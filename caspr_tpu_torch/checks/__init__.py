"""Measurements that back a statement in the documents or a tolerance in the
tests; each is a script of its own (``python3 -m caspr_tpu_torch.checks.<name>``)
and nothing of the port imports them."""
