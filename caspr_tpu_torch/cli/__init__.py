"""The port's command lines: ``python -m caspr_tpu_torch.cli.train`` and
``python -m caspr_tpu_torch.cli.test`` (counterparts of the JAX package's
train.py and test.py, with the same flags)."""
