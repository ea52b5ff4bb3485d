"""The port's command lines: ``python -m caspr_tpu_torch.cli.train``,
``python -m caspr_tpu_torch.cli.test`` and ``python -m caspr_tpu_torch.cli.viz``
(counterparts of the JAX package's train.py, test.py and viz.py, with the
same flags)."""
