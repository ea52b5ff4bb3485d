"""PyTorch / CUDA port of caspr_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout: ``nn`` (functional layers), ``ops``
(point-cloud primitives, the dopri5 solver, the hand-written CUDA kernels
in ``ops.kernels``), ``models`` (the encoder, the latent ODE, the CNF
decoder and ``CaSPRModel``), ``train`` (the train step, the epoch runner,
checkpoints), ``data`` (the dataset loader), ``compat`` (reference .pth
weights), ``utils`` (the evaluation protocols, the CLI options), ``cli``
(the train and test command lines) and ``weights`` (JAX checkpoints ->
tensors).
"""
