"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at its full 700 W power limit."""

# the highest dense product rate of the card (bf16 / fp16 tensor cores): at
# or above every way the port computes float32-accurate products (3xTF32 at
# 495, bf16 at 989), so no implementation of the counted work passes 100%
DENSE_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops, nbytes):
    """The least time the card could take for the work."""
    return max(flops / DENSE_FLOPS, nbytes / HBM_BYTES_PER_S)
