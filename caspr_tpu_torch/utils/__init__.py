"""Host-side utilities of the port: the evaluation protocols, the RANSAC
registration they use, and the command lines' options (counterparts of
caspr_tpu/utils)."""
