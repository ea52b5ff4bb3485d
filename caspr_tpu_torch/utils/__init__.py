"""Host-side utilities of the port: the evaluation protocols and the
RANSAC registration they use (counterparts of caspr_tpu/utils)."""
