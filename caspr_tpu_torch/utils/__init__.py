"""Host-side utilities of the port: the evaluation protocols, the RANSAC
registration they use, the command lines' options and the profiling
helpers (counterparts of caspr_tpu/utils)."""
