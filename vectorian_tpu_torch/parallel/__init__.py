"""Multi-device serving (the JAX package's vectorian_tpu/parallel)."""
