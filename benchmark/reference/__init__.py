"""Plain references of what the benchmark's entries produce.  They import
NumPy and torch only: nothing of krisp_tpu_torch, JAX or krisp_tpu."""
