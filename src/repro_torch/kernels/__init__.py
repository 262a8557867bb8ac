"""The search kernels: CUDA sources in ``csrc/``, wrappers, plain versions."""
