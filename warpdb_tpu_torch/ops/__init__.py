"""Physical operators on torch tensors, and the CUDA kernels' wrappers."""
