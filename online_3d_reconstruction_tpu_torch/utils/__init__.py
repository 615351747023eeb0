"""Build and load the CUDA kernels."""
