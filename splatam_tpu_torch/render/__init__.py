"""Differentiable Gaussian rendering: projection, binning, the CUDA kernels."""
