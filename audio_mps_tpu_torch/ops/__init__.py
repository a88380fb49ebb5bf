"""Operators and kernels of the PyTorch/CUDA port."""
