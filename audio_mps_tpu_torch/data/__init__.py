"""Datasets of the PyTorch/CUDA port."""
from .synthetic import damped_sine_batch

__all__ = ["damped_sine_batch"]
