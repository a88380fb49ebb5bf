"""Datasets of the PyTorch/CUDA port."""
from .audio import get_audio
from .synthetic import damped_sine_batch, damped_sine_iterator

__all__ = ["damped_sine_batch", "damped_sine_iterator", "get_audio"]
