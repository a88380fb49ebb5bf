"""audio_mps_tpu_torch — the PyTorch/CUDA port of audio_mps_tpu.

The psi family's generation and forward scoring, with the two block
kernels of the TPU package (SDE sampler, forward-only NLL) written by hand
in CUDA for Hopper (``csrc/``). The kernels are built on first use, never
at import. The JAX package stays the reference; this package imports
neither it nor jax.
"""
from .config import CMPSConfig
from .models.cmps import PsiCMPS
from .models.params import init_psi
from .ops.scan import psi_nll_fused, psi_sample_fused, psi_sample_fused_keyed

__all__ = ["CMPSConfig", "PsiCMPS", "init_psi", "psi_nll_fused",
           "psi_sample_fused", "psi_sample_fused_keyed"]
