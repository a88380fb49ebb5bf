"""audio_mps_tpu_torch — the PyTorch/CUDA port of audio_mps_tpu.

The psi and rho families' generation, forward scoring and training, with
the block kernels of the TPU package (SDE samplers, forward-only NLLs, the
training forwards and their adjoints), and psi's split-layout kernels,
written by hand in CUDA for Hopper (``csrc/``). The kernels are built on
first use, never at import. The legacy estimator's entry point is
``python -m audio_mps_tpu_torch.estimator``. ``data/`` reads and writes
the reference's TFRecord datasets (with the native scanner of
``native/``, built with g++ on first use), and
``models/reference_transcription.py`` is the lab-frame anchor. The JAX
package stays the reference; this package imports neither it nor jax.
"""
from .config import CMPSConfig, RunConfig
from .models.cmps import PsiCMPS, RhoCMPS
from .models.params import init_psi, init_rho
from .ops.grad import psi_nll_fused_trainable, rho_nll_fused_trainable
from .ops.scan import (psi_nll_fused, psi_sample_fused,
                       psi_sample_fused_keyed, rho_nll_fused,
                       rho_sample_fused, rho_sample_fused_keyed)
from .training import Checkpointer, make_optimizer, make_train_step

__all__ = ["CMPSConfig", "Checkpointer", "PsiCMPS", "RhoCMPS", "RunConfig",
           "init_psi", "init_rho", "make_optimizer", "make_train_step",
           "psi_nll_fused", "psi_nll_fused_trainable", "psi_sample_fused",
           "psi_sample_fused_keyed", "rho_nll_fused",
           "rho_nll_fused_trainable", "rho_sample_fused",
           "rho_sample_fused_keyed"]
