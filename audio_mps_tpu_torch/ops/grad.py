"""Differentiable NLL through the kernels, psi and rho (counterpart of the
entry points of ``audio_mps_tpu/ops/pallas_grad.py``).

Layout resolution is the forward NLL's (``ops/scan.py``), as in the JAX
package: the block kernels (``ops/block.py``) take D % 4 == 0; other D,
and ``kernel_layout="split"``, resolve to the split layout. psi's split
training kernels and rho's are ported (``ops/split.psi_nll_split_trainable``
and ``ops/split.rho_nll_split_trainable``: a CUDA tensor launches them, a
CPU tensor runs their plain versions; both raise ``ValueError`` at
``high``).
"""
from __future__ import annotations

from typing import Optional

from ..config import CMPSConfig
from . import block, split
from .rank import device_limits, rho_nll_rank_chunked, rho_train_chunk
from .scan import DEFAULT_UNROLL, _nll_layout

def psi_nll_fused_trainable(params, cfg: CMPSConfig, signals, *,
                            unroll: int = DEFAULT_UNROLL,
                            precision: str = "highest",
                            defer_norm: bool = False,
                            layout: Optional[str] = None):
    """Differentiable mean NLL of waveforms [B, T] on the signals' device
    (stands for ``pallas_grad.psi_nll_pallas_trainable``; semantics of
    ``core.psi_nll``): gradients reach every parameter through the block
    constants, the initial state and the increments: the block layout's
    ``PsiBlockNLL`` or the split layout's ``PsiSplitNLL`` (which raises
    ``ValueError`` at ``high``)."""
    if _nll_layout(cfg, layout) == "block":
        return block.psi_nll_block_trainable(
            params, cfg, signals, unroll=unroll, precision=precision,
            defer_norm=defer_norm)
    return split.psi_nll_split_trainable(params, cfg, signals, unroll=unroll,
                                         precision=precision,
                                         defer_norm=defer_norm)


def rho_nll_fused_trainable(params, cfg: CMPSConfig, signals, *,
                            unroll: int = DEFAULT_UNROLL,
                            precision: str = "highest",
                            defer_norm: bool = False,
                            layout: Optional[str] = None):
    """Differentiable mean rho NLL of waveforms [B, T] on the signals'
    device (stands for ``pallas_grad.rho_nll_pallas_trainable`` and the
    rank chunking of ``audio_mps_tpu/training.py:100-140``; semantics of
    ``core.rho_nll``): gradients reach every parameter through the block
    constants, the initial factor and the increments. In the block layout
    the monolithic kernels (``block.rho_nll_block_trainable``) run while
    one block holds the constants beside an example's segment; past that
    (``rank.rho_train_chunk`` on the card's limits: D > 64 or rank > 64 on
    an H100) the rank-chunked partials (``rank.rho_nll_rank_chunked``),
    which renormalise at block exits whatever ``defer_norm`` says. In the
    split layout, ``RhoSplitNLL`` (``split.rho_nll_split_trainable``)."""
    if _nll_layout(cfg, layout) == "block":
        B, rank = signals.shape[0], params.Wx.shape[0]
        chunk = rho_train_chunk(cfg.bond_dim, B, rank,
                                *device_limits(signals.device))
        if chunk is None:
            return block.rho_nll_block_trainable(
                params, cfg, signals, unroll=unroll, precision=precision,
                defer_norm=defer_norm)
        return rho_nll_rank_chunked(params, cfg, signals, rank_chunk=chunk,
                                    unroll=unroll, precision=precision)
    return split.rho_nll_split_trainable(params, cfg, signals, unroll=unroll,
                                         precision=precision,
                                         defer_norm=defer_norm)
