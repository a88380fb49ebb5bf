"""Kernel dispatch for generation and forward scoring, psi and rho
(counterpart of the entry points of ``audio_mps_tpu/ops/pallas_scan.py``).

Layout resolution follows the JAX package: the block kernels
(``ops/block.py``) take D % 8 == 0 for the sampler and D % 4 == 0 for the
NLL; other D, and ``kernel_layout="split"``, resolve to the split layout.
The split kernels of both families are ported (``ops/split.py``): a CUDA
tensor launches them, a CPU tensor runs their plain versions, so that the
CPU tests pin the function the card runs; a shape past a kernel's shared
memory raises ``NotImplementedError`` on the card. The split samplers take
``highest`` where ``high`` is asked for, with a warning, as JAX's do; the
split NLLs raise ``ValueError`` at ``high``.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from ..config import CMPSConfig
from ..models import core
from . import _build, block, cluster, split

DEFAULT_UNROLL = 16

def _sampler_layout(cfg: CMPSConfig, layout: Optional[str]) -> str:
    """The block sampler needs D % 8 == 0, so even an explicit "block"
    resolves to split when unsupported (with a warning), as on the TPU."""
    requested = layout if layout is not None else cfg.kernel_layout
    if requested not in ("auto", "split", "block"):
        raise ValueError(
            f"layout must be 'auto', 'split', or 'block', got {requested!r}")
    if requested == "split":
        return "split"
    if block.supports_block_sampler(cfg):
        return "block"
    if requested == "block":
        warnings.warn(
            f"explicit sampler layout='block' needs bond_dim % 8 == 0; "
            f"resolving to the split sampler at D={cfg.bond_dim}",
            stacklevel=3)
    return "split"


def psi_sampler_fits(cfg: CMPSConfig, device) -> bool:
    """Does a psi sampler kernel take ``cfg``'s D on the CUDA ``device``:
    the block sampler where the layout resolves to block (its one-CTA
    bodies within one block's shared memory, its cluster body at a cluster
    of ``cluster.psi_sample_cluster_for``: D % 8 == 0 to 256), else the
    split one, within one block's shared memory?"""
    lib = _build.library()
    D = cfg.bond_dim
    optin = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    block_layout = (cfg.kernel_layout != "split"
                    and block.supports_block_sampler(cfg))
    if block_layout and block.psi_sample_body(D) == "cluster":
        try:
            cluster.psi_sample_cluster_for(D, optin)
        except NotImplementedError:
            return False
        return True
    need = (lib.amt_psi_sample_smem_bytes(D) if block_layout
            else lib.amt_psi_split_sample_smem_bytes(D))
    return need <= optin


def rho_sampler_fits(cfg: CMPSConfig, rank: int, device) -> bool:
    """Does a rho sampler kernel take ``cfg``'s D at ``rank`` on the CUDA
    ``device``: the block sampler where the layout resolves to block
    (D % 8 == 0, within ``block.rho_block_fits``; its CTA at some cluster
    the card holds, ``block.rho_sample_fits``), else the split one, within
    one block's shared memory (its ceiling,
    ``split.rho_split_sample_ceiling_bytes``)?"""
    D = cfg.bond_dim
    if cfg.kernel_layout != "split" and block.supports_block_sampler(cfg):
        return (block.rho_block_fits(D, rank)
                and block.rho_sample_fits(D, rank, device))
    need = split.rho_split_sample_ceiling_bytes(D, rank)
    return need <= torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def _downgrade_high(cfg: CMPSConfig) -> str:
    """bf16x3 exists only in the block kernels; a model trained in the
    block layout at e.g. D=12 must still sample (as JAX's does,
    ``pallas_scan.py:566-574``): the split sampler runs ``highest``, with a
    warning."""
    warnings.warn(
        f"sampler precision='high' (bf16x3) exists only in the block "
        f"kernels; split fallback at D={cfg.bond_dim} runs full fp32 "
        f"('highest') instead", stacklevel=3)
    return "highest"


def _nll_layout(cfg: CMPSConfig, layout: Optional[str]) -> str:
    """"auto" picks block when D % 4 == 0, else split; an explicit "block"
    on an unsupported D flows into the block path, which raises."""
    layout = layout if layout is not None else cfg.kernel_layout
    if layout == "auto":
        return "block" if block.supports_block(cfg) else "split"
    if layout not in ("split", "block"):
        raise ValueError(
            f"layout must be 'auto', 'split', or 'block', got {layout!r}")
    return layout


def psi_sample_fused(params, cfg: CMPSConfig, noise, *,
                     precision: Optional[str] = None,
                     layout: Optional[str] = None):
    """Waveforms [N, T] from noise [T, N] on the noise's device (stands for
    ``audio_mps_tpu.ops.pallas_scan.psi_sample_pallas``; semantics of
    ``core.sample_psi_with_noise``): the block sampler
    (``block.psi_sample_block``) or the split one
    (``split.psi_sample_split``). ``precision=None`` follows
    ``cfg.kernel_precision``."""
    if precision is None:
        precision = cfg.kernel_precision
    if _sampler_layout(cfg, layout) == "block":
        inputs = block.psi_sample_inputs(params, cfg, noise)
        wave = block.psi_sample_block(**inputs, precision=precision)
        return params.A.detach() * wave.T
    if precision == "high":
        precision = _downgrade_high(cfg)
    inputs = split.psi_split_inputs(params, cfg, noise, noise=True)
    wave = split.psi_sample_split(**inputs, precision=precision)
    return params.A.detach() * wave.T


def psi_sample_fused_keyed(params, cfg: CMPSConfig, generator,
                           num_samples: int, length: int, temp=1.0, **kw):
    """Drop-in for ``core.sample_psi`` through the kernels (stands for
    ``audio_mps_tpu.ops.pallas_scan.psi_sample_pallas_keyed``): the noise
    comes from ``generator``."""
    noise = core._sample_noise(cfg, generator, num_samples, length, temp)
    return psi_sample_fused(params, cfg, noise.to(params.A.device), **kw)


def psi_nll_fused(params, cfg: CMPSConfig, signals, *,
                  unroll: int = DEFAULT_UNROLL, precision: str = "highest",
                  defer_norm: bool = False, layout: Optional[str] = None):
    """Mean NLL [scalar] of waveforms [B, T] on the signals' device (stands
    for ``audio_mps_tpu.ops.pallas_scan.psi_nll_pallas``; semantics of
    ``core.psi_nll``): the block NLL (``block.psi_nll_block``) or the split
    one (``split.psi_nll_split``, which raises ``ValueError`` at
    ``high``)."""
    if _nll_layout(cfg, layout) == "block":
        inputs = block.psi_nll_inputs(params, cfg, signals)
        return block.psi_nll_block(**inputs, unroll=unroll,
                                   precision=precision,
                                   defer_norm=defer_norm).mean()
    inputs = split.psi_split_inputs(params, cfg, signals)
    return split.psi_nll_split(**inputs, unroll=unroll, precision=precision,
                               defer_norm=defer_norm).mean()


def rho_sample_fused(params, cfg: CMPSConfig, noise, *,
                     precision: Optional[str] = None,
                     layout: Optional[str] = None):
    """Waveforms [N, T] from noise [T, N] under the mixed-state model, on
    the noise's device (stands for
    ``audio_mps_tpu.ops.pallas_scan.rho_sample_pallas``; semantics of
    ``core.sample_rho_with_noise``). ``precision=None`` follows
    ``cfg.kernel_precision``."""
    if precision is None:
        precision = cfg.kernel_precision
    if _sampler_layout(cfg, layout) == "block":
        inputs = block.rho_sample_inputs(params, cfg, noise)
        wave = block.rho_sample_block(**inputs, precision=precision)
        return params.A.detach() * wave.T
    if precision == "high":
        precision = _downgrade_high(cfg)
    inputs = split.rho_split_inputs(params, cfg, noise, noise=True)
    wave = split.rho_sample_split(**inputs, precision=precision)
    return params.A.detach() * wave.T


def rho_sample_fused_keyed(params, cfg: CMPSConfig, generator,
                           num_samples: int, length: int, temp=1.0, **kw):
    """Drop-in for ``core.sample_rho`` through the kernels (stands for
    ``audio_mps_tpu.ops.pallas_scan.rho_sample_pallas_keyed``): the noise
    comes from ``generator``."""
    noise = core._sample_noise(cfg, generator, num_samples, length, temp)
    return rho_sample_fused(params, cfg, noise.to(params.A.device), **kw)


def rho_nll_fused(params, cfg: CMPSConfig, signals, *,
                  unroll: int = DEFAULT_UNROLL, precision: str = "highest",
                  defer_norm: bool = False, layout: Optional[str] = None):
    """Mean rho NLL [scalar] of waveforms [B, T] on the signals' device
    (stands for ``audio_mps_tpu.ops.pallas_scan.rho_nll_pallas``; semantics
    of ``core.rho_nll``)."""
    if _nll_layout(cfg, layout) == "block":
        inputs = block.rho_nll_inputs(params, cfg, signals)
        return block.rho_nll_block(**inputs, unroll=unroll,
                                   precision=precision,
                                   defer_norm=defer_norm).mean()
    inputs = split.rho_split_inputs(params, cfg, signals)
    return split.rho_nll_split(**inputs, unroll=unroll, precision=precision,
                               defer_norm=defer_norm).mean()
