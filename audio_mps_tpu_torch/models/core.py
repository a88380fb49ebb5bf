"""Eager reference: losses, samplers, trajectories for the psi and rho
families (port of ``audio_mps_tpu/models/core.py``).

Time is a plain Python loop over ``models/cell.py`` steps, so this is the
slow, obviously-right version that the CUDA kernels of ``ops/block.py`` are
held to. It runs on whatever device the parameters live on. The loss runs
through ``chunked_scan``, whose full chunks are recomputed in the backward
pass (``torch.utils.checkpoint``), so its gradient over T=65536 keeps
O(T/chunk + chunk) states alive instead of O(T).
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..config import CMPSConfig
from ..ops.complexing import cadjoint, cmatmul, ctrace_re
from . import cell
from .cell import effective_R, make_constants


def psi0(params, cfg: CMPSConfig):
    """Normalized initial pure state [D] (reference: model.py:214-222)."""
    pr, pi = params.psi_x[None, :], params.psi_y[None, :]
    pr, pi = cell.normalize_psi(pr, pi, cfg.norm_eps)
    return pr[0], pi[0]


def rho0(params, cfg: CMPSConfig):
    """``rho_0 = W^dag W / tr`` [D,D] (reference: model.py:118-130)."""
    wr, wi = params.Wx, params.Wy
    ar, ai = cadjoint(wr, wi)
    rr, ri = cmatmul(ar, ai, wr, wi)
    tr = ctrace_re(rr)
    return rr / tr, ri / tr


def _tile(x, n):
    return x[None].expand((n,) + tuple(x.shape))


def chunked_scan(step, carry, xs, chunk: int):
    """Fold ``step(carry, x)`` over the leading axis of ``xs`` with
    bounded-memory backprop: full chunks of ``chunk`` steps run under
    ``torch.utils.checkpoint`` (their states are recomputed in the backward
    pass), the remainder runs plain, so no masking is needed. ``carry`` is a
    tuple of tensors."""
    def plain(carry, xs_):
        for x in xs_:
            carry = step(carry, x)
        return carry

    T = xs.shape[0]
    if chunk is None or chunk <= 1 or T <= chunk:
        return plain(carry, xs)
    n_full = T // chunk
    for c in range(n_full):
        carry = checkpoint(plain, carry, xs[c * chunk:(c + 1) * chunk],
                           use_reentrant=False)
    return plain(carry, xs[n_full * chunk:])


def _increments(signals):
    """Waveform [B,T] -> time-major increments [T-1, B]
    (reference: model.py:138-139)."""
    return (signals[:, 1:] - signals[:, :-1]).T


def rho_nll(params, cfg: CMPSConfig, signals):
    """Mean NLL of waveforms [B,T] under the mixed-state model, evolving the
    density matrix itself (reference: model.py:132-142)."""
    cc = make_constants(params, cfg)
    incs = _increments(signals)
    B = signals.shape[0]
    rr, ri = rho0(params, cfg)
    carry = (_tile(rr, B), _tile(ri, B),
             torch.zeros((B,), dtype=signals.dtype, device=signals.device))
    step = functools.partial(cell.rho_loss_step, cc, cfg)
    _, _, loss = chunked_scan(step, carry, incs, cfg.scan_chunk)
    return torch.mean(loss)


def rho_nll_factor(params, cfg: CMPSConfig, signals):
    """``rho_nll`` evolving the purification factor G (rho = G^dag G, the
    exact form of rho_0 = W^dag W / tr) instead of rho: the same value at
    half the matmul FLOPs. The training loss off the card."""
    cc = make_constants(params, cfg)
    incs = _increments(signals)
    B = signals.shape[0]
    gr, gi = cell.rho_factor_state0(params, cfg, B)
    carry = (gr, gi,
             torch.zeros((B,), dtype=signals.dtype, device=signals.device))
    step = functools.partial(cell.rho_factor_loss_step, cc, cfg)
    _, _, loss = chunked_scan(step, carry, incs, cfg.scan_chunk)
    return torch.mean(loss)


def psi_nll(params, cfg: CMPSConfig, signals):
    """Mean NLL of waveforms [B,T] under the pure-state model
    (reference: model.py:257-267)."""
    cc = make_constants(params, cfg)
    incs = _increments(signals)
    B = signals.shape[0]
    pr, pi = psi0(params, cfg)
    carry = (_tile(pr, B), _tile(pi, B),
             torch.zeros((B,), dtype=signals.dtype, device=signals.device))
    step = functools.partial(cell.psi_loss_step, cc, cfg)
    _, _, loss = chunked_scan(step, carry, incs, cfg.scan_chunk)
    return torch.mean(loss)


def regularized_loss(nll, params, cfg: CMPSConfig):
    """``total = nll + h_reg ||freqs||^2 + r_reg ||R||^2``, with R's zeroed
    diagonal (reference: train.py:55-60). Returns (total, (h_sq, r_sq))."""
    Rr, Ri = effective_R(params)
    r_sq = torch.sum(Rr * Rr + Ri * Ri)
    h_sq = torch.sum(params.freqs ** 2)
    return nll + cfg.h_reg * h_sq + cfg.r_reg * r_sq, (h_sq, r_sq)


def _sample_noise(cfg: CMPSConfig, generator: torch.Generator,
                  num_samples: int, length: int, temp):
    """SDE driving noise [length, N] on the generator's device."""
    std = cfg.sigma * math.sqrt(temp * cfg.delta_t)
    return std * torch.randn((length, num_samples), generator=generator,
                             device=generator.device, dtype=torch.float32)


def _rho_sampler_steps(cc, params, cfg: CMPSConfig, noise):
    """Yield (increment [N], normalized pre-rotation state [N, D, D] pair)
    for each step of the rho sampler on given noise [T, N]."""
    rr, ri = rho0(params, cfg)
    carry = (_tile(rr, noise.shape[1]), _tile(ri, noise.shape[1]))
    for z in noise:
        carry, out = cell.rho_sample_step(cc, cfg, carry, z)
        yield out


def sample_rho_with_noise(params, cfg: CMPSConfig, noise):
    """Waveforms [N, T] from given noise [T, N] (the SDE driving terms)."""
    cc = make_constants(params, cfg)
    incs = [inc for inc, _ in _rho_sampler_steps(cc, params, cfg, noise)]
    return cc.A * torch.cumsum(torch.stack(incs), dim=0).T


def sample_rho(params, cfg: CMPSConfig, generator: torch.Generator,
               num_samples: int, length: int, temp=1.0):
    """(reference: model.py:103-112)"""
    noise = _sample_noise(cfg, generator, num_samples, length, temp)
    return sample_rho_with_noise(params, cfg, noise.to(params.A.device))


def sample_psi_with_noise(params, cfg: CMPSConfig, noise):
    """Waveforms [N, T] from given noise [T, N] (the SDE driving terms)."""
    cc = make_constants(params, cfg)
    num_samples = noise.shape[1]
    pr, pi = psi0(params, cfg)
    carry = (_tile(pr, num_samples), _tile(pi, num_samples))
    incs = []
    for z in noise:
        carry, (inc, _state) = cell.psi_sample_step(cc, cfg, carry, z)
        incs.append(inc)
    return cc.A * torch.cumsum(torch.stack(incs), dim=0).T


def sample_psi(params, cfg: CMPSConfig, generator: torch.Generator,
               num_samples: int, length: int, temp=1.0):
    """(reference: model.py:242-251)"""
    noise = _sample_noise(cfg, generator, num_samples, length, temp)
    return sample_psi_with_noise(params, cfg, noise.to(params.A.device))


def _lab_rotate_rho_traj(params, cfg: CMPSConfig, rr, ri):
    """Back-rotate a rotating-frame rho trajectory [T,B,D,D] into the lab
    frame: rho_lab(t_n) = rho~ .* E(t_n), E_ij = exp(i (f_i - f_j) n dt)."""
    T = rr.shape[0]
    f = params.freqs
    t = torch.arange(T, dtype=torch.float32, device=rr.device) * cfg.delta_t
    ang = t[:, None, None] * (f[:, None] - f[None, :])[None]   # [T,D,D]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    return rr * c - ri * s, rr * s + ri * c


def _lab_rotate_psi_traj(params, cfg: CMPSConfig, pr, pi):
    """psi_lab(t_n) = phases(t_n) .* psi~, phases = exp(i f t_n)."""
    T = pr.shape[0]
    t = torch.arange(T, dtype=torch.float32, device=pr.device) * cfg.delta_t
    ang = t[:, None] * params.freqs[None]        # [T,D]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    return pr * c - pi * s, pr * s + pi * c


def psi_evolve_with_data(params, cfg: CMPSConfig, signals):
    """Full psi trajectory [B, T-1, D] pair (reference: model.py:231-240)."""
    cc = make_constants(params, cfg)
    incs = _increments(signals)
    B = signals.shape[0]
    pr, pi = psi0(params, cfg)
    carry = (_tile(pr, B), _tile(pi, B),
             torch.zeros((B,), dtype=signals.dtype, device=signals.device))
    tr_r, tr_i = [], []
    for inc in incs:
        carry, (sr, si) = cell.psi_evolve_step(cc, cfg, carry, inc)
        tr_r.append(sr)
        tr_i.append(si)
    tr_r, tr_i = _lab_rotate_psi_traj(params, cfg, torch.stack(tr_r),
                                      torch.stack(tr_i))
    return tr_r.transpose(0, 1), tr_i.transpose(0, 1)


def rho_evolve_with_data(params, cfg: CMPSConfig, signals):
    """Full rho trajectory [B, T-1, D, D] pair under a data batch [B,T]
    (reference: model.py:76-85)."""
    cc = make_constants(params, cfg)
    incs = _increments(signals)
    B = signals.shape[0]
    rr, ri = rho0(params, cfg)
    carry = (_tile(rr, B), _tile(ri, B),
             torch.zeros((B,), dtype=signals.dtype, device=signals.device))
    tr_r, tr_i = [], []
    for inc in incs:
        carry, (sr, si) = cell.rho_evolve_step(cc, cfg, carry, inc)
        tr_r.append(sr)
        tr_i.append(si)
    tr_r, tr_i = _lab_rotate_rho_traj(params, cfg, torch.stack(tr_r),
                                      torch.stack(tr_i))
    return tr_r.transpose(0, 1), tr_i.transpose(0, 1)


def _sampled_rho_states(params, cfg: CMPSConfig, noise):
    """The normalized pre-rotation states [T, N, D, D] pair of the sampler
    on given noise [T, N]."""
    cc = make_constants(params, cfg)
    sr, si = zip(*(s for _, s in _rho_sampler_steps(cc, params, cfg, noise)))
    return torch.stack(sr), torch.stack(si)


def rho_evolve_with_noise(params, cfg: CMPSConfig, noise):
    """rho trajectory [N, T, D, D] pair of the sampler driven by given noise
    [T, N], in the lab frame."""
    tr_r, tr_i = _lab_rotate_rho_traj(params, cfg,
                                      *_sampled_rho_states(params, cfg, noise))
    return tr_r.transpose(0, 1), tr_i.transpose(0, 1)


def rho_evolve_with_sampling(params, cfg: CMPSConfig,
                             generator: torch.Generator, num_samples: int,
                             length: int, temp=1.0):
    """rho trajectory under ancestral sampling [N, length, D, D] pair
    (reference: model.py:87-93)."""
    noise = _sample_noise(cfg, generator, num_samples, length, temp)
    return rho_evolve_with_noise(params, cfg, noise.to(params.A.device))


def purity_with_noise(params, cfg: CMPSConfig, noise):
    """``tr(rho^2)`` [N, T] along the sampler's trajectories on given noise
    [T, N], on the rotating-frame states (it is frame-invariant)."""
    sr, si = _sampled_rho_states(params, cfg, noise)
    p = (torch.sum(sr * sr.transpose(-1, -2), dim=(-2, -1))
         - torch.sum(si * si.transpose(-1, -2), dim=(-2, -1)))
    return p.T


def purity(params, cfg: CMPSConfig, generator: torch.Generator,
           num_samples: int, length: int, temp=1.0):
    """``tr(rho^2)`` along sampled trajectories [N, length]
    (reference: model.py:95-101)."""
    noise = _sample_noise(cfg, generator, num_samples, length, temp)
    return purity_with_noise(params, cfg, noise.to(params.A.device))
