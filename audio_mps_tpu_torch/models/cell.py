"""The cMPS physics cell (port of ``audio_mps_tpu/models/cell.py``).

The ancilla evolves in the rotating (interaction) frame: with a diagonal
Hamiltonian the one-step lab-frame update becomes time-independent. For
psi it is ``psi'' = psi + (-(sigma^2 dt/2) K + s R) psi`` followed by the
constant phase ``psi <- conj(p) .* psi''`` with ``p = exp(i f dt)`` and
``K = R^dag R``; for rho it is ``rho'' = U rho U^dag``, ``U = C + s R``,
followed by ``rho <- rho'' .* Phi``, ``Phi_ij = exp(i (f_j - f_i) dt)``,
with ``C = 1 - (sigma^2 dt/2) K``. All complex algebra is split into real
pairs (see ``ops/complexing.py``); psi states are row-vector batches
``[B, D]``, rho states ``[B, D, D]`` and purification factors
``[B, rank, D]``.

The lab-frame single steps at the end (``lab_*``) recompute the phases at
time t instead: the reference's own form, which
``models/reference_transcription.py`` runs step by step.

Reference quirks kept as they are: the expectation in the loss is taken on
the unnormalised post-update state; ``log_eps <= 0`` leaves ``-log`` of a
non-positive argument unclamped (NaN, as the reference does); the norm
floor is ``cfg.norm_eps`` (1e-12 by default).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import CMPSConfig
from ..ops.complexing import (apply_matrix, block_embed, cmatmul,
                               cmatmul_adj_right, cmul, ctrace_re, gram_adj,
                               matmul)


def effective_R(params):
    """R with its (gauge) diagonal zeroed (reference: model.py:42)."""
    d = params.Rx.shape[-1]
    mask = 1.0 - torch.eye(d, dtype=params.Rx.dtype, device=params.Rx.device)
    return params.Rx * mask, params.Ry * mask


@dataclass
class CellConstants:
    """Scan-invariant derived quantities, built once per loss/sample call."""

    Rr: torch.Tensor   # effective R, zero diagonal
    Ri: torch.Tensor
    Kr: torch.Tensor   # K = R^dag R
    Ki: torch.Tensor
    Cr: torch.Tensor   # C = I - (sigma^2 dt / 2) K
    Ci: torch.Tensor
    Xr: torch.Tensor   # X = R + R^dag  (expectation operator)
    Xi: torch.Tensor
    phi_c: torch.Tensor  # [D,D] cos/sin of (f_j - f_i) dt  (rho rotation)
    phi_s: torch.Tensor
    p_c: torch.Tensor    # [D] cos/sin of f dt  (psi rotation)
    p_s: torch.Tensor
    A: torch.Tensor      # amplitude scale (scalar)


def make_constants(params, cfg: CMPSConfig) -> CellConstants:
    Rr, Ri = effective_R(params)
    Kr, Ki = gram_adj(Rr, Ri)
    half = 0.5 * (cfg.sigma ** 2) * cfg.delta_t
    d = Rr.shape[-1]
    eye = torch.eye(d, dtype=Rr.dtype, device=Rr.device)
    Cr = eye - half * Kr
    Ci = -half * Ki
    Xr = Rr + Rr.T
    Xi = Ri - Ri.T
    f = params.freqs
    df = (f[None, :] - f[:, None]) * cfg.delta_t   # (f_j - f_i) dt
    return CellConstants(Rr=Rr, Ri=Ri, Kr=Kr, Ki=Ki, Cr=Cr, Ci=Ci,
                         Xr=Xr, Xi=Xi,
                         phi_c=torch.cos(df), phi_s=torch.sin(df),
                         p_c=torch.cos(f * cfg.delta_t),
                         p_s=torch.sin(f * cfg.delta_t), A=params.A)


def rho_apply_U(cc: CellConstants, rr, ri, s):
    """Unnormalized Kraus update ``rho'' = (C + s R) rho (C + s R)^dag``.
    rr/ri: [B,D,D]; s: [B] = signal / A (reference: model.py:172-187)."""
    sb = s[:, None, None]
    Ur = cc.Cr[None] + sb * cc.Rr[None]
    Ui = cc.Ci[None] + sb * cc.Ri[None]
    mr, mi = cmatmul(Ur, Ui, rr, ri)
    return cmatmul_adj_right(mr, mi, Ur, Ui)


def rho_expectation(cc: CellConstants, rr, ri):
    """``<x> = Re tr[(R + R^dag) rho~]``, frame-invariant
    (reference: model.py:189-196)."""
    rt_r, rt_i = rr.transpose(-1, -2), ri.transpose(-1, -2)
    return (torch.sum(cc.Xr * rt_r, dim=(-2, -1))
            - torch.sum(cc.Xi * rt_i, dim=(-2, -1)))


def normalize_rho(rr, ri, eps: float):
    """Divide by the (real) trace, floored at eps
    (reference: model.py:198-203)."""
    inv = (1.0 / torch.clamp(ctrace_re(rr), min=eps))[:, None, None]
    return rr * inv, ri * inv


def rotate_rho(cc: CellConstants, rr, ri):
    """Advance the rotating frame one step: ``rho~ <- rho~ .* Phi``."""
    return cmul(rr, ri, cc.phi_c[None], cc.phi_s[None])


def psi_apply_update(cc: CellConstants, pr, pi, s):
    """``psi'' = psi + (-(sigma^2 dt/2) K + s R) psi`` in the rotating frame
    (reference: model.py:300-317), using ``-(sigma^2 dt/2) K = C - I``.
    pr/pi: [B,D]; s: [B] = signal / A."""
    d = cc.Cr.shape[-1]
    eye = torch.eye(d, dtype=cc.Cr.dtype, device=cc.Cr.device)
    dr1, di1 = apply_matrix(cc.Cr - eye, cc.Ci, pr, pi)
    rr_, ri_ = apply_matrix(cc.Rr, cc.Ri, pr, pi)
    sb = s[:, None]
    return pr + dr1 + sb * rr_, pi + di1 + sb * ri_


def psi_expectation(cc: CellConstants, pr, pi):
    """``<x> = 2 Re <psi|R|psi>`` (reference: model.py:319-325)."""
    rr_, ri_ = apply_matrix(cc.Rr, cc.Ri, pr, pi)
    return 2.0 * torch.sum(pr * rr_ + pi * ri_, dim=-1)


def normalize_psi(pr, pi, eps: float):
    """L2 normalize with eps floor (reference: model.py:327-334)."""
    sq = torch.sum(pr * pr + pi * pi, dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(sq, min=eps))
    return pr * inv, pi * inv


def rotate_psi(cc: CellConstants, pr, pi):
    """``psi~ <- conj(p) .* psi~`` with p = exp(i f dt)."""
    return (pr * cc.p_c[None] + pi * cc.p_s[None],
            pi * cc.p_c[None] - pr * cc.p_s[None])


def nll_increment(e, s, log_eps: float):
    """``-log(1 + <x> * signal / A)`` (reference: model.py:169-170,
    293-294), clamped at ``log_eps`` when it is > 0."""
    arg = 1.0 + e * s
    if log_eps > 0:
        arg = torch.clamp(arg, min=log_eps)
    return -torch.log(arg)


def rho_loss_step(cc: CellConstants, cfg: CMPSConfig, carry, inc):
    """update -> loss -> normalize -> rotate (reference: model.py:152-158);
    the expectation is taken on the unnormalized post-update state."""
    rr, ri, loss = carry
    s = inc / cc.A
    rr2, ri2 = rho_apply_U(cc, rr, ri, s)
    e = rho_expectation(cc, rr2, ri2)
    loss = loss + nll_increment(e, s, cfg.log_eps)
    rr2, ri2 = normalize_rho(rr2, ri2, cfg.norm_eps)
    rr2, ri2 = rotate_rho(cc, rr2, ri2)
    return (rr2, ri2, loss)


def rho_evolve_step(cc: CellConstants, cfg: CMPSConfig, carry, inc):
    """Update without loss (reference: model.py:144-150). Returns the carry
    plus the normalized pre-rotation state."""
    rr, ri, loss = carry
    s = inc / cc.A
    rr2, ri2 = rho_apply_U(cc, rr, ri, s)
    rr2, ri2 = normalize_rho(rr2, ri2, cfg.norm_eps)
    out = (rr2, ri2)
    rr2, ri2 = rotate_rho(cc, rr2, ri2)
    return (rr2, ri2, loss), out


def rho_sample_step(cc: CellConstants, cfg: CMPSConfig, carry, noise):
    """Euler–Maruyama step (reference: model.py:160-167): the increment is
    ``<x> dt + noise`` on the current state, and the ancilla is conditioned
    on it. Returns (carry, (increment, state))."""
    rr, ri = carry
    e = rho_expectation(cc, rr, ri)
    inc = e * cfg.delta_t + noise
    s = inc / cc.A
    rr2, ri2 = rho_apply_U(cc, rr, ri, s)
    rr2, ri2 = normalize_rho(rr2, ri2, cfg.norm_eps)
    state = (rr2, ri2)
    rr2, ri2 = rotate_rho(cc, rr2, ri2)
    return (rr2, ri2), (inc, state)


def rho_factor_loss_step(cc: CellConstants, cfg: CMPSConfig, carry, inc):
    """One loss step on the purification factor G (rho = G^dag G evolves as
    G <- G U^dag, exactly). carry: (gr, gi [B, rank, D], loss [B])."""
    gr, gi, loss = carry
    s = (inc / cc.A)[:, None, None]
    cdr, cdi = cc.Cr.T, -cc.Ci.T
    rdr, rdi = cc.Rr.T, -cc.Ri.T
    yr = ((matmul(gr, cdr) - matmul(gi, cdi))
          + s * (matmul(gr, rdr) - matmul(gi, rdi)))
    yi = ((matmul(gr, cdi) + matmul(gi, cdr))
          + s * (matmul(gr, rdi) + matmul(gi, rdr)))
    # e = Re tr(X rho'') = sum Re(G'' . conj(G'' @ X))
    gxr = matmul(yr, cc.Xr) - matmul(yi, cc.Xi)
    gxi = matmul(yr, cc.Xi) + matmul(yi, cc.Xr)
    e = torch.sum(yr * gxr + yi * gxi, dim=(1, 2))
    tr = torch.sum(yr * yr + yi * yi, dim=(1, 2))
    loss = loss + nll_increment(e, s[:, 0, 0], cfg.log_eps)
    inv = torch.rsqrt(torch.clamp(tr, min=cfg.norm_eps))[:, None, None]
    yr = yr * inv
    yi = yi * inv
    # rotate: G <- G P (column scale by exp(i f dt))
    return (yr * cc.p_c - yi * cc.p_s, yr * cc.p_s + yi * cc.p_c, loss)


def rho_factor_state0(params, cfg: CMPSConfig, b: int):
    """Initial purification factor [b, rank, D], normalized to unit trace
    (reference: model.py:57-66)."""
    wr, wi = params.Wx, params.Wy
    tr0 = torch.sum(wr * wr + wi * wi)
    inv0 = torch.rsqrt(torch.clamp(tr0, min=cfg.norm_eps))
    return ((wr * inv0)[None].expand((b,) + tuple(wr.shape)),
            (wi * inv0)[None].expand((b,) + tuple(wi.shape)))


def psi_loss_step(cc: CellConstants, cfg: CMPSConfig, carry, inc):
    """update -> loss -> normalize -> rotate (reference: model.py:276-282)."""
    pr, pi, loss = carry
    s = inc / cc.A
    pr2, pi2 = psi_apply_update(cc, pr, pi, s)
    e = psi_expectation(cc, pr2, pi2)
    loss = loss + nll_increment(e, s, cfg.log_eps)
    pr2, pi2 = normalize_psi(pr2, pi2, cfg.norm_eps)
    pr2, pi2 = rotate_psi(cc, pr2, pi2)
    return (pr2, pi2, loss)


def psi_evolve_step(cc: CellConstants, cfg: CMPSConfig, carry, inc):
    """(reference: model.py:269-274). Returns the carry plus the normalized
    pre-rotation state."""
    pr, pi, loss = carry
    s = inc / cc.A
    pr2, pi2 = psi_apply_update(cc, pr, pi, s)
    pr2, pi2 = normalize_psi(pr2, pi2, cfg.norm_eps)
    out = (pr2, pi2)
    pr2, pi2 = rotate_psi(cc, pr2, pi2)
    return (pr2, pi2, loss), out


def psi_sample_step(cc: CellConstants, cfg: CMPSConfig, carry, noise):
    """Euler–Maruyama step (reference: model.py:284-291): the increment is
    ``<x> dt + noise`` on the current state, and the ancilla is conditioned
    on it. Returns (carry, (increment, state))."""
    pr, pi = carry
    e = psi_expectation(cc, pr, pi)
    inc = e * cfg.delta_t + noise
    s = inc / cc.A
    pr2, pi2 = psi_apply_update(cc, pr, pi, s)
    pr2, pi2 = normalize_psi(pr2, pi2, cfg.norm_eps)
    state = (pr2, pi2)
    pr2, pi2 = rotate_psi(cc, pr2, pi2)
    return (pr2, pi2), (inc, state)


# ---------------------------------------------------------------------------
# Lab-frame single steps: the reference's form, the steps that
# models/reference_transcription.py runs
# ---------------------------------------------------------------------------
#
# The JAX package's seams take split pairs and rebuild R, K and the phases
# at every call. These take real blocks: a psi state stacked ``[re | im]``
# ([B, 2D]; a phase applied by a roll of the halves), a rho state as its
# real [2D, 2D] block (``ops.complexing.block_embed``, to which products,
# adjoints and real traces, halved, carry over). What does not depend on t
# is built once a call (``lab_psi_operators``, ``lab_rho_operators``); the
# phases are recomputed at t every step (``lab_phases_psi``, ``_lab_Rt``).
# The signal comes divided by A, as ``s``.

@dataclass
class LabPsiOperators:
    """psi's lab-frame operators, as row-vector blocks: ``x @ rkb`` gives
    ``[R u | -(sigma^2 dt / 2) K u]`` of a stacked state u."""

    rkb: torch.Tensor   # [2D, 4D]
    rb2: torch.Tensor   # [2D, 2D]: 2 R
    f2: torch.Tensor    # [2D]: [f | -f]


def lab_psi_operators(params, cfg: CMPSConfig) -> LabPsiOperators:
    Rr, Ri = effective_R(params)
    half = 0.5 * (cfg.sigma ** 2) * cfg.delta_t
    rb = block_embed(Rr, Ri).T
    return LabPsiOperators(
        rkb=torch.cat([rb, -half * block_embed(*gram_adj(Rr, Ri)).T], -1),
        rb2=2.0 * rb, f2=torch.cat([params.freqs, -params.freqs]))


def lab_phases_psi(ops: LabPsiOperators, t):
    """The phases ``p = e^{i f t}`` at t, as the cos and sin of
    ``[f | -f] t``: ``[c | c]`` and ``[s | -s]``."""
    ang = ops.f2 * t
    return torch.cos(ang), torch.sin(ang)


def _lab_unphase(x, phases):
    """``conj(p) .* psi`` of a stacked state."""
    c, sn = phases
    return torch.addcmul(x * c, x.roll(x.shape[-1] // 2, -1), sn)


def lab_update_ancilla_psi(ops: LabPsiOperators, x, s, phases):
    """Direct transcription of the reference psi update (model.py:300-317):
    ``Upsi = conj(p) .* psi``, ``psi'' = psi + p .* (-(sigma^2 dt / 2) K +
    s R) Upsi``. x: [B, 2D]; s: [B]; returns psi'' unnormalised."""
    D = x.shape[-1] // 2
    c, sn = phases
    ru_ku = matmul(_lab_unphase(x, phases), ops.rkb)
    du = torch.addcmul(ru_ku[:, 2 * D:], s[:, None], ru_ku[:, :2 * D])
    return torch.addcmul(torch.addcmul(x, du, c), du.roll(D, -1), sn,
                         value=-1.0)


def lab_expectation_psi(ops: LabPsiOperators, x, phases):
    """``2 Re <Upsi, R Upsi>`` (reference: model.py:319-325)."""
    u = _lab_unphase(x, phases)
    return torch.sum(u * matmul(u, ops.rb2), dim=-1)


@dataclass
class LabRhoOperators:
    """rho's lab-frame operators that do not depend on t."""

    Rr: torch.Tensor    # effective R
    Ri: torch.Tensor
    fd: torch.Tensor    # [D, D]: f_i - f_j
    eye: torch.Tensor   # [2D, 2D]
    half: float         # sigma^2 dt / 2


def lab_rho_operators(params, cfg: CMPSConfig) -> LabRhoOperators:
    Rr, Ri = effective_R(params)
    f = params.freqs
    return LabRhoOperators(
        Rr=Rr, Ri=Ri, fd=f[:, None] - f[None, :],
        eye=torch.eye(2 * Rr.shape[-1], dtype=Rr.dtype, device=Rr.device),
        half=0.5 * (cfg.sigma ** 2) * cfg.delta_t)


def _lab_Rt(ops: LabRhoOperators, t):
    """``Rt = diag(e^{i f t}) R diag(e^{-i f t}) = R .* E``,
    ``E_ij = e^{i (f_i - f_j) t}`` (reference: model.py:178-179), as its
    real block."""
    ang = ops.fd * t
    return block_embed(*cmul(ops.Rr, ops.Ri, torch.cos(ang), torch.sin(ang)))


def lab_update_ancilla_rho(ops: LabRhoOperators, rt, rho, s):
    """Direct transcription of the reference update (model.py:172-187):
    ``U = 1 - (sigma^2 dt / 2) Rt^dag Rt + s Rt``, ``rho'' = U rho U^dag``.
    rt: Rt's block (``_lab_Rt``); rho: [B, 2D, 2D]; s: [B]."""
    u = (ops.eye - ops.half * matmul(rt.T, rt))[None] + s[:, None, None] * rt
    return matmul(matmul(u, rho), u.mT)


def lab_expectation_rho(rt, rho):
    """``Re tr[(Rt + Rt^dag) rho]`` (reference: model.py:189-196), half the
    trace of the blocks' product, as elementwise products and sums: no
    matrix product that a TF32 setting could round."""
    return 0.5 * torch.sum((rt + rt.T) * rho.mT, dim=(-2, -1))
