"""Split-layout kernels for Hopper, psi: the SDE sampler, the forward-only
NLL and the training NLL with its adjoint (port of the split halves of
``audio_mps_tpu/ops/pallas_scan.py`` and ``audio_mps_tpu/ops/pallas_grad.py``;
the sibling of ``ops/block.py``).

Layout (as in the JAX package): the state is split into real and imaginary
columns ``pr, pi`` [D, cols], and each complex product ``M v`` is four real
[D,D] x [D] products. The frame rotation is not folded into the constants:
each step normalises (or, with the deferred norm, does not) and then rotates
by conj(p) with ``pc, ps`` [D]. Nothing needs D % 4 == 0, so this layout runs
every D the block layout refuses (training and scoring at D % 4 != 0, the
sampler at D % 8 != 0) and any D asked for with ``kernel_layout="split"``.
Like the TPU's split kernels it takes only the ``highest`` and ``default``
precisions; ``high`` raises ``ValueError`` (the sampler's dispatch in
``ops/scan.py`` runs ``highest`` instead, with a warning, as JAX's does).

Each kernel comes as a pair:

* ``*_plain``: the step loop in plain PyTorch. It is the CPU path and the
  version the CUDA kernel is held to on the card.
* the wrapper (``psi_sample_split``, ``psi_nll_split``, ``psi_split_fwd``,
  ``psi_split_bwd``): a CPU tensor goes to the plain version; a CUDA tensor
  launches the hand-written kernel from ``csrc/`` (built by
  ``ops/_build.py``) or raises. The wrapper counts its launches in
  ``.launches``.

The training pair sits under ``PsiSplitNLL``, a ``torch.autograd.Function``
(the counterpart of ``_psi_fused_nll_factory``'s custom VJP,
``pallas_grad.py:577-593``): the forward keeps the state entering each block
of ``unroll`` steps, and the adjoint re-runs each block from its checkpoint
and sweeps back through it, as the TPU kernels do. ``default`` rounds both
operands of every product to bf16 once and sums in fp32.

Shared-memory ceilings on an H100 (232,448 bytes a block), checked before
any launch (``_check_smem``): the sampler, the NLL and the training
forward hold C and R (16 D^2 bytes) and run to D=119; the adjoint also
holds the [D,D] cotangent sums and 12 [D] vectors a step of its block, so
at unroll 16 it runs to D=73 (``csrc/psi_split_bwd.cu``).
"""
from __future__ import annotations

import torch

from ..config import CMPSConfig
from ..models import core
from ..models.cell import make_constants
from . import _build
from .block import (PRECISIONS, _as_kernel_input, _check_inputs,
                    _check_smem, _cuda_or_raise, _make_dot_ops, _ptr,
                    _stream_ptr, n_blocks)

SPLIT_PRECISIONS = ("highest", "default")


def _check_split_options(precision: str, unroll: int = 1):
    if precision == "high":
        raise ValueError(
            "kernel_precision='high' (bf16x3) is only implemented in the "
            "block kernel layout (ops/block.py)")
    if precision not in SPLIT_PRECISIONS:
        raise ValueError(f"precision must be one of {SPLIT_PRECISIONS}, got "
                         f"{precision!r}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")



def psi_split_inputs(params, cfg: CMPSConfig, x, *, noise: bool = False
                     ) -> dict:
    """Kernel inputs from parameters (the TPU wrappers' preambles,
    ``pallas_grad.py:728-743``, ``pallas_scan.py:245-258`` and
    ``:609-622``). ``x`` is waveforms [B, T] for ``psi_nll_split`` and
    ``psi_split_fwd`` (``se`` = the increments / A, [T-1, B], not padded
    to whole blocks), or, with ``noise=True``, the noise [T, N] of
    ``psi_sample_split``."""
    with torch.no_grad():
        cc = make_constants(params, cfg)
        D, cols = cfg.bond_dim, x.shape[1 if noise else 0]
        pr0, pi0 = core.psi0(params, cfg)
        out = dict(cr=cc.Cr, ci=cc.Ci, rr=cc.Rr, ri=cc.Ri, pc=cc.p_c,
                   ps=cc.p_s,
                   s0r=pr0[:, None].expand(D, cols),
                   s0i=pi0[:, None].expand(D, cols))
        if noise:
            out.update(noise=x, inv_a=(1.0 / cc.A).reshape(1))
        else:
            out["se"] = (x[:, 1:] - x[:, :-1]).T / cc.A
        out = {k: _as_kernel_input(v) for k, v in out.items()}
        if noise:
            out["dt"] = float(cfg.delta_t)
        else:
            out["log_eps"] = float(cfg.log_eps if cfg.log_eps > 0
                                   else float("-inf"))
        out["norm_eps"] = float(cfg.norm_eps)
        return out


def _cdot(dotf, mr, mi, vr, vi):
    """(M v) for complex M = mr + i mi and v = vr + i vi, as the kernels
    form it: four real products."""
    return dotf(mr, vr) - dotf(mi, vi), dotf(mr, vi) + dotf(mi, vr)


def _cdot_t(dotf, mrt, mit, vr, vi):
    """The real adjoint of ``_cdot`` applied to v, from the transposes:
    (mr^T vr + mi^T vi, mr^T vi - mi^T vr)."""
    return dotf(mrt, vr) + dotf(mit, vi), dotf(mrt, vi) - dotf(mit, vr)


# ===========================================================================
# Sampler (Euler–Maruyama SDE; reference model.py:242-251)
# ===========================================================================

@torch.no_grad()
def psi_sample_split_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, noise, inv_a, *,
                           dt: float, norm_eps: float,
                           precision: str = "highest"):
    """Running waveform [T, N] (the cumulative sum of the increments; the
    caller scales by A and transposes), the TPU's
    ``pallas_scan._make_psi_sample_kernel``: the expectation on the current
    state, ``inc = e dt + noise``, the update ``C psi + (inc/A) R psi``
    reusing R psi, renormalise, rotate by conj(p). Plain PyTorch, any
    device."""
    _check_split_options(precision)
    prep, dotf = _make_dot_ops(precision)
    crp, cip, rrp, rip = map(prep, (cr, ci, rr, ri))
    pc, ps = pc[:, None], ps[:, None]
    pr, pi = s0r, s0i
    samp = torch.zeros_like(noise[:1])
    out = torch.empty_like(noise)
    for k in range(noise.shape[0]):
        xr, xi = prep(pr), prep(pi)
        rur, rui = _cdot(dotf, rrp, rip, xr, xi)
        g1r, g1i = _cdot(dotf, crp, cip, xr, xi)
        e = 2.0 * torch.sum(pr * rur + pi * rui, dim=0, keepdim=True)
        inc = e * dt + noise[k:k + 1]
        samp = samp + inc
        out[k:k + 1] = samp
        s = inc * inv_a
        yr, yi = g1r + s * rur, g1i + s * rui
        inv = torch.rsqrt(torch.clamp(torch.sum(yr * yr + yi * yi, dim=0,
                                                keepdim=True), min=norm_eps))
        yr, yi = yr * inv, yi * inv
        pr, pi = yr * pc + yi * ps, yi * pc - yr * ps
    return out


@torch.no_grad()
def psi_sample_split(cr, ci, rr, ri, pc, ps, s0r, s0i, noise, inv_a, *,
                     dt: float, norm_eps: float, precision: str = "highest"):
    """Running waveform [T, N]: ``psi_sample_split_plain`` for CPU tensors,
    the CUDA kernel ``csrc/psi_split_sample.cu`` for CUDA tensors."""
    if _cuda_or_raise("psi_sample_split", noise):
        return psi_sample_split_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, noise,
                                      inv_a, dt=dt, norm_eps=norm_eps,
                                      precision=precision)
    _check_split_options(precision)
    T, N = noise.shape
    D = cr.shape[0]
    _check_inputs("psi_sample_split", noise.device, dict(
        cr=(cr, (D, D)), ci=(ci, (D, D)), rr=(rr, (D, D)), ri=(ri, (D, D)),
        pc=(pc, (D,)), ps=(ps, (D,)), s0r=(s0r, (D, N)), s0i=(s0i, (D, N)),
        noise=(noise, (T, N)), inv_a=(inv_a, (1,))))
    lib = _build.library()
    _check_smem("psi_sample_split",
                      lib.amt_psi_split_sample_smem_bytes(D), noise.device, D)
    wave = torch.empty_like(noise)
    if T == 0 or N == 0:
        return wave
    err = lib.amt_psi_split_sample(
        _ptr(cr), _ptr(ci), _ptr(rr), _ptr(ri), _ptr(pc), _ptr(ps),
        _ptr(s0r), _ptr(s0i), _ptr(noise), _ptr(inv_a), _ptr(wave), D, T, N,
        dt, norm_eps, PRECISIONS.index(precision), _stream_ptr(noise.device))
    _build.check(lib, err, "psi_sample_split")
    psi_sample_split.launches += 1
    return wave


psi_sample_split.launches = 0


# ===========================================================================
# Forward chain: the NLL (row 10) and the training forward (row 8)
# ===========================================================================

def _psi_split_chain_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, se, *, log_eps,
                           norm_eps, unroll, precision, defer_norm, ck=None):
    """Per-example NLL [B] (``pallas_scan._make_psi_nll_kernel`` and
    ``pallas_grad._make_psi_fwd_kernel``): y = C psi + s R psi, e = 2 Re
    <y|R|y> on the unnormalised y (divided by the previous |y|^2 inside a
    deferred block), loss -= log(max(1 + e s, log_eps)), then normalise and
    rotate, or, deferred, rotate and renormalise at every ``unroll``-th
    step. ``ck`` = (ckr, cki) receives the state entering each block."""
    _check_split_options(precision, unroll)
    prep, dotf = _make_dot_ops(precision)
    crp, cip, rrp, rip = map(prep, (cr, ci, rr, ri))
    pc, ps = pc[:, None], ps[:, None]
    pr, pi = s0r, s0i
    acc = torch.zeros_like(s0r[:1])
    n2p = torch.ones_like(acc)
    for k in range(se.shape[0]):
        if ck is not None and k % unroll == 0:
            ck[0][k // unroll], ck[1][k // unroll] = pr, pi
        s = se[k:k + 1]
        xr, xi = prep(pr), prep(pi)
        g1r, g1i = _cdot(dotf, crp, cip, xr, xi)
        g2r, g2i = _cdot(dotf, rrp, rip, xr, xi)
        yr, yi = g1r + s * g2r, g1i + s * g2i
        rur, rui = _cdot(dotf, rrp, rip, prep(yr), prep(yi))
        ehat = 2.0 * torch.sum(yr * rur + yi * rui, dim=0, keepdim=True)
        n2 = torch.sum(yr * yr + yi * yi, dim=0, keepdim=True)
        if defer_norm:
            e = ehat / torch.clamp(n2p, min=norm_eps)
            acc = acc - torch.log(torch.clamp(1.0 + e * s, min=log_eps))
            pr, pi = yr * pc + yi * ps, yi * pc - yr * ps
            if (k + 1) % unroll == 0:
                inv = torch.rsqrt(torch.clamp(n2, min=norm_eps))
                pr, pi = pr * inv, pi * inv
                n2p = torch.ones_like(acc)
            else:
                n2p = n2
        else:
            acc = acc - torch.log(torch.clamp(1.0 + ehat * s, min=log_eps))
            inv = torch.rsqrt(torch.clamp(n2, min=norm_eps))
            tr, ti = yr * inv, yi * inv
            pr, pi = tr * pc + ti * ps, ti * pc - tr * ps
    return acc[0]


@torch.no_grad()
def psi_nll_split_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, se, *,
                        log_eps: float, norm_eps: float, unroll: int = 16,
                        precision: str = "highest", defer_norm: bool = False):
    """Per-example NLL [B] over the increments se [T-1, B] (already divided
    by A). Plain PyTorch, any device."""
    return _psi_split_chain_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, se,
                                  log_eps=log_eps, norm_eps=norm_eps,
                                  unroll=unroll, precision=precision,
                                  defer_norm=defer_norm)


@torch.no_grad()
def psi_split_fwd_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, se, *,
                        log_eps: float, norm_eps: float, unroll: int = 16,
                        precision: str = "highest", defer_norm: bool = False):
    """(loss [B], ckr, cki [n_blocks, D, B]): the NLL of
    ``psi_nll_split_plain`` and the state entering every block of
    ``unroll`` steps, normalised in both norm modes (the TPU forward's
    checkpoints, ``pallas_grad.py:132-135``). Plain PyTorch, any device."""
    shape = (n_blocks(se.shape[0], unroll),) + tuple(s0r.shape)
    ck = (se.new_empty(shape), se.new_empty(shape))
    loss = _psi_split_chain_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, se,
                                  log_eps=log_eps, norm_eps=norm_eps,
                                  unroll=unroll, precision=precision,
                                  defer_norm=defer_norm, ck=ck)
    return (loss,) + ck


def _launch_fwd(name, entry, cr, ci, rr, ri, pc, ps, s0r, s0i, se, ck, *,
                log_eps, norm_eps, unroll, precision, defer_norm):
    """Launch the forward template (``csrc/psi_split_fwd.cuh``) through its
    C entry ``entry``; ``ck`` None for the NLL, else the checkpoints to
    write. Returns the loss [B]."""
    _check_split_options(precision, unroll)
    n_steps, B = se.shape
    D = cr.shape[0]
    _check_inputs(name, se.device, dict(
        cr=(cr, (D, D)), ci=(ci, (D, D)), rr=(rr, (D, D)), ri=(ri, (D, D)),
        pc=(pc, (D,)), ps=(ps, (D,)), s0r=(s0r, (D, B)), s0i=(s0i, (D, B)),
        se=(se, (n_steps, B))))
    lib = _build.library()
    _check_smem(name, lib.amt_psi_split_fwd_smem_bytes(D), se.device,
                      D)
    loss = se.new_empty((B,))
    if B == 0:
        return loss
    args = [_ptr(x) for x in (cr, ci, rr, ri, pc, ps, s0r, s0i, se, loss)]
    if ck is not None:
        args += [_ptr(ck[0]), _ptr(ck[1])]
    err = getattr(lib, entry)(
        *args, D, n_steps, B, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), _stream_ptr(se.device))
    _build.check(lib, err, name)
    return loss


@torch.no_grad()
def psi_nll_split(cr, ci, rr, ri, pc, ps, s0r, s0i, se, *, log_eps: float,
                  norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False):
    """Per-example NLL [B]: ``psi_nll_split_plain`` for CPU tensors, the
    CUDA kernel ``csrc/psi_split_nll.cu`` for CUDA tensors."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("psi_nll_split", se):
        return psi_nll_split_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, se, **kw)
    loss = _launch_fwd("psi_nll_split", "amt_psi_split_nll", cr, ci, rr, ri,
                       pc, ps, s0r, s0i, se, None, **kw)
    psi_nll_split.launches += 1
    return loss


psi_nll_split.launches = 0


@torch.no_grad()
def psi_split_fwd(cr, ci, rr, ri, pc, ps, s0r, s0i, se, *, log_eps: float,
                  norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False):
    """(loss [B], ckr, cki): ``psi_split_fwd_plain`` for CPU tensors, the
    CUDA kernel ``csrc/psi_split_fwd.cu`` for CUDA tensors."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("psi_split_fwd", se):
        return psi_split_fwd_plain(cr, ci, rr, ri, pc, ps, s0r, s0i, se, **kw)
    shape = (n_blocks(se.shape[0], unroll),) + tuple(s0r.shape)
    ck = (se.new_empty(shape), se.new_empty(shape))
    loss = _launch_fwd("psi_split_fwd", "amt_psi_split_fwd", cr, ci, rr, ri,
                       pc, ps, s0r, s0i, se, ck, **kw)
    psi_split_fwd.launches += 1
    return (loss,) + ck


psi_split_fwd.launches = 0


# ===========================================================================
# Adjoint (row 8: pallas_grad._make_psi_bwd_kernel :172 and
# _make_psi_bwd_kernel_defer :320)
# ===========================================================================

def _recompute_blocks(crp, cip, rrp, rip, pc, ps, se, ckr, cki, *, unroll,
                      norm_eps, prep, dotf, defer_norm):
    """Every block re-run from its checkpoint, the blocks side by side as a
    leading axis: per step [n_steps, ...] the prepped entry state x, R x,
    y, R y, |y|^2 and 2 Re <y|R|y>, and the |y|^2 of the step before
    inside a deferred block (1 at a block's first step)."""
    n, B = se.shape
    nb = ckr.shape[0]
    sp = torch.cat([se, se.new_zeros(nb * unroll - n, B)]).reshape(
        nb, unroll, 1, B)
    pr, pi = ckr, cki
    n2p = torch.ones_like(ckr[:, :1])
    keep = {k: [] for k in ("xr", "xi", "g2r", "g2i", "yr", "yi", "rur",
                            "rui", "n2", "ehat", "n2p")}
    for k in range(unroll):
        s = sp[:, k]
        xr, xi = prep(pr), prep(pi)
        g1r, g1i = _cdot(dotf, crp, cip, xr, xi)
        g2r, g2i = _cdot(dotf, rrp, rip, xr, xi)
        yr, yi = g1r + s * g2r, g1i + s * g2i
        rur, rui = _cdot(dotf, rrp, rip, prep(yr), prep(yi))
        ehat = 2.0 * torch.sum(yr * rur + yi * rui, dim=1, keepdim=True)
        n2 = torch.sum(yr * yr + yi * yi, dim=1, keepdim=True)
        for name, v in (("xr", xr), ("xi", xi), ("g2r", g2r), ("g2i", g2i),
                        ("yr", yr), ("yi", yi), ("rur", rur), ("rui", rui),
                        ("n2", n2), ("ehat", ehat), ("n2p", n2p)):
            keep[name].append(v)
        if defer_norm:
            pr, pi = yr * pc + yi * ps, yi * pc - yr * ps
            n2p = n2
        else:
            inv = torch.rsqrt(torch.clamp(n2, min=norm_eps))
            tr, ti = yr * inv, yi * inv
            pr, pi = tr * pc + ti * ps, ti * pc - tr * ps
    return {k: torch.stack(v, dim=1).flatten(0, 1)[:n]
            for k, v in keep.items()}


@torch.no_grad()
def psi_split_bwd_plain(cr, ci, rr, ri, pc, ps, se, g, ckr, cki, *,
                        log_eps: float, norm_eps: float, unroll: int = 16,
                        precision: str = "highest", defer_norm: bool = False):
    """Adjoint of ``psi_split_fwd`` for the per-example loss cotangent g
    [B]: (dse [n_steps, B], dcr, dci, drr, dri [D,D], dpc, dps [D], dp0r,
    dp0i [D, B]).

    The TPU's adjoints (``_make_psi_bwd_kernel_defer`` :320 with the
    deferred norm, ``_make_psi_bwd_kernel`` :172 without) re-run each block
    from its checkpoint and sweep back through it. Here the blocks are
    re-run side by side (they are independent given their checkpoints),
    the work that does not depend on the carried cotangent (the loss and
    norm tail, R^T (2 dehat y)) runs over all steps at once, the loop is
    the serial chain dp <- C^T dy + s R^T dy, and the [D,D] cotangents are
    products over all steps and columns at the end. The deferred norm
    seeds (dp, dn2) at each block's exit from its renormalisation and
    carries dn2 back; the per-step norm runs a normalise adjoint each
    step. Plain PyTorch, any device."""
    _check_split_options(precision, unroll)
    prep, dotf = _make_dot_ops(precision)
    crp, cip, rrp, rip = map(prep, (cr, ci, rr, ri))
    crt, cit, rrt, rit = map(prep, (cr.T, ci.T, rr.T, ri.T))
    pc, ps = pc[:, None], ps[:, None]
    n, B = se.shape
    D = cr.shape[0]
    f = _recompute_blocks(crp, cip, rrp, rip, pc, ps, se, ckr, cki,
                          unroll=unroll, norm_eps=norm_eps, prep=prep,
                          dotf=dotf, defer_norm=defer_norm)
    # the loss and norm tail, every step at once
    s = se[:, None, :]
    n2p_c = torch.clamp(f["n2p"], min=norm_eps)
    e = f["ehat"] / n2p_c if defer_norm else f["ehat"]
    arg = torch.clamp(1.0 + e * s, min=log_eps)
    darg = torch.where(arg > log_eps, -g / arg, torch.zeros_like(arg))
    de = darg * s
    ds0 = darg * e
    dehat = de / n2p_c if defer_norm else de
    dn2_new = torch.where(f["n2p"] > norm_eps, -de * e / n2p_c,
                          torch.zeros_like(de))
    q = 2.0 * dehat
    dur, dui = prep(q * f["yr"]), prep(q * f["yi"])
    fix_r, fix_i = q * f["rur"], q * f["rui"]
    radj_r, radj_i = _cdot_t(dotf, rrt, rit, dur, dui)
    # the serial chain
    dpr = dpi = torch.zeros_like(ckr[0])
    dn2 = torch.zeros_like(g)[None]
    dpc_sum = torch.zeros_like(pc[:, 0])
    dps_sum = torch.zeros_like(dpc_sum)
    dse = torch.empty_like(se)
    dyr_all, dyi_all = torch.empty_like(f["yr"]), torch.empty_like(f["yi"])
    for k in reversed(range(n)):
        yr, yi, n2 = f["yr"][k], f["yi"][k], f["n2"][k]
        if defer_norm and (k % unroll == unroll - 1 or k == n - 1):
            # block exit: the renormalisation adjoint seeds (dp, dn2)
            inv = torch.rsqrt(torch.clamp(n2, min=norm_eps))
            er, ei = yr * pc + yi * ps, yi * pc - yr * ps
            dinv = torch.sum(dpr * er + dpi * ei, dim=0, keepdim=True)
            dpr, dpi = dpr * inv, dpi * inv
            dn2 = torch.where(n2 > norm_eps, -0.5 * dinv * inv * inv * inv,
                              torch.zeros_like(dinv))
        if defer_norm:
            tr, ti = yr, yi
        else:
            inv = torch.rsqrt(torch.clamp(n2, min=norm_eps))
            tr, ti = yr * inv, yi * inv
        dtr, dti = dpr * pc - dpi * ps, dpr * ps + dpi * pc
        dpc_sum = dpc_sum + torch.sum(dpr * tr + dpi * ti, dim=1)
        dps_sum = dps_sum + torch.sum(dpr * ti - dpi * tr, dim=1)
        if defer_norm:
            dyr, dyi = dtr, dti
        else:
            dyr, dyi = dtr * inv, dti * inv
            dinv = torch.sum(dtr * yr + dti * yi, dim=0, keepdim=True)
            dn2 = torch.where(n2 > norm_eps, -0.5 * dinv * inv * inv * inv,
                              torch.zeros_like(dinv))
        dyr = dyr + 2.0 * yr * dn2 + fix_r[k] + radj_r[k]
        dyi = dyi + 2.0 * yi * dn2 + fix_i[k] + radj_i[k]
        dse[k] = ds0[k, 0] + torch.sum(dyr * f["g2r"][k] + dyi * f["g2i"][k],
                                       dim=0)
        pyr, pyi = prep(dyr), prep(dyi)
        dyr_all[k], dyi_all[k] = pyr, pyi
        c_r, c_i = _cdot_t(dotf, crt, cit, pyr, pyi)
        r_r, r_i = _cdot_t(dotf, rrt, rit, pyr, pyi)
        dpr, dpi = c_r + se[k] * r_r, c_i + se[k] * r_i
        if defer_norm:
            dn2 = dn2_new[k]

    def lanes(x):                                       # [D, n_steps * B]
        return x.transpose(0, 1).reshape(D, -1)

    xr, xi = lanes(f["xr"]), lanes(f["xi"])
    dyr, dyi = lanes(dyr_all), lanes(dyi_all)
    sdyr, sdyi = lanes(s * dyr_all), lanes(s * dyi_all)
    wr, wi = lanes(prep(f["yr"])), lanes(prep(f["yi"]))
    ur, ui = lanes(dur), lanes(dui)
    dcr = dyr @ xr.T + dyi @ xi.T
    dci = dyi @ xr.T - dyr @ xi.T
    drr = ur @ wr.T + ui @ wi.T + sdyr @ xr.T + sdyi @ xi.T
    dri = ui @ wr.T - ur @ wi.T + sdyi @ xr.T - sdyr @ xi.T
    return dse, dcr, dci, drr, dri, dpc_sum, dps_sum, dpr, dpi


@torch.no_grad()
def psi_split_bwd(cr, ci, rr, ri, pc, ps, se, g, ckr, cki, *, log_eps: float,
                  norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False):
    """(dse, dcr, dci, drr, dri, dpc, dps, dp0r, dp0i):
    ``psi_split_bwd_plain`` for CPU tensors, the CUDA kernel
    ``csrc/psi_split_bwd.cu`` for CUDA tensors. The kernel writes each
    column's cotangent sums ([D,D] x 4 and [D] x 2) to its own row of a
    [B, ...] buffer; their sum over the columns here is a fixed-order
    reduction, so two runs are equal bit for bit."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("psi_split_bwd", se):
        return psi_split_bwd_plain(cr, ci, rr, ri, pc, ps, se, g, ckr, cki,
                                   **kw)
    _check_split_options(precision, unroll)
    n_steps, B = se.shape
    D = cr.shape[0]
    nb = n_blocks(n_steps, unroll)
    _check_inputs("psi_split_bwd", se.device, dict(
        cr=(cr, (D, D)), ci=(ci, (D, D)), rr=(rr, (D, D)), ri=(ri, (D, D)),
        pc=(pc, (D,)), ps=(ps, (D,)), se=(se, (n_steps, B)), g=(g, (B,)),
        ckr=(ckr, (nb, D, B)), cki=(cki, (nb, D, B))))
    lib = _build.library()
    _check_smem("psi_split_bwd",
                      lib.amt_psi_split_bwd_smem_bytes(D, unroll), se.device,
                      D)
    dse = torch.empty_like(se)
    dp0r = se.new_empty((D, B))
    dp0i = se.new_empty((D, B))
    part = se.new_empty((B, 4 * D * D + 2 * D))
    if B == 0:
        part = se.new_zeros((1, 4 * D * D + 2 * D))
    else:
        err = lib.amt_psi_split_bwd(
            *[_ptr(x) for x in (cr, ci, rr, ri, pc, ps, se, g, ckr, cki, dse,
                                dp0r, dp0i, part)],
            D, n_steps, B, unroll, log_eps, norm_eps,
            PRECISIONS.index(precision), int(defer_norm),
            _stream_ptr(se.device))
        _build.check(lib, err, "psi_split_bwd")
        psi_split_bwd.launches += 1
    tot = part.sum(dim=0)
    mats = tot[:4 * D * D].reshape(4, D, D)
    return (dse, mats[0], mats[1], mats[2], mats[3], tot[4 * D * D:][:D],
            tot[4 * D * D + D:], dp0r, dp0i)


psi_split_bwd.launches = 0


class PsiSplitNLL(torch.autograd.Function):
    """Per-example NLL [B] over the split constants with a kernel adjoint:
    the counterpart of ``_psi_fused_nll_factory``'s custom VJP
    (``pallas_grad.py:577-593``). ``forward(cr, ci, rr, ri, pc, ps, s0r,
    s0i, se, opts)`` returns loss [B] and keeps the block checkpoints;
    ``backward(g)`` takes the per-example cotangent g [B], as JAX's
    ``fused_bwd`` does, and returns the cotangents of the nine inputs.
    ``opts`` holds log_eps, norm_eps, unroll, precision and defer_norm.
    Only the values handed to the kernels are detached; autograd carries
    the cotangents on to the parameters outside."""

    @staticmethod
    def forward(ctx, cr, ci, rr, ri, pc, ps, s0r, s0i, se, opts):
        ins = [_as_kernel_input(x) for x in
               (cr, ci, rr, ri, pc, ps, s0r, s0i, se)]
        loss, ckr, cki = psi_split_fwd(*ins, **opts)
        ctx.opts = opts
        ctx.save_for_backward(*ins[:6], ins[8], ckr, cki)
        return loss

    @staticmethod
    def backward(ctx, g):
        cr, ci, rr, ri, pc, ps, se, ckr, cki = ctx.saved_tensors
        (dse, dcr, dci, drr, dri, dpc, dps, dp0r, dp0i) = psi_split_bwd(
            cr, ci, rr, ri, pc, ps, se, _as_kernel_input(g), ckr, cki,
            **ctx.opts)
        return dcr, dci, drr, dri, dpc, dps, dp0r, dp0i, dse, None


def psi_nll_split_trainable(params, cfg: CMPSConfig, signals, *,
                            unroll: int = 16, precision: str = "highest",
                            defer_norm: bool = False):
    """Differentiable mean NLL of waveforms [B, T] through the split
    kernels (the TPU's ``pallas_grad.psi_nll_pallas_trainable`` in its
    split layout; semantics of ``core.psi_nll``). The constants, initial
    state and increments are built with autograd; the loss and its adjoint
    go through ``PsiSplitNLL``. On the card both kernels' shared memory
    is checked before the forward launches, so a shape past the adjoint's
    ceiling raises having launched nothing."""
    _check_split_options(precision, unroll)
    B = signals.shape[0]
    D = cfg.bond_dim
    if signals.device.type == "cuda":
        lib = _build.library()
        _check_smem("psi_split_fwd", lib.amt_psi_split_fwd_smem_bytes(D),
                          signals.device, D)
        _check_smem("psi_split_bwd",
                          lib.amt_psi_split_bwd_smem_bytes(D, unroll),
                          signals.device, D)
    cc = make_constants(params, cfg)
    se = (signals[:, 1:] - signals[:, :-1]).T / cc.A      # [T-1, B]
    pr0, pi0 = core.psi0(params, cfg)
    log_eps = cfg.log_eps if cfg.log_eps > 0 else float("-inf")
    loss = PsiSplitNLL.apply(
        cc.Cr, cc.Ci, cc.Rr, cc.Ri, cc.p_c, cc.p_s, pr0[:, None].expand(D, B),
        pi0[:, None].expand(D, B), se,
        dict(log_eps=float(log_eps), norm_eps=float(cfg.norm_eps),
             unroll=unroll, precision=precision, defer_norm=defer_norm))
    return loss.mean()
