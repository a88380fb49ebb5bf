"""Split-layout kernels for Hopper, psi and rho: the SDE samplers, the
forward-only NLLs and the training NLLs with their adjoints (port of the
split halves of ``audio_mps_tpu/ops/pallas_scan.py`` and
``audio_mps_tpu/ops/pallas_grad.py``; the sibling of ``ops/block.py``).

Layout (as in the JAX package): the state is split into real and imaginary
parts, psi's columns ``pr, pi`` [D, B] and rho's purification factor
``hr, hi`` [D, B * rank] (an example's rank lanes side by side), and each
complex product ``M v`` is four real [D,D] x [D] products. The frame
rotation is not folded into the constants: each step normalises (or, with
the deferred norm, does not) and then rotates by conj(p) (psi) or p (rho)
with ``pc, ps`` [D]. Nothing needs D % 4 == 0, so this layout runs every D
the block layout refuses (training and scoring at D % 4 != 0, the
samplers at D % 8 != 0) and any D asked for with ``kernel_layout="split"``.
Like the TPU's split kernels it takes only the ``highest`` and ``default``
precisions; ``high`` raises ``ValueError`` (the samplers' dispatch in
``ops/scan.py`` runs ``highest`` instead, with a warning, as JAX's does).

Each kernel comes as a pair:

* ``*_plain``: the step loop in plain PyTorch. It is the CPU path and the
  version the CUDA kernel is held to on the card.
* the wrapper (``psi_sample_split``, ``psi_nll_split``, ``psi_split_fwd``,
  ``psi_split_bwd`` and their ``rho_*`` counterparts): a CPU tensor goes to
  the plain version; a CUDA tensor launches the hand-written kernel from
  ``csrc/`` (built by ``ops/_build.py``) or raises. The wrapper counts its
  launches in ``.launches``.

The training pairs sit under ``PsiSplitNLL`` and ``RhoSplitNLL``,
``torch.autograd.Function``s (the counterparts of the custom VJPs of
``_psi_fused_nll_factory``, ``pallas_grad.py:577-593``, and
``_rho_fused_nll_factory``, ``:1309-1331``): the forward keeps the state
entering each block of ``unroll`` steps, and the adjoint re-runs each block
from its checkpoint and sweeps back through it, as the TPU kernels do.
``default`` rounds both operands of every product to bf16 once and sums in
fp32.

Shared-memory ceilings on an H100 (232,448 bytes a block), checked before
any launch (``_check_smem``, ``psi_split_bwd_plan``, ``rho_split_bwd_plan``),
from the kernels' own byte counts (``amt_*_smem_bytes``, mirrored here for
the adjoints' plans):

* psi: the sampler, the NLL and the training forward hold C and R
  (16 D^2 bytes) and run to D=120 (the sampler) and D=119; the adjoint
  also holds the [D,D] cotangent sums and a slab of 12 [D] vectors a step
  of its block, so at unroll 16 it runs to D=73
  (``csrc/psi_split_bwd.cu``).
* rho: the sampler, the NLL and the training forward hold conj(C),
  conj(R) and X^T (24 D^2 bytes) and eight [D, rank] vectors
  (32 D rank bytes), so at full rank they run to D=64; the adjoint holds
  the constants at a row pitch of D + 1 words and 14 [D, rank] vectors
  (its block's slab of saved vectors goes to a device workspace past
  shared memory), so at full rank it runs to D=53
  (``csrc/rho_split_bwd.cu``). Lower ranks go further.
  ``psi_nll_split_trainable`` and ``rho_nll_split_trainable`` check the
  forward and the adjoint before the forward launches.

The adjoints come in two forms of one kernel (``SPLIT_BWD_FORMS``):
"double" runs a re-run role and a sweep role side by side on two slabs,
"single" one role on one slab; rho's slabs sit in shared memory or in the
device workspace (``SPLIT_BWD_PLACEMENTS``). ``psi_split_bwd_plan`` and
``rho_split_bwd_plan`` choose, before the launch, from the shape and the
card's shared memory; every form and placement gives the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CMPSConfig
from ..models import core
from ..models.cell import make_constants
from . import _build
from .complexing import fp32_products
from .block import (H100_SMEM_OPTIN, PRECISIONS, _as_kernel_input,
                    _check_inputs, _check_smem, _cuda_or_raise, _lanes,
                    _make_dot_ops, _ptr, _rank_of, _segment_sum, _smem_optin,
                    _smem_refusal, _stream_ptr, n_blocks, rho_factor_inputs)

SPLIT_PRECISIONS = ("highest", "default")
# the adjoints' forms and rho's slab placements, in the plans' order of
# preference
SPLIT_BWD_FORMS = ("double", "single")
SPLIT_BWD_PLACEMENTS = ("smem", "ws")
_STEP_SCALARS = 4        # s, |y|^2 or trace, ehat, the previous one
_SAVED = 12              # slab vectors a step, psi and rho
_RHO_PIPE_THREADS = 512  # the most threads of a double-form rho CTA


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



def _split_threads(D: int) -> int:
    """Threads of a psi split CTA or adjoint role: D rounded to warps."""
    return -(-D // 32) * 32


def _rho_split_threads(D: int, rank: int) -> int:
    """Threads of a rho split CTA or adjoint role: D rank rounded to
    warps, at most 1024 (``csrc/rho_split_fwd.cuh``)."""
    n = D * rank
    return 1024 if n >= 1024 else -(-n // 32) * 32


# the forwards' loss ring (csrc/psi_split_fwd.cuh, LossRing): its slots in
# psi and rho's warp-local layout, and in rho's element layout
_RING_SLOTS, _RING_SLOTS_CTA = 18, 8


def _loss_ring_words(threads: int, slots: int, lanes: bool) -> int:
    """The loss ring's words: the warp parts of ehat and of |y|^2 (or the
    trace) and the totals and s a slot, and with ``lanes`` each lane's
    parts."""
    return slots * (2 * (threads // 32) + 2 + (2 * threads if lanes else 0))


def psi_split_sample_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one CTA of psi's split sampler
    (``csrc/psi_split_sample.cu``, its ``amt_psi_split_sample_smem_bytes``):
    C and R packed (16 D^2 bytes), the prepped u (8 D) and the exchange's
    32 float2 parts. 231,616 bytes at D=120, the ceiling on an H100."""
    return 4 * (4 * D * D + 2 * D + 64)


def psi_split_fwd_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one CTA of psi's split NLL and training
    forward (``csrc/psi_split_fwd.cuh``, its ``split_fwd_smem_bytes``): C
    and R packed (16 D^2 bytes), the double buffer of the prepped (x, y)
    (32 D), the loss ring (each lane's parts at D <= 32, one warp a CTA;
    the warps' past it) and 64 floats. 231,360 bytes at D=119, the ceiling
    on an H100."""
    t = _split_threads(D)
    return 4 * (4 * D * D + 8 * D
                + _loss_ring_words(t, _RING_SLOTS, t == 32) + 64)


def _sched_walks(warps: int, elems: int) -> int:
    """A warp-local step's walks on the busiest of an SM's four warp
    schedulers."""
    return -(-warps // 4) * elems


class RhoSplitFwdLayout(NamedTuple):
    """The layout of one CTA of rho's split NLL and training forward."""
    cols: int        # whole columns a warp; 0: the element layout
    warps: int
    threads: int
    elems: int       # elements a thread at most (a power of 2)
    slots: int       # the loss ring's
    smem_bytes: int


def rho_split_fwd_layout(D: int, rank: int,
                         warp_local: bool = True) -> RhoSplitFwdLayout:
    """The layout ``csrc/rho_split_fwd.cuh`` launches for an example's
    [D, rank] segment, mirrored from its ``rho_split_fwd_layout``.
    Warp-local where D <= 32: a thread takes ``elems`` elements of its
    warp's cols = floor(32 elems / D) whole columns, so a step synchronises
    its warp alone; elems is the power of 2 up to 8 that gives a step the
    fewest walks on the busiest of an SM's four schedulers, ceil(warps /
    4) x elems (idle lanes cost warps, a thread's elements run in turn),
    the smallest on a tie, with at most 32 warps (one element, 3 columns a
    warp and 4 warps at D=10, rank 10, 0.88x the element layout's time;
    two, 3 columns and 7 warps at D=20, 1.11x it, where one column a warp
    took 1.36x: ``tools/split_forward_sweep.py``, PERF.md).
    Else, or with ``warp_local=False`` (the wrappers' ``_warp_local``), the
    adjoint re-run role's element layout (``cols`` 0: D rank threads
    rounded to warps, at most 1024, each on up to ``elems`` elements; one
    CTA barrier a step). The shared memory: the packed constants (24 D^2
    bytes), the double buffer (32 D rank), the loss ring (18 slots with
    each lane's parts warp-local; 8 slots of warp parts in the element
    layout, which keeps D=64 at full rank, 231,744 bytes, under an H100's
    ceiling) and 64 floats. A pure function of its arguments, as
    ``psi_split_bwd_plan`` is."""
    best = None
    if warp_local and D <= 32:
        for elems in (1, 2, 4, 8):
            cols = 32 * elems // D
            warps = -(-rank // cols)
            if warps <= 32 and (best is None or _sched_walks(warps, elems)
                                < _sched_walks(best[1], best[2])):
                best = (cols, warps, elems)
    if best is not None:
        cols, warps, elems = best
        threads, slots = 32 * warps, _RING_SLOTS
    else:
        cols = 0
        threads = _rho_split_threads(D, rank)
        elems = 1 << (-(-(D * rank) // threads) - 1).bit_length()
        slots = _RING_SLOTS_CTA
    words = (6 * D * D + 8 * D * rank
             + _loss_ring_words(threads, slots, cols > 0) + 64)
    return RhoSplitFwdLayout(cols, threads // 32, threads, elems, slots,
                             4 * words)


class RhoSplitSampleLayout(NamedTuple):
    """The layout of one CTA of rho's split sampler."""
    threads: int
    elems: int       # elements a thread at most (1, 2, 4 or 8)


def rho_split_sample_layout(D: int, rank: int) -> RhoSplitSampleLayout:
    """The layout ``csrc/rho_split_sample.cu`` launches for a chain's
    [D, rank] segment (its C entry checks it with
    ``rho_split_sample_layout_ok``): the element layout, D rank threads
    rounded to warps (at most 1024), each on the fewest elements, a power
    of 2, that cover the segment. A pure function of D and rank; raises
    ValueError past 8 elements a thread (8192 elements, past the ceiling
    of ``rho_split_sample_ceiling_bytes``)."""
    threads = _rho_split_threads(D, rank)
    elems = 1 << (-(-(D * rank) // threads) - 1).bit_length()
    if elems > 8:
        raise ValueError(f"rho split sampler: D={D}, rank {rank} needs "
                         f"{elems} elements a thread, past 8")
    return RhoSplitSampleLayout(threads, elems)


def rho_split_sample_ceiling_bytes(D: int, rank: int) -> int:
    """The split sampler's ceiling, kept from its first design: it takes
    the shapes whose 4 (6 D^2 + 8 D rank + 2 D + 64) bytes fit one block's
    shared memory (D=64 at full rank on an H100, not 65), so that
    ``scan.rho_sampler_fits`` and ``rho_sample_split`` accept the shapes
    they did. The kernel's own CTA (its ``amt_rho_split_sample_smem_bytes``,
    4 (6 D^2 + 4 D rank + 128)) fits wherever the ceiling does."""
    return 4 * (6 * D * D + 8 * D * rank + 2 * D + 64)


def _bwd_reduction_words(unroll: int, warps: int, form: str) -> int:
    """The adjoints' warp partials and reduction floats: the re-run's two
    a step a warp and 64, the sweep's one and 64; the single form's roles
    share them."""
    red_r, red_s = 2 * unroll * warps + 64, unroll * warps + 64
    return red_r + red_s if form == "double" else red_r


def psi_split_bwd_smem_bytes(D: int, unroll: int, form: str) -> int:
    """Dynamic shared memory of one CTA of ``csrc/psi_split_bwd.cu`` in
    ``form`` (its ``psi_split_bwd_words``, 4 bytes a word): 4 mbarriers,
    C and R at a row pitch of D + 1 words, the four [D,D] sums, a double
    buffer of two [D] vectors, the warp partials, the sweep's loss
    adjoints (3 a step) and, a slab, the step scalars and 12 [D] vectors a
    step."""
    slots = 2 if form == "double" else 1
    words = (8 + 4 * D * (D + 1) + 4 * D * D + 4 * D
             + _bwd_reduction_words(unroll, _split_threads(D) // 32, form)
             + 3 * unroll
             + slots * (_STEP_SCALARS + _SAVED * D) * unroll)
    return 4 * words


def rho_split_bwd_smem_bytes(D: int, rank: int, unroll: int,
                             placement: str, form: str) -> int:
    """Dynamic shared memory of one CTA of ``csrc/rho_split_bwd.cu`` with
    its slabs at ``placement`` in ``form`` (its ``rho_split_bwd_words``):
    4 mbarriers, conj(C), conj(R) and X^T at a row pitch of D + 1 words,
    pc and ps, the warp partials, the sweep's loss adjoints (3 a step), 24
    [D, rank] working vectors (double) or 14 (single), the step scalars of
    each slab and, in shared memory, the slabs of 12 [D, rank] vectors a
    step."""
    n = D * rank
    slots = 2 if form == "double" else 1
    words = (8 + 6 * D * (D + 1) + 2 * D
             + _bwd_reduction_words(unroll,
                                    _rho_split_threads(D, rank) // 32, form)
             + 3 * unroll + (24 if form == "double" else 14) * n
             + slots * _STEP_SCALARS * unroll
             + (slots * _SAVED * unroll * n if placement == "smem" else 0))
    return 4 * words


def psi_split_bwd_plan(D: int, unroll: int,
                       smem_optin: int = H100_SMEM_OPTIN) -> str:
    """The form of psi's split adjoint at bond dimension D: "double" (a
    re-run role and a sweep role on two slabs) where its CTA fits
    ``smem_optin`` bytes of shared memory, else "single" (to D=73 at
    unroll 16 on an H100; double to D=63); past that NotImplementedError.
    A pure function of its arguments, as ``block.psi_columns_per_cta`` is.

    Why: the two roles overlap the re-run of one block with the sweep of
    the next, the two halves of the adjoint's step; the single form runs
    them in turn (``tools/split_adjoint_attribution.py``, NVIDIA H100 80GB
    HBM3, 700 W, D=10, B=32, T=65536: 74.2 ms against 107.5)."""
    for form in SPLIT_BWD_FORMS:
        if psi_split_bwd_smem_bytes(D, unroll, form) <= smem_optin:
            return form
    raise _smem_refusal("psi_split_bwd",
                        psi_split_bwd_smem_bytes(D, unroll, "single"),
                        smem_optin, D)


def rho_split_bwd_plan(D: int, rank: int, unroll: int,
                       smem_optin: int = H100_SMEM_OPTIN
                       ) -> tuple[str, str]:
    """(placement, form) of rho's split adjoint for an example's [D, rank]
    segment: the double form where its two roles of D rank threads
    (rounded to warps) fit 512 threads, before the single form, and for
    each the slabs in shared memory before the device workspace, the first
    whose CTA fits ``smem_optin`` bytes. At full rank and unroll 16 on an
    H100: shared memory and double to D=11, the workspace and double at
    D=12-16, the workspace and single from D=17 to the ceiling D=53; past
    that NotImplementedError. A pure function of its arguments.

    Why (``tools/split_adjoint_attribution.py``, NVIDIA H100 80GB HBM3,
    700 W, D=10, B=32, T=65536): the roles overlap the re-run with the
    sweep, 106.9 ms double against 173.0 single with the slabs in shared
    memory, 131.3 against 226.5 in the workspace; the slabs in shared
    memory take the outer products' reads off L2."""
    threads = _rho_split_threads(D, rank)
    for form in SPLIT_BWD_FORMS:
        if form == "double" and 2 * threads > _RHO_PIPE_THREADS:
            continue
        for placement in SPLIT_BWD_PLACEMENTS:
            if rho_split_bwd_smem_bytes(D, rank, unroll, placement,
                                        form) <= smem_optin:
                return placement, form
    raise _smem_refusal("rho_split_bwd",
                        rho_split_bwd_smem_bytes(D, rank, unroll, "ws",
                                                 "single"),
                        smem_optin, D)


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
    reusing R psi, renormalise, rotate by conj(p). The state is carried
    unnormalised, in the kernel's order: u_0 = s0 and u_{k+1} = conj(p) .*
    y_k, the rotated update before its renorm (|conj(p) .* y| = |y|); step
    k forms a1 = C u_k and a2 = R u_k, applies c_k = rsqrt(max(|u_k|^2,
    norm_eps)) (1 at step 0, where s0 is taken as given) after its
    products, e_k = c_k^2 2 sum(u_k . a2) and u_{k+1} = conj(p) .* (c_k (a1
    + s_k a2)), the same recursion in exact arithmetic. Plain PyTorch, any
    device."""
    _check_split_options(precision)
    prep, dotf = _make_dot_ops(precision)
    crp, cip, rrp, rip = map(prep, (cr, ci, rr, ri))
    pc, ps = pc[:, None], ps[:, None]
    ur, ui = s0r, s0i
    samp = torch.zeros_like(noise[:1])
    out = torch.empty_like(noise)
    for k in range(noise.shape[0]):
        xr, xi = prep(ur), prep(ui)
        a2r, a2i = _cdot(dotf, rrp, rip, xr, xi)
        a1r, a1i = _cdot(dotf, crp, cip, xr, xi)
        E = 2.0 * torch.sum(ur * a2r + ui * a2i, dim=0, keepdim=True)
        c = (torch.rsqrt(torch.clamp(torch.sum(ur * ur + ui * ui, dim=0,
                                               keepdim=True), min=norm_eps))
             if k else torch.ones_like(E))
        inc = c * c * E * dt + noise[k:k + 1]
        samp = samp + inc
        out[k:k + 1] = samp
        s = inc * inv_a
        yr, yi = c * (a1r + s * a2r), c * (a1i + s * a2i)
        ur, ui = yr * pc + yi * ps, yi * pc - yr * ps
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
    with fp32_products():
        dcr = dyr @ xr.T + dyi @ xi.T
        dci = dyi @ xr.T - dyr @ xi.T
        drr = ur @ wr.T + ui @ wi.T + sdyr @ xr.T + sdyi @ xi.T
        dri = ui @ wr.T - ur @ wi.T + sdyi @ xr.T - sdyr @ xi.T
    return dse, dcr, dci, drr, dri, dpc_sum, dps_sum, dpr, dpi


@torch.no_grad()
def psi_split_bwd(cr, ci, rr, ri, pc, ps, se, g, ckr, cki, *, log_eps: float,
                  norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False,
                  _form: str | None = None):
    """(dse, dcr, dci, drr, dri, dpc, dps, dp0r, dp0i):
    ``psi_split_bwd_plain`` for CPU tensors, the CUDA kernel
    ``csrc/psi_split_bwd.cu`` for CUDA tensors, in the form
    ``psi_split_bwd_plan`` picks (``_form`` forces one, for the tests and
    tools; the form of the last launch is in ``psi_split_bwd.form``). The
    kernel writes each column's cotangent sums ([D,D] x 4 and [D] x 2) to
    its own row of a [B, ...] buffer; their sum over the columns here is a
    fixed-order reduction, so two runs are equal bit for bit."""
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
    if _form is None:
        form = psi_split_bwd_plan(D, unroll, _smem_optin(se.device))
    elif _form in SPLIT_BWD_FORMS:
        form = _form
        _check_smem("psi_split_bwd",
                    psi_split_bwd_smem_bytes(D, unroll, form), se.device, D)
    else:
        raise ValueError(f"_form must be None or one of {SPLIT_BWD_FORMS}, "
                         f"got {_form!r}")
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
            int(form == "double"), _stream_ptr(se.device))
        _build.check(lib, err, "psi_split_bwd")
        psi_split_bwd.launches += 1
        psi_split_bwd.form = form
    tot = part.sum(dim=0)
    mats = tot[:4 * D * D].reshape(4, D, D)
    return (dse, mats[0], mats[1], mats[2], mats[3], tot[4 * D * D:][:D],
            tot[4 * D * D + D:], dp0r, dp0i)


psi_split_bwd.launches = 0
psi_split_bwd.form = None


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
        psi_split_bwd_plan(D, unroll, _smem_optin(signals.device))
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


# ===========================================================================
# rho in the split layout: the purification factor H = G^T, [D, B * rank]
# (pallas_scan._make_rho_sample_kernel :657, _make_rho_nll_kernel :289,
# pallas_grad._rho_fused_nll_factory :1201)
# ===========================================================================
#
# One step on an example's segment H [D, rank] (its rank lanes), with s the
# increment / A shared by the lanes:
#   y  = conj(C) H + s conj(R) H              (four real products each)
#   gx = X^T y,  ehat = sum(y_r gx_r + y_i gx_i),  tr = |y|^2   (segment sums)
#   per-step norm:  loss -= log(max(1 + ehat s, log_eps));
#                   H = p .* (y rsqrt(max(tr, eps)))
#   deferred norm:  e = ehat / max(tr_prev, eps), the same loss;
#                   H = p .* y, tr_prev = tr, and at every unroll-th step
#                   H *= rsqrt(max(tr, eps)), tr_prev = 1.
# The expectation is taken on the unnormalised y, as the reference's is
# (model.py:160-170). The per-example scalars are computed once an example,
# not repeated over its lanes as the TPU's [1, B * rank] rows are.

RHO_SPLIT_NAMES = ("ccr", "cci", "rcr", "rci", "xtr", "xti", "pc", "ps",
                   "h0r", "h0i")


def rho_split_inputs(params, cfg: CMPSConfig, x, *, noise: bool = False
                     ) -> dict:
    """Kernel inputs from rho parameters (the TPU wrappers' preambles,
    ``pallas_grad.py:1357-1375``, ``pallas_scan.py:435-474`` and
    ``:746-786``): conj(C), conj(R) and X^T as real pairs, ``pc, ps`` [D],
    the normalised initial factor ``h0r, h0i`` [D, cols * rank]
    (``block.rho_factor_inputs``), and, for ``x`` = waveforms [B, T],
    ``se`` = the increments / A [T-1, B], one column an example (the
    TPU's repeat over the rank lanes, ``pallas_scan.py:441``, is a lane
    artefact); with ``noise=True``, ``x`` is the noise [T, N] of
    ``rho_sample_split``."""
    with torch.no_grad():
        cc = make_constants(params, cfg)
        h0r, h0i = rho_factor_inputs(params, cfg, x.shape[1 if noise else 0])
        out = dict(ccr=cc.Cr, cci=-cc.Ci, rcr=cc.Rr, rci=-cc.Ri,
                   xtr=cc.Xr.T, xti=cc.Xi.T, pc=cc.p_c, ps=cc.p_s, h0r=h0r,
                   h0i=h0i)
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


def _rotate_p(yr, yi, pc, ps):
    """p .* y, the rho frame rotation H <- P H (a row scale)."""
    return yr * pc - yi * ps, yr * ps + yi * pc


def _rho_update(dotf, ccp, rcp, xr, xi, s):
    """(y, conj(R) x) for prepped x: y = conj(C) x + s conj(R) x."""
    a1r, a1i = _cdot(dotf, *ccp, xr, xi)
    a2r, a2i = _cdot(dotf, *rcp, xr, xi)
    return a1r + s * a2r, a1i + s * a2i, a2r, a2i


def _rho_split_shapes(D, ccr, cci, rcr, rci, xtr, xti, pc, ps):
    return dict(ccr=(ccr, (D, D)), cci=(cci, (D, D)), rcr=(rcr, (D, D)),
                rci=(rci, (D, D)), xtr=(xtr, (D, D)), xti=(xti, (D, D)),
                pc=(pc, (D,)), ps=(ps, (D,)))


@torch.no_grad()
def rho_sample_split_plain(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i,
                           noise, inv_a, *, dt: float, norm_eps: float,
                           precision: str = "highest"):
    """Running waveform [T, N] of N chains whose factors are h0 [D, N *
    rank] (the caller scales by A and transposes), the TPU's
    ``pallas_scan._make_rho_sample_kernel``: the expectation e = sum(H . X^T
    H) on the current factor, ``inc = e dt + noise``, the update with the
    realised increment / A, renormalise by the trace, rotate by p. The
    factor is carried unnormalised, in the kernel's order: u_0 = h0 and
    u_{k+1} = p .* y_k, the rotated update before its renorm (|p .* y| =
    |y|); step k forms gx = X^T u_k, a1 = conj(C) u_k and a2 = conj(R) u_k,
    applies c_k = rsqrt(max(|u_k|^2, norm_eps)) (1 at step 0, where h0 is
    taken as given) after its products, e_k = c_k^2 sum(u_k . gx) and
    u_{k+1} = p .* (c_k (a1 + s_k a2)), the same recursion in exact
    arithmetic. Plain PyTorch, any device."""
    _check_split_options(precision)
    prep, dotf = _make_dot_ops(precision)
    rank = _rank_of("rho_sample_split", h0r.shape[1], noise.shape[1])
    ccp = (prep(ccr), prep(cci))
    rcp = (prep(rcr), prep(rci))
    xtp = (prep(xtr), prep(xti))
    pc, ps = pc[:, None], ps[:, None]
    ur, ui = h0r, h0i
    samp = torch.zeros_like(noise[0])
    out = torch.empty_like(noise)
    for k in range(noise.shape[0]):
        xr, xi = prep(ur), prep(ui)
        gxr, gxi = _cdot(dotf, *xtp, xr, xi)
        a1r, a1i = _cdot(dotf, *ccp, xr, xi)
        a2r, a2i = _cdot(dotf, *rcp, xr, xi)
        E = _segment_sum(ur * gxr + ui * gxi, rank)
        c = (torch.rsqrt(torch.clamp(_segment_sum(ur * ur + ui * ui, rank),
                                     min=norm_eps))
             if k else torch.ones_like(E))
        inc = c * c * E * dt + noise[k]
        samp = samp + inc
        out[k] = samp
        s, cl = _lanes(inc * inv_a, rank), _lanes(c, rank)
        ur, ui = _rotate_p(cl * (a1r + s * a2r), cl * (a1i + s * a2i), pc,
                           ps)
    return out


@torch.no_grad()
def rho_sample_split(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, noise,
                     inv_a, *, dt: float, norm_eps: float,
                     precision: str = "highest"):
    """Running waveform [T, N]: ``rho_sample_split_plain`` for CPU tensors,
    the CUDA kernel ``csrc/rho_split_sample.cu`` for CUDA tensors in the
    layout of ``rho_split_sample_layout`` (the last launch's in
    ``.layout``). Raises NotImplementedError past the sampler's ceiling
    (``rho_split_sample_ceiling_bytes``)."""
    if _cuda_or_raise("rho_sample_split", noise):
        return rho_sample_split_plain(ccr, cci, rcr, rci, xtr, xti, pc, ps,
                                      h0r, h0i, noise, inv_a, dt=dt,
                                      norm_eps=norm_eps, precision=precision)
    _check_split_options(precision)
    T, N = noise.shape
    D = ccr.shape[0]
    rank = _rank_of("rho_sample_split", h0r.shape[1], N)
    shapes = _rho_split_shapes(D, ccr, cci, rcr, rci, xtr, xti, pc, ps)
    shapes.update(h0r=(h0r, (D, N * rank)), h0i=(h0i, (D, N * rank)),
                  noise=(noise, (T, N)), inv_a=(inv_a, (1,)))
    _check_inputs("rho_sample_split", noise.device, shapes)
    lib = _build.library()
    have = _smem_optin(noise.device)
    if rho_split_sample_ceiling_bytes(D, rank) > have:
        raise NotImplementedError(
            f"rho_sample_split at D={D}, rank {rank}: past the split "
            f"sampler's ceiling (4 (6 D^2 + 8 D rank + 2 D + 64) bytes "
            f"within the {have} of one block; D=64 at full rank). Streaming "
            f"the constants is not ported yet (ROADMAP queue B)")
    lay = rho_split_sample_layout(D, rank)
    wave = torch.empty_like(noise)
    if T == 0 or N == 0:
        return wave
    err = lib.amt_rho_split_sample(
        *[_ptr(x) for x in (ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i,
                            noise, inv_a, wave)],
        D, T, N, rank, lay.threads, lay.elems, dt, norm_eps,
        PRECISIONS.index(precision), _stream_ptr(noise.device))
    _build.check(lib, err, "rho_sample_split")
    rho_sample_split.launches += 1
    rho_sample_split.layout = lay
    return wave


rho_sample_split.launches = 0
rho_sample_split.layout = None


def _rho_split_chain_plain(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i,
                           se, *, log_eps, norm_eps, unroll, precision,
                           defer_norm, ck=None):
    """Per-example NLL [B] (``pallas_scan._make_rho_nll_kernel`` and
    ``pallas_grad._make_rho_fwd_kernel``); ``ck`` = (ckr, cki) receives
    the factor entering each block of ``unroll`` steps."""
    _check_split_options(precision, unroll)
    prep, dotf = _make_dot_ops(precision)
    rank = _rank_of("rho split NLL", h0r.shape[1], se.shape[1])
    ccp = (prep(ccr), prep(cci))
    rcp = (prep(rcr), prep(rci))
    xtp = (prep(xtr), prep(xti))
    pc, ps = pc[:, None], ps[:, None]
    hr, hi = h0r, h0i
    acc = torch.zeros_like(se[0])
    trp = torch.ones_like(acc)
    for k in range(se.shape[0]):
        if ck is not None and k % unroll == 0:
            ck[0][k // unroll], ck[1][k // unroll] = hr, hi
        s = se[k]
        yr, yi, _, _ = _rho_update(dotf, ccp, rcp, prep(hr), prep(hi),
                                   _lanes(s, rank))
        gxr, gxi = _cdot(dotf, *xtp, prep(yr), prep(yi))
        ehat = _segment_sum(yr * gxr + yi * gxi, rank)
        tr = _segment_sum(yr * yr + yi * yi, rank)
        if defer_norm:
            e = ehat / torch.clamp(trp, min=norm_eps)
            acc = acc - torch.log(torch.clamp(1.0 + e * s, min=log_eps))
            hr, hi = _rotate_p(yr, yi, pc, ps)
            if (k + 1) % unroll == 0:
                inv = _lanes(torch.rsqrt(torch.clamp(tr, min=norm_eps)), rank)
                hr, hi = hr * inv, hi * inv
                trp = torch.ones_like(acc)
            else:
                trp = tr
        else:
            acc = acc - torch.log(torch.clamp(1.0 + ehat * s, min=log_eps))
            inv = _lanes(torch.rsqrt(torch.clamp(tr, min=norm_eps)), rank)
            hr, hi = _rotate_p(yr * inv, yi * inv, pc, ps)
    return acc


@torch.no_grad()
def rho_nll_split_plain(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se,
                        *, log_eps: float, norm_eps: float, unroll: int = 16,
                        precision: str = "highest", defer_norm: bool = False):
    """Per-example NLL [B] over the increments se [T-1, B] (already divided
    by A) of factors h0 [D, B * rank]. Plain PyTorch, any device."""
    return _rho_split_chain_plain(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r,
                                  h0i, se, log_eps=log_eps, norm_eps=norm_eps,
                                  unroll=unroll, precision=precision,
                                  defer_norm=defer_norm)


@torch.no_grad()
def rho_split_fwd_plain(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se,
                        *, log_eps: float, norm_eps: float, unroll: int = 16,
                        precision: str = "highest", defer_norm: bool = False):
    """(loss [B], ckr, cki [n_blocks, D, B * rank]): the NLL of
    ``rho_nll_split_plain`` and the factor entering every block of
    ``unroll`` steps, normalised in both norm modes (the TPU forward's
    checkpoints, ``pallas_grad.py:841-842``, ``:856-859``). Plain PyTorch,
    any device."""
    shape = (n_blocks(se.shape[0], unroll),) + tuple(h0r.shape)
    ck = (se.new_empty(shape), se.new_empty(shape))
    loss = _rho_split_chain_plain(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r,
                                  h0i, se, log_eps=log_eps, norm_eps=norm_eps,
                                  unroll=unroll, precision=precision,
                                  defer_norm=defer_norm, ck=ck)
    return (loss,) + ck


def _launch_rho_fwd(name, entry, args, se, ck, *, log_eps, norm_eps, unroll,
                    precision, defer_norm, warp_local):
    """Launch the rho forward template (``csrc/rho_split_fwd.cuh``) through
    its C entry ``entry``; ``args`` are the ten inputs before ``se``, ``ck``
    None for the NLL, else the checkpoints to write; ``warp_local`` False
    forces the element layout. Returns (the loss [B], the layout)."""
    _check_split_options(precision, unroll)
    n_steps, B = se.shape
    D = args[0].shape[0]
    rank = _rank_of(name, args[8].shape[1], B)
    shapes = _rho_split_shapes(D, *args[:8])
    shapes.update(h0r=(args[8], (D, B * rank)), h0i=(args[9], (D, B * rank)),
                  se=(se, (n_steps, B)))
    _check_inputs(name, se.device, shapes)
    lib = _build.library()
    layout = rho_split_fwd_layout(D, rank, warp_local)
    _check_smem(name, lib.amt_rho_split_fwd_layout(D, rank, int(warp_local),
                                                   4), se.device, D)
    loss = se.new_empty((B,))
    if B == 0:
        return loss, layout
    ptrs = [_ptr(x) for x in (*args, se, loss)]
    if ck is not None:
        ptrs += [_ptr(ck[0]), _ptr(ck[1])]
    err = getattr(lib, entry)(
        *ptrs, D, n_steps, B, rank, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), int(warp_local),
        _stream_ptr(se.device))
    _build.check(lib, err, name)
    return loss, layout


@torch.no_grad()
def rho_nll_split(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se, *,
                  log_eps: float, norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False,
                  _warp_local: bool = True):
    """Per-example NLL [B]: ``rho_nll_split_plain`` for CPU tensors, the
    CUDA kernel ``csrc/rho_split_nll.cu`` for CUDA tensors, in the layout
    of ``rho_split_fwd_layout`` (``_warp_local=False`` forces the element
    layout), recorded in ``rho_nll_split.layout``."""
    args = (ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i)
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("rho_nll_split", se):
        return rho_nll_split_plain(*args, se, **kw)
    loss, rho_nll_split.layout = _launch_rho_fwd(
        "rho_nll_split", "amt_rho_split_nll", args, se, None, **kw,
        warp_local=_warp_local)
    rho_nll_split.launches += 1
    return loss


rho_nll_split.launches = 0
rho_nll_split.layout = None


@torch.no_grad()
def rho_split_fwd(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se, *,
                  log_eps: float, norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False,
                  _warp_local: bool = True):
    """(loss [B], ckr, cki): ``rho_split_fwd_plain`` for CPU tensors, the
    CUDA kernel ``csrc/rho_split_fwd.cu`` for CUDA tensors, in the layout
    of ``rho_split_fwd_layout`` (``_warp_local=False`` forces the element
    layout), recorded in ``rho_split_fwd.layout``."""
    args = (ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i)
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("rho_split_fwd", se):
        return rho_split_fwd_plain(*args, se, **kw)
    shape = (n_blocks(se.shape[0], unroll),) + tuple(h0r.shape)
    ck = (se.new_empty(shape), se.new_empty(shape))
    loss, rho_split_fwd.layout = _launch_rho_fwd(
        "rho_split_fwd", "amt_rho_split_fwd", args, se, ck, **kw,
        warp_local=_warp_local)
    rho_split_fwd.launches += 1
    return (loss,) + ck


rho_split_fwd.launches = 0
rho_split_fwd.layout = None


def _rho_recompute_blocks(ccp, rcp, xtp, pc, ps, se, ckr, cki, *, rank,
                          unroll, norm_eps, prep, dotf, defer_norm):
    """Every block re-run from its checkpoint, the blocks side by side as a
    leading axis: per step [n_steps, ...] the prepped entry factor x,
    conj(R) x, y, X^T y, the segment sums ehat and tr, and the trace of
    the step before inside a deferred block (1 at a block's first
    step)."""
    n, B = se.shape
    nb = ckr.shape[0]
    sp = torch.cat([se, se.new_zeros(nb * unroll - n, B)]).reshape(
        nb, unroll, B)
    hr, hi = ckr, cki
    trp = torch.ones_like(sp[:, 0])
    keep = {k: [] for k in ("xr", "xi", "a2r", "a2i", "yr", "yi", "gxr",
                            "gxi", "ehat", "tr", "trp")}
    for k in range(unroll):
        xr, xi = prep(hr), prep(hi)
        yr, yi, a2r, a2i = _rho_update(dotf, ccp, rcp, xr, xi,
                                       _lanes(sp[:, k, None], rank))
        gxr, gxi = _cdot(dotf, *xtp, prep(yr), prep(yi))
        ehat = _segment_sum(yr * gxr + yi * gxi, rank)
        tr = _segment_sum(yr * yr + yi * yi, rank)
        for name, v in (("xr", xr), ("xi", xi), ("a2r", a2r), ("a2i", a2i),
                        ("yr", yr), ("yi", yi), ("gxr", gxr), ("gxi", gxi),
                        ("ehat", ehat), ("tr", tr), ("trp", trp)):
            keep[name].append(v)
        if defer_norm:
            hr, hi = _rotate_p(yr, yi, pc, ps)
            trp = tr
        else:
            inv = _lanes(torch.rsqrt(torch.clamp(tr, min=norm_eps)), rank)
            hr, hi = _rotate_p(yr * inv[:, None], yi * inv[:, None], pc, ps)
    return {k: torch.stack(v, dim=1).flatten(0, 1)[:n]
            for k, v in keep.items()}


@torch.no_grad()
def rho_split_bwd_plain(ccr, cci, rcr, rci, xtr, xti, pc, ps, se, g, ckr,
                        cki, *, log_eps: float, norm_eps: float,
                        unroll: int = 16, precision: str = "highest",
                        defer_norm: bool = False):
    """Adjoint of ``rho_split_fwd`` for the per-example loss cotangent g
    [B]: (dse [n_steps, B], dccr, dcci, drcr, drci, dxtr, dxti [D,D], dpc,
    dps [D], dh0r, dh0i [D, B * rank]).

    The TPU's adjoints (``_make_rho_bwd_kernel_defer`` :1032 with the
    deferred norm, ``_make_rho_bwd_kernel`` :879 without) re-run each block
    from its checkpoint and sweep back through it. Here the blocks are
    re-run side by side, the work that does not depend on the carried
    cotangent (the loss tail, X (dehat y)) runs over all steps at once,
    the loop is the serial chain dH <- conj(C)^T dy + s conj(R)^T dy with
    the rotation and normalise adjoints, and the [D,D] cotangents are
    products over all steps and lanes at the end. The deferred norm seeds
    (dH, dtr) at each block's exit from its renormalisation and carries dtr
    back through e = ehat / tr_prev. dse sums an example's lanes (the
    TPU's VJP of its repeat over them). Plain PyTorch, any device."""
    _check_split_options(precision, unroll)
    prep, dotf = _make_dot_ops(precision)
    rank = _rank_of("rho_split_bwd", ckr.shape[2], se.shape[1])
    ccp = (prep(ccr), prep(cci))
    rcp = (prep(rcr), prep(rci))
    xtp = (prep(xtr), prep(xti))
    cct = (prep(ccr.T), prep(cci.T))
    rct = (prep(rcr.T), prep(rci.T))
    xtt = (prep(xtr.T), prep(xti.T))
    pc, ps = pc[:, None], ps[:, None]
    n, B = se.shape
    D = ccr.shape[0]
    f = _rho_recompute_blocks(ccp, rcp, xtp, pc, ps, se, ckr, cki, rank=rank,
                              unroll=unroll, norm_eps=norm_eps, prep=prep,
                              dotf=dotf, defer_norm=defer_norm)
    # the loss tail, every step at once ([n, B])
    trp_c = torch.clamp(f["trp"], min=norm_eps)
    e = f["ehat"] / trp_c if defer_norm else f["ehat"]
    arg = torch.clamp(1.0 + e * se, min=log_eps)
    darg = torch.where(arg > log_eps, -g / arg, torch.zeros_like(arg))
    de = darg * se
    ds0 = darg * e
    dehat = de / trp_c if defer_norm else de
    dtr_new = torch.where(f["trp"] > norm_eps, -de * e / trp_c,
                          torch.zeros_like(de))
    q = _lanes(dehat, rank)[:, None, :]
    dgr, dgi = prep(q * f["yr"]), prep(q * f["yi"])
    xadj_r, xadj_i = _cdot_t(dotf, *xtt, dgr, dgi)
    fix_r, fix_i = q * f["gxr"] + xadj_r, q * f["gxi"] + xadj_i
    inv_all = torch.rsqrt(torch.clamp(f["tr"], min=norm_eps))
    # the serial chain
    dhr = dhi = torch.zeros_like(ckr[0])
    dtr = torch.zeros_like(g)
    dpc_sum = torch.zeros_like(pc[:, 0])
    dps_sum = torch.zeros_like(dpc_sum)
    dse = torch.empty_like(se)
    dyr_all, dyi_all = torch.empty_like(f["yr"]), torch.empty_like(f["yi"])
    for k in reversed(range(n)):
        yr, yi, tr, inv = f["yr"][k], f["yi"][k], f["tr"][k], inv_all[k]
        if defer_norm and (k % unroll == unroll - 1 or k == n - 1):
            # block exit: the renormalisation adjoint seeds (dH, dtr)
            er, ei = _rotate_p(yr, yi, pc, ps)
            dinv = _segment_sum(dhr * er + dhi * ei, rank)
            dhr, dhi = dhr * _lanes(inv, rank), dhi * _lanes(inv, rank)
            dtr = torch.where(tr > norm_eps, -0.5 * dinv * inv ** 3,
                              torch.zeros_like(dinv))
        if defer_norm:
            tyr, tyi = yr, yi
        else:
            tyr, tyi = yr * _lanes(inv, rank), yi * _lanes(inv, rank)
        dtyr, dtyi = dhr * pc + dhi * ps, dhi * pc - dhr * ps
        dpc_sum = dpc_sum + torch.sum(dhr * tyr + dhi * tyi, dim=1)
        dps_sum = dps_sum + torch.sum(dhi * tyr - dhr * tyi, dim=1)
        if defer_norm:
            dyr, dyi = dtyr, dtyi
        else:
            dyr, dyi = dtyr * _lanes(inv, rank), dtyi * _lanes(inv, rank)
            dinv = _segment_sum(dtyr * yr + dtyi * yi, rank)
            dtr = torch.where(tr > norm_eps, -0.5 * dinv * inv ** 3,
                              torch.zeros_like(dinv))
        dtl = _lanes(dtr, rank)
        dyr = dyr + 2.0 * yr * dtl + fix_r[k]
        dyi = dyi + 2.0 * yi * dtl + fix_i[k]
        dse[k] = ds0[k] + _segment_sum(dyr * f["a2r"][k] + dyi * f["a2i"][k],
                                       rank)
        pyr, pyi = prep(dyr), prep(dyi)
        dyr_all[k], dyi_all[k] = pyr, pyi
        c_r, c_i = _cdot_t(dotf, *cct, pyr, pyi)
        r_r, r_i = _cdot_t(dotf, *rct, pyr, pyi)
        s = _lanes(se[k], rank)
        dhr, dhi = c_r + s * r_r, c_i + s * r_i
        if defer_norm:
            dtr = dtr_new[k]

    def lanes(x):                               # [D, n_steps * B * rank]
        return x.transpose(0, 1).reshape(D, -1)

    s_l = _lanes(se, rank)[:, None, :]
    xr, xi = lanes(f["xr"]), lanes(f["xi"])
    dyr, dyi = lanes(dyr_all), lanes(dyi_all)
    sdyr, sdyi = lanes(s_l * dyr_all), lanes(s_l * dyi_all)
    wr, wi = lanes(prep(f["yr"])), lanes(prep(f["yi"]))
    ur, ui = lanes(dgr), lanes(dgi)
    with fp32_products():
        return (dse, dyr @ xr.T + dyi @ xi.T, dyi @ xr.T - dyr @ xi.T,
                sdyr @ xr.T + sdyi @ xi.T, sdyi @ xr.T - sdyr @ xi.T,
                ur @ wr.T + ui @ wi.T, ui @ wr.T - ur @ wi.T, dpc_sum,
                dps_sum, dhr, dhi)


@torch.no_grad()
def rho_split_bwd(ccr, cci, rcr, rci, xtr, xti, pc, ps, se, g, ckr, cki, *,
                  log_eps: float, norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False,
                  _plan: tuple[str, str] | None = None):
    """(dse, dccr, dcci, drcr, drci, dxtr, dxti, dpc, dps, dh0r, dh0i):
    ``rho_split_bwd_plain`` for CPU tensors, the CUDA kernel
    ``csrc/rho_split_bwd.cu`` for CUDA tensors, at the (placement, form)
    ``rho_split_bwd_plan`` picks (``_plan`` forces one, for the tests and
    tools; that of the last launch is in ``rho_split_bwd.plan``). The
    kernel writes each example's cotangent sums ([D,D] x 6 and [D] x 2) to
    its own row of a [B, ...] buffer; their sum over the examples here is
    a fixed-order reduction, so two runs are equal bit for bit."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    mats = (ccr, cci, rcr, rci, xtr, xti, pc, ps)
    if _cuda_or_raise("rho_split_bwd", se):
        return rho_split_bwd_plain(*mats, se, g, ckr, cki, **kw)
    _check_split_options(precision, unroll)
    n_steps, B = se.shape
    D = ccr.shape[0]
    rank = _rank_of("rho_split_bwd", ckr.shape[2], B)
    nb = n_blocks(n_steps, unroll)
    shapes = _rho_split_shapes(D, *mats)
    shapes.update(se=(se, (n_steps, B)), g=(g, (B,)),
                  ckr=(ckr, (nb, D, B * rank)), cki=(cki, (nb, D, B * rank)))
    _check_inputs("rho_split_bwd", se.device, shapes)
    lib = _build.library()
    if _plan is None:
        placement, form = rho_split_bwd_plan(D, rank, unroll,
                                             _smem_optin(se.device))
    else:
        placement, form = _plan
        if (placement not in SPLIT_BWD_PLACEMENTS
                or form not in SPLIT_BWD_FORMS):
            raise ValueError(f"_plan must be None or a (placement, form) of "
                             f"{SPLIT_BWD_PLACEMENTS} x {SPLIT_BWD_FORMS}, "
                             f"got {_plan!r}")
        _check_smem("rho_split_bwd",
                    rho_split_bwd_smem_bytes(D, rank, unroll, placement,
                                             form), se.device, D)
    dse = torch.empty_like(se)
    dh0r = se.new_empty((D, B * rank))
    dh0i = se.new_empty((D, B * rank))
    width = 6 * D * D + 2 * D
    part = se.new_empty((B, width))
    if B == 0:
        part = se.new_zeros((1, width))
    else:
        ws = None
        if placement == "ws":
            slabs = 2 if form == "double" else 1
            floats = lib.amt_rho_split_bwd_workspace_floats(D, rank, unroll)
            ws = se.new_empty((B, slabs * floats))
        err = lib.amt_rho_split_bwd(
            *[_ptr(x) for x in (*mats, se, g, ckr, cki, dse, dh0r, dh0i,
                                part)],
            _ptr(ws) if ws is not None else None,
            D, n_steps, B, rank, unroll, log_eps, norm_eps,
            PRECISIONS.index(precision), int(defer_norm),
            int(form == "double"), int(placement == "smem"),
            _stream_ptr(se.device))
        _build.check(lib, err, "rho_split_bwd")
        rho_split_bwd.launches += 1
        rho_split_bwd.plan = (placement, form)
    tot = part.sum(dim=0)
    m = tot[:6 * D * D].reshape(6, D, D)
    return (dse, m[0], m[1], m[2], m[3], m[4], m[5], tot[6 * D * D:][:D],
            tot[6 * D * D + D:], dh0r, dh0i)


rho_split_bwd.launches = 0
rho_split_bwd.plan = None


class RhoSplitNLL(torch.autograd.Function):
    """Per-example rho NLL [B] over the split constants with a kernel
    adjoint: the counterpart of ``_rho_fused_nll_factory``'s custom VJP
    (``pallas_grad.py:1309-1331``; its segment matrices z, zt have no
    counterpart here). ``forward(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r,
    h0i, se, opts)`` returns loss [B] and keeps the block checkpoints;
    ``backward(g)`` takes the per-example cotangent g [B] and returns the
    cotangents of the eleven inputs. ``opts`` holds log_eps, norm_eps,
    unroll, precision and defer_norm."""

    @staticmethod
    def forward(ctx, ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se,
                opts):
        ins = [_as_kernel_input(x) for x in
               (ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se)]
        loss, ckr, cki = rho_split_fwd(*ins, **opts)
        ctx.opts = opts
        ctx.save_for_backward(*ins[:8], ins[10], ckr, cki)
        return loss

    @staticmethod
    def backward(ctx, g):
        (ccr, cci, rcr, rci, xtr, xti, pc, ps, se, ckr,
         cki) = ctx.saved_tensors
        out = rho_split_bwd(ccr, cci, rcr, rci, xtr, xti, pc, ps, se,
                            _as_kernel_input(g), ckr, cki, **ctx.opts)
        return out[1:] + (out[0], None)


def rho_nll_split_trainable(params, cfg: CMPSConfig, signals, *,
                            unroll: int = 16, precision: str = "highest",
                            defer_norm: bool = False):
    """Differentiable mean rho NLL of waveforms [B, T] through the split
    kernels (the TPU's ``pallas_grad.rho_nll_pallas_trainable`` in its
    split layout; semantics of ``core.rho_nll``). The constants, initial
    factor and increments are built with autograd; the loss and its
    adjoint go through ``RhoSplitNLL``. On the card both kernels' shared
    memory is checked before the forward launches, so a shape past the
    adjoint's ceiling raises having launched nothing."""
    _check_split_options(precision, unroll)
    B = signals.shape[0]
    D, rank = cfg.bond_dim, params.Wx.shape[0]
    if signals.device.type == "cuda":
        lib = _build.library()
        _check_smem("rho_split_fwd", lib.amt_rho_split_fwd_smem_bytes(D, rank),
                    signals.device, D)
        rho_split_bwd_plan(D, rank, unroll, _smem_optin(signals.device))
    cc = make_constants(params, cfg)
    se = (signals[:, 1:] - signals[:, :-1]).T / cc.A      # [T-1, B]
    h0r, h0i = rho_factor_inputs(params, cfg, B)
    log_eps = cfg.log_eps if cfg.log_eps > 0 else float("-inf")
    loss = RhoSplitNLL.apply(
        cc.Cr, -cc.Ci, cc.Rr, -cc.Ri, cc.Xr.T, cc.Xi.T, cc.p_c, cc.p_s, h0r,
        h0i, se,
        dict(log_eps=float(log_eps), norm_eps=float(cfg.norm_eps),
             unroll=unroll, precision=precision, defer_norm=defer_norm))
    return loss.mean()
