"""Rank-chunked rho training past one block's shared memory (port of
``audio_mps_tpu/ops/pallas_rank.py``, the single-device rank chunking).

The rho block kernels (``ops/block.py``) keep Ab, Bb and Xb resident in one
block's shared memory and an example's whole [2D, rank] factor segment in
one CTA: 224 KB of 227 at D=64, rank 64, and no room beyond. This module
keeps the rho family on hand-written kernels past that ceiling by changing
the kernel boundary, as the JAX package does: the purification factor's
rank rows evolve independently (``G <- G U(s)^dag``), so a kernel that owns
a CHUNK of an example's rows evolves them exactly and emits, per step and
chunk, the partial sums

    ehat[t] = sum over the chunk's rows of Re<row| X |row>   (block-entry
    tr[t]   = sum over the chunk's rows of ||row||^2          scale)

renormalising the chunk's rows by its own trace at every ``unroll``-th
step. The global NLL is rebuilt outside the kernel, in plain differentiable
PyTorch, by ``combine_rank_partials`` in the log domain (gamma is each
chunk's absolute log squared norm at its block entry):

    e[t] = sum_g ehat_g[t] e^{gamma_g - m} / sum_g trp_g[t] e^{gamma_g - m}
    loss = mean_B sum_t -log(max(1 + e[t] s[t], log_eps))

so the per-chunk renormalisations cancel and the value and gradients are
those of the one-kernel path up to the order of the sums.

The kernels (``csrc/rank_partials_fwd.cu``, ``csrc/rank_partials_bwd.cu``
and ``csrc/psi_cotangents.cu`` over the lanes) run every chunk of every
example in one launch, one CTA a (example, chunk) segment, and stream the
[2D,2D] constants from global memory (they stay in the 50 MB L2) through a
ring of shared-memory slabs filled by bulk copies, shared by multicast
within a thread-block cluster of an example's chunks (``partials_cluster``),
so D is bounded by the CTA's thread layout, not by shared memory. Each
comes beside its plain PyTorch version; the wrappers run the plain version
for a CPU tensor and the kernel, or raise, for a CUDA one. Without the
state stream (``kernel_stream="off"``) the forward keeps the block
checkpoints (``rank_partials_fwd_ckpt``) and the recompute adjoint
(``rank_recompute_bwd``) rebuilds one time segment's states at a time
(``csrc/rank_partials_recompute.cu``) before the adjoint and the
reductions run over it.

Layout: the state is [2D, B*rank] as in ``ops/block.py``, example b in
columns b*rank .. (b+1)*rank - 1, its chunk g in the rc columns from
b*rank + g*rc. Segment j = b*G + g (G = rank / rc chunks an example) owns
columns j*rc .. (j+1)*rc - 1; the per-step partials are [n_steps, B*G].
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import CMPSConfig
from ..models.cell import make_constants
from . import _build, block
from .block import (PRECISIONS, _as_kernel_input, _check_inputs,
                    _check_options, _check_smem, _cuda_or_raise, _lanes,
                    _make_dot_ops, _make_dot_ops_bwd, _ptr, _segment_sum,
                    _stream_ptr)

# The H100 SXM: the per-block shared-memory opt-in limit and the SM count;
# the chunk rule reads the card's own on a CUDA tensor, these on the CPU.
H100_SMEM_PER_BLOCK = 232448
H100_SMS = 132
# The partials kernels' CTA (csrc/rank_partials.cuh): 256 consumer threads,
# each an 8 x 4 tile of the [2D, rc] segment (rho_tile.cuh), so
# D/4 x ceil(rc/4) <= 256, and a producer warp; a ring of 4 stages of 8192
# words for the constants' slabs, the prepped state tile, 64 reduction
# floats and 2 mbarriers a stage.
PARTIALS_THREADS = 256
STAGES = 4
STAGE_WORDS = 8192
# The largest thread-block cluster the kernels take (16 is past the portable
# 8), and the adjoint tail's CTAs (csrc/rank_partials_bwd.cu kTailCtas).
MAX_CLUSTER = 16
TAIL_CTAS = 264

# ===========================================================================
# The dispatch rule: one kernel while the constants fit, rank chunks beyond
# ===========================================================================

def partials_fits(D: int, rc: int) -> bool:
    """Does the partials kernels' thread layout take a [2D, rc] segment?"""
    return D % 4 == 0 and rc >= 1 and \
        (D // 4) * -(-rc // 4) <= PARTIALS_THREADS


def partials_smem_bytes(D: int, rc: int) -> int:
    """Dynamic shared memory of a partials CTA (every partials kernel
    takes the same): the ring, the prepped state tile [2D, 4 ceil(rc/4)]
    and 64 reduction floats, 4 bytes a word, and two 8-byte mbarriers a
    stage."""
    return 4 * (STAGES * STAGE_WORDS + 2 * D * 4 * -(-rc // 4) + 64) \
        + 16 * STAGES


def rank_chunk_for(D: int, B: int, rank: int,
                   smem_limit: int = H100_SMEM_PER_BLOCK,
                   n_sms: int = H100_SMS) -> Optional[int]:
    """The chunk of the rank rows one partials CTA owns: a divisor rc of
    ``rank`` whose segment fits the thread layout and ``smem_limit``, or
    None when none does. Among those it takes the rc with the least work
    an SM does, waves x active threads a CTA, ceil(B rank / rc / n_sms) x
    D/4 ceil(rc/4); ties go to the larger rc, whose constant loads serve
    more columns (D=256, rank 256, B=8 on 132 SMs: rc=16, 128 CTAs). No
    precision enters: every precision streams a constant element as 4
    bytes."""
    best, best_cost = None, None
    for rc in range(1, rank + 1):
        if rank % rc or not partials_fits(D, rc) \
                or partials_smem_bytes(D, rc) > smem_limit:
            continue
        ctas = B * (rank // rc)
        cost = -(-ctas // n_sms) * (D // 4) * -(-rc // 4)
        if best_cost is None or cost <= best_cost:
            best, best_cost = rc, cost
    return best


def rho_train_chunk(D: int, B: int, rank: int,
                    smem_limit: int = H100_SMEM_PER_BLOCK,
                    n_sms: int = H100_SMS) -> Optional[int]:
    """The dispatch of rho training: None while the monolithic kernels
    (``ops/block.py``, one CTA holding an example's segment beside the
    resident constants) take (D, rank) within ``smem_limit``; else the rank
    chunk of ``rank_chunk_for``. Raises when neither fits. (The port of the
    decision at ``audio_mps_tpu/training.py:100-140``, not of its v5e
    constants.)"""
    if block.rho_block_fits(D, rank) and \
            block.rho_train_smem_bytes(D, rank) <= smem_limit:
        return None
    rc = rank_chunk_for(D, B, rank, smem_limit, n_sms)
    if rc is None:
        raise NotImplementedError(
            f"rho training at D={D}, rank={rank}: no rank chunk fits the "
            f"partials kernels (D/4 x ceil(chunk/4) <= {PARTIALS_THREADS} "
            f"threads, {smem_limit} bytes of shared memory)")
    return rc


def device_limits(device) -> tuple:
    """(shared memory per block, SM count) of a CUDA device; the H100's
    for any other device, so that the CPU takes the card's branch."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_SMEM_PER_BLOCK, H100_SMS
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin, props.multi_processor_count


def partials_cluster(G: int, ctas: int, resident) -> int:
    """The thread-block cluster of a partials launch of ``ctas`` CTAs whose
    examples have G chunks each: the largest c <= 16 that divides G and
    adds no wave, ceil(ctas / (resident(c) c)) <= ceil(ctas / resident(1)),
    where ``resident(c)`` is the number of c-CTA clusters the card holds at
    once (a mapping or a callable; 0 or less: it takes none); 1 when no
    larger c does. A cluster's CTAs share each constant slab by multicast
    and compute the same bits at every c. (An H100 at the partials CTA's
    shared memory holds 132 CTAs, but only 66 clusters of 2, 30 of 4 and
    15 of 8: the 128 CTAs of the D=256 model run in clusters of 2.)"""
    res = resident if callable(resident) else resident.__getitem__
    waves = -(-ctas // res(1))
    best = 1
    for c in range(2, min(G, MAX_CLUSTER) + 1):
        have = res(c)
        if G % c == 0 and have > 0 and -(-ctas // (have * c)) <= waves:
            best = c
    return best


@functools.lru_cache(maxsize=None)
def _resident_clusters(index: int, D: int, rc: int, c: int) -> int:
    """Clusters of c partials CTAs card ``index`` holds at once."""
    lib = _build.library()
    with torch.cuda.device(index):
        got = lib.amt_rank_partials_max_clusters(D, rc, c)
    if got < 0:
        _build.check(lib, -got, "amt_rank_partials_max_clusters")
    return got


def launch_cluster(D: int, rc: int, G: int, ctas: int, device,
                   cluster: Optional[int] = None) -> int:
    """The cluster a partials launch on a CUDA ``device`` takes:
    ``cluster`` when given (it must divide G and lie in 1 .. 16; the
    kernel then runs in clusters of that many CTAs, whatever the waves),
    else ``partials_cluster`` on the card's own residency."""
    if cluster is not None:
        if not 1 <= cluster <= MAX_CLUSTER or G % cluster:
            raise ValueError(f"a partials cluster of {cluster} CTAs: it "
                             f"must lie in 1 .. {MAX_CLUSTER} and divide "
                             f"the {G} chunks of an example")
        return cluster
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return partials_cluster(
        G, ctas, lambda c: _resident_clusters(index, D, rc, c))


# ===========================================================================
# Kernels and their plain versions
# ===========================================================================

def _n_segments(name, t0, se, rc: int):
    """(S, G): segments of rc columns and chunks an example."""
    cols, B = t0.shape[1], se.shape[1]
    if rc < 1 or B < 1 or cols % (B * rc):
        raise ValueError(f"{name}: {cols} state columns are not {B} examples "
                         f"of whole rank chunks of {rc}")
    return cols // rc, cols // (B * rc)


def _exit_scales(tr, *, rc, unroll, norm_eps):
    """[n_steps, cols]: the factor taking y_k to t_{k+1}: rsqrt(max(tr,
    eps)) of the segment at a block exit, 1 elsewhere."""
    return block._state_scales(_lanes(tr, rc), norm_eps=norm_eps,
                               unroll=unroll, defer_norm=True)


def _partials_chain_plain(ab, bb, xb, t0, se, *, rc, unroll, norm_eps,
                          precision, ys=None, ck=None):
    """(eh [L, S], tr [L, S], tfin): the partials forward's step loop over
    se [L, B] from t0; ``ys[k]`` receives each post-step state and
    ``ck[j]`` the state entering step j * unroll, where given."""
    prep, dotf = _make_dot_ops(precision)
    n, cols = t0.shape
    L, B = se.shape
    S, _ = _n_segments("rank_partials_fwd", t0, se, rc)
    rank = cols // B
    xbp = prep(xb)
    eh = se.new_empty((L, S))
    tr = se.new_empty((L, S))
    t = t0
    for k in range(L):
        if ck is not None and k % unroll == 0:
            ck[k // unroll] = t
        m = ab + se[k][:, None, None] * bb                  # [B, 2D, 2D]
        tb = t.reshape(n, B, rank).transpose(0, 1)          # [B, 2D, rank]
        y = dotf(prep(m), prep(tb)).transpose(0, 1).reshape(n, cols)
        gx = dotf(xbp, prep(y))
        eh[k] = _segment_sum(y * gx, rc)
        tr[k] = _segment_sum(y * y, rc)
        if ys is not None:
            ys[k] = y
        if (k + 1) % unroll == 0:
            y = y * _lanes(torch.rsqrt(torch.clamp(tr[k], min=norm_eps)), rc)
        t = y
    return eh, tr, t


@torch.no_grad()
def rank_partials_fwd_plain(ab, bb, xb, t0, se, *, rc: int, unroll: int,
                            norm_eps: float, precision: str = "highest"):
    """(eh [L, S], tr [L, S], tfin [2D, cols], ys [L, 2D, cols]) of the
    segments of rc columns of t0 over the per-example increments se [L, B]:
    per step y = (Ab + s Bb) t (one s an example), ehat = sum(y .* Xb y) and
    tr = sum(y .* y) per segment, t = y renormalised by its segment's trace
    at every ``unroll``-th step (the math of ``pallas_rank.py:80-149``,
    with ``stream``). Plain PyTorch, any device."""
    ys = t0.new_empty((se.shape[0],) + tuple(t0.shape))
    eh, tr, tfin = _partials_chain_plain(
        ab, bb, xb, t0, se, rc=rc, unroll=unroll, norm_eps=norm_eps,
        precision=precision, ys=ys)
    return eh, tr, tfin, ys


@torch.no_grad()
def rank_partials_fwd_ckpt_plain(ab, bb, xb, t0, se, *, rc: int,
                                 unroll: int, norm_eps: float,
                                 precision: str = "highest"):
    """(eh, tr, tfin, ck [n_blocks, 2D, cols]): ``rank_partials_fwd_plain``
    with the state entering every block of ``unroll`` steps (after the
    previous block's exit renorm) in place of the stream (the TPU forward
    with ``stream=False``). Plain PyTorch, any device."""
    ck = t0.new_empty((block.n_blocks(se.shape[0], unroll),)
                      + tuple(t0.shape))
    eh, tr, tfin = _partials_chain_plain(
        ab, bb, xb, t0, se, rc=rc, unroll=unroll, norm_eps=norm_eps,
        precision=precision, ck=ck)
    return eh, tr, tfin, ck


@torch.no_grad()
def rank_partials_recompute_plain(ab, bb, xb, ck, se, *, rc: int,
                                  unroll: int, norm_eps: float,
                                  precision: str = "highest"):
    """ys [L, 2D, cols] of a time segment that starts at a block entry,
    every block re-run from its checkpoint ck[j]: what
    ``rank_partials_fwd_plain`` streams over those steps. Plain PyTorch,
    any device."""
    L = se.shape[0]
    ys = ck.new_empty((L,) + tuple(ck.shape[1:]))
    for j in range(block.n_blocks(L, unroll)):
        k0 = j * unroll
        _partials_chain_plain(ab, bb, xb, ck[j], se[k0:k0 + unroll], rc=rc,
                              unroll=unroll, norm_eps=norm_eps,
                              precision=precision, ys=ys[k0:k0 + unroll])
    return ys


@torch.no_grad()
def rank_partials_bwd_plain(ab, bb, xb, t0, se, ys, tr, deh, dtr, dtfin, *,
                            rc: int, unroll: int, norm_eps: float,
                            precision: str = "highest"):
    """Adjoint of ``rank_partials_fwd`` for the cotangents deh, dtr
    [L, S] and dtfin [2D, cols]: (dse [L, S], dt0 [2D, cols],
    dy [L, 2D, cols]), the math of ``pallas_rank.py:259-369``. Step k in
    reverse, dt the cotangent of t_{k+1} (dtfin after the last step):
    q = deh (Xb + Xb^T) y; at a block exit dtr += -0.5 sum(dt .* y) inv^3
    (tr > eps) and dt <- dt inv; dy = dt + (2 dtr y + q);
    dse = sum((Bb^T dy) .* t_k) per segment; dt <- Ab^T dy + s Bb^T dy.
    Plain PyTorch, any device."""
    prep, dotf, _ = _make_dot_ops_bwd(precision)
    L, B = se.shape
    rank = t0.shape[1] // B
    S, _ = _n_segments("rank_partials_bwd", t0, se, rc)
    scales = _exit_scales(tr, rc=rc, unroll=unroll, norm_eps=norm_eps)
    xsp = prep(xb + xb.T)
    abT, bbT = prep(ab.T), prep(bb.T)
    dt = dtfin
    dy_all = torch.empty_like(ys)
    dse = se.new_empty((L, S))
    for k in reversed(range(L)):
        y = ys[k]
        q = _lanes(deh[k], rc) * dotf(xsp, prep(y))
        dtr_k = dtr[k]
        if (k + 1) % unroll == 0:
            inv = torch.rsqrt(torch.clamp(tr[k], min=norm_eps))
            dinv = _segment_sum(dt * y, rc)
            dtr_k = dtr_k + torch.where(tr[k] > norm_eps,
                                        -0.5 * dinv * inv * inv * inv,
                                        torch.zeros_like(dinv))
            dt = dt * _lanes(inv, rc)
        dy = dt + (y * _lanes(2.0 * dtr_k, rc) + q)
        dy_all[k] = dy
        pdy = prep(dy)
        du = dotf(bbT, pdy)                             # Bb^T dy
        tk = block._rho_input_state(k, t0, ys, scales)
        dse[k] = _segment_sum(du * tk, rc)
        dt = dotf(abT, pdy) + _lanes(se[k], rank) * du
    return dse, dt, dy_all


@torch.no_grad()
def rank_cotangents_plain(dy, ys, t0, se, tr, deh, *, rc: int, unroll: int,
                          norm_eps: float, precision: str = "highest"):
    """(dAb, dBb, dXb) [2D, 2D]: sums over steps and columns of dy t^T,
    dy (s t)^T and deh y y^T (``pallas_rank.py:356-358``). They are the rho
    cotangents with each segment standing in for an example:
    ``block.rho_cotangents_plain`` over the segments, fed s repeated over
    an example's chunks. Plain PyTorch, any device."""
    _, G = _n_segments("rank_cotangents", t0, se, rc)
    return block.rho_cotangents_plain(
        dy, ys, t0, _lanes(se, G), tr, deh, norm_eps=norm_eps,
        unroll=unroll, precision=precision, defer_norm=True)


def _partials_checks(name, ab, bb, xb, t0, se, rc, precision, unroll,
                     cluster, grid=1):
    """(lib, L, B, D, S, cluster) of a partials launch after its checks:
    ``cluster`` as ``launch_cluster`` takes it for S x ``grid`` CTAs (the
    smaller over the counts when ``grid`` is a tuple)."""
    _check_options(precision, unroll)
    L, B = se.shape
    n, cols = t0.shape
    D = n // 2
    S, G = _n_segments(name, t0, se, rc)
    if not partials_fits(D, rc):
        raise NotImplementedError(
            f"{name} at D={D}, rank chunk {rc}: the partials kernels take "
            f"D % 4 == 0 and D/4 x ceil(chunk/4) <= {PARTIALS_THREADS} "
            f"threads; take a smaller chunk (rank_chunk_for)")
    _check_inputs(name, se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), xb=(xb, (n, n)),
        t0=(t0, (n, cols)), se=(se, (L, B))))
    lib = _build.library()
    _check_smem(name, lib.amt_rank_partials_smem_bytes(D, rc), se.device, D)
    grids = grid if isinstance(grid, tuple) else (grid,)
    cs = min(launch_cluster(D, rc, G, S * g, se.device, cluster)
             for g in grids)
    return lib, L, B, D, S, cs


def tail_split(S: int, n_steps: int) -> int:
    """The step ranges the adjoint tail splits each segment into (about
    TAIL_CTAS CTAs; csrc/rank_partials_bwd.cu tail_split)."""
    return min(-(-TAIL_CTAS // S), n_steps)


@torch.no_grad()
def rank_partials_fwd(ab, bb, xb, t0, se, *, rc: int, unroll: int,
                      norm_eps: float, precision: str = "highest",
                      cluster: Optional[int] = None):
    """(eh, tr, tfin, ys): ``rank_partials_fwd_plain`` for CPU tensors, the
    CUDA kernel ``csrc/rank_partials_fwd.cu`` for CUDA tensors, in clusters
    of ``cluster`` CTAs (``launch_cluster``: the card's rule when None;
    every cluster gives the same bits)."""
    kw = dict(rc=rc, unroll=unroll, norm_eps=norm_eps, precision=precision)
    if _cuda_or_raise("rank_partials_fwd", se):
        return rank_partials_fwd_plain(ab, bb, xb, t0, se, **kw)
    lib, L, B, D, S, cs = _partials_checks(
        "rank_partials_fwd", ab, bb, xb, t0, se, rc, precision, unroll,
        cluster)
    eh = se.new_empty((L, S))
    tr = se.new_empty((L, S))
    tfin = torch.empty_like(t0)
    ys = se.new_empty((L,) + tuple(t0.shape))
    # the kernel reads each constant "j-major" (row j: the coefficients of
    # v[j]): the transposes
    abt, bbt, xbt = (m.t().contiguous() for m in (ab, bb, xb))
    err = lib.amt_rank_partials_fwd(
        _ptr(abt), _ptr(bbt), _ptr(xbt), _ptr(t0), _ptr(se), _ptr(eh),
        _ptr(tr), _ptr(tfin), _ptr(ys), D, L, B, S, rc, unroll, norm_eps,
        PRECISIONS.index(precision), cs, _stream_ptr(se.device))
    _build.check(lib, err, "rank_partials_fwd")
    rank_partials_fwd.launches += 1
    return eh, tr, tfin, ys


rank_partials_fwd.launches = 0


@torch.no_grad()
def rank_partials_fwd_ckpt(ab, bb, xb, t0, se, *, rc: int, unroll: int,
                           norm_eps: float, precision: str = "highest",
                           cluster: Optional[int] = None):
    """(eh, tr, tfin, ck): ``rank_partials_fwd_ckpt_plain`` for CPU tensors,
    the CUDA kernel ``csrc/rank_partials_fwd.cu`` (its checkpoint mode) for
    CUDA tensors, in clusters as ``rank_partials_fwd``."""
    kw = dict(rc=rc, unroll=unroll, norm_eps=norm_eps, precision=precision)
    if _cuda_or_raise("rank_partials_fwd_ckpt", se):
        return rank_partials_fwd_ckpt_plain(ab, bb, xb, t0, se, **kw)
    lib, L, B, D, S, cs = _partials_checks(
        "rank_partials_fwd_ckpt", ab, bb, xb, t0, se, rc, precision, unroll,
        cluster)
    eh = se.new_empty((L, S))
    tr = se.new_empty((L, S))
    tfin = torch.empty_like(t0)
    ck = se.new_empty((block.n_blocks(L, unroll),) + tuple(t0.shape))
    abt, bbt, xbt = (m.t().contiguous() for m in (ab, bb, xb))
    err = lib.amt_rank_partials_fwd_ckpt(
        _ptr(abt), _ptr(bbt), _ptr(xbt), _ptr(t0), _ptr(se), _ptr(eh),
        _ptr(tr), _ptr(tfin), _ptr(ck), D, L, B, S, rc, unroll, norm_eps,
        PRECISIONS.index(precision), cs, _stream_ptr(se.device))
    _build.check(lib, err, "rank_partials_fwd_ckpt")
    rank_partials_fwd_ckpt.launches += 1
    return eh, tr, tfin, ck


rank_partials_fwd_ckpt.launches = 0


@torch.no_grad()
def rank_partials_recompute(ab, bb, xb, ck, se, *, rc: int, unroll: int,
                            norm_eps: float, precision: str = "highest",
                            cluster: Optional[int] = None):
    """ys of a time segment: ``rank_partials_recompute_plain`` for CPU
    tensors, the CUDA kernel ``csrc/rank_partials_recompute.cu`` for CUDA
    tensors (one CTA a segment and block, in clusters of segments as
    ``rank_partials_fwd``)."""
    kw = dict(rc=rc, unroll=unroll, norm_eps=norm_eps, precision=precision)
    if _cuda_or_raise("rank_partials_recompute", se):
        return rank_partials_recompute_plain(ab, bb, xb, ck, se, **kw)
    L = se.shape[0]
    _check_inputs("rank_partials_recompute", se.device, dict(
        ck=(ck, (block.n_blocks(L, unroll),) + tuple(ck.shape[1:]))))
    lib, L, B, D, S, cs = _partials_checks(
        "rank_partials_recompute", ab, bb, xb, ck[0], se, rc, precision,
        unroll, cluster, block.n_blocks(L, unroll))
    ys = se.new_empty((L,) + tuple(ck.shape[1:]))
    abt, bbt = (m.t().contiguous() for m in (ab, bb))
    err = lib.amt_rank_partials_recompute(
        _ptr(abt), _ptr(bbt), _ptr(ck), _ptr(se), _ptr(ys), D, L, B, S, rc,
        unroll, norm_eps, PRECISIONS.index(precision), cs,
        _stream_ptr(se.device))
    _build.check(lib, err, "rank_partials_recompute")
    rank_partials_recompute.launches += 1
    return ys


rank_partials_recompute.launches = 0


@torch.no_grad()
def rank_partials_bwd(ab, bb, xb, t0, se, ys, tr, deh, dtr, dtfin, *,
                      rc: int, unroll: int, norm_eps: float,
                      precision: str = "highest",
                      cluster: Optional[int] = None):
    """(dse, dt0, dy): ``rank_partials_bwd_plain`` for CPU tensors, the
    CUDA kernels of ``csrc/rank_partials_bwd.cu`` (the chain-free tail over
    all steps at once, then the serial chain) for CUDA tensors, both in
    clusters of ``cluster`` CTAs (the rule's smaller choice of the two
    launches when None)."""
    kw = dict(rc=rc, unroll=unroll, norm_eps=norm_eps, precision=precision)
    if _cuda_or_raise("rank_partials_bwd", se):
        return rank_partials_bwd_plain(ab, bb, xb, t0, se, ys, tr, deh, dtr,
                                       dtfin, **kw)
    L = se.shape[0]
    S = _n_segments("rank_partials_bwd", t0, se, rc)[0]
    lib, L, B, D, S, cs = _partials_checks(
        "rank_partials_bwd", ab, bb, xb, t0, se, rc, precision, unroll,
        cluster, (1, max(tail_split(S, L), 1)))
    n, cols = t0.shape
    _check_inputs("rank_partials_bwd", se.device, dict(
        ys=(ys, (L, n, cols)), tr=(tr, (L, S)), deh=(deh, (L, S)),
        dtr=(dtr, (L, S)), dtfin=(dtfin, (n, cols))))
    dse = se.new_empty((L, S))
    dt0 = torch.empty_like(t0)
    dy = torch.empty_like(ys)
    # the tail's Xb + Xb^T (symmetric, so its own j-major form), and the
    # j-major forms of Ab^T and Bb^T (the matrices themselves) for the chain
    xs = xb + xb.t()
    err = lib.amt_rank_partials_bwd(
        _ptr(xs), _ptr(ab), _ptr(bb), _ptr(t0), _ptr(se),
        _ptr(ys), _ptr(tr), _ptr(deh), _ptr(dtr), _ptr(dtfin), _ptr(dse),
        _ptr(dt0), _ptr(dy), D, L, B, S, rc, unroll, norm_eps,
        PRECISIONS.index(precision), cs, _stream_ptr(se.device))
    _build.check(lib, err, "rank_partials_bwd")
    rank_partials_bwd.launches += 1
    return dse, dt0, dy


rank_partials_bwd.launches = 0


@torch.no_grad()
def rank_cotangents(dy, ys, t0, se, tr, deh, *, rc: int, unroll: int,
                    norm_eps: float, precision: str = "highest"):
    """(dAb, dBb, dXb): ``rank_cotangents_plain`` for CPU tensors; for CUDA
    tensors the kernel ``csrc/psi_cotangents.cu`` over the lanes, in
    examples of rank lanes (one s each) and segments of rc lanes (one trace
    and one deh each): its dRb = sum deh y y^T is dXb, and its state
    rebuild is the partials forward's. The launch counts here only."""
    kw = dict(rc=rc, unroll=unroll, norm_eps=norm_eps, precision=precision)
    if _cuda_or_raise("rank_cotangents", se):
        return rank_cotangents_plain(dy, ys, t0, se, tr, deh, **kw)
    _n_segments("rank_cotangents", t0, se, rc)
    rank = t0.shape[1] // se.shape[1]
    return block._cotangents_kernel(
        rank_cotangents, dy, ys, t0, se, tr, deh, gs=rank, gn=rc,
        w_scale=1.0, norm_eps=norm_eps, unroll=unroll, precision=precision,
        defer_norm=True)


rank_cotangents.launches = 0


def _rank_recompute_bwd(fns, ab, bb, xb, ck, se, tr, deh, dtr, dtfin, *,
                        rc, unroll, norm_eps, precision, segment):
    """The recompute adjoint of the partials from the checkpoints ck:
    (dse [L, S], dt0, dAb, dBb, dXb). ``fns`` = (recompute, adjoint,
    cotangents), the plain versions or the kernels, run a segment at a
    time by ``block.recompute_segments_bwd``, each segment's adjoint with
    its dtfin carried in from the next segment (dtfin after the last) and
    its own rows of the cotangents deh and dtr."""
    recompute, adjoint, cotangents = fns
    kw = dict(rc=rc, unroll=unroll, norm_eps=norm_eps, precision=precision)

    def step(k0, k1, cks, s, dt):
        ys = recompute(ab, bb, xb, cks, s, **kw)
        rows = [x[k0:k1] for x in (tr, deh, dtr)]
        d_s, dt, dy = adjoint(ab, bb, xb, cks[0], s, ys, *rows, dt, **kw)
        return d_s, dt, cotangents(dy, ys, cks[0], s, rows[0], rows[1],
                                   **kw)

    return block.recompute_segments_bwd(step, ck, se, torch.empty_like(tr),
                                        dtfin, ab, unroll, segment)


@torch.no_grad()
def rank_recompute_bwd_plain(ab, bb, xb, ck, se, tr, deh, dtr, dtfin, *,
                             rc: int, unroll: int, norm_eps: float,
                             precision: str = "highest",
                             segment: Optional[int] = None):
    """The recompute adjoint of ``rank_partials_fwd_ckpt`` for the
    cotangents deh, dtr [L, S] and dtfin [2D, cols]: (dse [L, S], dt0,
    dAb, dBb, dXb) from the checkpoints ck, with no state stream (the TPU's
    ``_make_rank_partials_bwd_kernel`` :152), over time segments of
    ``segment`` steps (``block.recompute_segment_steps``):
    ``rank_partials_recompute_plain``, ``rank_partials_bwd_plain`` and
    ``rank_cotangents_plain`` on each. Plain PyTorch, any device."""
    return _rank_recompute_bwd(
        (rank_partials_recompute_plain, rank_partials_bwd_plain,
         rank_cotangents_plain), ab, bb, xb, ck, se, tr, deh, dtr, dtfin,
        rc=rc, unroll=unroll, norm_eps=norm_eps, precision=precision,
        segment=segment)


@torch.no_grad()
def rank_recompute_bwd(ab, bb, xb, ck, se, tr, deh, dtr, dtfin, *, rc: int,
                       unroll: int, norm_eps: float,
                       precision: str = "highest",
                       segment: Optional[int] = None):
    """(dse, dt0, dAb, dBb, dXb): ``rank_recompute_bwd_plain`` for CPU
    tensors; for CUDA tensors the same segments through the kernels
    ``rank_partials_recompute``, ``rank_partials_bwd`` and
    ``rank_cotangents``, each counting its own launches."""
    kw = dict(rc=rc, unroll=unroll, norm_eps=norm_eps, precision=precision,
              segment=segment)
    if _cuda_or_raise("rank_recompute_bwd", se):
        return rank_recompute_bwd_plain(ab, bb, xb, ck, se, tr, deh, dtr,
                                        dtfin, **kw)
    return _rank_recompute_bwd(
        (rank_partials_recompute, rank_partials_bwd, rank_cotangents),
        ab, bb, xb, ck, se, tr, deh, dtr, dtfin, **kw)


class RankPartials(torch.autograd.Function):
    """(eh [L, S], tr [L, S], tfin [2D, cols]) of the segments with a
    kernel adjoint: the counterpart of ``_rank_partials_factory``'s custom
    VJP (``pallas_rank.py:372-530``). ``forward(ab, bb, xb, t0, se, opts,
    segment)`` for per-example increments se [L, B];
    ``backward(deh, dtr, dtfin)`` returns (dAb, dBb, dXb, dt0, dse), dse
    per example (the kernel's per segment dse summed over an example's
    chunks). ``opts`` holds rc, unroll, norm_eps and precision. ``segment``
    None runs the streamed pair (``rank_partials_fwd``, then
    ``rank_partials_bwd`` and ``rank_cotangents`` over the whole stream);
    an int the checkpoint forward (``rank_partials_fwd_ckpt``) and the
    recompute adjoint (``rank_recompute_bwd``) in time segments of that
    many steps."""

    @staticmethod
    def forward(ctx, ab, bb, xb, t0, se, opts, segment):
        ins = [_as_kernel_input(x) for x in (ab, bb, xb, t0, se)]
        ctx.opts, ctx.segment = opts, segment
        fwd = rank_partials_fwd if segment is None else rank_partials_fwd_ckpt
        eh, tr, tfin, states = fwd(*ins, **opts)
        ctx.save_for_backward(*ins, states, tr)
        return eh, tr, tfin

    @staticmethod
    def backward(ctx, deh, dtr, dtfin):
        ab, bb, xb, t0, se, states, tr = ctx.saved_tensors
        opts = ctx.opts
        deh, dtr, dtfin = (_as_kernel_input(x) for x in (deh, dtr, dtfin))
        if ctx.segment is None:
            dse, dt0, dy = rank_partials_bwd(ab, bb, xb, t0, se, states, tr,
                                             deh, dtr, dtfin, **opts)
            dab, dbb, dxb = rank_cotangents(dy, states, t0, se, tr, deh,
                                            **opts)
        else:
            dse, dt0, dab, dbb, dxb = rank_recompute_bwd(
                ab, bb, xb, states, se, tr, deh, dtr, dtfin,
                segment=ctx.segment, **opts)
        L, B = se.shape
        return (dab, dbb, dxb, dt0, dse.reshape(L, B, -1).sum(-1), None,
                None)


# ===========================================================================
# The host side: initial chunks, time segments, the combination
# ===========================================================================

def segment_steps(D: int, cols: int, n_steps: int, unroll: int, device,
                  time_segment: Optional[int] = None) -> Optional[int]:
    """Steps per kernel call, a whole number of unroll blocks, or None for
    one call over the whole run. ``time_segment`` is rounded up to whole
    blocks; left None, a CUDA device takes as many steps as half its free
    memory (the card's, and what the caching allocator holds unused)
    holds of one segment's two streams (``ys`` from the forward,
    ``dy`` from the adjoint), at least one block, and any other device the
    whole run. (The port's own policy in place of
    ``pallas_rank.auto_time_segment``.)"""
    if time_segment is None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
        # free on the card, and what PyTorch's allocator holds unused
        free = (torch.cuda.mem_get_info(device)[0]
                + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
        per_step = block.stream_bytes(D, cols, 2)
        time_segment = max(unroll, (free // 2 // per_step) // unroll * unroll)
    steps = -(-time_segment // unroll) * unroll
    return None if steps >= n_steps else steps


def _chunk_t0(params, cfg: CMPSConfig, cc, B: int, rc: int):
    """(t0 [2D, B*rank], c0 [G]): each chunk's rows normalised by their
    own trace, tiled over the examples, in the kernel frame, and the log of
    that trace (``pallas_rank.py:813-828`` for every chunk at once)."""
    wr, wi = params.Wx, params.Wy
    rank, D = wr.shape
    tr0 = (wr * wr + wi * wi).reshape(rank // rc, rc * D).sum(-1)
    scale = torch.rsqrt(torch.clamp(tr0, min=cfg.norm_eps)) \
        .repeat_interleave(rc)[:, None]
    h0r = (wr * scale).T.repeat(1, B)
    h0i = (wi * scale).T.repeat(1, B)
    return (block._rho_block_t0(cc, h0r, h0i),
            torch.log(torch.clamp(tr0, min=cfg.norm_eps)))


def partials_inputs(params, cfg: CMPSConfig, signals, rank_chunk: int):
    """Kernel inputs of ``rank_partials_fwd`` from parameters and waveforms
    [B, T] (ab, bb, xb, t0, se, rc, norm_eps), as
    ``rho_nll_rank_partials`` builds them, detached, and the chunks' log
    scales c0 [G] that ``chunk_partials`` takes."""
    with torch.no_grad():
        cc = make_constants(params, cfg)
        ab, bb, xb = block._rho_block_constants(cc)
        t0, c0 = _chunk_t0(params, cfg, cc, signals.shape[0], rank_chunk)
        se = (signals[:, 1:] - signals[:, :-1]).T / cc.A
        return dict(ab=_as_kernel_input(ab), bb=_as_kernel_input(bb),
                    xb=_as_kernel_input(xb), t0=_as_kernel_input(t0),
                    se=_as_kernel_input(se), rc=rank_chunk,
                    norm_eps=float(cfg.norm_eps)), c0


def rho_nll_rank_partials(params, cfg: CMPSConfig, signals, *,
                          rank_chunk: Optional[int] = None, unroll: int = 16,
                          precision: str = "highest",
                          time_segment: Optional[int] = None):
    """Run the partials kernels on every chunk of ``rank_chunk`` rows of
    params' W (the whole rank when None) over waveforms [B, T]. Returns
    (ehat, trp, gamma) [G, T-1, B], one row of each a chunk, and
    seb [T-1, B] (``pallas_rank.rho_nll_rank_partials``, :740):
      ehat  per-step expectation partials (block-entry scale);
      trp   the previous step's trace partial (1 at block entries);
      gamma the absolute log squared norm of the chunk's rows at each
            step's block entry (log tr0 + the block exits' log traces);
      seb   the per-example increments / A.
    With the state stream the steps run in segments of ``segment_steps``
    steps chained through the final state; each segment's forward runs
    under ``torch.utils.checkpoint``, so the backward holds one segment's
    streams at a time and recomputes its forward. With
    ``kernel_stream="off"`` the forward runs once, keeping the block
    checkpoints, and the recompute adjoint runs in time segments of
    ``time_segment`` steps (``block.recompute_segment_steps``)."""
    if not block.supports_block(cfg):
        raise ValueError(
            f"rank-partials kernels use the block layout (bond_dim % 4 == "
            f"0), got bond_dim={cfg.bond_dim}")
    _check_options(precision, unroll)
    B, T = signals.shape
    rank, D = params.Wx.shape
    rc = rank if rank_chunk is None else rank_chunk
    if rc < 1 or rank % rc:
        raise ValueError(f"rank {rank} must be divisible by rank_chunk {rc}")
    G, n_steps = rank // rc, T - 1
    cc = make_constants(params, cfg)
    se = (signals[:, 1:] - signals[:, :-1]).T / cc.A      # [T-1, B]
    ab, bb, xb = block._rho_block_constants(cc)
    t0, c0 = _chunk_t0(params, cfg, cc, B, rc)
    opts = dict(rc=rc, unroll=unroll, norm_eps=float(cfg.norm_eps),
                precision=precision)
    if cfg.kernel_stream == "off":
        eh, tr, _ = RankPartials.apply(
            ab, bb, xb, t0, se, opts,
            block.recompute_segment_steps(n_steps, unroll, time_segment))
        return chunk_partials(eh, tr, c0, B, unroll=unroll,
                              norm_eps=cfg.norm_eps) + (se,)
    steps = segment_steps(D, B * rank, n_steps, unroll, signals.device,
                          time_segment)
    if steps is None:
        eh, tr, _ = RankPartials.apply(ab, bb, xb, t0, se, opts, None)
    else:
        t, ehs, trs = t0, [], []
        for k0 in range(0, n_steps, steps):
            e_s, r_s, t = checkpoint(RankPartials.apply, ab, bb, xb, t,
                                     se[k0:k0 + steps], opts, None,
                                     use_reentrant=False)
            ehs.append(e_s)
            trs.append(r_s)
        eh, tr = torch.cat(ehs), torch.cat(trs)

    return chunk_partials(eh, tr, c0, B, unroll=unroll,
                          norm_eps=cfg.norm_eps) + (se,)


def chunk_partials(eh, tr, c0, B: int, *, unroll: int, norm_eps: float):
    """(ehat, trp, gamma) [G, n_steps, B] from the kernel's per-segment
    rows eh, tr [n_steps, B*G] and the chunks' log scales c0 [G]
    (``pallas_rank.py:866-878``): trp is the previous step's trace (1 at a
    block entry), gamma c0 plus the log traces of the earlier block exits."""
    n_steps, G = eh.shape[0], c0.shape[0]

    def by_chunk(x):                                    # [G, n_steps, B]
        return x.reshape(n_steps, B, G).permute(2, 0, 1)

    eh, tr = by_chunk(eh), by_chunk(tr)
    K = unroll
    nb = -(-n_steps // K)
    t_pad = nb * K
    tr4 = torch.cat([tr, tr.new_ones((G, t_pad - n_steps, B))],
                    dim=1).reshape(G, nb, K, B)
    trp = torch.cat([tr4.new_ones((G, nb, 1, B)), tr4[:, :, :K - 1]], dim=2)
    blk = torch.log(torch.clamp(tr4[:, :, K - 1], min=norm_eps))
    offs = torch.cat([blk.new_zeros((G, 1, B)),
                      torch.cumsum(blk, dim=1)[:, :-1]], dim=1)
    gam = (c0[:, None, None, None] + offs[:, :, None, :]).expand(G, nb, K, B)
    return (eh, trp.reshape(G, t_pad, B)[:, :n_steps],
            gam.reshape(G, t_pad, B)[:, :n_steps])


def combine_rank_partials(eh, trp, gam, seb, cfg: CMPSConfig):
    """Global mean NLL from stacked chunk partials eh/trp/gam [G, T-1, B]
    and seb [T-1, B] (``pallas_rank.combine_rank_partials``, :881): each
    chunk rescaled to the per-step shift m = max_g gamma, summed, and
    e = num / den is the globally normalised expectation."""
    m = torch.max(gam, dim=0).values
    w = torch.exp(gam - m[None])
    num = torch.sum(eh * w, dim=0)
    den = torch.sum(trp * w, dim=0)
    e = num / torch.clamp(den, min=cfg.norm_eps)
    arg = 1.0 + e * seb
    if cfg.log_eps > 0:
        arg = torch.clamp(arg, min=cfg.log_eps)
    return torch.mean(torch.sum(-torch.log(arg), dim=0))


def rho_nll_rank_chunked(params, cfg: CMPSConfig, signals, *,
                         rank_chunk: Optional[int] = None, unroll: int = 16,
                         precision: str = "highest",
                         time_segment: Optional[int] = None):
    """Differentiable mean rho NLL past the monolithic kernels' ceiling:
    the rank rows in chunks of ``rank_chunk`` (``rank_chunk_for`` the
    signals' device when None), every chunk through the partials kernels,
    combined outside (``pallas_rank.rho_nll_rank_chunked``, :899). The
    partials renormalise at block exits whatever ``cfg.defer_norm`` says,
    as in the JAX package."""
    rank = params.Wx.shape[0]
    B = signals.shape[0]
    if rank_chunk is None:
        rank_chunk = rank_chunk_for(cfg.bond_dim, B, rank,
                                    *device_limits(signals.device))
        if rank_chunk is None:
            raise NotImplementedError(
                f"no rank chunk fits the partials kernels at "
                f"bond_dim={cfg.bond_dim}, rank={rank}")
    parts = rho_nll_rank_partials(params, cfg, signals,
                                  rank_chunk=rank_chunk, unroll=unroll,
                                  precision=precision,
                                  time_segment=time_segment)
    return combine_rank_partials(*parts, cfg)

