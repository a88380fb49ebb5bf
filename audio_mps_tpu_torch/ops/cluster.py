"""psi's block kernels in the cluster layout: psi trained, scored and
sampled past the quad layout of ``ops/block.py`` (D <= 68), at every
D % 4 == 0 up to 256 (the sampler: D % 8 == 0 from 88).

At D=128 the constants Ab, Bb and Rb take 768 KB in fp32, more than one
SM's registers and shared memory together. The cluster layout spreads a
column's state rows over a thread-block cluster of C CTAs, each holding its
rows of the constants in shared memory, and exchanges the new state's rows
over distributed shared memory once a step (``csrc/psi_cluster.cuh``). The
kernels compute the functions the quad layout's kernels compute, so their
plain versions are ``ops/block.py``'s (``psi_train_fwd_plain``,
``psi_train_bwd_plain``, ...); every output is the same bits at every
cluster size C and every G columns a cluster.

Each kernel has a wrapper here that counts its launches (``.launches``): a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises. ``ops/block.py``'s wrappers route to them past the quad layout
(``psi_block_layout``), so the training, scoring and sampling paths above
are unchanged. Byte counts mirror the C entries (``amt_psi_cl_*``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build, block

PSI_CLUSTERS = (1, 2, 4, 8, 16)   # CTAs a cluster (csrc kClMaxCluster)
PSI_CLUSTER_COLS = (1, 2, 4)      # columns a cluster
PSI_CLUSTER_MAX_D = 256           # kClMaxD
CL_THREADS = 512                  # kClThreads: the most threads a CTA
CL_SLOTS = 4                      # kClSlots: the atoms' rings
CL_TAIL_KS = 16                   # kClTailKs: rows j of S a slab
CL_TAIL_STAGES = 2                # kClTailStages: slabs in flight


def cl_rows(D: int, C: int) -> int:
    """State rows a CTA of the cluster layout holds: 2D / C rounded up to
    whole atoms of 8 rows (``ClLayout::nr``)."""
    n = 2 * D
    return 8 * (-(-n // (8 * C)))


def cl_threads(D: int, C: int) -> int:
    """Threads of one CTA: four a row (``ClLayout::threads``)."""
    return 4 * cl_rows(D, C)


def cl_ok(D: int, C: int) -> bool:
    """Does the cluster layout take D and C (``cl_ok``): D % 4 == 0 up to
    ``PSI_CLUSTER_MAX_D``, C in ``PSI_CLUSTERS`` and a CTA of at most
    ``CL_THREADS`` threads."""
    return (4 <= D <= PSI_CLUSTER_MAX_D and D % 4 == 0 and C in PSI_CLUSTERS
            and cl_threads(D, C) <= CL_THREADS)


def cl_fwd_ok(D: int, C: int) -> bool:
    """Does the cluster forward take D and C (``cl_fwd_ok``): ``cl_ok``, and
    room in the CTA for the loss warp past its row threads. Of the layouts
    whose forward slabs fit an H100's shared memory, only D=64 at C=1 (512
    row threads) has none, and the rule runs D=64 in the quad layout."""
    return cl_ok(D, C) and cl_threads(D, C) + 32 <= CL_THREADS


def _state_words(D: int, G: int) -> int:
    n = 2 * D
    return 4 * n * G + 2 * CL_SLOTS * (n // 8) * G


def psi_cluster_fwd_smem_bytes(D: int, C: int, G: int) -> int:
    """Dynamic shared memory of one forward CTA (``cl_fwd_smem_bytes``):
    Ab, Bb and Rb's slabs of the CTA's rows ([2D][rows] each) and the
    state buffers (two parities of the prepped vectors of G columns, hi and
    lo, and the atoms' rings of two sums)."""
    return 4 * (3 * 2 * D * cl_rows(D, C) + _state_words(D, G))


def psi_cluster_chain_smem_bytes(D: int, C: int, G: int) -> int:
    """Dynamic shared memory of one adjoint-chain CTA
    (``cl_chain_smem_bytes``): Ab^T and Bb^T's slabs and the state
    buffers."""
    return 4 * (2 * 2 * D * cl_rows(D, C) + _state_words(D, G))


def psi_cluster_tail_plan(D: int, precision: str = "highest") -> dict:
    """The tail's tile (``ClTailPlan``): the 2D rows padded to whole slabs
    of ``CL_TAIL_KS`` (``np``), ``rm`` rows x ``rn`` = 8 lanes a thread (8
    x 8; 4 x 8 at high, whose three fmaf chains an output take three
    registers), ``rt`` row threads x ``lt`` lane threads of the CTA's 256
    ``threads``, ``nl`` = rn lt (step, column) lanes a tile
    (at most one a thread), and its dynamic shared memory ``smem`` (S's
    slabs in flight, the tile's prepped y, the row threads' parts of ehat,
    four floats and an 8-byte offset a lane)."""
    high = precision == "high"
    threads, rm, rn = 256, (4 if high else 8), 8
    n = 2 * D
    np_ = CL_TAIL_KS * -(-n // CL_TAIL_KS)
    rt = np_ // rm
    lt = min(threads // rt, threads // rn)
    nl = rn * lt
    y_words = (2 if high else 1) * np_ * nl
    smem = 4 * (CL_TAIL_STAGES * CL_TAIL_KS * np_ + y_words + rt * nl
                + 4 * nl) + 8 * nl
    return dict(threads=threads, np=np_, rm=rm, rn=rn, rt=rt, lt=lt, nl=nl,
                smem=smem)


def psi_cluster_tail_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one tail CTA at D (``cl_tail_smem_bytes``):
    the most any precision's ``psi_cluster_tail_plan`` takes."""
    return max(psi_cluster_tail_plan(D, p)["smem"] for p in block.PRECISIONS)


def psi_cluster_sample_smem_bytes(D: int, C: int) -> int:
    """Dynamic shared memory of one sampler CTA (``cl_sample_words``): Ab
    and Bb's slabs, u raw and prepped, the gathered (a, b) by step parity,
    the rows' twist constants and the atoms of the step's two sums."""
    n = 2 * D
    return 4 * (2 * n * cl_rows(D, C) + 9 * n + 2 * (n // 8))


def _ceiling_refusal(name: str, D: int, why: str):
    return NotImplementedError(
        f"{name} at D={D}: {why}; psi's block kernels take D % 4 == 0 up to "
        f"{PSI_CLUSTER_MAX_D} (ROADMAP queue B)")


def _need(D: int, C: int, G: int) -> int:
    return max(psi_cluster_fwd_smem_bytes(D, C, G),
               psi_cluster_chain_smem_bytes(D, C, G))


def cluster_cols(D: int, B: int, C: int, n_sms: int,
                 smem_optin: int = block.H100_SMEM_OPTIN) -> int:
    """G of the cluster layout at cluster C: the G of ``PSI_CLUSTER_COLS``
    of fewest waves of ceil(B / G) clusters of C CTAs (one CTA an SM), the
    smallest such, among those at which both CTAs fit ``smem_optin``; 1
    where none does (the launch then raises)."""
    fits = [G for G in PSI_CLUSTER_COLS if _need(D, C, G) <= smem_optin]

    def waves(G):
        return -(-(-(-B // G) * C) // n_sms)

    return min(fits, key=lambda G: (waves(G), G)) if fits else 1


def cluster_for(D: int, B: int, n_sms: int,
                smem_optin: int = block.H100_SMEM_OPTIN,
                name: str = "psi") -> tuple:
    """(C, G) of the cluster layout at D for B columns: the smallest C of
    ``PSI_CLUSTERS`` at which both the forward's and the chain's CTAs fit
    ``smem_optin`` at G = 1, and ``cluster_cols`` there. Raises
    NotImplementedError past D=256 and where no cluster holds the
    constants."""
    if D % 4:
        raise _ceiling_refusal(name, D, "D % 4 != 0")
    if D > PSI_CLUSTER_MAX_D:
        raise _ceiling_refusal(
            name, D, f"past the cluster layout, whose forward CTA would "
                     f"need {_need(D, 16, 1)} bytes of shared memory at 16 "
                     f"CTAs a cluster, one column; the card allows "
                     f"{smem_optin} a block")
    for C in PSI_CLUSTERS:
        if cl_fwd_ok(D, C) and _need(D, C, 1) <= smem_optin:
            return C, cluster_cols(D, B, C, n_sms, smem_optin)
    raise _ceiling_refusal(
        name, D, f"the forward's CTA needs {_need(D, 16, 1)} bytes of "
                 f"shared memory at the largest cluster, 16 CTAs; the card "
                 f"allows {smem_optin} a block")


def psi_block_layout(D: int, B: int, n_sms: int,
                     smem_optin: int = block.H100_SMEM_OPTIN,
                     name: str = "psi") -> tuple:
    """(layout, C, G) of psi's block forward and adjoint for B columns at
    bond dimension D on a card of ``n_sms`` SMs and ``smem_optin`` bytes
    of shared memory a block: "quad" with C = 1 and G =
    ``block.psi_columns_per_cta`` exactly where ``block.psi_block_fits``
    holds (D <= 68), else "cluster" with ``cluster_for``'s C and G. A pure
    function of its arguments, as ``block.rho_cluster_for`` is. Raises
    NotImplementedError past D=256, and where no cluster holds the
    constants.

    Why: the forward's CTA keeps its rows of three [2D,2D] constants in
    shared memory (the chain's two), 3 (2D)^2 / C words: at D=128 C=4 is
    the first that fits (217,088 bytes at G=4 against 232,448), and 32
    clusters of 4 CTAs carry B=128 in one wave of 132 SMs; D=256 needs
    C=16, where G=4's state buffers no longer fit beside the slabs."""
    if block.psi_block_fits(D):
        return "quad", 1, block.psi_columns_per_cta(B, D, n_sms, smem_optin)
    return ("cluster",) + cluster_for(D, B, n_sms, smem_optin, name)


def psi_sample_cluster_for(D: int,
                           smem_optin: int = block.H100_SMEM_OPTIN) -> int:
    """Cluster size of the cluster sampler at D: the smallest C of
    ``PSI_CLUSTERS`` whose CTA holds its rows of Ab and Bb within
    ``smem_optin`` (generation waits on one chain's latency, and the walk of
    a step is 2D/4 j a thread at any C, so a chain takes no more SMs than
    its constants need: 4 at D=128, 16 at D=256). Raises
    NotImplementedError where none does."""
    if D % 8 or D > PSI_CLUSTER_MAX_D:
        raise _ceiling_refusal("psi_sample_block", D,
                               "past the cluster sampler (D % 8 == 0)")
    for C in PSI_CLUSTERS:
        if cl_ok(D, C) and psi_cluster_sample_smem_bytes(D, C) <= smem_optin:
            return C
    raise _ceiling_refusal(
        "psi_sample_block", D,
        f"the sampler's CTA needs {psi_cluster_sample_smem_bytes(D, 16)} "
        f"bytes of shared memory at 16 CTAs; the card allows {smem_optin}")


def check_cluster(name: str, D: int, C: int, G: int):
    """Raise ValueError for a cluster or G the layout does not take at D."""
    if not cl_ok(D, C):
        raise ValueError(f"{name}: the cluster layout does not take D={D} "
                         f"at a cluster of {C!r}")
    if G not in PSI_CLUSTER_COLS:
        raise ValueError(f"{name}: G must be one of {PSI_CLUSTER_COLS} in "
                         f"the cluster layout, got {G!r}")


def check_cluster_fwd(name: str, D: int, C: int, G: int):
    """``check_cluster``, and raise ValueError where the forward's CTA has
    no room for its loss warp (``cl_fwd_ok``)."""
    check_cluster(name, D, C, G)
    if not cl_fwd_ok(D, C):
        raise ValueError(
            f"{name}: the cluster forward at D={D} and a cluster of {C} has "
            f"{cl_threads(D, C)} row threads a CTA, no room for its loss "
            f"warp within {CL_THREADS}")


def _smem_or_raise(name: str, need: int, device, D: int):
    have = block._smem_optin(device)
    if need > have:
        raise NotImplementedError(
            f"{name} at D={D} needs {need} bytes of shared memory a CTA of "
            f"its cluster; the card allows {have} (ROADMAP queue B)")


def psi_cluster_recompute_blocks(ctas: int, blocks: int, n_sms: int) -> int:
    """Blocks a span of the cluster recompute: its CTAs (one an SM) load
    their slabs once a span, so as many blocks as keep the ``ctas`` of a
    span set over the segment's ``blocks`` at one wave or more, at least
    one and at most the segment."""
    return max(1, min(blocks, ctas * blocks // n_sms))


# ---------------------------------------------------------------------------
# The wrappers: a CPU tensor runs the plain version, a CUDA tensor the kernel


def _fwd_launch(entry: str, name: str, outs, ab, bb, rb, t0, se, *, log_eps,
                norm_eps, unroll, precision, defer_norm, C, G):
    block._check_options(precision, unroll)
    n_steps, B = se.shape
    n = t0.shape[0]
    D = n // 2
    block._check_inputs(name, se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), rb=(rb, (n, n)), t0=(t0, (n, B)),
        se=(se, (n_steps, B))))
    check_cluster_fwd(name, D, C, G)
    lib = _build.library()
    _smem_or_raise(name, lib.amt_psi_cl_fwd_smem_bytes(D, C, G), se.device,
                   D)
    if B == 0:
        return
    err = getattr(lib, entry)(
        block._ptr(ab), block._ptr(bb), block._ptr(rb), block._ptr(t0),
        block._ptr(se), *[block._ptr(x) for x in outs], D, n_steps, B,
        unroll, log_eps, norm_eps, block.PRECISIONS.index(precision),
        int(defer_norm), C, G, block._stream_ptr(se.device))
    _build.check(lib, err, name)


@torch.no_grad()
def psi_nll_cluster(ab, bb, rb, t0, se, *, log_eps: float, norm_eps: float,
                    unroll: int = 16, precision: str = "highest",
                    defer_norm: bool = False, cluster: int = 4, cols: int = 1):
    """Per-example NLL [B]: ``block.psi_nll_block_plain`` for CPU tensors,
    the CUDA kernel ``csrc/psi_cluster_fwd.cu`` (kNll) for CUDA tensors, in
    clusters of ``cluster`` CTAs, ``cols`` columns a cluster."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if block._cuda_or_raise("psi_nll_cluster", se):
        return block.psi_nll_block_plain(ab, bb, rb, t0, se, **kw)
    loss = se.new_empty((se.shape[1],))
    _fwd_launch("amt_psi_cl_nll", "psi_nll_cluster", (loss,), ab, bb, rb, t0,
                se, C=cluster, G=cols, **kw)
    psi_nll_cluster.launches += 1
    return loss


psi_nll_cluster.launches = 0


@torch.no_grad()
def psi_train_fwd_cluster(ab, bb, rb, t0, se, *, log_eps: float,
                          norm_eps: float, unroll: int = 16,
                          precision: str = "highest",
                          defer_norm: bool = False, cluster: int = 4,
                          cols: int = 1):
    """(loss [B], ys [n_steps, 2D, B], n2s [n_steps, B]):
    ``block.psi_train_fwd_plain`` for CPU tensors, the CUDA kernel
    ``csrc/psi_cluster_fwd.cu`` (kStream) for CUDA tensors."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if block._cuda_or_raise("psi_train_fwd_cluster", se):
        return block.psi_train_fwd_plain(ab, bb, rb, t0, se, **kw)
    n_steps, B = se.shape
    loss = se.new_empty((B,))
    ys = se.new_empty((n_steps, t0.shape[0], B))
    n2s = se.new_empty((n_steps, B))
    _fwd_launch("amt_psi_cl_train_fwd", "psi_train_fwd_cluster",
                (loss, ys, n2s), ab, bb, rb, t0, se, C=cluster, G=cols, **kw)
    psi_train_fwd_cluster.launches += 1
    return loss, ys, n2s


psi_train_fwd_cluster.launches = 0


@torch.no_grad()
def psi_train_fwd_ckpt_cluster(ab, bb, rb, t0, se, *, log_eps: float,
                               norm_eps: float, unroll: int = 16,
                               precision: str = "highest",
                               defer_norm: bool = False, cluster: int = 4,
                               cols: int = 1):
    """(loss [B], ck [n_blocks, 2D, B]): ``block.psi_train_fwd_ckpt_plain``
    for CPU tensors, the CUDA kernel ``csrc/psi_cluster_fwd.cu`` (kCkpt)
    for CUDA tensors."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if block._cuda_or_raise("psi_train_fwd_ckpt_cluster", se):
        return block.psi_train_fwd_ckpt_plain(ab, bb, rb, t0, se, **kw)
    n_steps, B = se.shape
    loss = se.new_empty((B,))
    ck = se.new_empty((block.n_blocks(n_steps, unroll), t0.shape[0], B))
    _fwd_launch("amt_psi_cl_train_fwd_ckpt", "psi_train_fwd_ckpt_cluster",
                (loss, ck), ab, bb, rb, t0, se, C=cluster, G=cols, **kw)
    psi_train_fwd_ckpt_cluster.launches += 1
    return loss, ck


psi_train_fwd_ckpt_cluster.launches = 0


@torch.no_grad()
def psi_recompute_cluster(ab, bb, rb, ck, se, *, norm_eps: float,
                          unroll: int = 16, precision: str = "highest",
                          defer_norm: bool = False, cluster: int = 4,
                          cols: int = 1):
    """(ys, n2s) of a segment: ``block.psi_recompute_plain`` for CPU
    tensors, the CUDA kernel ``csrc/psi_cluster_fwd.cu`` (kRecompute) for
    CUDA tensors, a span of ``psi_cluster_recompute_blocks`` blocks."""
    kw = dict(norm_eps=norm_eps, unroll=unroll, precision=precision,
              defer_norm=defer_norm)
    if block._cuda_or_raise("psi_recompute_cluster", se):
        return block.psi_recompute_plain(ab, bb, rb, ck, se, **kw)
    name = "psi_recompute_cluster"
    block._check_options(precision, unroll)
    n_steps, B = se.shape
    n = ck.shape[1]
    D = n // 2
    block._check_inputs(name, se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), rb=(rb, (n, n)),
        ck=(ck, (block.n_blocks(n_steps, unroll), n, B)),
        se=(se, (n_steps, B))))
    check_cluster_fwd(name, D, cluster, cols)
    lib = _build.library()
    _smem_or_raise(name, lib.amt_psi_cl_fwd_smem_bytes(D, cluster, cols),
                   se.device, D)
    ys = se.new_empty((n_steps, n, B))
    n2s = se.new_empty((n_steps, B))
    if B == 0 or n_steps == 0:
        return ys, n2s
    span = psi_cluster_recompute_blocks(
        -(-B // cols) * cluster, ck.shape[0],
        torch.cuda.get_device_properties(se.device).multi_processor_count)
    err = lib.amt_psi_cl_recompute(
        block._ptr(ab), block._ptr(bb), block._ptr(rb), block._ptr(ck),
        block._ptr(se), block._ptr(ys), block._ptr(n2s), D, n_steps, B,
        unroll, span, norm_eps, block.PRECISIONS.index(precision),
        int(defer_norm), cluster, cols, block._stream_ptr(se.device))
    _build.check(lib, err, name)
    psi_recompute_cluster.launches += 1
    return ys, n2s


psi_recompute_cluster.launches = 0


def _tail_checks(name, rb, se, g, ys, n2s, precision, unroll):
    block._check_options(precision, unroll)
    n_steps, B = se.shape
    n = rb.shape[0]
    D = n // 2
    block._check_inputs(name, se.device, dict(
        rb=(rb, (n, n)), se=(se, (n_steps, B)), g=(g, (B,)),
        ys=(ys, (n_steps, n, B)), n2s=(n2s, (n_steps, B))))
    if D % 2 or D > PSI_CLUSTER_MAX_D:
        raise _ceiling_refusal(name, D, "past the cluster tail")
    lib = _build.library()
    _smem_or_raise(name, lib.amt_psi_cl_tail_smem_bytes(D), se.device, D)
    return lib, n_steps, B, D


@torch.no_grad()
def psi_train_bwd_tail_cluster(rb, se, g, ys, n2s, *, log_eps: float,
                               norm_eps: float, unroll: int = 16,
                               precision: str = "highest",
                               defer_norm: bool = False):
    """(q, ds0, dehat, dn2_new): ``block.psi_train_bwd_tail_plain`` for CPU
    tensors; for CUDA tensors the tail kernel of ``csrc/psi_cluster_bwd.cu``
    alone: one tiled product u = S y with S = Rb + Rb^T (packed by a
    pre-pass into a scratch), ehat = y . u and q = (2 dehat) u
    (``psi_train_bwd_cluster`` launches it before its chain and counts its
    launches here too)."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if block._cuda_or_raise("psi_train_bwd_tail_cluster", se):
        return block.psi_train_bwd_tail_plain(rb, se, g, ys, n2s, **kw)
    lib, n_steps, B, D = _tail_checks("psi_train_bwd_tail_cluster", rb, se, g,
                                      ys, n2s, precision, unroll)
    q = torch.empty_like(ys)
    ds0 = torch.empty_like(se)
    dehat = torch.empty_like(se)
    dn2_new = torch.empty_like(se)
    if B == 0 or n_steps == 0:
        return q, ds0, dehat, dn2_new
    rbp = se.new_empty((rb.numel(),))
    err = lib.amt_psi_cl_tail(
        block._ptr(rb), block._ptr(rbp), block._ptr(se), block._ptr(g),
        block._ptr(ys), block._ptr(n2s), block._ptr(ds0), block._ptr(q),
        block._ptr(dehat), block._ptr(dn2_new), D, n_steps, B, unroll,
        log_eps, norm_eps, block.PRECISIONS.index(precision),
        int(defer_norm), block._stream_ptr(se.device))
    _build.check(lib, err, "psi_train_bwd_tail_cluster")
    psi_train_bwd_tail_cluster.launches += 1
    return q, ds0, dehat, dn2_new


psi_train_bwd_tail_cluster.launches = 0


@torch.no_grad()
def psi_train_bwd_cluster(ab, bb, rb, t0, se, g, ys, n2s, *, log_eps: float,
                          norm_eps: float, unroll: int = 16,
                          precision: str = "highest",
                          defer_norm: bool = False, dtfin=None,
                          cluster: int = 4, cols: int = 1):
    """(dse, dt0, dy, dehat): ``block.psi_train_bwd_plain`` for CPU
    tensors; for CUDA tensors the two kernels of ``csrc/psi_cluster_bwd.cu``
    in one call: the tail over all (step, column) pairs (counted in
    ``psi_train_bwd_tail_cluster.launches``), then the chain in clusters of
    ``cluster`` CTAs, ``cols`` columns a cluster."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if block._cuda_or_raise("psi_train_bwd_cluster", se):
        return block.psi_train_bwd_plain(ab, bb, rb, t0, se, g, ys, n2s,
                                         dtfin=dtfin, **kw)
    name = "psi_train_bwd_cluster"
    lib, n_steps, B, D = _tail_checks(name, rb, se, g, ys, n2s, precision,
                                      unroll)
    n = 2 * D
    block._check_inputs(name, se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), t0=(t0, (n, B))))
    if dtfin is not None:
        block._check_inputs(name, se.device, dict(dtfin=(dtfin, (n, B))))
    check_cluster(name, D, cluster, cols)
    _smem_or_raise(name, lib.amt_psi_cl_chain_smem_bytes(D, cluster, cols),
                   se.device, D)
    dse = torch.empty_like(se)
    dt0 = torch.empty_like(t0)
    dy = torch.empty_like(ys)
    dehat = torch.empty_like(se)
    dn2_new = torch.empty_like(se)    # the tail's, for the chain
    if B == 0:
        return dse, dt0, dy, dehat
    rbp = se.new_empty((n * n,))
    err = lib.amt_psi_cl_train_bwd(
        block._ptr(ab), block._ptr(bb), block._ptr(rb), block._ptr(t0),
        block._ptr(se), block._ptr(g), block._ptr(ys), block._ptr(n2s),
        None if dtfin is None else block._ptr(dtfin), block._ptr(dse),
        block._ptr(dt0), block._ptr(dy), block._ptr(dehat),
        block._ptr(dn2_new), block._ptr(rbp), D, n_steps, B, unroll,
        log_eps, norm_eps, block.PRECISIONS.index(precision),
        int(defer_norm), cluster, cols, block._stream_ptr(se.device))
    _build.check(lib, err, name)
    psi_train_bwd_cluster.launches += 1
    if n_steps > 0:
        psi_train_bwd_tail_cluster.launches += 1
    return dse, dt0, dy, dehat


psi_train_bwd_cluster.launches = 0


@torch.no_grad()
def psi_sample_cluster(ab, bb, pc, ps, t0, noise, inv_a, *, dt: float,
                       norm_eps: float, precision: str = "highest",
                       cluster: Optional[int] = None):
    """Running waveform [T, N]: ``block.psi_sample_block_plain`` for CPU
    tensors, the CUDA kernel ``csrc/psi_cluster_sample.cu`` for CUDA
    tensors, one chain a cluster of ``cluster`` CTAs (None:
    ``psi_sample_cluster_for`` on the card's shared memory; the last
    launch's in ``.cluster``)."""
    if block._cuda_or_raise("psi_sample_cluster", noise):
        return block.psi_sample_block_plain(ab, bb, pc, ps, t0, noise, inv_a,
                                            dt=dt, norm_eps=norm_eps,
                                            precision=precision)
    block._check_options(precision)
    T, N = noise.shape
    D = pc.shape[0]
    name = "psi_sample_cluster"
    block._check_inputs(name, noise.device, dict(
        ab=(ab, (2 * D, 2 * D)), bb=(bb, (2 * D, 2 * D)), pc=(pc, (D,)),
        ps=(ps, (D,)), t0=(t0, (2 * D, N)), noise=(noise, (T, N)),
        inv_a=(inv_a, (1,))))
    C = (psi_sample_cluster_for(D, block._smem_optin(noise.device))
         if cluster is None else cluster)
    check_cluster(name, D, C, 1)
    lib = _build.library()
    _smem_or_raise(name, lib.amt_psi_cl_sample_smem_bytes(D, C),
                   noise.device, D)
    wave = torch.empty_like(noise)
    if T == 0 or N == 0:
        return wave
    err = lib.amt_psi_cl_sample(
        block._ptr(ab), block._ptr(bb), block._ptr(pc), block._ptr(ps),
        block._ptr(t0), block._ptr(noise), block._ptr(inv_a),
        block._ptr(wave), D, T, N, dt, norm_eps,
        block.PRECISIONS.index(precision), C,
        block._stream_ptr(noise.device))
    _build.check(lib, err, name)
    psi_sample_cluster.launches += 1
    psi_sample_cluster.cluster = C
    return wave


psi_sample_cluster.launches = 0
psi_sample_cluster.cluster = None

# the wrappers of the cluster kernels, by the kernel entry they count
WRAPPERS = (psi_sample_cluster, psi_nll_cluster, psi_train_fwd_cluster,
            psi_train_fwd_ckpt_cluster, psi_recompute_cluster,
            psi_train_bwd_tail_cluster, psi_train_bwd_cluster)
