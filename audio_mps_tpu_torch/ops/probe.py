"""The per-step floor probe's forward-only psi NLL variants (port of the
kernel of ``tools/probe8_psi_floor.py``'s ``build_variant``).

The probe asks what bounds the serial chain of psi's deferred-norm forward
(block-complex layout, ``ops/block.py``) by restructuring it:

* ``G``: the batch in G contiguous groups of B / G columns. On the card a
  CTA runs one column of each group in lockstep, so each shared-memory load
  of a constant feeds G products and the G chains' latencies overlap. A
  column's value does not depend on G.
* ``paired``: two steps a pass, y2 = (AA t + s0 AB t) + s1 (BA t + s0 BB t)
  beside y1 = Ab t + s0 Bb t: six products on t that do not wait on each
  other, half the serial depth for +50% products. The four products of the
  constants are formed outside the kernel (``probe_products``).
* ``noloss``: the state chain alone; each column's value is |y|^2 of the
  last block's final state before its renorm (the loss tail stripped).

``se`` is zero-padded to whole blocks of ``unroll`` steps, as the TPU tool
pads it: a padded step's loss term is 0, but the state evolves through it.

Each function comes as a pair: ``psi_probe_columns_plain`` (plain PyTorch,
the CPU path and the card's reference) and ``psi_probe_columns``, which
launches ``csrc/psi_probe.cu`` for CUDA tensors and counts its launches in
``.launches``. ``psi_probe_nll`` / ``psi_probe_nll_plain`` take the mean
over the batch, as the tool's ``run`` does.
"""
from __future__ import annotations

import torch

from . import _build
from .complexing import fp32_products
from .block import (PRECISIONS, _check_inputs, _check_options, _check_smem,
                    _cuda_or_raise, _make_dot_ops, _psi_chain_plain, _ptr,
                    _stream_ptr)

GROUPS = (1, 2, 4)


def _check_variant(G: int, paired: bool, noloss: bool, unroll: int,
                   B: int):
    if G not in GROUPS:
        raise ValueError(f"G must be one of {GROUPS}, got {G}")
    if B % G:
        raise ValueError(f"G={G} does not divide the batch B={B}")
    if paired and not noloss and unroll % 2:
        # the TPU tool's range(K // 2) would drop a step of every block
        raise ValueError(f"paired runs two steps a pass and needs an even "
                         f"unroll, got {unroll}")


def pad_steps(se, unroll: int):
    """se [n_steps, B] with zero rows appended to whole blocks of
    ``unroll`` steps (the TPU tool's ``_pad_rows``)."""
    n_steps = se.shape[0]
    t_pad = max(1, -(-n_steps // unroll)) * unroll
    return torch.cat([se, se.new_zeros((t_pad - n_steps, se.shape[1]))])


def probe_products(ab, bb):
    """(AA, AB, BA, BB) = (Ab Ab, Ab Bb, Bb Ab, Bb Bb), the paired variant's
    constants, as true fp32 products (``torch.matmul`` outside the kernel
    under ``fp32_products``, as the TPU tool forms them with ``_dot`` at
    highest)."""
    with fp32_products():
        return ab @ ab, ab @ bb, bb @ ab, bb @ bb


@torch.no_grad()
def psi_probe_columns_plain(consts, t0, se, *, G: int = 1,
                            paired: bool = False, noloss: bool = False,
                            precision: str = "highest", unroll: int = 16,
                            log_eps: float, norm_eps: float):
    """Per-column values [B] of the probe variant: the NLL, or with
    ``noloss`` |y|^2 of the last block's final state. ``consts`` is (Ab,
    Bb, Rb), followed by ``probe_products(Ab, Bb)`` when ``paired``; ``se``
    [n_steps, B] is unpadded. Plain PyTorch, any device; G only groups the
    columns on the card, so it is checked here and changes nothing."""
    _check_options(precision, unroll)
    _check_variant(G, paired, noloss, unroll, se.shape[1])
    se = pad_steps(se, unroll)
    ab, bb, rb = consts[:3]
    if not paired and not noloss:
        return _psi_chain_plain(ab, bb, rb, t0, se, log_eps=log_eps,
                                norm_eps=norm_eps, unroll=unroll,
                                precision=precision, defer_norm=True)
    prep, dotf = _make_dot_ops(precision)
    abp, bbp = prep(ab), prep(bb)
    t = t0
    if noloss:
        for j in range(se.shape[0] // unroll):
            tp = prep(t)
            for k in range(j * unroll, (j + 1) * unroll):
                t = dotf(abp, tp) + se[k:k + 1] * dotf(bbp, tp)
                tp = prep(t)
            n2 = torch.sum(t * t, dim=0)
            t = t * torch.rsqrt(torch.clamp(n2, min=norm_eps))
        return n2
    rbp = prep(rb)
    aa, ab2, ba, bb2 = (prep(m) for m in consts[3:])
    acc = torch.zeros_like(t0[0])
    n2p = torch.ones_like(acc)

    def term(y, s, n2p):
        ehat = 2.0 * torch.sum(y * dotf(rbp, prep(y)), dim=0)
        e = ehat / torch.clamp(n2p, min=norm_eps)
        return torch.log(torch.clamp(1.0 + e * s, min=log_eps))

    for k in range(0, se.shape[0], 2):
        s0, s1 = se[k:k + 1], se[k + 1:k + 2]
        tp = prep(t)
        y1 = dotf(abp, tp) + s0 * dotf(bbp, tp)
        y2 = ((dotf(aa, tp) + s0 * dotf(ab2, tp))
              + s1 * (dotf(ba, tp) + s0 * dotf(bb2, tp)))
        acc = acc - term(y1, s0[0], n2p)
        n2_1 = torch.sum(y1 * y1, dim=0)
        acc = acc - term(y2, s1[0], n2_1)
        n2p = torch.sum(y2 * y2, dim=0)
        t = y2
        if (k + 2) % unroll == 0:
            t = y2 * torch.rsqrt(torch.clamp(n2p, min=norm_eps))
            n2p = torch.ones_like(acc)
    return acc


@torch.no_grad()
def psi_probe_columns(consts, t0, se, *, G: int = 1, paired: bool = False,
                      noloss: bool = False, precision: str = "highest",
                      unroll: int = 16, log_eps: float, norm_eps: float):
    """Per-column values [B]: ``psi_probe_columns_plain`` for CPU tensors,
    the CUDA kernel ``csrc/psi_probe.cu`` (B / G CTAs of G columns) for
    CUDA tensors."""
    kw = dict(G=G, paired=paired, noloss=noloss, precision=precision,
              unroll=unroll, log_eps=log_eps, norm_eps=norm_eps)
    if _cuda_or_raise("psi_probe_columns", se):
        return psi_probe_columns_plain(consts, t0, se, **kw)
    _check_options(precision, unroll)
    n_steps, B = se.shape
    _check_variant(G, paired, noloss, unroll, B)
    paired = paired and not noloss
    n = consts[0].shape[0]
    D = n // 2
    names = ("ab", "bb", "rb") + (("aa", "ab2", "ba", "bb2") if paired
                                  else ())
    if len(consts) < len(names):
        raise ValueError(f"psi_probe_columns: {len(names)} constants "
                         f"needed, got {len(consts)}")
    _check_inputs("psi_probe_columns", se.device, dict(
        **{k: (m, (n, n)) for k, m in zip(names, consts)},
        t0=(t0, (n, B)), se=(se, (n_steps, B))))
    lib = _build.library()
    _check_smem("psi_probe_columns",
                lib.amt_psi_probe_smem_bytes(D, G, int(paired)), se.device,
                D)
    se = pad_steps(se, unroll)
    prod_t = (torch.stack([m.T for m in consts[3:7]]).contiguous()
              if paired else None)
    out = se.new_empty((B,))
    if B == 0:
        return out
    mode = 2 if noloss else int(paired)
    err = lib.amt_psi_probe(
        _ptr(consts[0]), _ptr(consts[1]), _ptr(consts[2]),
        None if prod_t is None else _ptr(prod_t), _ptr(t0), _ptr(se),
        _ptr(out), D, se.shape[0], B, unroll, G, mode, log_eps, norm_eps,
        PRECISIONS.index(precision), _stream_ptr(se.device))
    _build.check(lib, err, "psi_probe_columns")
    psi_probe_columns.launches += 1
    return out


psi_probe_columns.launches = 0


def psi_probe_nll_plain(consts, t0, se, **kw):
    """The mean over the batch of ``psi_probe_columns_plain``."""
    return psi_probe_columns_plain(consts, t0, se, **kw).mean()


def psi_probe_nll(consts, t0, se, **kw):
    """The mean over the batch of ``psi_probe_columns`` (the TPU tool's
    ``run``)."""
    return psi_probe_columns(consts, t0, se, **kw).mean()
