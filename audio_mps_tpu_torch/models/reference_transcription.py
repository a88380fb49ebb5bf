"""Transcription of the reference evolution semantics (port of
``audio_mps_tpu/models/reference_transcription.py``).

The reference hot loop rendered step by step: lab-frame per-step phase
recomputation (reference: model.py:172-196) over the density matrix or
the pure state, in eager PyTorch, each step the ``cell.lab_*`` seams.
This is the ANCHOR implementation: the rotating-frame core and the CUDA
kernel paths are pinned against it by tests, and ``make_lab_train_step``
is the baseline a benchmark divides by the kernel path's training step
(``vs_baseline``). It is unfused: a Python loop of small ops a step, no
kernel, no compilation.

It is not the JAX transcription op for op. The seams work on real blocks
and stacked states, and what does not depend on t (R, K, their blocks)
is built once a call, so a psi step runs about a third of the small ops
that the JAX form's split pairs take (PERF.md section 5 gives both forms'
times on the card). The values are the JAX transcription's to float32
rounding (tests/test_torch_lab_frame.py).

The reference's quirks are kept: the expectation is taken on the
unnormalised post-update state, ``nll_increment`` clamps at ``log_eps``,
the norm floor is ``cfg.norm_eps`` (1e-12), and time advances as a
running sum ``t + delta_t`` in the signals' dtype.
"""
from __future__ import annotations

import torch

from ..config import CMPSConfig
from ..ops.complexing import block_embed
from . import cell, core


def rho_nll_lab_frame(params, cfg: CMPSConfig, signals):
    """Mean NLL, reference-shaped: carry (rho, loss, t), phases at t
    recomputed inside every step (reference: model.py:132-158), each step
    ``cell.lab_update_ancilla_rho`` and ``lab_expectation_rho`` on rho's
    real block. Runs in chunks of ``cfg.scan_chunk`` steps recomputed in
    the backward pass (``core.chunked_scan``), so its gradient keeps
    O(T/chunk + chunk) states alive."""
    incs = core._increments(signals)
    B = signals.shape[0]
    ops = cell.lab_rho_operators(params, cfg)
    rho = block_embed(*core.rho0(params, cfg))

    def step(carry, inc):
        rho, loss, t = carry
        rt = cell._lab_Rt(ops, t)
        s = inc / params.A
        rho2 = cell.lab_update_ancilla_rho(ops, rt, rho, s)
        e = cell.lab_expectation_rho(rt, rho2)
        loss = loss + cell.nll_increment(e, s, cfg.log_eps)
        tr = 0.5 * rho2.diagonal(dim1=-2, dim2=-1).sum(-1)
        rho2 = rho2 / torch.clamp(tr, min=cfg.norm_eps)[:, None, None]
        return (rho2, loss, t + cfg.delta_t)

    carry = (core._tile(rho, B),
             torch.zeros((B,), dtype=signals.dtype, device=signals.device),
             torch.zeros((), dtype=signals.dtype, device=signals.device))
    _, loss, _ = core.chunked_scan(step, carry, incs, cfg.scan_chunk)
    return torch.mean(loss)


def psi_nll_lab_frame(params, cfg: CMPSConfig, signals):
    """Mean NLL, reference-shaped pure-state variant
    (reference: model.py:257-298), each step
    ``cell.lab_update_ancilla_psi`` and ``lab_expectation_psi`` on the
    state stacked as ``[re | im]``. Runs plain: every step's states stay
    alive for the backward pass, as in the JAX transcription."""
    incs = core._increments(signals)
    B = signals.shape[0]
    ops = cell.lab_psi_operators(params, cfg)
    pr, pi = core.psi0(params, cfg)
    x = core._tile(torch.cat([pr, pi]), B)
    loss = torch.zeros((B,), dtype=signals.dtype, device=signals.device)
    t = torch.zeros((), dtype=signals.dtype, device=signals.device)
    for inc in incs:
        phases = cell.lab_phases_psi(ops, t)
        s = inc / params.A
        x2 = cell.lab_update_ancilla_psi(ops, x, s, phases)
        e = cell.lab_expectation_psi(ops, x2, phases)
        loss = loss + cell.nll_increment(e, s, cfg.log_eps)
        x = x2 * torch.rsqrt(torch.clamp(
            torch.sum(x2 * x2, dim=-1, keepdim=True), min=cfg.norm_eps))
        t = t + cfg.delta_t
    return torch.mean(loss)


def make_lab_train_step(cfg: CMPSConfig, mps_model: str, params):
    """Training step on the literal reference-semantics transcription (the
    counterpart of ``bench.py``'s ``make_lab_train_step``): Adam at
    ``cfg.learning_rate`` on ``core.regularized_loss`` of the lab-frame
    NLL. Returns (optimizer, step); ``step(batch)`` updates ``params`` in
    place and returns the metrics of the parameters it started from,
    detached, under ``make_train_step``'s names: ``model_loss`` (the NLL)
    and ``total_loss``."""
    nll_fn = (rho_nll_lab_frame if mps_model == "rho_mps"
              else psi_nll_lab_frame)
    optimizer = torch.optim.Adam(params.parameters(), lr=cfg.learning_rate)

    def step(batch):
        batch = torch.as_tensor(batch, dtype=params.A.dtype,
                                device=params.A.device)
        optimizer.zero_grad(set_to_none=True)
        nll = nll_fn(params, cfg, batch)
        total, _ = core.regularized_loss(nll, params, cfg)
        total.backward()
        optimizer.step()
        return {"model_loss": nll.detach(), "total_loss": total.detach()}

    return optimizer, step
