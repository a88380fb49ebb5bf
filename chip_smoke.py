#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_mps_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It needs a CUDA card and the CUDA toolkit's nvcc; without a card it exits
non-zero before printing any result. Phases, each of which raises on
failure (the script then exits non-zero):

1. set-up: card name and power limit, CUDA version, TF32 off, kernel build;
2. kernel vs plain PyTorch at full width (psi, D=64): the SDE sampler
   (N=8 chains, T=65536) and the forward-only NLL (B=128, T=16384), at the
   tolerances stated below;
3. the port's kernels vs its eager reference (models/core.py) on a short
   input;
4. the serving path: the sample CLI (``fused=True``) restores a seeded
   params.npz and writes 8 x 65536-sample waveforms, then a damped-sine
   batch is scored through ``psi_nll_fused``; both kernels' launch counts
   must move in that window;
5. the training kernels (forward, adjoint, cotangent reduction) vs their
   plain versions: the main path's variant on the whole B=128, T=16384
   batch (one timed run of each plain version), the other three variants
   on its T=2048 prefix, with a control reading of the kernels at
   ``default``; then the training path's value and gradients vs autograd
   through the eager reference;
6. the training path: the train CLI takes 3 Adam steps at D=64, B=128,
   T=16384 on damped-sine batches, then a second call restores step 3 and
   takes one more; the three training kernels' launch counts must move in
   that window; then the step time of ``make_train_step`` (host clock);
7. CUDA-event timings (median of 5 after a warm-up) of each kernel, and one
   timed run of each plain version, beside each kernel's bound.

It prints each phase's measurements, the card line, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

D = 64                 # psi bond dimension, the flagship model (README)
N_CHAINS = 8           # README's sampler figure: D=64, 8 chains
T_SAMPLE = 65536       # the sample CLI's default duration
T_PLAIN = 4096         # sampler prefix the plain version is held to
B_NLL = 128            # the training headline's batch
T_NLL = 16384          # the training headline's length

# Tolerances, as max|kernel - plain| <= TOL * max|plain|.
# highest: the two run the same fp32 arithmetic and differ only in the order
#   of the 128-term dot sums and the reductions (~1e-7 a step); the state
#   is renormalised every step, so the difference stays near that level
#   over the run, and 1e-4 leaves room for its slow drift.
# high: the bf16 (hi, lo) splits are formed from states that already differ
#   in the last fp32 bits, so a split can round the other way; hi + lo keeps
#   ~2^-17 of the value, so the per-step difference is ~1e-5 and 1e-3 holds
#   its drift.
TOL = {"highest": 1e-4, "high": 1e-3}
# kernels vs the eager reference on a short input: the same arithmetic in
# another association order (rotation folded into the block constants)
TOL_REFERENCE = 1e-4

T_TRAIN_PLAIN = 2048   # prefix for the variants the main path does not run
TRAIN_STEPS = 3        # Adam steps of the train CLI's first call
# Training kernels vs plain, max|kernel - plain| <= TOL * max|plain|, per
# output. The main path's variant (the CLI's precision and norm) is held at
# the full T=16384, the other three on the T=2048 prefix.
# Forward (loss, the state stream ys and its norms n2s): as the NLL above.
# Adjoint (dse, dt0, dy, dehat): fed the plain forward's own streams, so
#   only its own summation order differs; its chain renormalises dt with the
#   state, so the difference stays at the per-step level as in the forward:
#   1e-4 at highest, 1e-3 at high, where the bf16 splits of dy can round
#   the other way.
# Reductions (dAb, dBb, dRb): fed the plain adjoint's own streams, both
#   sides form the same bf16 splits, and only the order of the fp32 sum over
#   n_steps x 128 terms differs (~1e-6 of max|plain| at T=16384): 1e-5 at
#   both precisions. The rounding errors of a kernel that dropped the lo
#   terms average out over the coherent sums, to ~5e-5, so a looser limit
#   would not see it.
# Control: the kernels at default (bf16 products without the lo terms)
#   against the plain versions at high must miss each high limit.
TOL_TRAIN = {"highest": {"psi_train_fwd": 1e-4, "psi_train_bwd": 1e-4,
                         "psi_cotangents": 1e-5},
             "high": {"psi_train_fwd": 1e-3, "psi_train_bwd": 1e-3,
                      "psi_cotangents": 1e-5}}
# the training path's loss and its six parameter gradients vs autograd
# through core.psi_nll: the same fp32 arithmetic in another order, so the
# value to 1e-4 and each gradient to 1e-3 of its largest element
TOL_TRAIN_REFERENCE = (1e-4, 1e-3)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reps=5, warmup=1) -> float:
    """Median CUDA-event time of fn() over `reps` runs after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed(fn):
    """(CUDA-event ms of one fn() call, its result)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def rel_err(got, want):
    """(max|got - want|, that divided by max|want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def train_phases(dev, params, cfg):
    """Phases 5-7 for the training path; returns the three kernels' entries
    of the {"kernels": [...]} line."""
    from audio_mps_tpu_torch.data import damped_sine_batch, damped_sine_iterator
    from audio_mps_tpu_torch.models import core
    from audio_mps_tpu_torch.ops import block
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL
    from audio_mps_tpu_torch.train import parse_args, train
    from audio_mps_tpu_torch.training import make_train_step
    from audio_mps_tpu_torch.weights import (psi_params_from_numpy,
                                             psi_params_to_numpy)

    B, T = B_NLL, T_NLL
    n = 2 * D
    wrappers = {"psi_train_fwd": block.psi_train_fwd,
                "psi_train_bwd": block.psi_train_bwd,
                "psi_cotangents": block.psi_cotangents}
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(4), B, T,
                                cfg.delta_t)
    t_in = block.psi_nll_inputs(params, cfg, signals)
    eps = dict(log_eps=t_in.pop("log_eps"), norm_eps=t_in.pop("norm_eps"))
    pre = dict(t_in, se=t_in["se"][:T_TRAIN_PLAIN - 1].contiguous())
    g = torch.full((B,), 1.0 / B, device=dev)     # the batch mean's cotangent

    def fwd(ins, plain=False, **o):
        f = block.psi_train_fwd_plain if plain else block.psi_train_fwd
        return f(**ins, **eps, **o)

    def bwd(ins, ys, n2s, plain=False, **o):
        f = block.psi_train_bwd_plain if plain else block.psi_train_bwd
        return f(**ins, g=g, ys=ys, n2s=n2s, **eps, **o)

    def cot(ins, ys, n2s, dy, dehat, plain=False, **o):
        f = block.psi_cotangents_plain if plain else block.psi_cotangents
        return f(dy, ys, ins["t0"], ins["se"], n2s, dehat,
                 norm_eps=eps["norm_eps"], **o)

    def kernel_outputs(kname, ins, f_p, b_p, **o):
        """The kernel's outputs, each kernel fed the plain versions' streams."""
        torch.cuda.synchronize()
        if kname == "psi_train_fwd":
            out = fwd(ins, **o)
        elif kname == "psi_train_bwd":
            out = bwd(ins, f_p[1], f_p[2], **o)
        else:
            out = cot(ins, f_p[1], f_p[2], b_p[2], b_p[3], **o)
        torch.cuda.synchronize()
        return out

    main = (cfg.kernel_precision, cfg.defer_norm)
    phase(f"training kernels vs plain (D={D}, B={B}): the main path's "
          f"variant {main} at T={T}, the other three on a T={T_TRAIN_PLAIN} "
          f"prefix")
    err_at, plain_ms = {}, {}
    names = {"psi_train_fwd": ("loss", "ys", "n2s"),
             "psi_train_bwd": ("dse", "dt0", "dy", "dehat"),
             "psi_cotangents": ("dAb", "dBb", "dRb")}
    variants = [(p, d) for p in ("highest", "high") for d in (False, True)
                if (p, d) != main] + [main]
    for prec, defer in variants:
        ins = t_in if (prec, defer) == main else pre
        o = dict(precision=prec, defer_norm=defer)
        t_f, f_p = timed(lambda: fwd(ins, plain=True, **o))
        t_b, b_p = timed(lambda: bwd(ins, f_p[1], f_p[2], plain=True, **o))
        t_c, c_p = timed(lambda: cot(ins, f_p[1], f_p[2], b_p[2], b_p[3],
                                     plain=True, **o))
        want = {"psi_train_fwd": f_p, "psi_train_bwd": b_p,
                "psi_cotangents": c_p}
        if (prec, defer) == main:
            plain_ms = {"psi_train_fwd": t_f, "psi_train_bwd": t_b,
                        "psi_cotangents": t_c}
        line = []
        for kname, outs in names.items():
            tol = TOL_TRAIN[prec][kname]
            got = kernel_outputs(kname, ins, f_p, b_p, **o)
            worst = 0.0
            for label, a, b in zip(outs, got, want[kname]):
                check(bool(torch.isfinite(a).all()),
                      f"{kname} {label}: non-finite")
                err, rel = rel_err(a, b)
                worst = max(worst, err)
                line.append(f"{label} {rel:.2e}")
                check(rel <= tol, f"{kname} {prec} defer={defer} {label}:"
                                  f" rel err {rel:.3e} (tol {tol:g})")
            err_at[(kname, prec, defer)] = worst
            del got
        print(f"  {prec} defer_norm={defer}, T={ins['se'].shape[0] + 1} (tol "
              + " / ".join(f"{v:g}" for v in TOL_TRAIN[prec].values())
              + "), x max|plain|: " + ", ".join(line), flush=True)
        if prec == "high" and ins is pre:
            # control: the kernels at default (bf16 products without the lo
            # terms) against the plain versions at high, on the same inputs
            ctrl = []
            for kname, outs in names.items():
                got = kernel_outputs(kname, ins, f_p, b_p, precision="default",
                                     defer_norm=defer)
                worst = max(rel_err(a, b)[1]
                            for a, b in zip(got, want[kname]))
                ctrl.append(f"{kname} {worst:.2e}")
                check(worst > TOL_TRAIN["high"][kname],
                      f"control: {kname} at default is within the high "
                      f"limit of plain at high ({worst:.3e})")
            print(f"  control, kernels at default vs plain at high, defer_norm"
                  f"={defer}, worst x max|plain| (must exceed the high "
                  f"limits): " + ", ".join(ctrl), flush=True)
        del f_p, b_p, c_p, want
    print(f"  plain versions at T={T} ({main}): fwd "
          f"{plain_ms['psi_train_fwd']:.1f} ms, bwd "
          f"{plain_ms['psi_train_bwd']:.1f} ms, cotangents "
          f"{plain_ms['psi_cotangents']:.1f} ms (CUDA events, one run)",
          flush=True)

    phase(f"training path vs the eager reference (D={D}, 8 columns, T=512)")
    short = signals[:8, :512].contiguous()
    cfg8 = dataclasses.replace(cfg, minibatch_size=8)
    pk = psi_params_from_numpy(psi_params_to_numpy(params), dev)
    pr = psi_params_from_numpy(psi_params_to_numpy(params), dev)
    loss_k = block.psi_nll_block_trainable(pk, cfg8, short,
                                           precision="highest",
                                           defer_norm=cfg.defer_norm)
    loss_k.backward()
    loss_r = core.psi_nll(pr, cfg8, short)
    loss_r.backward()
    _, rel = rel_err(loss_k.detach(), loss_r.detach())
    line = [f"loss {rel:.2e}"]
    check(rel <= TOL_TRAIN_REFERENCE[0], f"train loss vs reference: {rel:.3e}")
    for name in pk.NAMES:
        _, rel = rel_err(getattr(pk, name).grad, getattr(pr, name).grad)
        line.append(f"d{name} {rel:.2e}")
        check(rel <= TOL_TRAIN_REFERENCE[1],
              f"gradient of {name} vs reference: rel err {rel:.3e}")
    print(f"  x max|reference| (tol {TOL_TRAIN_REFERENCE[0]:g} / "
          f"{TOL_TRAIN_REFERENCE[1]:g}): " + ", ".join(line), flush=True)

    phase(f"training path: train CLI (D={D}, B={B}, T={T}), {TRAIN_STEPS} "
          f"steps, then a restore and one more step")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--mps_model=psi_mps", "--dataset=damped_sine",
                f"--sample_duration={T}",
                f"--hparams=bond_dim={D},minibatch_size={B}",
                f"--logdir={tmp}", f"--device={dev.type}"]
        for w in (block.psi_sample_block, block.psi_nll_block,
                  *wrappers.values()):
            w.launches = 0
        run, device = parse_args(argv + [f"--max_steps={TRAIN_STEPS}"])
        t0 = time.perf_counter()
        _, m_first = train(run, device=device)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        ckdir = os.path.join(run.run_logdir(cfg), "checkpoints")
        first_ckpts = sorted(os.listdir(ckdir))
        run2, device = parse_args(argv + [f"--max_steps={TRAIN_STEPS + 1}"])
        t0 = time.perf_counter()
        p_last, m_last = train(run2, device=device)
        torch.cuda.synchronize()
        t_second = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        state = torch.load(os.path.join(ckdir, f"ckpt_{TRAIN_STEPS + 1}.pt"),
                           map_location="cpu", weights_only=True)
        has_npz = os.path.exists(os.path.join(run.run_logdir(cfg),
                                              "params.npz"))
    print(f"  first call: {TRAIN_STEPS} steps in {t_first * 1e3:.1f} ms, "
          f"checkpoints {first_ckpts}; second call: restore + 1 step in "
          f"{t_second * 1e3:.1f} ms (host clock, set-up included); final "
          f"loss {float(m_last['model_loss']):.6f}; launches {launches}",
          flush=True)
    check(first_ckpts == [f"ckpt_{TRAIN_STEPS}.pt"],
          f"first call left {first_ckpts}")
    check(state["step"] == TRAIN_STEPS + 1, f"final step {state['step']}")
    check(all(float(s["step"]) == TRAIN_STEPS + 1
              for s in state["optimizer"]["state"].values()),
          "the Adam state was not restored")
    check(has_npz, "the train CLI wrote no params.npz")
    for m in (m_first, m_last):
        check(all(bool(torch.isfinite(v).all()) for v in m.values()),
              f"non-finite metrics {m}")
    check(all(bool(torch.isfinite(x).all()) for x in p_last.parameters()),
          "non-finite parameters")
    for name, count in launches.items():
        check(count == TRAIN_STEPS + 1,
              f"{name} launched {count} times on the training path, "
              f"expected {TRAIN_STEPS + 1}")

    tp = psi_params_from_numpy(psi_params_to_numpy(params), dev)
    _, step = make_train_step("psi_mps", cfg, tp, device=dev)
    data = damped_sine_iterator(cfg, T, seed=5, device=dev)
    step(next(data))
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        metrics = step(next(data))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    check(bool(torch.isfinite(metrics["total_loss"])), "non-finite loss")
    print(f"  train step (make_train_step, batch draw included): "
          f"{step_ms:.2f} ms host clock, mean of {reps} after a warm-up; "
          f"{B * (T - 1) / step_ms * 1e3:.4e} frames/s", flush=True)

    phase("training timings (CUDA events, median of 5 after 1 warm-up)")
    o = dict(precision=cfg.kernel_precision, defer_norm=cfg.defer_norm)
    loss, ys, n2s = fwd(t_in, **o)
    dse, dt0, dy, dehat = bwd(t_in, ys, n2s, **o)
    ms = {"psi_train_fwd": median_ms(lambda: fwd(t_in, **o)),
          "psi_train_bwd": median_ms(lambda: bwd(t_in, ys, n2s, **o)),
          "psi_cotangents": median_ms(lambda: cot(t_in, ys, n2s, dy, dehat,
                                                  **o))}
    # library yardstick of the reductions: the three [2D, M] x [M, 2D]
    # products as torch.matmul (fp32, TF32 off) on operands built once
    m_cols = (T - 1) * B

    def lanes(x):
        return x.transpose(0, 1).reshape(n, m_cols)

    ts = block._input_states(t_in["t0"], ys, block._state_scales(
        n2s, norm_eps=eps["norm_eps"], unroll=DEFAULT_UNROLL,
        defer_norm=cfg.defer_norm))
    ops = [(lanes(dy), lanes(ts)),
           (lanes(dy), lanes(t_in["se"][:, None, :] * ts)),
           (lanes((2.0 * dehat)[:, None, :] * ys), lanes(ys))]
    del ts
    library_ms = median_ms(lambda: [a @ b.T for a, b in ops])
    del ops
    # the main path's variant once more last, as a repeat within the call
    for prec, defer in (("high", True), ("highest", False),
                        (cfg.kernel_precision, cfg.defer_norm)):
        v = dict(precision=prec, defer_norm=defer)
        l_v, ys_v, n2s_v = fwd(t_in, **v)
        b_v = bwd(t_in, ys_v, n2s_v, **v)
        t_f = median_ms(lambda: fwd(t_in, **v))
        t_b = median_ms(lambda: bwd(t_in, ys_v, n2s_v, **v))
        t_c = median_ms(lambda: cot(t_in, ys_v, n2s_v, b_v[2], b_v[3], **v))
        print(f"  {prec} defer_norm={defer}: fwd {t_f:.3f} ms, bwd "
              f"{t_b:.3f} ms, cotangents {t_c:.3f} ms", flush=True)
        del l_v, ys_v, n2s_v, b_v
    # FLOPs: the [2D,2D] products only, 2 n^2 a column-step each: 3 in the
    # forward, 4 on the adjoint chain (RU recomputed), 3 reductions. Bytes:
    # the ys / dy streams and the per-step rows, each read or written once.
    steps = (T - 1) * B
    cost = {"psi_train_fwd": (3 * 2 * n * n * steps,
                              4 * (steps * n + 2 * steps + 3 * n * n)),
            "psi_train_bwd": (4 * 2 * n * n * steps,
                              4 * (2 * steps * n + 4 * steps + 3 * n * n)),
            "psi_cotangents": (3 * 2 * n * n * steps,
                               4 * (2 * steps * n + 3 * steps + 3 * n * n))}
    replaces = {"psi_train_fwd": "audio_mps_tpu/ops/pallas_block.py:875",
                "psi_train_bwd": "audio_mps_tpu/ops/pallas_block.py:935",
                "psi_cotangents": "audio_mps_tpu/ops/pallas_block.py:1035"}
    entries = []
    for name in wrappers:
        bound, by = bound_ms(*cost[name])
        entries.append({
            "name": name, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err_at[(name, *main)], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms if name == "psi_cotangents" else None})
        print(f"  {name}: {ms[name]:.3f} ms, launches per train step "
              f"{launches[name] / (TRAIN_STEPS + 1):g} (plain "
              f"{plain_ms[name]:.1f} ms at T={T}, bound "
              f"{bound:.3f} ms by {by})", flush=True)
    print(f"  torch.matmul of the three reductions: {library_ms:.3f} ms; "
          f"train step {step_ms:.2f} ms, of which the three kernels "
          f"{sum(ms.values()):.2f} ms", flush=True)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models import core
    from audio_mps_tpu_torch.models.params import init_psi
    from audio_mps_tpu_torch.ops import _build, block
    from audio_mps_tpu_torch.ops.scan import psi_nll_fused, psi_sample_fused
    from audio_mps_tpu_torch.sample import SampleConfig, sample
    from audio_mps_tpu_torch.weights import load_params, save_params

    t_start = time.perf_counter()

    phase("set-up")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = _build.build()
    print(f"kernel build: {built['seconds']:.1f} s (rebuilt="
          f"{built['rebuilt']}) -> {built['path']}", flush=True)
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)
    _build.library()

    dev = torch.device("cuda")
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B_NLL)
    params = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)

    phase(f"sampler kernel vs plain (D={D}, N={N_CHAINS}, T={T_SAMPLE})")
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(1),
                               N_CHAINS, T_SAMPLE, 1.0)
    s_in = block.psi_sample_inputs(params, cfg, noise)
    s_short = dict(s_in, noise=s_in["noise"][:T_PLAIN].contiguous())
    wave = block.psi_sample_block(**s_in, precision="highest")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(wave).all()), "sampler kernel: non-finite")
    sample_err = {}
    for prec in ("highest", "high"):
        got = (wave[:T_PLAIN] if prec == "highest" else
               block.psi_sample_block(**s_short, precision=prec))
        want = block.psi_sample_block_plain(**s_short, precision=prec)
        err, rel = rel_err(got, want)
        sample_err[prec] = err
        print(f"  {prec}: max|d| {err:.3e} = {rel:.3e} x max|plain| over "
              f"{T_PLAIN} steps (tol {TOL[prec]:g})", flush=True)
        check(rel <= TOL[prec], f"sampler {prec}: rel err {rel:.3e}")

    phase(f"NLL kernel vs plain (D={D}, B={B_NLL}, T={T_NLL})")
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(2), B_NLL,
                                T_NLL, cfg.delta_t)
    n_in = block.psi_nll_inputs(params, cfg, signals)
    nll_err = {}
    for prec in ("highest", "high"):
        for defer in (False, True):
            got = block.psi_nll_block(**n_in, precision=prec,
                                      defer_norm=defer)
            want = block.psi_nll_block_plain(**n_in, precision=prec,
                                             defer_norm=defer)
            check(bool(torch.isfinite(got).all()), "NLL kernel: non-finite")
            err, rel = rel_err(got, want)
            nll_err[f"{prec}/defer={defer}"] = err
            print(f"  {prec} defer_norm={defer}: max|d| {err:.3e} = "
                  f"{rel:.3e} x max|plain| (tol {TOL[prec]:g}); mean loss "
                  f"{got.mean().item():.6f}", flush=True)
            check(rel <= TOL[prec], f"NLL {prec} defer={defer}: rel err "
                                    f"{rel:.3e}")

    phase(f"kernels vs the eager reference (D={D}, 8 columns, T=512)")
    short_noise = noise[:512].contiguous()
    err, rel = rel_err(psi_sample_fused(params, cfg, short_noise),
                       core.sample_psi_with_noise(params, cfg,
                                                  short_noise).detach())
    print(f"  sampler: {rel:.3e} x max|reference| (tol {TOL_REFERENCE:g})",
          flush=True)
    check(rel <= TOL_REFERENCE, f"sampler vs reference: rel err {rel:.3e}")
    short_sig = signals[:8, :512].contiguous()
    got = block.psi_nll_block(**block.psi_nll_inputs(params, cfg, short_sig))
    with torch.no_grad():
        want = torch.stack([core.psi_nll(params, cfg, short_sig[b:b + 1])
                            for b in range(short_sig.shape[0])])
    err, rel = rel_err(got, want)
    print(f"  NLL per example: {rel:.3e} x max|reference| (tol "
          f"{TOL_REFERENCE:g})", flush=True)
    check(rel <= TOL_REFERENCE, f"NLL vs reference: rel err {rel:.3e}")

    phase("serving path: sample CLI (fused) + psi_nll_fused")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"cfg": dataclasses.asdict(cfg),
                       "run": {"mps_model": "psi_mps"}}, f)
        save_params(os.path.join(tmp, "params.npz"), params)
        out = os.path.join(tmp, "samples.npz")
        block.psi_sample_block.launches = 0
        block.psi_nll_block.launches = 0
        t0 = time.perf_counter()
        waves = sample(SampleConfig(modeldir=tmp, num_samples=N_CHAINS,
                                    sample_duration=T_SAMPLE, fused=True,
                                    device="cuda", out=out))
        t_sample = time.perf_counter() - t0
        t0 = time.perf_counter()
        scored = load_params(os.path.join(tmp, "params.npz"), dev)
        batch = damped_sine_batch(torch.Generator(dev).manual_seed(3),
                                  B_NLL, T_NLL, cfg.delta_t)
        nll = psi_nll_fused(scored, cfg, batch).item()
        t_score = time.perf_counter() - t0
        launches = {"psi_sample_block": block.psi_sample_block.launches,
                    "psi_nll_block": block.psi_nll_block.launches}
        n_wav = sum(os.path.exists(os.path.join(tmp, f"samples_{i}.wav"))
                    for i in range(N_CHAINS))
        check(os.path.exists(out), "sample CLI wrote no samples.npz")
    print(f"  sample CLI: {waves.shape} in {t_sample * 1e3:.1f} ms, {n_wav} "
          f"wav files; NLL {nll:.6f} in {t_score * 1e3:.1f} ms (host clock); "
          f"launches {launches}", flush=True)
    check(waves.shape == (N_CHAINS, T_SAMPLE), f"waves {waves.shape}")
    check(bool(torch.isfinite(torch.as_tensor(waves)).all()),
          "sampled waveforms are not finite")
    check(n_wav == N_CHAINS, f"{n_wav} of {N_CHAINS} wav files written")
    check(torch.isfinite(torch.tensor(nll)).item(), f"NLL {nll}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the serving path")

    train_entries = train_phases(dev, params, cfg)

    phase("timings (CUDA events, median of 5 after 1 warm-up)")
    n = 2 * D
    sample_ms = median_ms(
        lambda: block.psi_sample_block(**s_in, precision="highest"))
    # plain versions: one run each (the sampler's takes ~16 s)
    sample_plain_ms = median_ms(
        lambda: block.psi_sample_block_plain(**s_in, precision="highest"),
        reps=1, warmup=0)
    # two [2D,2D] x [2D] products per chain per step; bytes: each input
    # read once, the running waveform written once
    s_flops = T_SAMPLE * N_CHAINS * 2 * (2 * n * n)
    s_bytes = 4 * (2 * T_SAMPLE * N_CHAINS + 2 * n * n + n * N_CHAINS
                   + 2 * D + 1)
    s_bound, s_by = bound_ms(s_flops, s_bytes)
    nll_ms = median_ms(lambda: block.psi_nll_block(**n_in))
    nll_plain_ms = median_ms(lambda: block.psi_nll_block_plain(**n_in),
                             reps=1, warmup=0)
    n_steps = T_NLL - 1
    # three [2D,2D] x [2D] products per example per step
    l_flops = n_steps * B_NLL * 3 * (2 * n * n)
    l_bytes = 4 * (n_steps * B_NLL + 3 * n * n + n * B_NLL + B_NLL)
    l_bound, l_by = bound_ms(l_flops, l_bytes)
    variants = {}
    for prec in ("high", "default"):
        variants[f"psi_sample_block/{prec}"] = median_ms(
            lambda: block.psi_sample_block(**s_in, precision=prec))
        for defer in (False, True):
            variants[f"psi_nll_block/{prec}/defer={defer}"] = median_ms(
                lambda: block.psi_nll_block(**n_in, precision=prec,
                                            defer_norm=defer))
    variants["psi_nll_block/highest/defer=True"] = median_ms(
        lambda: block.psi_nll_block(**n_in, defer_norm=True))
    for name, ms in variants.items():
        print(f"  {name}: {ms:.3f} ms", flush=True)
    kernels = [
        {"name": "psi_sample_block", "route": "cuda",
         "source": "audio_mps_tpu_torch/csrc/psi_sample.cu",
         "replaces": "audio_mps_tpu/ops/pallas_block.py:2176",
         "launches": launches["psi_sample_block"],
         "max_abs_err": sample_err["highest"], "ms": sample_ms,
         "plain_ms": sample_plain_ms, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": None},
        {"name": "psi_nll_block", "route": "cuda",
         "source": "audio_mps_tpu_torch/csrc/psi_nll.cu",
         "replaces": "audio_mps_tpu/ops/pallas_block.py:2428",
         "launches": launches["psi_nll_block"],
         "max_abs_err": nll_err["highest/defer=False"], "ms": nll_ms,
         "plain_ms": nll_plain_ms, "bound_ms": l_bound,
         "bound_by": l_by, "library_ms": None},
    ]
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.1f} "
              f"ms, bound {k['bound_ms']:.3f} ms by {k['bound_by']})",
              flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels + train_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
