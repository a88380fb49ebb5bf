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
4. the main path: the sample CLI (``fused=True``) restores a seeded
   params.npz and writes 8 x 65536-sample waveforms, then a damped-sine
   batch is scored through ``psi_nll_fused``; both kernels' launch counts
   must move in that window;
5. CUDA-event timings (median of 5 after a warm-up) of each kernel and its
   plain version, beside each kernel's bound.

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


def rel_err(got, want):
    """(max|got - want|, that divided by max|want|)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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

    phase("main path: sample CLI (fused) + psi_nll_fused")
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
        check(count > 0, f"{name} was not launched on the main path")

    phase("timings (CUDA events, median of 5 after 1 warm-up)")
    n = 2 * D
    sample_ms = median_ms(
        lambda: block.psi_sample_block(**s_in, precision="highest"))
    sample_plain_ms = median_ms(
        lambda: block.psi_sample_block_plain(**s_in, precision="highest"))
    # two [2D,2D] x [2D] products per chain per step; bytes: each input
    # read once, the running waveform written once
    s_flops = T_SAMPLE * N_CHAINS * 2 * (2 * n * n)
    s_bytes = 4 * (2 * T_SAMPLE * N_CHAINS + 2 * n * n + n * N_CHAINS
                   + 2 * D + 1)
    s_bound, s_by = bound_ms(s_flops, s_bytes)
    nll_ms = median_ms(lambda: block.psi_nll_block(**n_in))
    nll_plain_ms = median_ms(lambda: block.psi_nll_block_plain(**n_in))
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
