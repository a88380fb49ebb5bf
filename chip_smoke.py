#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_mps_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

It needs a CUDA card and the CUDA toolkit's nvcc; without a card it exits
non-zero before printing any result. Phases, each of which raises on
failure (the script then exits non-zero):

1. set-up: card name and power limit, CUDA version, TF32 off, kernel build;
2. kernel vs plain PyTorch at full width (psi, D=64): the SDE sampler
   (N=8 chains, T=65536; the plain version on its T=4096 prefix) and the
   forward-only NLL (B=128: the scoring variant at T=16384, the other three
   on a T=2048 prefix), at the tolerances stated below;
3. the port's kernels vs its eager reference (models/core.py) on a short
   input;
4. the serving path: the sample CLI (``fused=True``) restores a seeded
   params.npz and writes 8 x 65536-sample waveforms, then a damped-sine
   batch is scored through ``psi_nll_fused``; both kernels' launch counts
   must move in that window;
5. the training phases (``train_phases``) of psi at D=64, B=128, T=16384:
   the training kernels (forward, adjoint, cotangent reduction) vs their
   plain versions (the main path's variant on the whole batch, with one
   timed run of each plain version, the other three variants on a T=2048
   prefix, with a control reading of the kernels at ``default``), and
   psi's adjoint's tail alone vs its plain version on the whole batch; the
   training path's value and gradients vs autograd through the eager
   reference; the train CLI (3 Adam steps on damped-sine batches, then a
   second call restores step 3 and takes one more; the family's three
   training kernels' launch counts must move in that window, the other
   family's must not); the step time of ``make_train_step`` (host clock);
   CUDA-event timings (median of 5 after a warm-up) of each kernel beside
   its bound (psi's tail too: inside the adjoint's time, and an entry of
   its own in the kernels line); the cotangent reduction at each precision
   beside ``torch.matmul`` of its products, each precision's two launches
   equal bit for bit;
6. timings of the psi sampler and NLL kernels, and one timed run of each
   plain version, beside each kernel's bound; then psi past the quad
   layout (``wide_phases``, BASELINE config 5 on one card): the cluster
   layout's kernels at D=128 (the NLL, the streamed and checkpoint
   forwards, the segment recompute, the adjoint's tail and the whole
   adjoint, and the cotangent reduction) held to their plain versions, the
   main path's variant (highest, deferred norm) over the whole B=128,
   T=16385 run, the other three on a T=2048 prefix; the same at D=256,
   B=16, T=257; the cluster sampler at D=128 (8 chains and one, on the
   T=4096 prefix) and D=256; the train CLI at D=128, B=128, T=16385 (3
   Adam steps, a restore, 1 more; the summaries sample through the
   cluster sampler) and with ``kernel_stream=off`` (1 + 1 steps); scoring
   at B=128, T=16384 and the sample CLI at 8 x 65536; each cluster kernel's
   CUDA-event time beside its bound, the tail beside two ``torch.matmul``
   calls of its products;
7. the rho (mixed-state) family at D=64, rank 64 (``rho_phases``): the
   sampler (N=8 chains, T=65536, held to its plain version over its first
   16384 steps and over the whole run) and the NLL (B=8, T=16384) held to
   their plain versions
   (with controls at ``default`` for each ``high`` limit),
   the serving path (the sample CLI with ``mps_model=rho_mps`` and
   ``fused=True``, then ``rho_nll_fused``), the training phases of 5 at
   B=8, T=16384 (the main variant held to plain on a T=4097 prefix; the
   reference is autograd through the eager
   ``core.rho_nll_factor``), the device time by kernel of one rho train
   step (``torch.profiler``), the thread-block clusters the rho forward,
   chain and sampler took (``rho_cluster_phase``: the rule's, on the
   card's residency) and every cluster size's outputs held to one CTA's
   bit for bit and timed (the sampler's for 8 chains and for one), and
   the sampler's and NLL's timings;
8. rank-chunked rho training past the monolithic kernels' shared memory
   (``rank_phases``) at D=256, full rank, B=8, T=16385: the partials
   forward, adjoint and reductions vs their plain versions on a T=2049
   prefix (with controls at ``default``), the chunked path vs the
   monolithic kernels at D=64, rank 64, T=16385 (loss and six gradients)
   and the two in whole Adam steps (``a4_whole_steps``), the train CLI (a refusal while it would sample, then 1 Adam step with
   ``--visualize=false``, a restore and one more; the partials kernels'
   launch counts must move, the monolithic ones' must not), one step's
   time and peak memory, and each kernel's CUDA-event time per time
   segment and over the whole run beside its bound and its time before
   the ring redesign (the reductions on one segment at each precision,
   two launches equal bit for bit, and over the run beside
   ``torch.matmul``); first it prints the thread-block clusters the
   partials launches take, how many of each size the card holds, and each
   partials kernel's registers and spills, and on one segment it times the
   forward and the adjoint unclustered too;
9. training without the state stream (``kernel_stream="off"``), for psi and
   rho after their training phases (``recompute_phases``) and for the rank
   partials after theirs (``rank_recompute_phases``): the checkpoint
   forward, the segment recompute and the whole recompute adjoint vs their
   plain versions on the T=2048 (rank: 2049) prefix, with controls at
   ``default``; the recompute path vs the streamed path on the card (the
   recomputed states and the loss bit for bit, two runs of the recompute
   adjoint bit for bit, the loss and six gradients at the training
   headline, the rank path on the prefix); the train CLI with
   ``kernel_stream=off`` at psi D=64, B=1024, T=16384 and rho D=64, rank
   64, B=8, T=16384 (2 steps, a restore and 1 more) and at the rank
   partials' D=256 (1 + 1), where the checkpoint forward must launch once
   a step and the recompute, adjoint and reductions once a time segment,
   and the streamed forward never; the kernels' CUDA-event times beside
   their bounds, and one step's time and peak memory, off and streamed;
   then psi's block kernels at B=1024 (``psi_columns_phases``): each at
   the G the rule takes (8 columns a CTA on an H100) held to a forced G=1
   run bit for bit on the T=2048 prefix (highest and high, both norms),
   and scoring, the streamed forward and the adjoint chain alone timed
   beside their bounds, with the G each launch took;
10. psi's split layout (``split_phases``, after psi's phases) at the legacy
   estimator's published shape (D=10, B=32, dt=1e-3, T=65536): the sampler
   (N=8 chains) held to its plain version on the T=4096 prefix and over the
   whole run, the NLL (both norms) on a T=4096 prefix, the training
   forward and adjoint on the T=4096 (deferred norm) and T=2048 (per-step
   norm) prefixes, each with a control at ``default``, and all four at D=8
   with
   ``kernel_layout="split"``; the training path vs autograd through the
   eager reference; the estimator CLI at its defaults (4 steps, then 2
   more resuming at step 4: the split forward and adjoint launch once a
   step, no other kernel); the sample CLI and ``psi_nll_fused`` at D=10
   through the split sampler and NLL; the four kernels' CUDA-event times
   beside their bounds and one estimator step's time; the adjoint's two
   forms (double, single) equal bit for bit on the training prefixes, and
   each form's time with the re-run, the sweep and the outer products
   alone (``tools/split_adjoint_attribution.py``, its builds started in
   set-up); the NLL's loss the training forward's bit for bit at both
   norms, and both timed at both norms at D=50 as well
   (``tools/split_forward_sweep.py``);
11. rho's split layout (``rho_split_phases``, after psi's) at the same
   shape with ``--discr=true`` (full rank 10, 320 factor lanes): the
   sampler (N=8 chains) on the T=4096 prefix, the NLL (both norms) on a
   T=4096 prefix, the training forward and adjoint on the T=4096 and
   T=2048 prefixes, each held to its plain version with a control at
   ``default``; the training path vs autograd through the eager
   ``core.rho_nll_factor``; the estimator CLI with ``--discr=true`` (4 + 2
   steps: the rho split pair once a step, no other kernel); the sample
   CLI with ``mps_model=rho_mps`` and ``rho_nll_fused`` through the split
   sampler and NLL; the four kernels' CUDA-event times beside their
   bounds and one estimator step's time; the adjoint's four (placement,
   form) equal bit for bit on the training prefixes, each one's time and
   the parts alone, as psi's; the forwards' layout, and the NLL and the
   training forward at both norms at D=10 and at D=20, rank 20, in the
   warp-local layout and in the element layout, the NLL's loss the
   forward's bit for bit in each;
12. psi's spine/limbs training pair (``batched_phases``, after psi's
   recompute phases; the TPU factory's ``batched=True``, off by default) at
   D=64, B=128, T=16384, highest, deferred norm: the batched forward held
   to its plain version over the whole run and on the T=2048 prefix, and
   to the checkpoint forward bit for bit; the adjoint on the prefix; both
   at highest and high with controls at ``default``; the batched pair vs
   the streamed pair (loss and six gradients); two adjoint runs bit for
   bit; three Adam steps through the batched loss (only the batched pair
   launches); one step's time and peak memory beside the streamed and
   recompute steps'; the two kernels' CUDA-event times beside their
   bounds;
13. the floor probe (``probe_phases``; ``tools/probe8_psi_floor.py``'s
   kernel): the port tool's card correctness pass (every variant against
   ``core.psi_nll`` at D=64, B=128, T=257) and timing pass (T=16385, high
   and highest); each variant and the chain-only diagnostic held to its
   plain version per column at T=257, with controls at ``default``; each
   variant's CUDA-event time and ns a step beside its bound;
14. the data plane (``data_plane_phases``): the native library built with
   g++ and loaded; a guitar-like and an organ-like stand-in dataset
   (100 notes each in the NSynth schema, through the ETL of the
   reference's make-small-dataset.py: padded to 2^16, audio-only
   Examples) written by ``tools/make_instrument_dataset.py``; the records
   read a second through the native and the pure-Python parsers, held to
   identical arrays;
15. training on those files (``file_training_phases``): BASELINE.json's
   config 1, the train CLI at its defaults (psi, D=8, B=8, T=65536) on
   guitar.tfrecords (3 Adam steps, a restore, 1 more; psi's three
   training kernels and the adjoint's tail launch once a step, no other
   training kernel), and ``get_audio``'s time a batch, in memory and
   streamed, beside the train step's; config 2, organ-nsynth.tfrecord
   filtered by instrument and pitch through ``NSynthDataset`` and
   ``tools/make_small_dataset.py`` (equal to the ETL's output), the
   estimator CLI with ``--data_dir`` at D=32 (2 + 2 steps) and the rho
   train CLI on organ.tfrecords (1 step; rho's three training kernels
   once);
16. the lab-frame anchor (``lab_frame_phases``): psi's lab-frame NLL held
   to the kernel path on a T=2048 prefix at rtol 2e-4; one lab-frame Adam
   step on a T=2049 prefix of bench.py's primary cell (D=64, B=128,
   T=16384) after a short warm-up, beside the kernel path's step there
   (their ratio, per frame, is vs_baseline), and the whole-length gap
   between the two NLLs (no gradient) held to a limit set from a float64
   run (``tools/lab_frame_gap.py``); rho's lab-frame step and its
   peak memory on a T=1025 prefix of its cell (D=64, rank 64, B=8), its
   loss held to the kernel path's at rtol 2e-4.

It prints each phase's measurements, the card line, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
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

T_PREFIX = 2048        # prefix for the variants the main paths do not run
TRAIN_STEPS = 3        # Adam steps of the train CLI's first call
# Training kernels vs plain, max|kernel - plain| <= TOL * max|plain|, per
# output, for both families. The main path's variant (the CLI's precision
# and norm) is held at the full T=16384, the other three on the T=2048
# prefix.
# Forward (loss, the state stream ys and its norms): as the NLL above.
# Adjoint (dse, dt0, dy, dehat): fed the plain forward's own streams, so
#   only its own summation order differs; its chain renormalises dt with the
#   state, so the difference stays at the per-step level as in the forward:
#   1e-4 at highest, 1e-3 at high, where the bf16 splits of dy can round
#   the other way.
# Reductions (dAb, dBb, dRb or dXb): fed the plain adjoint's own streams,
#   both sides form the same bf16 splits, and only the order of the fp32
#   sum over n_steps x 128 terms differs (~1e-6 of max|plain| at T=16384):
#   1e-5 at both precisions. The rounding errors of a kernel that dropped
#   the lo terms average out over the coherent sums, to ~5e-5, so a looser
#   limit would not see it.
# rho: the same limits for the same reasons; its kernels sum a segment of
#   2D x rank terms where psi sums 2D, in another order than the plain
#   versions, which moves the per-step difference by ~1e-7 at most.
# Control: the kernels at default (bf16 products without the lo terms)
#   against the plain versions at high must miss each high limit.
TOL_TRAIN = {"highest": {"fwd": 1e-4, "bwd": 1e-4, "cot": 1e-5},
             "high": {"fwd": 1e-3, "bwd": 1e-3, "cot": 1e-5}}
PRECISIONS = ("highest", "high", "default")
# the training path's loss and its six parameter gradients vs autograd
# through the eager reference: the same fp32 arithmetic in another order,
# so the value to 1e-4 and each gradient to 1e-3 of its largest element
TOL_TRAIN_REFERENCE = (1e-4, 1e-3)

# FLOPs of the training kernels: the fewest [2D,2D] products a lane-step
# (2 n^2 FLOPs each, n = 2D) the function needs, plus the per-example-step
# matrix work, in n^2 FLOPs.
# psi (one lane an example): forward 3 (Ab t, Bb t, Rb y); adjoint 4 (RU
#   recomputed on its chain); reductions 3.
# rho: an example's rank lanes share one increment s, so y = Ab t + s Bb t
#   = (Ab + s Bb) t is one product after one multiply-add per element of a
#   [2D,2D] matrix (2 n^2) an example-step. Forward 2 (that, and Xb y).
#   Adjoint 3: Ab^T dy and Bb^T dy on its chain (dse needs the latter
#   alone), and (Xb + Xb^T) y in its tail. Reductions 2, as
#   csrc/psi_cotangents.cu computes them: P = dy t^T summed over an
#   example's lanes of a step, which gives dAb by n^2 adds and dBb by n^2
#   multiply-adds (s P; 3 n^2 an example-step), and dehat y y^T for dXb.
#   psi's lanes each have their own s, so its reductions stay 3 products
#   (dy t^T, dy (s t)^T, 2 dehat y y^T).
TRAIN_PRODUCTS = {"psi": {"fwd": 3, "bwd": 4, "cot": 3},
                  "rho": {"fwd": 2, "bwd": 3, "cot": 2}}
TRAIN_BUILDS = {"psi": {"fwd": 0, "bwd": 0, "cot": 0},
                "rho": {"fwd": 2, "bwd": 0, "cot": 3}}

# The rho family's main paths (README: "Training, mixed state (rho, D=64,
# B=8, T=16384)" and "Fused SDE samplers (rho, D=64)"), at rank D = 64.
RHO_N_CHAINS = 8       # 8 chains x rank 64 = 512 state columns
RHO_B = 8
RHO_T = 16384
RHO_T_SAMPLE_CHECK = 16384   # the sampler's prefix held at TOL["highest"]
RHO_T_TRAIN_MAIN = 4097      # the training kernels' main variant vs plain
# A sampler's waveform is a running sum of T increments, so the kernel's and
# the plain version's per-step differences in e dt add up along the run:
# 7.9e-5 of max|plain| over all 65536 steps on an H100 at D=64, rank 64, 16x
# the T=4096 level. So both samplers' whole runs are held at 1e-3, their
# prefixes (RHO_T_SAMPLE_CHECK, SPLIT_T_SAMPLE_CHECK) at TOL["highest"].
RHO_TOL_SAMPLE_FULL = 1e-3

# Rank-chunked rho training past the monolithic kernels' shared memory: the
# repo's beyond-ceiling model (README "Large-D frontier", the d256_full case
# of tools/rankstream_bench.py): D=256, full purification rank, B=8,
# T=16385, the train CLI's defaults.
RANK_D = 256
RANK_B = 8
RANK_T = 16385
RANK_T_PREFIX = 2049   # the kernels vs their plain versions
RANK_TRAIN_STEPS = 1   # the train CLI's first call; the second takes one more
RANK_KERNELS = ("rank_partials_fwd", "rank_partials_bwd", "rank_cotangents")
RANK_RECOMPUTE_KERNELS = ("rank_partials_fwd_ckpt", "rank_partials_recompute")
# chunked vs monolithic on the card, both branches at D=64, rank 64, B=8,
# T=16385: the chunked path forced with chunks of 16 rows. The chunked loss
# to 1e-5 relative of its value in float64 (the monolithic kernel's loss,
# summed over the steps in one fp32 register, is ~1e-4 off it at this T);
# each gradient to 1e-4 of the monolithic one's largest element (the same
# fp32 arithmetic in another order).
RANK_CHECK_CHUNK = 16
TOL_CHUNKED = (1e-5, 1e-4)
# ROADMAP A4 in whole Adam steps (a4_whole_steps): timed steps after one
# warm-up step
A4_REPS = 2
# The partials kernels' whole-run times before their ring redesign (CUDA
# events over T=16385 at D=256, highest; NVIDIA H100 80GB HBM3, 700 W; the
# last chip_smoke.py run of that tree), printed beside this run's.
RANK_BEFORE_MS = {"rank_partials_fwd": 2377.0, "rank_partials_bwd": 2809.8,
                  "rank_partials_fwd_ckpt": 2508.7,
                  "rank_partials_recompute": 1490.6, "recompute_adjoint":
                  5096.6}
# the kernel build's ptxas report (registers, spills), kept by main()
BUILD = {"log": ""}
# the measurement builds of tools/split_adjoint_attribution.py (started
# after the kernel build, loaded by the split phases)
SPLIT_ATTRIBUTION = {"builds": None, "libs": None}


# The training path without the state stream (kernel_stream="off"): the
# checkpoint forwards, the segment recomputes and the recompute adjoints.
# Kernels vs plain on the T=2048 prefix (rank: T=2049), each kernel fed the
# plain version's inputs, max|kernel - plain| <= TOL * max|plain|:
# checkpoint forward (loss, ck): 1e-5 at highest (its states drift from the
#   plain loop's by the fp32 rounding of 2047 steps, a few 1e-6 at that
#   length); at high the training forward's 1e-3;
# segment recompute (ys and the norms from the plain checkpoints, at most
#   16 steps from each): 1e-5 at highest, 1e-4 at high (a bf16 split of a
#   state a last bit apart can round the other way, ~1e-5 a step);
# the whole recompute adjoint (dse, dt0 and the cotangents, fed the plain
#   checkpoints; each segment's reductions run on the kernels' own dy): the
#   adjoint's 1e-4 at highest, 1e-3 at high.
# Control: the kernels at default against the plain versions at high must
#   miss the high limits of the forward and the recompute.
TOL_CKPT = {"highest": 1e-5, "high": 1e-3}
TOL_RECOMPUTE = {"highest": 1e-5, "high": 1e-4}
TOL_RECOMPUTE_BWD = {"highest": 1e-4, "high": 1e-3}
# the recompute path against the streamed path on the card, both through
# the kernels: the forward is one template, so the loss is the same to the
# bit, held at 1e-6 relative; the recomputed states are the stream's to
# the bit, so the gradients differ only by the order of the reductions'
# sums, held at 1e-5 of each gradient's largest element
TOL_OFF = (1e-6, 1e-5)
# the train CLI without the stream at the full widths: psi at the TPU's
# saturated batch (README "saturated batch", D=64, B=1024, T=16384), rho
# at its headline (D=64, rank 64, B=8, T=16384), 2 Adam steps, a restore
# and 1 more; the rank partials at D=256 (1 + 1)
PSI_OFF_B = 1024
# psi's whole-run times at that batch with one column a CTA (CUDA events,
# D=64, T=16384, highest; steps host clock, mean of 2; NVIDIA H100 80GB
# HBM3, 700 W; the last chip_smoke.py run of that tree), printed beside
# this run's
PSI_ONE_COLUMN_MS = {"checkpoint forward": 418.23,
                     "segment recompute": 282.58,
                     "whole recompute adjoint": 1017.44, "step off": 1450.10,
                     "step streamed": 1176.09}
OFF_STEPS = 2
RANK_OFF_STEPS = 1


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


T_START = time.perf_counter()


def phase(name):
    """A phase's header, with the seconds since the script started."""
    print(f"== {name} [at {time.perf_counter() - T_START:.1f} s]",
          flush=True)


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


def _free():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _control(name, got_fn, want, limit):
    """The kernel at default against the plain version at high must miss
    the high limit; returns the worst reading."""
    got = got_fn()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst = max(rel_err(a, b)[1] for a, b in zip(got, want))
    check(worst > limit, f"control: {name} at default is within the high "
                         f"limit of plain at high ({worst:.3e})")
    return worst


@dataclasses.dataclass
class Family:
    """What the training phases need of one model family. Its kernels are
    ``block.<name>_train_fwd``, ``<name>_train_bwd`` and
    ``<name>_cotangents``, each beside its ``_plain`` version."""
    name: str              # "psi" or "rho"
    params: object         # the family's seeded weights
    cfg: object
    B: int                 # the training headline's batch and length
    T: int
    seed: int              # of its batch; the step timing's data uses seed+1
    ref_cols: int          # examples of the check against autograd
    reference: object      # the eager loss that autograd runs through
    replaces: dict         # "fwd" / "bwd" / "cot" / "ckpt" / "rec" -> the
                           # TPU kernel
    dehat_scale: float     # the third reduction's weight on dehat


# psi's adjoint launches a tail kernel before its chain (one C entry;
# csrc/psi_train_bwd.cu), counted and timed as a kernel of its own
PSI_TAIL = "psi_train_bwd_tail"


def _train_kernel_names(family: str) -> dict:
    return {"fwd": f"{family}_train_fwd", "bwd": f"{family}_train_bwd",
            "cot": f"{family}_cotangents"}


def _recompute_kernel_names(family: str) -> dict:
    return {"ckpt": f"{family}_train_fwd_ckpt",
            "rec": f"{family}_recompute"}


def _training_wrappers() -> dict:
    """Every training kernel wrapper, both families' and the rank
    partials', streamed and recompute path, both split pairs and psi's
    batched pair, by name."""
    from audio_mps_tpu_torch.ops import block, cluster, rank, split
    counted = {k: getattr(block, k) for f in ("psi", "rho")
               for k in _train_kernel_names(f).values()}
    counted.update((k, getattr(block, k)) for f in ("psi", "rho")
                   for k in _recompute_kernel_names(f).values())
    counted.update((k, getattr(rank, k)) for k in RANK_KERNELS
                   + RANK_RECOMPUTE_KERNELS)
    counted.update((k, getattr(split, k)) for k in (
        "psi_split_fwd", "psi_split_bwd", "rho_split_fwd", "rho_split_bwd"))
    counted.update((k, getattr(block, k)) for k in BATCHED_KERNELS)
    counted[PSI_TAIL] = block.psi_train_bwd_tail
    counted.update((w.__name__, w) for w in cluster.WRAPPERS
                   if w not in (cluster.psi_sample_cluster,
                                cluster.psi_nll_cluster))
    return counted


def train_cli_phase(dev, mps_model, cfg, T, steps, per_step, flags=(),
                    dataset="damped_sine"):
    """The train CLI on ``dataset``'s batches at ``cfg``'s width and
    ``kernel_stream``: ``steps`` Adam steps, then a second call that
    restores step ``steps`` and takes one more. Checks the checkpoints, the
    restored Adam state, params.npz, the family of the weights and that
    metrics and weights are finite; of every training wrapper
    (``_training_wrappers``), those in ``per_step`` must launch that many
    times a step (None: at least once a step), the others not at all.
    Returns the launch counts."""
    from audio_mps_tpu_torch.models.params import PsiParams, RhoParams
    from audio_mps_tpu_torch.train import parse_args, train

    counted = _training_wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        argv = [f"--mps_model={mps_model}", f"--dataset={dataset}",
                f"--sample_duration={T}",
                f"--hparams=bond_dim={cfg.bond_dim},"
                f"minibatch_size={cfg.minibatch_size},"
                f"kernel_stream={cfg.kernel_stream}",
                f"--logdir={tmp}", f"--device={dev.type}", *flags]
        for w in counted.values():
            w.launches = 0
        run, device = parse_args(argv + [f"--max_steps={steps}"])
        t0 = time.perf_counter()
        _, m_first = train(run, device=device)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        ckdir = os.path.join(run.run_logdir(cfg), "checkpoints")
        first_ckpts = sorted(os.listdir(ckdir))
        run2, device = parse_args(argv + [f"--max_steps={steps + 1}"])
        t0 = time.perf_counter()
        p_last, m_last = train(run2, device=device)
        torch.cuda.synchronize()
        t_second = time.perf_counter() - t0
        launches = {k: w.launches for k, w in counted.items()}
        state = torch.load(os.path.join(ckdir, f"ckpt_{steps + 1}.pt"),
                           map_location="cpu", weights_only=True)
        has_npz = os.path.exists(os.path.join(run.run_logdir(cfg),
                                              "params.npz"))
    moved = {k: v for k, v in launches.items() if v}
    print(f"  first call: {steps} steps in {t_first * 1e3:.1f} ms, "
          f"checkpoints {first_ckpts}; second call: restore + 1 step in "
          f"{t_second * 1e3:.1f} ms (host clock, set-up included); final "
          f"loss {float(m_last['model_loss']):.6f}; launches {moved}",
          flush=True)
    check(first_ckpts == [f"ckpt_{steps}.pt"],
          f"first call left {first_ckpts}")
    check(state["step"] == steps + 1, f"final step {state['step']}")
    check(all(float(s["step"]) == steps + 1
              for s in state["optimizer"]["state"].values()),
          "the Adam state was not restored")
    check(has_npz, "the train CLI wrote no params.npz")
    want = RhoParams if mps_model == "rho_mps" else PsiParams
    check(type(p_last) is want, f"the train CLI made no {want.__name__}")
    for m in (m_first, m_last):
        check(all(bool(torch.isfinite(v).all()) for v in m.values()),
              f"non-finite metrics {m}")
    check(all(bool(torch.isfinite(x).all()) for x in p_last.parameters()),
          "non-finite parameters")
    for name, count in launches.items():
        if name not in per_step:
            check(count == 0, f"{name} launched {count} times on the "
                              f"{mps_model} training path")
        else:
            n = per_step[name]
            check(count >= steps + 1 if n is None
                  else count == n * (steps + 1),
                  f"{name} launched {count} times in {steps + 1} steps of "
                  f"the {mps_model} training path ({n} a step expected)")
    return launches


def time_train_step(dev, mps_model, cfg, params, T, seed, reps):
    """(host-clock ms of one ``make_train_step`` step, batch draw included,
    the mean of ``reps`` after a warm-up step; peak device memory of the
    timed steps in bytes) on a copy of ``params``."""
    from audio_mps_tpu_torch import weights
    from audio_mps_tpu_torch.data import damped_sine_iterator
    from audio_mps_tpu_torch.training import make_train_step

    from_numpy = getattr(weights, f"{mps_model[:3]}_params_from_numpy")
    tp = from_numpy(weights.params_to_numpy(params), dev)
    _, step = make_train_step(mps_model, cfg, tp, device=dev)
    data = damped_sine_iterator(cfg, T, seed=seed, device=dev)
    step(next(data))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        metrics = step(next(data))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    check(bool(torch.isfinite(metrics["total_loss"])), "non-finite loss")
    peak = torch.cuda.max_memory_allocated(dev)
    del tp, step, data, metrics
    _free()
    return step_ms, peak


def train_phases(dev, fam: Family):
    """The training phases of one family; returns its three kernels'
    entries of the {"kernels": [...]} line."""
    from audio_mps_tpu_torch import weights
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.ops import block
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL

    cfg, B, T = fam.cfg, fam.B, fam.T
    rank = fam.params.Wx.shape[0] if fam.name == "rho" else 1
    n = 2 * D
    names = _train_kernel_names(fam.name)
    kernels = {r: getattr(block, k) for r, k in names.items()}
    plains = {r: getattr(block, k + "_plain") for r, k in names.items()}
    aux = "n2s" if fam.name == "psi" else "trs"   # the forward's norm stream
    labels = {"fwd": ("loss", "ys", aux), "bwd": ("dse", "dt0", "dy", "dehat"),
              "cot": ("dAb", "dBb", "dRb" if fam.name == "psi" else "dXb")}
    shape = f"D={D}, B={B}" + (f", rank {rank}" if fam.name == "rho" else "")
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(fam.seed), B,
                                T, cfg.delta_t)
    t_in = getattr(block, f"{fam.name}_nll_inputs")(fam.params, cfg, signals)
    eps = dict(log_eps=t_in.pop("log_eps"), norm_eps=t_in.pop("norm_eps"))
    pre = dict(t_in, se=t_in["se"][:T_PREFIX - 1].contiguous())
    g = torch.full((B,), 1.0 / B, device=dev)     # the batch mean's cotangent

    def fwd(ins, plain=False, **o):
        return (plains if plain else kernels)["fwd"](**ins, **eps, **o)

    def bwd(ins, ys, norms, plain=False, **o):
        return (plains if plain else kernels)["bwd"](
            **ins, g=g, ys=ys, **{aux: norms}, **eps, **o)

    def cot(ins, ys, norms, dy, dehat, plain=False, **o):
        return (plains if plain else kernels)["cot"](
            dy, ys, ins["t0"], ins["se"], norms, dehat,
            norm_eps=eps["norm_eps"], **o)

    def kernel_outputs(role, ins, f_p, b_p, **o):
        """The kernel's outputs, each kernel fed the plain versions' streams."""
        torch.cuda.synchronize()
        if role == "fwd":
            out = fwd(ins, **o)
        elif role == "bwd":
            out = bwd(ins, f_p[1], f_p[2], **o)
        else:
            out = cot(ins, f_p[1], f_p[2], b_p[2], b_p[3], **o)
        torch.cuda.synchronize()
        return out

    main = (cfg.kernel_precision, cfg.defer_norm)
    # psi's main variant over the whole run; rho's on a prefix (its plain
    # adjoint takes ~12 s over the whole run)
    t_main = T if fam.name == "psi" else RHO_T_TRAIN_MAIN
    main_in = (t_in if t_main == T
               else dict(t_in, se=t_in["se"][:t_main - 1].contiguous()))
    phase(f"{fam.name} training kernels vs plain ({shape}): the main path's "
          f"variant {main} at T={t_main}, the other three on a T={T_PREFIX} "
          f"prefix")
    err_at, plain_ms, ctrl = {}, {}, {}
    variants = [(p, d) for p in ("highest", "high") for d in (False, True)
                if (p, d) != main] + [main]
    for prec, defer in variants:
        ins = main_in if (prec, defer) == main else pre
        o = dict(precision=prec, defer_norm=defer)
        t_f, f_p = timed(lambda: fwd(ins, plain=True, **o))
        t_b, b_p = timed(lambda: bwd(ins, f_p[1], f_p[2], plain=True, **o))
        t_c, c_p = timed(lambda: cot(ins, f_p[1], f_p[2], b_p[2], b_p[3],
                                     plain=True, **o))
        want = {"fwd": f_p, "bwd": b_p, "cot": c_p}
        if (prec, defer) == main:
            plain_ms = {"fwd": t_f, "bwd": t_b, "cot": t_c}
        line = []
        for role, outs in labels.items():
            tol = TOL_TRAIN[prec][role]
            got = kernel_outputs(role, ins, f_p, b_p, **o)
            worst = 0.0
            for label, a, b in zip(outs, got, want[role]):
                check(bool(torch.isfinite(a).all()),
                      f"{names[role]} {label}: non-finite")
                err, rel = rel_err(a, b)
                worst = max(worst, err)
                line.append(f"{label} {rel:.2e}")
                check(rel <= tol, f"{names[role]} {prec} defer={defer} "
                                  f"{label}: rel err {rel:.3e} (tol {tol:g})")
            if (prec, defer) == main:
                err_at[role] = worst
            del got
        if fam.name == "psi" and (prec, defer) == main:
            # the adjoint's tail alone on the plain forward's streams
            t_args = (ins["rb"], ins["se"], g, f_p[1], f_p[2])
            t_kw = dict(eps, **o)
            plain_ms["tail"], t_p = timed(
                lambda: block.psi_train_bwd_tail_plain(*t_args, **t_kw))
            got = block.psi_train_bwd_tail(*t_args, **t_kw)
            torch.cuda.synchronize()
            tol, worst = TOL_TRAIN[prec]["bwd"], 0.0
            for label, a, b in zip(("q", "ds0", "dehat", "dn2_new"), got,
                                   t_p):
                check(bool(torch.isfinite(a).all()),
                      f"{PSI_TAIL} {label}: non-finite")
                err, rel = rel_err(a, b)
                worst = max(worst, err)
                line.append(f"tail {label} {rel:.2e}")
                check(rel <= tol, f"{PSI_TAIL} {prec} defer={defer} "
                                  f"{label}: rel err {rel:.3e} (tol {tol:g})")
            err_at["tail"] = worst
            del got, t_p
        print(f"  {prec} defer_norm={defer}, T={ins['se'].shape[0] + 1} (tol "
              + " / ".join(f"{v:g}" for v in TOL_TRAIN[prec].values())
              + "), x max|plain|: " + ", ".join(line), flush=True)
        if prec == "high" and ins is pre:
            # control: the kernels at default (bf16 products without the lo
            # terms) against the plain versions at high, on the same inputs
            readings = []
            for role in labels:
                worst = _control(names[role], lambda: kernel_outputs(
                    role, ins, f_p, b_p, precision="default",
                    defer_norm=defer), want[role], TOL_TRAIN["high"][role])
                ctrl[role] = max(ctrl.get(role, 0.0), worst)
                readings.append(f"{names[role]} {worst:.2e}")
            print(f"  control, kernels at default vs plain at high, defer_norm"
                  f"={defer}, worst x max|plain| (must exceed the high "
                  f"limits): " + ", ".join(readings), flush=True)
        del f_p, b_p, c_p, want
        _free()
    print(f"  plain versions at T={t_main} ({main}): fwd "
          f"{plain_ms['fwd']:.1f} ms, "
          f"bwd {plain_ms['bwd']:.1f} ms, cotangents {plain_ms['cot']:.1f} ms "
          f"(CUDA events, one run)", flush=True)

    phase(f"{fam.name} training path vs autograd through the eager reference "
          f"(D={D}, {fam.ref_cols} examples, T=512)")
    short = signals[:fam.ref_cols, :512].contiguous()
    cfg_r = dataclasses.replace(cfg, minibatch_size=fam.ref_cols)
    from_numpy = getattr(weights, f"{fam.name}_params_from_numpy")
    pk = from_numpy(weights.params_to_numpy(fam.params), dev)
    pr = from_numpy(weights.params_to_numpy(fam.params), dev)
    loss_k = getattr(block, f"{fam.name}_nll_block_trainable")(
        pk, cfg_r, short, precision="highest", defer_norm=cfg.defer_norm)
    loss_k.backward()
    loss_r = fam.reference(pr, cfg_r, short)
    loss_r.backward()
    _, rel = rel_err(loss_k.detach(), loss_r.detach())
    line = [f"loss {rel:.2e}"]
    check(rel <= TOL_TRAIN_REFERENCE[0], f"{fam.name} train loss vs "
                                         f"reference: {rel:.3e}")
    for name in pk.NAMES:
        _, rel = rel_err(getattr(pk, name).grad, getattr(pr, name).grad)
        line.append(f"d{name} {rel:.2e}")
        check(rel <= TOL_TRAIN_REFERENCE[1],
              f"{fam.name} gradient of {name} vs reference: rel err "
              f"{rel:.3e}")
    print(f"  x max|reference| (tol {TOL_TRAIN_REFERENCE[0]:g} / "
          f"{TOL_TRAIN_REFERENCE[1]:g}): " + ", ".join(line), flush=True)
    del pk, pr, loss_k, loss_r

    phase(f"{fam.name} training path: train CLI ({shape}, T={T}), "
          f"{TRAIN_STEPS} steps, then a restore and one more step")
    per_step = {k: 1 for k in names.values()}
    if fam.name == "psi":
        per_step[PSI_TAIL] = 1
    launches = train_cli_phase(dev, f"{fam.name}_mps", cfg, T, TRAIN_STEPS,
                               per_step)
    reps = 5
    step_ms, _ = time_train_step(dev, f"{fam.name}_mps", cfg, fam.params, T,
                                 fam.seed + 1, reps)
    print(f"  {fam.name} train step (make_train_step, batch draw included): "
          f"{step_ms:.2f} ms host clock, mean of {reps} after a warm-up; "
          f"{B * (T - 1) / step_ms * 1e3:.4e} frames/s", flush=True)

    phase(f"{fam.name} training timings (CUDA events, median of 5 after 1 "
          f"warm-up)")
    o = dict(precision=cfg.kernel_precision, defer_norm=cfg.defer_norm)
    loss, ys, norms = fwd(t_in, **o)
    dse, dt0, dy, dehat = bwd(t_in, ys, norms, **o)
    # the reductions at each precision on the main path's streams (high and
    # default on the tensor cores), and two launches of each on the same
    # streams equal bit for bit
    cot_ms = {}
    for prec in PRECISIONS:
        v = dict(o, precision=prec)
        cot_ms[prec] = median_ms(lambda: cot(t_in, ys, norms, dy, dehat, **v))
        runs = [cot(t_in, ys, norms, dy, dehat, **v) for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"{names['cot']} at {prec}: two launches differ")
        del runs
    ms = {"fwd": median_ms(lambda: fwd(t_in, **o)),
          "bwd": median_ms(lambda: bwd(t_in, ys, norms, **o)),
          "cot": cot_ms[cfg.kernel_precision]}
    if fam.name == "psi":
        # the adjoint's tail alone (its time is in the adjoint's too)
        tail_ms = median_ms(lambda: block.psi_train_bwd_tail(
            t_in["rb"], t_in["se"], g, ys, norms, **eps, **o))
    # library yardstick of the reductions: the three [2D, M] x [M, 2D]
    # products as torch.matmul (fp32, TF32 off) on operands built once
    scales = block._state_scales(block._lanes(norms, rank),
                                 norm_eps=eps["norm_eps"],
                                 unroll=DEFAULT_UNROLL,
                                 defer_norm=cfg.defer_norm)
    ts = block._input_states(t_in["t0"], ys, scales)
    del scales, dse, dt0

    def lanes(x):
        return x.transpose(0, 1).reshape(n, -1)

    ops = [(lanes(dy), lanes(ts)),
           (lanes(dy), lanes(block._lanes(t_in["se"], rank)[:, None, :]
                             * ts))]
    del ts
    ops.append((lanes(fam.dehat_scale
                      * block._lanes(dehat, rank)[:, None, :] * ys),
                lanes(ys)))
    del loss, ys, norms, dy, dehat
    _free()
    library_ms = median_ms(lambda: [a @ b.T for a, b in ops])
    del ops
    _free()
    # the main path's variant once more last, as a repeat within the call
    for prec, defer in (("high", True), ("highest", False), main):
        v = dict(precision=prec, defer_norm=defer)
        l_v, ys_v, norms_v = fwd(t_in, **v)
        b_v = bwd(t_in, ys_v, norms_v, **v)
        t_f = median_ms(lambda: fwd(t_in, **v))
        t_b = median_ms(lambda: bwd(t_in, ys_v, norms_v, **v))
        t_c = median_ms(lambda: cot(t_in, ys_v, norms_v, b_v[2], b_v[3], **v))
        print(f"  {prec} defer_norm={defer}: fwd {t_f:.3f} ms, bwd "
              f"{t_b:.3f} ms, cotangents {t_c:.3f} ms", flush=True)
        del l_v, ys_v, norms_v, b_v
        _free()
    # bounds: FLOPs as TRAIN_PRODUCTS and TRAIN_BUILDS count them; bytes:
    # the ys / dy streams, the per-step rows, the constants and the initial
    # state, each read or written once
    ex_steps = (T - 1) * B
    lane_steps = ex_steps * rank
    cols = B * rank
    mats = 3 * n * n
    nbytes = {"fwd": lane_steps * n + 2 * ex_steps + mats + n * cols + B,
              "bwd": (2 * lane_steps * n + 4 * ex_steps + mats + 2 * n * cols
                      + B),
              "cot": 2 * lane_steps * n + 3 * ex_steps + n * cols + mats}
    entries = []
    for role, name in names.items():
        flops = (TRAIN_PRODUCTS[fam.name][role] * 2 * n * n * lane_steps
                 + TRAIN_BUILDS[fam.name][role] * n * n * ex_steps)
        bound, by = bound_ms(flops, 4 * nbytes[role])
        src = "psi_cotangents.cu" if role == "cot" else f"{name}.cu"
        entries.append({
            "name": name, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{src}",
            "replaces": fam.replaces[role], "launches": launches[name],
            "max_abs_err": err_at[role], "ms": ms[role],
            "plain_ms": plain_ms[role], "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms if role == "cot" else None})
        if role == "cot":
            entries[-1]["ms_by_precision"] = cot_ms
            print(f"  {name} (two launches equal bit for bit at each "
                  f"precision): highest {cot_ms['highest']:.3f} / high "
                  f"{cot_ms['high']:.3f} / default {cot_ms['default']:.3f} "
                  f"ms; torch.matmul x3 {library_ms:.3f} ms; kernel / "
                  f"torch.matmul {ms[role] / library_ms:.3f}; "
                  f"{bound / ms[role] * 100:.1f}% of its bound", flush=True)
        print(f"  {name}: {ms[role]:.3f} ms, launches per train step "
              f"{launches[name] / (TRAIN_STEPS + 1):g} (plain "
              f"{plain_ms[role]:.1f} ms at T={t_main}, bound {bound:.3f} ms "
              f"by "
              f"{by}, control at default "
              f"{ctrl.get(role, float('nan')):.2e})", flush=True)
    if fam.name == "psi":
        # the tail: Rb y and Rb^T (2 dehat y) a lane-step; bytes: ys read
        # and q written, se, n2s read, ds0, dehat, dn2_new written, Rb, g
        bound, by = bound_ms(2 * 2 * n * n * lane_steps, 4 * (
            2 * lane_steps * n + 5 * ex_steps + n * n + B))
        entries.append({
            "name": PSI_TAIL, "route": "cuda",
            "source": "audio_mps_tpu_torch/csrc/psi_train_bwd.cu",
            "replaces": fam.replaces["bwd"] + " (its batched tail)",
            "launches": launches[PSI_TAIL], "max_abs_err": err_at["tail"],
            "ms": tail_ms, "plain_ms": plain_ms["tail"], "bound_ms": bound,
            "bound_by": by, "library_ms": None})
        print(f"  {PSI_TAIL}: {tail_ms:.3f} ms (within the adjoint's "
              f"{ms['bwd']:.3f}), launches per train step "
              f"{launches[PSI_TAIL] / (TRAIN_STEPS + 1):g} (plain "
              f"{plain_ms['tail']:.1f} ms at T={T}, bound {bound:.3f} ms by "
              f"{by})", flush=True)
    print(f"  torch.matmul of the three reductions: {library_ms:.3f} ms; "
          f"{fam.name} train step {step_ms:.2f} ms, of which the three "
          f"kernels {sum(ms.values()):.2f} ms", flush=True)
    return entries


# FLOPs of the recompute path's kernels, as TRAIN_PRODUCTS and TRAIN_BUILDS
# count them: the checkpoint forward does the streamed forward's work; the
# recompute needs the update alone (its expectation feeds only the loss):
# psi 2 products (Ab t, Bb t; each column has its own s), rho and the rank
# partials 1 ((Ab + s Bb) t) after the 2 n^2 build an example-step.
RECOMPUTE_PRODUCTS = {"psi": 2, "rho": 1}
RECOMPUTE_BUILDS = {"psi": 0, "rho": 2}


def _adjoint_bound(family, n, lane_steps, ex_steps, ck_elems, cols, B):
    """(bound ms, bound_by) of the whole recompute adjoint over a run: the
    recompute's products, the adjoint's and the reductions', the fewest
    each needs; bytes of its inputs (ck, se, g, the constants) and outputs
    (dse, dt0, the three cotangents) once."""
    flops = ((RECOMPUTE_PRODUCTS[family] + TRAIN_PRODUCTS[family]["bwd"]
              + TRAIN_PRODUCTS[family]["cot"]) * 2 * n * n * lane_steps
             + (RECOMPUTE_BUILDS[family] + TRAIN_BUILDS[family]["bwd"]
                + TRAIN_BUILDS[family]["cot"]) * n * n * ex_steps)
    nbytes = ck_elems + 2 * ex_steps + B + 6 * n * n + n * cols
    return bound_ms(flops, 4 * nbytes)


def _segment_inputs(con, ck, se, segments, unroll):
    """The segment recompute's inputs for each of ``segments``, as the
    recompute adjoint slices them."""
    return [dict(con, ck=ck[k0 // unroll:-(-k1 // unroll)], se=se[k0:k1])
            for k0, k1 in segments]


def _recompute_run(recompute, con, ck, se, segments, **o):
    """The segment recompute over a whole run, a segment at a time, as the
    recompute adjoint calls it; keeps nothing."""
    for args in _segment_inputs(con, ck, se, segments, o["unroll"]):
        recompute(**args, **o)


def _recompute_bounds(family, n, lane_steps, ex_steps, ck_elems, cols,
                      ckpt_out):
    """{"ckpt", "rec"}: (bound ms, bound_by) of the checkpoint forward and
    of the segment recompute over a run; bytes of each input read once and
    each output written once (``ckpt_out``: the forward's elements besides
    ck: the loss, or the partials and the final state)."""
    mats = 3 * n * n
    flops = {
        "ckpt": (TRAIN_PRODUCTS[family]["fwd"] * 2 * n * n * lane_steps
                 + TRAIN_BUILDS[family]["fwd"] * n * n * ex_steps),
        "rec": (RECOMPUTE_PRODUCTS[family] * 2 * n * n * lane_steps
                + RECOMPUTE_BUILDS[family] * n * n * ex_steps)}
    nbytes = {"ckpt": ck_elems + ex_steps + mats + n * cols + ckpt_out,
              "rec": ck_elems + 2 * ex_steps + lane_steps * n
              + 2 * n * n}
    return {r: bound_ms(flops[r], 4 * nbytes[r]) for r in flops}


def _hold_outputs(tag, labels, got, want, tol):
    """Each kernel output of ``got`` finite and within ``tol`` of max|plain|
    of its ``want``. Returns {label: (abs err, rel err)}."""
    res = {}
    for label, a, b in zip(labels, got, want):
        check(bool(torch.isfinite(a).all()), f"{tag} {label}: non-finite")
        res[label] = rel_err(a, b)
        check(res[label][1] <= tol, f"{tag} {label}: rel err "
                                    f"{res[label][1]:.3e} (tol {tol:g})")
    return res


def _readings(prefix, res):
    """(the readings of ``_hold_outputs``' ``res`` for a printed line, the
    worst absolute error)."""
    return ([f"{prefix} {k} {rel:.2e}" for k, (_, rel) in res.items()],
            max(err for err, _ in res.values()))


def _hold_to_plain(tag, prec, o, calls, want, labels, tols, err_at, ctrl,
                   line):
    """Each kernel call of ``calls`` (role -> fn(**o)) against the plain
    versions' ``want[role]`` at ``prec``: finite and within
    ``tols[role][prec]`` of max|plain|, each reading added to ``line``. At
    highest the worst absolute error goes to ``err_at``; at high the
    control (the kernel at default) of every role but the whole adjoint to
    ``ctrl``."""
    for role, fn in calls.items():
        got = fn(**o)
        torch.cuda.synchronize()
        readings, worst = _readings(prec, _hold_outputs(
            f"{tag} {role} {prec}", labels[role], got, want[role],
            tols[role][prec]))
        line += readings
        if prec == "highest":
            err_at[role] = worst
        elif role != "adj":
            ctrl[role] = _control(
                f"{tag} {role}", lambda: fn(**dict(o, precision="default")),
                want[role], tols[role]["high"])
        del got


def _off_vs_streamed(tag, nll, params, from_numpy, cfg, dev, other=None,
                     label="off"):
    """The loss and six gradients of ``nll(q, cfg)`` (the streamed path)
    and of ``nll(q, cfg with kernel_stream="off")`` (or, given, of
    ``other(q, cfg)``, read as ``label``), each on a fresh copy of
    ``params``, held to each other at TOL_OFF; returns the readings."""
    from audio_mps_tpu_torch import weights
    res = {}
    off = dataclasses.replace(cfg, kernel_stream="off")
    for path, fn, c in (("streamed", nll, cfg),
                        ("off", other or nll, cfg if other else off)):
        q = from_numpy(weights.params_to_numpy(params), dev)
        loss = fn(q, c)
        loss.backward()
        res[path] = (loss.detach(), q)
    torch.cuda.synchronize()
    _, rel = rel_err(res["off"][0], res["streamed"][0])
    line = [f"loss {rel:.2e}"]
    check(rel <= TOL_OFF[0], f"{tag} {label} vs streamed loss: {rel:.3e}")
    for pname in q.NAMES:
        _, rel = rel_err(getattr(res["off"][1], pname).grad,
                         getattr(res["streamed"][1], pname).grad)
        line.append(f"d{pname} {rel:.2e}")
        check(rel <= TOL_OFF[1], f"{tag} {label} vs streamed gradient of "
                                 f"{pname}: {rel:.3e}")
    return line


def recompute_phases(dev, fam: Family, cli_B: int):
    """The training path without the state stream (kernel_stream="off") of
    one family: its checkpoint forward, segment recompute and recompute
    adjoint vs their plain versions on the T=2048 prefix (with controls at
    ``default``); the recompute path vs the streamed path on the card at
    the family's training headline; the train CLI at batch ``cli_B``; and
    at that batch the kernels' CUDA-event times beside their bounds and one
    step's time and peak memory, off and streamed. Returns the two kernels'
    entries of the {"kernels": [...]} line."""
    from audio_mps_tpu_torch import weights
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.ops import block
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL

    cfg, T, name = fam.cfg, fam.T, fam.name
    rank = fam.params.Wx.shape[0] if name == "rho" else 1
    n = 2 * D
    names = _recompute_kernel_names(name)
    ckpt = getattr(block, names["ckpt"])
    recompute = getattr(block, names["rec"])
    recompute_bwd = getattr(block, f"{name}_recompute_bwd")

    def plain(fn):
        return getattr(block, fn.__name__ + "_plain")

    cb, aux = ("rb", "n2s") if name == "psi" else ("xb", "trs")
    unroll = DEFAULT_UNROLL
    main = dict(precision=cfg.kernel_precision, defer_norm=cfg.defer_norm,
                unroll=unroll)
    shape = f"D={D}" + (f", rank {rank}" if name == "rho" else "")

    def inputs(B, seed):
        sig = damped_sine_batch(torch.Generator(dev).manual_seed(seed), B, T,
                                cfg.delta_t)
        ins = getattr(block, f"{name}_nll_inputs")(fam.params, cfg, sig)
        eps = dict(log_eps=ins.pop("log_eps"), norm_eps=ins.pop("norm_eps"))
        return sig, ins, {k: ins[k] for k in ("ab", "bb", cb)}, eps

    labels = {"ckpt": ("loss", "ck"), "rec": ("ys", aux),
              "adj": ("dse", "dt0", "dAb", "dBb",
                      "dRb" if name == "psi" else "dXb")}
    tols = {"ckpt": TOL_CKPT, "rec": TOL_RECOMPUTE, "adj": TOL_RECOMPUTE_BWD}

    # at the headline's batch and at the train CLI's: psi's recompute CTAs
    # take spans of blocks that depend on the batch (31 of a 128-block
    # prefix at B=128, all of it at B=1024), so the CLI's batch is held too
    for B in sorted({fam.B, cli_B}):
        sig, t_in, con, eps = inputs(B, fam.seed + (4 if B != fam.B else 0))
        pre = dict(t_in, se=t_in["se"][:T_PREFIX - 1].contiguous())
        g = torch.full((B,), 1.0 / B, device=dev)
        phase(f"{name} recompute kernels vs plain ({shape}, B={B}, "
              f"T={T_PREFIX} prefix, defer_norm={cfg.defer_norm})")
        err_at, ctrl, line = {}, {}, []
        for prec in ("highest", "high"):
            o = dict(main, precision=prec)
            f_p = plain(ckpt)(**pre, **eps, **o)
            rec = dict(con, ck=f_p[1], se=pre["se"])
            want = {"ckpt": f_p,
                    "rec": plain(recompute)(**rec, norm_eps=eps["norm_eps"],
                                            **o),
                    "adj": plain(recompute_bwd)(**rec, g=g, **eps, **o)}
            calls = {"ckpt": lambda **x: ckpt(**pre, **eps, **x),
                     "rec": lambda **x: recompute(
                         **rec, norm_eps=eps["norm_eps"], **x),
                     "adj": lambda **x: recompute_bwd(**rec, g=g, **eps, **x)}
            _hold_to_plain(name, prec, o, calls, want, labels, tols, err_at,
                           ctrl, line)
            del f_p, rec, want
            _free()
        print("  x max|plain| (tol " + ", ".join(
            f"{r} {t['highest']:g}/{t['high']:g}" for r, t in tols.items())
              + "): " + ", ".join(line), flush=True)
        print(f"  control, kernels at default vs plain at high (must exceed "
              f"the high limits): checkpoint forward {ctrl['ckpt']:.2e}, "
              f"recompute {ctrl['rec']:.2e}", flush=True)
        del sig, t_in, pre, con, g
        _free()

    sig, t_in, con, eps = inputs(fam.B, fam.seed)
    g = torch.full((fam.B,), 1.0 / fam.B, device=dev)
    phase(f"{name} recompute path vs the streamed path on the card ({shape}, "
          f"B={fam.B}, T={T})")
    stream_fwd = getattr(block, f"{name}_train_fwd")
    loss_s, ys, norms = stream_fwd(**t_in, **eps, **main)
    loss_c, ck = ckpt(**t_in, **eps, **main)
    r_ys, r_norms = recompute(**con, ck=ck, se=t_in["se"],
                              norm_eps=eps["norm_eps"], **main)
    torch.cuda.synchronize()
    check(torch.equal(loss_s, loss_c), f"{name}: the checkpoint forward's "
                                       f"loss is not the streamed forward's")
    check(torch.equal(r_ys, ys) and torch.equal(r_norms, norms),
          f"{name}: the recomputed states are not the streamed forward's")
    del ys, norms, r_ys, r_norms, loss_s, loss_c
    _free()
    runs = [recompute_bwd(**con, ck=ck, se=t_in["se"], g=g, **eps, **main)
            for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"{name}: two runs of the recompute adjoint differ")
    del runs, ck
    _free()
    trainable = getattr(block, f"{name}_nll_block_trainable")
    line = _off_vs_streamed(
        name, lambda q, c: trainable(q, c, sig,
                                     precision=cfg.kernel_precision,
                                     defer_norm=cfg.defer_norm),
        fam.params, getattr(weights, f"{name}_params_from_numpy"), cfg, dev)
    print(f"  the checkpoint forward's loss and the recomputed ys and {aux} "
          f"equal the streamed forward's bit for bit; two runs of the "
          f"recompute adjoint equal bit for bit; off vs streamed x "
          f"max|streamed| (tol {TOL_OFF[0]:g} / {TOL_OFF[1]:g}): "
          + ", ".join(line), flush=True)
    del sig, t_in, con, g
    _free()

    cfg_off = dataclasses.replace(cfg, minibatch_size=cli_B,
                                  kernel_stream="off")
    segments = block.recompute_segments(T - 1, unroll)
    n_seg = len(segments)
    cli_shape = f"{shape}, B={cli_B}, T={T}"
    phase(f"{name} training without the stream: train CLI ({cli_shape}, "
          f"kernel_stream=off), {OFF_STEPS} steps, then a restore and one "
          f"more step")
    per_step = {names["ckpt"]: 1, names["rec"]: n_seg,
                f"{name}_train_bwd": n_seg, f"{name}_cotangents": n_seg}
    if name == "psi":
        per_step[PSI_TAIL] = n_seg
    launches = train_cli_phase(dev, f"{name}_mps", cfg_off, T, OFF_STEPS,
                               per_step)

    phase(f"{name} recompute timings and the kernels vs plain over the run "
          f"({cli_shape}: CUDA events, median of 5 after 1 warm-up, plain "
          f"one run; one step's time and peak memory, off and streamed)")
    _, c_in, c_con, _ = inputs(cli_B, fam.seed + 2)
    g_c = torch.full((cli_B,), 1.0 / cli_B, device=dev)
    rec_o = dict(main, norm_eps=eps["norm_eps"])
    prec = main["precision"]
    ms = {"ckpt": median_ms(lambda: ckpt(**c_in, **eps, **main))}
    got = ckpt(**c_in, **eps, **main)
    ck = got[1]
    ms["rec"] = median_ms(lambda: _recompute_run(
        recompute, c_con, ck, c_in["se"], segments, **rec_o))
    adj_ms = median_ms(lambda: recompute_bwd(**c_con, ck=ck, se=c_in["se"],
                                             g=g_c, **eps, **main))
    # the kernels against their plain versions over the whole run at the
    # CLI's batch: the forward at the streamed forward's full-length limit
    # (its states drift from the plain loop's over the 16383 steps, as the
    # stream's do); the recompute, a segment at a time, and the whole
    # recompute adjoint, both sides from the kernel's checkpoints, at the
    # prefix's limits
    plain_ms, full = {}, {}
    plain_ms["ckpt"], want = timed(lambda: plain(ckpt)(**c_in, **eps, **main))
    full["ckpt"] = _hold_outputs(f"{name} ckpt {prec} T={T}", labels["ckpt"],
                                 got, want, TOL_TRAIN[prec]["fwd"])
    del got, want
    plain_ms["rec"], full["rec"] = 0.0, {}
    for args in _segment_inputs(c_con, ck, c_in["se"], segments, unroll):
        t, want = timed(lambda: plain(recompute)(**args, **rec_o))
        plain_ms["rec"] += t
        res = _hold_outputs(f"{name} rec {prec} T={T} segment",
                            labels["rec"], recompute(**args, **rec_o), want,
                            TOL_RECOMPUTE[prec])
        for k, v in res.items():
            full["rec"][k] = tuple(map(max, full["rec"].get(k, v), v))
        del want, args   # args holds a view of ck
    adj_plain_ms, want = timed(lambda: plain(recompute_bwd)(
        **c_con, ck=ck, se=c_in["se"], g=g_c, **eps, **main))
    full["adj"] = _hold_outputs(
        f"{name} adj {prec} T={T}", labels["adj"], recompute_bwd(
            **c_con, ck=ck, se=c_in["se"], g=g_c, **eps, **main), want,
        TOL_RECOMPUTE_BWD[prec])
    del want
    line = []
    for role in ("ckpt", "rec", "adj"):
        readings, worst = _readings(role, full[role])
        line += readings
        if role != "adj":
            err_at[role] = max(err_at[role], worst)
    print(f"  {prec}, x max|plain| over the run (tol ckpt "
          f"{TOL_TRAIN[prec]['fwd']:g}, rec {TOL_RECOMPUTE[prec]:g} (worst "
          f"segment), adj {TOL_RECOMPUTE_BWD[prec]:g}): " + ", ".join(line),
          flush=True)
    ck_elems = ck.numel()
    del c_in, c_con, ck
    _free()
    stream_fwd.launches = 0
    step_ms, peak = {}, {}
    for label, c in (("off", cfg_off),
                     ("streamed", dataclasses.replace(cfg_off,
                                                      kernel_stream="auto"))):
        step_ms[label], peak[label] = time_train_step(
            dev, f"{name}_mps", c, fam.params, T, fam.seed + 3, reps=2)
    check(stream_fwd.launches == 3, f"the streamed step timing launched "
                                    f"{name}_train_fwd {stream_fwd.launches} "
                                    f"times")
    s_bytes = block.stream_bytes(D, cli_B * rank, T)
    check(peak["off"] < s_bytes / 4, f"{name} off: peak memory {peak['off']} "
                                     f"not below a quarter of the stream's "
                                     f"{s_bytes} bytes")
    sizes = (n, (T - 1) * cli_B * rank, (T - 1) * cli_B, ck_elems,
             cli_B * rank)
    bounds = _recompute_bounds(name, *sizes, cli_B)
    adj_bound = _adjoint_bound(name, *sizes, cli_B)
    entries = []
    src = {"ckpt": f"{name}_train_fwd.cu", "rec": f"{name}_recompute.cu"}
    for role, kname in names.items():
        bound, by = bounds[role]
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{src[role]}",
            "replaces": fam.replaces[role], "launches": launches[kname],
            "max_abs_err": err_at[role], "ms": ms[role],
            "plain_ms": plain_ms[role], "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        print(f"  {kname}: {ms[role]:.3f} ms over the run"
              + (f" ({n_seg} segments, {ms[role] / n_seg:.3f} ms each)"
                 if role == "rec" else "")
              + f", {bound / ms[role] * 100:.1f}% of its bound {bound:.3f} "
              f"ms by {by}; launches in the CLI's {OFF_STEPS + 1} steps "
              f"{launches[kname]}; plain {plain_ms[role]:.1f} ms (one run)",
              flush=True)
    took = {f.__name__: f.cols_per_cta for f in (
        ckpt, recompute, getattr(block, f"{name}_train_bwd"))
        if hasattr(f, "cols_per_cta")}
    if took:
        print(f"  columns a CTA each launch took at B={cli_B}: {took}",
              flush=True)
    if name == "psi" and cli_B == PSI_OFF_B:
        now = dict(zip(PSI_ONE_COLUMN_MS, (ms["ckpt"], ms["rec"], adj_ms,
                                           step_ms["off"],
                                           step_ms["streamed"])))
        print("  one column a CTA (700 W) against this run: " + ", ".join(
            f"{k} {v:.2f} ms against {now[k]:.2f} ({v / now[k]:.2f}x)"
            for k, v in PSI_ONE_COLUMN_MS.items()), flush=True)
    print(f"  the whole recompute adjoint (recompute, adjoint and reductions "
          f"in {n_seg} segments) {adj_ms:.3f} ms, "
          f"{adj_bound[0] / adj_ms * 100:.1f}% of its bound "
          f"{adj_bound[0]:.3f} ms by {adj_bound[1]} (plain {adj_plain_ms:.1f}"
          f" ms, one run); one step (make_train_step, "
          f"batch draw included, host clock, mean of 2 after a warm-up): off "
          f"{step_ms['off']:.2f} ms, peak {peak['off'] / 1e9:.3f} GB; "
          f"streamed {step_ms['streamed']:.2f} ms, peak "
          f"{peak['streamed'] / 1e9:.3f} GB; the stream {s_bytes / 1e9:.3f} "
          f"GB, the checkpoints {4 * ck_elems / 1e9:.3f} GB; "
          f"{cli_B * (T - 1) / step_ms['off'] * 1e3:.4e} frames/s off, "
          f"{cli_B * (T - 1) / step_ms['streamed'] * 1e3:.4e} streamed",
          flush=True)
    return entries


# psi's block forward and adjoint at the saturated batch take several
# columns a CTA (ops/block.psi_columns_per_cta: 4 at B=1024 on 132 SMs);
# every G gives G=1's bits, held here on the T=2048 prefix at highest and
# high, both norms, for each psi block kernel
PSI_COLS_PRECISIONS = ("highest", "high")


def psi_columns_phases(dev, fam: Family, B: int):
    """psi's block kernels at batch ``B`` (the saturated batch of the
    recompute phases): each kernel at the rule's G held to a forced G=1 run
    bit for bit on the T=2048 prefix; then at the full T, CUDA-event times
    of scoring (the NLL kernel, and ``psi_nll_fused`` on the host clock),
    the streamed forward and the adjoint chain alone beside their bounds,
    with the G each launch took."""
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.ops import block
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL, psi_nll_fused

    cfg, T, n = fam.cfg, fam.T, 2 * D
    unroll = DEFAULT_UNROLL
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = block.psi_columns_per_cta(B, D, sms)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(fam.seed + 5),
                            B, T, cfg.delta_t)
    ins = block.psi_nll_inputs(fam.params, cfg, sig)
    eps = dict(log_eps=ins.pop("log_eps"), norm_eps=ins.pop("norm_eps"))
    g = torch.full((B,), 1.0 / B, device=dev)
    con = {k: ins[k] for k in ("ab", "bb", "rb")}

    phase(f"psi columns a CTA (D={D}, B={B}, T={T_PREFIX} prefix): the "
          f"rule's G={G} vs a forced G=1, every psi block kernel bit for bit")
    pre = dict(ins, se=ins["se"][:T_PREFIX - 1].contiguous())
    segment = block.recompute_segment_steps(T_PREFIX - 1, unroll)

    def run(cols, **o):
        c = dict(o, unroll=unroll, cols_per_cta=cols)
        nll = block.psi_nll_block(**pre, **eps, **c)
        loss, ys, n2s = block.psi_train_fwd(**pre, **eps, **c)
        loss_c, ck = block.psi_train_fwd_ckpt(**pre, **eps, **c)
        rec = block.psi_recompute(**con, ck=ck, se=pre["se"],
                                  norm_eps=eps["norm_eps"], **c)
        adj = block.psi_train_bwd(**pre, g=g, ys=ys, n2s=n2s, **eps, **c)
        whole = block.psi_recompute_bwd(**con, ck=ck, se=pre["se"], g=g,
                                        segment=segment, **eps, **c)
        torch.cuda.synchronize()
        check(torch.equal(nll, loss) and torch.equal(loss, loss_c),
              f"psi G={cols}: the NLL, streamed and checkpoint losses differ")
        check(torch.equal(rec[0], ys) and torch.equal(rec[1], n2s),
              f"psi G={cols}: the recomputed states are not the stream's")
        took = {f.__name__: f.cols_per_cta for f in (
            block.psi_nll_block, block.psi_train_fwd,
            block.psi_train_fwd_ckpt, block.psi_recompute,
            block.psi_train_bwd)}
        return (nll, ys, n2s, ck, *rec, *adj, *whole), took

    held = 0
    for prec in PSI_COLS_PRECISIONS:
        for defer in (False, True):
            want, _ = run(1, precision=prec, defer_norm=defer)
            got, took = run(None, precision=prec, defer_norm=defer)
            check(all(v == G for v in took.values()),
                  f"psi launches took {took}, not the rule's G={G}")
            for i, (a, b) in enumerate(zip(got, want)):
                check(bool(torch.isfinite(b).all()) and torch.equal(a, b),
                      f"psi {prec} defer={defer}: output {i} at G={G} is "
                      f"not G=1's")
                held += 1
            del got, want
            _free()
    print(f"  {held} outputs (NLL, streamed forward, checkpoint forward, "
          f"recompute, adjoint, whole recompute adjoint; highest and high, "
          f"both norms) at G={G} equal G=1's bit for bit; each G, the NLL, "
          f"streamed and checkpoint losses equal and the recomputed states "
          f"the stream's; G each launch took: {took}", flush=True)
    del pre
    _free()

    phase(f"psi at B={B} (D={D}, T={T}, highest, deferred norm): scoring, "
          f"the streamed forward and the adjoint chain alone at the rule's G "
          f"and at one column a CTA (CUDA events, median of 3 after 1 "
          f"warm-up; scoring through psi_nll_fused on the host clock, mean "
          f"of 3)")
    main = dict(precision=cfg.kernel_precision, defer_norm=cfg.defer_norm,
                unroll=unroll)
    ex_steps = (T - 1) * B
    mats = 3 * n * n
    ms, one, bounds, took = {}, {}, {}, {}
    ms["nll"] = median_ms(lambda: block.psi_nll_block(**ins, **eps, **main),
                          reps=3)
    took["psi_nll_block"] = block.psi_nll_block.cols_per_cta
    one["nll"] = median_ms(lambda: block.psi_nll_block(
        **ins, **eps, **main, cols_per_cta=1), reps=3)
    bounds["nll"] = bound_ms(3 * 2 * n * n * ex_steps,
                             4 * (ex_steps + mats + n * B + B))
    psi_nll_fused(fam.params, cfg, sig).item()
    t0 = time.perf_counter()
    for _ in range(3):
        psi_nll_fused(fam.params, cfg, sig).item()
    score_ms = (time.perf_counter() - t0) / 3 * 1e3
    ms["fwd"] = median_ms(lambda: block.psi_train_fwd(**ins, **eps, **main),
                          reps=3)
    took["psi_train_fwd"] = block.psi_train_fwd.cols_per_cta
    one["fwd"] = median_ms(lambda: block.psi_train_fwd(
        **ins, **eps, **main, cols_per_cta=1), reps=3)
    bounds["fwd"] = bound_ms(
        TRAIN_PRODUCTS["psi"]["fwd"] * 2 * n * n * ex_steps,
        4 * (ex_steps * n + 2 * ex_steps + mats + n * B + B))
    _, ys, n2s = block.psi_train_fwd(**ins, **eps, **main)
    ms["bwd"] = median_ms(lambda: block.psi_train_bwd(
        **ins, g=g, ys=ys, n2s=n2s, **eps, **main), reps=3)
    took["psi_train_bwd"] = block.psi_train_bwd.cols_per_cta
    one["bwd"] = median_ms(lambda: block.psi_train_bwd(
        **ins, g=g, ys=ys, n2s=n2s, **eps, **main, cols_per_cta=1), reps=3)
    bounds["bwd"] = bound_ms(
        TRAIN_PRODUCTS["psi"]["bwd"] * 2 * n * n * ex_steps,
        4 * (2 * ex_steps * n + 4 * ex_steps + mats + 2 * n * B + B))
    del ys, n2s
    _free()
    names = {"nll": "psi_nll_block (scoring)",
             "fwd": "psi_train_fwd (streamed forward)",
             "bwd": "psi_train_bwd (adjoint chain alone)"}
    for role, label in names.items():
        bound, by = bounds[role]
        print(f"  {label}: {ms[role]:.3f} ms, {bound / ms[role] * 100:.1f}% "
              f"of its bound {bound:.3f} ms by {by}; one column a CTA "
              f"{one[role]:.3f} ms ({one[role] / ms[role]:.2f}x)", flush=True)
    print(f"  scoring through psi_nll_fused: {score_ms:.2f} ms, "
          f"{ex_steps / score_ms * 1e3:.4e} frames/s (the kernel alone "
          f"{ex_steps / ms['nll'] * 1e3:.4e}); G each launch took: {took}",
          flush=True)
    del sig, ins, g, con
    _free()


def rho_phases(dev):
    """Phase 7, the rho family; returns its five kernels' entries of the
    {"kernels": [...]} line."""
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models import core
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import block
    from audio_mps_tpu_torch.ops.scan import rho_nll_fused
    from audio_mps_tpu_torch.sample import SampleConfig, sample
    from audio_mps_tpu_torch.weights import save_params

    cfg = CMPSConfig(bond_dim=D, minibatch_size=RHO_B)    # rank D
    params = init_rho(torch.Generator(dev).manual_seed(10), cfg, device=dev)
    rank = params.Wx.shape[0]
    n = 2 * D
    err_at, plain_ms, ctrl = {}, {}, {}

    phase(f"rho sampler kernel vs plain (D={D}, rank {rank}, "
          f"N={RHO_N_CHAINS}, T={T_SAMPLE})")
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(11),
                               RHO_N_CHAINS, T_SAMPLE, 1.0)
    s_in = block.rho_sample_inputs(params, cfg, noise)
    wave = block.rho_sample_block(**s_in)
    _free()
    check(bool(torch.isfinite(wave).all()), "rho sampler kernel: non-finite")
    plain_ms["rho_sample_block"], want = timed(
        lambda: block.rho_sample_block_plain(**s_in))
    k = RHO_T_SAMPLE_CHECK
    _, rel_pre = rel_err(wave[:k], want[:k])
    err, rel = rel_err(wave, want)
    err_at["rho_sample_block"] = err
    print(f"  highest: {rel_pre:.3e} x max|plain| over the first {k} steps "
          f"(tol {TOL['highest']:g}); max|d| {err:.3e} = {rel:.3e} x "
          f"max|plain| over all {T_SAMPLE} (tol {RHO_TOL_SAMPLE_FULL:g}); "
          f"plain {plain_ms['rho_sample_block']:.1f} ms (one run)",
          flush=True)
    check(rel_pre <= TOL["highest"], f"rho sampler highest, first {k} "
                                     f"steps: rel err {rel_pre:.3e}")
    check(rel <= RHO_TOL_SAMPLE_FULL, f"rho sampler highest: rel err "
                                      f"{rel:.3e}")
    pre = dict(s_in, noise=s_in["noise"][:T_PLAIN].contiguous())
    want = block.rho_sample_block_plain(**pre, precision="high")
    _, rel = rel_err(block.rho_sample_block(**pre, precision="high"), want)
    check(rel <= TOL["high"], f"rho sampler high: rel err {rel:.3e}")
    ctrl["rho_sample_block"] = _control(
        "rho sampler", lambda: block.rho_sample_block(**pre,
                                                      precision="default"),
        want, TOL["high"])
    print(f"  high over {T_PLAIN} steps: {rel:.3e} x max|plain| (tol "
          f"{TOL['high']:g}); control at default "
          f"{ctrl['rho_sample_block']:.3e} (must exceed it)", flush=True)
    del wave, want

    phase(f"rho NLL kernel vs plain (D={D}, rank {rank}, B={RHO_B}): the "
          f"scoring variant (highest, per-step norm) at T={RHO_T}, the other "
          f"three on a T={T_PREFIX} prefix")
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(12), RHO_B,
                                RHO_T, cfg.delta_t)
    n_in = block.rho_nll_inputs(params, cfg, signals)
    n_pre = dict(n_in, se=n_in["se"][:T_PREFIX - 1].contiguous())
    for prec in ("highest", "high"):
        for defer in (False, True):
            o = dict(precision=prec, defer_norm=defer)
            ins = n_in if (prec, defer) == ("highest", False) else n_pre
            got = block.rho_nll_block(**ins, **o)
            t_p, want = timed(lambda: block.rho_nll_block_plain(**ins, **o))
            check(bool(torch.isfinite(got).all()), "rho NLL: non-finite")
            err, rel = rel_err(got, want)
            line = (f"  {prec} defer_norm={defer}, T={ins['se'].shape[0] + 1}:"
                    f" max|d| {err:.3e} = {rel:.3e} x max|plain| (tol "
                    f"{TOL[prec]:g}); mean loss {got.mean().item():.6f}")
            check(rel <= TOL[prec], f"rho NLL {prec} defer={defer}: rel err "
                                    f"{rel:.3e}")
            if (prec, defer) == ("highest", False):
                err_at["rho_nll_block"] = err
                plain_ms["rho_nll_block"] = t_p
            if prec == "high" and not defer:
                ctrl["rho_nll_block"] = _control(
                    "rho NLL", lambda: block.rho_nll_block(
                        **ins, precision="default", defer_norm=defer),
                    want, TOL["high"])
                line += (f"; control at default "
                         f"{ctrl['rho_nll_block']:.3e}")
            print(line, flush=True)

    phase("rho serving path: sample CLI (mps_model=rho_mps, fused) + "
          "rho_nll_fused")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"cfg": dataclasses.asdict(cfg),
                       "run": {"mps_model": "rho_mps"}}, f)
        save_params(os.path.join(tmp, "params.npz"), params)
        out = os.path.join(tmp, "samples.npz")
        block.rho_sample_block.launches = 0
        block.rho_nll_block.launches = 0
        t0 = time.perf_counter()
        waves = sample(SampleConfig(modeldir=tmp, mps_model="rho_mps",
                                    num_samples=RHO_N_CHAINS,
                                    sample_duration=T_SAMPLE, fused=True,
                                    device=dev.type, out=out))
        t_sample = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = damped_sine_batch(torch.Generator(dev).manual_seed(13),
                                  RHO_B, RHO_T, cfg.delta_t)
        nll = rho_nll_fused(params, cfg, batch).item()
        t_score = time.perf_counter() - t0
        serve = {"rho_sample_block": block.rho_sample_block.launches,
                 "rho_nll_block": block.rho_nll_block.launches}
        sample_cluster = block.rho_sample_block.cluster
        check(os.path.exists(out), "sample CLI wrote no samples.npz")
    print(f"  sample CLI: {waves.shape} in {t_sample * 1e3:.1f} ms; NLL "
          f"{nll:.6f} in {t_score * 1e3:.1f} ms (host clock); launches "
          f"{serve}", flush=True)
    check(waves.shape == (RHO_N_CHAINS, T_SAMPLE), f"waves {waves.shape}")
    check(bool(torch.isfinite(torch.as_tensor(waves)).all()),
          "rho sampled waveforms are not finite")
    check(torch.isfinite(torch.tensor(nll)).item(), f"rho NLL {nll}")
    for name, count in serve.items():
        check(count > 0, f"{name} was not launched on the rho serving path")

    fam = Family(
        name="rho", params=params, cfg=cfg, B=RHO_B, T=RHO_T, seed=12,
        ref_cols=2, reference=core.rho_nll_factor, dehat_scale=1.0,
        replaces={"fwd": "audio_mps_tpu/ops/pallas_block.py:1366",
                  "bwd": "audio_mps_tpu/ops/pallas_block.py:1438",
                  "cot": "audio_mps_tpu/ops/pallas_block.py:1583",
                  "ckpt": "audio_mps_tpu/ops/pallas_block.py:1366",
                  "rec": "audio_mps_tpu/ops/pallas_block.py:1790"})
    train_entries = train_phases(dev, fam)
    _free()
    taken = _rho_clusters_taken()
    train_entries += recompute_phases(dev, fam, RHO_B)
    taken.update((k, v) for k, v in _rho_clusters_taken().items()
                 if k not in taken)
    taken["rho_sample_block"] = sample_cluster
    print(f"  the clusters the rho launches took (CTAs an example; the "
          f"recompute's an (example, block); the sample CLI's, a chain): "
          f"{taken}", flush=True)

    # device time by kernel of one rho training step's three launches (the
    # adjoint's call runs two kernels: the tail and the chain). The script
    # opens one torch.profiler session: a second one in the same process
    # recorded no device time on the H100.
    from torch.profiler import ProfilerActivity, profile
    t_in = dict(n_in)
    eps = dict(log_eps=t_in.pop("log_eps"), norm_eps=t_in.pop("norm_eps"))
    o = dict(precision=cfg.kernel_precision, defer_norm=cfg.defer_norm)
    g = torch.full((RHO_B,), 1.0 / RHO_B, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ys, trs = block.rho_train_fwd(**t_in, **eps, **o)
        b_p = block.rho_train_bwd(**t_in, g=g, ys=ys, trs=trs, **eps, **o)
        block.rho_cotangents(b_p[2], ys, t_in["t0"], t_in["se"], trs, b_p[3],
                             norm_eps=eps["norm_eps"], **o)
        torch.cuda.synchronize()
    del ys, trs, b_p
    _free()
    by_kernel = sorted(
        ((getattr(e, "device_time_total", 0.0), e.key.split("(")[0])
         for e in prof.key_averages()
         if getattr(e, "device_time_total", 0.0) > 0
         and not e.key.startswith("cuda")), reverse=True)
    print("  torch.profiler, device time of one rho train step's kernels: "
          + (", ".join(f"{k} {us / 1e3:.3f} ms" for us, k in by_kernel[:8])
             if by_kernel else "no device time recorded (not measured)"),
          flush=True)

    rho_cluster_phase(dev, n_in, cfg, taken)
    _free()

    phase("rho serving timings (CUDA events, median of 5 after 1 warm-up)")
    ms = {"rho_sample_block": median_ms(lambda: block.rho_sample_block(
              **s_in)),
          "rho_nll_block": median_ms(lambda: block.rho_nll_block(**n_in))}
    for prec in ("high", "default"):
        t_s = median_ms(lambda: block.rho_sample_block(**s_in,
                                                       precision=prec),
                        reps=1, warmup=0)
        t_n = median_ms(lambda: block.rho_nll_block(**n_in, precision=prec),
                        reps=1, warmup=0)
        print(f"  {prec}: rho_sample_block {t_s:.3f} ms, rho_nll_block "
              f"{t_n:.3f} ms (one run each)", flush=True)
    # FLOPs: the fewest [2D,2D] products a lane-step, 2 n^2 each, and the
    # per-example-step (per chain-step) matrix build (Ab + s Bb), 2 n^2: the
    # NLL 2 products ((Ab + s Bb) t, Xb y), the sampler 2 (Xs t for the
    # expectation on the current state, then the update). Bytes: each input
    # read once, each output written once.
    chain_steps = T_SAMPLE * RHO_N_CHAINS
    ex_steps = (RHO_T - 1) * RHO_B
    mats = 3 * n * n
    cost = {
        "rho_sample_block": (2 * 2 * n * n * chain_steps * rank
                             + 2 * n * n * chain_steps,
                             4 * (2 * chain_steps + mats
                                  + n * RHO_N_CHAINS * rank + 2 * D + 1)),
        "rho_nll_block": (2 * 2 * n * n * ex_steps * rank
                          + 2 * n * n * ex_steps,
                          4 * (ex_steps + mats + n * RHO_B * rank + RHO_B))}
    where = {"rho_sample_block": ("rho_sample.cu", "pallas_block.py:2278"),
             "rho_nll_block": ("rho_nll.cu", "pallas_block.py:2519")}
    entries = []
    for name, (src, rep) in where.items():
        bound, by = bound_ms(*cost[name])
        entries.append({
            "name": name, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{src}",
            "replaces": f"audio_mps_tpu/ops/{rep}", "launches": serve[name],
            "max_abs_err": err_at[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        print(f"  {name}: {ms[name]:.3f} ms, launches {serve[name]} (plain "
              f"{plain_ms[name]:.1f} ms, bound {bound:.3f} ms by {by}, "
              f"control at default {ctrl[name]:.2e})", flush=True)
    return entries + train_entries


RHO_CLUSTER_WRAPPERS = ("rho_nll_block", "rho_train_fwd", "rho_train_bwd",
                        "rho_train_fwd_ckpt", "rho_recompute")


def _rho_clusters_taken() -> dict:
    """The cluster of each rho block wrapper's last launch (None: none)."""
    from audio_mps_tpu_torch.ops import block
    return {k: getattr(block, k).cluster for k in RHO_CLUSTER_WRAPPERS
            if getattr(block, k).cluster is not None}


def rho_cluster_phase(dev, n_in, cfg, taken):
    """rho's block forward, adjoint and sampler over thread-block clusters
    at the headlines (D=64, rank 64; B=8, T=16384; 8 chains, T=65536;
    ``tools/rho_cluster_sweep.py``): the kernels' registers and spills,
    the card's residency at each cluster size and the rule's choice (which
    the training path's and the sample CLI's launches, ``taken``, must
    have followed), then the streamed forward, the adjoint (tail and
    chain), the NLL at both norms, the checkpoint forward and the segment
    recompute forced to each C, and the sampler forced to each C for 8
    chains and for one over the first 16384 steps, timed (CUDA events,
    median of 3) and held to C=1's outputs bit for bit (the tool's
    ``--sampler`` runs it over all 65536)."""
    from audio_mps_tpu_torch.tools import rho_cluster_sweep as sweep

    phase(f"rho clusters (D={D}, rank {D}, B={RHO_B}, T={RHO_T}; the "
          f"sampler {RHO_N_CHAINS} chains and 1, T={RHO_T_SAMPLE_CHECK}): "
          f"each C held to C=1 bit for bit and timed")
    # the highest-precision, deferred-norm kernels and the highest sampler
    # (the main path's); the tool prints every instantiation
    for line in _ptxas_lines(sweep.SOURCES):
        if ("<0,1" in line or "rho_sample_kernel<0," in line
                or "no ptxas" in line):
            print("  " + line, flush=True)
    if dev.type == "cuda":     # (a rehearsal on the CPU runs no kernel)
        # units: the training kernels' examples, the sampler's chains
        rules = sweep.residency(dev, D, RHO_B)
        rules["sample"] = sweep.residency(dev, D, RHO_N_CHAINS)["sample"]
        for kernel, (held, rule) in rules.items():
            name = {"fwd": "rho_train_fwd", "chain": "rho_train_bwd",
                    "recompute": "rho_recompute",
                    "sample": "rho_sample_block"}[kernel]
            print(f"  {kernel}: clusters of C the card holds {held}; the "
                  f"rule takes C={rule}, the main path took "
                  f"{taken.get(name)}", flush=True)
            check(taken.get(name) == rule, f"{name} took cluster "
                                           f"{taken.get(name)}, the rule {rule}")
    t_in = dict(n_in)
    eps = dict(log_eps=t_in.pop("log_eps"), norm_eps=t_in.pop("norm_eps"))
    ms = sweep.sweep(t_in, eps, cfg.kernel_precision, cfg.defer_norm,
                     log=lambda s: print(s, flush=True))
    if dev.type == "cuda":
        for chains in (RHO_N_CHAINS, 1):
            sweep.sample_sweep(dev, chains, log=lambda s: print(s, flush=True),
                               length=RHO_T_SAMPLE_CHECK)
            rule = sweep.residency(dev, D, chains)["sample"][1]
            print(f"  sampler, {chains} chain(s): the rule takes C={rule}",
                  flush=True)
    return ms


def _ptxas_lines(sources):
    """One line per kernel of `sources` from the build's ptxas report:
    its name and template arguments, registers and spill bytes."""
    from audio_mps_tpu_torch.ops import _build
    return _build.ptxas_report(BUILD["log"], sources)


def _combination_cotangents(f_out, c0, se, cfg, unroll):
    """The combination's cotangents of the partials forward's eh and tr (as
    the training path's backward hands them over) and a zero dtfin (the
    last time segment's)."""
    from audio_mps_tpu_torch.ops import rank
    eh, tr = (x.detach().clone().requires_grad_(True) for x in f_out[:2])
    with torch.enable_grad():
        loss = rank.combine_rank_partials(
            *rank.chunk_partials(eh, tr, c0, se.shape[1], unroll=unroll,
                                 norm_eps=float(cfg.norm_eps)), se, cfg)
        deh, dtr = torch.autograd.grad(loss, (eh, tr))
    return dict(deh=deh, dtr=dtr, dtfin=torch.zeros_like(f_out[2]))


def rank_phases(dev):
    """Phase 8, rank-chunked rho training at D=256, full rank; returns the
    partials kernels' entries of the {"kernels": [...]} line."""
    from audio_mps_tpu_torch import weights
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models.cell import make_constants
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import _build, block, rank
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL
    from audio_mps_tpu_torch.train import parse_args, train

    cfg = CMPSConfig(bond_dim=RANK_D, minibatch_size=RANK_B)    # rank D
    params = init_rho(torch.Generator(dev).manual_seed(20), cfg, device=dev)
    rank_ = params.Wx.shape[0]
    n = 2 * RANK_D
    cols = RANK_B * rank_
    limits = rank.device_limits(dev)
    rc = rank.rho_train_chunk(RANK_D, RANK_B, rank_, *limits)
    check(rc is not None, f"D={RANK_D} dispatched to the monolithic kernels")
    S = cols // rc
    G = rank_ // rc
    phase(f"rank-partials launches (D={RANK_D}, rank {rank_}, B={RANK_B}, "
          f"chunks of {rc} rows: {S} CTAs)")
    resident, clusters = {}, {"forward": 1, "adjoint (tail, chain)": 1}
    if dev.type == "cuda":      # (a rehearsal on the CPU runs no kernel)
        resident = {c: _build.library().amt_rank_partials_max_clusters(
            RANK_D, rc, c) for c in range(1, rank.MAX_CLUSTER + 1)}
        tail = rank.tail_split(S, RANK_T - 1)
        clusters = {"forward": rank.launch_cluster(RANK_D, rc, G, S, dev),
                    "adjoint (tail, chain)": min(
                        rank.launch_cluster(RANK_D, rc, G, S * g, dev)
                        for g in (1, tail))}
    print(f"  clusters of c CTAs the card holds at once: {resident}; the "
          f"rule (the largest c that divides an example's {G} chunks and "
          f"adds no wave) takes: " + ", ".join(
              f"{k} {v}" for k, v in clusters.items()), flush=True)
    for line in _ptxas_lines(("rank_partials_fwd.cu",
                              "rank_partials_recompute.cu",
                              "rank_partials_bwd.cu")):
        print("  " + line, flush=True)
    names = dict(zip(("fwd", "bwd", "cot"), RANK_KERNELS))
    kernels = {r: getattr(rank, k) for r, k in names.items()}
    plains = {r: getattr(rank, k + "_plain") for r, k in names.items()}
    labels = {"fwd": ("eh", "tr", "tfin", "ys"), "bwd": ("dse", "dt0", "dy"),
              "cot": ("dAb", "dBb", "dXb")}
    shape = f"D={RANK_D}, rank {rank_}, B={RANK_B}, chunks of {rc} rows"
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(21), RANK_B,
                                RANK_T, cfg.delta_t)
    kw = dict(rc=rc, unroll=DEFAULT_UNROLL, norm_eps=float(cfg.norm_eps))

    def inputs(steps):
        ins, c0 = rank.partials_inputs(params, cfg, signals[:, :steps + 1],
                                       rc)
        del ins["rc"], ins["norm_eps"]
        return ins, c0

    def cotangents(f_out, c0, se):
        return _combination_cotangents(f_out, c0, se, cfg, kw["unroll"])

    def call(role, ins, cot, f_out, b_out, plain=False, **o):
        fn = (plains if plain else kernels)[role]
        if role == "fwd":
            out = fn(**ins, **kw, **o)
        elif role == "bwd":
            out = fn(**ins, ys=f_out[3], tr=f_out[1], **cot, **kw, **o)
        else:
            out = fn(b_out[2], f_out[3], ins["t0"], ins["se"], f_out[1],
                     cot["deh"], **kw, **o)
        torch.cuda.synchronize()
        return out

    phase(f"rank-partials kernels vs plain ({shape}, T={RANK_T_PREFIX})")
    pre, c0 = inputs(RANK_T_PREFIX - 1)
    err_at, plain_ms, ctrl, prefix_ms = {}, {}, {}, {}
    for prec in ("highest", "high"):
        o = dict(precision=prec)
        outs, line, cot = {}, [], None
        for role in labels:
            f_p, b_p = outs.get("fwd"), outs.get("bwd")
            if role == "bwd":
                cot = cotangents(f_p, c0, pre["se"])
            t_p, want = timed(lambda: call(role, pre, cot, f_p, b_p,
                                           plain=True, **o))
            outs[role] = want
            got = call(role, pre, cot, f_p, b_p, **o)
            tol = TOL_TRAIN[prec][role]
            worst = 0.0
            for label, a, b in zip(labels[role], got, want):
                check(bool(torch.isfinite(a).all()),
                      f"{names[role]} {label}: non-finite")
                err, rel = rel_err(a, b)
                worst = max(worst, err)
                line.append(f"{label} {rel:.2e}")
                check(rel <= tol, f"{names[role]} {prec} {label}: rel err "
                                  f"{rel:.3e} (tol {tol:g})")
            del got
            if prec == "highest":
                err_at[role], plain_ms[role] = worst, t_p
                prefix_ms[role] = median_ms(
                    lambda: call(role, pre, cot, f_p, b_p, **o), reps=3)
            else:
                ctrl[role] = _control(names[role], lambda: call(
                    role, pre, cot, f_p, b_p, precision="default"), want,
                    TOL_TRAIN["high"][role])
        print(f"  {prec} (tol " + " / ".join(
            f"{v:g}" for v in TOL_TRAIN[prec].values())
            + "), x max|plain|: " + ", ".join(line), flush=True)
        del outs
        _free()
    print("  control, kernels at default vs plain at high, worst x "
          "max|plain| (must exceed the high limits): " + ", ".join(
              f"{names[r]} {v:.2e}" for r, v in ctrl.items()), flush=True)
    print(f"  at T={RANK_T_PREFIX}: plain (one run) fwd {plain_ms['fwd']:.1f}"
          f" / bwd {plain_ms['bwd']:.1f} / cotangents {plain_ms['cot']:.1f} "
          f"ms; kernels (median of 3) {prefix_ms['fwd']:.2f} / "
          f"{prefix_ms['bwd']:.2f} / {prefix_ms['cot']:.2f} ms", flush=True)
    del pre, cot
    _free()

    phase(f"chunked vs monolithic rho training (D={D}, rank {D}, "
          f"B={RHO_B}, T={RANK_T}, chunks of {RANK_CHECK_CHUNK})")
    cfg_m = CMPSConfig(bond_dim=D, minibatch_size=RHO_B)
    p_m = init_rho(torch.Generator(dev).manual_seed(23), cfg_m, device=dev)
    sig_m = damped_sine_batch(torch.Generator(dev).manual_seed(24), RHO_B,
                              RANK_T, cfg_m.delta_t)
    pm, pc = (weights.rho_params_from_numpy(weights.params_to_numpy(p_m),
                                            dev) for _ in range(2))
    counted = [block.rho_train_fwd, block.rho_train_bwd, block.rho_cotangents,
               *kernels.values()]
    before = [w.launches for w in counted]
    t_m, loss_m = timed(lambda: block.rho_nll_block_trainable(
        pm, cfg_m, sig_m, defer_norm=True))
    loss_m.backward()
    t_c, loss_c = timed(lambda: rank.rho_nll_rank_chunked(
        pc, cfg_m, sig_m, rank_chunk=RANK_CHECK_CHUNK))
    loss_c.backward()
    torch.cuda.synchronize()
    moved = [w.launches - b for w, b in zip(counted, before)]
    # the value's reference: the chunked function in float64 (its plain
    # forward on the card). The monolithic kernel sums its loss over the
    # T steps in one fp32 register, which drifts ~1e-4 from it at T=16385,
    # so the loss is held to the reference and the two paths' gradients to
    # each other.
    with torch.no_grad():
        q = pm.double()
        cc = make_constants(q, cfg_m)
        ab, bb, xb = block._rho_block_constants(cc)
        t0, c0 = rank._chunk_t0(q, cfg_m, cc, RHO_B, RANK_CHECK_CHUNK)
        s64 = sig_m.double()
        se = (s64[:, 1:] - s64[:, :-1]).T / cc.A
        eh, tr, _, _ = rank.rank_partials_fwd_plain(
            ab, bb, xb, t0, se, rc=RANK_CHECK_CHUNK, unroll=kw["unroll"],
            norm_eps=kw["norm_eps"])
        ref = rank.combine_rank_partials(*rank.chunk_partials(
            eh, tr, c0, RHO_B, unroll=kw["unroll"],
            norm_eps=kw["norm_eps"]), se, cfg_m).item()
        del q, ab, bb, xb, t0, eh, tr
    rel_c = abs(loss_c.item() - ref) / abs(ref)
    rel_m = abs(loss_m.item() - ref) / abs(ref)
    check(rel_c <= TOL_CHUNKED[0], f"chunked loss vs its float64 value: "
                                   f"{rel_c:.3e}")
    line = []
    for name in pm.NAMES:
        _, rel = rel_err(getattr(pc, name).grad, getattr(pm, name).grad)
        line.append(f"d{name} {rel:.2e}")
        check(rel <= TOL_CHUNKED[1], f"chunked vs monolithic gradient of "
                                     f"{name}: {rel:.3e}")
    check(all(m == 1 for m in moved), f"launches {moved}")
    print(f"  loss {loss_c.item():.7f} chunked, {loss_m.item():.7f} "
          f"monolithic, {ref:.7f} float64: chunked {rel_c:.2e} (tol "
          f"{TOL_CHUNKED[0]:g}), monolithic {rel_m:.2e} of it; gradients, "
          f"chunked vs monolithic x max|monolithic| (tol "
          f"{TOL_CHUNKED[1]:g}): " + ", ".join(line) + f"; forward "
          f"{t_m:.1f} ms monolithic, {t_c:.1f} ms chunked (one run)",
          flush=True)
    del pm, pc, p_m, sig_m, loss_m, loss_c
    _free()
    a4_whole_steps(dev)

    phase(f"rank-chunked training path: train CLI ({shape}, T={RANK_T}), "
          f"{RANK_TRAIN_STEPS} steps, then a restore and one more step")
    # the summaries' rho sampler is not ported past D=64: with them on, the
    # CLI refuses before its first step, launching nothing
    before = [w.launches for w in kernels.values()]
    with tempfile.TemporaryDirectory() as tmp:
        run, device = parse_args([
            "--mps_model=rho_mps", "--dataset=damped_sine",
            f"--sample_duration={RANK_T}",
            f"--hparams=bond_dim={RANK_D},minibatch_size={RANK_B}",
            f"--logdir={tmp}", f"--device={dev.type}", "--max_steps=1"])
        try:
            train(run, device=device)
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
    check("--visualize=false" in refused,
          f"the train CLI did not refuse the rho sampler: {refused!r}")
    check([w.launches for w in kernels.values()] == before,
          "the refused train CLI launched a kernel")
    print(f"  with visualize on, refused: {refused[:90]}...", flush=True)
    launches = train_cli_phase(dev, "rho_mps", cfg, RANK_T, RANK_TRAIN_STEPS,
                               dict.fromkeys(RANK_KERNELS),
                               flags=("--visualize=false",))
    step_ms, peak = time_train_step(dev, "rho_mps", cfg, params, RANK_T, 25,
                                    reps=1)
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    check(peak < total_mem, f"peak memory {peak} of {total_mem}")
    print(f"  rank-chunked train step (make_train_step, batch draw "
          f"included): {step_ms:.1f} ms host clock, one step after a "
          f"warm-up; {RANK_B * (RANK_T - 1) / step_ms * 1e3:.4e} frames/s; "
          f"peak memory {peak / 2 ** 30:.2f} GiB of "
          f"{total_mem / 2 ** 30:.2f}", flush=True)

    n_steps = RANK_T - 1
    full, c0 = inputs(n_steps)
    L = rank.segment_steps(RANK_D, cols, n_steps, DEFAULT_UNROLL, dev)
    L = n_steps if L is None else L
    phase(f"rank-partials timings ({shape}, T={RANK_T} in segments of {L} "
          f"steps; CUDA events)")
    seg = dict(full, se=full["se"][:L].contiguous())
    f_out = call("fwd", seg, None, None, None)
    cot = cotangents(f_out, c0, seg["se"])
    b_out = call("bwd", seg, cot, f_out, None)
    seg_ms = {r: median_ms(lambda: call(r, seg, cot, f_out, b_out), reps=3)
              for r in ("fwd", "bwd")}
    # the same launches unclustered: what the multicast of the rule's
    # cluster changes
    solo_ms = {r: median_ms(lambda: call(r, seg, cot, f_out, b_out,
                                         cluster=1), reps=3)
               for r in ("fwd", "bwd")}
    print(f"  one segment of {L} steps (median of 3), the rule's clusters "
          f"({clusters['forward']}, {clusters['adjoint (tail, chain)']}) / "
          f"clusters of 1: fwd {seg_ms['fwd']:.1f} / {solo_ms['fwd']:.1f}, "
          f"bwd {seg_ms['bwd']:.1f} / {solo_ms['bwd']:.1f} ms", flush=True)
    # the reductions on this segment at each precision (high and default on
    # the tensor cores), two launches of each equal bit for bit
    seg_cot = {}
    for prec in PRECISIONS:
        seg_cot[prec] = median_ms(lambda: call("cot", seg, cot, f_out, b_out,
                                               precision=prec), reps=3)
        runs = [call("cot", seg, cot, f_out, b_out, precision=prec)
                for _ in range(2)]
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"rank_cotangents at {prec}: two launches differ")
        del runs
    print(f"  rank_cotangents on one segment of {L} steps (median of 3; two "
          f"launches equal bit for bit at each precision): " + " / ".join(
              f"{p} {seg_cot[p]:.1f}" for p in PRECISIONS) + " ms",
          flush=True)
    seg_ms["cot"] = seg_cot["highest"]
    del f_out, b_out, seg
    _free()
    # the whole run once: the forward over the segments chained through
    # tfin, then each segment's adjoint and reductions after its forward
    # again (as the checkpointed backward runs them), and torch.matmul of
    # the reductions' three products on operands built per 512 steps
    ms = {r: 0.0 for r in labels}
    library_ms = 0.0
    t_in, starts = full["t0"], []
    for k0 in range(0, n_steps, L):
        ins = dict(full, t0=t_in, se=full["se"][k0:k0 + L].contiguous())
        starts.append(t_in)
        t_f, out = timed(lambda: call("fwd", ins, None, None, None))
        ms["fwd"] += t_f
        t_in = out[2]
        del out
    for i, k0 in enumerate(range(0, n_steps, L)):
        ins = dict(full, t0=starts[i], se=full["se"][k0:k0 + L].contiguous())
        f_out = call("fwd", ins, None, None, None)
        cot = cotangents(f_out, c0, ins["se"])
        t_b, b_out = timed(lambda: call("bwd", ins, cot, f_out, None))
        t_c, _ = timed(lambda: call("cot", ins, cot, f_out, b_out))
        ms["bwd"] += t_b
        ms["cot"] += t_c
        ys, tr, dy = f_out[3], f_out[1], b_out[2]
        del b_out
        scales = rank._exit_scales(tr, rc=rc, unroll=DEFAULT_UNROLL,
                                   norm_eps=kw["norm_eps"])
        for j0 in range(0, ys.shape[0], 512):
            j1 = min(j0 + 512, ys.shape[0])
            ts = torch.stack([block._rho_input_state(k, ins["t0"], ys, scales)
                              for k in range(j0, j1)])

            def lanes(x):
                return x.transpose(0, 1).reshape(n, -1)

            se_l = block._lanes(ins["se"][j0:j1], rank_)[:, None, :]
            deh_l = block._lanes(cot["deh"][j0:j1], rc)[:, None, :]
            ops = [(lanes(dy[j0:j1]), lanes(ts)),
                   (lanes(dy[j0:j1]), lanes(se_l * ts)),
                   (lanes(deh_l * ys[j0:j1]), lanes(ys[j0:j1]))]
            del ts
            t_l, _ = timed(lambda: [a @ b.T for a, b in ops])
            library_ms += t_l
            del ops
        del f_out, ys, tr, dy, scales
        _free()
    n_seg = len(starts)
    print(f"  per segment of {L} steps (median of 3): fwd {seg_ms['fwd']:.1f}"
          f", bwd {seg_ms['bwd']:.1f}, cotangents {seg_ms['cot']:.1f} ms; "
          f"the whole run ({n_seg} segments, one run): fwd {ms['fwd']:.1f}, "
          f"bwd {ms['bwd']:.1f}, cotangents {ms['cot']:.1f} ms; "
          f"torch.matmul of the reductions {library_ms:.1f} ms", flush=True)
    # bounds over the whole run: FLOPs as rho's (TRAIN_PRODUCTS,
    # TRAIN_BUILDS: the chunks of an example share its s); bytes of the
    # streams, the per-step rows and the constants, each once
    ex_steps = n_steps * RANK_B
    lane_steps = n_steps * cols
    seg_steps = n_steps * S
    mats = 3 * n * n
    nbytes = {"fwd": lane_steps * n + 2 * seg_steps + ex_steps + mats
              + 2 * n * cols,
              "bwd": (2 * lane_steps * n + 4 * seg_steps + ex_steps + mats
                      + 3 * n * cols),
              "cot": 2 * lane_steps * n + 2 * seg_steps + ex_steps + n * cols
              + mats}
    src = {"fwd": "rank_partials_fwd.cu", "bwd": "rank_partials_bwd.cu",
           "cot": "psi_cotangents.cu"}
    replaces = {"fwd": "audio_mps_tpu/ops/pallas_rank.py:80",
                "bwd": "audio_mps_tpu/ops/pallas_rank.py:259",
                "cot": "audio_mps_tpu/ops/pallas_rank.py:356"}
    entries = []
    for role, name in names.items():
        flops = (TRAIN_PRODUCTS["rho"][role] * 2 * n * n * lane_steps
                 + TRAIN_BUILDS["rho"][role] * n * n * ex_steps)
        bound, by = bound_ms(flops, 4 * nbytes[role])
        entries.append({
            "name": name, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{src[role]}",
            "replaces": replaces[role], "launches": launches[name],
            "max_abs_err": err_at[role], "ms": ms[role],
            "plain_ms": plain_ms[role], "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms if role == "cot" else None})
        if role == "cot":
            entries[-1]["segment_ms_by_precision"] = seg_cot
            print(f"  {name}: torch.matmul x3 {library_ms:.1f} ms; kernel / "
                  f"torch.matmul {ms[role] / library_ms:.3f}", flush=True)
        print(f"  {name}: {ms[role]:.1f} ms over T={RANK_T}, "
              f"{bound / ms[role] * 100:.1f}% of its bound {bound:.3f} ms by "
              f"{by}; launches in the train CLI's {RANK_TRAIN_STEPS + 1} "
              f"steps {launches[name]}; plain {plain_ms[role]:.1f} ms at "
              f"T={RANK_T_PREFIX}; control at default {ctrl[role]:.2e}",
              flush=True)
        if name in RANK_BEFORE_MS:
            print(f"  {name}: {ms[role]:.1f} ms against "
                  f"{RANK_BEFORE_MS[name]:.1f} ms before the ring "
                  f"({RANK_BEFORE_MS[name] / ms[role]:.2f}x); bound share "
                  f"{bound / ms[role] * 100:.1f}% against "
                  f"{bound / RANK_BEFORE_MS[name] * 100:.1f}%", flush=True)
    print(f"  rank-chunked train step {step_ms:.1f} ms, of which one pass of "
          f"the three kernels {sum(ms.values()):.1f} ms and the recomputed "
          f"forward {ms['fwd'] if n_seg > 1 else 0.0:.1f} ms", flush=True)
    return entries, (step_ms, peak)


def _whole_step_ms(dev, loss_of, params, cfg, reps=A4_REPS):
    """(host-clock ms of one whole Adam step on ``params``: the loss
    ``loss_of(params)`` with the regularisers, its backward and the update,
    as ``make_train_step`` takes it; the mean of ``reps`` after a warm-up
    step; peak device memory of the timed steps in bytes)."""
    from audio_mps_tpu_torch.models import core
    from audio_mps_tpu_torch.training import make_optimizer

    opt = make_optimizer(cfg, params)

    def step():
        opt.zero_grad(set_to_none=True)
        total, _ = core.regularized_loss(loss_of(params), params, cfg)
        total.backward()
        opt.step()
        return total.detach()

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        total = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    check(bool(torch.isfinite(total)), "non-finite loss in a whole step")
    del opt
    _free()
    return ms, torch.cuda.max_memory_allocated(dev)


def a4_whole_steps(dev):
    """ROADMAP A4 in whole Adam steps at D=64, rank 64, B=8, T=16385: the
    monolithic block pair (``rho_nll_block_trainable``, deferred norm, the
    streamed pair) against the rank-chunked path at chunks of 16 rows
    (``rank.rho_nll_rank_chunked``), each on its own copy of one seeded
    init; returns {path: (ms, peak bytes)}."""
    from audio_mps_tpu_torch import weights
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import block, rank

    phase(f"A4: whole Adam steps, monolithic vs rank-chunked (D={D}, rank "
          f"{D}, B={RHO_B}, T={RANK_T}, chunks of {RANK_CHECK_CHUNK}; host "
          f"clock, mean of {A4_REPS} after a warm-up)")
    cfg = CMPSConfig(bond_dim=D, minibatch_size=RHO_B)
    p0 = init_rho(torch.Generator(dev).manual_seed(23), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(24), RHO_B,
                            RANK_T, cfg.delta_t)
    losses = {
        "monolithic": lambda p: block.rho_nll_block_trainable(
            p, cfg, sig, defer_norm=True),
        "chunked": lambda p: rank.rho_nll_rank_chunked(
            p, cfg, sig, rank_chunk=RANK_CHECK_CHUNK)}
    out = {}
    for name, loss_of in losses.items():
        p = weights.rho_params_from_numpy(weights.params_to_numpy(p0), dev)
        out[name] = _whole_step_ms(dev, loss_of, p, cfg)
        del p
        _free()
    (m_ms, m_peak), (c_ms, c_peak) = out["monolithic"], out["chunked"]
    print(f"  whole step: monolithic {m_ms:.2f} ms (peak "
          f"{m_peak / 2 ** 30:.2f} GiB), chunked {c_ms:.2f} ms (peak "
          f"{c_peak / 2 ** 30:.2f} GiB); monolithic / chunked "
          f"{m_ms / c_ms:.3f}", flush=True)
    return out


def rank_recompute_phases(dev, streamed):
    """The rank-chunked training path without the state stream at D=256,
    full rank, B=8: the checkpoint forward, segment recompute and recompute
    adjoint vs their plain versions on the T=2049 prefix (with controls at
    ``default``), the recompute path vs the streamed path on that prefix,
    the train CLI with kernel_stream=off at T=16385, and over the whole run
    each kernel's CUDA-event time (one run) beside its bound and one step's
    time and peak memory beside the streamed path's (``streamed``: its
    (step ms, peak bytes) from ``rank_phases``). Returns the two kernels'
    entries of the {"kernels": [...]} line."""
    from audio_mps_tpu_torch import weights
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import block, rank
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL

    cfg = CMPSConfig(bond_dim=RANK_D, minibatch_size=RANK_B)    # rank D
    params = init_rho(torch.Generator(dev).manual_seed(20), cfg, device=dev)
    rank_ = params.Wx.shape[0]
    n = 2 * RANK_D
    cols = RANK_B * rank_
    rc = rank.rho_train_chunk(RANK_D, RANK_B, rank_, *rank.device_limits(dev))
    S = cols // rc
    unroll = DEFAULT_UNROLL
    kw = dict(rc=rc, unroll=unroll, norm_eps=float(cfg.norm_eps))
    shape = f"D={RANK_D}, rank {rank_}, B={RANK_B}, chunks of {rc} rows"
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(21), RANK_B,
                                RANK_T, cfg.delta_t)
    names = dict(zip(("ckpt", "rec"), RANK_RECOMPUTE_KERNELS))

    def inputs(steps):
        ins, c0 = rank.partials_inputs(params, cfg, signals[:, :steps + 1],
                                       rc)
        del ins["rc"], ins["norm_eps"]
        return ins, c0, {k: ins[k] for k in ("ab", "bb", "xb")}

    labels = {"ckpt": ("eh", "tr", "tfin", "ck"), "rec": ("ys",),
              "adj": ("dse", "dt0", "dAb", "dBb", "dXb")}
    tols = {"ckpt": TOL_CKPT, "rec": TOL_RECOMPUTE, "adj": TOL_RECOMPUTE_BWD}
    phase(f"rank-partials recompute kernels vs plain ({shape}, "
          f"T={RANK_T_PREFIX})")
    pre, c0, con = inputs(RANK_T_PREFIX - 1)
    err_at, ctrl, plain_ms, line = {}, {}, {}, []
    for prec in ("highest", "high"):
        o = dict(kw, precision=prec)
        t_f, f_p = timed(lambda: rank.rank_partials_fwd_ckpt_plain(**pre,
                                                                   **o))
        rec = dict(con, ck=f_p[3], se=pre["se"])
        t_r, r_p = timed(lambda: rank.rank_partials_recompute_plain(**rec,
                                                                    **o))
        cot = _combination_cotangents(f_p, c0, pre["se"], cfg, unroll)
        t_a, w_a = timed(lambda: rank.rank_recompute_bwd_plain(
            **rec, tr=f_p[1], **cot, **o))
        want = {"ckpt": f_p, "rec": (r_p,), "adj": w_a}
        calls = {
            "ckpt": lambda **x: rank.rank_partials_fwd_ckpt(**pre, **x),
            "rec": lambda **x: (rank.rank_partials_recompute(**rec, **x),),
            "adj": lambda **x: rank.rank_recompute_bwd(**rec, tr=f_p[1],
                                                       **cot, **x)}
        _hold_to_plain("rank", prec, o, calls, want, labels, tols, err_at,
                       ctrl, line)
        if prec == "highest":
            plain_ms.update(ckpt=t_f, rec=t_r, adj=t_a)
        del f_p, r_p, w_a, rec, want, cot
        _free()
    print("  x max|plain| (tol " + ", ".join(
        f"{r} {t['highest']:g}/{t['high']:g}" for r, t in tols.items())
          + "): " + ", ".join(line), flush=True)
    print(f"  control, kernels at default vs plain at high (must exceed the "
          f"high limits): checkpoint forward {ctrl['ckpt']:.2e}, recompute "
          f"{ctrl['rec']:.2e}; plain at T={RANK_T_PREFIX} (one run): "
          f"checkpoint forward {plain_ms['ckpt']:.1f} ms, recompute "
          f"{plain_ms['rec']:.1f} ms, the whole recompute adjoint "
          f"{plain_ms['adj']:.1f} ms", flush=True)

    phase(f"rank-chunked recompute path vs the streamed path on the card "
          f"({shape}, T={RANK_T_PREFIX})")
    o = dict(kw, precision=cfg.kernel_precision)
    f_s = rank.rank_partials_fwd(**pre, **o)
    f_c = rank.rank_partials_fwd_ckpt(**pre, **o)
    r_ys = rank.rank_partials_recompute(**con, ck=f_c[3], se=pre["se"], **o)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(f_s[:3], f_c[:3])),
          "rank: the checkpoint forward's partials are not the streamed "
          "forward's")
    check(torch.equal(r_ys, f_s[3]), "rank: the recomputed states are not "
                                     "the streamed forward's")
    cot = _combination_cotangents(f_s, c0, pre["se"], cfg, unroll)
    del f_s, r_ys
    _free()
    runs = [rank.rank_recompute_bwd(**con, ck=f_c[3], se=pre["se"],
                                    tr=f_c[1], **cot, **o) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "rank: two runs of the recompute adjoint differ")
    del runs, f_c, cot, pre, con
    _free()
    line = _off_vs_streamed(
        "rank", lambda q, c: rank.rho_nll_rank_chunked(
            q, c, signals[:, :RANK_T_PREFIX], rank_chunk=rc,
            precision=cfg.kernel_precision),
        params, weights.rho_params_from_numpy, cfg, dev)
    print(f"  the checkpoint forward's partials and the recomputed ys equal "
          f"the streamed forward's bit for bit; two runs of the recompute "
          f"adjoint equal bit for bit; off vs streamed x max|streamed| (tol "
          f"{TOL_OFF[0]:g} / {TOL_OFF[1]:g}): " + ", ".join(line), flush=True)
    _free()

    cfg_off = dataclasses.replace(cfg, kernel_stream="off")
    segments = block.recompute_segments(RANK_T - 1, unroll)
    n_seg = len(segments)
    phase(f"rank-chunked training without the stream: train CLI ({shape}, "
          f"T={RANK_T}, kernel_stream=off), {RANK_OFF_STEPS} step, then a "
          f"restore and one more")
    launches = train_cli_phase(
        dev, "rho_mps", cfg_off, RANK_T, RANK_OFF_STEPS,
        {names["ckpt"]: 1, names["rec"]: n_seg, "rank_partials_bwd": n_seg,
         "rank_cotangents": n_seg}, flags=("--visualize=false",))

    phase(f"rank-partials recompute timings ({shape}, T={RANK_T}, "
          f"{n_seg} segments; CUDA events, one run each) and one step's time "
          f"and peak memory")
    full, c0, f_con = inputs(RANK_T - 1)
    o = dict(kw, precision=cfg.kernel_precision)
    ms = {}
    ms["ckpt"], f_out = timed(lambda: rank.rank_partials_fwd_ckpt(**full,
                                                                  **o))
    ms["rec"], _ = timed(lambda: _recompute_run(
        rank.rank_partials_recompute, f_con, f_out[3], full["se"], segments,
        **o))
    cot = _combination_cotangents(f_out, c0, full["se"], cfg, unroll)
    adj_ms, _ = timed(lambda: rank.rank_recompute_bwd(
        **f_con, ck=f_out[3], se=full["se"], tr=f_out[1], **cot, **o))
    ck_elems = f_out[3].numel()
    del full, f_con, f_out, cot
    _free()
    step_ms, peak = time_train_step(dev, "rho_mps", cfg_off, params, RANK_T,
                                    26, reps=1)
    s_bytes = block.stream_bytes(RANK_D, cols, RANK_T)
    check(peak < s_bytes / 4, f"rank off: peak memory {peak} not below a "
                              f"quarter of the stream's {s_bytes} bytes")
    n_steps = RANK_T - 1
    sizes = (n, n_steps * cols, n_steps * RANK_B, ck_elems, cols)
    bounds = _recompute_bounds("rho", *sizes, 2 * n_steps * S + n * cols)
    adj_bound = _adjoint_bound("rho", *sizes, RANK_B)
    replaces = {"ckpt": "audio_mps_tpu/ops/pallas_rank.py:80",
                "rec": "audio_mps_tpu/ops/pallas_rank.py:152"}
    src = {"ckpt": "rank_partials_fwd.cu", "rec": "rank_partials_recompute.cu"}
    entries = []
    for role, kname in names.items():
        bound, by = bounds[role]
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{src[role]}",
            "replaces": replaces[role], "launches": launches[kname],
            "max_abs_err": err_at[role], "ms": ms[role],
            "plain_ms": plain_ms[role], "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        print(f"  {kname}: {ms[role]:.1f} ms over T={RANK_T}, "
              f"{bound / ms[role] * 100:.1f}% of its bound {bound:.3f} ms by "
              f"{by}; launches in the CLI's {RANK_OFF_STEPS + 1} steps "
              f"{launches[kname]}; plain {plain_ms[role]:.1f} ms at "
              f"T={RANK_T_PREFIX}; {RANK_BEFORE_MS[kname]:.1f} ms before the "
              f"ring ({RANK_BEFORE_MS[kname] / ms[role]:.2f}x)", flush=True)
    print(f"  the whole recompute adjoint ({n_seg} segments) {adj_ms:.1f} ms,"
          f" {adj_bound[0] / adj_ms * 100:.1f}% of its bound "
          f"{adj_bound[0]:.3f} ms by {adj_bound[1]} (plain "
          f"{plain_ms['adj']:.1f} ms at T={RANK_T_PREFIX}; "
          f"{RANK_BEFORE_MS['recompute_adjoint']:.1f} ms before the ring); "
          f"one step (make_train_step, batch draw included, host clock, one "
          f"after a warm-up): off {step_ms:.1f} ms, peak "
          f"{peak / 2 ** 30:.2f} GiB; streamed (checkpointed segments) "
          f"{streamed[0]:.1f} ms, peak {streamed[1] / 2 ** 30:.2f} GiB; the "
          f"stream {s_bytes / 1e9:.1f} GB, the checkpoints "
          f"{4 * ck_elems / 1e9:.2f} GB; "
          f"{RANK_B * n_steps / step_ms * 1e3:.4e} frames/s off", flush=True)
    return entries


# The split layout (ops/split.py; PERF.md kernel table rows 8, 10 and 12):
# psi at the legacy estimator's published shape (the reference's
# training_estimators.py:16-31, SURVEY.md:305; audio_mps_tpu/estimator.py
# :35-49): bond_d=10, batch_size=32, dt=1e-3, sample_duration=2**16, psi
# (discr=False). D=10 is no multiple of 4, so every path of it takes the
# split kernels.
SPLIT_D = 10
SPLIT_B = 32
SPLIT_DT = 1e-3
SPLIT_T = 65536
SPLIT_N_CHAINS = 8
# prefixes the plain versions run on (their step loops launch ~35 small ops
# a step); the kernels are held to them at TOL["highest"] and TOL_TRAIN
SPLIT_T_SAMPLE_CHECK = 4096   # the sampler's prefix (its full run: 1e-3)
SPLIT_T_NLL = 4096            # the NLL, both norms
SPLIT_T_TRAIN = {True: 4096, False: 2048}    # the training pair, by defer
SPLIT_T_REF = 512             # autograd through the eager reference
SPLIT_T_D8 = 1024             # D=8 asked for with kernel_layout="split"
SPLIT_CLI_STEPS = (4, 2)      # the estimator CLI's two calls
SPLIT_NAMES = ("cr", "ci", "rr", "ri", "pc", "ps", "s0r", "s0i", "se")
# FLOPs: the complex [D,D] x [D] products (4 real ones, 8 D^2 FLOPs) an
# example-step (chain-step) the function needs: the sampler 2 (R psi,
# C psi), the NLL and the training forward 3 (and R y), the adjoint 8 (its
# re-run of the forward from the checkpoints, 3; R^T dru, C^T dy and R^T dy,
# 3; the outer products dy x^T and dru y^T, 2) and 4 D^2 more (s dy x^T
# added into dR)
SPLIT_PRODUCTS = {"sample": 2, "nll": 3, "fwd": 3, "bwd": 8}
SPLIT_KERNELS = {
    "sample": ("psi_sample_split", "psi_split_sample.cu",
               "audio_mps_tpu/ops/pallas_scan.py:485"),
    "nll": ("psi_nll_split", "psi_split_nll.cu",
            "audio_mps_tpu/ops/pallas_scan.py:113"),
    "fwd": ("psi_split_fwd", "psi_split_fwd.cu",
            "audio_mps_tpu/ops/pallas_grad.py:107"),
    "bwd": ("psi_split_bwd", "psi_split_bwd.cu",
            "audio_mps_tpu/ops/pallas_grad.py:320")}
SPLIT_FWD_LABELS = ("loss", "ckr", "cki")
SPLIT_BWD_LABELS = ("dse", "dcr", "dci", "drr", "dri", "dpc", "dps", "dp0r",
                    "dp0i")
# which TOL_TRAIN limit each adjoint output takes: the per-step and
# initial-state cotangents the adjoint's, the [D,D] / [D] parameter
# cotangents the reductions'
SPLIT_BWD_ROLE = {k: "bwd" if k in ("dse", "dp0r", "dp0i") else "cot"
                  for k in SPLIT_BWD_LABELS}


def _split_args(inputs, steps=None, names=SPLIT_NAMES):
    """The tensor inputs of a split NLL / training forward in order, ``se``
    last (cut to ``steps`` - 1 rows), and their eps options."""
    args = [inputs[k] for k in names]
    if steps is not None:
        args[-1] = args[-1][:steps - 1].contiguous()
    return args, dict(log_eps=inputs["log_eps"],
                      norm_eps=inputs["norm_eps"])


def _split_bwd(fn, args, g, ck, **o):
    """A split adjoint on the constants of ``_split_args`` (all but the
    initial state and ``se``), ``se``, g and the checkpoints."""
    return fn(*args[:-3], args[-1], g, ck[0], ck[1], **o)


def _split_hold(tag, labels, tols, got, want):
    """Each output finite and within its limit of max|plain|; returns
    (readings, worst absolute error)."""
    line, worst = [], 0.0
    for label, a, b in zip(labels, got, want):
        check(bool(torch.isfinite(a).all()), f"{tag} {label}: non-finite")
        err, rel = rel_err(a, b)
        tol = tols[label]
        check(rel <= tol, f"{tag} {label}: rel err {rel:.3e} (tol {tol:g})")
        line.append(f"{label} {rel:.2e}")
        worst = max(worst, err)
    return line, worst


def _split_miss(tag, labels, tols, got, want):
    """The control: for each limit, the worst of the outputs it holds must
    exceed it. Returns the readings."""
    by_tol = {}
    for label, a, b in zip(labels, got, want):
        tol = tols[label]
        by_tol[tol] = max(by_tol.get(tol, 0.0), rel_err(a, b)[1])
    for tol, worst in by_tol.items():
        check(worst > tol, f"control: {tag} at default is within {tol:g} of "
                           f"plain at highest ({worst:.3e})")
    return [f"{worst:.2e} (limit {tol:g})" for tol, worst in by_tol.items()]


def _split_attribution(family, dev):
    """The re-run, the sweep and the outer products of a split adjoint
    alone (``tools/split_adjoint_attribution.py``, its builds started in
    set-up) and each form (and placement) built, at the estimator's
    shape; prints one line."""
    from audio_mps_tpu_torch.tools import split_adjoint_attribution as attr
    if SPLIT_ATTRIBUTION["libs"] is None:
        SPLIT_ATTRIBUTION["libs"] = attr.load_builds(
            SPLIT_ATTRIBUTION["builds"])
    measure = attr.measure_psi if family == "psi" else attr.measure_rho
    res = measure(dev, SPLIT_ATTRIBUTION["libs"], SPLIT_T)
    print("  attribution: " + attr.summary(f"{family}_split_bwd", res,
                                           SPLIT_T), flush=True)
    return res


def _split_forward_sweep(dev, family, D, rank=None):
    """The split NLL and training forward at both norms, and rho's two
    layouts where D <= 32 (``tools/split_forward_sweep.py``) at B=32,
    T=65536: prints a line each and checks that each NLL's loss is the
    training forward's bit for bit."""
    from audio_mps_tpu_torch.tools import split_forward_sweep as sweep
    for entry in sweep.measure(dev, family, D, rank, SPLIT_T):
        print("  " + sweep.line(entry), flush=True)
        check(entry["nll_is_fwd"], f"{entry['kernel']} D={D}: the NLL's "
                                   f"loss is not the training forward's "
                                   f"bit for bit")


def split_phases(dev):
    """Phase 10, psi's split layout at the legacy estimator's shape;
    returns its four kernels' entries of the {"kernels": [...]} line."""
    from audio_mps_tpu_torch import estimator
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models import core
    from audio_mps_tpu_torch.models.params import init_psi
    from audio_mps_tpu_torch.ops import block, grad, scan, split
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL
    from audio_mps_tpu_torch.sample import SampleConfig, sample
    from audio_mps_tpu_torch.weights import (load_params, params_to_numpy,
                                             psi_params_from_numpy,
                                             save_params)

    cfg = CMPSConfig(bond_dim=SPLIT_D, minibatch_size=SPLIT_B,
                     delta_t=SPLIT_DT)
    params = init_psi(torch.Generator(dev).manual_seed(20), cfg, device=dev)
    kernels = {r: getattr(split, k[0]) for r, k in SPLIT_KERNELS.items()}
    plains = {r: getattr(split, k[0] + "_plain")
              for r, k in SPLIT_KERNELS.items()}
    err_at, plain_ms, ctrl = {}, {}, {}
    fwd_tols = {k: TOL_TRAIN["highest"]["fwd"] for k in SPLIT_FWD_LABELS}
    bwd_tols = {k: TOL_TRAIN["highest"][SPLIT_BWD_ROLE[k]]
                for k in SPLIT_BWD_LABELS}

    phase(f"split sampler kernel vs plain (D={SPLIT_D}, N={SPLIT_N_CHAINS}, "
          f"T={SPLIT_T})")
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(21),
                               SPLIT_N_CHAINS, SPLIT_T, 1.0)
    s_in = split.psi_split_inputs(params, cfg, noise, noise=True)
    wave = kernels["sample"](**s_in)
    _free()
    check(bool(torch.isfinite(wave).all()), "split sampler: non-finite")
    plain_ms["sample"], want = timed(lambda: plains["sample"](**s_in))
    k = SPLIT_T_SAMPLE_CHECK
    _, rel_pre = rel_err(wave[:k], want[:k])
    err, rel = rel_err(wave, want)
    err_at["sample"] = err
    check(rel_pre <= TOL["highest"], f"split sampler, first {k} steps: rel "
                                     f"err {rel_pre:.3e}")
    check(rel <= RHO_TOL_SAMPLE_FULL, f"split sampler: rel err {rel:.3e}")
    pre = dict(s_in, noise=s_in["noise"][:k].contiguous())
    ctrl["sample"] = _split_miss(
        "split sampler", ("wave",), {"wave": TOL["highest"]},
        (kernels["sample"](**pre, precision="default"),), (want[:k],))
    print(f"  highest: {rel_pre:.3e} x max|plain| over the first {k} steps "
          f"(tol {TOL['highest']:g}); max|d| {err:.3e} = {rel:.3e} x "
          f"max|plain| over all {SPLIT_T} (tol {RHO_TOL_SAMPLE_FULL:g}); "
          f"plain {plain_ms['sample']:.1f} ms (one run); control at default "
          f"on the prefix {ctrl['sample'][0]}", flush=True)
    del wave, want, pre

    phase(f"split NLL kernel vs plain (D={SPLIT_D}, B={SPLIT_B}): the kernel "
          f"at T={SPLIT_T}, held to plain on a T={SPLIT_T_NLL} prefix")
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(22), SPLIT_B,
                                SPLIT_T, SPLIT_DT)
    n_in = split.psi_split_inputs(params, cfg, signals)
    full, eps = _split_args(n_in)
    short, _ = _split_args(n_in, SPLIT_T_NLL)
    nll_full = {}
    for defer in (False, True):
        o = dict(eps, defer_norm=defer)
        nll_full[defer] = kernels["nll"](*full, **o)
        check(bool(torch.isfinite(nll_full[defer]).all()),
              f"split NLL defer={defer} at T={SPLIT_T}: non-finite")
        got = kernels["nll"](*short, **o)
        t_p, want = timed(lambda: plains["nll"](*short, **o))
        err, rel = rel_err(got, want)
        check(rel <= TOL["highest"], f"split NLL defer={defer}: rel err "
                                     f"{rel:.3e}")
        c = _split_miss(f"split NLL defer={defer}", ("loss",),
                        {"loss": TOL["highest"]},
                        (kernels["nll"](*short, **o, precision="default"),),
                        (want,))
        if not defer:
            err_at["nll"], plain_ms["nll"], ctrl["nll"] = err, t_p, c
        print(f"  highest defer_norm={defer}: max|d| {err:.3e} = {rel:.3e} x "
              f"max|plain| (tol {TOL['highest']:g}), plain {t_p:.1f} ms; "
              f"control at default {c[0]}; mean loss at T={SPLIT_T} "
              f"{nll_full[defer].mean().item():.6f}", flush=True)

    phase(f"split training pair vs plain (D={SPLIT_D}, B={SPLIT_B}): "
          f"defer_norm=True on a T={SPLIT_T_TRAIN[True]} prefix, False on "
          f"T={SPLIT_T_TRAIN[False]}; the adjoint fed the plain forward's "
          f"checkpoints")
    g = torch.full((SPLIT_B,), 1.0 / SPLIT_B, device=dev)
    for defer in (True, False):
        args, _ = _split_args(n_in, SPLIT_T_TRAIN[defer])
        o = dict(eps, defer_norm=defer)
        t_f, f_p = timed(lambda: plains["fwd"](*args, **o))
        t_b, b_p = timed(lambda: _split_bwd(plains["bwd"], args, g, f_p[1:],
                                            **o))
        line, e_f = _split_hold(f"psi_split_fwd defer={defer}",
                                   SPLIT_FWD_LABELS, fwd_tols,
                                   kernels["fwd"](*args, **o), f_p)
        b_k = _split_bwd(kernels["bwd"], args, g, f_p[1:], **o)
        torch.cuda.synchronize()
        form = split.psi_split_bwd.form
        lb, e_b = _split_hold(f"psi_split_bwd defer={defer}",
                                 SPLIT_BWD_LABELS, bwd_tols, b_k, b_p)
        for other in split.SPLIT_BWD_FORMS:
            b_f = _split_bwd(kernels["bwd"], args, g, f_p[1:], **o,
                             _form=other)
            check(all(torch.equal(a, b) for a, b in zip(b_f, b_k)),
                  f"psi_split_bwd defer={defer}: the {other} form is not "
                  f"the {form} form's bits")
        lb.append(f"the forms {'/'.join(split.SPLIT_BWD_FORMS)} the same "
                  f"bits (the plan: {form})")
        d = dict(o, precision="default")
        c_f = _split_miss(f"psi_split_fwd defer={defer}", SPLIT_FWD_LABELS,
                          fwd_tols, kernels["fwd"](*args, **d), f_p)
        c_b = _split_miss(f"psi_split_bwd defer={defer}", SPLIT_BWD_LABELS,
                          bwd_tols, _split_bwd(kernels["bwd"], args, g,
                                               f_p[1:], **d), b_p)
        if defer:
            err_at.update(fwd=e_f, bwd=e_b)
            plain_ms.update(fwd=t_f, bwd=t_b)
            ctrl.update(fwd=c_f, bwd=c_b)
        print(f"  defer_norm={defer}, T={SPLIT_T_TRAIN[defer]} (tol fwd "
              f"{TOL_TRAIN['highest']['fwd']:g}, adjoint "
              f"{TOL_TRAIN['highest']['bwd']:g}, parameter cotangents "
              f"{TOL_TRAIN['highest']['cot']:g}), x max|plain|: "
              + ", ".join(line + lb) + f"; plain fwd {t_f:.1f} ms, bwd "
              f"{t_b:.1f} ms; control at default: fwd " + ", ".join(c_f)
              + "; bwd " + ", ".join(c_b), flush=True)
        del f_p, b_p, b_k
        _free()

    phase(f"split kernels at D=8 with kernel_layout=split (B={SPLIT_B}, "
          f"T={SPLIT_T_D8}, highest, defer_norm=True)")
    cfg8 = dataclasses.replace(cfg, bond_dim=8, kernel_layout="split")
    p8 = init_psi(torch.Generator(dev).manual_seed(23), cfg8, device=dev)
    noise8 = noise[:SPLIT_T_D8].contiguous()
    sig8 = signals[:, :SPLIT_T_D8].contiguous()
    s8 = split.psi_split_inputs(p8, cfg8, noise8, noise=True)
    args8, eps8 = _split_args(split.psi_split_inputs(p8, cfg8, sig8))
    o8 = dict(eps8, defer_norm=True)
    f8 = plains["fwd"](*args8, **o8)
    line8 = []
    for tag, labels, tols, got, want in (
            ("psi_sample_split", ("wave",), {"wave": TOL["highest"]},
             (kernels["sample"](**s8),), (plains["sample"](**s8),)),
            ("psi_nll_split", ("loss",), {"loss": TOL["highest"]},
             (kernels["nll"](*args8, **o8),), (plains["nll"](*args8, **o8),)),
            ("psi_split_fwd", SPLIT_FWD_LABELS, fwd_tols,
             kernels["fwd"](*args8, **o8), f8),
            ("psi_split_bwd", SPLIT_BWD_LABELS, bwd_tols,
             _split_bwd(kernels["bwd"], args8, g, f8[1:], **o8),
             _split_bwd(plains["bwd"], args8, g, f8[1:], **o8))):
        readings, _ = _split_hold(f"D=8 split {tag}", labels, tols, got,
                                     want)
        line8.append(f"{tag}: " + ", ".join(readings))
    before = [w.launches for w in kernels.values()]
    with torch.no_grad():
        scan.psi_nll_fused(p8, cfg8, sig8)
    check([w.launches - b for w, b in zip(kernels.values(), before)]
          == [0, 1, 0, 0], "psi_nll_fused at D=8, kernel_layout=split, did "
                           "not launch the split NLL alone")
    print("  x max|plain|: " + "; ".join(line8) + "; psi_nll_fused took the "
          "split NLL", flush=True)
    del p8, s8, args8, f8
    _free()

    phase(f"split training path vs autograd through the eager reference "
          f"(D={SPLIT_D}, {SPLIT_B} examples, T={SPLIT_T_REF})")
    short_sig = signals[:, :SPLIT_T_REF].contiguous()
    pk = psi_params_from_numpy(params_to_numpy(params), dev)
    pr = psi_params_from_numpy(params_to_numpy(params), dev)
    loss_k = grad.psi_nll_fused_trainable(pk, cfg, short_sig,
                                          precision="highest",
                                          defer_norm=cfg.defer_norm)
    loss_k.backward()
    loss_r = core.psi_nll(pr, cfg, short_sig)
    loss_r.backward()
    _, rel = rel_err(loss_k.detach(), loss_r.detach())
    line = [f"loss {rel:.2e}"]
    check(rel <= TOL_TRAIN_REFERENCE[0], f"split train loss vs reference: "
                                         f"{rel:.3e}")
    for name in pk.NAMES:
        _, rel = rel_err(getattr(pk, name).grad, getattr(pr, name).grad)
        line.append(f"d{name} {rel:.2e}")
        check(rel <= TOL_TRAIN_REFERENCE[1], f"split gradient of {name} vs "
                                             f"reference: {rel:.3e}")
    print(f"  x max|reference| (tol {TOL_TRAIN_REFERENCE[0]:g} / "
          f"{TOL_TRAIN_REFERENCE[1]:g}): " + ", ".join(line), flush=True)
    del pk, pr, loss_k, loss_r

    first, second = SPLIT_CLI_STEPS
    phase(f"split training path: the estimator CLI at its defaults (psi, "
          f"D={SPLIT_D}, B={SPLIT_B}, T={SPLIT_T}, dt={SPLIT_DT}), "
          f"--max_steps={first} --viz_steps=2, then --max_steps={second} "
          f"resuming at step {first}")
    counted = dict(_training_wrappers(), **{
        k: getattr(block, k) for k in ("psi_sample_block", "psi_nll_block",
                                       "rho_sample_block", "rho_nll_block")},
        psi_sample_split=kernels["sample"], psi_nll_split=kernels["nll"])
    for w in counted.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        argv = [f"--model_dir={tmp}", "--viz_steps=2",
                f"--device={dev.type}"]
        t0 = time.perf_counter()
        est1 = estimator.main(argv + [f"--max_steps={first}"])
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        ckdir = os.path.join(tmp, "checkpoints")
        first_ckpts = sorted(os.listdir(ckdir))
        t0 = time.perf_counter()
        est2 = estimator.main(argv + [f"--max_steps={second}"])
        torch.cuda.synchronize()
        t_second = time.perf_counter() - t0
        cli = {k: w.launches for k, w in counted.items()}
        state = torch.load(os.path.join(ckdir, f"ckpt_{first + second}.pt"),
                           map_location="cpu", weights_only=True)
        last_ckpts = sorted(os.listdir(ckdir))
    moved = {k: v for k, v in cli.items() if v}
    print(f"  first call: {first} steps in {t_first * 1e3:.1f} ms, "
          f"checkpoints {first_ckpts}; second call: resumed at step "
          f"{est2.global_step - second}, {second} steps in "
          f"{t_second * 1e3:.1f} ms (host clock, set-up included), "
          f"checkpoints {last_ckpts}; launches {moved}", flush=True)
    check(est1.global_step == first and est2.global_step == first + second,
          f"global steps {est1.global_step}, {est2.global_step}")
    check(first_ckpts == [f"ckpt_{s}.pt" for s in range(2, first + 1, 2)],
          f"first call left {first_ckpts}")
    check(state["step"] == first + second, f"final step {state['step']}")
    check(all(float(s["step"]) == first + second
              for s in state["optimizer"]["state"].values()),
          "the Adam state was not restored")
    check(all(bool(torch.isfinite(x).all()) for x in est2.params.parameters()),
          "non-finite parameters")
    for name, count in cli.items():
        want_n = (first + second if name in ("psi_split_fwd", "psi_split_bwd")
                  else 0)
        check(count == want_n, f"{name} launched {count} times in "
                               f"{first + second} estimator steps ({want_n} "
                               f"expected)")
    ec = estimator.parse_args([f"--device={dev.type}"])
    with tempfile.TemporaryDirectory() as tmp:
        est = estimator.Estimator("psi_mps", est2.cfg, tmp, device=dev)
        input_fn = estimator.build_input_fn(ec, est2.cfg)
        est.train(input_fn, steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.train(input_fn, steps=3)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        del est
    print(f"  estimator train step: {step_ms:.2f} ms host clock (mean of 3 "
          f"after a warm-up step, its checkpoint save included); "
          f"{SPLIT_B * (SPLIT_T - 1) / step_ms * 1e3:.4e} frames/s",
          flush=True)

    phase(f"split serving path: sample CLI (fused, D={SPLIT_D}, "
          f"{SPLIT_N_CHAINS} x {SPLIT_T}) + psi_nll_fused (B={SPLIT_B}, "
          f"T={SPLIT_T})")
    for w in counted.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"cfg": dataclasses.asdict(cfg),
                       "run": {"mps_model": "psi_mps"}}, f)
        save_params(os.path.join(tmp, "params.npz"), params)
        out = os.path.join(tmp, "samples.npz")
        t0 = time.perf_counter()
        waves = sample(SampleConfig(modeldir=tmp, num_samples=SPLIT_N_CHAINS,
                                    sample_duration=SPLIT_T, fused=True,
                                    device=dev.type, out=out))
        t_sample = time.perf_counter() - t0
        t0 = time.perf_counter()
        scored = load_params(os.path.join(tmp, "params.npz"), dev)
        batch = damped_sine_batch(torch.Generator(dev).manual_seed(24),
                                  SPLIT_B, SPLIT_T, SPLIT_DT)
        nll = scan.psi_nll_fused(scored, cfg, batch).item()
        t_score = time.perf_counter() - t0
        serve = {k: w.launches for k, w in counted.items()}
        n_wav = sum(os.path.exists(os.path.join(tmp, f"samples_{i}.wav"))
                    for i in range(SPLIT_N_CHAINS))
    print(f"  sample CLI: {waves.shape} in {t_sample * 1e3:.1f} ms, {n_wav} "
          f"wav files; NLL {nll:.6f} in {t_score * 1e3:.1f} ms (host clock); "
          f"launches { {k: v for k, v in serve.items() if v} }", flush=True)
    check(waves.shape == (SPLIT_N_CHAINS, SPLIT_T), f"waves {waves.shape}")
    check(bool(torch.isfinite(torch.as_tensor(waves)).all()),
          "sampled waveforms are not finite")
    check(n_wav == SPLIT_N_CHAINS, f"{n_wav} wav files written")
    check(torch.isfinite(torch.tensor(nll)).item(), f"NLL {nll}")
    for name, count in serve.items():
        want_n = 1 if name in ("psi_sample_split", "psi_nll_split") else 0
        check(count == want_n, f"{name} launched {count} times on the split "
                               f"serving path ({want_n} expected)")

    phase("split timings (CUDA events, median of 5 after 1 warm-up)")
    o = dict(eps, defer_norm=cfg.defer_norm)
    loss_f, ckr, cki = kernels["fwd"](*full, **o)
    check(torch.equal(loss_f, nll_full[cfg.defer_norm]),
          "the training forward's loss is not the NLL's bit for bit")
    ms = {"sample": median_ms(lambda: kernels["sample"](**s_in)),
          "nll": median_ms(lambda: kernels["nll"](*full, **eps)),
          "fwd": median_ms(lambda: kernels["fwd"](*full, **o)),
          "bwd": median_ms(lambda: _split_bwd(kernels["bwd"], full, g,
                                              (ckr, cki), **o))}
    # the same kernels on the prefixes their plain versions ran on
    pre_ms = {}
    for role, steps, oo in (("nll", SPLIT_T_NLL, eps),
                            ("fwd", SPLIT_T_TRAIN[True], o)):
        args, _ = _split_args(n_in, steps)
        pre_ms[role] = median_ms(lambda: kernels[role](*args, **oo))
    args, _ = _split_args(n_in, SPLIT_T_TRAIN[True])
    ck_pre = kernels["fwd"](*args, **o)[1:]
    pre_ms["bwd"] = median_ms(lambda: _split_bwd(kernels["bwd"], args, g,
                                                 ck_pre, **o))
    del ck_pre
    check(torch.equal(kernels["fwd"](*full, **eps, defer_norm=False)[0],
                      nll_full[False]),
          "the training forward's loss at defer_norm=False is not the "
          "NLL's bit for bit")
    variants = {
        "psi_nll_split/defer=True": median_ms(
            lambda: kernels["nll"](*full, **o)),
        "psi_sample_split/default": median_ms(
            lambda: kernels["sample"](**s_in, precision="default")),
        "psi_split_fwd/defer=False": median_ms(
            lambda: kernels["fwd"](*full, **eps, defer_norm=False))}
    for name, t in variants.items():
        print(f"  {name}: {t:.3f} ms", flush=True)
    _split_forward_sweep(dev, "psi", 50)
    n_steps = SPLIT_T - 1
    ex_steps = n_steps * SPLIT_B
    chain_steps = SPLIT_T * SPLIT_N_CHAINS
    nb = -(-n_steps // DEFAULT_UNROLL)
    mats = 4 * SPLIT_D * SPLIT_D + 2 * SPLIT_D
    state = 2 * SPLIT_D * SPLIT_B
    ck = 2 * nb * SPLIT_D * SPLIT_B
    c = 8 * SPLIT_D * SPLIT_D
    cost = {"sample": (SPLIT_PRODUCTS["sample"] * c * chain_steps,
                       2 * chain_steps + mats + 2 * SPLIT_D * SPLIT_N_CHAINS
                       + 1),
            "nll": (SPLIT_PRODUCTS["nll"] * c * ex_steps,
                    ex_steps + mats + state + SPLIT_B),
            "fwd": (SPLIT_PRODUCTS["fwd"] * c * ex_steps,
                    ex_steps + mats + state + SPLIT_B + ck),
            "bwd": ((SPLIT_PRODUCTS["bwd"] * c + 4 * SPLIT_D * SPLIT_D)
                    * ex_steps,
                    2 * ex_steps + SPLIT_B + ck + 2 * mats + state)}
    launches = {"sample": serve["psi_sample_split"],
                "nll": serve["psi_nll_split"],
                "fwd": cli["psi_split_fwd"], "bwd": cli["psi_split_bwd"]}
    pre_t = {"sample": SPLIT_T, "nll": SPLIT_T_NLL,
             "fwd": SPLIT_T_TRAIN[True], "bwd": SPLIT_T_TRAIN[True]}
    entries = []
    for role, (name, src, rep) in SPLIT_KERNELS.items():
        flops, words = cost[role]
        bound, by = bound_ms(flops, 4 * words)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": launches[role], "max_abs_err": err_at[role],
            "ms": ms[role], "plain_ms": plain_ms[role], "bound_ms": bound,
            "bound_by": by, "library_ms": None})
        same = (f"the kernel {pre_ms[role]:.3f} ms on it" if role in pre_ms
                else "the kernel's own length")
        print(f"  {name}: {ms[role]:.3f} ms at T={SPLIT_T}, launches "
              f"{launches[role]} on its main path (plain {plain_ms[role]:.1f}"
              f" ms at T={pre_t[role]}, {same}; bound {bound:.3f} ms by "
              f"{by}, {bound / ms[role] * 100:.2f}% of it; control at default "
              + ", ".join(ctrl[role]) + ")", flush=True)
    print(f"  estimator step {step_ms:.2f} ms, of which the forward and "
          f"adjoint kernels {ms['fwd'] + ms['bwd']:.2f} ms; the adjoint's "
          f"launches took the {split.psi_split_bwd.form} form; "
          f"{card_line()}", flush=True)
    _split_attribution("psi", dev)
    return entries


# rho's split layout at the same published shape: the legacy estimator's
# --discr=true (training_estimators.py:16-31 of the reference;
# audio_mps_tpu/estimator.py:43, :178) trains the mixed-state model at
# D=10, B=32, dt=1e-3, T=65536, full purification rank 10 (320 factor
# lanes); its sample CLI and scoring take the split sampler and NLL.
# Prefixes for the plain versions as psi's (SPLIT_T_*).
RHO_SPLIT_RANK = SPLIT_D
# FLOPs: the complex [D,D] x [D] products (8 D^2 FLOPs) a lane-step, plus
# the complex [D,D] matrix work an example-step (4 D^2 FLOPs each): an
# example's rank lanes share one s, so conj(C) + s conj(R) is one product
# after one such build. The sampler 2 (X^T H, then the update) + 1 build;
# the NLL and the training forward 2 (the update, X^T y) + 1; the adjoint 6
# (its re-run's 2; X (dehat y) and the built matrix's transpose on dy, 2;
# the outer products dy x^T and (dehat y) y^T, 2) + 2 (the build, and
# s dy x^T added into d conj(R) from the first outer product).
RHO_SPLIT_PRODUCTS = {"sample": 2, "nll": 2, "fwd": 2, "bwd": 6}
RHO_SPLIT_BUILDS = {"sample": 1, "nll": 1, "fwd": 1, "bwd": 2}
RHO_SPLIT_KERNELS = {
    "sample": ("rho_sample_split", "rho_split_sample.cu",
               "audio_mps_tpu/ops/pallas_scan.py:657"),
    "nll": ("rho_nll_split", "rho_split_nll.cu",
            "audio_mps_tpu/ops/pallas_scan.py:289"),
    "fwd": ("rho_split_fwd", "rho_split_fwd.cu",
            "audio_mps_tpu/ops/pallas_grad.py:815"),
    "bwd": ("rho_split_bwd", "rho_split_bwd.cu",
            "audio_mps_tpu/ops/pallas_grad.py:1032")}
RHO_SPLIT_BWD_LABELS = ("dse", "dccr", "dcci", "drcr", "drci", "dxtr",
                        "dxti", "dpc", "dps", "dh0r", "dh0i")
RHO_SPLIT_BWD_ROLE = {k: "bwd" if k in ("dse", "dh0r", "dh0i") else "cot"
                      for k in RHO_SPLIT_BWD_LABELS}


def rho_split_phases(dev):
    """Phase 11, rho's split layout at the legacy estimator's --discr=true
    shape; returns its four kernels' entries of the {"kernels": [...]}
    line."""
    from audio_mps_tpu_torch import estimator
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models import core
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import block, grad, scan, split
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL
    from audio_mps_tpu_torch.sample import SampleConfig, sample
    from audio_mps_tpu_torch.weights import (load_params, params_to_numpy,
                                             rho_params_from_numpy,
                                             save_params)

    cfg = CMPSConfig(bond_dim=SPLIT_D, minibatch_size=SPLIT_B,
                     delta_t=SPLIT_DT)
    params = init_rho(torch.Generator(dev).manual_seed(30), cfg, device=dev)
    check(params.Wx.shape[0] == RHO_SPLIT_RANK, f"rank {params.Wx.shape}")
    kernels = {r: getattr(split, k[0]) for r, k in RHO_SPLIT_KERNELS.items()}
    plains = {r: getattr(split, k[0] + "_plain")
              for r, k in RHO_SPLIT_KERNELS.items()}
    err_at, plain_ms, ctrl = {}, {}, {}
    fwd_tols = {k: TOL_TRAIN["highest"]["fwd"] for k in SPLIT_FWD_LABELS}
    bwd_tols = {k: TOL_TRAIN["highest"][RHO_SPLIT_BWD_ROLE[k]]
                for k in RHO_SPLIT_BWD_LABELS}
    shape = f"D={SPLIT_D}, rank {RHO_SPLIT_RANK}"

    phase(f"rho split sampler kernel vs plain ({shape}, N={SPLIT_N_CHAINS}, "
          f"T={SPLIT_T})")
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(31),
                               SPLIT_N_CHAINS, SPLIT_T, 1.0)
    s_in = split.rho_split_inputs(params, cfg, noise, noise=True)
    wave = kernels["sample"](**s_in)
    _free()
    check(bool(torch.isfinite(wave).all()), "rho split sampler: non-finite")
    k = SPLIT_T_SAMPLE_CHECK
    pre = dict(s_in, noise=s_in["noise"][:k].contiguous())
    plain_ms["sample"], want = timed(lambda: plains["sample"](**pre))
    err, rel = rel_err(wave[:k], want)
    err_at["sample"] = err
    check(rel <= TOL["highest"], f"rho split sampler, first {k} steps: rel "
                                 f"err {rel:.3e}")
    ctrl["sample"] = _split_miss(
        "rho split sampler", ("wave",), {"wave": TOL["highest"]},
        (kernels["sample"](**pre, precision="default"),), (want,))
    print(f"  highest: max|d| {err:.3e} = {rel:.3e} x max|plain| over the "
          f"first {k} steps (tol {TOL['highest']:g}); plain "
          f"{plain_ms['sample']:.1f} ms on them; control at default "
          f"{ctrl['sample'][0]}", flush=True)
    del wave, want, pre

    phase(f"rho split NLL kernel vs plain ({shape}, B={SPLIT_B}): the kernel "
          f"at T={SPLIT_T}, held to plain on a T={SPLIT_T_NLL} prefix")
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(32), SPLIT_B,
                                SPLIT_T, SPLIT_DT)
    n_in = split.rho_split_inputs(params, cfg, signals)
    names = split.RHO_SPLIT_NAMES + ("se",)
    full, eps = _split_args(n_in, names=names)
    short, _ = _split_args(n_in, SPLIT_T_NLL, names)
    nll_full = {}
    for defer in (False, True):
        o = dict(eps, defer_norm=defer)
        nll_full[defer] = kernels["nll"](*full, **o)
        check(bool(torch.isfinite(nll_full[defer]).all()),
              f"rho split NLL defer={defer} at T={SPLIT_T}: non-finite")
        got = kernels["nll"](*short, **o)
        t_p, want = timed(lambda: plains["nll"](*short, **o))
        err, rel = rel_err(got, want)
        check(rel <= TOL["highest"], f"rho split NLL defer={defer}: rel err "
                                     f"{rel:.3e}")
        c = _split_miss(f"rho split NLL defer={defer}", ("loss",),
                        {"loss": TOL["highest"]},
                        (kernels["nll"](*short, **o, precision="default"),),
                        (want,))
        if not defer:
            err_at["nll"], plain_ms["nll"], ctrl["nll"] = err, t_p, c
        print(f"  highest defer_norm={defer}: max|d| {err:.3e} = {rel:.3e} x "
              f"max|plain| (tol {TOL['highest']:g}), plain {t_p:.1f} ms; "
              f"control at default {c[0]}; mean loss at T={SPLIT_T} "
              f"{nll_full[defer].mean().item():.6f}", flush=True)

    phase(f"rho split training pair vs plain ({shape}, B={SPLIT_B}): "
          f"defer_norm=True on a T={SPLIT_T_TRAIN[True]} prefix, False on "
          f"T={SPLIT_T_TRAIN[False]}; the adjoint fed the plain forward's "
          f"checkpoints")
    g = torch.full((SPLIT_B,), 1.0 / SPLIT_B, device=dev)
    for defer in (True, False):
        args, _ = _split_args(n_in, SPLIT_T_TRAIN[defer], names)
        o = dict(eps, defer_norm=defer)
        t_f, f_p = timed(lambda: plains["fwd"](*args, **o))
        t_b, b_p = timed(lambda: _split_bwd(plains["bwd"], args, g,
                                                f_p[1:], **o))
        line, e_f = _split_hold(f"rho_split_fwd defer={defer}",
                                SPLIT_FWD_LABELS, fwd_tols,
                                kernels["fwd"](*args, **o), f_p)
        b_k = _split_bwd(kernels["bwd"], args, g, f_p[1:], **o)
        torch.cuda.synchronize()
        plan = split.rho_split_bwd.plan
        lb, e_b = _split_hold(f"rho_split_bwd defer={defer}",
                              RHO_SPLIT_BWD_LABELS, bwd_tols, b_k, b_p)
        plans = [(pl, f) for f in split.SPLIT_BWD_FORMS
                 for pl in split.SPLIT_BWD_PLACEMENTS]
        for other in plans:
            b_f = _split_bwd(kernels["bwd"], args, g, f_p[1:], **o,
                             _plan=other)
            check(all(torch.equal(a, b) for a, b in zip(b_f, b_k)),
                  f"rho_split_bwd defer={defer}: {other} is not {plan}'s "
                  f"bits")
        lb.append(f"the four (placement, form) the same bits (the plan: "
                  f"{'/'.join(plan or ('none',))})")
        d = dict(o, precision="default")
        c_f = _split_miss(f"rho_split_fwd defer={defer}", SPLIT_FWD_LABELS,
                          fwd_tols, kernels["fwd"](*args, **d), f_p)
        c_b = _split_miss(f"rho_split_bwd defer={defer}",
                          RHO_SPLIT_BWD_LABELS, bwd_tols,
                          _split_bwd(kernels["bwd"], args, g, f_p[1:],
                                         **d), b_p)
        if defer:
            err_at.update(fwd=e_f, bwd=e_b)
            plain_ms.update(fwd=t_f, bwd=t_b)
            ctrl.update(fwd=c_f, bwd=c_b)
        print(f"  defer_norm={defer}, T={SPLIT_T_TRAIN[defer]} (tol fwd "
              f"{TOL_TRAIN['highest']['fwd']:g}, adjoint "
              f"{TOL_TRAIN['highest']['bwd']:g}, parameter cotangents "
              f"{TOL_TRAIN['highest']['cot']:g}), x max|plain|: "
              + ", ".join(line + lb) + f"; plain fwd {t_f:.1f} ms, bwd "
              f"{t_b:.1f} ms; control at default: fwd " + ", ".join(c_f)
              + "; bwd " + ", ".join(c_b), flush=True)
        del f_p, b_p, b_k
        _free()

    phase(f"rho split training path vs autograd through the eager reference "
          f"({shape}, {SPLIT_B} examples, T={SPLIT_T_REF})")
    short_sig = signals[:, :SPLIT_T_REF].contiguous()
    pk = rho_params_from_numpy(params_to_numpy(params), dev)
    pr = rho_params_from_numpy(params_to_numpy(params), dev)
    loss_k = grad.rho_nll_fused_trainable(pk, cfg, short_sig,
                                          precision="highest",
                                          defer_norm=cfg.defer_norm)
    loss_k.backward()
    loss_r = core.rho_nll_factor(pr, cfg, short_sig)
    loss_r.backward()
    _, rel = rel_err(loss_k.detach(), loss_r.detach())
    line = [f"loss {rel:.2e}"]
    check(rel <= TOL_TRAIN_REFERENCE[0], f"rho split train loss vs "
                                         f"reference: {rel:.3e}")
    for name in pk.NAMES:
        _, rel = rel_err(getattr(pk, name).grad, getattr(pr, name).grad)
        line.append(f"d{name} {rel:.2e}")
        check(rel <= TOL_TRAIN_REFERENCE[1], f"rho split gradient of {name} "
                                             f"vs reference: {rel:.3e}")
    print(f"  x max|reference| (tol {TOL_TRAIN_REFERENCE[0]:g} / "
          f"{TOL_TRAIN_REFERENCE[1]:g}): " + ", ".join(line), flush=True)
    del pk, pr, loss_k, loss_r

    first, second = SPLIT_CLI_STEPS
    phase(f"rho split training path: the estimator CLI with --discr=true "
          f"({shape}, B={SPLIT_B}, T={SPLIT_T}, dt={SPLIT_DT}), "
          f"--max_steps={first} --viz_steps=2, then --max_steps={second} "
          f"resuming at step {first}")
    counted = dict(_training_wrappers(), **{
        k: getattr(block, k) for k in ("psi_sample_block", "psi_nll_block",
                                       "rho_sample_block", "rho_nll_block")},
        **{k: getattr(split, k) for k in ("psi_sample_split", "psi_nll_split",
                                          "rho_sample_split",
                                          "rho_nll_split")})
    for w in counted.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        argv = [f"--model_dir={tmp}", "--viz_steps=2", "--discr=true",
                f"--device={dev.type}"]
        t0 = time.perf_counter()
        est1 = estimator.main(argv + [f"--max_steps={first}"])
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        est2 = estimator.main(argv + [f"--max_steps={second}"])
        torch.cuda.synchronize()
        t_second = time.perf_counter() - t0
        cli = {k: w.launches for k, w in counted.items()}
        state = torch.load(os.path.join(tmp, "checkpoints",
                                        f"ckpt_{first + second}.pt"),
                           map_location="cpu", weights_only=True)
    print(f"  first call: {first} steps in {t_first * 1e3:.1f} ms; second "
          f"call: resumed at step {est2.global_step - second}, {second} steps "
          f"in {t_second * 1e3:.1f} ms (host clock, set-up included); "
          f"launches { {k: v for k, v in cli.items() if v} }", flush=True)
    check(est1.global_step == first and est2.global_step == first + second,
          f"global steps {est1.global_step}, {est2.global_step}")
    check(est2.params.Wx.shape == (RHO_SPLIT_RANK, SPLIT_D),
          f"the estimator trained {type(est2.params).__name__} "
          f"{tuple(est2.params.Wx.shape)}")
    check(state["step"] == first + second, f"final step {state['step']}")
    check(all(float(s["step"]) == first + second
              for s in state["optimizer"]["state"].values()),
          "the Adam state was not restored")
    check(all(bool(torch.isfinite(x).all()) for x in est2.params.parameters()),
          "non-finite parameters")
    for name, count in cli.items():
        want_n = (first + second if name in ("rho_split_fwd", "rho_split_bwd")
                  else 0)
        check(count == want_n, f"{name} launched {count} times in "
                               f"{first + second} estimator steps ({want_n} "
                               f"expected)")
    ec = estimator.parse_args([f"--device={dev.type}", "--discr=true"])
    with tempfile.TemporaryDirectory() as tmp:
        est = estimator.Estimator("rho_mps", est2.cfg, tmp, device=dev)
        input_fn = estimator.build_input_fn(ec, est2.cfg)
        est.train(input_fn, steps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.train(input_fn, steps=3)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        del est
    print(f"  estimator --discr=true train step: {step_ms:.2f} ms host clock "
          f"(mean of 3 after a warm-up step, its checkpoint save included); "
          f"{SPLIT_B * (SPLIT_T - 1) / step_ms * 1e3:.4e} frames/s",
          flush=True)

    phase(f"rho split serving path: sample CLI (mps_model=rho_mps, fused, "
          f"{shape}, {SPLIT_N_CHAINS} x {SPLIT_T}) + rho_nll_fused "
          f"(B={SPLIT_B}, T={SPLIT_T})")
    for w in counted.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"cfg": dataclasses.asdict(cfg),
                       "run": {"mps_model": "rho_mps"}}, f)
        save_params(os.path.join(tmp, "params.npz"), params)
        out = os.path.join(tmp, "samples.npz")
        t0 = time.perf_counter()
        waves = sample(SampleConfig(modeldir=tmp, num_samples=SPLIT_N_CHAINS,
                                    sample_duration=SPLIT_T, fused=True,
                                    device=dev.type, out=out))
        t_sample = time.perf_counter() - t0
        t0 = time.perf_counter()
        scored = load_params(os.path.join(tmp, "params.npz"), dev)
        batch = damped_sine_batch(torch.Generator(dev).manual_seed(34),
                                  SPLIT_B, SPLIT_T, SPLIT_DT)
        nll = scan.rho_nll_fused(scored, cfg, batch).item()
        t_score = time.perf_counter() - t0
        serve = {k: w.launches for k, w in counted.items()}
        n_wav = sum(os.path.exists(os.path.join(tmp, f"samples_{i}.wav"))
                    for i in range(SPLIT_N_CHAINS))
    print(f"  sample CLI: {waves.shape} in {t_sample * 1e3:.1f} ms, {n_wav} "
          f"wav files; NLL {nll:.6f} in {t_score * 1e3:.1f} ms (host clock); "
          f"launches { {k: v for k, v in serve.items() if v} }", flush=True)
    check(waves.shape == (SPLIT_N_CHAINS, SPLIT_T), f"waves {waves.shape}")
    check(bool(torch.isfinite(torch.as_tensor(waves)).all()),
          "sampled waveforms are not finite")
    check(n_wav == SPLIT_N_CHAINS, f"{n_wav} wav files written")
    check(torch.isfinite(torch.tensor(nll)).item(), f"rho NLL {nll}")
    for name, count in serve.items():
        want_n = 1 if name in ("rho_sample_split", "rho_nll_split") else 0
        check(count == want_n, f"{name} launched {count} times on the rho "
                               f"split serving path ({want_n} expected)")

    phase("rho split timings (CUDA events, median of 5 after 1 warm-up)")
    o = dict(eps, defer_norm=cfg.defer_norm)
    loss_f, ckr, cki = kernels["fwd"](*full, **o)
    check(torch.equal(loss_f, nll_full[cfg.defer_norm]),
          "the training forward's loss is not the NLL's bit for bit")
    ms = {"sample": median_ms(lambda: kernels["sample"](**s_in)),
          "nll": median_ms(lambda: kernels["nll"](*full, **eps)),
          "fwd": median_ms(lambda: kernels["fwd"](*full, **o)),
          "bwd": median_ms(lambda: _split_bwd(kernels["bwd"], full, g,
                                                  (ckr, cki), **o))}
    check(torch.equal(kernels["fwd"](*full, **eps, defer_norm=False)[0],
                      nll_full[False]),
          "the rho training forward's loss at defer_norm=False is not the "
          "NLL's bit for bit")
    s_one = dict(s_in, noise=s_in["noise"][:, :1].contiguous(),
                 h0r=s_in["h0r"][:, :RHO_SPLIT_RANK].contiguous(),
                 h0i=s_in["h0i"][:, :RHO_SPLIT_RANK].contiguous())
    one_ms = median_ms(lambda: kernels["sample"](**s_one))
    lay = split.rho_sample_split.layout
    print(f"  rho_sample_split ({lay.threads} threads of {lay.elems} "
          f"element(s)): {SPLIT_N_CHAINS} chains "
          f"{ms['sample']:.3f} ms ({ms['sample'] / SPLIT_T * 1e3:.3f} us a "
          f"step), one chain {one_ms:.3f} ms "
          f"({one_ms / SPLIT_T * 1e3:.3f} us a step)", flush=True)
    del s_one
    layout = split.rho_split_fwd.layout
    variants = {
        "rho_nll_split/defer=True": median_ms(
            lambda: kernels["nll"](*full, **o)),
        "rho_split_fwd/defer=False": median_ms(
            lambda: kernels["fwd"](*full, **eps, defer_norm=False))}
    for name, t in variants.items():
        print(f"  {name}: {t:.3f} ms", flush=True)
    print(f"  the forwards' layout at D={SPLIT_D}, rank {RHO_SPLIT_RANK}: "
          f"{layout.cols} columns a warp, {layout.warps} warps", flush=True)
    _split_forward_sweep(dev, "rho", SPLIT_D, RHO_SPLIT_RANK)
    _split_forward_sweep(dev, "rho", 20, 20)
    n_steps = SPLIT_T - 1
    ex_steps = n_steps * SPLIT_B
    lane_steps = ex_steps * RHO_SPLIT_RANK
    chain_steps = SPLIT_T * SPLIT_N_CHAINS
    nb = -(-n_steps // DEFAULT_UNROLL)
    mats = 6 * SPLIT_D * SPLIT_D + 2 * SPLIT_D
    lanes = SPLIT_B * RHO_SPLIT_RANK
    state = 2 * SPLIT_D * lanes
    ck = 2 * nb * SPLIT_D * lanes
    c = 8 * SPLIT_D * SPLIT_D
    b = 4 * SPLIT_D * SPLIT_D

    def flops(role, lane_n, ex_n):
        return (RHO_SPLIT_PRODUCTS[role] * c * lane_n
                + RHO_SPLIT_BUILDS[role] * b * ex_n)

    cost = {"sample": (flops("sample", chain_steps * RHO_SPLIT_RANK,
                             chain_steps),
                       2 * chain_steps + mats
                       + 2 * SPLIT_D * SPLIT_N_CHAINS * RHO_SPLIT_RANK + 1),
            "nll": (flops("nll", lane_steps, ex_steps),
                    ex_steps + mats + state + SPLIT_B),
            "fwd": (flops("fwd", lane_steps, ex_steps),
                    ex_steps + mats + state + SPLIT_B + ck),
            "bwd": (flops("bwd", lane_steps, ex_steps),
                    2 * ex_steps + SPLIT_B + ck + 2 * mats + state)}
    launches = {"sample": serve["rho_sample_split"],
                "nll": serve["rho_nll_split"],
                "fwd": cli["rho_split_fwd"], "bwd": cli["rho_split_bwd"]}
    pre_t = {"sample": SPLIT_T_SAMPLE_CHECK, "nll": SPLIT_T_NLL,
             "fwd": SPLIT_T_TRAIN[True], "bwd": SPLIT_T_TRAIN[True]}
    entries = []
    for role, (name, src, rep) in RHO_SPLIT_KERNELS.items():
        flops_n, words = cost[role]
        bound, by = bound_ms(flops_n, 4 * words)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": launches[role], "max_abs_err": err_at[role],
            "ms": ms[role], "plain_ms": plain_ms[role], "bound_ms": bound,
            "bound_by": by, "library_ms": None})
        print(f"  {name}: {ms[role]:.3f} ms at T={SPLIT_T} "
              f"({ms[role] / SPLIT_T * 1e3:.2f} us a step), launches "
              f"{launches[role]} on its main path (plain "
              f"{plain_ms[role]:.1f} ms at T={pre_t[role]}; bound "
              f"{bound:.3f} ms by {by}, {bound / ms[role] * 100:.2f}% of it; "
              f"control at default " + ", ".join(ctrl[role]) + ")",
              flush=True)
    print(f"  estimator --discr=true step {step_ms:.2f} ms, of which the "
          f"forward and adjoint kernels {ms['fwd'] + ms['bwd']:.2f} ms; the "
          f"adjoint's launches took "
          f"{'/'.join(split.rho_split_bwd.plan or ('none',))} "
          f"(placement/form); {card_line()}", flush=True)
    _split_attribution("rho", dev)
    return entries


# psi's spine/limbs training pair (row 3e: the TPU factory's batched=True,
# deferred norm only; off on the default path) at the training headline.
# Holds, max|kernel - plain| <= TOL * max|plain|: the forward (loss, ck)
# over the whole run at the streamed forward's full-length limit
# (TOL_TRAIN fwd, as row 3d's checkpoint forward is held over its run) and
# on the T=2048 prefix at TOL_CKPT; the adjoint (dse, dt0 and the three
# cotangents, fed the plain checkpoints) on the prefix at TOL_RECOMPUTE_BWD,
# both at highest and high, with the kernels at default as the controls of
# the high limits. The batched pair against the streamed pair: TOL_OFF.
BATCHED_KERNELS = ("psi_batched_fwd", "psi_batched_bwd")
BATCHED_STEPS = 3      # Adam steps through the batched loss


def _adam_steps(dev, cfg, params, T, seed, steps, batched):
    """``steps`` Adam steps (``training.make_optimizer``) on a copy of
    ``params`` through the mean block NLL (``psi_nll_block_trainable``,
    the streamed or recompute pair as ``cfg.kernel_stream`` picks, or the
    batched pair), on damped-sine batches: (host-clock ms a step after the
    first, synchronised; peak device memory of those steps; the losses)."""
    from audio_mps_tpu_torch import weights
    from audio_mps_tpu_torch.data import damped_sine_iterator
    from audio_mps_tpu_torch.ops import block
    from audio_mps_tpu_torch.training import make_optimizer

    p = weights.psi_params_from_numpy(weights.params_to_numpy(params), dev)
    opt = make_optimizer(cfg, p)
    data = damped_sine_iterator(cfg, T, seed=seed, device=dev)
    losses, times = [], []
    for k in range(steps):
        batch = next(data)
        if k == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = block.psi_nll_block_trainable(
            p, cfg, batch, precision=cfg.kernel_precision,
            defer_norm=cfg.defer_norm, batched=batched)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses),
          f"non-finite losses {losses}")
    check(all(bool(torch.isfinite(getattr(p, k)).all()) for k in p.NAMES),
          "non-finite parameters after the Adam steps")
    del p, opt, data
    _free()
    return statistics.mean(times[1:]), peak, losses


def batched_phases(dev, fam: Family, library_ms: float):
    """Row 3e at psi's training headline (D=64, B=128, T=16384, highest,
    unroll 16, deferred norm): the batched forward and adjoint vs their
    plain versions (the forward over the whole run and the prefix, the
    adjoint on the T=2048 prefix, highest and high, controls at default);
    vs the checkpoint forward bit for bit and the streamed pair (loss and
    six gradients); two adjoint runs bit for bit; three Adam steps through
    the batched loss, in which only the batched pair launches; the kernels'
    CUDA-event times beside their bounds, and one step's time and peak
    memory beside the streamed and recompute steps'. ``library_ms``: the
    three reductions as ``torch.matmul`` at this shape, measured in
    ``train_phases``. Returns the two kernels' entries."""
    from audio_mps_tpu_torch import weights
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.ops import block
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL

    cfg, B, T = fam.cfg, fam.B, fam.T
    check(cfg.defer_norm, "the batched pair needs the deferred norm")
    unroll = DEFAULT_UNROLL
    n = 2 * D
    fwd, bwd = block.psi_batched_fwd, block.psi_batched_bwd
    fwd_p, bwd_p = block.psi_batched_fwd_plain, block.psi_batched_bwd_plain
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(fam.seed + 5),
                            B, T, cfg.delta_t)
    ins = block.psi_nll_inputs(fam.params, cfg, sig)
    eps = dict(log_eps=ins.pop("log_eps"), norm_eps=ins.pop("norm_eps"))
    con = (ins["ab"], ins["bb"], ins["rb"])
    pre = dict(ins, se=ins["se"][:T_PREFIX - 1].contiguous())
    g = torch.full((B,), 1.0 / B, device=dev)
    shape = f"D={D}, B={B}"

    phase(f"psi batched pair (row 3e) vs plain ({shape}): the forward at "
          f"T={T} and on the T={T_PREFIX} prefix, the adjoint on the prefix")
    o = dict(unroll=unroll, precision="highest")
    plain_ms = {}
    plain_ms["fwd"], want = timed(lambda: fwd_p(**ins, **eps, **o))
    got = fwd(**ins, **eps, **o)
    ckpt = block.psi_train_fwd_ckpt(**ins, **eps, **o, defer_norm=True)
    torch.cuda.synchronize()
    check(torch.equal(got[0], ckpt[0]) and torch.equal(got[1], ckpt[1]),
          "the batched forward's loss and ck are not the checkpoint "
          "forward's bits")
    tol = TOL_TRAIN["highest"]["fwd"]
    readings, err_fwd = _readings(f"highest T={T}", _hold_outputs(
        f"psi_batched_fwd highest T={T}", ("loss", "ck"), got, want, tol))
    print(f"  highest T={T} (tol {tol:g}), x max|plain|: "
          + ", ".join(readings) + f"; equal to psi_train_fwd_ckpt's bits; "
          f"plain {plain_ms['fwd']:.1f} ms", flush=True)
    del want, got, ckpt
    _free()
    err_at, ctrl = {"fwd": err_fwd}, {}
    labels = {"fwd": ("loss", "ck"),
              "bwd": ("dse", "dt0", "dAb", "dBb", "dRb")}
    tols = {"fwd": TOL_CKPT, "bwd": TOL_RECOMPUTE_BWD}
    for prec in ("highest", "high"):
        o = dict(unroll=unroll, precision=prec)
        f_p = fwd_p(**pre, **eps, **o)
        t_b, b_p = timed(lambda: bwd_p(*con, f_p[1], pre["se"], g, **eps,
                                       **o))
        if prec == "highest":
            plain_ms["bwd"] = t_b
        want = {"fwd": f_p, "bwd": b_p}
        calls = {"fwd": lambda **x: fwd(**pre, **eps, **x),
                 "bwd": lambda **x: bwd(*con, f_p[1], pre["se"], g, **eps,
                                        **x)}
        line = []
        for role, fn in calls.items():
            got = fn(**o)
            torch.cuda.synchronize()
            readings, worst = _readings(prec, _hold_outputs(
                f"psi_batched_{role} {prec}", labels[role], got, want[role],
                tols[role][prec]))
            line += readings
            if prec == "highest":
                err_at[role] = max(err_at.get(role, 0.0), worst)
            else:
                ctrl[role] = _control(
                    f"psi_batched_{role}",
                    lambda: fn(**dict(o, precision="default")), want[role],
                    tols[role]["high"])
            del got
        print(f"  T={T_PREFIX} {prec} (tol fwd {tols['fwd'][prec]:g}, bwd "
              f"{tols['bwd'][prec]:g}), x max|plain|: " + ", ".join(line),
              flush=True)
        del f_p, b_p, want
        _free()
    print(f"  control, kernels at default vs plain at high (must exceed the "
          f"high limits): forward {ctrl['fwd']:.2e}, adjoint "
          f"{ctrl['bwd']:.2e}; plain adjoint {plain_ms['bwd']:.1f} ms at "
          f"T={T_PREFIX}", flush=True)

    phase(f"psi batched pair vs the streamed pair on the card ({shape}, "
          f"T={T})")
    _, ck = fwd(**ins, **eps, unroll=unroll)
    runs = [bwd(*con, ck, ins["se"], g, **eps, unroll=unroll)
            for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          "two runs of the batched adjoint differ")
    del runs
    _free()

    def nll(q, c, batched=False):
        return block.psi_nll_block_trainable(
            q, c, sig, precision=cfg.kernel_precision,
            defer_norm=cfg.defer_norm, batched=batched)

    line = _off_vs_streamed(
        "psi", nll, fam.params, weights.psi_params_from_numpy, cfg, dev,
        other=lambda q, c: nll(q, c, batched=True), label="batched")
    print(f"  two runs of the batched adjoint equal bit for bit; batched vs "
          f"streamed x max|streamed| (tol {TOL_OFF[0]:g} / {TOL_OFF[1]:g}): "
          + ", ".join(line), flush=True)

    phase(f"psi batched pair: {BATCHED_STEPS} Adam steps through the batched "
          f"loss ({shape}, T={T}), then the streamed and recompute steps")
    counted = _training_wrappers()
    for fn in counted.values():
        fn.launches = 0
    step_ms, peak, losses = {}, {}, {}
    step_ms["batched"], peak["batched"], losses["batched"] = _adam_steps(
        dev, cfg, fam.params, T, fam.seed + 6, BATCHED_STEPS, True)
    launches = {k: fn.launches for k, fn in counted.items()}
    for k, count in launches.items():
        want_n = BATCHED_STEPS if k in BATCHED_KERNELS else 0
        check(count == want_n, f"{k} launched {count} times in the "
                               f"{BATCHED_STEPS} batched Adam steps")
    for label, kind in (("streamed", "on"), ("recompute", "off")):
        c = dataclasses.replace(cfg, kernel_stream=kind)
        step_ms[label], peak[label], losses[label] = _adam_steps(
            dev, c, fam.params, T, fam.seed + 6, BATCHED_STEPS, False)
    # the same batches from the same weights: the first step's loss is the
    # same function on each path
    for label in ("streamed", "recompute"):
        _, rel = rel_err(torch.tensor(losses["batched"][0]),
                         torch.tensor(losses[label][0]))
        check(rel <= TOL_OFF[0], f"batched vs {label}: first loss {rel:.3e}")
    print(f"  launches in the {BATCHED_STEPS} steps: "
          + ", ".join(f"{k} {launches[k]}" for k in BATCHED_KERNELS)
          + ", every other training kernel 0; losses "
          + ", ".join(f"{x:.6f}" for x in losses["batched"]), flush=True)
    print("  one step (host clock, mean of steps 2-3, synchronised): "
          + "; ".join(f"{k} {step_ms[k]:.2f} ms, peak {peak[k] / 1e9:.3f} GB"
                      for k in ("batched", "streamed", "recompute"))
          + f"; {B * (T - 1) / step_ms['batched'] * 1e3:.4e} frames/s "
          f"batched", flush=True)

    phase(f"psi batched pair timings ({shape}, T={T}, CUDA events, median "
          f"of 5 after 1 warm-up)")
    ms = {}
    for prec in ("highest", "high"):
        _, ck_p = fwd(**ins, **eps, unroll=unroll, precision=prec)
        t_f = median_ms(lambda: fwd(**ins, **eps, unroll=unroll,
                                    precision=prec))
        t_b = median_ms(lambda: bwd(*con, ck_p, ins["se"], g, **eps,
                                    unroll=unroll, precision=prec))
        if prec == "highest":
            ms = {"fwd": t_f, "bwd": t_b}
        print(f"  {prec}: forward {t_f:.3f} ms, adjoint {t_b:.3f} ms",
              flush=True)
        del ck_p
    ex_steps = (T - 1) * B
    ck_elems = ck.numel()
    del ck
    _free()
    # forward: the three products of the streamed forward; bytes of se,
    # the constants, t0, loss and ck once. Adjoint: the recompute adjoint's
    # bound (row 3d): re-run, adjoint and reductions, 2 + 4 + 3 products
    f_bound = bound_ms(TRAIN_PRODUCTS["psi"]["fwd"] * 2 * n * n * ex_steps,
                       4 * (ex_steps + 3 * n * n + n * B + B + ck_elems))
    bounds = {"fwd": f_bound,
              "bwd": _adjoint_bound("psi", n, ex_steps, ex_steps, ck_elems,
                                    B, B)}
    no_rerun = bounds["bwd"][0] * (
        (TRAIN_PRODUCTS["psi"]["bwd"] + TRAIN_PRODUCTS["psi"]["cot"])
        / (RECOMPUTE_PRODUCTS["psi"] + TRAIN_PRODUCTS["psi"]["bwd"]
           + TRAIN_PRODUCTS["psi"]["cot"]))
    entries = []
    for role, name in zip(("fwd", "bwd"), BATCHED_KERNELS):
        bound, by = bounds[role]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"audio_mps_tpu_torch/csrc/{name}.cu",
            "replaces": "audio_mps_tpu/ops/pallas_block.py:"
                        + ("276" if role == "fwd" else "338"),
            "launches": launches[name], "max_abs_err": err_at[role],
            "ms": ms[role], "plain_ms": plain_ms[role], "bound_ms": bound,
            "bound_by": by,
            "library_ms": library_ms if role == "bwd" else None})
        print(f"  {name}: {ms[role]:.3f} ms, {bound / ms[role] * 100:.2f}% "
              f"of its bound {bound:.3f} ms by {by}; launches "
              f"{launches[name]}; plain {plain_ms[role]:.1f} ms at T="
              f"{T if role == 'fwd' else T_PREFIX}; control at default "
              f"{ctrl[role]:.2e}"
              + (f"; torch.matmul of the three reductions {library_ms:.3f} "
                 f"ms; {no_rerun:.3f} ms without the re-run's two products"
                 if role == "bwd" else ""), flush=True)
    return entries


# The floor probe (row 14, tools/probe8_psi_floor.py): the port tool's
# card passes, then each variant against its plain version at the
# correctness shape (D=64, B=128, T=257, K=16), max|kernel - plain| <= TOL
# x max|plain| of the per-column values at highest and high, controls at
# default; then the tool's time of each variant at the timing shape
# (D=64, B=128, T=16385, K=16) beside its bound.
def probe_phases(dev):
    """Row 14: returns the probe kernel's entry of the {"kernels": [...]}
    line (its time: the G=1 variant at highest)."""
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models.params import init_psi
    from audio_mps_tpu_torch.ops import block, probe
    from audio_mps_tpu_torch.tools import probe8_psi_floor as tool

    phase("floor probe (row 14): the port tool's card passes, correctness "
          f"at (D, B, T, K) = {tool.CARD_SHAPE}, timing at "
          f"{tool.TIMING_SHAPE}")
    probe.psi_probe_columns.launches = 0
    tool.check_variants(dev)
    timings = tool.time_variants(dev)
    launches = probe.psi_probe_columns.launches
    # one run a variant and precision in the correctness pass; 2 warm-ups
    # and 8 timed runs in the timing pass
    check(launches == len(tool.VARIANTS) * len(tool.PRECISIONS)
          + len(tool.TIMED) * len(tool.PRECISIONS) * (2 + 8),
          f"the tool launched the probe kernel {launches} times")

    def inputs(shape):
        Dp, Bp, Tp, _ = shape
        cfg = CMPSConfig(bond_dim=Dp, minibatch_size=Bp)
        params = init_psi(torch.Generator(dev).manual_seed(0), cfg,
                          device=dev)
        sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), Bp, Tp,
                                cfg.delta_t)
        ins = block.psi_nll_inputs(params, cfg, sig)
        consts = (ins["ab"], ins["bb"], ins["rb"]) + probe.probe_products(
            ins["ab"], ins["bb"])
        return consts, ins

    variants = [(g, p, False) for g, p in tool.VARIANTS] + [(1, False, True)]
    phase(f"floor probe kernel vs plain per column, T={tool.CARD_SHAPE[2]}")
    consts, ins = inputs(tool.CARD_SHAPE)
    K = tool.CARD_SHAPE[3]
    worst, ctrl = 0.0, float("inf")
    for G, paired, noloss in variants:
        line = []
        for prec in ("highest", "high"):
            kw = dict(G=G, paired=paired, noloss=noloss, unroll=K,
                      log_eps=ins["log_eps"], norm_eps=ins["norm_eps"])
            want = probe.psi_probe_columns_plain(consts, ins["t0"], ins["se"],
                                                 precision=prec, **kw)
            got = probe.psi_probe_columns(consts, ins["t0"], ins["se"],
                                          precision=prec, **kw)
            torch.cuda.synchronize()
            res = _hold_outputs(f"probe {tool.tag(G, paired, noloss)} {prec}",
                                ("values",), (got,), (want,), TOL[prec])
            line.append(f"{prec} {res['values'][1]:.2e}")
            if prec == "highest":
                worst = max(worst, res["values"][0])
            else:
                c = _control(f"probe {tool.tag(G, paired, noloss)}",
                             lambda: probe.psi_probe_columns(
                                 consts, ins["t0"], ins["se"],
                                 precision="default", **kw), want,
                             TOL["high"])
                ctrl = min(ctrl, c)
                line.append(f"control {c:.2e}")
        print(f"  {tool.tag(G, paired, noloss)} (tol {TOL['highest']:g} / "
              f"{TOL['high']:g}), x max|plain|: " + ", ".join(line),
              flush=True)
    del consts, ins
    _free()

    Dt, Bt, Tt, Kt = tool.TIMING_SHAPE
    phase(f"floor probe timings (D={Dt}, B={Bt}, T={Tt}, K={Kt}): the "
          f"tool's (CUDA events, the mean of 8 runs of its run(), inputs "
          f"built in each) beside the bounds; the G=1 kernel alone (median "
          f"of 5 after 1 warm-up) and its plain version (one run)")
    consts, ins = inputs(tool.TIMING_SHAPE)
    n = 2 * Dt
    ex_steps = (Tt - 1) * Bt
    # the fewest [2D,2D] products a column-step: 3 (Ab t, Bb t, Rb y; the
    # paired variants compute the same function), 2 without the loss;
    # bytes of se, the constants, t0 and the values once
    bounds = {noloss: bound_ms((2 if noloss else 3) * 2 * n * n * ex_steps,
                               4 * (ex_steps + 3 * n * n + n * Bt + Bt))
              for noloss in (False, True)}
    for prec, G, paired, noloss, t, ns, _ in timings:
        bound, by = bounds[noloss]
        print(f"  {prec} {tool.tag(G, paired, noloss)}: {t:.3f} ms, "
              f"{ns:.0f} ns a step; bound {bound:.3f} ms by {by} "
              f"({bound / t * 100:.2f}%)", flush=True)
    kw = dict(unroll=Kt, log_eps=ins["log_eps"], norm_eps=ins["norm_eps"])
    ms = median_ms(lambda: probe.psi_probe_columns(consts, ins["t0"],
                                                   ins["se"], **kw))
    plain_ms, _ = timed(lambda: probe.psi_probe_columns_plain(
        consts, ins["t0"], ins["se"], **kw))
    bound, by = bounds[False]
    print(f"  the G=1 kernel at highest alone: {ms:.3f} ms, "
          f"{bound / ms * 100:.2f}% of its bound; plain {plain_ms:.1f} ms; "
          f"{card_line()}", flush=True)
    del consts, ins
    _free()
    return [{"name": "psi_probe_columns", "route": "cuda",
             "source": "audio_mps_tpu_torch/csrc/psi_probe.cu",
             "replaces": "tools/probe8_psi_floor.py:62",
             "launches": launches, "max_abs_err": worst,
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None}]


# ---------------------------------------------------------------------------
# The data plane on the reference's datasets, and the lab-frame anchor
# ---------------------------------------------------------------------------

DATA_EXAMPLES = 100    # the reference's make-small-dataset.py keeps ~100
DATA_LENGTH = 2 ** 16  # its ETL pads each note to 2^16 samples
# (dataset name, instrument family, MIDI pitch) of the two stand-ins
DATASETS = (("guitar", "guitar", 50), ("organ", "organ", 55))
DATA_BATCHES = 20      # get_audio batches timed after the first
EST_D = 32             # BASELINE.json config 2: D=32 on the organ subset
EST_STEPS = 2          # the estimator CLI's two calls of 2 steps each
DATA_STEP_REPS = 3
PSI_KERNELS = {"psi_train_fwd": 1, "psi_train_bwd": 1, "psi_cotangents": 1,
               PSI_TAIL: 1}
RHO_KERNELS = {"rho_train_fwd": 1, "rho_train_bwd": 1, "rho_cotangents": 1}
# bench.py's primary cell: psi D=64, B=128, T=16384; rho D=64 (rank 64), B=8
LAB_D, LAB_B, LAB_T = 64, 128, 16384
LAB_T_PREFIX = 2048    # the lab frame held to the kernel path at rtol 2e-4
LAB_T_WARMUP = 256     # the warm-up lab step's prefix
# the lab-frame Adam step and the kernel path's on this prefix (their ratio,
# vs_baseline, is per frame; the lab step's backward takes ~4.7 ms a step);
# the whole-length gap comes from the two NLLs without gradient
LAB_T_STEP = 2049
TOL_LAB = 2e-4         # tests/test_model_psi.py's lab-frame tolerance
LAB_RHO_B = 8
LAB_RHO_T = 1025       # rho's lab step on a prefix: 4 chunks of 256 steps
# the whole-length gap of the lab frame to the kernel path, relative to the
# kernel path's NLL: twice the sum of the float32 lab frame's and the
# float32 eager core's gaps to a float64 run of the lab frame on the same
# inputs, on the CPU (tools/lab_frame_gap.py on an H100 machine: 8.959e-4
# and 4.548e-5; PERF.md section 5)
LAB_GAP_LIMIT = 1.883e-3


def _sync_ms(t0):
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _zero_launches():
    counted = _training_wrappers()
    for w in counted.values():
        w.launches = 0
    return counted


def _check_launches(counted, per_step, steps, what):
    launches = {k: w.launches for k, w in counted.items() if w.launches}
    for name, w in counted.items():
        want = per_step.get(name, 0) * steps
        check(w.launches == want, f"{name} launched {w.launches} times in "
                                  f"{what} ({want} expected)")
    return launches


def _summary_samples(sampler, calls):
    """The train CLI's summaries draw their samples through ``sampler``
    once a summary (``calls`` of them) where tensorboard is installed, and
    draw none where it is not."""
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        want = calls
    except ImportError:
        want = 0
    print(f"  the summaries' sampler {sampler.__name__}: "
          f"{sampler.launches} launches ({want} expected)", flush=True)
    check(sampler.launches == want, f"{sampler.__name__} launched "
                                    f"{sampler.launches} times")


def data_plane_phases(dev, tmp):
    """The native library, the two stand-in datasets written into ``tmp``
    by the port's dataset tool, and the records read a second through the
    native and the pure-Python parsers."""
    import contextlib
    import importlib.util
    import io

    import numpy as np

    from audio_mps_tpu_torch import native
    from audio_mps_tpu_torch.data import tfrecord
    from audio_mps_tpu_torch.tools import make_instrument_dataset

    card = card_line()
    phase(f"data plane: the native library, {len(DATASETS)} stand-in "
          f"datasets ({DATA_EXAMPLES} x {DATA_LENGTH}), records a second "
          f"[{card}]")
    built = native.build()
    check(native.available(), f"the native library did not load: "
                              f"{native.build_error()}")
    crc = ("google_crc32c" if importlib.util.find_spec("google_crc32c")
           else "the native library")
    print(f"  native library: g++ {built['seconds']:.2f} s (rebuilt="
          f"{built['rebuilt']}) -> {built['path']}; CRC32C by {crc}",
          flush=True)
    for name, family, pitch in DATASETS:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            make_instrument_dataset.main([
                f"--output_dir={tmp}", f"--name={name}", f"--family={family}",
                f"--pitch={pitch}", f"--count={DATA_EXAMPLES}",
                f"--length={DATA_LENGTH}"])
        secs = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(tmp, f"{name}.tfrecords"))
        print(f"  {name}.tfrecords: {size / 1e6:.2f} MB, synthesized and "
              f"written through the NSynth ETL in {secs:.2f} s", flush=True)
    path = os.path.join(tmp, "guitar.tfrecords")
    n_mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    payloads = list(tfrecord.read_records(path))
    t_frame = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = [native.parse_float_feature(p, "audio") for p in payloads]
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = [tfrecord.decode_example(p)["audio"] for p in payloads]
    t_python = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = tfrecord.read_audio_tfrecords(path)
    t_read = time.perf_counter() - t0
    check(len(payloads) == DATA_EXAMPLES, f"{len(payloads)} records")
    check(all(a is not None and np.array_equal(a, b)
              for a, b in zip(fast, slow)),
          "the native and the pure-Python parsers disagree")
    check(whole.shape == (DATA_EXAMPLES, DATA_LENGTH)
          and np.array_equal(whole, np.stack(slow)), "read_audio_tfrecords")
    n = len(payloads)
    print(f"  guitar.tfrecords ({n} records, {n_mb:.2f} MB): framing and "
          f"CRC {n / t_frame:.1f} records/s ({n_mb / t_frame:.0f} MB/s); "
          f"native parser {n / t_native:.1f} records/s "
          f"({n_mb / t_native:.0f} MB/s); pure-Python parser "
          f"{n / t_python:.1f} records/s ({n_mb / t_python:.0f} MB/s), "
          f"identical arrays; read_audio_tfrecords {t_read * 1e3:.1f} ms "
          f"[{card}]", flush=True)


def file_training_phases(dev, tmp):
    """Configs 1 and 2 of BASELINE.json on the stand-ins in ``tmp``: the
    train CLI at its defaults on guitar.tfrecords, get_audio's time a batch
    against the train step's; the organ set filtered by pitch and
    instrument, the estimator CLI at D=32 and the rho train CLI on it."""
    import contextlib
    import io

    from audio_mps_tpu_torch import estimator
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import NSynthDataset, get_audio
    from audio_mps_tpu_torch.models.params import RhoParams, init_psi
    from audio_mps_tpu_torch.ops import block
    from audio_mps_tpu_torch.tools import make_small_dataset
    from audio_mps_tpu_torch.train import parse_args, train
    from audio_mps_tpu_torch.training import make_train_step

    card = card_line()
    cfg = CMPSConfig()
    phase(f"config 1: the train CLI at its defaults on guitar.tfrecords "
          f"(psi, D={cfg.bond_dim}, B={cfg.minibatch_size}, T={DATA_LENGTH}"
          f"), {TRAIN_STEPS} steps, a restore and one more [{card}]")
    block.psi_sample_block.launches = 0
    train_cli_phase(dev, "psi_mps", cfg, DATA_LENGTH, TRAIN_STEPS,
                    PSI_KERNELS, flags=(f"--datadir={tmp}",),
                    dataset="guitar")
    _summary_samples(block.psi_sample_block, 2)
    reads = {}
    for stream in (False, True):
        t0 = time.perf_counter()
        it = get_audio(tmp, "guitar", cfg, sample_duration=DATA_LENGTH,
                       stream=stream, device=dev)
        first = next(it)
        t_first = _sync_ms(t0)
        t0 = time.perf_counter()
        for _ in range(DATA_BATCHES):
            batch = next(it)
        reads[stream] = (t_first, _sync_ms(t0) / DATA_BATCHES)
        check(batch.shape == first.shape == (cfg.minibatch_size,
                                             DATA_LENGTH)
              and batch.device.type == "cuda"
              and bool(torch.isfinite(batch).all()), "get_audio batches")
    params = init_psi(torch.Generator(dev).manual_seed(30), cfg, device=dev)
    _, step = make_train_step("psi_mps", cfg, params, device=dev)
    it = get_audio(tmp, "guitar", cfg, sample_duration=DATA_LENGTH,
                   device=dev)
    step(next(it))
    t0 = time.perf_counter()
    for _ in range(DATA_STEP_REPS):
        metrics = step(next(it))
    step_ms = _sync_ms(t0) / DATA_STEP_REPS
    check(bool(torch.isfinite(metrics["total_loss"])), "non-finite loss")
    (m_first, m_batch), (s_first, s_batch) = reads[False], reads[True]
    print(f"  get_audio a batch: in memory {m_batch:.3f} ms (the first "
          f"{m_first:.1f} ms, the file read), streamed {s_batch:.3f} ms "
          f"(the first {s_first:.1f} ms, the reservoir's fill); a train "
          f"step {step_ms:.2f} ms host clock with its batch drawn, mean of "
          f"{DATA_STEP_REPS}: the in-memory draw is "
          f"{m_batch / step_ms:.1%} of it, the streamed "
          f"{s_batch / step_ms:.1%} [{card}]", flush=True)
    del params, step, it
    _free()

    raw = os.path.join(tmp, "organ-nsynth.tfrecord")
    sub = os.path.join(tmp, "organ_pitch55.tfrecords")
    _, family, pitch = DATASETS[1]
    phase(f"config 2: organ-nsynth.tfrecord filtered by instrument "
          f"({family}) and pitch ({pitch}) through NSynthDataset; the "
          f"estimator CLI at D={EST_D} on it ({EST_STEPS} + {EST_STEPS} "
          f"steps), the rho train CLI (1 step) [{card}]")
    t0 = time.perf_counter()
    audio = NSynthDataset(raw, instrument=family, pitch=pitch).load_audio(
        length=DATA_LENGTH)
    t_filter = time.perf_counter() - t0
    check(audio.shape == (DATA_EXAMPLES, DATA_LENGTH), f"{audio.shape}")
    for kw in (dict(instrument="guitar"), dict(pitch=pitch + 1)):
        try:
            NSynthDataset(raw, **kw).load_audio(length=DATA_LENGTH)
        except IOError:
            continue
        check(False, f"NSynthDataset({kw}) matched organ notes at {pitch}")
    with contextlib.redirect_stdout(io.StringIO()):
        make_small_dataset.main([
            f"--input={raw}", f"--output={sub}", f"--pitch={pitch}",
            f"--instrument={family}", f"--count={DATA_EXAMPLES}",
            f"--length={DATA_LENGTH}"])
    with open(sub, "rb") as f, open(os.path.join(tmp, "organ.tfrecords"),
                                     "rb") as g:
        check(f.read() == g.read(), "make_small_dataset's subset differs "
                                    "from make_instrument_dataset's ETL")
    print(f"  NSynthDataset: {audio.shape[0]} of {DATA_EXAMPLES} notes "
          f"match in {t_filter * 1e3:.1f} ms; make_small_dataset wrote "
          f"{os.path.basename(sub)}, equal to organ.tfrecords [{card}]",
          flush=True)
    counted = _zero_launches()
    argv = [f"--data_dir={sub}", f"--bond_d={EST_D}",
            f"--model_dir={os.path.join(tmp, 'estimator')}",
            f"--viz_steps={EST_STEPS}", f"--max_steps={EST_STEPS}",
            f"--sample_duration={DATA_LENGTH}", f"--device={dev.type}"]
    t0 = time.perf_counter()
    est = estimator.main(argv)
    est = estimator.main(argv)
    t_est = _sync_ms(t0)
    check(est.global_step == 2 * EST_STEPS, f"step {est.global_step}")
    check(all(bool(torch.isfinite(x).all()) for x in est.params.parameters()),
          "non-finite parameters")
    launches = _check_launches(counted, PSI_KERNELS, 2 * EST_STEPS,
                               f"the estimator's {2 * EST_STEPS} steps")
    print(f"  estimator: {2 * EST_STEPS} steps in two calls in {t_est:.1f} "
          f"ms host clock (set-up and checkpoints included); launches "
          f"{launches} [{card}]", flush=True)
    del est
    _free()
    counted = _zero_launches()
    block.rho_sample_block.launches = 0
    logdir = os.path.join(tmp, "rho")
    run, device = parse_args(["--mps_model=rho_mps", "--dataset=organ",
                              f"--datadir={tmp}", f"--logdir={logdir}",
                              f"--sample_duration={DATA_LENGTH}",
                              "--max_steps=1", f"--device={dev.type}"])
    t0 = time.perf_counter()
    p, m = train(run, device=device)
    t_rho = _sync_ms(t0)
    check(type(p) is RhoParams, "the rho train CLI made no RhoParams")
    check(all(bool(torch.isfinite(v).all()) for v in m.values()),
          f"non-finite metrics {m}")
    check(os.path.exists(os.path.join(run.run_logdir(CMPSConfig()),
                                      "params.npz")), "no params.npz")
    launches = _check_launches(counted, RHO_KERNELS, 1,
                               "the rho train CLI's step")
    _summary_samples(block.rho_sample_block, 1)
    print(f"  rho train CLI (D={CMPSConfig().bond_dim}, full rank, "
          f"B={CMPSConfig().minibatch_size}, T={DATA_LENGTH}): 1 step in "
          f"{t_rho:.1f} ms host clock (set-up included), loss "
          f"{float(m['model_loss']):.6f}; launches {launches} [{card}]",
          flush=True)
    del p, m
    _free()


def _lab_warmup(ref, cfg, mps_model, params, from_numpy, batch):
    """One lab-frame Adam step on a copy of ``params``, which stay as they
    are."""
    from audio_mps_tpu_torch.weights import params_to_numpy
    copy = from_numpy(params_to_numpy(params), params.A.device)
    ref.make_lab_train_step(cfg, mps_model, copy)[1](batch)
    del copy
    _free()


def lab_frame_phases(dev):
    """The lab-frame anchor (models/reference_transcription.py) on the
    card: psi's lab-frame Adam step at the primary cell beside the kernel
    path's (vs_baseline), the lab frame held to the kernel path on a prefix
    and over the whole length, and rho's lab step and its peak memory on a
    prefix."""
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models import reference_transcription as ref
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.tools.lab_frame_gap import psi_inputs
    from audio_mps_tpu_torch.training import make_train_step, nll_fn_for
    from audio_mps_tpu_torch.weights import (params_to_numpy,
                                             psi_params_from_numpy,
                                             rho_params_from_numpy)

    card = card_line()
    params, cfg, batch = psi_inputs(dev, LAB_T)
    phase(f"lab frame, psi (D={LAB_D}, B={LAB_B}, T={LAB_T}): held to the "
          f"kernel path on the T={LAB_T_PREFIX} prefix at rtol {TOL_LAB:g}; "
          f"one lab-frame Adam step on the T={LAB_T_STEP} prefix after a "
          f"warm-up (T={LAB_T_WARMUP}) beside the kernel path's step there; "
          f"the whole-length gap of the two NLLs [{card}]")
    prefix = batch[:, :LAB_T_PREFIX]
    with torch.no_grad():
        t0 = time.perf_counter()
        lab = ref.psi_nll_lab_frame(params, cfg, prefix).item()
        t_lab = _sync_ms(t0)
        kern = nll_fn_for("psi_mps")(params, cfg, prefix).item()
    rel = abs(lab - kern) / abs(kern)
    print(f"  prefix NLL: lab frame {lab:.8f} ({t_lab:.1f} ms, no "
          f"gradient), kernel path {kern:.8f}: {rel:.3e} relative (tol "
          f"{TOL_LAB:g}) [{card}]", flush=True)
    check(rel <= TOL_LAB, f"lab frame vs kernel path on the prefix: {rel}")
    with torch.no_grad():
        lab_nll = ref.psi_nll_lab_frame(params, cfg, batch).item()
        kern_nll = nll_fn_for("psi_mps")(params, cfg, batch).item()
    gap = abs(lab_nll - kern_nll) / abs(kern_nll)
    _lab_warmup(ref, cfg, "psi_mps", params, psi_params_from_numpy,
                batch[:, :LAB_T_WARMUP])
    step_batch = batch[:, :LAB_T_STEP].contiguous()
    lp = psi_params_from_numpy(params_to_numpy(params), dev)
    _, lab_step = ref.make_lab_train_step(cfg, "psi_mps", lp)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lab_step(step_batch)
    lab_ms = _sync_ms(t0)
    lab_peak = torch.cuda.max_memory_allocated(dev)
    del lp, lab_step
    _free()
    fp = psi_params_from_numpy(params_to_numpy(params), dev)
    _, step = make_train_step("psi_mps", cfg, fp, device=dev)
    step(step_batch)
    t0 = time.perf_counter()
    for _ in range(DATA_STEP_REPS):
        step(step_batch)
    fused_ms = _sync_ms(t0) / DATA_STEP_REPS
    frames = LAB_B * (LAB_T_STEP - 1)
    print(f"  lab-frame step at T={LAB_T_STEP} {lab_ms:.1f} ms host clock "
          f"({frames / lab_ms * 1e3:.4e} frames/s, peak "
          f"{lab_peak / 1e9:.3f} GB); kernel-path step {fused_ms:.2f} ms "
          f"(mean of {DATA_STEP_REPS} after a warm-up): vs_baseline "
          f"{lab_ms / fused_ms:.1f} [{card}]", flush=True)
    print(f"  whole-length NLL: lab frame {lab_nll:.8f}, kernel path "
          f"{kern_nll:.8f}: gap {gap:.3e} relative (limit "
          f"{LAB_GAP_LIMIT:g}, tools/lab_frame_gap.py)", flush=True)
    check(gap <= LAB_GAP_LIMIT, f"whole-length gap {gap:.3e}")
    del fp, step, params, batch, prefix, step_batch
    _free()

    rcfg = CMPSConfig(bond_dim=LAB_D, minibatch_size=LAB_RHO_B)
    phase(f"lab frame, rho (D={LAB_D}, rank {LAB_D}, B={LAB_RHO_B}, on the "
          f"T={LAB_RHO_T} prefix of rho's T=16384 cell; chunks of "
          f"{rcfg.scan_chunk} steps): one lab-frame Adam step after a "
          f"warm-up, its peak memory, beside the kernel path's step "
          f"[{card}]")
    rp = init_rho(torch.Generator(dev).manual_seed(42), rcfg, device=dev)
    rbatch = damped_sine_batch(torch.Generator(dev).manual_seed(43),
                               LAB_RHO_B, LAB_RHO_T, rcfg.delta_t)
    _lab_warmup(ref, rcfg, "rho_mps", rp, rho_params_from_numpy,
                rbatch[:, :LAB_T_WARMUP])
    lp = rho_params_from_numpy(params_to_numpy(rp), dev)
    _, lab_step = ref.make_lab_train_step(rcfg, "rho_mps", lp)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lab_nll = lab_step(rbatch)["model_loss"].item()
    lab_ms = _sync_ms(t0)
    lab_peak = torch.cuda.max_memory_allocated(dev)
    del lp, lab_step
    _free()
    fp = rho_params_from_numpy(params_to_numpy(rp), dev)
    _, step = make_train_step("rho_mps", rcfg, fp, device=dev)
    first = step(rbatch)
    t0 = time.perf_counter()
    for _ in range(DATA_STEP_REPS):
        step(rbatch)
    fused_ms = _sync_ms(t0) / DATA_STEP_REPS
    kern_nll = first["model_loss"].item()
    rel = abs(lab_nll - kern_nll) / abs(kern_nll)
    print(f"  lab-frame step {lab_ms:.1f} ms host clock "
          f"({lab_ms / (LAB_RHO_T - 1) * 1e3:.1f} us a step), peak "
          f"{lab_peak / 1e9:.3f} GB; kernel-path step {fused_ms:.2f} ms: "
          f"ratio {lab_ms / fused_ms:.1f}; NLL lab frame {lab_nll:.8f}, "
          f"kernel path {kern_nll:.8f} ({rel:.3e} relative, tol "
          f"{TOL_LAB:g}) [{card}]", flush=True)
    check(rel <= TOL_LAB, f"rho lab frame vs kernel path: {rel}")
    del fp, step, rp, rbatch
    _free()


# psi past the quad layout (BASELINE config 5 on one card): the cluster
# layout of psi's block kernels (ops/cluster.py, csrc/psi_cluster*.cu) at
# D=128, psi training at B=128, T=16385 (16384 steps), the train CLI's
# defaults otherwise (highest, deferred norm); scoring at B=128, T=16384;
# the sampler 8 chains x 65536 and one chain. The kernels are held to their
# plain versions on prefixes of the run (the plain versions launch ~10 small
# ops a step; the kernels' states are renormalised as the run's are): the
# main path's variant on WIDE_T_MAIN, the other three on WIDE_T_PREFIX; the
# widest D the layout takes, 256, at B=16 (a layout sweep's batch) on a
# short run.
WIDE_D, WIDE_B, WIDE_T = 128, 128, 16385
WIDE_T_MAIN, WIDE_T_PREFIX = 4097, 2048
WIDEST_D, WIDEST_B, WIDEST_T = 256, 16, 257
WIDE_OFF_STEPS = 1     # the kernel_stream=off CLI's first call
WIDE_REPLACES = {
    "psi_sample_cluster": "audio_mps_tpu/ops/pallas_block.py:2176",
    "psi_nll_cluster": "audio_mps_tpu/ops/pallas_block.py:2428",
    "psi_train_fwd_cluster": "audio_mps_tpu/ops/pallas_block.py:875",
    "psi_train_bwd_cluster": "audio_mps_tpu/ops/pallas_block.py:935",
    "psi_train_bwd_tail_cluster": "audio_mps_tpu/ops/pallas_block.py:935 "
                                  "(its batched tail)",
    "psi_train_fwd_ckpt_cluster": "audio_mps_tpu/ops/pallas_block.py:461",
    "psi_recompute_cluster": "audio_mps_tpu/ops/pallas_block.py:621"}
WIDE_SOURCES = {
    "psi_sample_cluster": "psi_cluster_sample.cu",
    "psi_train_bwd_cluster": "psi_cluster_bwd.cu",
    "psi_train_bwd_tail_cluster": "psi_cluster_bwd.cu"}


def _wide_holds(dev, params, cfg, T, variants, prefix):
    """The cluster kernels against their plain versions at ``cfg``'s width:
    each (precision, defer) of ``variants`` on the first ``prefix`` steps
    (None: the whole run), each kernel fed the plain versions' streams; the
    NLL's loss and the checkpoint forward's are the streamed forward's bit
    for bit, and the recompute of the kernel's checkpoints is its stream.
    Returns ({kernel: max|d|}, {kernel: plain ms}) of the last variant;
    at highest the reductions are held to their plain version in
    float64."""
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.ops import block

    B = cfg.minibatch_size
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(61), B, T,
                                cfg.delta_t)
    t_in = block.psi_nll_inputs(params, cfg, signals)
    eps = dict(log_eps=t_in.pop("log_eps"), norm_eps=t_in.pop("norm_eps"))
    g = torch.full((B,), 1.0 / B, device=dev)
    err_at, plain_ms = {}, {}
    for (prec, defer), steps in zip(variants, prefix):
        ins = (t_in if steps is None
               else dict(t_in, se=t_in["se"][:steps - 1].contiguous()))
        o = dict(eps, precision=prec, defer_norm=defer)
        r_o = dict(norm_eps=eps["norm_eps"], precision=prec, defer_norm=defer)
        mats = (ins["ab"], ins["bb"], ins["rb"])
        t_args = (ins["rb"], ins["se"])
        ms = {}
        ms["psi_train_fwd_cluster"], f_p = timed(
            lambda: block.psi_train_fwd_plain(**ins, **o))
        ms["psi_nll_cluster"] = ms["psi_train_fwd_cluster"]
        ms["psi_train_fwd_ckpt_cluster"], c_p = timed(
            lambda: block.psi_train_fwd_ckpt_plain(**ins, **o))
        ms["psi_recompute_cluster"], r_p = timed(
            lambda: block.psi_recompute_plain(*mats, c_p[1], ins["se"],
                                              **r_o))
        ms["psi_train_bwd_tail_cluster"], tail_p = timed(
            lambda: block.psi_train_bwd_tail_plain(*t_args, g, f_p[1],
                                                   f_p[2], **o))
        ms["psi_train_bwd_cluster"], b_p = timed(
            lambda: block.psi_train_bwd_plain(**ins, g=g, ys=f_p[1],
                                              n2s=f_p[2], **o))
        cot_in = (b_p[2], f_p[1], ins["t0"], ins["se"], f_p[2], b_p[3])
        ms["psi_cotangents"], cot_p = timed(
            lambda: block.psi_cotangents_plain(*cot_in, **r_o))
        del r_p
        tol = TOL_TRAIN[prec]
        line = []

        def hold(kernel, labels, got, want, tol_):
            worst = 0.0
            for label, a, b in zip(labels, got, want):
                check(bool(torch.isfinite(a).all()),
                      f"{kernel} {label}: non-finite")
                err, rel = rel_err(a, b)
                worst = max(worst, err)
                line.append(f"{label} {rel:.2e}")
                check(rel <= tol_, f"{kernel} {prec} defer={defer} {label}: "
                                   f"rel err {rel:.3e} (tol {tol_:g})")
            err_at[kernel] = worst

        f_k = block.psi_train_fwd(**ins, **o)
        check(block.psi_train_fwd.layout == "cluster",
              f"psi_train_fwd took the {block.psi_train_fwd.layout} layout")
        hold("psi_train_fwd_cluster", ("loss", "ys", "n2s"), f_k, f_p,
             tol["fwd"])
        nll = block.psi_nll_block(**ins, **o)
        check(torch.equal(nll, f_k[0]), "the cluster NLL's loss is not the "
                                        "training forward's bit for bit")
        err_at["psi_nll_cluster"] = rel_err(nll, f_p[0])[0]
        c_k = block.psi_train_fwd_ckpt(**ins, **o)
        check(torch.equal(c_k[0], f_k[0]), "the checkpoint forward's loss is "
                                           "not the streamed forward's")
        hold("psi_train_fwd_ckpt_cluster", ("ck",), c_k[1:], c_p[1:],
             tol["fwd"])
        r_k = block.psi_recompute(*mats, c_k[1], ins["se"], **r_o)
        check(torch.equal(r_k[0], f_k[1]) and torch.equal(r_k[1], f_k[2]),
              "the recompute of the kernel's checkpoints is not its stream")
        r_pk = block.psi_recompute_plain(*mats, c_k[1], ins["se"], **r_o)
        hold("psi_recompute_cluster", ("rec ys", "rec n2s"), r_k, r_pk,
             TOL_RECOMPUTE[prec])
        del f_k, c_k, r_k, r_pk
        tail_k = block.psi_train_bwd_tail(*t_args, g, f_p[1], f_p[2], **o)
        hold("psi_train_bwd_tail_cluster", ("q", "ds0", "dehat", "dn2_new"),
             tail_k, tail_p, tol["bwd"])
        del tail_k, tail_p
        b_k = block.psi_train_bwd(**ins, g=g, ys=f_p[1], n2s=f_p[2], **o)
        hold("psi_train_bwd_cluster", ("dse", "dt0", "dy", "dehat"), b_k,
             b_p, tol["bwd"])
        del b_k
        cot_k = block.psi_cotangents(*cot_in, **r_o)
        if prec == "highest":
            # the reductions sum (T-1) B terms an element in fp32, the
            # kernel and the plain version in two orders (over the whole
            # D=128, B=128, T=16385 run, 2.1e6 terms, they differed by
            # 2.6e-5 of the largest element): at highest the kernel is held
            # to the plain version in float64
            cot_64 = block.psi_cotangents_plain(
                *(x.double() for x in cot_in), **r_o)
            p_64 = max(rel_err(a.double(), b)[1]
                       for a, b in zip(cot_p, cot_64))
            line.append(f"(fp32 plain vs float64 {p_64:.2e})")
            hold("psi_cotangents", ("dAb/f64", "dBb/f64", "dRb/f64"),
                 [a.double() for a in cot_k], cot_64, tol["cot"])
            del cot_64
        else:
            hold("psi_cotangents", ("dAb", "dBb", "dRb"), cot_k, cot_p,
                 tol["cot"])
        torch.cuda.synchronize()
        print(f"  {prec} defer_norm={defer}, T="
              f"{ins['se'].shape[0] + 1} (tol fwd {tol['fwd']:g}, bwd "
              f"{tol['bwd']:g}, cot {tol['cot']:g}, recompute "
              f"{TOL_RECOMPUTE[prec]:g}), x max|plain|: " + ", ".join(line),
              flush=True)
        plain_ms = ms
        del f_p, c_p, b_p, cot_p, cot_in, cot_k
        _free()
    return err_at, plain_ms


def wide_phases(dev):
    """psi past the quad layout of its block kernels: the cluster layout at
    D=128 (training, recompute, scoring and sampling at the full width of
    BASELINE config 5 on one card) and at D=256. Returns the cluster
    kernels' entries of the {"kernels": [...]} line."""
    from audio_mps_tpu_torch.config import CMPSConfig
    from audio_mps_tpu_torch.data import damped_sine_batch
    from audio_mps_tpu_torch.models import core
    from audio_mps_tpu_torch.models.params import init_psi
    from audio_mps_tpu_torch.ops import block, cluster as cl
    from audio_mps_tpu_torch.ops.scan import DEFAULT_UNROLL, psi_nll_fused
    from audio_mps_tpu_torch.sample import SampleConfig, sample
    from audio_mps_tpu_torch.weights import save_params

    Dw, B, T = WIDE_D, WIDE_B, WIDE_T
    n = 2 * Dw
    props = torch.cuda.get_device_properties(dev)
    sms, optin = props.multi_processor_count, \
        props.shared_memory_per_block_optin
    lay = cl.psi_block_layout(Dw, B, sms, optin)
    c_sample = cl.psi_sample_cluster_for(Dw, optin)
    card = card_line()
    cfg = CMPSConfig(bond_dim=Dw, minibatch_size=B)
    params = init_psi(torch.Generator(dev).manual_seed(60), cfg, device=dev)
    main = (cfg.kernel_precision, cfg.defer_norm)
    variants = [(p, d) for p in ("highest", "high") for d in (False, True)
                if (p, d) != main] + [main]

    phase(f"psi at D={Dw} in the cluster layout ({lay[1]} CTAs a cluster, "
          f"{lay[2]} columns a cluster at B={B} on this card; the sampler "
          f"{c_sample} CTAs a chain): the kernels vs plain, the main path's "
          f"variant {main} on the T={WIDE_T_MAIN} prefix of T={T}, the other "
          f"three on a T={WIDE_T_PREFIX} prefix; the cotangent reduction at "
          f"D={Dw} too [{card}]")
    check(lay[0] == "cluster", f"the rule took {lay} at D={Dw}")
    err_at, plain_ms = _wide_holds(
        dev, params, cfg, T, variants,
        [WIDE_T_PREFIX] * (len(variants) - 1) + [WIDE_T_MAIN])
    print(f"  plain versions at T={WIDE_T_MAIN} {main}: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in plain_ms.items())
        + " (CUDA events, one run)", flush=True)

    wcfg = CMPSConfig(bond_dim=WIDEST_D, minibatch_size=WIDEST_B)
    wlay = cl.psi_block_layout(WIDEST_D, WIDEST_B, sms, optin)
    w_sample = cl.psi_sample_cluster_for(WIDEST_D, optin)
    phase(f"psi at D={WIDEST_D}, the widest the cluster layout takes "
          f"({wlay[1]} CTAs a cluster, {wlay[2]} columns a cluster): B="
          f"{WIDEST_B}, T={WIDEST_T}, both precisions and norms, the kernels "
          f"vs plain; the sampler ({w_sample} CTAs a chain) over "
          f"{T_PREFIX} steps")
    wparams = init_psi(torch.Generator(dev).manual_seed(63), wcfg,
                       device=dev)
    _wide_holds(dev, wparams, wcfg, WIDEST_T, variants,
                [None] * len(variants))
    noise = core._sample_noise(wcfg, torch.Generator(dev).manual_seed(64),
                               2, T_PREFIX, 1.0)
    w_in = block.psi_sample_inputs(wparams, wcfg, noise)
    for prec in ("highest", "high"):
        err, rel = rel_err(block.psi_sample_block(**w_in, precision=prec),
                           block.psi_sample_block_plain(**w_in,
                                                        precision=prec))
        print(f"  sampler {prec}: {rel:.3e} x max|plain| (tol "
              f"{TOL[prec]:g})", flush=True)
        check(rel <= TOL[prec], f"the D={WIDEST_D} sampler {prec}: rel err "
                                f"{rel:.3e}")
    del wparams, w_in, noise
    _free()

    phase(f"psi sampler at D={Dw} (the cluster body): kernel vs plain, "
          f"{N_CHAINS} chains and one, on the T={T_PLAIN} prefix of "
          f"T={T_SAMPLE}")
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(62),
                               N_CHAINS, T_SAMPLE, 1.0)
    s_in = block.psi_sample_inputs(params, cfg, noise)
    s_short = dict(s_in, noise=s_in["noise"][:T_PLAIN].contiguous())
    s_one = dict(s_in, noise=s_in["noise"][:, :1].contiguous(),
                 t0=s_in["t0"][:, :1].contiguous())
    s_one_short = dict(s_one, noise=s_one["noise"][:T_PLAIN].contiguous())
    for prec in ("highest", "high"):
        for tag, ins in ((f"{N_CHAINS} chains", s_short),
                         ("one chain", s_one_short)):
            got = block.psi_sample_block(**ins, precision=prec)
            check(block.psi_sample_block.body == "cluster",
                  f"the sampler took the {block.psi_sample_block.body} body")
            if prec == "highest" and tag != "one chain":
                plain_ms["psi_sample_cluster"], want = timed(
                    lambda: block.psi_sample_block_plain(**ins,
                                                         precision=prec))
            else:
                want = block.psi_sample_block_plain(**ins, precision=prec)
            err, rel = rel_err(got, want)
            if prec == "highest" and tag != "one chain":
                err_at["psi_sample_cluster"] = err
            print(f"  {prec}, {tag}: {rel:.3e} x max|plain| over {T_PLAIN} "
                  f"steps (tol {TOL[prec]:g})", flush=True)
            check(rel <= TOL[prec], f"the D={Dw} sampler {prec} {tag}: rel "
                                    f"err {rel:.3e}")
    del s_short, s_one_short

    phase(f"psi training at D={Dw}: train CLI (B={B}, T={T}), "
          f"{TRAIN_STEPS} steps, then a restore and one more step, the "
          f"summaries sampling through the cluster sampler")
    per_step = {"psi_train_fwd_cluster": 1, "psi_train_bwd_cluster": 1,
                "psi_train_bwd_tail_cluster": 1, "psi_cotangents": 1}
    cl.psi_sample_cluster.launches = 0
    launches = train_cli_phase(dev, "psi_mps", cfg, T, TRAIN_STEPS, per_step)
    _summary_samples(cl.psi_sample_cluster, 2)
    reps = 3
    step_ms, step_peak = time_train_step(dev, "psi_mps", cfg, params, T, 65,
                                         reps)
    print(f"  psi train step at D={Dw} (make_train_step, batch draw "
          f"included): {step_ms:.2f} ms host clock, mean of {reps} after a "
          f"warm-up; {B * (T - 1) / step_ms * 1e3:.4e} frames/s; peak "
          f"{step_peak / 1e9:.3f} GB", flush=True)

    phase(f"psi training at D={Dw} without the stream: train CLI "
          f"(kernel_stream=off, B={B}, T={T}), {WIDE_OFF_STEPS} step, then a "
          f"restore and one more")
    cfg_off = dataclasses.replace(cfg, kernel_stream="off")
    per_off = {"psi_train_fwd_ckpt_cluster": 1,
               "psi_recompute_cluster": None, "psi_train_bwd_cluster": None,
               "psi_train_bwd_tail_cluster": None, "psi_cotangents": None}
    cl.psi_sample_cluster.launches = 0
    off_launches = train_cli_phase(dev, "psi_mps", cfg_off, T,
                                   WIDE_OFF_STEPS, per_off)
    _summary_samples(cl.psi_sample_cluster, 2)
    segments = len(block.recompute_segments(T - 1, DEFAULT_UNROLL))
    for k in ("psi_recompute_cluster", "psi_train_bwd_cluster"):
        check(off_launches[k] == segments * (WIDE_OFF_STEPS + 1),
              f"{k} launched {off_launches[k]} times off the stream "
              f"({segments} segments a step)")
    launches["psi_train_fwd_ckpt_cluster"] = \
        off_launches["psi_train_fwd_ckpt_cluster"]
    launches["psi_recompute_cluster"] = off_launches["psi_recompute_cluster"]

    phase(f"psi serving at D={Dw}: scoring (psi_nll_fused, B={B}, "
          f"T={T_NLL}) and the sample CLI (fused, {N_CHAINS} x {T_SAMPLE})")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"cfg": dataclasses.asdict(cfg),
                       "run": {"mps_model": "psi_mps"}}, f)
        save_params(os.path.join(tmp, "params.npz"), params)
        cl.psi_nll_cluster.launches = 0
        cl.psi_sample_cluster.launches = 0
        batch = damped_sine_batch(torch.Generator(dev).manual_seed(66), B,
                                  T_NLL, cfg.delta_t)
        t0 = time.perf_counter()
        nll = psi_nll_fused(params, cfg, batch).item()
        t_score = _sync_ms(t0)
        t0 = time.perf_counter()
        waves = sample(SampleConfig(modeldir=tmp, num_samples=N_CHAINS,
                                    sample_duration=T_SAMPLE, fused=True,
                                    device="cuda",
                                    out=os.path.join(tmp, "samples.npz")))
        t_sample = _sync_ms(t0)
        launches["psi_nll_cluster"] = cl.psi_nll_cluster.launches
        launches["psi_sample_cluster"] = cl.psi_sample_cluster.launches
    print(f"  NLL {nll:.6f} in {t_score:.1f} ms; sample CLI {waves.shape} in "
          f"{t_sample:.1f} ms (host clock); launches nll "
          f"{launches['psi_nll_cluster']}, sampler "
          f"{launches['psi_sample_cluster']}", flush=True)
    check(math.isfinite(nll), f"NLL {nll}")
    check(waves.shape == (N_CHAINS, T_SAMPLE), f"waves {waves.shape}")
    check(bool(torch.isfinite(torch.as_tensor(waves)).all()),
          "sampled waveforms are not finite")
    for k in ("psi_nll_cluster", "psi_sample_cluster"):
        check(launches[k] == 1, f"{k} launched {launches[k]} times")
    del batch, waves

    phase(f"psi at D={Dw} timings (CUDA events, median of 5 after 1 "
          f"warm-up; the recompute over the run's {segments} segments) "
          f"[{card}]")
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(61), B, T,
                                cfg.delta_t)
    t_in = block.psi_nll_inputs(params, cfg, signals)
    eps = dict(log_eps=t_in.pop("log_eps"), norm_eps=t_in.pop("norm_eps"))
    o = dict(eps, precision=main[0], defer_norm=main[1])
    r_o = dict(norm_eps=eps["norm_eps"], precision=main[0],
               defer_norm=main[1])
    g = torch.full((B,), 1.0 / B, device=dev)
    loss, ys, n2s = block.psi_train_fwd(**t_in, **o)
    _, ck = block.psi_train_fwd_ckpt(**t_in, **o)
    mats = (t_in["ab"], t_in["bb"], t_in["rb"])
    seg = block.recompute_segments(T - 1, DEFAULT_UNROLL)

    def recompute_run():
        for k0, k1 in seg:
            b0 = k0 // DEFAULT_UNROLL
            block.psi_recompute(
                *mats, ck[b0:b0 + block.n_blocks(k1 - k0, DEFAULT_UNROLL)],
                t_in["se"][k0:k1], **r_o)

    ms = {"psi_sample_cluster": median_ms(
              lambda: block.psi_sample_block(**s_in)),
          "psi_nll_cluster": median_ms(
              lambda: block.psi_nll_block(**t_in, **o)),
          "psi_train_fwd_cluster": median_ms(
              lambda: block.psi_train_fwd(**t_in, **o)),
          "psi_train_fwd_ckpt_cluster": median_ms(
              lambda: block.psi_train_fwd_ckpt(**t_in, **o)),
          "psi_recompute_cluster": median_ms(recompute_run),
          "psi_train_bwd_tail_cluster": median_ms(
              lambda: block.psi_train_bwd_tail(t_in["rb"], t_in["se"], g, ys,
                                               n2s, **o)),
          "psi_train_bwd_cluster": median_ms(
              lambda: block.psi_train_bwd(**t_in, g=g, ys=ys, n2s=n2s, **o))}
    one_ms = median_ms(lambda: block.psi_sample_block(**s_one))
    # the per-step norm (defer_norm=False, the TPU's :461 / :529) at
    # highest: a second cluster barrier a step in both
    o_s = dict(o, defer_norm=False)
    _, ys_s, n2s_s = block.psi_train_fwd(**t_in, **o_s)
    per_step_ms = (median_ms(lambda: block.psi_train_fwd(**t_in, **o_s)),
                   median_ms(lambda: block.psi_train_bwd(
                       **t_in, g=g, ys=ys_s, n2s=n2s_s, **o_s)))
    del ys_s, n2s_s
    # the whole recompute adjoint (its 32 segments' recompute, adjoint and
    # reductions), the path of kernel_stream="off"; bound: 2 + 4 + 3
    # products a column-step
    rec_bwd_ms = median_ms(lambda: block.psi_recompute_bwd(
        *mats, ck, t_in["se"], g, **o))
    rec_bwd_bound = bound_ms(9 * 2 * n * n * (T - 1) * B, 4 * (
        (T - 1) * B * (2 * n + 4) + 3 * n * n + ck.numel()))
    _, _, dy, dehat = block.psi_train_bwd(**t_in, g=g, ys=ys, n2s=n2s, **o)
    cot_ms = median_ms(lambda: block.psi_cotangents(
        dy, ys, t_in["t0"], t_in["se"], n2s, dehat, **r_o))
    def lanes(x):
        return x.transpose(0, 1).reshape(n, -1)

    # the tail's yardsticks on operands built once (fp32, TF32 off): the
    # one [2D,2D] x [2D, (T-1) B] product it forms, S Y with S = Rb + Rb^T,
    # as torch.matmul (the kernels line's library_ms), and the two of the
    # plain version, Rb Y and Rb^T U
    lanes_y = lanes(ys)
    s_mat = t_in["rb"] + t_in["rb"].T
    tail_lib_ms = median_ms(lambda: s_mat @ lanes_y)
    lanes_u = lanes(2.0 * dehat[:, None, :] * ys)
    rbT = t_in["rb"].T.contiguous()
    tail_lib2_ms = median_ms(lambda: (t_in["rb"] @ lanes_y, rbT @ lanes_u))
    del lanes_y, lanes_u, s_mat, rbT
    _free()
    # the reductions' yardstick at D=128: their three [2D, M] x [M, 2D]
    # products as torch.matmul
    ts = block._input_states(t_in["t0"], ys, block._state_scales(
        n2s, norm_eps=eps["norm_eps"], unroll=DEFAULT_UNROLL,
        defer_norm=main[1]))
    ops = [(lanes(dy), lanes(ts)),
           (lanes(dy), lanes(t_in["se"][:, None, :] * ts))]
    del ts
    ops.append((lanes(2.0 * dehat[:, None, :] * ys), lanes(ys)))
    cot_lib_ms = median_ms(lambda: [a @ b.T for a, b in ops])
    del ops, dy, dehat, ck
    _free()
    # bounds: FLOPs the fewest [2D,2D] products a column-step (2 n^2 each):
    # the forwards 3 (Ab t, Bb t, Rb y), the recompute 2, the adjoint 3 (its
    # tail 1: (Rb + Rb^T) y; its chain 2: Ab^T dy and Bb^T dy), the sampler
    # 2 a chain-step; bytes: each input read once, each output written once
    steps = T - 1
    lane_steps = steps * B
    mats_b = 3 * n * n
    prods = {"psi_train_fwd_cluster": 3, "psi_nll_cluster": 3,
             "psi_train_fwd_ckpt_cluster": 3, "psi_recompute_cluster": 2,
             "psi_train_bwd_cluster": 3, "psi_train_bwd_tail_cluster": 1}
    n_ck = block.n_blocks(steps, DEFAULT_UNROLL) * n * B
    nbytes = {"psi_train_fwd_cluster": lane_steps * (n + 2) + mats_b + n * B
              + B,
              "psi_nll_cluster": lane_steps + mats_b + n * B + B,
              "psi_train_fwd_ckpt_cluster": lane_steps + mats_b + n * B + B
              + n_ck,
              "psi_recompute_cluster": lane_steps * (n + 2) + 2 * n * n
              + n_ck,
              "psi_train_bwd_tail_cluster": 2 * lane_steps * n
              + 5 * lane_steps + n * n + B,
              "psi_train_bwd_cluster": 2 * lane_steps * n + 4 * lane_steps
              + mats_b + 2 * n * B + B}
    entries = []
    for name in WIDE_REPLACES:
        if name == "psi_sample_cluster":
            flops = T_SAMPLE * N_CHAINS * 2 * (2 * n * n)
            nb = 2 * T_SAMPLE * N_CHAINS + 2 * n * n + n * N_CHAINS + n + 1
        else:
            flops = prods[name] * 2 * n * n * lane_steps
            nb = nbytes[name]
        bound, by = bound_ms(flops, 4 * nb)
        entries.append({
            "name": name, "route": "cuda",
            "source": "audio_mps_tpu_torch/csrc/"
                      + WIDE_SOURCES.get(name, "psi_cluster_fwd.cu"),
            "replaces": WIDE_REPLACES[name], "launches": launches[name],
            "max_abs_err": err_at[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": bound, "bound_by": by,
            "library_ms": (tail_lib_ms if name == "psi_train_bwd_tail_cluster"
                           else None)})
        at = (f"T={T_PLAIN}" if name == "psi_sample_cluster"
              else f"T={WIDE_T_MAIN}")
        print(f"  {name}: {ms[name]:.3f} ms, launches {launches[name]} (plain "
              f"{plain_ms[name]:.1f} ms at {at}, bound {bound:.3f} ms by "
              f"{by}, {bound / ms[name] * 100:.1f}% of it)", flush=True)
    print(f"  defer_norm=False (highest): psi_train_fwd_cluster "
          f"{per_step_ms[0]:.3f} ms, psi_train_bwd_cluster "
          f"{per_step_ms[1]:.3f} ms; the whole recompute adjoint "
          f"{rec_bwd_ms:.3f} ms (bound {rec_bwd_bound[0]:.3f} ms by "
          f"{rec_bwd_bound[1]})", flush=True)
    print(f"  psi_sample_cluster one chain: {one_ms:.3f} ms "
          f"({one_ms / T_SAMPLE * 1e3:.3f} us a step); {N_CHAINS} chains "
          f"{ms['psi_sample_cluster'] / T_SAMPLE * 1e3:.3f} us a step",
          flush=True)
    in_kernels = (ms["psi_train_fwd_cluster"] + ms["psi_train_bwd_cluster"]
                  + cot_ms)
    print(f"  psi_train_bwd_tail_cluster vs torch.matmul of its product "
          f"(Rb + Rb^T) Y: {ms['psi_train_bwd_tail_cluster']:.3f} / "
          f"{tail_lib_ms:.3f} ms (the plain version's two, Rb Y and Rb^T U: "
          f"{tail_lib2_ms:.3f} ms); psi_cotangents at D={Dw}: {cot_ms:.3f} "
          f"ms (plain {plain_ms['psi_cotangents']:.1f} ms, torch.matmul x3 "
          f"{cot_lib_ms:.3f} ms); train step "
          f"{step_ms:.2f} ms, of which the forward, the adjoint and the "
          f"reductions {in_kernels:.2f} ms [{card}]", flush=True)
    del loss, ys, n2s, t_in, s_in, s_one, params
    _free()
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

    phase("set-up")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = _build.build()
    BUILD["log"] = built["log"]
    print(f"kernel build: {built['seconds']:.1f} s (rebuilt="
          f"{built['rebuilt']}) -> {built['path']}", flush=True)
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)
    _build.library()
    from audio_mps_tpu_torch.tools import split_adjoint_attribution
    SPLIT_ATTRIBUTION["builds"] = split_adjoint_attribution.start_builds()

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

    phase(f"NLL kernel vs plain (D={D}, B={B_NLL}): the scoring variant "
          f"(highest, per-step norm) at T={T_NLL}, the other three on a "
          f"T={T_PREFIX} prefix")
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(2), B_NLL,
                                T_NLL, cfg.delta_t)
    n_in = block.psi_nll_inputs(params, cfg, signals)
    n_pre = dict(n_in, se=n_in["se"][:T_PREFIX - 1].contiguous())
    nll_err = {}
    for prec in ("highest", "high"):
        for defer in (False, True):
            ins = n_in if (prec, defer) == ("highest", False) else n_pre
            got = block.psi_nll_block(**ins, precision=prec,
                                      defer_norm=defer)
            want = block.psi_nll_block_plain(**ins, precision=prec,
                                             defer_norm=defer)
            check(bool(torch.isfinite(got).all()), "NLL kernel: non-finite")
            err, rel = rel_err(got, want)
            nll_err[f"{prec}/defer={defer}"] = err
            print(f"  {prec} defer_norm={defer}, T={ins['se'].shape[0] + 1}: "
                  f"max|d| {err:.3e} = {rel:.3e} x max|plain| (tol "
                  f"{TOL[prec]:g}); mean loss {got.mean().item():.6f}",
                  flush=True)
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

    fam = Family(
        name="psi", params=params, cfg=cfg, B=B_NLL, T=T_NLL, seed=4,
        ref_cols=8, reference=core.psi_nll, dehat_scale=2.0,
        replaces={"fwd": "audio_mps_tpu/ops/pallas_block.py:875",
                  "bwd": "audio_mps_tpu/ops/pallas_block.py:935",
                  "cot": "audio_mps_tpu/ops/pallas_block.py:1035",
                  "ckpt": "audio_mps_tpu/ops/pallas_block.py:461",
                  "rec": "audio_mps_tpu/ops/pallas_block.py:621"})
    train_entries = train_phases(dev, fam)
    _free()
    train_entries += recompute_phases(dev, fam, PSI_OFF_B)
    _free()
    psi_columns_phases(dev, fam, PSI_OFF_B)
    _free()
    cot_library_ms = next(e["library_ms"] for e in train_entries
                          if e["name"] == "psi_cotangents")
    train_entries += batched_phases(dev, fam, cot_library_ms)
    _free()
    train_entries += probe_phases(dev)

    phase("timings (CUDA events, median of 5 after 1 warm-up)")
    n = 2 * D
    sample_ms = median_ms(
        lambda: block.psi_sample_block(**s_in, precision="highest"))
    s_one = dict(s_in, noise=s_in["noise"][:, :1].contiguous(),
                 t0=s_in["t0"][:, :1].contiguous())
    sample_one_ms = median_ms(
        lambda: block.psi_sample_block(**s_one, precision="highest"))
    print(f"  psi_sample_block ({block.psi_sample_block.body} body): "
          f"{N_CHAINS} chains {sample_ms:.3f} ms "
          f"({sample_ms / T_SAMPLE * 1e3:.3f} us a step), one chain "
          f"{sample_one_ms:.3f} ms ({sample_one_ms / T_SAMPLE * 1e3:.3f} us "
          f"a step)", flush=True)
    # plain versions: one run each, the sampler's on the T_PLAIN prefix it
    # is held on (its whole run takes ~18 s, 3% of the script's limit)
    sample_plain_ms = median_ms(
        lambda: block.psi_sample_block_plain(**s_short, precision="highest"),
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
    print(f"  the sampler's plain version at T={T_PLAIN}", flush=True)
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.1f} "
              f"ms, bound {k['bound_ms']:.3f} ms by {k['bound_by']})",
              flush=True)
    del s_in, s_one, n_in, noise, signals, wave
    _free()
    wide_entries = wide_phases(dev)
    _free()
    split_entries = split_phases(dev)
    _free()
    split_entries += rho_split_phases(dev)
    _free()
    rho_entries = rho_phases(dev)
    _free()
    rank_entries, streamed = rank_phases(dev)
    _free()
    rank_entries += rank_recompute_phases(dev, streamed)
    _free()
    with tempfile.TemporaryDirectory() as tmp:
        data_plane_phases(dev, tmp)
        file_training_phases(dev, tmp)
    _free()
    lab_frame_phases(dev)
    print(f"total {time.perf_counter() - T_START:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels + train_entries + wide_entries
                      + split_entries + rho_entries + rank_entries}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
