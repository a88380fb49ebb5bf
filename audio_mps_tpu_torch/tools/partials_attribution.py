"""What holds the rank partials kernels' step time on the card.

It times the partials forward (``csrc/rank_partials_fwd.cu``, the streamed
mode) and adjoint (``csrc/rank_partials_bwd.cu``, tail and chain) at the
D=256 model's shape (full rank, B=8, chunks of 16 rows: 128 CTAs) as built
and as two variants of the same sources with one part of the pipeline of
``csrc/rank_partials.cuh`` switched off:

  built     the kernels the training path runs
  products  no copies and no waits on the ring: the products over whatever
            the ring holds (their results are not used)
  copies    the ring's copies and waits, no products

each at clusters of 1 and 2 CTAs, at highest and high (CUDA events, the
median of 3 runs after a warm-up), printed as ms and us a step. The
variants are built with nvcc into ``build/attribution/`` from the sources
patched in memory (a patch raises when the source no longer holds the line
it replaces). It needs an NVIDIA card and the CUDA toolkit.

    python -m audio_mps_tpu_torch.tools.partials_attribution [--steps=512]
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys

import torch

from ..config import CMPSConfig
from ..data import damped_sine_batch
from ..models.params import init_rho
from ..ops import _build, rank

D, B, RC = 256, 8, 16
PRECISIONS = ("highest", "high")
CLUSTERS = (1, 2)
# (line of rank_partials.cuh, its replacement) a variant applies
PATCHES = {
    "products": (
        ("    mbar_wait(sm.full + stg, (q / kStages) & 1);",
         "    if (false) mbar_wait(sm.full + stg, (q / kStages) & 1);"),
        ("    if (cs == 1) {\n"
         "      if (lane == 0) mbar_arrive(sm.empty + stg);",
         "    if (true) {\n"
         "      if (false) mbar_arrive(sm.empty + stg);"),
        ("  const uint32_t cs = cluster_size(), rank = cluster_rank();",
         "  return;\n"
         "  const uint32_t cs = cluster_size(), rank = cluster_rank();")),
    "copies": (
        ("    if (tl.active) {\n"
         "      const int rows = n - j0 < ks ? n - j0 : ks;",
         "    if (false) {\n"
         "      const int rows = n - j0 < ks ? n - j0 : ks;"),),
}
ENTRIES = ("amt_rank_partials_fwd", "amt_rank_partials_bwd")


def build_variants() -> dict:
    """{variant: the loaded library}: "built" is the port's own library,
    the others compiled from patched copies of csrc/, all at once."""
    out = _build.ROOT / "build" / "attribution"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, patches in PATCHES.items():
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        header = src / "rank_partials.cuh"
        text = header.read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: rank_partials.cuh no "
                                   f"longer holds {old!r}")
            text = text.replace(old, new)
        header.write_text(text)
        lib = out / f"lib_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             str(src / "rank_partials_fwd.cu"),
             str(src / "rank_partials_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"built": _build.library()}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        for entry in ENTRIES:
            fn = getattr(libs[name], entry)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry]
    return libs


def median_ms(fn, reps: int = 3) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("partials_attribution: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)

    cfg = CMPSConfig(bond_dim=D, minibatch_size=B)
    params = init_rho(torch.Generator(dev).manual_seed(20), cfg, device=dev)
    L = args.steps
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(21), B,
                                L + 1, cfg.delta_t)
    ins, _ = rank.partials_inputs(params, cfg, signals, RC)
    ab, bb, xb, t0, se = (ins[k] for k in ("ab", "bb", "xb", "t0", "se"))
    n, cols = t0.shape
    S = cols // RC
    abt, bbt, xbt = (m.t().contiguous() for m in (ab, bb, xb))
    xs = xb + xb.t()
    eh, tr = se.new_empty((L, S)), se.new_empty((L, S))
    tfin, dt0 = torch.empty_like(t0), torch.empty_like(t0)
    ys = se.new_empty((L, n, cols))
    dys, dse = torch.empty_like(ys), se.new_empty((L, S))
    gen = torch.Generator(dev).manual_seed(22)
    deh, dtr = (torch.randn(L, S, generator=gen, device=dev)
                for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [x.data_ptr() for x in (abt, bbt, xbt, t0, se, eh, tr, tfin, ys)]
    bptr = [x.data_ptr() for x in (xs, ab, bb, t0, se, ys, tr, deh, dtr,
                                   torch.zeros_like(t0), dse, dt0, dys)]
    eps = float(cfg.norm_eps)

    def run(fn, *a):
        err = fn(*a, D, L, B, S, RC, 16, eps, *opts, stream)
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")

    # the built forward writes the ys and tr the adjoints read; the timed
    # forwards write elsewhere
    opts = (0, 1)
    run(libs["built"].amt_rank_partials_fwd, *ptr)
    fwd_out = ptr[:5] + [x.data_ptr() for x in (dse, dse, dt0, dys)]
    print(f"rank partials at D={D}, rank {D}, B={B}, chunks of {RC} rows "
          f"({S} CTAs), {L} steps; median of 3 CUDA-event runs", flush=True)
    for prec in PRECISIONS:
        for cs in CLUSTERS:
            opts = (rank.PRECISIONS.index(prec), cs)
            line = []
            for name, lib in libs.items():
                f_ms = median_ms(lambda: run(lib.amt_rank_partials_fwd,
                                             *fwd_out))
                b_ms = median_ms(lambda: run(lib.amt_rank_partials_bwd,
                                             *bptr))
                line.append(f"{name} fwd {f_ms:.2f} ms "
                            f"({f_ms / L * 1e3:.2f} us/step), bwd "
                            f"{b_ms:.2f} ms ({b_ms / L * 1e3:.2f} us/step)")
            print(f"  {prec}, clusters of {cs}: " + "; ".join(line),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
