"""What holds the split adjoints' step time on the card.

It times psi's and rho's split adjoints (``csrc/psi_split_bwd.cu``,
``csrc/rho_split_bwd.cu``) at the legacy estimator's shape (D=10, B=32,
T=65536; rho at full rank 10; highest, deferred norm, unroll 16):

  built     the kernels the training path runs, in each form (psi) and
            each (placement, form) (rho) the plans can pick
  rerun     the re-run of the blocks alone
  sweep     the sweep alone (over whatever the slabs hold)
  outer     the outer products alone

the last three in the form and placement the plan picks at this shape,
from builds of the same sources with ``-DAMT_SPLIT_BWD_PARTS`` = 1, 2 and
4 into ``build/attribution/split/`` (the hand-overs between the roles
stay), plus rho's sweep alone with its slabs in the workspace, and the
training forward (``psi_split_fwd``, ``rho_split_fwd``) beside them. CUDA
events, the median of 3 runs after a warm-up, printed as ms and us a step
with the card's name and power limit, then one JSON line. It needs an
NVIDIA card and the CUDA toolkit.

    python -m audio_mps_tpu_torch.tools.split_adjoint_attribution [--steps=65536]
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from ..config import CMPSConfig
from ..data import damped_sine_batch
from ..models.params import init_psi, init_rho
from ..ops import _build, split

D, B, T, UNROLL = 10, 32, 65536, 16
PARTS = {"rerun": 1, "sweep": 2, "outer": 4}
# the adjoints, and the source that carries amt_error_string
SOURCES = ("psi_split_bwd.cu", "rho_split_bwd.cu", "psi_sample.cu")


def start_builds() -> dict:
    """Start nvcc on each part's build, one process a source, all at once;
    returns {part: (library path, [(object, process)])}."""
    out = _build.ROOT / "build" / "attribution" / "split"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    builds = {}
    for part, mask in PARTS.items():
        objs = []
        for name in SOURCES:
            obj = out / f"{part}_{name}.o"
            objs.append((obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, f"-DAMT_SPLIT_BWD_PARTS={mask}",
                 "-c", str(_build.CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        builds[part] = (out / f"lib_{part}.so", objs)
    return builds


def load_builds(builds: dict) -> dict:
    """Wait for ``start_builds``'s processes, link each part and load it:
    {part: library}, with the signatures of ``ops/_build.py``."""
    libs = {}
    for part, (lib, objs) in builds.items():
        for obj, proc in objs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {obj.name}:\n{log}")
        link = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
             *[str(obj) for obj, _ in objs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed on {part}:\n{link.stdout}")
        cdll = ctypes.CDLL(str(lib))
        for name, (argtypes, restype) in _build._SIGNATURES.items():
            fn = getattr(cdll, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, restype
        libs[part] = cdll
    return libs


@contextlib.contextmanager
def _library(lib):
    """Route the wrappers' launches to ``lib``."""
    keep = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = keep


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


def _signals(dev, steps):
    return damped_sine_batch(torch.Generator(dev).manual_seed(22), B, steps,
                             1e-3)


def measure_psi(dev, libs: dict, steps: int = T) -> dict:
    """psi's timings (ms): the forward, the adjoint built in each form, and
    each part alone in the plan's form."""
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B, delta_t=1e-3)
    params = init_psi(torch.Generator(dev).manual_seed(20), cfg, device=dev)
    ins = split.psi_split_inputs(params, cfg, _signals(dev, steps))
    args = [ins[k] for k in ("cr", "ci", "rr", "ri", "pc", "ps", "s0r",
                             "s0i", "se")]
    o = dict(log_eps=ins["log_eps"], norm_eps=ins["norm_eps"],
             unroll=UNROLL, defer_norm=True)
    g = torch.full((B,), 1.0 / B, device=dev)
    _, ckr, cki = split.psi_split_fwd(*args, **o)
    plan = split.psi_split_bwd_plan(
        D, UNROLL, torch.cuda.get_device_properties(dev)
        .shared_memory_per_block_optin)

    def bwd(form):
        return lambda: split.psi_split_bwd(*args[:6], args[8], g, ckr, cki,
                                           **o, _form=form)

    res = {"plan": plan,
           "forward": median_ms(lambda: split.psi_split_fwd(*args, **o))}
    for form in split.SPLIT_BWD_FORMS:
        res[f"built {form}"] = median_ms(bwd(form))
    for part, lib in libs.items():
        with _library(lib):
            res[f"{part} {plan}"] = median_ms(bwd(plan))
    return res


def measure_rho(dev, libs: dict, steps: int = T) -> dict:
    """rho's timings (ms): the forward, the adjoint built at each
    (placement, form), each part alone at the plan's, and the sweep alone
    with its slabs in the workspace."""
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B, delta_t=1e-3)
    params = init_rho(torch.Generator(dev).manual_seed(30), cfg, device=dev)
    ins = split.rho_split_inputs(params, cfg, _signals(dev, steps))
    args = [ins[k] for k in split.RHO_SPLIT_NAMES + ("se",)]
    o = dict(log_eps=ins["log_eps"], norm_eps=ins["norm_eps"],
             unroll=UNROLL, defer_norm=True)
    g = torch.full((B,), 1.0 / B, device=dev)
    _, ckr, cki = split.rho_split_fwd(*args, **o)
    rank = ckr.shape[2] // B
    plan = split.rho_split_bwd_plan(
        D, rank, UNROLL, torch.cuda.get_device_properties(dev)
        .shared_memory_per_block_optin)

    def bwd(p):
        return lambda: split.rho_split_bwd(*args[:8], args[10], g, ckr, cki,
                                           **o, _plan=p)

    res = {"plan": "/".join(plan),
           "forward": median_ms(lambda: split.rho_split_fwd(*args, **o))}
    for form in split.SPLIT_BWD_FORMS:
        for placement in split.SPLIT_BWD_PLACEMENTS:
            res[f"built {placement}/{form}"] = median_ms(bwd((placement,
                                                              form)))
    for part, lib in libs.items():
        with _library(lib):
            res[f"{part} {'/'.join(plan)}"] = median_ms(bwd(plan))
            if part == "sweep":
                other = ("ws", plan[1])
                res[f"sweep {'/'.join(other)}"] = median_ms(bwd(other))
    return res


def summary(name: str, res: dict, steps: int) -> str:
    """One line of a kernel's timings, ms and us a step."""
    items = [f"{k} {v:.2f} ms ({v / (steps - 1) * 1e3:.3f} us/step)"
             for k, v in res.items() if k != "plan"]
    return f"{name} (plan {res['plan']}): " + "; ".join(items)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=T)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_adjoint_attribution: needs an NVIDIA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = load_builds(start_builds())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    print(f"split adjoints at D={D}, B={B}, T={args.steps}, highest, "
          f"deferred norm, unroll {UNROLL}; median of 3 CUDA-event runs",
          flush=True)
    out = {"card": card.stdout.strip(), "steps": args.steps,
           "psi": measure_psi(dev, libs, args.steps),
           "rho": measure_rho(dev, libs, args.steps)}
    print("  " + summary("psi_split_bwd", out["psi"], args.steps), flush=True)
    print("  " + summary("rho_split_bwd", out["rho"], args.steps), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
