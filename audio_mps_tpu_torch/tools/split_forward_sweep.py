"""The split forwards on the card: the NLL and the training forward of psi
(``csrc/psi_split_fwd.cuh``) and rho (``csrc/rho_split_fwd.cuh``) at the
legacy estimator's shape and wider ones.

Each case (psi D=10 and D=50; rho D=10 and D=20 at full rank; B=32,
T=65536, dt=1e-3, highest, unroll 16) is timed at both norms, the NLL
(kNll) and the training forward (kCkpt), and the NLL's loss must be the
training forward's bit for bit; rho at D <= 32 runs its warp-local layout
and, forced, the element layout. CUDA events, the median of 3 runs after a
warm-up, printed as ms and us a step with the card's name and power limit,
then one JSON line. It needs an NVIDIA card and the CUDA toolkit.

    python -m audio_mps_tpu_torch.tools.split_forward_sweep [--steps=65536]

``inputs`` and ``estimator_step`` also serve ``tools/checkout_timer.py``,
which times one function in several checkouts on the same inputs (copy
this file into a checkout that lacks it), for example the parent against
this checkout:

    python -m audio_mps_tpu_torch.tools.checkout_timer \\
        --roots=build/parent,.,.,build/parent --fn=ops.split:psi_split_fwd \\
        --inputs=tools.split_forward_sweep:inputs --args='{"family": "psi"}' \\
        --kwargs='{"defer_norm": true}'
    python -m audio_mps_tpu_torch.tools.checkout_timer \\
        --roots=build/parent,.,.,build/parent \\
        --fn=tools.split_forward_sweep:estimator_step \\
        --inputs=tools.split_forward_sweep:no_inputs --kwargs='{"discr": true}'
"""
from __future__ import annotations

import argparse
import atexit
import json
import shutil
import subprocess
import sys
import tempfile

import torch

from ..config import CMPSConfig
from ..data import damped_sine_batch
from ..models.params import init_psi, init_rho
from ..ops import split
from .split_adjoint_attribution import median_ms

B, T, DT, UNROLL = 32, 65536, 1e-3, 16
# (family, D, rank): the estimator's shape, then one wider shape each
CASES = (("psi", 10, None), ("psi", 50, None), ("rho", 10, 10),
         ("rho", 20, 20))


def inputs(dev, family: str = "psi", D: int = 10, rank=None, B: int = B,
           T: int = T, seed: int = 22) -> dict:
    """The keyword arguments of ``split.psi_nll_split`` / ``psi_split_fwd``
    (or rho's) for B damped sines of T samples, the estimator's dt and
    seeded random parameters (rho at ``rank``, None: full)."""
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B, delta_t=DT,
                     initial_rank=rank)
    init, make = ((init_psi, split.psi_split_inputs) if family == "psi"
                  else (init_rho, split.rho_split_inputs))
    params = init(torch.Generator(dev).manual_seed(20), cfg, device=dev)
    signals = damped_sine_batch(torch.Generator(dev).manual_seed(seed), B, T,
                                DT)
    return make(params, cfg, signals)


def no_inputs(dev) -> dict:
    """No inputs (``estimator_step`` makes its own)."""
    return {}


_ESTIMATORS = {}


def estimator_step(discr: bool = False, steps: int = 3):
    """``steps`` training steps of the legacy estimator at its published
    defaults (psi, or rho with ``discr``), its checkpoint save included, as
    ``chip_smoke.py`` times them; the estimator is made on the first call
    (in a temporary model_dir) and kept."""
    from .. import estimator
    if discr not in _ESTIMATORS:
        ec = estimator.parse_args([f"--discr={str(discr).lower()}"])
        cfg = CMPSConfig(minibatch_size=ec.batch_size, bond_dim=ec.bond_d,
                         delta_t=ec.dt, learning_rate=ec.learning_rate)
        tmp = tempfile.mkdtemp()
        atexit.register(shutil.rmtree, tmp, True)
        est = estimator.Estimator("rho_mps" if discr else "psi_mps", cfg,
                                  tmp, device=ec.device)
        _ESTIMATORS[discr] = (est, estimator.build_input_fn(ec, cfg))
    est, input_fn = _ESTIMATORS[discr]
    est.train(input_fn, steps=steps)


def measure(dev, family: str, D: int, rank=None, steps: int = T,
            reps: int = 3) -> list:
    """One entry a (kernel, norm, layout): ms, us a step, and whether the
    NLL's loss is the training forward's bit for bit."""
    ins = inputs(dev, family, D, rank, B, steps)
    nll, fwd = ((split.psi_nll_split, split.psi_split_fwd) if family == "psi"
                else (split.rho_nll_split, split.rho_split_fwd))
    layouts = (True, False) if family == "rho" and D <= 32 else (True,)
    out = []
    for warp_local in layouts:
        extra = {} if family == "psi" else {"_warp_local": warp_local}
        for defer in (False, True):
            kw = dict(unroll=UNROLL, defer_norm=defer, **extra)
            same = torch.equal(nll(**ins, **kw), fwd(**ins, **kw)[0])
            layout = ("one CTA a column" if family == "psi" else
                      "warp-local" if split.rho_split_fwd_layout(
                          D, rank or D, warp_local).cols else "element")
            for fn in (nll, fwd):
                ms = median_ms(lambda: fn(**ins, **kw), reps)
                out.append({"kernel": fn.__name__, "D": D, "rank": rank,
                            "defer_norm": defer, "layout": layout, "ms": ms,
                            "us_step": ms / (steps - 1) * 1e3,
                            "nll_is_fwd": same})
    return out


def line(entry: dict) -> str:
    rank = f", rank {entry['rank']}" if entry["rank"] else ""
    return (f"{entry['kernel']} D={entry['D']}{rank} defer_norm="
            f"{entry['defer_norm']} ({entry['layout']}): {entry['ms']:.3f} "
            f"ms ({entry['us_step']:.3f} us/step); NLL = forward bits "
            f"{entry['nll_is_fwd']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=T)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_forward_sweep: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    print(f"split forwards at B={B}, T={args.steps}, highest, unroll "
          f"{UNROLL}; median of 3 CUDA-event runs", flush=True)
    res = []
    for family, D, rank in CASES:
        for entry in measure(dev, family, D, rank, args.steps):
            print("  " + line(entry), flush=True)
            res.append(entry)
    print(json.dumps({"card": card.strip(), "steps": args.steps,
                      "cases": res}), flush=True)
    return 0 if all(e["nll_is_fwd"] for e in res) else 1


if __name__ == "__main__":
    sys.exit(main())
