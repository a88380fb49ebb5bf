"""The samplers timed at the serving headlines.

psi's block sampler (``csrc/psi_sample.cu``) at D=64 (or each D of
``--psi_d``) in the quad body and in the row body (the row body alone
past D=64); psi's split sampler (``csrc/psi_split_sample.cu``) at the
legacy estimator's D=10 (or each D of ``--psi_split``: one warp a chain
to D=32, a CTA of warps past it); rho's split sampler
(``csrc/rho_split_sample.cu``) at D=10, rank 10 (or each shape of
``--rho``); each at 8 chains and at one, T=65536, ``highest`` (or
``--precision``), with the body rule's picks marked.
CUDA events, the median of ``--reps`` runs after a warm-up; one line a case,
then a JSON line with the card's name and power limit. Needs an NVIDIA
card and the CUDA toolkit (~1 min with the build).

    python -m audio_mps_tpu_torch.tools.sampler_sweep [--chains=8,1] \\
        [--psi_d=8,16,32,64,72] [--psi_split=6,10,50,64,119] \\
        [--rho=10x10,20x20,32x32]

``psi_sampler_inputs``, ``psi_split_sampler_inputs`` and
``rho_split_sampler_inputs`` make the inputs
of the timed calls (the serving headlines' weights from a seed, seeded
noise); they serve ``tools/checkout_timer.py --inputs`` to time one
sampler in several checkouts:

    python -m audio_mps_tpu_torch.tools.checkout_timer \\
        --roots=build/parent,.,.,build/parent \\
        --fn=ops.block:psi_sample_block \\
        --inputs=tools.sampler_sweep:psi_sampler_inputs \\
        --args='{"n_chains": 8}'
    python -m audio_mps_tpu_torch.tools.checkout_timer \\
        --roots=build/parent,.,.,build/parent \\
        --fn=ops.split:psi_sample_split \\
        --inputs=tools.sampler_sweep:psi_split_sampler_inputs \\
        --args='{"n_chains": 8, "D": 10}'
    python -m audio_mps_tpu_torch.tools.checkout_timer \\
        --roots=build/parent,.,.,build/parent \\
        --fn=ops.split:rho_sample_split \\
        --inputs=tools.sampler_sweep:rho_split_sampler_inputs \\
        --args='{"n_chains": 1}'
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..config import CMPSConfig
from ..models import core
from ..models.params import init_psi, init_rho
from ..ops import block, split

T_SAMPLE = 65536     # the sample CLI's default duration
PSI_D = 64           # the flagship psi model (README)
RHO_D = 10           # the legacy estimator's D, full rank (--discr=true)
RHO_DT = 1e-3        # its delta_t


def psi_sampler_inputs(dev, n_chains=8, length=T_SAMPLE, D=PSI_D, seed=1):
    """Kernel inputs of ``block.psi_sample_block`` at D for ``n_chains``
    chains of ``length`` steps (weights from seed 0, noise from ``seed``)."""
    cfg = CMPSConfig(bond_dim=D)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(seed),
                               n_chains, length, 1.0)
    return block.psi_sample_inputs(p, cfg, noise)


def psi_split_sampler_inputs(dev, n_chains=8, length=T_SAMPLE, D=RHO_D,
                             seed=1):
    """Kernel inputs of ``split.psi_sample_split`` at D (the estimator's
    D=10 by default; any D to 120) for ``n_chains`` chains (weights from
    seed 0, noise from ``seed``; the estimator's delta_t)."""
    cfg = CMPSConfig(bond_dim=D, delta_t=RHO_DT, kernel_layout="split")
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(seed),
                               n_chains, length, 1.0)
    return split.psi_split_inputs(p, cfg, noise, noise=True)


def rho_split_sampler_inputs(dev, n_chains=8, length=T_SAMPLE, D=RHO_D,
                             rank=None, seed=31):
    """Kernel inputs of ``split.rho_sample_split`` at D and ``rank`` (None:
    full) for ``n_chains`` chains (weights from seed 30, noise from
    ``seed``; the estimator's delta_t)."""
    cfg = CMPSConfig(bond_dim=D, delta_t=RHO_DT, initial_rank=rank)
    p = init_rho(torch.Generator(dev).manual_seed(30), cfg, device=dev)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(seed),
                               n_chains, length, 1.0)
    return split.rho_split_inputs(p, cfg, noise, noise=True)


def median_ms(fn, reps):
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
    return sorted(times)[len(times) // 2]


def cases(psi_ds=(PSI_D,), rho_shapes=((RHO_D, RHO_D),),
          precision="highest", psi_split_ds=(RHO_D,)):
    """(label, wrapper, inputs maker, its keywords, the wrapper's forcing
    keywords, is the rule's pick): psi at each D of ``psi_ds`` in each body
    that takes it, psi's split sampler at each D of ``psi_split_ds`` and
    rho at each (D, rank) of ``rho_shapes`` in its layout (the split
    kernels have no ``high``)."""
    out = []
    for D in psi_ds:
        rule = block.psi_sample_body(D)
        for body in ("quad", "row") if rule == "quad" else ("row",):
            out.append((f"psi D={D} {body} body", block.psi_sample_block,
                        psi_sampler_inputs, dict(D=D), dict(_body=body),
                        body == rule))
    for D in psi_split_ds if precision != "high" else ():
        warps = -(-D // 32)
        out.append((f"psi split D={D} ({warps} warp{'s' if warps > 1 else ''}"
                    f" a chain)", split.psi_sample_split,
                    psi_split_sampler_inputs, dict(D=D), {}, True))
    for D, rank in rho_shapes if precision != "high" else ():
        lay = split.rho_split_sample_layout(D, rank)
        out.append((f"rho split D={D} rank {rank} ({lay.threads} threads, "
                    f"{lay.elems} element(s) each)", split.rho_sample_split,
                    rho_split_sampler_inputs, dict(D=D, rank=rank), {},
                    True))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", default="8,1")
    ap.add_argument("--psi_d", default=str(PSI_D),
                    help="psi bond dimensions, comma-separated")
    ap.add_argument("--psi_split", default=str(RHO_D),
                    help="psi split-sampler bond dimensions, comma-separated")
    ap.add_argument("--rho", default=f"{RHO_D}x{RHO_D}",
                    help="rho (D)x(rank) shapes, comma-separated")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--precision", default="highest",
                    help="the samplers' precision (rho: highest, default)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sampler_sweep needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    psi_ds = [int(d) for d in args.psi_d.split(",")]
    rho_shapes = [tuple(int(v) for v in x.split("x"))
                  for x in args.rho.split(",")]
    psi_split_ds = [int(d) for d in args.psi_split.split(",")]
    rows = []
    for n_chains in (int(c) for c in args.chains.split(",")):
        made = {}
        for label, fn, maker, mk, force, rule in cases(
                psi_ds, rho_shapes, args.precision, psi_split_ds):
            key = (maker, tuple(sorted(mk.items())))
            if key not in made:
                made[key] = maker(dev, n_chains=n_chains, **mk)
            ins = made[key]
            ms = median_ms(lambda: fn(**ins, **force,
                                      precision=args.precision), args.reps)
            rows.append({"case": label, "chains": n_chains, "ms": ms,
                         "us_a_step": ms / T_SAMPLE * 1e3, "rule": rule})
            print(f"  {label}, {n_chains} chain(s): {ms:.3f} ms "
                  f"({ms / T_SAMPLE * 1e3:.3f} us a step)"
                  f"{' <- the rule' if rule else ''}", flush=True)
        del made
    print(json.dumps({"card": card, "T": T_SAMPLE,
                      "precision": args.precision, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
