"""probe8 on the card: what bounds the per-step time of psi's forward (port
of ``tools/probe8_psi_floor.py``).

It times forward-only NLL variants that restructure the serial chain of
psi's deferred-norm forward (``ops/probe.py``, kernel ``csrc/psi_probe.cu``):

  G=1 paired=False  the baseline: the deferred-norm NLL, one column a CTA
  G=2 paired=False  two columns a CTA in lockstep: each shared-memory load
                    of a constant feeds two chains, whose latencies overlap
  G=4 paired=False  four columns a CTA
  G=1 paired=True   two steps a pass: y2 = (AA t + s0 AB t)
                    + s1 (BA t + s0 BB t) beside y1 = Ab t + s0 Bb t, six
                    products that do not wait on each other: half the
                    serial depth at +50% products
  G=2 paired=True   pairing and two columns a CTA
  noloss            the state chain alone (no expectation, no loss tail):
                    its time against the baseline's says whether the floor
                    is the chain or the tail

Each variant is first checked against the eager ``core.psi_nll``: on the
CPU (plain versions, no timing) at D=8, B=16, T=65, K=4; on the card at
D=64, B=128, T=257, K=16. The card then times every variant at D=64,
B=128, T=16385, K=16, at high and highest (CUDA events, the mean of 8 runs
after 2 warm-ups), and prints ms and ns a step.

    python -m audio_mps_tpu_torch.tools.probe8_psi_floor [--device=cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..config import CMPSConfig
from ..data import damped_sine_batch
from ..device import resolve_device
from ..models import core
from ..models.params import init_psi
from ..ops import block, probe

VARIANTS = ((1, False), (2, False), (4, False), (1, True), (2, True))
# (G, paired, noloss) of the timing pass: the chain-only diagnostic first
TIMED = ((1, False, True),) + tuple((g, p, False) for g, p in VARIANTS)
PRECISIONS = ("high", "highest")
# (D, B, T, K) of the correctness pass on the CPU and on the card, and of
# the card's timing pass
CPU_SHAPE = (8, 16, 65, 4)
CARD_SHAPE = (64, 128, 257, 16)
TIMING_SHAPE = (64, 128, 16385, 16)
# each variant's mean NLL against core.psi_nll, relative (the TPU tool's)
TOL = {"highest": 1e-4, "high": 3e-3}


def tag(G: int, paired: bool, noloss: bool = False) -> str:
    return "noloss (state chain only)" if noloss else \
        f"G={G} paired={paired}"


def build_variant(cfg: CMPSConfig, K: int, precision: str, G: int,
                  paired: bool, B: int, T: int, *, device,
                  noloss: bool = False):
    """``run(params, signals)``: the variant's mean over the batch of
    waveforms [B, T] on ``device`` (the NLL, or with ``noloss`` |y|^2 of
    the last block's final state), its inputs built from the parameters on
    every call, as the TPU tool's ``run`` builds them."""
    dev = resolve_device(device)

    def run(params, signals):
        if tuple(signals.shape) != (B, T) or signals.device.type != dev.type:
            raise ValueError(f"signals {tuple(signals.shape)} on "
                             f"{signals.device}, built for {(B, T)} on {dev}")
        ins = block.psi_nll_inputs(params, cfg, signals)
        consts = (ins["ab"], ins["bb"], ins["rb"])
        if paired:
            consts += probe.probe_products(ins["ab"], ins["bb"])
        return probe.psi_probe_nll(
            consts, ins["t0"], ins["se"], G=G, paired=paired, noloss=noloss,
            precision=precision, unroll=K, log_eps=ins["log_eps"],
            norm_eps=ins["norm_eps"])

    return run


def _setup(D: int, B: int, T: int, dev):
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B)
    params = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), B, T,
                            cfg.delta_t)
    return cfg, params, sig


def check_variants(device, shape=None) -> list:
    """The correctness pass: [(precision, G, paired, value, rel err)] of
    every variant's mean NLL against ``core.psi_nll`` at ``shape`` (the
    CPU's or the card's by default); raises past ``TOL``."""
    dev = resolve_device(device)
    D, B, T, K = shape or (CPU_SHAPE if dev.type == "cpu" else CARD_SHAPE)
    cfg, params, sig = _setup(D, B, T, dev)
    with torch.no_grad():
        ref = core.psi_nll(params, cfg, sig).item()
    print(f"ref psi_nll (D={D}, B={B}, T={T}): {ref:.6f}", flush=True)
    out = []
    for prec in PRECISIONS:
        for G, paired in VARIANTS:
            v = build_variant(cfg, K, prec, G, paired, B, T,
                              device=dev)(params, sig).item()
            err = abs(v - ref) / abs(ref)
            print(f"  {tag(G, paired)} {prec}: {v:.6f} rel-err {err:.2e}",
                  flush=True)
            if not err < TOL[prec]:
                raise AssertionError(f"{tag(G, paired)} {prec}: rel err "
                                     f"{err:.3e} (tol {TOL[prec]:g})")
            out.append((prec, G, paired, v, err))
    return out


def time_variants(device="cuda", shape=TIMING_SHAPE, reps: int = 8) -> list:
    """The timing pass on the card: [(precision, G, paired, noloss, ms,
    ns a step, value)], each the CUDA-event mean of ``reps`` runs after
    two warm-ups."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the timing pass needs the card")
    D, B, T, K = shape
    cfg, params, sig = _setup(D, B, T, dev)
    out = []
    for prec in PRECISIONS:
        print(f"--- timing {prec} (D={D} B={B} T={T})", flush=True)
        for G, paired, noloss in TIMED:
            run = build_variant(cfg, K, prec, G, paired, B, T, device=dev,
                                noloss=noloss)
            for _ in range(2):
                v = run(params, sig)
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                v = run(params, sig)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / reps
            ns = ms / (T - 1) * 1e6
            value = v.item()
            print(f"  {tag(G, paired, noloss)}: {ms:.3f} ms ({ns:.0f} "
                  f"ns/step) value={value:.4f}", flush=True)
            out.append((prec, G, paired, noloss, ms, ns, value))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    check_variants(dev)
    if dev.type == "cpu":
        print("CPU: correctness only (plain versions), no timing")
        return 0
    time_variants(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
