"""psi's block kernels at each number of columns a CTA, on the card.

At the saturated batch (D=64, B=1024, T=16384, deferred norm) it forces
G = 1, 2, 4 and 8 columns a CTA (``cols_per_cta=``) on the kernels the
training path without the stream runs, the checkpoint forward
(``csrc/psi_train_fwd.cu``), the segment recompute over the run's time
segments (``csrc/psi_recompute.cu``) and the whole recompute adjoint
(recompute, adjoint chain ``csrc/psi_train_bwd.cu`` and reductions, a
segment at a time), plus the streamed forward and the adjoint chain alone
over the whole run; then the B=128 headline's streamed forward and
adjoint at G=1, the launch the rule keeps there. CUDA events, the median
of 2 runs after a warm-up (B=128: of 3). Every G's outputs are held to
G=1's bit for bit on the first 2048 steps. It prints one line a G and a
JSON line of the timings, with the card's name and power limit; these
are the timings ``ops/block.py psi_columns_per_cta`` is derived from. It
needs an NVIDIA card and the CUDA toolkit.

    python -m audio_mps_tpu_torch.tools.psi_columns_sweep [--precision=highest]

``headline_inputs``, ``step_inputs`` and ``batched_inputs`` (the batched
adjoint's, at B=128 or any batch) make inputs for
``tools/checkout_timer.py``:

    python -m audio_mps_tpu_torch.tools.checkout_timer \\
        --roots=build/parent,.,.,build/parent --fn=ops.block:psi_batched_bwd \\
        --inputs=tools.psi_columns_sweep:batched_inputs --args='{"batch": 1024}'
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from ..config import CMPSConfig
from ..data import damped_sine_batch
from ..models.params import init_psi
from ..ops import block

D, B, B_HEADLINE, T, T_CHECK, UNROLL = 64, 1024, 128, 16384, 2048, 16


def _median_ms(fn, reps):
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


def _inputs(dev, batch, steps, seed):
    cfg = CMPSConfig(bond_dim=D, minibatch_size=batch)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(seed), batch,
                            steps, cfg.delta_t)
    ins = block.psi_nll_inputs(p, cfg, sig)
    eps = dict(log_eps=ins.pop("log_eps"), norm_eps=ins.pop("norm_eps"))
    return ins, eps, torch.full((batch,), 1.0 / batch, device=dev)


def headline_inputs(dev, batch: int = B_HEADLINE, adjoint: bool = False,
                    recompute: bool = False, precision: str = "highest",
                    defer_norm: bool = True):
    """The keyword inputs of psi's block kernels at D=64, T=16384 and
    ``batch`` columns: scoring's and the training forwards'; with
    ``adjoint`` also the loss cotangent g and the streamed forward's ys and
    n2s at ``precision`` and ``defer_norm`` (the adjoint's inputs); with
    ``recompute`` the whole recompute adjoint's (the checkpoints ck in
    place of t0, and g)."""
    ins, eps, g = _inputs(dev, batch, T, seed=3)
    out = dict(ins, **eps)
    o = dict(precision=precision, defer_norm=defer_norm, unroll=UNROLL)
    if adjoint:
        _, ys, n2s = block.psi_train_fwd(**out, **o)
        out.update(g=g, ys=ys, n2s=n2s)
    if recompute:
        _, ck = block.psi_train_fwd_ckpt(**out, **o)
        del out["t0"]
        out.update(g=g, ck=ck)
    return out


def segment_recompute(ab, bb, rb, ck, se, norm_eps, unroll: int = UNROLL,
                      defer_norm: bool = True, precision: str = "highest",
                      **_):
    """The recompute path's segment recomputes over a whole run (one
    ``psi_recompute`` a time segment, as ``psi_recompute_bwd`` runs them),
    on ``headline_inputs(recompute=True)``."""
    for k0, k1 in block.recompute_segments(se.shape[0], unroll):
        block.psi_recompute(ab, bb, rb, ck[k0 // unroll:-(-k1 // unroll)],
                            se[k0:k1], norm_eps=norm_eps, unroll=unroll,
                            defer_norm=defer_norm, precision=precision)


def step_inputs(dev, batch: int = B_HEADLINE) -> dict:
    """A damped-sine batch [batch, T] for ``headline_step``."""
    cfg = CMPSConfig(bond_dim=D, minibatch_size=batch)
    return {"signals": damped_sine_batch(torch.Generator(dev).manual_seed(4),
                                         batch, T, cfg.delta_t)}


_STEPS = {}


def headline_step(signals, defer_norm: bool = True,
                  precision: str = "highest"):
    """One Adam step of psi training (``make_train_step``, the train CLI's
    step) at D=64 on ``signals``; seeded weights and the step are made on
    the first call and kept."""
    from ..training import make_train_step
    key = (tuple(signals.shape), defer_norm, precision)
    if key not in _STEPS:
        cfg = CMPSConfig(bond_dim=D, minibatch_size=signals.shape[0],
                         defer_norm=defer_norm, kernel_precision=precision)
        p = init_psi(torch.Generator(signals.device).manual_seed(0), cfg,
                     device=signals.device)
        _STEPS[key] = make_train_step("psi_mps", cfg, p,
                                      device=signals.device)[1]
    _STEPS[key](signals)


def batched_inputs(dev, batch: int = B_HEADLINE,
                   precision: str = "highest") -> dict:
    """The keyword inputs of ``block.psi_batched_bwd`` at D=64, T=16384,
    unroll 16 and ``batch`` columns: the constants, the batched forward's
    checkpoints at ``precision``, se, the loss cotangent g and the
    options (B=128 the headline, B=1024 the saturated batch)."""
    ins, eps, g = _inputs(dev, batch, T, seed=3)
    o = dict(eps, unroll=UNROLL, precision=precision)
    _, ck = block.psi_batched_fwd(**ins, **o)
    return dict(ab=ins["ab"], bb=ins["bb"], rb=ins["rb"], ck=ck,
                se=ins["se"], g=g, **o)


def _outputs(ins, eps, g, o):
    """Every kernel's outputs at the options ``o`` (cols_per_cta
    included)."""
    con = {k: ins[k] for k in ("ab", "bb", "rb")}
    loss, ys, n2s = block.psi_train_fwd(**ins, **eps, **o)
    _, ck = block.psi_train_fwd_ckpt(**ins, **eps, **o)
    rec = block.psi_recompute(**con, ck=ck, se=ins["se"],
                              norm_eps=eps["norm_eps"], **o)
    adj = block.psi_train_bwd(**ins, g=g, ys=ys, n2s=n2s, **eps, **o)
    whole = block.psi_recompute_bwd(**con, ck=ck, se=ins["se"], g=g, **eps,
                                    **o)
    torch.cuda.synchronize()
    return (loss, ys, n2s, ck, *rec, *adj, *whole)


def sweep(dev, precision):
    base = dict(precision=precision, defer_norm=True, unroll=UNROLL)
    ins, eps, g = _inputs(dev, B, T_CHECK, seed=1)
    want = _outputs(ins, eps, g, dict(base, cols_per_cta=1))
    for G in block.PSI_COLS[1:]:
        got = _outputs(ins, eps, g, dict(base, cols_per_cta=G))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"G={G} does not give G=1's bits")
    del ins, want, got
    torch.cuda.empty_cache()

    ins, eps, g = _inputs(dev, B, T, seed=2)
    con = {k: ins[k] for k in ("ab", "bb", "rb")}
    segments = block.recompute_segments(T - 1, UNROLL)
    res = {}
    for G in block.PSI_COLS:
        o = dict(base, cols_per_cta=G)
        r = {"ckpt": _median_ms(
            lambda: block.psi_train_fwd_ckpt(**ins, **eps, **o), 2)}
        _, ck = block.psi_train_fwd_ckpt(**ins, **eps, **o)

        def recompute():
            for k0, k1 in segments:
                block.psi_recompute(
                    **con, ck=ck[k0 // UNROLL:-(-k1 // UNROLL)],
                    se=ins["se"][k0:k1], norm_eps=eps["norm_eps"], **o)

        r["rec"] = _median_ms(recompute, 2)
        r["adj"] = _median_ms(lambda: block.psi_recompute_bwd(
            **con, ck=ck, se=ins["se"], g=g, **eps, **o), 2)
        del ck
        r["fwd"] = _median_ms(lambda: block.psi_train_fwd(**ins, **eps, **o),
                              2)
        _, ys, n2s = block.psi_train_fwd(**ins, **eps, **o)
        r["chain"] = _median_ms(lambda: block.psi_train_bwd(
            **ins, g=g, ys=ys, n2s=n2s, **eps, **o), 2)
        del ys, n2s
        torch.cuda.empty_cache()
        res[G] = r
        print(f"G={G} ({-(-B // G)} CTAs): checkpoint forward "
              f"{r['ckpt']:.2f} ms, segment recompute {r['rec']:.2f}, "
              f"recompute adjoint {r['adj']:.2f}, streamed forward "
              f"{r['fwd']:.2f}, adjoint (tail and chain) {r['chain']:.2f}",
              flush=True)
    del ins, con
    torch.cuda.empty_cache()

    ins, eps, g = _inputs(dev, B_HEADLINE, T, seed=3)
    o = dict(base, cols_per_cta=1)
    head = {"fwd": _median_ms(lambda: block.psi_train_fwd(**ins, **eps, **o),
                              3)}
    _, ys, n2s = block.psi_train_fwd(**ins, **eps, **o)
    head["chain"] = _median_ms(lambda: block.psi_train_bwd(
        **ins, g=g, ys=ys, n2s=n2s, **eps, **o), 3)
    del o["cols_per_cta"]
    head["tail"] = _median_ms(lambda: block.psi_train_bwd_tail(
        ins["rb"], ins["se"], g, ys, n2s, **eps, **o), 3)
    print(f"B={B_HEADLINE}, G=1: streamed forward {head['fwd']:.2f} ms, "
          f"adjoint (tail and chain) {head['chain']:.2f}, the tail alone "
          f"{head['tail']:.2f}", flush=True)
    return res, head


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", default="highest",
                    choices=block.PRECISIONS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("psi_columns_sweep needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; D={D}, B={B}, T={T}, {args.precision}, deferred norm",
          flush=True)
    res, head = sweep(torch.device("cuda"), args.precision)
    print(json.dumps({"card": card, "precision": args.precision,
                      "B1024": res, "B128_G1": head}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
