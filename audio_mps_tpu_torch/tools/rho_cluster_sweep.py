"""rho's block forward, adjoint chain and sampler at each thread-block
cluster size, on the card.

At the rho training headline (D=64, rank 64, B=8, T=16384, highest) it
forces each cluster C the rank's 16 column groups admit (1, 2, 4, 8, 16;
``cluster=``) on the streamed forward (``csrc/rho_train_fwd.cu``), the
adjoint (the tail and the chain, ``csrc/rho_train_bwd.cu``), the scoring
NLL at the per-step and the deferred norm (``csrc/rho_nll.cu``; the
per-step norm exchanges its sums every step) and the segment recompute
over the run's 32 time segments (``csrc/rho_recompute.cu``). CUDA events,
the median of 3 runs after a warm-up. Every C's outputs are held to
C=1's bit for bit over the whole run. With ``--sampler`` it does the same
for the SDE sampler (``csrc/rho_sample.cu``) at the generation headline
(D=64, rank 64, T=65536) for each of ``--chains`` (8 chains and one by
default; from 67 an H100's rule takes C=1). It prints the card's
residency at each C and what ``ops/block.rho_cluster_for`` takes, the
kernels' registers and spills when the library was built by this
process, one line a C and a JSON line of the timings, with the card's
name and power limit. It needs an NVIDIA card and the CUDA toolkit.
(``tools/checkout_timer.py`` times another checkout's sampler on the
same inputs.)

    python -m audio_mps_tpu_torch.tools.rho_cluster_sweep [--defer=false]
    python -m audio_mps_tpu_torch.tools.rho_cluster_sweep --sampler \
        [--chains=8,1,67,132]
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
from ..models.params import init_rho
from ..ops import _build, block

D, B, T, UNROLL = 64, 8, 16384, 16
T_SAMPLE = 65536          # the sample CLI's default duration
SAMPLE_CHAINS = (8, 1)    # the generation headline, and one user's chain
KERNELS = ("fwd", "recompute", "chain", "sample")
SOURCES = ("rho_nll.cu", "rho_train_fwd.cu", "rho_recompute.cu",
           "rho_train_bwd.cu", "rho_sample.cu")


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


def headline_inputs(dev, seed=12):
    """The NLL inputs of the headline (seeded weights and damped-sine
    batch) and its eps."""
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B)
    p = init_rho(torch.Generator(dev).manual_seed(10), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(seed), B, T,
                            cfg.delta_t)
    ins = block.rho_nll_inputs(p, cfg, sig)
    return ins, dict(log_eps=ins.pop("log_eps"), norm_eps=ins.pop("norm_eps"))


def sampler_inputs(dev, n_chains, length=T_SAMPLE, seed=11):
    """The sampler inputs of the generation headline (the weights of
    ``headline_inputs``, seeded noise for ``n_chains`` chains)."""
    from ..models import core
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B)
    p = init_rho(torch.Generator(dev).manual_seed(10), cfg, device=dev)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(seed),
                               n_chains, length, 1.0)
    return block.rho_sample_inputs(p, cfg, noise)


def residency(dev, rank, units):
    """{kernel: ({C: clusters the card holds}, the rule's C)} at D, rank
    for ``units`` clusters (examples or chains; the recompute's: units x
    32 blocks)."""
    props = torch.cuda.get_device_properties(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    groups = -(-rank // 4)
    sizes = [c for c in block.RHO_CLUSTERS if groups % c == 0]
    out = {}
    for kernel in KERNELS:
        held = {c: block.rho_resident_clusters(index, kernel, D, rank, c)
                for c in sizes}
        n = units * (32 if kernel == "recompute" else 1)
        out[kernel] = (held, block.rho_cluster_for(
            D, n, rank, props.multi_processor_count, held,
            props.shared_memory_per_block_optin, kernel))
    return out


def sweep(ins, eps, precision="highest", defer=True, reps=3, log=print):
    """{C: {label: ms}} of each kernel at each cluster C, every C's outputs
    held to C=1's bit for bit (raises on a difference)."""
    rank = ins["t0"].shape[1] // ins["se"].shape[1]
    n_steps, batch = ins["se"].shape
    groups = -(-rank // 4)
    sizes = [c for c in block.RHO_CLUSTERS if groups % c == 0]
    o = dict(precision=precision, defer_norm=defer, unroll=UNROLL)
    g = torch.full((batch,), 1.0 / batch, device=ins["se"].device)
    seg = block.recompute_segment_steps(n_steps, UNROLL)
    spans = block.recompute_segments(n_steps, UNROLL, seg)
    con = dict(ab=ins["ab"], bb=ins["bb"], xb=ins["xb"])

    def recompute_all(ck, c):
        return [block.rho_recompute(
            **con, ck=ck[k0 // UNROLL:-(-k1 // UNROLL)],
            se=ins["se"][k0:k1], norm_eps=eps["norm_eps"], cluster=c, **o)
            for k0, k1 in spans]

    want, ms = None, {}
    for c in sizes:
        f = block.rho_train_fwd(**ins, **eps, **o, cluster=c)
        b = block.rho_train_bwd(**ins, g=g, ys=f[1], trs=f[2], **eps, **o,
                                cluster=c)
        nll = [block.rho_nll_block(**ins, **eps, precision=precision,
                                   unroll=UNROLL, defer_norm=d, cluster=c)
               for d in (False, True)]
        loss_c, ck = block.rho_train_fwd_ckpt(**ins, **eps, **o, cluster=c)
        rec = recompute_all(ck, c)
        got = (*f, *b, *nll, loss_c, ck,
               torch.cat([r[1] for r in rec]))
        torch.cuda.synchronize()
        del rec
        if want is None:
            want = got
        else:
            for i, (x, w) in enumerate(zip(got, want)):
                if not torch.equal(x, w):
                    raise RuntimeError(f"rho at cluster {c}: output {i} "
                                       f"differs from cluster 1's")
        del got, b, nll
        ms[c] = {
            "fwd": _median_ms(lambda: block.rho_train_fwd(
                **ins, **eps, **o, cluster=c), reps),
            "bwd": _median_ms(lambda: block.rho_train_bwd(
                **ins, g=g, ys=f[1], trs=f[2], **eps, **o, cluster=c),
                reps),
            "nll_per_step": _median_ms(lambda: block.rho_nll_block(
                **ins, **eps, precision=precision, unroll=UNROLL,
                defer_norm=False, cluster=c), reps),
            "nll_deferred": _median_ms(lambda: block.rho_nll_block(
                **ins, **eps, precision=precision, unroll=UNROLL,
                defer_norm=True, cluster=c), reps),
            "ckpt": _median_ms(lambda: block.rho_train_fwd_ckpt(
                **ins, **eps, **o, cluster=c), reps),
            "recompute": _median_ms(lambda: recompute_all(ck, c), reps)}
        del f, ck
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"  C={c} (C=1's bits): streamed forward {ms[c]['fwd']:.3f} "
            f"ms, adjoint (tail + chain) {ms[c]['bwd']:.3f}, NLL per-step "
            f"norm {ms[c]['nll_per_step']:.3f}, deferred "
            f"{ms[c]['nll_deferred']:.3f}, checkpoint forward "
            f"{ms[c]['ckpt']:.3f}, recompute over {len(spans)} segments "
            f"{ms[c]['recompute']:.3f}")
    return ms


def sample_sweep(dev, n_chains, precision="highest", reps=3, log=print,
                 length=T_SAMPLE):
    """{C: ms} of the sampler forced to each cluster C the card holds, for
    ``n_chains`` chains over ``length`` steps; every C's waveform held to
    C=1's bit for bit (raises on a difference)."""
    ins = sampler_inputs(dev, n_chains, length)
    rank = ins["t0"].shape[1] // n_chains
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sizes = [c for c in block.RHO_CLUSTERS if -(-rank // 4) % c == 0
             and block.rho_resident_clusters(index, "sample", D, rank, c) > 0]
    want, ms = None, {}
    for c in sizes:
        got = block.rho_sample_block(**ins, precision=precision, cluster=c)
        torch.cuda.synchronize()
        if want is None:
            want = got
        elif not torch.equal(got, want):
            raise RuntimeError(f"rho sampler at cluster {c}, {n_chains} "
                               f"chains: the waveform differs from cluster "
                               f"1's")
        ms[c] = _median_ms(lambda: block.rho_sample_block(
            **ins, precision=precision, cluster=c), reps)
        log(f"  sampler, {n_chains} chain(s), C={c} (C=1's bits): "
            f"{ms[c]:.3f} ms, {ms[c] / length * 1e3:.3f} us a step")
    return ms


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", default="highest",
                    choices=("highest", "high", "default"))
    ap.add_argument("--defer", default="true", choices=("true", "false"))
    ap.add_argument("--sampler", action="store_true",
                    help="sweep the sampler instead of the training kernels")
    ap.add_argument("--chains", default=",".join(map(str, SAMPLE_CHAINS)),
                    help="with --sampler: the chain counts, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rho_cluster_sweep needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    built = _build.build()
    print(f"card: {card_line()}; kernel build {built['seconds']:.1f} s",
          flush=True)
    for line in _build.ptxas_report(built["log"], SOURCES):
        print("  " + line, flush=True)
    dev = torch.device("cuda")
    for kernel, (held, rule) in residency(dev, D, B).items():
        print(f"  {kernel}: clusters the card holds {held}; the rule takes "
              f"C={rule}", flush=True)
    if args.sampler:
        out = {}
        for n in map(int, args.chains.split(",")):
            rule = residency(dev, D, n)["sample"][1]
            out[n] = {"rule": rule, "ms": sample_sweep(
                dev, n, args.precision, log=lambda s: print(s, flush=True))}
            print(f"  {n} chain(s): the rule takes C={rule}", flush=True)
        print(json.dumps({"card": card_line(), "D": D, "rank": D,
                          "T": T_SAMPLE, "precision": args.precision,
                          "sampler": out}), flush=True)
        return 0
    ins, eps = headline_inputs(dev)
    ms = sweep(ins, eps, args.precision, args.defer == "true",
               log=lambda s: print(s, flush=True))
    print(json.dumps({"card": card_line(), "D": D, "rank": D, "B": B,
                      "T": T, "precision": args.precision,
                      "defer": args.defer == "true", "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
