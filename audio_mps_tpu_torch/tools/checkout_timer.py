"""One function of the port timed in several checkouts of it, on the same
inputs, on the card.

The inputs come from a function of this checkout (``--inputs``,
``module:function`` under ``audio_mps_tpu_torch``, called with the device
and the JSON keywords of ``--args``, returning a dict of keyword
arguments) and are saved once. Each checkout given in ``--roots`` then
runs its own ``--fn`` (``module:function``) on them, with the JSON
keywords of ``--kwargs``, in a process of its own started from its root,
so that it imports and builds that checkout's package; CUDA events, the
median of ``--reps`` runs after a warm-up. Give the roots in the order
parent, change, change, parent to see the card's drift. It prints one
line a run and a JSON line of the timings, with the card's name and power
limit. It needs an NVIDIA card and the CUDA toolkit.

    python -m audio_mps_tpu_torch.tools.checkout_timer \\
        --roots=build/parent,.,.,build/parent \\
        --fn=ops.block:rho_sample_block \\
        --inputs=tools.rho_cluster_sweep:sampler_inputs \\
        --args='{"n_chains": 67}' --kwargs='{"precision": "highest"}'

(``build/parent`` here is the parent commit unpacked by ``git archive``
into a directory that git ignores.)
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch


def _resolve(spec: str):
    module, name = spec.split(":")
    return getattr(importlib.import_module("audio_mps_tpu_torch." + module),
                   name)


def _child(fn_spec: str, data: str, kwargs: dict, reps: int) -> float:
    """The median ms of the current checkout's ``fn_spec`` on the saved
    inputs (run from the checkout's root)."""
    sys.path.insert(0, os.getcwd())
    fn = _resolve(fn_spec)
    ins = torch.load(data, map_location="cuda")

    def run():
        return fn(**ins, **kwargs)

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", required=True,
                    help="the checkouts' roots, comma-separated, in order")
    ap.add_argument("--fn", required=True, help="module:function to time")
    ap.add_argument("--inputs", help="module:function making the inputs")
    ap.add_argument("--args", default="{}", help="JSON keywords of --inputs")
    ap.add_argument("--kwargs", default="{}", help="JSON keywords of --fn")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--data", help=argparse.SUPPRESS)   # a child's inputs
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("checkout_timer needs an NVIDIA card", file=sys.stderr)
        return 1
    kwargs = json.loads(args.kwargs)
    if args.data:
        print(json.dumps(_child(args.fn, args.data, kwargs, args.reps)))
        return 0
    ins = _resolve(args.inputs)(torch.device("cuda"), **json.loads(args.args))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "inputs.pt")
        torch.save(ins, data)
        del ins
        for root in args.roots.split(","):
            root = os.path.abspath(root)
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 f"--roots={root}", f"--fn={args.fn}", f"--data={data}",
                 f"--kwargs={args.kwargs}", f"--reps={args.reps}"],
                cwd=root, capture_output=True, text=True, check=True,
                env=dict(os.environ, PYTHONPATH=root), timeout=1800)
            ms = float(out.stdout.strip().splitlines()[-1])
            runs.append({"root": root, "ms": ms})
            print(f"  {root}: {args.fn} {ms:.3f} ms", flush=True)
    print(json.dumps({"card": card, "fn": args.fn, "inputs": args.inputs,
                      "args": json.loads(args.args), "kwargs": kwargs,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
