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
parent, change, change, parent to see the card's drift. With
``--compare`` each run also saves what the function returned, and every
run's outputs are held to the first root's: the same bits, or the largest
difference of each output that moved. It prints one line a run and a JSON
line of the timings (and the comparisons), with the card's name and power
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


def _outputs(out) -> list:
    """The tensors a function returned, on the CPU, in order."""
    if isinstance(out, torch.Tensor):
        return [out.detach().cpu()]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _outputs(o)]
    return []


def compare(runs: list) -> list:
    """Each run's outputs against the first's: per output, "same bits" or
    the largest absolute difference (and any change of shape)."""
    first = runs[0]
    out = []
    for outs in runs:
        line = []
        for a, b in zip(outs, first):
            if a.shape != b.shape:
                line.append(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
            elif torch.equal(a, b):
                line.append("same bits")
            else:
                line.append(float((a.double() - b.double()).abs().max()))
        if len(outs) != len(first):
            line.append(f"{len(outs)} outputs vs {len(first)}")
        out.append(line)
    return out


def _child(fn_spec: str, data: str, kwargs: dict, reps: int,
           save: str = None) -> float:
    """The median ms of the current checkout's ``fn_spec`` on the saved
    inputs (run from the checkout's root); with ``save``, its outputs are
    saved there."""
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
    if save:
        torch.save(_outputs(run()), save)
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
    ap.add_argument("--compare", action="store_true",
                    help="hold every run's outputs to the first root's")
    ap.add_argument("--data", help=argparse.SUPPRESS)   # a child's inputs
    ap.add_argument("--save", help=argparse.SUPPRESS)   # a child's outputs
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("checkout_timer needs an NVIDIA card", file=sys.stderr)
        return 1
    kwargs = json.loads(args.kwargs)
    if args.data:
        print(json.dumps(_child(args.fn, args.data, kwargs, args.reps,
                                args.save)))
        return 0
    ins = _resolve(args.inputs)(torch.device("cuda"), **json.loads(args.args))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runs, saved = [], []
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "inputs.pt")
        torch.save(ins, data)
        del ins
        for i, root in enumerate(args.roots.split(",")):
            root = os.path.abspath(root)
            save = os.path.join(tmp, f"outputs{i}.pt")
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 f"--roots={root}", f"--fn={args.fn}", f"--data={data}",
                 f"--kwargs={args.kwargs}", f"--reps={args.reps}"]
                + ([f"--save={save}"] if args.compare else []),
                cwd=root, capture_output=True, text=True, check=True,
                env=dict(os.environ, PYTHONPATH=root), timeout=1800)
            ms = float(out.stdout.strip().splitlines()[-1])
            runs.append({"root": root, "ms": ms})
            if args.compare:
                saved.append(torch.load(save))
            print(f"  {root}: {args.fn} {ms:.3f} ms", flush=True)
        if args.compare:
            for run, line in zip(runs, compare(saved)):
                run["vs_first"] = line
                print(f"  {run['root']} vs {runs[0]['root']}: {line}",
                      flush=True)
    print(json.dumps({"card": card, "fn": args.fn, "inputs": args.inputs,
                      "args": json.loads(args.args), "kwargs": kwargs,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
