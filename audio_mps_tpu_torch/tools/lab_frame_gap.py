"""How far the float32 lab frame lies from a float64 run, at the primary
training cell (psi, D=64, B=128, T=16384).

    python -m audio_mps_tpu_torch.tools.lab_frame_gap [--T=16384]

It makes ``chip_smoke.py``'s lab-frame inputs (``psi_inputs``: seeded
weights and one seeded damped-sine batch, drawn on the card) and scores
them, on the first T samples, with psi's lab-frame NLL
(``models/reference_transcription.py``) on the CPU in float64, the
yardstick, and in float32; with the rotating-frame eager core
(``models/core.psi_nll``) on the CPU in float32; and with the kernel path
(``training.nll_fn_for``) on the card in float32. It prints each one's gap
to the float64 lab frame, relative to it, and ``limit``: twice the sum of
the two CPU float32 gaps, the bound that ``chip_smoke.py`` holds the card's
lab frame and kernel path to over the whole length (each float32 NLL lies
about its gap from the float64 one; twice for the card's own rounding).
The CPU runs take about a minute. It needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..config import CMPSConfig
from ..data import damped_sine_batch
from ..models import core
from ..models.params import init_psi
from ..models.reference_transcription import psi_nll_lab_frame
from ..training import nll_fn_for
from ..weights import params_to_numpy, psi_params_from_numpy

D, B, T = 64, 128, 16384


def psi_inputs(dev, T=T):
    """(params, cfg, batch [B, T]) on ``dev``: weights from a generator
    seeded 40 and the batch from one seeded 41, both on ``dev``."""
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B)
    params = init_psi(torch.Generator(dev).manual_seed(40), cfg, device=dev)
    batch = damped_sine_batch(torch.Generator(dev).manual_seed(41), B, T,
                              cfg.delta_t)
    return params, cfg, batch


def _on_cpu(params, cfg, batch, dtype):
    """(params, cfg, batch) copied to the CPU in ``dtype``."""
    p = psi_params_from_numpy(params_to_numpy(params), "cpu").to(dtype)
    return p, cfg, batch.detach().cpu().to(dtype)


def gaps(params, cfg, batch) -> dict:
    """Each NLL on ``batch`` and its gap to the float64 lab frame."""
    out = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        out["lab64_cpu"] = psi_nll_lab_frame(
            *_on_cpu(params, cfg, batch, torch.float64)).item()
        out["lab64_cpu_s"] = time.perf_counter() - t0
        out["lab32_cpu"] = psi_nll_lab_frame(
            *_on_cpu(params, cfg, batch, torch.float32)).item()
        out["core32_cpu"] = core.psi_nll(
            *_on_cpu(params, cfg, batch, torch.float32)).item()
        out["kernels32_card"] = nll_fn_for("psi_mps")(params, cfg,
                                                      batch).item()
    ref = out["lab64_cpu"]
    for k in ("lab32_cpu", "core32_cpu", "kernels32_card"):
        out[k + "_gap"] = abs(out[k] - ref) / abs(ref)
    out["limit"] = 2 * (out["lab32_cpu_gap"] + out["core32_cpu_gap"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--T", type=int, default=T)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lab_frame_gap: needs an NVIDIA card")
    dev = torch.device("cuda")
    params, cfg, batch = psi_inputs(dev, args.T)
    out = gaps(params, cfg, batch)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out.update(D=D, B=B, T=args.T, card=card)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
