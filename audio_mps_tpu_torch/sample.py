"""Sampling CLI of the PyTorch/CUDA port (counterpart of
``audio_mps_tpu/sample.py``).

    python -m audio_mps_tpu_torch.sample --modeldir=<run logdir> \
        --num_samples=3 --sample_duration=65536 --fused --out=samples.npz

Reads ``{modeldir}/config.json`` (the format ``audio_mps_tpu.train``
writes) and the weights ``{modeldir}/params.npz`` of the run's family, psi
or rho (``--mps_model`` or the config's; see ``weights.py``; README,
"PyTorch/CUDA port", shows the JAX lines that export a checkpoint).
Without ``params.npz`` it warns and samples from a random init, as the JAX
CLI does without a checkpoint. ``--fused`` runs the family's sampler
kernel (psi: the block sampler at D % 8 == 0, the split one elsewhere;
rho: the block sampler); ``--device`` defaults to ``cuda``.

``--visualize`` also writes a waveform plot of each sample,
``{out base}_{i}.png``, where matplotlib is installed (it says it wrote
none where it is not).

Randomness: the init draws from a generator seeded with ``--seed`` and the
SDE noise from one seeded with ``--seed`` + 1, both on ``--device``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from .config import CMPSConfig, _coerce
from .device import resolve_device
from .models import core
from .models.params import init_psi, init_rho
from .ops.scan import psi_sample_fused_keyed, rho_sample_fused_keyed
from .summaries import waveform_figure
from .weights import load_params


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    modeldir: str = ""
    mps_model: str = ""       # "" = take from config.json (else psi_mps)
    hparams: str = ""
    sample_duration: int = 2 ** 16
    sample_rate: int = 16000
    num_samples: int = 3
    temperature: float = 1.0
    seed: int = 0
    out: str = "samples.npz"
    wav: bool = True
    visualize: bool = False      # waveform PNGs (reference sample.py:12)
    fused: bool = False          # sampler kernel (ops/block.py, split.py)
    mesh: str = ""               # multi-device sampling: not ported yet
    device: str = "cuda"


_TYPES = {"modeldir": str, "mps_model": str, "hparams": str,
          "sample_duration": int, "sample_rate": int, "num_samples": int,
          "temperature": float, "seed": int, "out": str, "wav": bool,
          "visualize": bool, "fused": bool, "mesh": str, "device": str}

# model families and options of the JAX CLI that later slices port
_NOT_PORTED = {
    "latent": "the latent family (ROADMAP queue A: Latent family)",
}
# mps_model -> (init, fused sampler, eager sampler)
_FAMILIES = {
    "psi_mps": (init_psi, psi_sample_fused_keyed, core.sample_psi),
    "rho_mps": (init_rho, rho_sample_fused_keyed, core.sample_rho),
}


def parse_args(argv) -> SampleConfig:
    updates = {}
    for arg in argv:
        if not arg.startswith("--"):
            continue
        body = arg[2:]
        k, v = (body.split("=", 1) if "=" in body else (body, "true"))
        if k not in _TYPES:
            raise ValueError(f"unknown flag --{k}")
        updates[k] = _coerce(v, _TYPES[k])
    return dataclasses.replace(SampleConfig(), **updates)


def write_wav(path: str, waveform: np.ndarray, sample_rate: int):
    """Minimal 16-bit PCM WAV writer (stdlib only)."""
    import wave
    w = np.asarray(waveform, dtype=np.float64)
    peak = np.abs(w).max()
    if peak > 0:
        w = w / peak
    pcm = (w * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def sample(sc: SampleConfig, verbose: bool = True) -> np.ndarray:
    """Restore (or init) the weights and write ``num_samples`` waveforms;
    returns them as [N, sample_duration]."""
    if not sc.modeldir:
        raise ValueError("--modeldir is required (a run logdir holding "
                         "config.json and params.npz)")
    if sc.mesh:
        raise NotImplementedError(
            f"--mesh={sc.mesh}: multi-device sampling is not ported yet "
            f"(ROADMAP queue A: Multi-GPU)")
    device = resolve_device(sc.device)
    mps_model = sc.mps_model
    cfg_path = os.path.join(sc.modeldir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            saved = json.load(f)
        # saved config is the base; --hparams overrides individual keys;
        # --mps_model only wins when explicitly given
        cfg = CMPSConfig(**saved["cfg"]).parse(sc.hparams)
        if not mps_model:
            mps_model = saved["run"].get("mps_model", "psi_mps")
    else:
        cfg = CMPSConfig().parse(sc.hparams)
    mps_model = mps_model or "psi_mps"
    if mps_model in _NOT_PORTED:
        raise NotImplementedError(
            f"--mps_model={mps_model}: {_NOT_PORTED[mps_model]} is not "
            f"ported yet")
    if mps_model not in _FAMILIES:
        raise ValueError(f"unknown mps_model {mps_model!r}")
    init, fused_fn, eager_fn = _FAMILIES[mps_model]

    params_path = os.path.join(sc.modeldir, "params.npz")
    if os.path.exists(params_path):
        params = load_params(params_path, device)
        if ("Wx" in params.NAMES) != (mps_model == "rho_mps"):
            raise ValueError(f"{params_path} holds {params.NAMES}, not "
                             f"{mps_model} weights")
    else:
        if verbose:
            print(f"warning: no {params_path} found, sampling from random "
                  f"init", flush=True)
        params = init(torch.Generator(device).manual_seed(sc.seed), cfg,
                      device=device)
    gen = torch.Generator(device).manual_seed(sc.seed + 1)
    with torch.no_grad():
        waves = (fused_fn if sc.fused else eager_fn)(
            params, cfg, gen, sc.num_samples, sc.sample_duration,
            sc.temperature)
    waves = waves.cpu().numpy()
    if sc.out:
        np.savez(sc.out, samples=waves)
        if verbose:
            print(f"wrote {sc.out}: {waves.shape}", flush=True)
    if sc.wav:
        base = os.path.splitext(sc.out or "samples.npz")[0]
        for i, w in enumerate(waves):
            write_wav(f"{base}_{i}.wav", w, sc.sample_rate)
        if verbose:
            print(f"wrote {len(waves)} wav files at {base}_*.wav", flush=True)
    if sc.visualize:
        base = os.path.splitext(sc.out or "samples.npz")[0]
        figs = [waveform_figure(w, cfg.delta_t) for w in waves]
        if None in figs:
            if verbose:
                print("matplotlib is not installed: wrote no waveform plots",
                      flush=True)
        else:
            import matplotlib.pyplot as plt
            for i, fig in enumerate(figs):
                fig.savefig(f"{base}_{i}.png", dpi=100)
                plt.close(fig)
            if verbose:
                print(f"wrote {len(waves)} waveform plots at {base}_*.png",
                      flush=True)
    return waves


def main(argv=None):
    sample(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
