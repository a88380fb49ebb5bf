"""TensorBoard summaries of the training loop (a copy of
``audio_mps_tpu/summaries.py`` that moves tensors to the host first):
scalars, histograms, audio of training batches and matplotlib waveform
images of data and fresh samples (reference: train.py:62-85,
utils.py:10-17).

Backed by ``torch.utils.tensorboard``; ``make_writer`` returns None where
tensorboard is not installed, and every writer call is then skipped. The
waveform images are skipped where matplotlib is not installed.
"""
from __future__ import annotations

import numpy as np
import torch


def make_writer(logdir: str):
    """Create a SummaryWriter, or None if tensorboard is unavailable."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None
    return SummaryWriter(log_dir=logdir)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def waveform_figure(waveform: np.ndarray, delta_t: float):
    """Matplotlib waveform plot (reference: utils.py:10-17), or None where
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(3, 3))
    times = np.arange(len(waveform)) * delta_t
    ax.plot(times, waveform)
    ax.set_ylabel("signal")
    ax.set_xlabel("time")
    fig.tight_layout()
    return fig


def write_step_summaries(writer, step: int, metrics: dict, cfg, run,
                         params=None, data=None, samples=None):
    """Emit the reference summary set (reference: train.py:62-85).

    metrics: dict of scalar floats (model_loss, total_loss, h_l2sqnorm,
    r_l2sqnorm, A, ...). data/samples: [N, T] waveforms (optional), as
    tensors on any device or numpy arrays.
    """
    if writer is None:
        return
    h_sq = float(metrics.get("h_l2sqnorm", 0.0))
    r_sq = float(metrics.get("r_l2sqnorm", 0.0))
    writer.add_scalar("A", float(metrics.get("A", cfg.A)), step)
    writer.add_scalar("sigma", cfg.sigma, step)
    writer.add_scalar("h_l2norm", np.sqrt(max(h_sq, 0.0)), step)
    writer.add_scalar("r_l2norm", np.sqrt(max(r_sq, 0.0)), step)
    # Physics health metric (reference: train.py:68-69).
    gr_rate = 2 * np.pi * cfg.sigma ** 2 * r_sq / cfg.bond_dim
    if gr_rate > 0:
        writer.add_scalar("gr_decay_time", 1.0 / gr_rate, step)
    writer.add_scalar("model_loss", float(metrics["model_loss"]), step)
    writer.add_scalar("total_loss", float(metrics["total_loss"]), step)

    if params is not None:
        freqs = _host(params.freqs)
        writer.add_histogram("frequencies", freqs / (2 * np.pi), step)

    if data is not None:
        data = _host(data)
        # Audio summaries of training batches (reference: train.py:74).
        for i in range(min(5, data.shape[0])):
            clip = data[i] / (np.abs(data[i]).max() + 1e-9)
            writer.add_audio(f"data/{i}", clip[None, :], step,
                             sample_rate=run.sample_rate)
        fig = waveform_figure(data[0], cfg.delta_t) if run.visualize else None
        if fig is not None:
            writer.add_figure("data_waveform", fig, step)

    if samples is not None and run.visualize:
        samples = _host(samples)
        fig = waveform_figure(samples[0], cfg.delta_t)
        if fig is not None:
            writer.add_figure("sample_waveform", fig, step)
        for i in range(min(3, samples.shape[0])):
            clip = samples[i] / (np.abs(samples[i]).max() + 1e-9)
            writer.add_audio(f"samples/{i}", clip[None, :], step,
                             sample_rate=run.sample_rate)
