"""``get_audio`` — the data entry point (port of
``audio_mps_tpu/data/audio.py``; reference: data.py:6-45).

Dispatches between the synthetic damped-sine generator and TFRecord-backed
datasets (``{datadir}/{dataset}.tfrecords`` with audio-only Examples, e.g.
guitar/organ). Returns an infinite iterator of [B, T] float32 batches on
the requested device.

Large files stream: above ``stream_threshold_bytes`` (or with
``stream=True``) batches come from a reservoir-shuffled record stream
(data/pipeline.py:iter_audio_tfrecords) instead of loading the whole [N, T]
array into host RAM — full NSynth (the reference reader.py use case) is
~70 GB, far beyond what the reference's eager path could hold. Both draw
numpy's ``default_rng(seed)`` as the JAX package does, so the two packages
give equal batches for a file and a seed.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional

import torch

from ..config import CMPSConfig
from ..device import resolve_device
from .pipeline import ArrayDataset, iter_audio_tfrecords
from .synthetic import damped_sine_iterator
from .tfrecord import read_audio_tfrecords

# Files larger than this stream through the reservoir shuffle instead of
# being materialized in host memory (the reference's own small datasets
# are ~100 waveforms, make-small-dataset.py:19 — far below this).
DEFAULT_STREAM_THRESHOLD = 256 << 20  # 256 MB


def batches_on(batches, device: torch.device) -> Iterator[torch.Tensor]:
    """Host numpy batches as float32 tensors on ``device``."""
    for b in batches:
        yield torch.as_tensor(b, dtype=torch.float32, device=device)


def get_audio(datadir: str, dataset: str, hps: CMPSConfig,
              sample_duration: int = 2 ** 16, seed: int = 0,
              stream: Optional[bool] = None,
              stream_threshold_bytes: int = DEFAULT_STREAM_THRESHOLD,
              device="cuda") -> Iterator:
    """Infinite iterator of [minibatch_size, sample_duration] batches on
    ``device`` (reference: data.py:6-45, same dataset names as
    train.py:23-25).

    ``stream=None`` auto-selects: in-memory shuffle-repeat-batch for small
    files, streaming reservoir shuffle above `stream_threshold_bytes`.
    """
    dev = resolve_device(device)
    if dataset == "damped_sine":
        return damped_sine_iterator(hps, sample_duration, seed=seed,
                                    device=dev)
    path = os.path.join(datadir, f"{dataset}.tfrecords")
    if not os.path.exists(path):
        alt = os.path.join(datadir, f"{dataset}.tfrecord")
        if os.path.exists(alt):
            path = alt
        else:
            raise FileNotFoundError(
                f"dataset file {path} not found; create it with "
                f"tools/make_small_dataset.py (reference: "
                f"make-small-dataset.py)")
    if stream is None:
        stream = os.path.getsize(path) > stream_threshold_bytes
    if stream:
        return batches_on(iter_audio_tfrecords(path, hps.minibatch_size,
                                        sample_duration=sample_duration,
                                        seed=seed), dev)
    data = read_audio_tfrecords(path, sample_duration=sample_duration)
    return batches_on(ArrayDataset(data, hps.minibatch_size, seed=seed), dev)
