"""``get_audio`` — the data entry point (port of
``audio_mps_tpu/data/audio.py``; reference: data.py:6-45).

Only the synthetic damped-sine dataset is ported. The file datasets
(guitar, organ, nsynth) come through the JAX package's TFRecord data plane,
which is queued (ROADMAP queue A item 4).
"""
from __future__ import annotations

from typing import Iterator

from ..config import CMPSConfig
from .synthetic import damped_sine_iterator

_DATA_PLANE = ("audio_mps_tpu/data/tfrecord.py, data/pipeline.py, "
               "data/nsynth.py and native/ (the TFRecord data plane, ROADMAP "
               "queue A item 4)")


def get_audio(datadir: str, dataset: str, hps: CMPSConfig,
              sample_duration: int = 2 ** 16, seed: int = 0,
              device="cuda") -> Iterator:
    """Infinite iterator of [minibatch_size, sample_duration] batches on
    ``device`` (reference: data.py:6-45, the dataset names of
    train.py:23-25). ``datadir`` holds the file datasets, which raise
    here."""
    if dataset == "damped_sine":
        return damped_sine_iterator(hps, sample_duration, seed=seed,
                                    device=device)
    raise NotImplementedError(
        f"dataset {dataset!r} (from {datadir!r}) is read by {_DATA_PLANE}, "
        f"which is not ported yet")
