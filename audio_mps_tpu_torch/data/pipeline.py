"""In-memory and streaming batching pipelines (a copy of
``audio_mps_tpu/data/pipeline.py``, numpy batches on the host).

The reference's training input is ``batch -> shuffle(24) -> repeat`` over a
TFRecord dataset (reference: data.py:37-43) — note it shuffles *whole
batches* with a tiny buffer (a quirk). Here the dataset (≤ a few hundred
waveforms in the reference's own ETL, make-small-dataset.py:19) lives in
host memory as one [N, T] array; we shuffle *examples* each epoch and batch
after, which strictly dominates the reference's mixing.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class ArrayDataset:
    """Shuffle-repeat-batch over an in-memory [N, T] array."""

    def __init__(self, data: np.ndarray, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim != 2:
            raise ValueError(f"expected [N, T] data, got {data.shape}")
        if data.shape[0] < batch_size and drop_remainder:
            # Small datasets still need full batches: tile up (the reference
            # would loop the repeat() anyway).
            reps = -(-batch_size // data.shape[0])
            data = np.tile(data, (reps, 1))
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        n = self.data.shape[0]
        b = self.batch_size
        while True:
            order = (self._rng.permutation(n) if self.shuffle
                     else np.arange(n))
            stop = (n // b) * b if self.drop_remainder else n
            for i in range(0, stop, b):
                yield self.data[order[i:i + b]]


def iter_audio_tfrecords(path: str, batch_size: int,
                         sample_duration: int = None,
                         shuffle_buffer: int = 1024, seed: int = 0,
                         repeat: bool = True) -> Iterator[np.ndarray]:
    """Streaming shuffled batches from a (possibly large) audio TFRecord
    file without loading it into memory: a reservoir-style shuffle buffer
    over streamed records (the scalable counterpart of ArrayDataset; the
    reference's datasets are small enough for memory, but full NSynth is
    not)."""
    from .tfrecord import read_records, _extract_audio

    rng = np.random.default_rng(seed)

    def records():
        while True:
            got = False
            for rec in read_records(path):
                audio = _extract_audio(rec)
                if audio is None:
                    continue
                audio = np.asarray(audio, dtype=np.float32)
                if sample_duration is not None:
                    if audio.shape[0] < sample_duration:
                        audio = np.pad(
                            audio, (0, sample_duration - audio.shape[0]))
                    else:
                        audio = audio[:sample_duration]
                got = True
                yield audio
            if not got:
                raise IOError(f"{path}: no audio records")
            if not repeat:
                return

    buf = []
    batch = []
    for audio in records():
        buf.append(audio)
        if len(buf) < shuffle_buffer:
            continue
        idx = rng.integers(len(buf))
        buf[idx], sample = buf[-1], buf[idx]
        buf.pop()
        batch.append(sample)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    # drain (non-repeat case)
    rng.shuffle(buf)
    for sample in buf:
        batch.append(sample)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
