"""NSynth dataset loading + filtering (a copy of
``audio_mps_tpu/data/nsynth.py``; reference: reader.py).

Reads the full NSynth TFRecord schema (reference: reader.py:43-52), filters
by instrument family and/or pitch (reference: reader.py:54-66), and batches
with padding to a fixed length (reference: reader.py:30-35) — all with the
in-repo TFRecord codec, no TensorFlow.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .pipeline import ArrayDataset
from .tfrecord import decode_example, read_records

INSTRUMENTS = ["all", "bass", "brass", "flute", "guitar", "keyboard",
               "mallet", "organ", "reed", "string", "synth_lead", "vocal"]


class NSynthDataset:
    """Filtered NSynth loader (reference: reader.py:3-40).

    Unlike the reference this is an eager reader: records are parsed,
    filtered, and padded into an [N, length] array up front (NSynth subsets
    at one pitch are ~100 examples — reference make-small-dataset.py:19).
    """

    def __init__(self, tfrecord_path: str, instrument: str = "all",
                 pitch: int = -1, count: int = -1):
        if instrument.lower() not in INSTRUMENTS:
            raise ValueError("instrument must be one of: "
                             + ", ".join(INSTRUMENTS))
        if pitch != -1 and pitch not in range(21, 109):
            raise ValueError("pitch must be in range 21-108, or -1 for all"
                             " pitches")
        self.record_path = tfrecord_path
        self.instrument = instrument.lower()
        self.pitch = pitch
        self.count = count

    def _match(self, ex: dict) -> bool:
        """(reference: reader.py:54-66)"""
        if self.instrument != "all":
            fam = ex.get("instrument_family_str")
            fam = fam[0].decode("utf-8") if fam else ""
            if fam != self.instrument:
                return False
        if self.pitch != -1:
            pitch = ex.get("pitch")
            if pitch is None or int(np.asarray(pitch).reshape(-1)[0]) != self.pitch:
                return False
        return True

    def examples(self, length: int = 2 ** 16) -> Iterator[dict]:
        """Yield parsed + filtered examples with audio padded/cut to
        `length`."""
        seen = 0
        for rec in read_records(self.record_path):
            if self.count >= 0 and seen >= self.count:
                return
            seen += 1
            ex = decode_example(rec)
            if not self._match(ex):
                continue
            audio = np.asarray(ex.get("audio", ()), dtype=np.float32)
            if audio.shape[0] < length:
                audio = np.pad(audio, (0, length - audio.shape[0]))
            else:
                audio = audio[:length]
            ex["audio"] = audio
            yield ex

    def load_audio(self, length: int = 2 ** 16,
                   max_examples: Optional[int] = None,
                   skip: int = 0) -> np.ndarray:
        """[N, length] array of matching waveforms. `skip` drops the first
        N matches (chunked ETL over datasets too big to hold at once);
        a fully-consumed tail returns an empty [0, length] array instead
        of raising so chunk loops can terminate cleanly."""
        rows = []
        matched = 0
        for ex in self.examples(length):
            matched += 1
            if matched <= skip:
                continue
            rows.append(ex["audio"])
            if max_examples is not None and len(rows) >= max_examples:
                break
        if not rows:
            if skip > 0:
                return np.zeros((0, length), np.float32)
            raise IOError(f"{self.record_path}: no examples matched "
                          f"instrument={self.instrument} pitch={self.pitch}")
        return np.stack(rows)

    def iterator(self, batch_size: int = 32, length: int = 2 ** 16,
                 seed: int = 0) -> Iterator[np.ndarray]:
        """Shuffled, repeated, padded batches (reference: reader.py:22-40)."""
        return iter(ArrayDataset(self.load_audio(length), batch_size,
                                 seed=seed))
