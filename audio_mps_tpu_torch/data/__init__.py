"""Datasets of the PyTorch/CUDA port: damped sines, and the TFRecord data
plane (record framing, the Example codec, NSynth filtering, batching)."""
from .audio import get_audio
from .nsynth import NSynthDataset
from .pipeline import ArrayDataset
from .synthetic import damped_sine_batch, damped_sine_iterator
from .tfrecord import (decode_example, encode_example, read_audio_tfrecords,
                       read_records, write_audio_tfrecords, write_records)

__all__ = [
    "get_audio", "NSynthDataset", "ArrayDataset", "damped_sine_batch",
    "damped_sine_iterator", "decode_example", "encode_example",
    "read_audio_tfrecords", "read_records", "write_audio_tfrecords",
    "write_records",
]
