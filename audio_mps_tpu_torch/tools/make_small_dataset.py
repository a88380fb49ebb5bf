"""Offline ETL: carve an audio-only TFRecord subset out of an NSynth
TFRecord (reference: make-small-dataset.py — reads nsynth-test.tfrecord at a
fixed pitch and re-serializes ~100 examples as audio-only Examples). A copy
of the JAX package's ``tools/make_small_dataset.py`` on the port's data
plane: the same flags write the same bytes.

    python -m audio_mps_tpu_torch.tools.make_small_dataset \
        --input=data/nsynth-test.tfrecord \
        --output=pitch_50.tfrecords --pitch=50 --instrument=all \
        --count=100 --length=65536
"""
from __future__ import annotations

import argparse

from ..data.nsynth import NSynthDataset
from ..data.tfrecord import write_audio_tfrecords


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True, help="NSynth TFRecord path")
    ap.add_argument("--output", default="pitch_50.tfrecords")
    ap.add_argument("--pitch", type=int, default=50)
    ap.add_argument("--instrument", default="all")
    ap.add_argument("--count", type=int, default=100,
                    help="max examples to write (reference keeps ~100)")
    ap.add_argument("--length", type=int, default=2 ** 16)
    args = ap.parse_args(argv)

    ds = NSynthDataset(args.input, instrument=args.instrument,
                       pitch=args.pitch)
    audio = ds.load_audio(length=args.length, max_examples=args.count)
    write_audio_tfrecords(args.output, audio)
    print(f"wrote {audio.shape[0]} examples of length {audio.shape[1]} "
          f"to {args.output}")


if __name__ == "__main__":
    main()
