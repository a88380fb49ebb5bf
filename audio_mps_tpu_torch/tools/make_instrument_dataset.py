"""Synthesize an instrument-like NSynth-schema TFRecord and run it through
the repo's own ETL into an audio-only training dataset (a copy of the JAX
package's ``tools/make_instrument_dataset.py`` on the port's data plane:
the same flags and seed write the same bytes).

The reference's real training artifacts are runs on ``guitar.tfrecords`` /
``organ.tfrecords`` (reference: data.py:28-34) whose data blobs are
stripped from its repository. This tool manufactures stand-ins with
realistic structure — plucked-string synthesis (a stack of ~12 harmonics
with 1/h amplitudes, per-harmonic decay, string inharmonicity, soft
onset, pick noise) and a sustained pipe-organ synth (harmonic drawbar
stack, pipe speech, chiff, tremulant) — writes them in the FULL NSynth
schema (note/pitch/sample_rate/instrument fields + audio[64000]), and then
exercises the exact ETL path the reference used (make-small-dataset.py):
NSynth filter -> pad to 2^16 -> audio-only Examples.

    python -m audio_mps_tpu_torch.tools.make_instrument_dataset \
        --output_dir=data --name=guitar --pitch=50 --count=100
    python -m audio_mps_tpu_torch.tools.make_instrument_dataset \
        --output_dir=data --name=organ --family=organ --pitch=55 --count=100

Then train on it on the card:

    python -m audio_mps_tpu_torch.train --dataset=guitar --datadir=data
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.nsynth import NSynthDataset
from ..data.tfrecord import (encode_example, write_audio_tfrecords,
                             write_records)

NSYNTH_T = 64000           # NSynth fixed audio length (4 s @ 16 kHz)


def midi_to_hz(pitch: int) -> float:
    return 440.0 * 2.0 ** ((pitch - 69) / 12.0)


def pluck(rng: np.random.RandomState, f0: float, t_samples: int = NSYNTH_T,
          sr: int = 16000, n_harmonics: int = 12) -> np.ndarray:
    """One plucked-string note: harmonic stack with per-harmonic decay,
    inharmonicity, soft onset, and pick noise."""
    t = np.arange(t_samples, dtype=np.float64) / sr
    inharm = 10 ** rng.uniform(-4.5, -3.5)          # string stiffness B
    tau0 = rng.uniform(0.6, 1.6)                    # fundamental decay (s)
    onset = rng.uniform(0.002, 0.01)                # attack time (s)
    wave = np.zeros_like(t)
    for h in range(1, n_harmonics + 1):
        fh = f0 * h * np.sqrt(1.0 + inharm * h * h)
        if fh >= sr / 2:
            break
        amp = (1.0 / h) * rng.uniform(0.7, 1.3)
        tau = tau0 / (1.0 + 0.8 * (h - 1))          # brighter dies faster
        phase = rng.uniform(0, 2 * np.pi)
        wave += amp * np.sin(2 * np.pi * fh * t + phase) * np.exp(-t / tau)
    wave *= 1.0 - np.exp(-t / onset)                # soft attack
    # pick transient: a few ms of filtered noise at the onset
    n_noise = int(0.004 * sr)
    noise = rng.randn(n_noise) * np.exp(-np.arange(n_noise) / (0.001 * sr))
    wave[:n_noise] += 0.15 * noise
    peak = np.abs(wave).max()
    return (0.5 * wave / max(peak, 1e-9)).astype(np.float32)


def organ(rng: np.random.RandomState, f0: float, t_samples: int = NSYNTH_T,
          sr: int = 16000) -> np.ndarray:
    """One sustained pipe-organ note — the stand-in for the reference's
    second stripped blob, ``organ.tfrecords``: a harmonic drawbar stack
    (pipes are harmonic — no inharmonicity, unlike the plucked string),
    per-pipe "speech" onsets, a breathy chiff transient, gentle tremulant
    AM, and a release fade. The sustained envelope is the structural
    contrast with pluck(): energy does not decay over the note."""
    t = np.arange(t_samples, dtype=np.float64) / sr
    drawbars = [(1, 1.0), (2, 0.9), (3, 0.45), (4, 0.4),
                (5, 0.22), (6, 0.18), (8, 0.12)]
    wave = np.zeros_like(t)
    for h, base_amp in drawbars:
        fh = f0 * h
        if fh >= sr / 2:
            break
        amp = base_amp * rng.uniform(0.85, 1.15)
        phase = rng.uniform(0, 2 * np.pi)
        speech = rng.uniform(0.01, 0.05) / np.sqrt(h)   # pipe speech time
        env = 1.0 - np.exp(-t / speech)
        wave += amp * env * np.sin(2 * np.pi * fh * t + phase)
    trem_rate = rng.uniform(4.5, 6.5)                    # tremulant AM
    trem_depth = rng.uniform(0.03, 0.10)
    wave *= 1.0 + trem_depth * np.sin(
        2 * np.pi * trem_rate * t + rng.uniform(0, 2 * np.pi))
    n_noise = int(0.02 * sr)                             # chiff at onset
    noise = rng.randn(n_noise) * np.exp(-np.arange(n_noise) / (0.006 * sr))
    wave[:n_noise] += 0.08 * noise
    n_rel = int(0.2 * sr)                                # release fade
    wave[-n_rel:] *= np.linspace(1.0, 0.0, n_rel) ** 2
    peak = np.abs(wave).max()
    return (0.5 * wave / max(peak, 1e-9)).astype(np.float32)


SYNTHS = {"pluck": pluck, "organ": organ}


def synthesize_nsynth(path: str, pitch, count: int, family: str,
                      seed: int = 0, synth: str = "auto",
                      flush_every: int = 256):
    """`pitch` may be an int or a list of MIDI pitches — multi-pitch
    datasets cycle through the list note-by-note (the NSynth-scale
    streaming soak and the >=4-class latent anchor both need several
    pitches in ONE file). Records append in chunks so multi-GB datasets
    never hold all waveforms in memory."""
    rng = np.random.RandomState(seed)
    pitches = [pitch] if np.isscalar(pitch) else list(pitch)
    gen = SYNTHS[synth if synth != "auto"
                 else ("organ" if family == "organ" else "pluck")]
    recs, written = [], 0
    for i in range(count):
        p = pitches[i % len(pitches)]
        # small per-note detune, like real instrument takes
        f = midi_to_hz(p) * 2.0 ** (rng.uniform(-10, 10) / 1200.0)
        recs.append(encode_example({
            "note": np.array([i], np.int64),
            "pitch": np.array([p], np.int64),
            "sample_rate": np.array([16000], np.int64),
            "instrument_source_str": [b"acoustic"],
            "instrument_family_str": [family.encode()],
            "audio": gen(rng, f),
        }))
        if len(recs) >= flush_every:
            write_records(path, recs, append=written > 0)
            written += len(recs)
            recs = []
    if recs or written == 0:
        write_records(path, recs, append=written > 0)
        written += len(recs)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--output_dir", default="data")
    ap.add_argument("--name", default="guitarish",
                    help="dataset name; writes <name>.tfrecords")
    ap.add_argument("--pitch", type=int, default=50)
    ap.add_argument("--pitches", default=None,
                    help="comma-separated MIDI pitches; overrides --pitch "
                         "and cycles through the list note-by-note (the "
                         "NSynth-scale streaming soak / multi-class "
                         "latent datasets)")
    ap.add_argument("--count", type=int, default=100)
    ap.add_argument("--family", default="guitar")
    ap.add_argument("--synth", default="auto",
                    choices=["auto"] + sorted(SYNTHS),
                    help="waveform generator; auto maps family 'organ' to "
                         "the sustained drawbar synth, anything else to "
                         "the plucked string")
    ap.add_argument("--length", type=int, default=2 ** 16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    pitches = ([int(p) for p in args.pitches.split(",")]
               if args.pitches else args.pitch)
    raw = os.path.join(args.output_dir, f"{args.name}-nsynth.tfrecord")
    n = synthesize_nsynth(raw, pitches, args.count, args.family,
                          args.seed, synth=args.synth)
    print(f"synthesized {n} NSynth-schema notes at MIDI {pitches} "
          f"-> {raw}", flush=True)

    # the reference's ETL path: filter + pad + strip to audio-only
    # (pitch=-1 = all pitches, reference reader.py:17-20 wildcard)
    etl_pitch = args.pitch if not args.pitches else -1
    ds = NSynthDataset(raw, instrument=args.family, pitch=etl_pitch)
    out = os.path.join(args.output_dir, f"{args.name}.tfrecords")
    total = 0
    # chunked ETL in ONE pass over the source (paging with
    # load_audio(skip=...) would re-parse the whole prefix per chunk —
    # O(N^2) at NSynth scale); multi-GB datasets never hold every waveform
    chunk, rows = 512, []
    for ex in ds.examples(args.length):
        rows.append(ex["audio"])
        if len(rows) >= chunk or total + len(rows) >= args.count:
            write_audio_tfrecords(out, np.stack(rows), append=total > 0)
            total += len(rows)
            rows = []
            print(f"  ETL: {total}/{args.count}", flush=True)
        if total >= args.count:
            break
    if rows:
        write_audio_tfrecords(out, np.stack(rows), append=total > 0)
        total += len(rows)
    print(f"wrote {total} examples of length {args.length} to {out}")


if __name__ == "__main__":
    main()
