"""The port's dataset tools (audio_mps_tpu_torch/tools/make_small_dataset.py
and make_instrument_dataset.py) against the JAX package's
(tools/make_small_dataset.py, tools/make_instrument_dataset.py): for the
same flags and seed, at a small count and length, each writes files byte
for byte equal to the JAX tool's."""
import runpy
import sys
from pathlib import Path

import pytest

from audio_mps_tpu_torch.tools import (make_instrument_dataset,
                                       make_small_dataset)

REPO = Path(__file__).resolve().parents[1]


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(str(REPO / "tools" / f"{name}.py"), run_name="__main__")


def _bytes(path):
    return Path(path).read_bytes()


@pytest.mark.parametrize("flags", [
    ["--name=guitar", "--pitch=50"],
    ["--name=organ", "--family=organ", "--pitch=55", "--seed=3"],
    ["--name=multi", "--pitches=48,60", "--synth=organ"],
])
def test_make_instrument_dataset_matches_jax(flags, tmp_path, monkeypatch):
    """The NSynth-schema file and the audio-only dataset the ETL writes from
    it (filtered, padded to --length): the same bytes from both tools."""
    common = ["--count=3", "--length=4096"]
    make_instrument_dataset.main(common + flags
                                 + [f"--output_dir={tmp_path / 'port'}"])
    _run_jax_tool("make_instrument_dataset",
                  common + flags + [f"--output_dir={tmp_path / 'jax'}"],
                  monkeypatch)
    name = flags[0].split("=")[1]
    for f in (f"{name}-nsynth.tfrecord", f"{name}.tfrecords"):
        got, want = tmp_path / "port" / f, tmp_path / "jax" / f
        assert got.stat().st_size > 3 * 4096
        assert _bytes(got) == _bytes(want), f


@pytest.mark.parametrize("flags", [
    ["--pitch=48", "--instrument=all"],
    ["--pitch=60", "--instrument=guitar", "--count=1", "--length=1000"],
])
def test_make_small_dataset_matches_jax(flags, tmp_path, monkeypatch):
    """An audio-only subset carved from an NSynth-schema file (two pitches,
    two notes each): the same bytes from both tools."""
    make_instrument_dataset.synthesize_nsynth(
        str(tmp_path / "nsynth.tfrecord"), [48, 60], 4, "guitar", seed=1)
    common = [f"--input={tmp_path / 'nsynth.tfrecord'}", "--length=2048"]
    make_small_dataset.main(common + flags
                            + [f"--output={tmp_path / 'port.tfrecords'}"])
    _run_jax_tool("make_small_dataset",
                  common + flags + [f"--output={tmp_path / 'jax.tfrecords'}"],
                  monkeypatch)
    got = _bytes(tmp_path / "port.tfrecords")
    assert got and got == _bytes(tmp_path / "jax.tfrecords")
