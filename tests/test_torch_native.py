"""The port's native data plane (audio_mps_tpu_torch/native: tfrec.cc built
with g++ and loaded by ctypes) against the JAX package's functions, on the
CPU: CRC parity, Example wire-format parsing parity, speed sanity; where
the port builds its library (its own build directory, nothing under
audio_mps_tpu/); and that a failed build is reported, not swallowed, while
the pure-Python codec still reads the file."""
import shutil
import struct
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from audio_mps_tpu import native as jnative
from audio_mps_tpu.data.tfrecord import (_crc32c_py, encode_example,
                                         masked_crc, write_audio_tfrecords)
from audio_mps_tpu_torch import native
from audio_mps_tpu_torch.data import tfrecord as ttfrecord

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def toolchain():
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH: the native library cannot be built")


@pytest.mark.smoke
def test_crc32c_matches_python():
    assert native.crc32c(b"123456789") == 0xE3069283
    rng = np.random.RandomState(0)
    for n in [0, 1, 7, 8, 9, 1000, 65536]:
        data = rng.bytes(n)
        assert native.crc32c(data) == _crc32c_py(data), n


def test_masked_crc_matches():
    data = np.random.RandomState(1).bytes(4096)
    assert native.masked_crc(data) == masked_crc(data)
    assert native.masked_crc(data) == ttfrecord.masked_crc(data)


def test_parse_float_feature_matches_codec():
    audio = np.linspace(-1, 1, 64000).astype(np.float32)
    rec = encode_example({
        "pitch": np.array([50], np.int64),
        "audio": audio,
        "label": [b"guitar"],
    })
    out = native.parse_float_feature(rec, "audio")
    np.testing.assert_array_equal(out, audio)
    np.testing.assert_array_equal(out, jnative.parse_float_feature(rec))
    assert native.parse_float_feature(rec, "absent") is None
    assert native.parse_float_feature(rec, "pitch") is None


def test_parse_rejects_garbage():
    assert native.parse_float_feature(b"\xff\xff\xff\xff") is None
    assert native.parse_float_feature(b"") is None


def test_read_audio_uses_native(tmp_path, monkeypatch):
    """A file the JAX package wrote reads back through the port's native
    scanner alone (the pure-Python decoder is made to fail), well under a
    second for 20 x 16k floats."""
    path = str(tmp_path / "w.tfrecords")
    waves = np.random.RandomState(0).randn(20, 16000).astype(np.float32)
    write_audio_tfrecords(path, waves)

    def refuse(buf):
        raise AssertionError("the pure-Python decoder ran")
    monkeypatch.setattr(ttfrecord, "decode_example", refuse)
    t0 = time.perf_counter()
    out = ttfrecord.read_audio_tfrecords(path)
    dt = time.perf_counter() - t0
    np.testing.assert_array_equal(out, waves)
    assert dt < 2.0


def test_parse_split_and_unpacked_float_lists():
    """protobuf allows the float list as multiple packed runs and/or
    unpacked wire-5 scalars; the scanner concatenates all of them, as the
    JAX package's does and the pure-Python decoder agrees."""
    vals = [1.5, -2.0, 3.25]
    # FloatList: packed run of 2 + one unpacked scalar
    fl = (b"\x0a\x08" + struct.pack("<2f", *vals[:2])      # field1 wire2 len8
          + b"\x0d" + struct.pack("<f", vals[2]))          # field1 wire5
    feat = b"\x12" + bytes([len(fl)]) + fl                 # Feature.float_list
    entry = b"\x0a\x05audio" + b"\x12" + bytes([len(feat)]) + feat
    feats = b"\x0a" + bytes([len(entry)]) + entry
    rec = b"\x0a" + bytes([len(feats)]) + feats
    out = native.parse_float_feature(rec, "audio")
    np.testing.assert_allclose(out, vals)
    np.testing.assert_array_equal(out, jnative.parse_float_feature(rec))
    np.testing.assert_allclose(ttfrecord.decode_example(rec)["audio"], vals)


def test_truncated_varint_lengths_rejected():
    """Oversized length varints must be rejected, not wrap the cursor."""
    # claims a 2^40-byte features field
    evil = b"\x0a" + b"\x80\x80\x80\x80\x80\x01"
    assert native.parse_float_feature(evil, "audio") is None
    assert jnative.parse_float_feature(evil, "audio") is None


def _jax_tree():
    """Files under audio_mps_tpu/ but bytecode caches and the JAX loader's
    own library (which its tests build there)."""
    root = REPO / "audio_mps_tpu"
    return {p.relative_to(root) for p in root.rglob("*")
            if "__pycache__" not in p.parts and p.name != "libamt_tfrec.so"}


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The port's loader pointed at an empty build directory; the loader's
    cached result and the CRC choice are cleared before and after."""
    build = tmp_path / "build"
    monkeypatch.setattr(native, "build_dir", lambda: build)
    native._load.cache_clear()
    ttfrecord._crc_impl.cache_clear()
    yield build
    monkeypatch.undo()
    native._load.cache_clear()
    ttfrecord._crc_impl.cache_clear()


def test_builds_into_its_own_directory(fresh_build):
    """In a checkout the library goes to build/native (gitignored); a build
    writes one library named by its hash there and nothing under
    audio_mps_tpu/, and a second build reuses it."""
    jnative.available()     # the JAX package's own build, if it is due
    before = _jax_tree()
    assert native.available(), native.build_error()
    assert native.build_error() is None
    libs = sorted(p.name for p in fresh_build.iterdir())
    assert len(libs) == 1 and libs[0].startswith("libamt_tfrec-")
    assert libs[0].endswith(".so")
    again = native.build()
    assert not again["rebuilt"] and Path(again["path"]).parent == fresh_build
    assert _jax_tree() == before
    assert not list((REPO / "audio_mps_tpu").rglob("libamt_tfrec-*"))


def test_default_build_dir_is_the_checkouts_build():
    assert native.build_dir() == REPO / "build" / "native"


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_build_failure_is_reported(fault, fresh_build, tmp_path,
                                   monkeypatch):
    """No g++ on PATH, or a source g++ refuses: available() is False and
    build_error() says why (the compiler's own output for a refused
    source); the entry points that need the library raise with that
    reason, and the pure-Python codec still reads a file."""
    if fault == "no_compiler":
        monkeypatch.setenv("PATH", str(tmp_path / "empty"))
        expect = "g++ not found on PATH"
    else:
        bad = tmp_path / "tfrec.cc"
        bad.write_text("extern \"C\" int amt_crc32c( {\n")
        monkeypatch.setattr(native, "SRC", bad)
        expect = "error"
    # no accelerated CRC either: the pure-Python table
    monkeypatch.setitem(sys.modules, "google_crc32c", None)
    assert not native.available()
    err = native.build_error()
    assert err is not None and expect in err, err
    assert native.parse_float_feature(b"\x0a\x00") is None
    with pytest.raises(RuntimeError, match="native library unavailable"):
        native.crc32c(b"x")
    assert ttfrecord._crc_impl() is ttfrecord._crc32c_py
    path = str(tmp_path / "w.tfrecords")
    waves = np.random.RandomState(3).randn(3, 50).astype(np.float32)
    write_audio_tfrecords(path, waves)
    np.testing.assert_array_equal(ttfrecord.read_audio_tfrecords(path),
                                  waves)
    assert not list(fresh_build.glob("*.so"))
