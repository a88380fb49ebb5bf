"""The port's TFRecord data plane (audio_mps_tpu_torch/data: tfrecord.py,
pipeline.py, nsynth.py, audio.get_audio) against the JAX package's on the
same files, on the CPU. Every case of tests/test_tfrecord.py, each in both
directions: the JAX package writes and the port reads, the port writes and
the JAX package reads; the two writers give equal bytes; the same corrupt
or malformed input gives the same result or the same exception class; and
get_audio gives equal batches (the port's as CPU tensors) for a file and
a seed, in memory and streamed."""
import numpy as np
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu import data as jdata
from audio_mps_tpu import native as jnative
from audio_mps_tpu.data import pipeline as jpipeline
from audio_mps_tpu.data import tfrecord as jtfrecord
from audio_mps_tpu_torch import data as tdata
from audio_mps_tpu_torch import native as tnative
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.data import pipeline as tpipeline
from audio_mps_tpu_torch.data import tfrecord as ttfrecord

PKG = {"jax": jdata, "port": tdata}
OTHER = {"jax": "port", "port": "jax"}
WRITERS = pytest.mark.parametrize("writer", ["jax", "port"])


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_crc32c_known_vectors():
    """RFC 3720's check value, and every CRC32C the port can take (the
    accelerated one, the native library, the pure-Python table) equal to
    the JAX package's on random data, masked too."""
    assert ttfrecord.crc32c(b"123456789") == 0xE3069283
    assert ttfrecord._crc32c_py(b"123456789") == 0xE3069283
    assert ttfrecord._crc32c_py(b"") == 0
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 8, 9, 1024):
        data = rng.bytes(n)
        want = jtfrecord._crc32c_py(data)
        assert ttfrecord.crc32c(data) == want
        assert ttfrecord._crc32c_py(data) == want
        assert tnative.crc32c(data) == want
        assert ttfrecord.masked_crc(data) == jtfrecord.masked_crc(data)


@pytest.mark.smoke
@WRITERS
def test_record_roundtrip(writer, tmp_path):
    payloads = [b"hello", b"", b"x" * 1000]
    paths = {}
    for pkg in ("jax", "port"):
        paths[pkg] = str(tmp_path / f"{pkg}.tfrecords")
        PKG[pkg].write_records(paths[pkg], payloads)
    assert _bytes(paths["jax"]) == _bytes(paths["port"])
    reader = PKG[OTHER[writer]]
    assert list(reader.read_records(paths[writer])) == payloads


def _corrupted(tmp_path, writer, edit):
    path = str(tmp_path / "x.tfrecords")
    PKG[writer].write_records(path, [b"hello world"])
    raw = edit(bytearray(_bytes(path)))
    with open(path, "wb") as f:
        f.write(bytes(raw))
    return path


def _flip_payload_byte(raw):
    raw[14] ^= 0xFF
    return raw


@WRITERS
def test_corrupt_record_detected(writer, tmp_path):
    """A flipped payload byte raises IOError in both readers."""
    path = _corrupted(tmp_path, writer, _flip_payload_byte)
    for pkg in ("jax", "port"):
        with pytest.raises(IOError, match="corrupt payload CRC"):
            list(PKG[pkg].read_records(path))
    # unverified, both readers return the same (corrupt) payload
    assert (list(ttfrecord.read_records(path, verify=False))
            == list(jtfrecord.read_records(path, verify=False)))


@WRITERS
@pytest.mark.parametrize("cut, message", [
    (2, "truncated record CRC"), (6, "truncated record payload"),
    (23, "truncated record header")])
def test_truncated_between_payload_and_crc(writer, cut, message, tmp_path):
    """A file cut inside the payload CRC, the payload or the header raises
    the module's IOError contract in both readers, not struct.error."""
    path = _corrupted(tmp_path, writer, lambda raw: raw[:-cut])
    for pkg in ("jax", "port"):
        with pytest.raises(IOError, match=message):
            list(PKG[pkg].read_records(path))


EXAMPLE = {
    "audio": np.linspace(-1, 1, 640).astype(np.float32),
    "pitch": np.array([50], dtype=np.int64),
    "note": np.array([7, -3], dtype=np.int64),
    "instrument_family_str": [b"guitar"],
}


@WRITERS
def test_example_roundtrip(writer):
    buf = PKG[writer].encode_example(EXAMPLE)
    assert buf == PKG[OTHER[writer]].encode_example(EXAMPLE)
    dec = PKG[OTHER[writer]].decode_example(buf)
    np.testing.assert_array_equal(dec["audio"], EXAMPLE["audio"])
    np.testing.assert_array_equal(dec["pitch"], EXAMPLE["pitch"])
    np.testing.assert_array_equal(dec["note"], EXAMPLE["note"])
    assert dec["instrument_family_str"] == [b"guitar"]


def test_handcrafted_wire_bytes():
    """Decode against hand-assembled wire bytes (no self-referential
    encoder): Example{features{feature{key:"audio" value{float_list{1.5}}}}};
    also a float list split into a packed run and an unpacked scalar."""
    float_list = b"\x0a\x04" + np.float32(1.5).tobytes()
    split = (b"\x0a\x08" + np.float32([1.5, -2.0]).tobytes()
             + b"\x0d" + np.float32(3.25).tobytes())
    for fl, want in ((float_list, [1.5]), (split, [1.5, -2.0, 3.25])):
        feature = b"\x12" + bytes([len(fl)]) + fl
        entry = b"\x0a\x05audio" + b"\x12" + bytes([len(feature)]) + feature
        features = b"\x0a" + bytes([len(entry)]) + entry
        example = b"\x0a" + bytes([len(features)]) + features
        dec = ttfrecord.decode_example(example)
        np.testing.assert_allclose(dec["audio"], want)
        np.testing.assert_array_equal(
            dec["audio"], jtfrecord.decode_example(example)["audio"])
        np.testing.assert_array_equal(ttfrecord._extract_audio(example),
                                      jtfrecord._extract_audio(example))


@WRITERS
def test_audio_tfrecords_roundtrip(writer, tmp_path):
    waves = np.random.RandomState(0).randn(5, 256).astype(np.float32)
    paths = {}
    for pkg in ("jax", "port"):
        paths[pkg] = str(tmp_path / f"{pkg}.tfrecords")
        PKG[pkg].write_audio_tfrecords(paths[pkg], waves)
    assert _bytes(paths["jax"]) == _bytes(paths["port"])
    read = PKG[OTHER[writer]].read_audio_tfrecords
    np.testing.assert_array_equal(read(paths[writer]), waves)
    # padding / truncation
    np.testing.assert_array_equal(read(paths[writer], 128), waves[:, :128])
    padded = read(paths[writer], 300)
    np.testing.assert_array_equal(padded[:, :256], waves)
    assert (padded[:, 256:] == 0).all()


@WRITERS
def test_append_mode_extends_file(writer, tmp_path):
    """append=True is a plain record concatenation: the extended file reads
    back as one dataset in the other package, the same bytes either way."""
    rng = np.random.RandomState(1)
    a, b = (rng.randn(3, 64).astype(np.float32) for _ in range(2))
    paths = {}
    for pkg in ("jax", "port"):
        paths[pkg] = str(tmp_path / f"{pkg}.tfrecords")
        PKG[pkg].write_audio_tfrecords(paths[pkg], a)
        PKG[pkg].write_audio_tfrecords(paths[pkg], b, append=True)
    assert _bytes(paths["jax"]) == _bytes(paths["port"])
    out = PKG[OTHER[writer]].read_audio_tfrecords(paths[writer])
    np.testing.assert_array_equal(out, np.concatenate([a, b]))


def _write_nsynth_fixture(data, path, n=12):
    """A miniature NSynth-schema TFRecord, written by ``data``'s codec."""
    rng = np.random.RandomState(0)
    fams = [b"guitar", b"organ", b"flute"]
    payloads = []
    for i in range(n):
        payloads.append(data.encode_example({
            "note": np.array([i], np.int64),
            "pitch": np.array([50 if i % 2 == 0 else 60], np.int64),
            "sample_rate": np.array([16000], np.int64),
            "instrument_source_str": [b"acoustic"],
            "instrument_family_str": [fams[i % 3]],
            "audio": rng.randn(1000).astype(np.float32),
        }))
    data.write_records(path, payloads)


@WRITERS
def test_nsynth_filtering(writer, tmp_path):
    path = str(tmp_path / "nsynth.tfrecord")
    _write_nsynth_fixture(PKG[writer], path)
    for kw, length, n in ((dict(pitch=50), 1000, 6),
                          (dict(instrument="guitar"), 1000, 4),
                          (dict(instrument="guitar", pitch=50), 2048, 2),
                          (dict(pitch=60, count=5), 1000, 2)):
        got = tdata.NSynthDataset(path, **kw).load_audio(length=length)
        want = jdata.NSynthDataset(path, **kw).load_audio(length=length)
        assert got.shape == (n, length), kw
        np.testing.assert_array_equal(got, want)
    ex_port = list(tdata.NSynthDataset(path, pitch=50).examples(500))
    ex_jax = list(jdata.NSynthDataset(path, pitch=50).examples(500))
    assert [sorted(e) for e in ex_port] == [sorted(e) for e in ex_jax]


@WRITERS
def test_nsynth_load_audio_skip_chunks(writer, tmp_path):
    """`skip` pages through matches: consecutive (skip, max_examples)
    windows tile the full load, as in the JAX package; a consumed tail is
    empty; no match at skip=0 raises IOError in both."""
    path = str(tmp_path / "nsynth.tfrecord")
    _write_nsynth_fixture(PKG[writer], path)
    ds, jds = (pkg.NSynthDataset(path, pitch=50) for pkg in (tdata, jdata))
    full = ds.load_audio(length=500)
    np.testing.assert_array_equal(full, jds.load_audio(length=500))
    for s in (0, 4, 6):
        got = ds.load_audio(length=500, max_examples=4, skip=s)
        np.testing.assert_array_equal(
            got, jds.load_audio(length=500, max_examples=4, skip=s))
    parts = [ds.load_audio(length=500, max_examples=4, skip=s)
             for s in (0, 4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    assert ds.load_audio(length=500, max_examples=4, skip=6).shape \
        == (0, 500)
    for pkg in (tdata, jdata):
        with pytest.raises(IOError):
            pkg.NSynthDataset(path, pitch=99).load_audio(length=500)
    b_port = next(ds.iterator(batch_size=4, length=500, seed=3))
    b_jax = next(jds.iterator(batch_size=4, length=500, seed=3))
    np.testing.assert_array_equal(b_port, b_jax)


@pytest.mark.parametrize("kw", [dict(instrument="banjo"), dict(pitch=500),
                                dict(pitch=20)])
def test_nsynth_validation(kw):
    for pkg in (tdata, jdata):
        with pytest.raises(ValueError):
            pkg.NSynthDataset("x", **kw)


@WRITERS
@pytest.mark.parametrize("stream", [False, True])
def test_get_audio_tfrecord_branch(writer, stream, tmp_path):
    """Equal batches from both get_audio calls on one file and seed, past
    the first epoch (10 rows, batches of 4: two a shuffle) and, streamed,
    past the first fill of a 16-record reservoir; the port's batches are
    float32 CPU tensors whose rows are dataset rows."""
    waves = np.random.RandomState(1).randn(10, 512).astype(np.float32)
    PKG[writer].write_audio_tfrecords(
        str(tmp_path / "guitar.tfrecords"), waves)
    it = tdata.get_audio(str(tmp_path), "guitar", CMPSConfig(minibatch_size=4),
                         sample_duration=512, seed=5, stream=stream,
                         device="cpu")
    jit = jdata.get_audio(str(tmp_path), "guitar",
                          jconfig.CMPSConfig(minibatch_size=4),
                          sample_duration=512, seed=5, stream=stream)
    rows = {w.tobytes() for w in waves}
    for _ in range(7):
        batch = next(it)
        assert isinstance(batch, torch.Tensor)
        assert batch.dtype == torch.float32 and batch.device.type == "cpu"
        assert batch.shape == (4, 512)
        np.testing.assert_array_equal(batch.numpy(), next(jit))
        assert all(r.tobytes() in rows for r in batch.numpy())


def test_get_audio_tfrecord_suffix_and_threshold(tmp_path):
    """``{dataset}.tfrecord`` is found too; a file above the threshold
    streams (the reservoir's batches, not the in-memory shuffle's)."""
    waves = np.random.RandomState(2).randn(6, 64).astype(np.float32)
    tdata.write_audio_tfrecords(str(tmp_path / "organ.tfrecord"), waves)
    cfg, jcfg = CMPSConfig(minibatch_size=2), jconfig.CMPSConfig(
        minibatch_size=2)
    for threshold in (1 << 30, 1):
        it = tdata.get_audio(str(tmp_path), "organ", cfg,
                             sample_duration=64, seed=0,
                             stream_threshold_bytes=threshold, device="cpu")
        jit = jdata.get_audio(str(tmp_path), "organ", jcfg,
                              sample_duration=64, seed=0,
                              stream_threshold_bytes=threshold)
        for _ in range(4):
            np.testing.assert_array_equal(next(it).numpy(), next(jit))


def test_get_audio_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError) as got:
        tdata.get_audio(str(tmp_path), "guitar", CMPSConfig(),
                        sample_duration=64, device="cpu")
    with pytest.raises(FileNotFoundError) as want:
        jdata.get_audio(str(tmp_path), "guitar", jconfig.CMPSConfig(),
                        sample_duration=64)
    assert str(got.value) == str(want.value)


@WRITERS
def test_streaming_iterator(writer, tmp_path):
    """iter_audio_tfrecords draws the JAX package's batches for a seed:
    repeated (ten batches through a 16-record reservoir over 50 records)
    and drained without repeat."""
    path = str(tmp_path / "big.tfrecords")
    waves = np.random.RandomState(0).randn(50, 64).astype(np.float32)
    PKG[writer].write_audio_tfrecords(path, waves)
    kw = dict(batch_size=8, sample_duration=64, shuffle_buffer=16, seed=3,
              repeat=True)
    it = tpipeline.iter_audio_tfrecords(path, **kw)
    jit = jpipeline.iter_audio_tfrecords(path, **kw)
    seen = set()
    for _ in range(10):
        b = next(it)
        assert b.shape == (8, 64)
        np.testing.assert_array_equal(b, next(jit))
        seen.update(round(float(row[0]), 5) for row in b)
    assert len(seen) > 30
    kw = dict(batch_size=10, sample_duration=64, shuffle_buffer=8,
              repeat=False)
    got = list(tpipeline.iter_audio_tfrecords(path, **kw))
    want = list(jpipeline.iter_audio_tfrecords(path, **kw))
    assert sum(b.shape[0] for b in got) == 50
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_array_dataset_tiles_small_datasets():
    """ArrayDataset tiles a dataset smaller than a batch up to one, and
    draws the JAX package's permutations epoch after epoch."""
    data = np.arange(3 * 4, dtype=np.float32).reshape(3, 4)
    for kw in (dict(batch_size=5), dict(batch_size=2, shuffle=False),
               dict(batch_size=2, drop_remainder=False)):
        a = iter(tpipeline.ArrayDataset(data, seed=7, **kw))
        b = iter(jpipeline.ArrayDataset(data, seed=7, **kw))
        for _ in range(6):
            np.testing.assert_array_equal(next(a), next(b))
    with pytest.raises(ValueError):
        tpipeline.ArrayDataset(np.zeros(4), 2)


def _decode(decode, buf):
    try:
        return decode(buf)
    except (IndexError, ValueError) as e:
        return type(e)


def _same(a, b):
    if a is None or b is None or isinstance(a, type) or isinstance(b, type):
        return a is b
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b,
                                                            equal_nan=True)
    return a == b


def test_decoder_fuzz_no_crash():
    """Random garbage never crashes either decoder; both give the same
    dict or raise the same exception class, and the two native scanners
    the same answer (None or the same floats)."""
    rng = np.random.RandomState(0)
    for n in [0, 1, 3, 17, 256]:
        for _ in range(200):
            buf = rng.bytes(n)
            assert _same(_decode(ttfrecord.decode_example, buf),
                         _decode(jtfrecord.decode_example, buf))
            got = tnative.parse_float_feature(buf, "audio")
            if jnative.available():
                want = jnative.parse_float_feature(buf, "audio")
                assert (got is None) == (want is None)
                if got is not None:
                    np.testing.assert_array_equal(got, want)
            assert _same(ttfrecord._extract_audio(buf),
                         jtfrecord._extract_audio(buf))
