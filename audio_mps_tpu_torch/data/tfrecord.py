"""TFRecord + tf.train.Example support with zero TensorFlow dependency (a
copy of ``audio_mps_tpu/data/tfrecord.py``).

The reference stores audio as TFRecord files of ``Example`` protos with a
single ``audio: float32[T]`` feature (reference: data.py:28-34,
make-small-dataset.py:24-32) and reads the full NSynth schema
(reference: reader.py:43-52). This module implements, from the wire format
up:

  - the TFRecord framing (length + masked CRC32C + payload + masked CRC32C),
  - CRC32C (Castagnoli) with the TFRecord masking,
  - a minimal protobuf codec for the Example message subset actually used
    (float_list / int64_list / bytes_list features),

so the same files interoperate with the reference's datasets in both
directions, and byte for byte with the JAX package's writer. CRC32C takes
``google_crc32c`` where it is installed, else the port's native library
(``native/``), else the pure-Python table; the choice is made on the first
call, not at import. The ``audio`` feature is pulled out by the native
scanner where the library loaded (``native.build_error()`` says why it did
not), else by the pure-Python decoder.
"""
from __future__ import annotations

import functools
import os
import struct
from typing import Dict, Iterable, Iterator, List, Union

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, poly 0x1EDC6F41 reflected = 0x82F63B78) + TFRecord mask
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_py(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _crc_impl():
    """The fastest CRC32C here: google_crc32c, the native library, or the
    pure-Python table."""
    try:
        import google_crc32c
    except ImportError:
        google_crc32c = None
    if google_crc32c is not None:
        return lambda data: int(google_crc32c.value(data))
    from .. import native
    return native.crc32c if native.available() else _crc32c_py


def crc32c(data: bytes) -> int:
    return _crc_impl()(data)


def masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset CRC mask."""
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            length, len_crc = struct.unpack("<QI", header)
            if verify and masked_crc(header[:8]) != len_crc:
                raise IOError(f"{path}: corrupt length CRC")
            payload = f.read(length)
            if len(payload) < length:
                raise IOError(f"{path}: truncated record payload")
            crc_bytes = f.read(4)
            if len(crc_bytes) < 4:
                raise IOError(f"{path}: truncated record CRC")
            data_crc = struct.unpack("<I", crc_bytes)[0]
            if verify and masked_crc(payload) != data_crc:
                raise IOError(f"{path}: corrupt payload CRC")
            yield payload


class RecordWriter:
    """Streaming TFRecord writer (context manager)."""

    def __init__(self, path: str, append: bool = False):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "ab" if append else "wb")

    def write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc(payload)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str, payloads: Iterable[bytes],
                  append: bool = False):
    """`append=True` extends an existing file (TFRecord framing is a plain
    record concatenation, so appended files read back seamlessly) — used
    by the multi-GB dataset synthesizers to flush in chunks."""
    with RecordWriter(path, append=append) as w:
        for p in payloads:
            w.write(p)


# ---------------------------------------------------------------------------
# Minimal protobuf wire codec (just what tf.train.Example needs)
# ---------------------------------------------------------------------------

def _write_varint(out: bytearray, value: int):
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int, payload: bytes):
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload


FeatureValue = Union[np.ndarray, List[bytes], List[int], List[float]]


def _encode_feature(value) -> bytes:
    """Encode one tf.train.Feature (oneof bytes_list=1 / float_list=2 /
    int64_list=3)."""
    inner = bytearray()
    if isinstance(value, (list, tuple)) and value and isinstance(value[0], (bytes, str)):
        for item in value:
            if isinstance(item, str):
                item = item.encode("utf-8")
            _write_len_delimited(inner, 1, item)      # BytesList.value
        body = bytearray()
        _write_len_delimited(body, 1, bytes(inner))   # Feature.bytes_list
        return bytes(body)
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.floating):
        payload = arr.astype("<f4").tobytes()
        _write_varint(inner, _tag(1, 2))              # FloatList.value packed
        _write_varint(inner, len(payload))
        inner += payload
        body = bytearray()
        _write_len_delimited(body, 2, bytes(inner))   # Feature.float_list
        return bytes(body)
    if np.issubdtype(arr.dtype, np.integer):
        packed = bytearray()
        for v in arr.reshape(-1).tolist():
            _write_varint(packed, v & 0xFFFFFFFFFFFFFFFF)
        _write_varint(inner, _tag(1, 2))              # Int64List.value packed
        _write_varint(inner, len(packed))
        inner += packed
        body = bytearray()
        _write_len_delimited(body, 3, bytes(inner))   # Feature.int64_list
        return bytes(body)
    raise TypeError(f"unsupported feature value: {value!r}")


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize a tf.train.Example: Example.features(1) ->
    Features.feature(1) map<string, Feature>."""
    fmap = bytearray()
    for name, value in features.items():
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))   # map key
        _write_len_delimited(entry, 2, _encode_feature(value))  # map value
        _write_len_delimited(fmap, 1, bytes(entry))             # Features.feature
    out = bytearray()
    _write_len_delimited(out, 1, bytes(fmap))                   # Example.features
    return bytes(out)


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _iter_fields(buf: bytes):
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + n]
            pos += n
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        else:
            start = pos
            pos = _skip_field(buf, pos, wire)
            yield field, wire, buf[start:pos]


def _decode_feature(buf: bytes):
    """Decode tf.train.Feature into np.ndarray (floats/ints) or list[bytes]."""
    for field, wire, payload in _iter_fields(buf):
        if field == 1:      # bytes_list
            vals = [p for f, w, p in _iter_fields(payload) if f == 1]
            return vals
        if field == 2:      # float_list
            floats: List[float] = []
            chunks = []
            for f, w, p in _iter_fields(payload):
                if f != 1:
                    continue
                if w == 2:   # packed
                    chunks.append(np.frombuffer(p, dtype="<f4"))
                elif w == 5:  # unpacked single fixed32
                    chunks.append(np.frombuffer(p, dtype="<f4"))
            if chunks:
                return np.concatenate(chunks)
            return np.asarray(floats, dtype=np.float32)
        if field == 3:      # int64_list
            ints: List[int] = []
            for f, w, p in _iter_fields(payload):
                if f != 1:
                    continue
                if w == 2:   # packed varints
                    pos = 0
                    while pos < len(p):
                        v, pos = _read_varint(p, pos)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        ints.append(v)
                elif w == 0:
                    v = p
                    if v >= 1 << 63:
                        v -= 1 << 64
                    ints.append(v)
            return np.asarray(ints, dtype=np.int64)
    return None


def decode_example(buf: bytes) -> Dict[str, FeatureValue]:
    """Parse a serialized tf.train.Example into {name: value}."""
    out: Dict[str, FeatureValue] = {}
    for field, wire, payload in _iter_fields(buf):
        if field != 1 or wire != 2:   # Example.features
            continue
        for f2, w2, entry in _iter_fields(payload):
            if f2 != 1 or w2 != 2:    # Features.feature map entry
                continue
            name = None
            value = None
            for f3, w3, p3 in _iter_fields(entry):
                if f3 == 1:
                    name = p3.decode("utf-8")
                elif f3 == 2:
                    value = _decode_feature(p3)
            if name is not None:
                out[name] = value
    return out


# ---------------------------------------------------------------------------
# Audio-level convenience (the reference's on-disk schema)
# ---------------------------------------------------------------------------

def _extract_audio(rec: bytes):
    """Pull the `audio` float_list out of one serialized Example, using the
    native C++ scanner when the library loaded (native/tfrec.cc)."""
    from .. import native
    audio = native.parse_float_feature(rec, "audio")
    if audio is not None:
        return audio
    # no library, or it found no feature (or refused the record): the
    # pure-Python decoder decides rather than trusting -1
    try:
        return decode_example(rec).get("audio")
    except (IndexError, ValueError):
        return None   # proto-malformed record: skip, don't crash the file


def read_audio_tfrecords(path: str, sample_duration: int = None) -> np.ndarray:
    """Load every ``audio`` feature from a TFRecord file into [N, T] float32
    (the reference's parse of audio-only records: data.py:31-34)."""
    rows = []
    for rec in read_records(path):
        audio = _extract_audio(rec)
        if audio is None:
            continue
        audio = np.asarray(audio, dtype=np.float32)
        if sample_duration is not None:
            if audio.shape[0] < sample_duration:
                audio = np.pad(audio, (0, sample_duration - audio.shape[0]))
            else:
                audio = audio[:sample_duration]
        rows.append(audio)
    if not rows:
        raise IOError(f"{path}: no 'audio' features found")
    return np.stack(rows)


def write_audio_tfrecords(path: str, waveforms: np.ndarray,
                          append: bool = False):
    """Write [N, T] waveforms as audio-only Examples
    (reference: make-small-dataset.py:24-32)."""
    waveforms = np.asarray(waveforms, dtype=np.float32)
    write_records(path, (encode_example({"audio": w}) for w in waveforms),
                  append=append)
