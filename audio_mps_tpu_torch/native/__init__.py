"""ctypes loader for the port's native data plane (``tfrec.cc``): CRC32C,
TFRecord's CRC mask, and a scanner that pulls one float_list feature out
of a serialized ``tf.train.Example`` (a copy of the JAX package's
``native/``).

On first use ``tfrec.cc`` is compiled with ``g++`` into a library named
after a hash of the source, the flags and ``g++ --version``: under
``build/native/`` at the root of a source checkout (gitignored), else in a
per-user cache directory, as ``ops/_build.py`` places the CUDA kernels.
Nothing is built at import time, and nothing is written beside the
source. A failed build or load is kept, not swallowed: ``load()`` returns
None, ``available()`` False, and ``build_error()`` says why, with the
compiler's output. ``data/tfrecord.py`` then reads through its pure-Python
codec, as it does on a machine without ``g++``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "tfrec.cc"
ROOT = Path(__file__).resolve().parents[2]
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class BuildError(RuntimeError):
    """``g++`` is missing or failed on ``tfrec.cc``."""


def build_dir() -> Path:
    """``build/native`` in a source checkout, else a per-user cache."""
    if (ROOT / "pyproject.toml").exists():
        return ROOT / "build" / "native"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "audio_mps_tpu_torch" / "native"


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise BuildError("g++ not found on PATH; the native data plane is "
                         "built from native/tfrec.cc on first use")
    return cxx


def build() -> dict:
    """Compile ``tfrec.cc`` unless the library of its hash exists. Returns
    ``{"path", "rebuilt", "seconds", "log"}``; raises ``BuildError`` with
    the compiler's output when the build fails."""
    cxx = _compiler()
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(subprocess.run([cxx, "--version"], capture_output=True,
                            text=True, check=True, timeout=60).stdout.encode())
    h.update(SRC.read_bytes())
    out_dir = build_dir()
    lib = out_dir / f"libamt_tfrec-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return dict(path=str(lib), rebuilt=False, seconds=0.0, log="")
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: concurrent processes (test
    # workers) each finish with a whole library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = os.path.join(tmp, lib.name)
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp_lib, str(SRC)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise BuildError(f"g++ failed on {SRC} (exit "
                             f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp_lib, lib)
    return dict(path=str(lib), rebuilt=True,
                seconds=time.perf_counter() - t0, log=proc.stdout)


@functools.lru_cache(maxsize=None)
def _load():
    """(library, None) or (None, the reason), once a process."""
    try:
        lib = ctypes.CDLL(build()["path"])
    except (BuildError, OSError, subprocess.SubprocessError) as e:
        return None, f"{type(e).__name__}: {e}"
    lib.amt_crc32c.restype = ctypes.c_uint32
    lib.amt_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.amt_masked_crc.restype = ctypes.c_uint32
    lib.amt_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.amt_parse_float_feature.restype = ctypes.c_long
    lib.amt_parse_float_feature.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_size_t]
    return lib, None


def load() -> Optional[ctypes.CDLL]:
    """The native library (built on first use), or None when it could not
    be built or loaded (``build_error()`` says why)."""
    return _load()[0]


def available() -> bool:
    return load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's output for a failed
    build), or None when it loaded."""
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {build_error()}")
    return lib


def crc32c(data: bytes) -> int:
    return int(_lib().amt_crc32c(data, len(data)))


def masked_crc(data: bytes) -> int:
    return int(_lib().amt_masked_crc(data, len(data)))


def parse_float_feature(record: bytes, name: str = "audio"
                        ) -> Optional[np.ndarray]:
    """The float_list feature ``name`` of a serialized Example, or None when
    it is absent, malformed, or the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = lib.amt_parse_float_feature(record, len(record),
                                    name.encode(), None, 0)
    if n < 0:
        return None
    out = np.empty(n, dtype=np.float32)
    got = lib.amt_parse_float_feature(
        record, len(record), name.encode(),
        out.ctypes.data_as(ctypes.c_void_p), n)
    if got != n:
        return None
    return out
