"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. On first use they are
compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started
together, then one link) into ``libamt_kernels.so`` and loaded with
``ctypes``. In a source checkout the library goes to ``build/kernels/`` at
its root; for an installed package, to a per-user cache directory keyed by
the build hash. A stamp file holds that hash, of the sources, the flags and
``nvcc --version``; a changed hash rebuilds. Nothing here runs at import
time, so the CPU tests import every module without a toolkit.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("psi_sample.cu", "psi_nll.cu", "psi_train_fwd.cu",
           "psi_recompute.cu", "psi_train_bwd.cu", "psi_cotangents.cu",
           "rho_sample.cu", "rho_nll.cu", "rho_train_fwd.cu",
           "rho_recompute.cu", "rho_train_bwd.cu", "rank_partials_fwd.cu",
           "rank_partials_recompute.cu", "rank_partials_bwd.cu",
           "psi_split_sample.cu", "psi_split_nll.cu", "psi_split_fwd.cu",
           "psi_split_bwd.cu", "rho_split_sample.cu", "rho_split_nll.cu",
           "rho_split_fwd.cu", "rho_split_bwd.cu", "psi_batched_fwd.cu",
           "psi_batched_bwd.cu", "psi_probe.cu", "psi_cluster_fwd.cu",
           "psi_cluster_bwd.cu", "psi_cluster_sample.cu")
HEADERS = ("common.cuh", "psi_fwd.cuh", "rho_tile.cuh", "rho_cluster.cuh",
           "rho_fwd.cuh", "rank_partials.cuh", "rank_partials_fwd.cuh",
           "psi_split_fwd.cuh", "rho_split_fwd.cuh", "psi_cluster.cuh")
ROOT = Path(__file__).resolve().parents[2]
LIB_NAME = "libamt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # ab, bb, pc, ps, t0, noise, inv_a, wave, D, T, N, dt, norm_eps,
    # precision, quad, stream
    "amt_psi_sample": ([_P] * 8 + [_I, _I, _I, _F, _F, _I, _I, _P], _I),
    # ab, bb, rb, t0, se, loss, D, n_steps, B, unroll, log_eps, norm_eps,
    # precision, defer_norm, cols_per_cta, stream
    "amt_psi_nll": ([_P] * 6 + [_I, _I, _I, _I, _F, _F, _I, _I, _I, _P],
                    _I),
    # ab, bb, rb, t0, se, loss, ys, n2s, D, n_steps, B, unroll, log_eps,
    # norm_eps, precision, defer_norm, cols_per_cta, stream
    "amt_psi_train_fwd": ([_P] * 8 + [_I, _I, _I, _I, _F, _F, _I, _I, _I,
                                      _P], _I),
    # ab, bb, rb, t0, se, loss, ck, D, n_steps, B, unroll, log_eps,
    # norm_eps, precision, defer_norm, cols_per_cta, stream
    "amt_psi_train_fwd_ckpt": ([_P] * 7 + [_I] * 4 + [_F, _F, _I, _I, _I,
                                                      _P], _I),
    # ab, bb, rb, ck, se, ys, n2s, D, n_steps, B, unroll, blocks_per_cta,
    # norm_eps, precision, defer_norm, cols_per_cta, stream
    "amt_psi_recompute": ([_P] * 7 + [_I] * 5 + [_F, _I, _I, _I, _P], _I),
    # ab, bb, rb, t0, se, g, ys, n2s, dtfin, dse, dt0, dys, dehats, dn2ns,
    # D, n_steps, B, unroll, log_eps, norm_eps, precision, defer_norm,
    # cols_per_cta, stream
    "amt_psi_train_bwd": ([_P] * 14 + [_I, _I, _I, _I, _F, _F, _I, _I, _I,
                                       _P], _I),
    # rb, se, g, ys, n2s, dse, dys, dehats, dn2ns, D, n_steps, B, unroll,
    # log_eps, norm_eps, precision, defer_norm, stream
    "amt_psi_train_bwd_tail": ([_P] * 9 + [_I] * 4 + [_F, _F, _I, _I, _P],
                               _I),
    # dys, ys, t0, se, n2s, dehats, partial, out, D, n_steps, L, gs, gn,
    # unroll, norm_eps, w_scale, precision, defer_norm, stream
    "amt_psi_cotangents": ([_P] * 8 + [_I] * 6 + [_F, _F, _I, _I, _P], _I),
    # ab, bb, xs, pc, ps, t0, noise, inv_a, wave, D, T, N, R, dt, norm_eps,
    # precision, cluster, stream
    "amt_rho_sample": ([_P] * 9 + [_I, _I, _I, _I, _F, _F, _I, _I, _P], _I),
    # ab, bb, xb, t0, se, loss, D, n_steps, B, R, unroll, log_eps, norm_eps,
    # precision, defer_norm, cluster, stream
    "amt_rho_nll": ([_P] * 6 + [_I] * 5 + [_F, _F, _I, _I, _I, _P], _I),
    # ab, bb, xb, t0, se, loss, ys, trs, D, n_steps, B, R, unroll, log_eps,
    # norm_eps, precision, defer_norm, cluster, stream
    "amt_rho_train_fwd": ([_P] * 8 + [_I] * 5 + [_F, _F, _I, _I, _I, _P],
                          _I),
    # ab, bb, xb, t0, se, loss, ck, D, n_steps, B, R, unroll, log_eps,
    # norm_eps, precision, defer_norm, cluster, stream
    "amt_rho_train_fwd_ckpt": ([_P] * 7 + [_I] * 5
                               + [_F, _F, _I, _I, _I, _P], _I),
    # ab, bb, xb, ck, se, ys, trs, D, n_steps, B, R, unroll, norm_eps,
    # precision, defer_norm, cluster, stream
    "amt_rho_recompute": ([_P] * 7 + [_I] * 5 + [_F, _I, _I, _I, _P], _I),
    # ab, bb, xb, t0, se, g, ys, trs, dtfin, dse, dt0, dys, dehats, dtrns,
    # D, n_steps, B, R, unroll, log_eps, norm_eps, precision, defer_norm,
    # cluster, stream
    "amt_rho_train_bwd": ([_P] * 14 + [_I] * 5 + [_F, _F, _I, _I, _I, _P],
                          _I),
    # abt, bbt, xbt, t0, se, eh, tr, tfin, ys, D, n_steps, B, S, rc,
    # unroll, norm_eps, precision, cluster, stream
    "amt_rank_partials_fwd": ([_P] * 9 + [_I] * 6 + [_F, _I, _I, _P], _I),
    # abt, bbt, xbt, t0, se, eh, tr, tfin, ck, D, n_steps, B, S, rc,
    # unroll, norm_eps, precision, cluster, stream
    "amt_rank_partials_fwd_ckpt": ([_P] * 9 + [_I] * 6 + [_F, _I, _I, _P],
                                   _I),
    # abt, bbt, ck, se, ys, D, n_steps, B, S, rc, unroll, norm_eps,
    # precision, cluster, stream
    "amt_rank_partials_recompute": ([_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
                                    _I),
    # xs, ab, bb, t0, se, ys, tr, deh, dtr, dtfin, dse, dt0, dys, D,
    # n_steps, B, S, rc, unroll, norm_eps, precision, cluster, stream
    "amt_rank_partials_bwd": ([_P] * 13 + [_I] * 6 + [_F, _I, _I, _P], _I),
    # cr, ci, rr, ri, pc, ps, s0r, s0i, noise, inv_a, wave, D, T, N, dt,
    # norm_eps, precision, stream
    "amt_psi_split_sample": ([_P] * 11 + [_I, _I, _I, _F, _F, _I, _P], _I),
    # cr, ci, rr, ri, pc, ps, s0r, s0i, se, loss, D, n_steps, B, unroll,
    # log_eps, norm_eps, precision, defer_norm, stream
    "amt_psi_split_nll": ([_P] * 10 + [_I] * 4 + [_F, _F, _I, _I, _P], _I),
    # cr, ci, rr, ri, pc, ps, s0r, s0i, se, loss, ckr, cki, D, n_steps, B,
    # unroll, log_eps, norm_eps, precision, defer_norm, stream
    "amt_psi_split_fwd": ([_P] * 12 + [_I] * 4 + [_F, _F, _I, _I, _P], _I),
    # cr, ci, rr, ri, pc, ps, se, g, ckr, cki, dse, dp0r, dp0i, part, D,
    # n_steps, B, unroll, log_eps, norm_eps, precision, defer_norm, pipe,
    # stream
    "amt_psi_split_bwd": ([_P] * 14 + [_I] * 4 + [_F, _F, _I, _I, _I, _P],
                          _I),
    # ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, noise, inv_a, wave, D,
    # T, N, rank, threads, elems, dt, norm_eps, precision, stream
    "amt_rho_split_sample": ([_P] * 13 + [_I] * 6 + [_F, _F, _I, _P], _I),
    # ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se, loss, D, n_steps,
    # B, rank, unroll, log_eps, norm_eps, precision, defer_norm, warp_local,
    # stream
    "amt_rho_split_nll": ([_P] * 12 + [_I] * 5 + [_F, _F, _I, _I, _I, _P],
                          _I),
    # ... as amt_rho_split_nll with ckr, cki after loss
    "amt_rho_split_fwd": ([_P] * 14 + [_I] * 5 + [_F, _F, _I, _I, _I, _P],
                          _I),
    # ccr, cci, rcr, rci, xtr, xti, pc, ps, se, g, ckr, cki, dse, dh0r, dh0i,
    # part, ws, D, n_steps, B, rank, unroll, log_eps, norm_eps, precision,
    # defer_norm, pipe, smem_slab, stream
    "amt_rho_split_bwd": ([_P] * 17 + [_I] * 5 + [_F, _F, _I, _I, _I, _I,
                                                  _P], _I),
    # ab, bb, rb, t0, se, loss, ck, D, n_steps, B, unroll, log_eps,
    # norm_eps, precision, stream
    "amt_psi_batched_fwd": ([_P] * 7 + [_I] * 4 + [_F, _F, _I, _P], _I),
    # ab, bb, rb, ck, se, g, dse, dt0, part, scr, D, n_steps, B, unroll,
    # window, log_eps, norm_eps, precision, stream
    "amt_psi_batched_bwd": ([_P] * 10 + [_I] * 5 + [_F, _F, _I, _P], _I),
    # ab, bb, rb, prod_t, t0, se, out, D, t_pad, B, unroll, G, mode,
    # log_eps, norm_eps, precision, stream
    "amt_psi_probe": ([_P] * 7 + [_I] * 6 + [_F, _F, _I, _P], _I),
    # the cluster layout (psi_cluster*.cu): ab, bb, rb, t0, se, loss, D,
    # n_steps, B, unroll, log_eps, norm_eps, precision, defer_norm, cluster,
    # cols, stream
    "amt_psi_cl_nll": ([_P] * 6 + [_I] * 4 + [_F, _F] + [_I] * 4 + [_P], _I),
    # ... loss, ys, n2s ...
    "amt_psi_cl_train_fwd": ([_P] * 8 + [_I] * 4 + [_F, _F] + [_I] * 4
                             + [_P], _I),
    # ... loss, ck ...
    "amt_psi_cl_train_fwd_ckpt": ([_P] * 7 + [_I] * 4 + [_F, _F] + [_I] * 4
                                  + [_P], _I),
    # ab, bb, rb, ck, se, ys, n2s, D, n_steps, B, unroll, blocks_per_cta,
    # norm_eps, precision, defer_norm, cluster, cols, stream
    "amt_psi_cl_recompute": ([_P] * 7 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
                             _I),
    # rb, rbp, se, g, ys, n2s, dse, dys, dehats, dn2ns, D, n_steps, B,
    # unroll, log_eps, norm_eps, precision, defer_norm, stream
    "amt_psi_cl_tail": ([_P] * 10 + [_I] * 4 + [_F, _F, _I, _I, _P], _I),
    # ab, bb, rb, t0, se, g, ys, n2s, dtfin, dse, dt0, dys, dehats, dn2ns,
    # rbp, D, n_steps, B, unroll, log_eps, norm_eps, precision, defer_norm,
    # cluster, cols, stream
    "amt_psi_cl_train_bwd": ([_P] * 15 + [_I] * 4 + [_F, _F] + [_I] * 4
                             + [_P], _I),
    # ab, bb, pc, ps, t0, noise, inv_a, wave, D, T, N, dt, norm_eps,
    # precision, cluster, stream
    "amt_psi_cl_sample": ([_P] * 8 + [_I] * 3 + [_F, _F, _I, _I, _P], _I),
    "amt_psi_cl_fwd_smem_bytes": ([_I] * 3, ctypes.c_size_t),
    "amt_psi_cl_chain_smem_bytes": ([_I] * 3, ctypes.c_size_t),
    "amt_psi_cl_tail_smem_bytes": ([_I], ctypes.c_size_t),
    "amt_psi_cl_tail_lanes": ([_I, _I], _I),
    "amt_psi_cl_sample_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "amt_psi_cl_threads": ([_I, _I], _I),
    "amt_psi_sample_smem_bytes": ([_I], ctypes.c_size_t),
    "amt_psi_sample_quad": ([_I], _I),
    "amt_psi_nll_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "amt_psi_train_fwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "amt_psi_train_bwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "amt_psi_train_bwd_tail_smem_bytes": ([_I], ctypes.c_size_t),
    "amt_psi_cotangents_workspace_floats": ([_I, _I], ctypes.c_size_t),
    # D, R, cluster, nbuf
    "amt_rho_sample_smem_bytes": ([_I] * 4, ctypes.c_size_t),
    # D, R, cluster
    "amt_rho_sample_buffers": ([_I] * 3, _I),
    "amt_rho_sample_max_clusters": ([_I] * 3, _I),
    "amt_rho_train_fwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # D, R, cluster, recompute, nbuf
    "amt_rho_fwd_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    # D, R, cluster, recompute
    "amt_rho_fwd_buffers": ([_I] * 4, _I),
    # D, R, cluster
    "amt_rho_fwd_max_clusters": ([_I] * 3, _I),
    "amt_rho_recompute_max_clusters": ([_I] * 3, _I),
    "amt_rho_train_bwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "amt_rho_chain_smem_bytes": ([_I] * 3, ctypes.c_size_t),
    "amt_rho_chain_max_clusters": ([_I] * 3, _I),
    "amt_rank_partials_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # D, rc, cluster
    "amt_rank_partials_max_clusters": ([_I, _I, _I], _I),
    "amt_psi_split_sample_smem_bytes": ([_I], ctypes.c_size_t),
    "amt_psi_split_fwd_smem_bytes": ([_I], ctypes.c_size_t),
    "amt_psi_split_bwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # D, unroll, pipe
    "amt_psi_split_bwd_form_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "amt_rho_split_sample_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "amt_rho_split_fwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # D, rank, warp_local, field (cols, threads, elems, slots, smem bytes)
    "amt_rho_split_fwd_layout": ([_I] * 4, _I),
    "amt_rho_split_bwd_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    # D, rank, unroll, pipe, smem_slab
    "amt_rho_split_bwd_form_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    "amt_rho_split_bwd_workspace_floats": ([_I, _I, _I], ctypes.c_size_t),
    "amt_psi_batched_fwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "amt_psi_batched_bwd_smem_bytes": ([_I, _I], ctypes.c_size_t),
    # D, window
    "amt_psi_batched_bwd_scratch_floats": ([_I, _I], ctypes.c_size_t),
    "amt_psi_probe_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "amt_error_string": ([_I], ctypes.c_char_p),
}


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def _build_dir(digest: str) -> Path:
    """``build/kernels`` in a source checkout, else a per-user cache."""
    if (ROOT / "pyproject.toml").exists():
        return ROOT / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "audio_mps_tpu_torch" / digest[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's kernels are built from csrc/ on first use")


def build() -> dict:
    """Compile ``csrc/`` into the shared library unless the stamp matches.

    Returns ``{"path", "rebuilt", "seconds", "log"}``; ``log`` holds
    ``ptxas -v`` (registers, shared memory, spills) for each source."""
    nvcc = _nvcc()
    digest = _source_hash(nvcc)
    build_dir = _build_dir(digest)
    lib = build_dir / LIB_NAME
    stamp = build_dir / (LIB_NAME + ".sha256")
    if (lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return dict(path=str(lib), rebuilt=False, seconds=0.0, log="")
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   str(CSRC / name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib,
             *[obj for _n, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    stamp.write_text(digest + "\n")
    return dict(path=str(lib), rebuilt=True,
                seconds=time.perf_counter() - t0, log="\n".join(logs))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(build()["path"])
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def ptxas_report(log: str, sources) -> list:
    """One line per kernel of ``sources`` from a ``build()`` log's ptxas
    report: its name and template arguments, registers and spill bytes."""
    import re
    out, src, name, spill = [], None, None, ""
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif src in sources and "Compiling entry function" in line:
            m = re.search(r"_ZN3amt\d+(\w+?)I((?:L[ib]\d+E)+)E", line)
            name = (f"{m.group(1)}<"
                    + ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
                    + ">" if m else line.split("'")[1])
        elif src in sources and name and "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif src in sources and name and "Used" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            out.append(f"{src}: {name}: {regs}, {spill}")
            name = None
    return out or ["(no ptxas report: the library was not rebuilt)"]


def check(lib, err: int, name: str):
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} "
            f"({lib.amt_error_string(err).decode()})")
