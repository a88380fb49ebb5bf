"""The PyTorch port stands alone and never falls back: it imports neither jax
nor the JAX package, its default-device entry points raise without a card,
a tensor that is not on the CPU never takes a plain version, and a shape
whose CUDA kernel is not ported raises on the card. This file imports no
jax, so it also runs on a card machine without it:

    python -m pytest --noconftest tests/test_torch_isolation.py \
        tests/test_torch_cuda.py
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_mps_tpu_torch import (CMPSConfig, PsiCMPS, RhoCMPS, RunConfig,
                                 init_psi, init_rho)
from audio_mps_tpu_torch.data import get_audio, write_audio_tfrecords
from audio_mps_tpu_torch.estimator import main as estimator_main
from audio_mps_tpu_torch.ops import block, grad, scan, split
from audio_mps_tpu_torch.ops import probe as probe_ops
from audio_mps_tpu_torch.ops import rank as rank_ops
from audio_mps_tpu_torch.sample import SampleConfig, sample
from audio_mps_tpu_torch.train import main as train_main
from audio_mps_tpu_torch.train import train
from audio_mps_tpu_torch.training import make_train_step
from audio_mps_tpu_torch.weights import (load_params, params_to_numpy,
                                         psi_params_from_numpy,
                                         rho_params_from_numpy, save_params)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "audio_mps_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "audio_mps_tpu"}


def port_modules():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    assert {"audio_mps_tpu_torch.ops.split",
            "audio_mps_tpu_torch.estimator", "audio_mps_tpu_torch.ops.probe",
            "audio_mps_tpu_torch.tools",
            "audio_mps_tpu_torch.tools.probe8_psi_floor",
            "audio_mps_tpu_torch.data.tfrecord", "audio_mps_tpu_torch.native",
            "audio_mps_tpu_torch.models.reference_transcription"} <= set(
                port_modules())
    code = (
        "import importlib, sys\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_no_forbidden_import_statements():
    """An AST scan of the port and chip_smoke.py (relative imports are the
    port's own)."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert len(files) > 10 and not found, found


def _np_weights(D=8):
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in
            dict(A=(), Rx=(D, D), Ry=(D, D), freqs=(D,), psi_x=(D,),
                 psi_y=(D,)).items()}


def _np_rho_weights(D=8, rank=3):
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in
            dict(A=(), Rx=(D, D), Ry=(D, D), freqs=(D,), Wx=(rank, D),
                 Wy=(rank, D)).items()}


@pytest.mark.parametrize("entry", ["PsiCMPS", "init_psi", "from_numpy",
                                   "load_params", "sample_cli", "train",
                                   "train_cli", "make_train_step",
                                   "RhoCMPS", "init_rho", "rho_from_numpy",
                                   "rho_sample_cli", "rho_train_cli",
                                   "rho_make_train_step", "estimator",
                                   "get_audio_file", "estimator_data_dir"])
def test_default_device_entry_points_raise_without_a_card(entry, tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "params.npz")
    save_params(path, psi_params_from_numpy(_np_weights(), "cpu"))
    calls = {
        "PsiCMPS": lambda: PsiCMPS(CMPSConfig()),
        "init_psi": lambda: init_psi(torch.Generator(), CMPSConfig()),
        "from_numpy": lambda: psi_params_from_numpy(_np_weights()),
        "load_params": lambda: load_params(path),
        "sample_cli": lambda: sample(SampleConfig(modeldir=str(tmp_path),
                                                  fused=True, out="")),
        "train": lambda: train(RunConfig(logdir=str(tmp_path), max_steps=1)),
        "train_cli": lambda: train_main([f"--logdir={tmp_path}",
                                         "--max_steps=1"]),
        "make_train_step": lambda: make_train_step(
            "psi_mps", CMPSConfig(),
            psi_params_from_numpy(_np_weights(), "cpu")),
        "RhoCMPS": lambda: RhoCMPS(CMPSConfig()),
        "init_rho": lambda: init_rho(torch.Generator(), CMPSConfig()),
        "rho_from_numpy": lambda: rho_params_from_numpy(_np_rho_weights()),
        "rho_sample_cli": lambda: sample(SampleConfig(
            modeldir=str(tmp_path), mps_model="rho_mps", fused=True,
            out="")),
        "rho_train_cli": lambda: train_main([f"--logdir={tmp_path}",
                                             "--mps_model=rho_mps",
                                             "--max_steps=1"]),
        "rho_make_train_step": lambda: make_train_step(
            "rho_mps", CMPSConfig(),
            rho_params_from_numpy(_np_rho_weights(), "cpu")),
        "estimator": lambda: estimator_main([f"--model_dir={tmp_path}",
                                             "--max_steps=1"]),
        "get_audio_file": lambda: get_audio(str(tmp_path), "guitar",
                                            CMPSConfig()),
        "estimator_data_dir": lambda: estimator_main([
            f"--model_dir={tmp_path}", "--max_steps=1",
            f"--data_dir={tmp_path / 'guitar.tfrecords'}"]),
    }
    write_audio_tfrecords(str(tmp_path / "guitar.tfrecords"),
                          np.zeros((2, 64), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


def _probe_call(x):
    return probe_ops.psi_probe_columns(
        (x["ab"], x["bb"], x["rb"]), x["t0"], x["se"], G=2,
        log_eps=x["log_eps"], norm_eps=x["norm_eps"])


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    cfg = CMPSConfig(bond_dim=8)
    p = psi_params_from_numpy(_np_weights(), "cpu")
    s_in = block.psi_sample_inputs(p, cfg, torch.zeros(5, 2))
    n_in = block.psi_nll_inputs(p, cfg, torch.zeros(2, 6))
    g = torch.ones(2)
    ys = torch.zeros(5, 16, 2)
    n2s = torch.ones(5, 2)
    cot = dict(dy=ys, ys=ys, t0=n_in["t0"], se=n_in["se"], n2s=n2s,
               dehat=n2s, norm_eps=n_in["norm_eps"])
    r = rho_params_from_numpy(_np_rho_weights(), "cpu")
    rs_in = block.rho_sample_inputs(r, cfg, torch.zeros(5, 2))
    rn_in = block.rho_nll_inputs(r, cfg, torch.zeros(2, 6))
    rys = torch.zeros(5, 16, 6)
    trs = torch.ones(5, 2)
    rcot = dict(dy=rys, ys=rys, t0=rn_in["t0"], se=rn_in["se"], trs=trs,
                dehat=trs, norm_eps=rn_in["norm_eps"])
    k_in, _ = rank_ops.partials_inputs(r, cfg, torch.zeros(2, 6), 1)
    S = 6
    k_cot = dict(ys=rys, tr=torch.ones(5, S), deh=torch.ones(5, S),
                 dtr=torch.ones(5, S), dtfin=k_in["t0"])
    # one checkpoint for the 5 steps at unroll 16 (psi, rho), two at 4 (rank)
    rec = dict(ab=n_in["ab"], bb=n_in["bb"], rb=n_in["rb"],
               ck=n_in["t0"][None], se=n_in["se"], norm_eps=n_in["norm_eps"])
    rrec = dict(ab=rn_in["ab"], bb=rn_in["bb"], xb=rn_in["xb"],
                ck=rn_in["t0"][None], se=rn_in["se"],
                norm_eps=rn_in["norm_eps"])
    k_rec = dict(ab=k_in["ab"], bb=k_in["bb"], xb=k_in["xb"],
                 ck=torch.stack([k_in["t0"]] * 2), se=k_in["se"], rc=1,
                 norm_eps=k_in["norm_eps"])
    sp_in = split.psi_split_inputs(p, cfg, torch.zeros(2, 6))
    ss_in = split.psi_split_inputs(p, cfg, torch.zeros(5, 2), noise=True)
    sp_ck = torch.zeros(1, 8, 2)
    sp_bwd = {k: sp_in[k] for k in ("cr", "ci", "rr", "ri", "pc", "ps", "se",
                                    "log_eps", "norm_eps")}
    sp_bwd.update(g=g, ckr=sp_ck, cki=sp_ck)
    rp_in = split.rho_split_inputs(r, cfg, torch.zeros(2, 6))
    rps_in = split.rho_split_inputs(r, cfg, torch.zeros(5, 2), noise=True)
    rp_ck = torch.zeros(1, 8, 6)
    rp_bwd = {k: rp_in[k] for k in split.RHO_SPLIT_NAMES[:8] + (
        "se", "log_eps", "norm_eps")}
    rp_bwd.update(g=g, ckr=rp_ck, cki=rp_ck)
    calls = [
        (split.rho_sample_split, lambda d: split.rho_sample_split(**d(rps_in))),
        (split.rho_nll_split, lambda d: split.rho_nll_split(**d(rp_in))),
        (split.rho_split_fwd, lambda d: split.rho_split_fwd(**d(rp_in))),
        (split.rho_split_bwd, lambda d: split.rho_split_bwd(**d(rp_bwd))),
        (split.psi_sample_split, lambda d: split.psi_sample_split(**d(ss_in))),
        (split.psi_nll_split, lambda d: split.psi_nll_split(**d(sp_in))),
        (split.psi_split_fwd, lambda d: split.psi_split_fwd(**d(sp_in))),
        (split.psi_split_bwd, lambda d: split.psi_split_bwd(**d(sp_bwd))),
        (rank_ops.rank_partials_fwd, lambda d: rank_ops.rank_partials_fwd(
            **d(k_in), unroll=4)),
        (rank_ops.rank_partials_fwd_ckpt,
         lambda d: rank_ops.rank_partials_fwd_ckpt(**d(k_in), unroll=4)),
        (rank_ops.rank_partials_recompute,
         lambda d: rank_ops.rank_partials_recompute(**d(k_rec), unroll=4)),
        (rank_ops.rank_partials_bwd, lambda d: rank_ops.rank_partials_bwd(
            **d(dict(k_in, **k_cot)), unroll=4)),
        (rank_ops.rank_cotangents, lambda d: rank_ops.rank_cotangents(
            **d(dict(dy=rys, ys=rys, t0=k_in["t0"], se=k_in["se"],
                     tr=k_cot["tr"], deh=k_cot["deh"], rc=1,
                     norm_eps=k_in["norm_eps"])), unroll=4)),
        (block.rho_sample_block, lambda d: block.rho_sample_block(**d(rs_in))),
        (block.rho_nll_block, lambda d: block.rho_nll_block(**d(rn_in))),
        (block.rho_train_fwd, lambda d: block.rho_train_fwd(**d(rn_in))),
        (block.rho_train_fwd_ckpt,
         lambda d: block.rho_train_fwd_ckpt(**d(rn_in))),
        (block.rho_recompute, lambda d: block.rho_recompute(**d(rrec))),
        (block.rho_train_bwd, lambda d: block.rho_train_bwd(
            **d(dict(rn_in, g=g, ys=rys, trs=trs)))),
        (block.rho_cotangents, lambda d: block.rho_cotangents(**d(rcot))),
        (block.psi_sample_block, lambda d: block.psi_sample_block(**d(s_in))),
        (block.psi_nll_block, lambda d: block.psi_nll_block(**d(n_in))),
        (block.psi_train_fwd, lambda d: block.psi_train_fwd(**d(n_in))),
        (block.psi_train_fwd_ckpt,
         lambda d: block.psi_train_fwd_ckpt(**d(n_in))),
        (block.psi_recompute, lambda d: block.psi_recompute(**d(rec))),
        (block.psi_train_bwd, lambda d: block.psi_train_bwd(
            **d(dict(n_in, g=g, ys=ys, n2s=n2s)))),
        (block.psi_cotangents, lambda d: block.psi_cotangents(**d(cot))),
        (block.psi_batched_fwd, lambda d: block.psi_batched_fwd(**d(n_in))),
        (block.psi_batched_bwd, lambda d: block.psi_batched_bwd(**d(dict(
            {k: n_in[k] for k in ("ab", "bb", "rb", "se", "log_eps",
                                  "norm_eps")}, ck=n_in["t0"][None], g=g)))),
        (probe_ops.psi_probe_columns, lambda d: _probe_call(d(n_in))),
    ]

    def meta(d):
        return {k: v.to("meta") if isinstance(v, torch.Tensor) else v
                for k, v in d.items()}

    # the recompute adjoints chain three wrappers each over time segments
    calls += [
        (None, lambda d: block.psi_recompute_bwd(
            **d(dict(rec, g=g, log_eps=n_in["log_eps"])))),
        (None, lambda d: block.rho_recompute_bwd(
            **d(dict(rrec, g=g, log_eps=rn_in["log_eps"])))),
        (None, lambda d: rank_ops.rank_recompute_bwd(
            **d(dict(k_rec, tr=k_cot["tr"], deh=k_cot["deh"],
                     dtr=k_cot["dtr"], dtfin=k_cot["dtfin"])), unroll=4)),
    ]
    counted = [fn for fn, _call in calls if fn is not None]

    for _fn, call in calls:
        with pytest.raises(ValueError, match="no kernel"):
            call(meta)
    launches = [fn.launches for fn in counted]
    for _fn, call in calls:
        call(dict)
    assert [fn.launches for fn in counted] == launches


@pytest.mark.parametrize("where", ["alone", "repo"])
def test_chip_smoke_fails_without_the_port_or_a_card(where, tmp_path):
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
        if torch.cuda.is_available() and subprocess.run(
                [sys.executable, "-c", "import importlib.util as u; print(u."
                 "find_spec('audio_mps_tpu_torch') is not None)"],
                cwd=cwd, env=env, capture_output=True, text=True,
                timeout=60).stdout.strip() == "True":
            pytest.skip("the port is installed and a card is present: "
                        "chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("kind, D", [("sample", 96), ("nll", 72),
                                     ("sample", 121), ("nll", 122),
                                     ("train", 74)])
def test_cuda_path_raises_for_unported_shapes(kind, D):
    """On a CUDA tensor a psi D whose constants overflow one block's shared
    memory raises NotImplementedError instead of running anything else,
    launching nothing: the block layout (sampler D=96, NLL D=72) and the
    split layout (sampler D=121 and NLL D=122 past its 119; training D=74
    past its adjoint's 73, refused before the forward launches). The split
    D below those ceilings runs (tests/test_torch_cuda.py); here they were
    ("sample", 12) and ("nll", 2) while the split kernels were not
    ported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA path has no CPU mode")
    dev = torch.device("cuda")
    cfg = CMPSConfig(bond_dim=D)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    wrappers = (block.psi_sample_block, block.psi_nll_block,
                block.psi_train_fwd, block.psi_train_bwd,
                split.psi_sample_split, split.psi_nll_split,
                split.psi_split_fwd, split.psi_split_bwd)
    before = [w.launches for w in wrappers]
    with pytest.raises(NotImplementedError):
        if kind == "sample":
            scan.psi_sample_fused(p, cfg, torch.zeros(16, 2, device=dev))
        elif kind == "nll":
            scan.psi_nll_fused(p, cfg, torch.zeros(2, 17, device=dev))
        else:
            grad.psi_nll_fused_trainable(
                p, cfg, torch.zeros(2, 17, device=dev)).backward()
    assert [w.launches for w in wrappers] == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind, D, rank", [
    ("sample", 66, 66), ("nll", 66, 66), ("train", 54, 54), ("nll", 72, 3),
    ("train", 1028, 1)])
def test_cuda_rho_path_raises_for_unported_shapes(kind, D, rank):
    """On a CUDA tensor the rho entry points raise NotImplementedError,
    launching nothing: the split layout past its shared memory (sampler and
    NLL D=66 at full rank past their D=64; training D=54 past the adjoint's
    53, refused before the forward launches), scoring past the block
    kernels' layout (D > 64), and training past what even a rank chunk of
    one row takes (D/4 > 256 threads). The split shapes this pinned while
    the split kernels were not ported (sampler D=12, NLL and training D=6,
    rank 3) run: tests/test_torch_cuda.py. Training without the state
    stream runs: test_cuda_rho_path_trains_without_the_stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA path has no CPU mode")
    dev = torch.device("cuda")
    cfg = CMPSConfig(bond_dim=D, initial_rank=rank)
    p = init_rho(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    wrappers = (block.rho_sample_block, block.rho_nll_block,
                block.rho_train_fwd, block.rho_train_bwd,
                block.rho_cotangents, rank_ops.rank_partials_fwd,
                rank_ops.rank_partials_bwd, rank_ops.rank_cotangents,
                split.rho_sample_split, split.rho_nll_split,
                split.rho_split_fwd, split.rho_split_bwd)
    before = [w.launches for w in wrappers]
    with pytest.raises(NotImplementedError):
        if kind == "sample":
            scan.rho_sample_fused(p, cfg, torch.zeros(16, 2, device=dev))
        elif kind == "nll":
            scan.rho_nll_fused(p, cfg, torch.zeros(2, 17, device=dev))
        else:
            grad.rho_nll_fused_trainable(p, cfg,
                                         torch.zeros(2, 17, device=dev))
    assert [w.launches for w in wrappers] == before


@pytest.mark.cuda
@pytest.mark.parametrize("D, rank", [(8, 3), (128, 4)])
def test_cuda_rho_path_trains_without_the_stream(D, rank):
    """kernel_stream="off" on a CUDA tensor (these two shapes raised
    NotImplementedError before the recompute adjoints, table rows 4d and
    7c, were ported): D=8 runs the monolithic rho kernels and D=128 the
    rank partials, each through its checkpoint forward and segment
    recompute and never its streamed forward; the loss and the gradients
    are finite and match the same call on CPU copies (the plain recompute
    path): the loss within 1e-4 relative, each gradient within 1e-3 of its
    largest element."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA path has no CPU mode")
    dev = torch.device("cuda")
    cfg = CMPSConfig(bond_dim=D, initial_rank=rank, kernel_stream="off")
    p = init_rho(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    chunked = D > 64
    ckpt, recompute, stream = (
        (rank_ops.rank_partials_fwd_ckpt, rank_ops.rank_partials_recompute,
         rank_ops.rank_partials_fwd) if chunked else
        (block.rho_train_fwd_ckpt, block.rho_recompute, block.rho_train_fwd))
    before = [w.launches for w in (ckpt, recompute, stream)]
    sig = torch.linspace(-0.1, 0.1, 2 * 17, device=dev).reshape(2, 17)
    loss = grad.rho_nll_fused_trainable(p, cfg, sig)
    loss.backward()
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip((ckpt, recompute, stream),
                                           before)] == [1, 1, 0]
    assert torch.isfinite(loss)
    assert all(torch.isfinite(x.grad).all() for x in p.parameters())
    q = rho_params_from_numpy(params_to_numpy(p), "cpu")
    want = grad.rho_nll_fused_trainable(q, cfg, sig.cpu())
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        got, ref = getattr(p, name).grad.cpu(), getattr(q, name).grad
        assert (got - ref).abs().max() <= 1e-3 * ref.abs().max(), name
