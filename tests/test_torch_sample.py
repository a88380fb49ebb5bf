"""The port's object API (PsiCMPS) and sample CLI end to end on the CPU,
against the JAX package on the same weights and noise."""
import dataclasses
import json
import os
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu.models import core as jcore
from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu_torch import CMPSConfig, PsiCMPS
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.sample import (SampleConfig, parse_args, sample,
                                        write_wav)
from test_torch_core import both, np_params, np_signals

T = 83
D = 8


def test_psicmps_cpu_matches_jax():
    d = np_params(D)
    hp = CMPSConfig(bond_dim=D, minibatch_size=3)
    jhp = jconfig.CMPSConfig(bond_dim=D, minibatch_size=3)
    sig = np_signals(3, T)
    m = PsiCMPS(hp, data_iterator=sig, R_in=d["Rx"] + 1j * d["Ry"],
                freqs_in=d["freqs"], psi_in=d["psi_x"] + 1j * d["psi_y"],
                device="cpu")
    jp = both(d)[0]
    np.testing.assert_allclose(m.loss.item(),
                               float(jcore.psi_nll(jp, jhp, jnp.asarray(sig))),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(m.psi_0, np.asarray(jcore.psi0(jp, jhp)[0])
                               + 1j * np.asarray(jcore.psi0(jp, jhp)[1]),
                               rtol=1e-6, atol=1e-7)
    R = m.R
    assert R.dtype == np.complex64 and np.all(np.diag(R) == 0)
    np.testing.assert_allclose(R, (d["Rx"] + 1j * d["Ry"])
                               * (1 - np.eye(D)), rtol=1e-7)
    assert m.A.item() == hp.A and m.freqs.shape == (D,)
    traj = m.psi_evolve_with_data()
    jr, ji = jcore.psi_evolve_with_data(jp, jhp, jnp.asarray(sig))
    np.testing.assert_allclose(traj, np.asarray(jr) + 1j * np.asarray(ji),
                               rtol=1e-5, atol=1e-7)
    # sampling: eager and fused on the same noise as the JAX block sampler
    noise = core._sample_noise(hp, torch.Generator().manual_seed(5), 3, T, 1.0)
    want = np.asarray(jblock.psi_sample_block(
        jp, jhp, jnp.asarray(noise.numpy()), interpret=True))
    for fused in (False, True):
        got = m.sample(3, T, generator=torch.Generator().manual_seed(5),
                       fused=fused)
        assert got.shape == (3, T)
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-6 * np.abs(want).max())


def _modeldir(tmp_path, d=None, bond_dim=D):
    """A run directory as the JAX train CLI writes it (config.json), plus
    params.npz when weights are given."""
    cfg = jconfig.CMPSConfig(bond_dim=bond_dim)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"cfg": dataclasses.asdict(cfg),
                   "run": dataclasses.asdict(jconfig.RunConfig())}, f)
    if d is not None:
        np.savez(tmp_path / "params.npz", **d)
    return str(tmp_path), cfg


@pytest.mark.parametrize("fused", [False, True])
def test_sample_cli_end_to_end(tmp_path, fused):
    d = np_params(D, 2)
    modeldir, jcfg = _modeldir(tmp_path, d)
    out = str(tmp_path / "s.npz")
    sc = SampleConfig(modeldir=modeldir, num_samples=3, sample_duration=T,
                      fused=fused, device="cpu", out=out, seed=7)
    waves = sample(sc, verbose=False)
    # the CLI's noise: a generator on the device seeded with seed + 1
    cfg = CMPSConfig(bond_dim=D)
    noise = core._sample_noise(cfg, torch.Generator().manual_seed(8), 3, T,
                               1.0)
    want = np.asarray(jblock.psi_sample_block(
        both(d)[0], jcfg, jnp.asarray(noise.numpy()), interpret=True))
    np.testing.assert_allclose(waves, want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())
    np.testing.assert_array_equal(np.load(out)["samples"], waves)
    for i in range(3):
        with wave.open(str(tmp_path / f"s_{i}.wav")) as f:
            assert f.getnframes() == T and f.getframerate() == 16000


def test_sample_cli_random_init_warns(tmp_path, capsys):
    modeldir, _ = _modeldir(tmp_path)
    sc = SampleConfig(modeldir=modeldir, num_samples=2, sample_duration=20,
                      device="cpu", out=str(tmp_path / "r.npz"), wav=False)
    waves = sample(sc)
    assert "warning: no" in capsys.readouterr().out
    assert waves.shape == (2, 20) and np.all(np.isfinite(waves))
    again = sample(sc, verbose=False)
    np.testing.assert_array_equal(waves, again)


@pytest.mark.parametrize("kw, exc", [
    (dict(mps_model="rho_mps", mesh="dp:2"), NotImplementedError),
    (dict(mps_model="latent"), NotImplementedError),
    (dict(mesh="dp:2"), NotImplementedError),
    (dict(mps_model="bogus"), ValueError),
    (dict(modeldir=""), ValueError),
])
def test_sample_cli_refuses_what_is_not_ported(tmp_path, kw, exc):
    modeldir, _ = _modeldir(tmp_path)
    sc = dataclasses.replace(SampleConfig(modeldir=modeldir, device="cpu",
                                          out=""), **kw)
    with pytest.raises(exc):
        sample(sc, verbose=False)


def test_parse_args_and_write_wav(tmp_path):
    sc = parse_args(["--modeldir=/m", "--fused", "--num_samples=4",
                     "--temperature=0.5", "--device=cpu", "positional"])
    assert (sc.modeldir, sc.fused, sc.num_samples, sc.temperature,
            sc.device) == ("/m", True, 4, 0.5, "cpu")
    assert parse_args([]).device == "cuda"
    assert parse_args(["--visualize"]).visualize
    assert not parse_args([]).visualize
    with pytest.raises(ValueError, match="unknown flag"):
        parse_args(["--visualise"])
    path = os.path.join(tmp_path, "w.wav")
    write_wav(path, np.sin(np.arange(100) / 5.0), 8000)
    with wave.open(path) as f:
        pcm = np.frombuffer(f.readframes(100), "<i2")
    assert f.getframerate() == 8000 and np.abs(pcm).max() == 32767


@pytest.mark.parametrize("matplotlib", [True, False])
def test_sample_cli_visualize(tmp_path, capsys, monkeypatch, matplotlib):
    """--visualize writes a waveform plot of each sample, samples_<i>.png
    beside samples.npz, as the JAX CLI does; without matplotlib (as on the
    card machine) the CLI says it wrote none and still returns the
    samples."""
    import sys
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    modeldir, _ = _modeldir(tmp_path, np_params(D, 2))
    out = str(tmp_path / "samples.npz")
    waves = sample(parse_args([f"--modeldir={modeldir}", "--num_samples=2",
                               "--sample_duration=40", "--device=cpu",
                               f"--out={out}", "--wav=false",
                               "--visualize"]))
    assert waves.shape == (2, 40)
    pngs = sorted(p.name for p in tmp_path.glob("samples_*.png"))
    said = capsys.readouterr().out
    if matplotlib:
        assert pngs == ["samples_0.png", "samples_1.png"]
        assert "wrote 2 waveform plots" in said
        for p in pngs:
            assert (tmp_path / p).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    else:
        assert pngs == [] and "wrote no waveform plots" in said
