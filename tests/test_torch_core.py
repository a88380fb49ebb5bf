"""The PyTorch port's config, parameters, weights, data and eager psi core
(audio_mps_tpu_torch) against the JAX package on the same numpy inputs.
Everything runs on the CPU; the port is called with device="cpu". The numpy
input helpers here are shared with test_torch_block.py and
test_torch_sample.py."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu.models import core as jcore
from audio_mps_tpu.models.cell import make_constants as jmake_constants
from audio_mps_tpu.models.params import PsiParams as JaxPsiParams
from audio_mps_tpu_torch import config
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.data import damped_sine_batch
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.models.cell import make_constants
from audio_mps_tpu_torch.models.params import init_psi
from audio_mps_tpu_torch.weights import (load_params, psi_params_from_numpy,
                                         psi_params_to_numpy, save_params)

HP = CMPSConfig(minibatch_size=4, bond_dim=8, scan_chunk=0)
JHP = jconfig.CMPSConfig(minibatch_size=4, bond_dim=8, scan_chunk=0)
T = 83    # odd, as in tests/test_pallas_block.py
RTOL, ATOL = 1e-5, 1e-7


def np_params(D, seed=0):
    """psi weights at their init scales (R: 1/sqrt(r_reg), freqs:
    1/sqrt(h_reg), psi: glorot limits), made with numpy."""
    rng = np.random.default_rng(seed)
    r = 1.0 / np.sqrt(HP.r_reg)
    lim = np.sqrt(6.0 / (2 * D))
    f32 = np.float32
    return dict(A=f32(HP.A),
                Rx=(r * rng.standard_normal((D, D))).astype(f32),
                Ry=(r * rng.standard_normal((D, D))).astype(f32),
                freqs=(rng.standard_normal(D) / np.sqrt(HP.h_reg)).astype(f32),
                psi_x=rng.uniform(-lim, lim, D).astype(f32),
                psi_y=rng.uniform(-lim, lim, D).astype(f32))


def np_signals(B, length, seed=1):
    """Damped-sine batch with Gamma(2) onsets, made with numpy."""
    rng = np.random.default_rng(seed)
    delays = rng.gamma(2.0, length / 200.0, (B, 1))
    times = (np.arange(length)[None] - delays) * HP.delta_t
    wave = (times > 0) * np.sin(2 * np.pi * 261.6 * times) \
        * np.exp(-times / 0.1)
    return wave.astype(np.float32)


def both(d):
    """(JAX params, port params on the CPU) from one numpy dict."""
    return (JaxPsiParams(**{k: jnp.asarray(v) for k, v in d.items()}),
            psi_params_from_numpy(d, "cpu"))


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_make_constants_fields():
    jp, tp = both(np_params(8))
    cj, ct = jmake_constants(jp, JHP), make_constants(tp, HP)
    for f in dataclasses.fields(ct):
        close(getattr(ct, f.name), getattr(cj, f.name))
    assert np.all(np.diag(ct.Rr.detach().numpy()) == 0)


@pytest.mark.parametrize("D", [8, 16])
def test_psi0_and_psi_nll(D):
    jp, tp = both(np_params(D))
    jhp = dataclasses.replace(JHP, bond_dim=D)
    hp = dataclasses.replace(HP, bond_dim=D)
    sig = np_signals(4, T)
    for a, b in zip(core.psi0(tp, hp), jcore.psi0(jp, jhp)):
        close(a, b)
    close(core.psi_nll(tp, hp, torch.as_tensor(sig)),
          jcore.psi_nll(jp, jhp, jnp.asarray(sig)))


@pytest.mark.parametrize("log_eps", [1e-8, 0.0])
def test_log_eps_clamp_and_reference_nan(log_eps):
    """1 + e*s <= 0 on a loud signal: log_eps > 0 clamps, log_eps <= 0 gives
    the reference's NaN, in both packages."""
    d = dict(np_params(8), A=np.float32(1e-3))
    jp, tp = both(d)
    sig = 3.0 * np_signals(2, 40)
    got = core.psi_nll(tp, dataclasses.replace(HP, log_eps=log_eps),
                       torch.as_tensor(sig)).item()
    want = float(jcore.psi_nll(jp, dataclasses.replace(JHP, log_eps=log_eps),
                               jnp.asarray(sig)))
    assert np.isnan(got) == np.isnan(want) == (log_eps <= 0)
    if log_eps > 0:
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_psi_evolve_with_data():
    jp, tp = both(np_params(8))
    sig = np_signals(3, T)
    got = core.psi_evolve_with_data(tp, HP, torch.as_tensor(sig))
    want = jcore.psi_evolve_with_data(jp, JHP, jnp.asarray(sig))
    assert got[0].shape == (3, T - 1, 8)
    for a, b in zip(got, want):
        close(a, b)


def test_sample_psi_with_noise():
    jp, tp = both(np_params(8))
    noise = (1e-4 * np.random.default_rng(3).standard_normal((T, 3))
             ).astype(np.float32)
    got = core.sample_psi_with_noise(tp, HP, torch.as_tensor(noise))
    want = np.asarray(jcore.sample_psi_with_noise(jp, JHP, jnp.asarray(noise)))
    close(got, want, rtol=2e-5, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("kw", [
    dict(kernel_precision="high", kernel_layout="split"),
    dict(kernel_precision="high", bond_dim=6),
    dict(bond_dim=6, kernel_layout="block"),
    dict(kernel_layout="blocky"),
    dict(kernel_precision="fast"),
    dict(kernel_stream="on", defer_norm=False),
    dict(initial_rank=0),
])
def test_config_validation(kw):
    """The JAX config's guards (tests/test_pallas_block.py:122-127, 162-178)
    hold in the port's copy."""
    with pytest.raises(ValueError):
        jconfig.CMPSConfig(**kw)
    with pytest.raises(ValueError):
        CMPSConfig(**kw)


@pytest.mark.parametrize("overrides", [
    "", "bond_dim=64,kernel_precision=high", "initial_rank=none,A=50",
    "defer_norm=false,log_eps=0"])
def test_config_parse_matches_jax(overrides):
    assert (dataclasses.asdict(CMPSConfig().parse(overrides))
            == dataclasses.asdict(jconfig.CMPSConfig().parse(overrides)))
    with pytest.raises(ValueError):
        CMPSConfig().parse("bond_dmi=8")


def test_run_config_and_mesh_spec_match_jax():
    argv = ["--mps_model=psi_mps", "--sample_duration=1024", "--visualize"]
    assert (dataclasses.asdict(config.parse_argv(argv))
            == dataclasses.asdict(jconfig.parse_argv(argv)))
    for spec in ("dp", "dp:4", "dpxtime:2x4", "dpxrankxtime:2x2x2"):
        assert config.parse_mesh_spec(spec) == jconfig.parse_mesh_spec(spec)
    with pytest.raises(ValueError):
        config.parse_mesh_spec("dp:x")
    with pytest.raises(ValueError):
        config.RunConfig(fused="maybe")


def test_init_psi_scales_and_warm_starts():
    g = torch.Generator().manual_seed(0)
    p = init_psi(g, HP, device="cpu")
    again = init_psi(torch.Generator().manual_seed(0), HP, device="cpu")
    for name in ("A", "Rx", "Ry", "freqs", "psi_x", "psi_y"):
        assert getattr(p, name).dtype == torch.float32
        assert torch.equal(getattr(p, name), getattr(again, name))
    assert p.Rx.shape == (8, 8) and p.psi_x.shape == (8,)
    assert p.psi_x.abs().max() <= np.sqrt(6.0 / 16)
    d = np_params(8)
    R = d["Rx"] + 1j * d["Ry"]
    warm = init_psi(g, HP, R_in=R, freqs_in=d["freqs"],
                    psi_in=d["psi_x"] + 1j * d["psi_y"], device="cpu")
    for name in ("Rx", "Ry", "freqs", "psi_x", "psi_y"):
        np.testing.assert_array_equal(getattr(warm, name).detach().numpy(),
                                      d[name])
    with pytest.raises(ValueError):
        init_psi(g, HP, R_in=np.zeros((4, 4)), device="cpu")


def test_weights_roundtrip(tmp_path):
    d = np_params(8)
    p = psi_params_from_numpy(d, "cpu")
    path = str(tmp_path / "params.npz")
    save_params(path, p)
    back = psi_params_to_numpy(load_params(path, "cpu"))
    assert set(back) == set(d)
    for k in d:
        np.testing.assert_array_equal(back[k], d[k])
    with pytest.raises(KeyError):
        psi_params_from_numpy({k: d[k] for k in ("A", "Rx")}, "cpu")


def test_damped_sine_batch():
    """Shape, the gate before the onset, the decaying envelope, and the
    Gamma(2, T/200) onset mean T/100 over many examples."""
    length = 2000
    g = torch.Generator().manual_seed(0)
    w = damped_sine_batch(g, 4000, length, HP.delta_t).numpy()
    again = damped_sine_batch(torch.Generator().manual_seed(0), 4000, length,
                              HP.delta_t).numpy()
    np.testing.assert_array_equal(w, again)
    assert w.shape == (4000, length) and w.dtype == np.float32
    assert np.all(np.isfinite(w)) and np.abs(w).max() <= 1.0
    onset = np.argmax(w != 0, axis=1)
    assert abs(onset.mean() / (length / 100.0) - 1.0) < 0.05
    two = damped_sine_batch(g, 2, length, HP.delta_t,
                            freq_hz=[261.6, 523.2]).numpy()
    assert two.shape == (2, length)
