"""The port's rho family (audio_mps_tpu_torch) on its serving side: the
eager core (models/cell.py, models/core.py), the plain versions of the rho
sampler and forward NLL kernels (ops/block.py) with their dispatch
(ops/scan.py), weights, RhoCMPS and the sample CLI, against the JAX package
on the same numpy inputs, on the CPU. The JAX block kernels run in Pallas
interpret mode. D=8 with rank 3 (a rank that is not D) and rank 8; T=83, so
T-1 = 82 fills no whole 16-step block. The numpy input helpers here are
shared with test_torch_rho_train.py."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu.models import core as jcore
from audio_mps_tpu.models.cell import make_constants as jmake_constants
from audio_mps_tpu.models.params import RhoParams as JaxRhoParams
from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu.ops.pallas_scan import rho_factor_inputs as j_factor_inputs
from audio_mps_tpu.ops.pallas_scan import rho_sample_pallas
from audio_mps_tpu_torch import CMPSConfig, RhoCMPS
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.models.cell import make_constants
from audio_mps_tpu_torch.models.params import init_rho
from audio_mps_tpu_torch.ops import block, scan
from audio_mps_tpu_torch.sample import SampleConfig, sample
from audio_mps_tpu_torch.weights import (load_params, params_to_numpy,
                                         rho_params_from_numpy, save_params)
from test_torch_core import ATOL, HP, RTOL, close, np_signals

T = 83
D = 8


def np_rho_params(D, rank, seed=0):
    """rho weights at their init scales (R: 1/sqrt(r_reg), freqs:
    1/sqrt(h_reg), W: glorot limits), made with numpy."""
    rng = np.random.default_rng(seed)
    r = 1.0 / np.sqrt(HP.r_reg)
    lim = np.sqrt(6.0 / (rank + D))
    f32 = np.float32
    return dict(A=f32(HP.A),
                Rx=(r * rng.standard_normal((D, D))).astype(f32),
                Ry=(r * rng.standard_normal((D, D))).astype(f32),
                freqs=(rng.standard_normal(D) / np.sqrt(HP.h_reg)).astype(f32),
                Wx=rng.uniform(-lim, lim, (rank, D)).astype(f32),
                Wy=rng.uniform(-lim, lim, (rank, D)).astype(f32))


def rho_both(d):
    """(JAX params, port params on the CPU) from one numpy dict."""
    return (JaxRhoParams(**{k: jnp.asarray(v) for k, v in d.items()}),
            rho_params_from_numpy(d, "cpu"))


def rho_configs(D=D, rank=None, **kw):
    base = dict(minibatch_size=3, bond_dim=D, initial_rank=rank,
                scan_chunk=0)
    base.update(kw)
    return CMPSConfig(**base), jconfig.CMPSConfig(**base)


def np_noise(N, length=T, seed=3):
    return (1e-4 * np.random.default_rng(seed).standard_normal((length, N))
            ).astype(np.float32)


@pytest.mark.parametrize("rank", [3, 8])
def test_rho0_and_both_losses_match_jax(rank):
    """rho_0, the literal density-matrix loss core.rho_nll and the factor
    loss core.rho_nll_factor against JAX and against each other."""
    hp, jhp = rho_configs(rank=rank)
    jp, tp = rho_both(np_rho_params(D, rank))
    for a, b in zip(core.rho0(tp, hp), jcore.rho0(jp, jhp)):
        close(a, b)
    sig = np_signals(3, T)
    lit = core.rho_nll(tp, hp, torch.as_tensor(sig))
    fac = core.rho_nll_factor(tp, hp, torch.as_tensor(sig))
    close(lit, jcore.rho_nll(jp, jhp, jnp.asarray(sig)))
    close(fac, jcore.rho_nll_factor(jp, jhp, jnp.asarray(sig)))
    close(fac, lit.detach().numpy())


def test_factor_inputs_constants_and_t0_match_jax():
    hp, jhp = rho_configs(rank=3)
    jp, tp = rho_both(np_rho_params(D, 3))
    h0 = block.rho_factor_inputs(tp, hp, 4)
    jh0r, jh0i, _ = j_factor_inputs(jp, jhp, 4)
    for a, b in zip(h0, (jh0r, jh0i)):
        close(a, b, rtol=1e-6)
    cj, ct = jmake_constants(jp, jhp), make_constants(tp, hp)
    for a, b in zip(block._rho_block_constants(ct),
                    jblock._rho_block_constants(cj)):
        close(a, b, rtol=1e-6)
    close(block._rho_block_t0(ct, *h0),
          jblock._rho_block_t0(cj, jh0r, jh0i), rtol=1e-6)


def test_cell_steps_match_jax():
    """One rho_loss_step, rho_evolve_step and rho_sample_step on a batch of
    density matrices, and one factor step."""
    from audio_mps_tpu.models import cell as jcell
    from audio_mps_tpu_torch.models import cell
    hp, jhp = rho_configs(rank=3)
    jp, tp = rho_both(np_rho_params(D, 3))
    cj, ct = jmake_constants(jp, jhp), make_constants(tp, hp)
    rr, ri = core.rho0(tp, hp)
    jr, ji = jcore.rho0(jp, jhp)
    x = np.asarray([0.01, -0.02], np.float32)
    carry = (rr[None].expand(2, D, D), ri[None].expand(2, D, D),
             torch.zeros(2))
    jcarry = (jnp.broadcast_to(jr, (2, D, D)), jnp.broadcast_to(ji, (2, D, D)),
              jnp.zeros(2))
    for a, b in zip(cell.rho_loss_step(ct, hp, carry, torch.as_tensor(x)),
                    jcell.rho_loss_step(cj, jhp, jcarry, jnp.asarray(x))):
        close(a, b)
    got = cell.rho_sample_step(ct, hp, carry[:2], torch.as_tensor(x))
    want = jcell.rho_sample_step(cj, jhp, jcarry[:2], jnp.asarray(x))
    for a, b in zip([*got[0], got[1][0], *got[1][1]],
                    jax.tree_util.tree_leaves(want)):
        close(a, b)
    g0 = cell.rho_factor_state0(tp, hp, 2)
    jg0 = jcell.rho_factor_state0(jp, jhp, 2)
    for a, b in zip(cell.rho_factor_loss_step(ct, hp, (*g0, torch.zeros(2)),
                                              torch.as_tensor(x)),
                    jcell.rho_factor_loss_step(cj, jhp, (*jg0, jnp.zeros(2)),
                                               jnp.asarray(x))):
        close(a, b)


def test_sample_rho_with_noise_matches_jax():
    hp, jhp = rho_configs(rank=3)
    jp, tp = rho_both(np_rho_params(D, 3))
    noise = np_noise(2)
    got = core.sample_rho_with_noise(tp, hp, torch.as_tensor(noise))
    want = np.asarray(jcore.sample_rho_with_noise(jp, jhp, jnp.asarray(noise)))
    close(got, want, rtol=2e-5, atol=2e-6 * np.abs(want).max())


def test_rho_evolve_with_data_matches_jax():
    hp, jhp = rho_configs(rank=3)
    jp, tp = rho_both(np_rho_params(D, 3))
    sig = np_signals(2, 40)
    got = core.rho_evolve_with_data(tp, hp, torch.as_tensor(sig))
    want = jcore.rho_evolve_with_data(jp, jhp, jnp.asarray(sig))
    assert got[0].shape == (2, 39, D, D)
    for a, b in zip(got, want):
        close(a, b, atol=1e-6)
    # trace 1 and Hermitian along the trajectory
    tr = got[0].diagonal(dim1=-2, dim2=-1).sum(-1)
    assert torch.allclose(tr, torch.ones_like(tr), atol=1e-5)
    assert torch.allclose(got[1], -got[1].transpose(-1, -2), atol=1e-6)


def test_sampled_trajectory_and_purity_match_jax():
    """rho_evolve_with_sampling and purity of the JAX package against the
    port's noise-driven versions fed the noise JAX draws from the same
    key."""
    hp, jhp = rho_configs(rank=3)
    jp, tp = rho_both(np_rho_params(D, 3))
    key = jax.random.PRNGKey(7)
    noise = torch.as_tensor(np.array(jcore._sample_noise(jhp, key, 2, 30,
                                                         1.0)))
    got = core.rho_evolve_with_noise(tp, hp, noise)
    want = jcore.rho_evolve_with_sampling(jp, jhp, key, 2, 30)
    for a, b in zip(got, want):
        close(a, b, atol=1e-6)
    p = core.purity_with_noise(tp, hp, noise)
    close(p, jcore.purity(jp, jhp, key, 2, 30), atol=1e-6)
    assert p.shape == (2, 30) and bool((p <= 1.0 + 1e-5).all())


@pytest.mark.parametrize("rank", [3, 8])
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("defer", [False, True])
def test_nll_plain_matches_jax(rank, precision, defer):
    """The plain rho NLL (through rho_nll_fused) against the JAX block
    kernel: highest at rtol 1e-5 / atol 1e-7, and against the XLA factor
    scan; high at rtol 1e-4, the bf16 splits being the same and only the
    order of the sums differing."""
    hp, jhp = rho_configs(rank=rank)
    jp, tp = rho_both(np_rho_params(D, rank))
    sig = np_signals(3, T)
    got = scan.rho_nll_fused(tp, hp, torch.as_tensor(sig),
                             precision=precision, defer_norm=defer).item()
    want = float(jblock.rho_nll_block(jp, jhp, jnp.asarray(sig),
                                      interpret=True, precision=precision,
                                      defer_norm=defer))
    if precision == "highest":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got, float(jcore.rho_nll_factor(jp, jhp, jnp.asarray(sig))),
            rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("rank", [3, 8])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_sample_plain_matches_jax(rank, precision):
    """Waveforms on the same noise against the JAX block sampler and the XLA
    scan: highest at rtol 2e-5 / atol 5e-6 max|w| (the JAX block sampler
    and the XLA scan themselves differ by 2.0e-6 max|w| on this draw at
    rank 8; the port lies within 3.5e-6 of both); high at rtol 1e-4 /
    atol 1e-4 max|w|."""
    hp, jhp = rho_configs(rank=rank)
    jp, tp = rho_both(np_rho_params(D, rank))
    noise = np_noise(2)
    got = scan.rho_sample_fused(tp, hp, torch.as_tensor(noise),
                                precision=precision).numpy()
    want = np.asarray(jblock.rho_sample_block(jp, jhp, jnp.asarray(noise),
                                              interpret=True,
                                              precision=precision))
    assert got.shape == (2, T)
    scale = np.abs(want).max()
    if precision == "highest":
        np.testing.assert_allclose(
            got, np.asarray(jcore.sample_rho_with_noise(jp, jhp,
                                                        jnp.asarray(noise))),
            rtol=2e-5, atol=5e-6 * scale)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=5e-6 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


# The port's "default" is one bf16 product per dot, as on the TPU; JAX on
# the CPU computes "default" in fp32. As for psi (tests/test_torch_block.py),
# the port is held to JAX's "highest" at 5e-2 over one 16-step block, and
# must differ from its own fp32 result.
DEFAULT_TOL = 5e-2
DEFAULT_STEPS = 16


def test_default_is_one_bf16_pass():
    hp, jhp = rho_configs(rank=3)
    jp, tp = rho_both(np_rho_params(D, 3))
    sig = torch.as_tensor(np_signals(3, T)[:, :DEFAULT_STEPS + 1])
    got = scan.rho_nll_fused(tp, hp, sig, precision="default").item()
    fp32 = scan.rho_nll_fused(tp, hp, sig).item()
    want = float(jblock.rho_nll_block(jp, jhp, jnp.asarray(sig.numpy()),
                                      interpret=True))
    assert abs(got - want) <= DEFAULT_TOL * abs(want)
    assert abs(got - fp32) > 1e-4 * abs(fp32)
    noise = torch.as_tensor(np_noise(2)[:DEFAULT_STEPS])
    got = scan.rho_sample_fused(tp, hp, noise, precision="default").numpy()
    fp32 = scan.rho_sample_fused(tp, hp, noise).numpy()
    want = np.asarray(jblock.rho_sample_block(jp, jhp,
                                              jnp.asarray(noise.numpy()),
                                              interpret=True))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= DEFAULT_TOL * scale
    assert np.abs(got - fp32).max() > 1e-4 * scale


def test_split_layouts_run_the_plain_kernels_on_cpu():
    """D=4: the NLL takes the block layout, the sampler resolves to split
    (D % 8 != 0); D=6: the NLL resolves to split. On a CPU tensor the split
    layout runs the plain versions of the split kernels
    (split.rho_sample_split_plain, split.rho_nll_split_plain), equal to the
    JAX split kernels."""
    from audio_mps_tpu.ops.pallas_scan import rho_nll_pallas
    hp4, jhp4 = rho_configs(D=4, rank=3)
    jp, tp = rho_both(np_rho_params(4, 3))
    noise = np_noise(2)
    want = np.asarray(rho_sample_pallas(jp, jhp4, jnp.asarray(noise),
                                        layout="split", interpret=True))
    got = scan.rho_sample_fused(tp, hp4, torch.as_tensor(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())
    with pytest.raises(ValueError):
        block.rho_sample_inputs(tp, hp4, torch.as_tensor(noise))
    hp6, jhp6 = rho_configs(D=6, rank=3)
    jp6, tp6 = rho_both(np_rho_params(6, 3))
    sig = np_signals(3, T)
    got = scan.rho_nll_fused(tp6, hp6, torch.as_tensor(sig)).item()
    np.testing.assert_allclose(got, float(rho_nll_pallas(
        jp6, jhp6, jnp.asarray(sig), interpret=True)), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        scan.rho_nll_fused(tp6, hp6, torch.as_tensor(sig), precision="high")
    with pytest.raises(ValueError):
        scan.rho_nll_fused(tp6, hp6, torch.as_tensor(sig), layout="block")


def test_rhocmps_matches_jax():
    """The class API on JAX-made weights: .loss (core.rho_nll), rho_0, R,
    the data trajectory, and the eager and fused samplers on one noise."""
    from audio_mps_tpu.models.cmps import RhoCMPS as JaxRhoCMPS
    d = np_rho_params(D, 3)
    hp, jhp = rho_configs(rank=3)
    sig = np_signals(3, 40)
    kw = dict(R_in=d["Rx"] + 1j * d["Ry"], freqs_in=d["freqs"],
              W_in=d["Wx"] + 1j * d["Wy"])
    m = RhoCMPS(hp, data_iterator=sig, device="cpu", **kw)
    jm = JaxRhoCMPS(jhp, data_iterator=sig, **kw)
    np.testing.assert_allclose(m.loss.item(), float(jm.loss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(m.rho_0, jm.rho_0, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(m.R, jm.R)
    assert m.rank_rho_0 == jm.rank_rho_0 == 3
    np.testing.assert_allclose(m.rho_evolve_with_data(),
                               jm.rho_evolve_with_data(), rtol=1e-5,
                               atol=1e-6)
    noise = core._sample_noise(hp, torch.Generator().manual_seed(5), 2, T,
                               1.0)
    jp = rho_both(d)[0]
    want = np.asarray(jblock.rho_sample_block(
        jp, jhp, jnp.asarray(noise.numpy()), interpret=True))
    for fused in (False, True):
        got = m.sample(2, T, generator=torch.Generator().manual_seed(5),
                       fused=fused)
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-6 * np.abs(want).max())
    traj = m.rho_evolve_with_sampling(2, 20)
    pur = m.purity(2, 20)
    assert traj.shape == (2, 20, D, D) and pur.shape == (2, 20)
    assert np.all(np.isfinite(pur)) and np.all(pur <= 1.0 + 1e-5)


def test_sample_cli_reads_rho_weights(tmp_path):
    """The sample CLI with --mps_model=rho_mps restores params.npz (Wx/Wy
    leaves) and writes the fused sampler's waveforms; the eager path gives
    the same waves; psi weights under rho_mps raise."""
    d = np_rho_params(D, 3)
    hp, _ = rho_configs(rank=3)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"cfg": dataclasses.asdict(hp),
                   "run": {"mps_model": "rho_mps"}}, f)
    save_params(str(tmp_path / "params.npz"), rho_params_from_numpy(d, "cpu"))
    out = str(tmp_path / "s.npz")
    sc = SampleConfig(modeldir=str(tmp_path), num_samples=2,
                      sample_duration=50, fused=True, device="cpu", out=out)
    waves = sample(sc, verbose=False)
    assert waves.shape == (2, 50) and np.all(np.isfinite(waves))
    assert os.path.exists(out) and os.path.exists(str(tmp_path / "s_1.wav"))
    eager = sample(dataclasses.replace(sc, fused=False, wav=False, out=""),
                   verbose=False)
    np.testing.assert_allclose(waves, eager, rtol=2e-5,
                               atol=2e-6 * np.abs(eager).max())
    from test_torch_core import np_params
    from audio_mps_tpu_torch.weights import psi_params_from_numpy
    save_params(str(tmp_path / "params.npz"),
                psi_params_from_numpy(np_params(D), "cpu"))
    with pytest.raises(ValueError):
        sample(sc, verbose=False)


def test_weights_pick_the_family(tmp_path):
    d = np_rho_params(D, 3)
    p = rho_params_from_numpy(d, "cpu")
    path = str(tmp_path / "params.npz")
    save_params(path, p)
    back = load_params(path, "cpu")
    assert type(back).__name__ == "RhoParams"
    for k, v in params_to_numpy(back).items():
        np.testing.assert_array_equal(v, d[k])
    with pytest.raises(KeyError):
        rho_params_from_numpy({k: d[k] for k in ("A", "Rx", "Wx")}, "cpu")


def test_init_rho_scales_and_warm_starts():
    hp, _ = rho_configs(rank=None)
    g = torch.Generator().manual_seed(0)
    p = init_rho(g, hp, device="cpu")
    again = init_rho(torch.Generator().manual_seed(0), hp, device="cpu")
    for name in p.NAMES:
        assert torch.equal(getattr(p, name), getattr(again, name))
    assert p.Wx.shape == (D, D)           # initial_rank=None: rank D
    assert p.Wx.abs().max() <= np.sqrt(6.0 / (2 * D))
    hp3 = dataclasses.replace(hp, initial_rank=3)
    d = np_rho_params(D, 3)
    warm = init_rho(g, hp3, W_in=d["Wx"] + 1j * d["Wy"], device="cpu")
    np.testing.assert_array_equal(warm.Wy.detach().numpy(), d["Wy"])
    with pytest.raises(ValueError):
        init_rho(g, hp3, W_in=np.zeros((4, D)), device="cpu")
