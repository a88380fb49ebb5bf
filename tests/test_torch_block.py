"""Plain versions of the port's two block kernels (audio_mps_tpu_torch.ops)
against the JAX block kernels in Pallas interpret mode and the JAX XLA scan,
on the same numpy inputs. CPU tensors take the plain versions; the CUDA
kernels are held to them on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu.models import core as jcore
from audio_mps_tpu.models.cell import make_constants as jmake_constants
from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu.ops.pallas_scan import psi_sample_pallas
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.models.cell import make_constants
from audio_mps_tpu_torch.ops import block, scan
from audio_mps_tpu_torch.weights import psi_params_from_numpy
from test_torch_core import both, np_params, np_signals

T = 83    # odd: not a multiple of the TPU kernels' 16-step blocks


def configs(D):
    return (CMPSConfig(minibatch_size=4, bond_dim=D, scan_chunk=0),
            jconfig.CMPSConfig(minibatch_size=4, bond_dim=D, scan_chunk=0))


def np_noise(N, seed=3):
    return (1e-4 * np.random.default_rng(seed).standard_normal((T, N))
            ).astype(np.float32)


def test_block_constants_and_t0_match_jax():
    hp, jhp = configs(8)
    jp, tp = both(np_params(8))
    cj, ct = jmake_constants(jp, jhp), make_constants(tp, hp)
    for a, b in zip(block._psi_block_constants(ct),
                    jblock._psi_block_constants(cj)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)
    x0 = np.random.default_rng(4).standard_normal((2, 8, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        block._psi_block_t0(ct, *map(torch.as_tensor, x0)).detach().numpy(),
        np.asarray(jblock._psi_block_t0(cj, *map(jnp.asarray, x0))),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("defer", [False, True])
def test_nll_plain_matches_jax(D, precision, defer):
    """highest at rtol 1e-5 / atol 1e-7, against the Pallas kernel and the
    XLA scan; high at rtol 1e-4 against the Pallas kernel: the bf16 splits
    are the same and only the order of the sums differs."""
    hp, jhp = configs(D)
    jp, tp = both(np_params(D))
    sig = np_signals(4, T)
    got = scan.psi_nll_fused(tp, hp, torch.as_tensor(sig),
                             precision=precision, defer_norm=defer).item()
    want = float(jblock.psi_nll_block(jp, jhp, jnp.asarray(sig),
                                      interpret=True, precision=precision,
                                      defer_norm=defer))
    if precision == "highest":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            got, float(jcore.psi_nll(jp, jhp, jnp.asarray(sig))),
            rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_dot_menu_rounds_operands_as_jax(precision):
    """The plain versions' products on operands rounded or split exactly as
    the TPU kernels' _make_dot_ops does (JAX's bf16 casts and _split_bf16),
    summed in fp32."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal((16, 3)).astype(np.float32)
    prep, dotf = block._make_dot_ops(precision)
    got = dotf(prep(torch.as_tensor(a)), prep(torch.as_tensor(b))).numpy()

    def f64(x):
        return np.asarray(x.astype(jnp.float32), np.float64)

    if precision == "highest":
        want = a.astype(np.float64) @ b
    elif precision == "default":
        want = (f64(jnp.asarray(a).astype(jnp.bfloat16))
                @ f64(jnp.asarray(b).astype(jnp.bfloat16)))
    else:
        ah, al = map(f64, jblock._split_bf16(jnp.asarray(a)))
        bh, bl = map(f64, jblock._split_bf16(jnp.asarray(b)))
        want = ah @ bh + ah @ bl + al @ bh
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# The port's "default" is one bf16 product per dot, as on the TPU. JAX on the
# CPU computes "default" in fp32, so the port is held to JAX's "highest",
# over one 16-step block. Rounding Ab and the state to bf16 (2^-8 to 2^-9
# relative) moves e = 2<y|R y> by up to ~1e-2 of its size at every step, and
# the per-step deviations add up along the run, so 1e-2 cannot hold over a
# run. The draw below is held at 5e-2 over 16 steps, plus a check that the
# result differs from the port's own fp32 result (bf16 rounding did happen).
DEFAULT_TOL = 5e-2
DEFAULT_STEPS = 16


@pytest.mark.parametrize("defer", [False, True])
def test_nll_plain_default_is_one_bf16_pass(defer):
    hp, jhp = configs(8)
    jp, tp = both(np_params(8))
    sig = torch.as_tensor(np_signals(4, T)[:, :DEFAULT_STEPS + 1])
    got = scan.psi_nll_fused(tp, hp, sig, precision="default",
                             defer_norm=defer).item()
    fp32 = scan.psi_nll_fused(tp, hp, sig, defer_norm=defer).item()
    want = float(jblock.psi_nll_block(jp, jhp, jnp.asarray(sig.numpy()),
                                      interpret=True, defer_norm=defer))
    assert abs(got - want) <= DEFAULT_TOL * abs(want)
    assert abs(got - fp32) > 1e-4 * abs(fp32)


@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_sample_plain_matches_jax(D, precision):
    """Waveforms on the same noise: highest at rtol 2e-5 / atol 2e-6 max|w|
    (tests/test_pallas_block.py:141) against the Pallas kernel and the XLA
    scan; high at rtol 1e-4 / atol 1e-4 max|w|."""
    hp, jhp = configs(D)
    jp, tp = both(np_params(D))
    noise = np_noise(3)
    got = scan.psi_sample_fused(tp, hp, torch.as_tensor(noise),
                                precision=precision).numpy()
    want = np.asarray(jblock.psi_sample_block(jp, jhp, jnp.asarray(noise),
                                              interpret=True,
                                              precision=precision))
    assert got.shape == (3, T)
    if precision == "highest":
        np.testing.assert_allclose(
            got, np.asarray(jcore.sample_psi_with_noise(
                jp, jhp, jnp.asarray(noise))),
            rtol=2e-5, atol=2e-6 * np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=2e-6 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_sample_plain_default_is_one_bf16_pass():
    hp, jhp = configs(8)
    jp, tp = both(np_params(8))
    noise = torch.as_tensor(np_noise(3)[:DEFAULT_STEPS])
    got = scan.psi_sample_fused(tp, hp, noise, precision="default").numpy()
    fp32 = scan.psi_sample_fused(tp, hp, noise).numpy()
    want = np.asarray(jblock.psi_sample_block(jp, jhp,
                                              jnp.asarray(noise.numpy()),
                                              interpret=True))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= DEFAULT_TOL * scale
    assert np.abs(got - fp32).max() > 1e-4 * scale


def test_layout_resolution_and_guards():
    """The dispatch rules of tests/test_pallas_block.py:162-178."""
    hp, _ = configs(8)
    assert scan._nll_layout(hp, None) == "block"                # auto, D=8
    assert scan._nll_layout(dataclasses.replace(hp, bond_dim=2),
                            None) == "split"                    # auto, D=2
    assert scan._nll_layout(hp, "split") == "split"             # explicit
    with pytest.raises(ValueError):
        scan._nll_layout(hp, "mosaic")
    hp2 = dataclasses.replace(hp, bond_dim=2)
    p2 = psi_params_from_numpy(np_params(2), "cpu")
    sig = torch.as_tensor(np_signals(4, T))
    with pytest.raises(ValueError):                  # explicit block, D=2
        scan.psi_nll_fused(p2, hp2, sig, layout="block")
    with pytest.raises(ValueError):                  # high needs block
        scan.psi_nll_fused(p2, hp2, sig, precision="high")
    with pytest.raises(ValueError):
        scan.psi_nll_fused(psi_params_from_numpy(np_params(8), "cpu"), hp,
                           sig, precision="fast")


def test_split_layouts_run_their_plain_twin_on_cpu():
    """D=4: the NLL takes the block layout, the sampler resolves to split
    (D % 8 != 0) even when block is asked for, and on a CPU tensor the split
    layout runs its kernels' plain versions (ops/split.py), equal to the JAX
    split kernels and to the eager reference."""
    hp, jhp = configs(4)
    jp, tp = both(np_params(4))
    noise = np_noise(3)
    want = np.asarray(psi_sample_pallas(jp, jhp, jnp.asarray(noise),
                                        layout="split", interpret=True))
    got = scan.psi_sample_fused(tp, hp, torch.as_tensor(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())
    with pytest.warns(UserWarning):
        scan.psi_sample_fused(tp, hp, torch.as_tensor(noise), layout="block")
    with pytest.raises(ValueError):
        block.psi_sample_inputs(tp, hp, torch.as_tensor(noise))
    sig = np_signals(4, T)
    assert scan._nll_layout(hp, None) == "block"
    got = scan.psi_nll_fused(tp, hp, torch.as_tensor(sig),
                             layout="split").item()
    np.testing.assert_allclose(got, float(jcore.psi_nll(jp, jhp,
                                                        jnp.asarray(sig))),
                               rtol=1e-5, atol=1e-7)


def test_nll_plain_unroll_only_moves_deferred_rounding():
    """The renormalisation period changes the deferred result only at the
    rounding level, and the per-step result not at all."""
    hp, _ = configs(8)
    tp = psi_params_from_numpy(np_params(8), "cpu")
    inputs = block.psi_nll_inputs(tp, hp, torch.as_tensor(np_signals(4, T)))
    ref = block.psi_nll_block_plain(**inputs).numpy()
    for unroll in (1, 5, 16, 100):
        np.testing.assert_allclose(
            block.psi_nll_block_plain(**inputs, unroll=unroll,
                                      defer_norm=True).numpy(),
            ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            block.psi_nll_block_plain(**inputs, unroll=unroll).numpy(), ref)


@pytest.mark.parametrize("B, D, want", [
    (8, 64, 1), (128, 64, 1), (132, 64, 1),   # one wave at one column a CTA
    (133, 64, 2), (264, 64, 2), (265, 64, 4),  # the fewest waves, smallest G
    (528, 64, 4),                              # 132 CTAs of 4
    (1024, 64, 4), (4096, 64, 4),              # at most 4: 2 and 8 waves
    (1024, 8, 4), (1024, 12, 4),
    (1024, 68, 4),     # every G fits at D=68 (Ab and Bb in registers)
    (1024, 72, 1)])    # the quad layout stops at D=68 (the launch raises)
def test_psi_columns_rule(B, D, want):
    """The columns a CTA of psi's block kernels on an H100's 132 SMs: 1
    while B CTAs fit one wave, else the G of fewest waves (the smallest
    such, at most 4) whose forward and adjoint CTAs fit a block's shared
    memory, at a D the quad layout takes; the counts at D=64 are the
    kernels': 109,328 bytes at G=1 (Rb^T at a pitch of 132 words; a
    column's double buffer of the prepped t, history of y raw, hi and lo,
    loss ring and 32 partials), 151,072 from G=2 (two such columns walked
    side by side) and 202,944 at every G (the adjoint's tail CTA: Rb^T and
    Rb at a pitch of 136 words, and for each of its 2 columns five [128,
    12] buffers, the 8 steps' partials of 34 tiles and their 8
    factors)."""
    assert block.psi_columns_per_cta(B, D, 132) == want
    for G in block.PSI_COLS:
        side = 2 if G >= 2 else 1
        assert block.psi_fwd_smem_bytes(64, G) == 4 * (
            128 * 132 + side * (16 * 36 + 3 * 128 * 24 + 18 * 34 + 32))
        assert block.psi_bwd_smem_bytes(64, G) == 4 * (
            2 * 128 * 136 + 2 * (5 * 128 * 12 + 8 * 34 + 8))
    assert block.psi_columns_per_cta(B, D, 132, smem_optin=0) == 1


def test_psi_wrappers_check_cols_per_cta_on_cpu():
    """On the CPU the wrappers run the plain versions whatever G, but a G
    the kernels do not take raises there too."""
    hp, _ = configs(8)
    _, tp = both(np_params(8))
    inputs = block.psi_nll_inputs(tp, hp, torch.as_tensor(np_signals(3, 40)))
    want = block.psi_nll_block(**inputs)
    assert torch.equal(block.psi_nll_block(**inputs, cols_per_cta=8), want)
    for fn in (block.psi_nll_block, block.psi_train_fwd,
               block.psi_train_fwd_ckpt):
        with pytest.raises(ValueError, match="cols_per_cta"):
            fn(**inputs, cols_per_cta=3)
