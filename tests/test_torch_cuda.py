"""The port's CUDA kernels (csrc/) against their plain PyTorch versions on
the card, at small shapes that include partial warps (D=8, 12) and the
flagship width (D=64). Every test needs an NVIDIA card and skips without
one. This file imports no jax; on a card machine run

    python -m pytest --noconftest tests/test_torch_isolation.py \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.data import damped_sine_batch
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.models.params import init_psi
from audio_mps_tpu_torch.ops import block

pytestmark = pytest.mark.cuda

# max|kernel - plain| <= TOL * max|plain|. highest and high: the same
# arithmetic in another summation order (see chip_smoke.py). default rounds
# the state to bf16 at every step, so one rounding that falls the other way
# moves the trajectory by ~2^-9; it is held over 16 steps only.
TOL = {"highest": 1e-4, "high": 1e-3, "default": 5e-2}
STEPS = {"highest": 300, "high": 300, "default": 16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("D", [8, 16, 64])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_sampler_kernel_matches_plain(dev, D, precision):
    cfg = CMPSConfig(bond_dim=D)
    p = init_psi(torch.Generator(dev).manual_seed(D), cfg, device=dev)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(1), 3,
                               STEPS[precision], 1.0)
    inputs = block.psi_sample_inputs(p, cfg, noise)
    before = block.psi_sample_block.launches
    got = block.psi_sample_block(**inputs, precision=precision)
    torch.cuda.synchronize()
    assert block.psi_sample_block.launches == before + 1
    _close(got, block.psi_sample_block_plain(**inputs, precision=precision),
           TOL[precision])


@pytest.mark.parametrize("D", [8, 12, 16, 64])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_nll_kernel_matches_plain(dev, D, precision, defer):
    cfg = CMPSConfig(bond_dim=D)
    p = init_psi(torch.Generator(dev).manual_seed(D), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(2), 5,
                            STEPS[precision] + 1, cfg.delta_t)
    inputs = block.psi_nll_inputs(p, cfg, sig)
    kw = dict(precision=precision, defer_norm=defer, unroll=7)
    before = block.psi_nll_block.launches
    got = block.psi_nll_block(**inputs, **kw)
    torch.cuda.synchronize()
    assert block.psi_nll_block.launches == before + 1
    _close(got, block.psi_nll_block_plain(**inputs, **kw), TOL[precision])


@pytest.mark.parametrize("kind", ["sample", "nll"])
def test_kernels_index_past_2_pow_31_elements(dev, kind):
    """A [T, cols] operand of more than 2^31 elements (8 GiB in fp32): the
    last column of one launch over all columns equals, bit for bit, a
    launch over that column alone, so its reads and writes past element
    2^31 land where they should. Each CTA runs the same arithmetic on its
    column in both launches."""
    cfg = CMPSConfig(bond_dim=8)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    if kind == "sample":
        T, cols, fn = 65537, 32768, block.psi_sample_block
        inputs = block.psi_sample_inputs(p, cfg, torch.zeros(1, cols,
                                                             device=dev))
        key = "noise"
    else:
        T, cols, fn = 16385, 131072, block.psi_nll_block
        inputs = block.psi_nll_inputs(p, cfg, torch.zeros(cols, 2,
                                                          device=dev))
        key = "se"
    assert T * cols > 2 ** 31
    inputs[key] = torch.randn(T, cols, generator=gen, device=dev).mul_(0.01)
    got = fn(**inputs)[..., -1:].clone()
    alone = dict(inputs, t0=inputs["t0"][:, -1:].contiguous())
    alone[key] = inputs[key][:, -1:].contiguous()
    del inputs
    want = fn(**alone)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)
