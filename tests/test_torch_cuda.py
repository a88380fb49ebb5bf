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


def _train_inputs(dev, D, steps, B=5, seed=2):
    cfg = CMPSConfig(bond_dim=D)
    p = init_psi(torch.Generator(dev).manual_seed(D), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(seed), B,
                            steps + 1, cfg.delta_t)
    inputs = block.psi_nll_inputs(p, cfg, sig)
    g = torch.rand(B, generator=torch.Generator(dev).manual_seed(5),
                   device=dev) + 0.5
    return inputs, g


def _counts():
    return (block.psi_train_fwd.launches, block.psi_train_bwd.launches,
            block.psi_cotangents.launches)


@pytest.mark.parametrize("D", [8, 12, 16, 64])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_train_kernels_match_plain(dev, D, precision, defer):
    """Each training kernel against its plain version on the same inputs:
    the forward on the step inputs, the adjoint on the plain forward's
    streams, the cotangent reduction on the plain adjoint's streams."""
    inputs, g = _train_inputs(dev, D, STEPS[precision])
    kw = dict(norm_eps=inputs.pop("norm_eps"), precision=precision,
              defer_norm=defer, unroll=7)
    log_eps = inputs.pop("log_eps")
    before = _counts()
    fwd = block.psi_train_fwd_plain(**inputs, log_eps=log_eps, **kw)
    for a, b in zip(block.psi_train_fwd(**inputs, log_eps=log_eps, **kw),
                    fwd):
        _close(a, b, TOL[precision])
    _, ys, n2s = fwd
    bwd = block.psi_train_bwd_plain(**inputs, g=g, ys=ys, n2s=n2s,
                                    log_eps=log_eps, **kw)
    for a, b in zip(block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s,
                                        log_eps=log_eps, **kw), bwd):
        _close(a, b, TOL[precision])
    cot_in = dict(dy=bwd[2], ys=ys, t0=inputs["t0"], se=inputs["se"],
                  n2s=n2s, dehat=bwd[3])
    got = block.psi_cotangents(**cot_in, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, block.psi_cotangents_plain(**cot_in, **kw)):
        _close(a, b, TOL[precision])
    assert _counts() == tuple(c + 1 for c in before)


def test_train_path_runs_the_three_kernels_at_d64(dev):
    """One value-and-gradient of the training NLL on the card launches each
    training kernel once and matches the plain path (the same call on CPU
    copies of the inputs)."""
    from audio_mps_tpu_torch.weights import (psi_params_from_numpy,
                                             psi_params_to_numpy)
    cfg = CMPSConfig(bond_dim=64, minibatch_size=8)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), 8, 257,
                            cfg.delta_t)
    before = _counts()
    loss = block.psi_nll_block_trainable(p, cfg, sig, defer_norm=True)
    loss.backward()
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    q = psi_params_from_numpy(psi_params_to_numpy(p), "cpu")
    want = block.psi_nll_block_trainable(q, cfg, sig.cpu(), defer_norm=True)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        _close(getattr(p, name).grad.cpu(), getattr(q, name).grad, 1e-3)


@pytest.mark.parametrize("case", ["stream_off", "D72"])
def test_train_path_raises_without_a_kernel(dev, case):
    """kernel_stream="off" (the recompute adjoint is not ported) and D=72
    (the constants overflow shared memory) raise NotImplementedError on the
    card before any launch."""
    from audio_mps_tpu_torch.training import nll_fn_for
    D = 72 if case == "D72" else 8
    cfg = CMPSConfig(bond_dim=D, kernel_stream="off" if case == "stream_off"
                     else "auto")
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    sig = torch.zeros(2, 17, device=dev)
    before = _counts()
    with pytest.raises(NotImplementedError):
        nll_fn_for("psi_mps")(p, cfg, sig)
    assert _counts() == before


def test_train_kernels_index_past_2_pow_31_elements(dev):
    """A [n_steps, 2D, B] stream of more than 2^31 elements (8 GiB in fp32):
    the last column of the forward and of the adjoint over all columns
    equals, bit for bit, a launch over that column alone. The cotangents of
    streams that are zero except in the last column equal those of the
    column alone: the zero terms add nothing, and the split over steps
    depends on n_steps only."""
    cfg = CMPSConfig(bond_dim=8)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    n_steps, cols = 131073, 1024
    assert n_steps * 2 * cfg.bond_dim * cols > 2 ** 31
    inputs = block.psi_nll_inputs(p, cfg, torch.zeros(cols, 2, device=dev))
    inputs["se"] = torch.randn(n_steps, cols, device=dev,
                               generator=torch.Generator(dev).manual_seed(3)
                               ).mul_(0.01)
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              defer_norm=True)
    g = torch.ones(cols, device=dev)

    def last(x):
        return x[..., -1:].contiguous()

    alone = dict(t0=last(inputs["t0"]), se=last(inputs["se"]),
                 ab=inputs["ab"], bb=inputs["bb"], rb=inputs["rb"])
    loss, ys, n2s = block.psi_train_fwd(**inputs, **kw)
    a_loss, a_ys, a_n2s = block.psi_train_fwd(**alone, **kw)
    assert torch.equal(last(loss), a_loss) and torch.equal(last(ys), a_ys)
    dse, dt0, dy, dehat = block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s,
                                              **kw)
    a_bwd = block.psi_train_bwd(**alone, g=g[-1:], ys=a_ys, n2s=a_n2s, **kw)
    for a, b in zip((dse, dt0, dy, dehat), a_bwd):
        assert torch.equal(last(a), b)
    del kw["log_eps"]
    dy[..., :-1] = 0
    dehat[:, :-1] = 0
    got = block.psi_cotangents(dy, ys, inputs["t0"], inputs["se"], n2s,
                               dehat, **kw)
    del ys, dy
    want = block.psi_cotangents(a_bwd[2], a_ys, alone["t0"], alone["se"],
                                a_n2s, a_bwd[3], **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(b).all() and torch.equal(a, b)


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


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("defer", [False, True])
def test_train_forward_loss_is_the_nll_kernel_bit_for_bit(dev, precision,
                                                          defer):
    """The training forward and the scoring NLL are one kernel template
    (csrc/psi_fwd.cuh) with and without the state stream: their losses are
    equal bit for bit."""
    inputs, _ = _train_inputs(dev, 64, 300)
    kw = dict(precision=precision, defer_norm=defer, unroll=7)
    loss, _, _ = block.psi_train_fwd(**inputs, **kw)
    assert torch.equal(loss, block.psi_nll_block(**inputs, **kw))


# ---------------------------------------------------------------------------
# rho kernels (csrc/rho_*.cu): one CTA per example's [2D, rank] segment
# ---------------------------------------------------------------------------

# (D, rank) pairs: partial warps (D=8, rank 1), a rank that is not a multiple
# of 4 (3), and the full segment at the flagship width (64, 64)
RHO_SHAPES = [(8, 1), (8, 3), (12, 3), (16, 64), (64, 1), (64, 64)]


def _rho_params(dev, D, rank):
    from audio_mps_tpu_torch.models.params import init_rho
    cfg = CMPSConfig(bond_dim=D, initial_rank=rank)
    return init_rho(torch.Generator(dev).manual_seed(D + rank), cfg,
                    device=dev), cfg


def _rho_counts():
    return (block.rho_train_fwd.launches, block.rho_train_bwd.launches,
            block.rho_cotangents.launches)


@pytest.mark.parametrize("D, rank", [(8, 1), (8, 3), (16, 64), (64, 3),
                                     (64, 64)])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_rho_sampler_kernel_matches_plain(dev, D, rank, precision):
    p, cfg = _rho_params(dev, D, rank)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(1), 3,
                               STEPS[precision], 1.0)
    inputs = block.rho_sample_inputs(p, cfg, noise)
    before = block.rho_sample_block.launches
    got = block.rho_sample_block(**inputs, precision=precision)
    torch.cuda.synchronize()
    assert block.rho_sample_block.launches == before + 1
    _close(got, block.rho_sample_block_plain(**inputs, precision=precision),
           TOL[precision])


@pytest.mark.parametrize("D, rank", RHO_SHAPES)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_rho_nll_kernel_matches_plain(dev, D, rank, precision, defer):
    p, cfg = _rho_params(dev, D, rank)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(2), 3,
                            STEPS[precision] + 1, cfg.delta_t)
    inputs = block.rho_nll_inputs(p, cfg, sig)
    kw = dict(precision=precision, defer_norm=defer, unroll=7)
    before = block.rho_nll_block.launches
    got = block.rho_nll_block(**inputs, **kw)
    torch.cuda.synchronize()
    assert block.rho_nll_block.launches == before + 1
    _close(got, block.rho_nll_block_plain(**inputs, **kw), TOL[precision])


@pytest.mark.parametrize("D, rank", RHO_SHAPES)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_rho_train_kernels_match_plain(dev, D, rank, precision, defer):
    """Each rho training kernel against its plain version on the same
    inputs: the forward on the step inputs, the adjoint (tail and chain) on
    the plain forward's streams, the cotangents on the plain adjoint's
    streams."""
    p, cfg = _rho_params(dev, D, rank)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(2), 3,
                            STEPS[precision] + 1, cfg.delta_t)
    inputs = block.rho_nll_inputs(p, cfg, sig)
    g = torch.rand(3, generator=torch.Generator(dev).manual_seed(5),
                   device=dev) + 0.5
    kw = dict(norm_eps=inputs.pop("norm_eps"), precision=precision,
              defer_norm=defer, unroll=7)
    log_eps = inputs.pop("log_eps")
    before = _rho_counts()
    fwd = block.rho_train_fwd_plain(**inputs, log_eps=log_eps, **kw)
    for a, b in zip(block.rho_train_fwd(**inputs, log_eps=log_eps, **kw),
                    fwd):
        _close(a, b, TOL[precision])
    _, ys, trs = fwd
    bwd = block.rho_train_bwd_plain(**inputs, g=g, ys=ys, trs=trs,
                                    log_eps=log_eps, **kw)
    for a, b in zip(block.rho_train_bwd(**inputs, g=g, ys=ys, trs=trs,
                                        log_eps=log_eps, **kw), bwd):
        _close(a, b, TOL[precision])
    cot_in = dict(dy=bwd[2], ys=ys, t0=inputs["t0"], se=inputs["se"],
                  trs=trs, dehat=bwd[3])
    got = block.rho_cotangents(**cot_in, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, block.rho_cotangents_plain(**cot_in, **kw)):
        _close(a, b, TOL[precision])
    assert _rho_counts() == tuple(c + 1 for c in before)


def test_rho_train_path_runs_the_kernels_at_d64(dev):
    """One value-and-gradient of the rho training NLL on the card at D=64,
    rank 64 launches each rho training kernel once, no psi training kernel
    (the rho reductions run psi's kernel but count as rho's), and matches
    the plain path (the same call on CPU copies of the inputs)."""
    from audio_mps_tpu_torch.weights import (params_to_numpy,
                                             rho_params_from_numpy)
    p, cfg = _rho_params(dev, 64, 64)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), 2, 257,
                            cfg.delta_t)
    before, psi_before = _rho_counts(), _counts()
    loss = block.rho_nll_block_trainable(p, cfg, sig, defer_norm=True)
    loss.backward()
    torch.cuda.synchronize()
    assert _rho_counts() == tuple(c + 1 for c in before)
    assert _counts() == psi_before
    q = rho_params_from_numpy(params_to_numpy(p), "cpu")
    want = block.rho_nll_block_trainable(q, cfg, sig.cpu(), defer_norm=True)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        _close(getattr(p, name).grad.cpu(), getattr(q, name).grad, 1e-3)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("defer", [False, True])
def test_rho_train_forward_loss_is_the_nll_kernel_bit_for_bit(dev, precision,
                                                              defer):
    """The rho training forward and the scoring NLL are one kernel template
    (csrc/rho_fwd.cuh) with and without the state stream: their losses are
    equal bit for bit."""
    p, cfg = _rho_params(dev, 64, 64)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(2), 3, 301,
                            cfg.delta_t)
    inputs = block.rho_nll_inputs(p, cfg, sig)
    kw = dict(precision=precision, defer_norm=defer, unroll=7)
    loss, _, _ = block.rho_train_fwd(**inputs, **kw)
    assert torch.equal(loss, block.rho_nll_block(**inputs, **kw))


def test_rho_train_kernels_index_past_2_pow_31_elements(dev):
    """A [n_steps, 2D, B*rank] stream of more than 2^31 elements (8 GiB in
    fp32): the last example of the forward and of the adjoint over all
    examples equals, bit for bit, a launch over that example alone. The
    cotangents of streams that are zero except in the last example's lanes
    equal those of the example alone: the zero terms add nothing, and the
    split over steps depends on n_steps only."""
    p, cfg = _rho_params(dev, 8, 64)
    n_steps, B, rank = 16385, 128, 64
    assert n_steps * 2 * cfg.bond_dim * B * rank > 2 ** 31
    inputs = block.rho_nll_inputs(p, cfg, torch.zeros(B, 2, device=dev))
    inputs["se"] = torch.randn(n_steps, B, device=dev,
                               generator=torch.Generator(dev).manual_seed(3)
                               ).mul_(0.01)
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              defer_norm=True)
    g = torch.ones(B, device=dev)

    def last(x, lanes=rank):
        return x[..., -lanes:].contiguous()

    alone = dict(t0=last(inputs["t0"]), se=last(inputs["se"], 1),
                 ab=inputs["ab"], bb=inputs["bb"], xb=inputs["xb"])
    loss, ys, trs = block.rho_train_fwd(**inputs, **kw)
    a_loss, a_ys, a_trs = block.rho_train_fwd(**alone, **kw)
    assert torch.equal(last(loss, 1), a_loss) and torch.equal(last(ys), a_ys)
    assert torch.equal(last(trs, 1), a_trs)
    dse, dt0, dy, dehat = block.rho_train_bwd(**inputs, g=g, ys=ys, trs=trs,
                                              **kw)
    a_bwd = block.rho_train_bwd(**alone, g=g[-1:], ys=a_ys, trs=a_trs, **kw)
    for a, b, lanes in zip((dse, dt0, dy, dehat), a_bwd, (1, rank, rank, 1)):
        assert torch.equal(last(a, lanes), b)
    del kw["log_eps"]
    dy[..., :-rank] = 0
    dehat[:, :-1] = 0
    got = block.rho_cotangents(dy, ys, inputs["t0"], inputs["se"], trs,
                               dehat, **kw)
    del ys, dy
    want = block.rho_cotangents(a_bwd[2], a_ys, alone["t0"], alone["se"],
                                a_trs, a_bwd[3], **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(b).all() and torch.equal(a, b)
