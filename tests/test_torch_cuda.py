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


def _psi_sample_inputs(dev, D, N, steps):
    cfg = CMPSConfig(bond_dim=D)
    p = init_psi(torch.Generator(dev).manual_seed(D), cfg, device=dev)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(1), N,
                               steps, 1.0)
    return block.psi_sample_inputs(p, cfg, noise)


@pytest.mark.parametrize("D", [8, 16, 64, 72, 80])
@pytest.mark.parametrize("N", [1, 3, 133])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_sampler_kernel_matches_plain(dev, D, N, precision):
    """The sampler in the body of psi_sample_body (quad to D=64, row at 72
    and 80), one chain, three, and 133 (past one wave of 132 SMs)."""
    inputs = _psi_sample_inputs(dev, D, N, STEPS[precision])
    before = block.psi_sample_block.launches
    got = block.psi_sample_block(**inputs, precision=precision)
    torch.cuda.synchronize()
    assert block.psi_sample_block.launches == before + 1
    assert block.psi_sample_block.body == block.psi_sample_body(D)
    _close(got, block.psi_sample_block_plain(**inputs, precision=precision),
           TOL[precision])


@pytest.mark.parametrize("D", [8, 64])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_sampler_row_body_at_quad_shapes(dev, D, precision):
    """The row body, forced at a D the rule gives the quad body, matches the
    plain version too; the quad body, forced past D=64, raises ValueError
    before any launch."""
    inputs = _psi_sample_inputs(dev, D, 5, STEPS[precision])
    row = block.psi_sample_block(**inputs, precision=precision, _body="row")
    torch.cuda.synchronize()
    assert block.psi_sample_block.body == "row"
    _close(row, block.psi_sample_block_plain(**inputs, precision=precision),
           TOL[precision])
    wide = _psi_sample_inputs(dev, 72, 2, 4)
    before = block.psi_sample_block.launches
    with pytest.raises(ValueError, match="quad"):
        block.psi_sample_block(**wide, _body="quad")
    assert block.psi_sample_block.launches == before


def test_sampler_fits_agree_with_the_kernels(dev):
    """scan.psi_sampler_fits is true where the block sampler launches (every
    D % 8 == 0 to 256: the one-CTA bodies to 80, the cluster body past it)
    and false at D=264, where the wrapper raises NotImplementedError before
    any launch; the one-CTA bodies' byte counts and the body rule are the
    kernel's own."""
    from audio_mps_tpu_torch.ops import _build, scan
    lib = _build.library()
    for D in range(8, 97, 8):
        assert lib.amt_psi_sample_smem_bytes(D) == \
            block.psi_sample_smem_bytes(D)
        assert bool(lib.amt_psi_sample_quad(D)) == (
            block.psi_sample_body(D) == "quad")
    for D in (72, 80, 88, 256, 264):
        fits = scan.psi_sampler_fits(CMPSConfig(bond_dim=D), dev)
        assert fits == (D <= 256)
        inputs = _psi_sample_inputs(dev, D, 2, 20)
        from audio_mps_tpu_torch.ops.cluster import psi_sample_cluster
        before = (block.psi_sample_block.launches,
                  psi_sample_cluster.launches)
        if fits:
            assert torch.isfinite(block.psi_sample_block(**inputs)).all()
            assert (block.psi_sample_block.launches
                    + psi_sample_cluster.launches) == sum(before) + 1
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
                block.psi_sample_block(**inputs)
            assert (block.psi_sample_block.launches,
                    psi_sample_cluster.launches) == before


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


@pytest.mark.parametrize("case", ["D260"])
def test_train_path_raises_without_a_kernel(dev, case):
    """D=260 (past the cluster layout of psi's block kernels, D <= 256)
    raises NotImplementedError on the card before any launch. D=72 to 256
    run: test_cluster_train_path_at_d128."""
    from audio_mps_tpu_torch.training import nll_fn_for
    D = 260
    cfg = CMPSConfig(bond_dim=D)
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


# ---------------------------------------------------------------------------
# rank-partials kernels (csrc/rank_partials_*.cu): one CTA a segment of rc
# columns (an example's chunk of rank rows), constants streamed from L2
# ---------------------------------------------------------------------------

# (D, rank, rc): partial warps (D=8), chunks that are not a multiple of 4
# (3, 17), a D past the monolithic kernels (68, 128, 256) and the D=256
# model's chunk (16 of 256)
RANK_SHAPES = [(8, 6, 3), (8, 8, 8), (64, 64, 8), (68, 68, 17), (128, 128, 16),
               (256, 256, 16), (256, 32, 4)]


def _rank_counts():
    from audio_mps_tpu_torch.ops import rank
    return (rank.rank_partials_fwd.launches, rank.rank_partials_bwd.launches,
            rank.rank_cotangents.launches)


def _rank_inputs(dev, D, rank_, rc, steps, B=2, seed=2):
    from audio_mps_tpu_torch.ops import rank
    p, cfg = _rho_params(dev, D, rank_)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(seed), B,
                            steps + 1, cfg.delta_t)
    inputs, _ = rank.partials_inputs(p, cfg, sig, rc)
    gen = torch.Generator(dev).manual_seed(5)
    S = B * rank_ // rc
    cot = dict(deh=torch.randn(steps, S, generator=gen, device=dev),
               dtr=torch.randn(steps, S, generator=gen, device=dev),
               dtfin=0.1 * torch.randn(inputs["t0"].shape, generator=gen,
                                       device=dev))
    return inputs, cot


@pytest.mark.parametrize("D, rank_, rc", RANK_SHAPES)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_rank_partials_kernels_match_plain(dev, D, rank_, rc, precision):
    """The partials forward, adjoint (tail and chain) and cotangents each
    against its plain version on the same inputs: the adjoint on the plain
    forward's streams, the cotangents on the plain adjoint's."""
    from audio_mps_tpu_torch.ops import rank
    steps = STEPS[precision] // (3 if D >= 128 else 1)
    inputs, cot = _rank_inputs(dev, D, rank_, rc, steps)
    kw = dict(precision=precision, unroll=7)
    before = _rank_counts()
    fwd = rank.rank_partials_fwd_plain(**inputs, **kw)
    for a, b in zip(rank.rank_partials_fwd(**inputs, **kw), fwd):
        _close(a, b, TOL[precision])
    eh, tr, tfin, ys = fwd
    bwd = rank.rank_partials_bwd_plain(**inputs, ys=ys, tr=tr, **cot, **kw)
    for a, b in zip(rank.rank_partials_bwd(**inputs, ys=ys, tr=tr, **cot,
                                           **kw), bwd):
        _close(a, b, TOL[precision])
    cot_in = dict(dy=bwd[2], ys=ys, t0=inputs["t0"], se=inputs["se"], tr=tr,
                  deh=cot["deh"], rc=rc, norm_eps=inputs["norm_eps"])
    got = rank.rank_cotangents(**cot_in, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, rank.rank_cotangents_plain(**cot_in, **kw)):
        _close(a, b, TOL[precision])
    assert _rank_counts() == tuple(c + 1 for c in before)


def test_rank_partials_smem_and_dispatch_agree_with_the_kernels(dev):
    """The Python rule's shared-memory counts are the kernels' own, and on
    this card D=64 at rank 64 stays monolithic while D=68 goes chunked."""
    from audio_mps_tpu_torch.ops import _build, rank
    lib = _build.library()
    for D, rc in ((8, 3), (64, 8), (256, 16), (512, 8)):
        assert lib.amt_rank_partials_smem_bytes(D, rc) == \
            rank.partials_smem_bytes(D, rc)
    assert lib.amt_rho_train_fwd_smem_bytes(64, 64) == \
        block.rho_train_smem_bytes(64, 64)
    limits = rank.device_limits(dev)
    assert rank.rho_train_chunk(64, 8, 64, *limits) is None
    assert rank.rho_train_chunk(68, 8, 68, *limits) is not None


def test_rank_partials_segments_chain_through_tfin(dev):
    """Two time segments chained through tfin (forward) and dtfin (adjoint)
    equal one launch over both, bit for bit; the cotangents of the two add
    up to the one launch's."""
    from audio_mps_tpu_torch.ops import rank
    steps, L1 = 70, 28                      # segments of 4 and 6 blocks
    inputs, cot = _rank_inputs(dev, 64, 64, 16, steps)
    kw = dict(rc=16, unroll=7, norm_eps=inputs.pop("norm_eps"))
    inputs.pop("rc")
    eh, tr, tfin, ys = rank.rank_partials_fwd(**inputs, **kw)
    first = dict(inputs, se=inputs["se"][:L1].contiguous())
    e1, r1, t1, y1 = rank.rank_partials_fwd(**first, **kw)
    second = dict(inputs, t0=t1, se=inputs["se"][L1:].contiguous())
    e2, r2, t2, y2 = rank.rank_partials_fwd(**second, **kw)
    for whole, parts in ((eh, (e1, e2)), (tr, (r1, r2)), (ys, (y1, y2))):
        assert torch.equal(whole, torch.cat(parts))
    assert torch.equal(tfin, t2)

    def part(x, k0, k1):
        return x[k0:k1].contiguous()

    zero = torch.zeros_like(cot["dtfin"])
    dse, dt0, dy = rank.rank_partials_bwd(**inputs, ys=ys, tr=tr,
                                          deh=cot["deh"], dtr=cot["dtr"],
                                          dtfin=zero, **kw)
    b2 = rank.rank_partials_bwd(**second, ys=y2, tr=r2,
                                deh=part(cot["deh"], L1, steps),
                                dtr=part(cot["dtr"], L1, steps), dtfin=zero,
                                **kw)
    b1 = rank.rank_partials_bwd(**first, ys=y1, tr=r1,
                                deh=part(cot["deh"], 0, L1),
                                dtr=part(cot["dtr"], 0, L1), dtfin=b2[1],
                                **kw)
    assert torch.equal(dse, torch.cat([b1[0], b2[0]]))
    assert torch.equal(dt0, b1[1])
    assert torch.equal(dy, torch.cat([b1[2], b2[2]]))
    whole = rank.rank_cotangents(dy, ys, inputs["t0"], inputs["se"], tr,
                                 cot["deh"], **kw)
    c1 = rank.rank_cotangents(b1[2], y1, first["t0"], first["se"], r1,
                              part(cot["deh"], 0, L1), **kw)
    c2 = rank.rank_cotangents(b2[2], y2, second["t0"], second["se"], r2,
                              part(cot["deh"], L1, steps), **kw)
    for w, a, b in zip(whole, c1, c2):
        _close(a + b, w, 1e-5)


def test_rank_partials_index_past_2_pow_31_elements(dev):
    """A [n_steps, 2D, cols] stream of more than 2^31 elements (8 GiB in
    fp32): the last segment of the forward and of the adjoint over all
    segments equals, bit for bit, a launch over that segment alone."""
    from audio_mps_tpu_torch.ops import rank
    D, B, rank_, rc, steps = 8, 128, 128, 16, 8193
    assert steps * 2 * D * B * rank_ > 2 ** 31
    p, cfg = _rho_params(dev, D, rank_)
    inputs, _ = rank.partials_inputs(p, cfg, torch.zeros(B, 2, device=dev),
                                     rc)
    inputs["se"] = torch.randn(steps, B, device=dev,
                               generator=torch.Generator(dev).manual_seed(3)
                               ).mul_(0.01)
    kw = dict(rc=inputs.pop("rc"), unroll=16,
              norm_eps=inputs.pop("norm_eps"))
    S = B * rank_ // rc
    gen = torch.Generator(dev).manual_seed(4)
    deh = torch.randn(steps, S, generator=gen, device=dev)
    dtr = torch.randn(steps, S, generator=gen, device=dev)

    def last(x, lanes=rc):
        return x[..., -lanes:].contiguous()

    alone = dict(inputs, t0=last(inputs["t0"]), se=last(inputs["se"], 1))
    eh, tr, tfin, ys = rank.rank_partials_fwd(**inputs, **kw)
    a_eh, a_tr, a_tfin, a_ys = rank.rank_partials_fwd(**alone, **kw)
    for a, b, lanes in zip((eh, tr, tfin, ys), (a_eh, a_tr, a_tfin, a_ys),
                           (1, 1, rc, rc)):
        assert torch.equal(last(a, lanes), b)
    del a_ys
    bwd = rank.rank_partials_bwd(**inputs, ys=ys, tr=tr, deh=deh, dtr=dtr,
                                 dtfin=torch.zeros_like(tfin), **kw)
    got = [last(x, lanes).clone() for x, lanes in zip(bwd, (1, rc, rc))]
    del bwd
    a_eh, a_tr, a_tfin, a_ys = rank.rank_partials_fwd(**alone, **kw)
    del ys
    want = rank.rank_partials_bwd(**alone, ys=a_ys, tr=a_tr, deh=last(deh, 1),
                                  dtr=last(dtr, 1),
                                  dtfin=torch.zeros_like(a_tfin), **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.isfinite(b).all() and torch.equal(a, b)


def _rank_all(rank, inputs, cot, kw, **o):
    """Every partials kernel once on the same inputs: the streamed forward,
    the checkpoint forward, the segment recompute from its checkpoints and
    the adjoint on the streamed forward's states."""
    fwd = rank.rank_partials_fwd(**inputs, **kw, **o)
    ckpt = rank.rank_partials_fwd_ckpt(**inputs, **kw, **o)
    rec = rank.rank_partials_recompute(inputs["ab"], inputs["bb"],
                                       inputs["xb"], ckpt[3], inputs["se"],
                                       **kw, **o)
    bwd = rank.rank_partials_bwd(**inputs, ys=fwd[3], tr=fwd[1], **cot,
                                 **kw, **o)
    torch.cuda.synchronize()
    return (*fwd, *ckpt, rec, *bwd)


@pytest.mark.parametrize("D, rank_, rc", [(64, 64, 8), (256, 256, 16)])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_rank_partials_every_cluster_gives_the_same_bits(dev, D, rank_, rc,
                                                         precision):
    """The forward (streamed, checkpoint and recompute modes) and the
    adjoint at every cluster size G admits (1, 2, 4, 8 and 16 of an
    example's G chunks) equal one another bit for bit: the multicast slabs
    are the same bits, and a CTA's arithmetic does not depend on who
    copied them."""
    from audio_mps_tpu_torch.ops import rank
    inputs, cot = _rank_inputs(dev, D, rank_, rc, 40)
    kw = dict(rc=inputs.pop("rc"), norm_eps=inputs.pop("norm_eps"),
              unroll=7, precision=precision)
    G = rank_ // rc
    want = _rank_all(rank, inputs, cot, kw, cluster=1)
    sizes = [c for c in (2, 4, 8, 16) if G % c == 0]
    assert sizes[-1] == G
    for c in sizes:
        got = _rank_all(rank, inputs, cot, kw, cluster=c)
        for a, b in zip(got, want):
            assert torch.isfinite(b).all() and torch.equal(a, b), c


def test_rank_partials_two_launches_are_the_same_bits(dev):
    """Each partials kernel launched twice on the same inputs, at the
    cluster the card's rule takes, gives the same bits (no atomics, fixed
    orders)."""
    from audio_mps_tpu_torch.ops import rank
    inputs, cot = _rank_inputs(dev, 256, 256, 16, 40)
    kw = dict(rc=inputs.pop("rc"), norm_eps=inputs.pop("norm_eps"),
              unroll=7)
    for a, b in zip(_rank_all(rank, inputs, cot, kw),
                    _rank_all(rank, inputs, cot, kw)):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("D, rank_, rc, B, cluster", [
    (68, 68, 17, 2, 8), (64, 16, 16, 3, 2), (256, 48, 16, 1, 2)])
def test_rank_partials_clusters_follow_g(dev, D, rank_, rc, B, cluster):
    """A G the preferred clusters do not divide (68 / 17 = 4 chunks, one
    chunk, three) runs at the largest cluster that divides it and matches
    the plain versions; asking for a cluster that does not divide G
    raises."""
    from audio_mps_tpu_torch.ops import rank
    inputs, cot = _rank_inputs(dev, D, rank_, rc, 40, B=B)
    kw = dict(rc=inputs.pop("rc"), norm_eps=inputs.pop("norm_eps"),
              unroll=7)
    G = rank_ // rc
    S = B * G
    chosen = rank.launch_cluster(D, rc, G, S, dev)
    assert G % chosen == 0 and chosen <= G
    fwd = rank.rank_partials_fwd_plain(**inputs, **kw)
    for a, b in zip(rank.rank_partials_fwd(**inputs, **kw), fwd):
        _close(a, b, TOL["highest"])
    bwd = rank.rank_partials_bwd_plain(**inputs, ys=fwd[3], tr=fwd[1],
                                       **cot, **kw)
    for a, b in zip(rank.rank_partials_bwd(**inputs, ys=fwd[3], tr=fwd[1],
                                           **cot, **kw), bwd):
        _close(a, b, TOL["highest"])
    with pytest.raises(ValueError, match="divide"):
        rank.rank_partials_fwd(**inputs, **kw, cluster=cluster)


def test_rho_train_path_runs_chunked_past_d64(dev):
    """rho training at D=68 (past the monolithic kernels) goes through the
    partials kernels once each, no monolithic rho training kernel, and
    matches the same call on CPU copies; kernel_stream="off" runs the
    checkpoint forward once and the segment recompute, adjoint and
    reductions once a segment (16 of one block), and matches the same call
    on CPU copies."""
    import dataclasses
    from audio_mps_tpu_torch.ops import grad
    from audio_mps_tpu_torch.weights import (params_to_numpy,
                                             rho_params_from_numpy)
    p, cfg = _rho_params(dev, 68, 68)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), 2, 257,
                            cfg.delta_t)
    before, mono = _rank_counts(), _rho_counts()
    loss = grad.rho_nll_fused_trainable(p, cfg, sig)
    loss.backward()
    torch.cuda.synchronize()
    assert _rank_counts() == tuple(c + 1 for c in before)
    assert _rho_counts() == mono
    q = rho_params_from_numpy(params_to_numpy(p), "cpu")
    want = grad.rho_nll_fused_trainable(q, cfg, sig.cpu())
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        _close(getattr(p, name).grad.cpu(), getattr(q, name).grad, 1e-3)
    off = dataclasses.replace(cfg, kernel_stream="off")
    for x in list(p.parameters()) + list(q.parameters()):
        x.grad = None
    before, rec = _rank_counts(), _recompute_counts()
    loss = grad.rho_nll_fused_trainable(p, off, sig)
    loss.backward()
    torch.cuda.synchronize()
    assert _rank_counts() == (before[0], before[1] + 16, before[2] + 16)
    assert _recompute_counts()[4:] == (rec[4] + 1, rec[5] + 16)
    want = grad.rho_nll_fused_trainable(q, off, sig.cpu())
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        _close(getattr(p, name).grad.cpu(), getattr(q, name).grad, 1e-3)


def test_rho_train_cli_refuses_the_sampler_past_d64(dev, tmp_path,
                                                    monkeypatch):
    """With summaries that draw samples, the train CLI at rho D=68 (trained
    rank-chunked, but the rho sampler kernel takes D <= 64) raises before
    its first step, naming the remedy, and launches nothing."""
    from audio_mps_tpu_torch import summaries
    from audio_mps_tpu_torch.train import parse_args, train

    class Writer:
        def close(self):
            pass

    monkeypatch.setattr(summaries, "make_writer", lambda logdir: Writer())
    run, device = parse_args([
        "--mps_model=rho_mps", "--dataset=damped_sine",
        "--sample_duration=65", "--hparams=bond_dim=68,minibatch_size=2",
        f"--logdir={tmp_path}", "--max_steps=1"])
    before = _rank_counts()
    with pytest.raises(NotImplementedError, match="--visualize=false"):
        train(run, device=device)
    assert _rank_counts() == before


# ---------------------------------------------------------------------------
# the recompute path (kernel_stream="off"): the checkpoint forwards (kCkpt
# mode of the forward templates), the segment recomputes (csrc/*_recompute.cu)
# and the streamed adjoints run a segment at a time with dt carried in
# ---------------------------------------------------------------------------

def _recompute_counts():
    from audio_mps_tpu_torch.ops import rank
    return (block.psi_train_fwd_ckpt.launches, block.psi_recompute.launches,
            block.rho_train_fwd_ckpt.launches, block.rho_recompute.launches,
            rank.rank_partials_fwd_ckpt.launches,
            rank.rank_partials_recompute.launches)


# unroll 7 over the steps, segments of 3 blocks: the last block and the
# last segment are short
UNROLL, SEGMENT = 7, 21


def _psi_family(dev, D, steps):
    inputs, g = _train_inputs(dev, D, steps)
    con = dict(ab=inputs["ab"], bb=inputs["bb"], rb=inputs["rb"])
    return inputs, g, con, (block.psi_train_fwd, block.psi_train_fwd_ckpt,
                            block.psi_recompute, block.psi_recompute_bwd,
                            block.psi_train_bwd, block.psi_cotangents)


def _rho_family(dev, D, rank_, steps):
    p, cfg = _rho_params(dev, D, rank_)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(2), 3,
                            steps + 1, cfg.delta_t)
    inputs = block.rho_nll_inputs(p, cfg, sig)
    g = torch.rand(3, generator=torch.Generator(dev).manual_seed(5),
                   device=dev) + 0.5
    con = dict(ab=inputs["ab"], bb=inputs["bb"], xb=inputs["xb"])
    return inputs, g, con, (block.rho_train_fwd, block.rho_train_fwd_ckpt,
                            block.rho_recompute, block.rho_recompute_bwd,
                            block.rho_train_bwd, block.rho_cotangents)


def _family(dev, family, D, rank_, steps):
    return (_psi_family(dev, D, steps) if family == "psi"
            else _rho_family(dev, D, rank_, steps))


def _plain(fn):
    return getattr(block, fn.__name__ + "_plain")


@pytest.mark.parametrize("family, D, rank_", [
    ("psi", 8, 1), ("psi", 12, 1), ("psi", 64, 1), ("rho", 8, 3),
    ("rho", 16, 64), ("rho", 64, 64)])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_recompute_kernels_match_plain(dev, family, D, rank_, precision,
                                       defer):
    """The checkpoint forward (loss, ck), the segment recompute on the plain
    checkpoints (ys and the norms) and the whole recompute adjoint on the
    plain checkpoints (dse, dt0 and the three cotangents: the recompute,
    the adjoint with dt carried in and the reductions, a segment at a time)
    each against its plain version on the same inputs."""
    inputs, g, con, fns = _family(dev, family, D, rank_, STEPS[precision])
    _, ckpt, recompute, recompute_bwd, _, _ = fns
    kw = dict(norm_eps=inputs.pop("norm_eps"), precision=precision,
              defer_norm=defer, unroll=UNROLL)
    log_eps = inputs.pop("log_eps")
    before = _recompute_counts()
    want = _plain(ckpt)(**inputs, log_eps=log_eps, **kw)
    for a, b in zip(ckpt(**inputs, log_eps=log_eps, **kw), want):
        _close(a, b, TOL[precision])
    rec = dict(con, ck=want[1], se=inputs["se"])
    for a, b in zip(recompute(**rec, **kw), _plain(recompute)(**rec, **kw)):
        _close(a, b, TOL[precision])
    got = recompute_bwd(**rec, g=g, log_eps=log_eps, segment=SEGMENT, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, _plain(recompute_bwd)(**rec, g=g, log_eps=log_eps,
                                               segment=SEGMENT, **kw)):
        _close(a, b, TOL[precision])
    n_seg = len(block.recompute_segments(STEPS[precision], UNROLL, SEGMENT))
    moved = [a - b for a, b in zip(_recompute_counts(), before)]
    assert moved[:4] == ([1, 1 + n_seg, 0, 0] if family == "psi"
                         else [0, 0, 1, 1 + n_seg])


@pytest.mark.parametrize("family, D, rank_", [("psi", 64, 1),
                                               ("rho", 64, 64)])
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("defer", [False, True])
def test_recompute_is_the_stream_bit_for_bit(dev, family, D, rank_,
                                             precision, defer):
    """On the card: the checkpoint forward's loss is the streamed forward's
    bit for bit; the states the recompute rebuilds from the checkpoints, in
    one launch over the run and a segment at a time, are the streamed
    forward's ys and norms bit for bit; the recompute adjoint's dse and dt0
    are the streamed adjoint's bit for bit (only dt crosses a segment
    boundary) and its cotangents within 1e-5 of their largest element (the
    reductions' sums split otherwise); two runs of it are equal bit for
    bit."""
    inputs, g, con, fns = _family(dev, family, D, rank_, 300)
    stream, ckpt, recompute, recompute_bwd, adjoint, cotangents = fns
    norm_eps, log_eps = inputs.pop("norm_eps"), inputs.pop("log_eps")
    kw = dict(norm_eps=norm_eps, precision=precision, defer_norm=defer,
              unroll=UNROLL)
    loss, ys, norms = stream(**inputs, log_eps=log_eps, **kw)
    loss_c, ck = ckpt(**inputs, log_eps=log_eps, **kw)
    assert torch.equal(loss, loss_c)
    se = inputs["se"]
    for a, b in zip(recompute(**con, ck=ck, se=se, **kw), (ys, norms)):
        assert torch.equal(a, b)
    for k0, k1 in block.recompute_segments(se.shape[0], UNROLL, SEGMENT):
        seg = recompute(**con, ck=ck[k0 // UNROLL:-(-k1 // UNROLL)],
                        se=se[k0:k1], **kw)
        for a, b in zip(seg, (ys[k0:k1], norms[k0:k1])):
            assert torch.equal(a, b)
    aux = "n2s" if family == "psi" else "trs"
    dse, dt0, dy, dehat = adjoint(**inputs, g=g, ys=ys, **{aux: norms},
                                  log_eps=log_eps, **kw)
    cot = cotangents(dy, ys, inputs["t0"], se, norms, dehat, **kw)
    runs = [recompute_bwd(**con, ck=ck, se=se, g=g, log_eps=log_eps,
                          segment=SEGMENT, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][0], dse) and torch.equal(runs[0][1], dt0)
    for a, b in zip(runs[0][2:], cot):
        _close(a, b, 1e-5)


def test_psi_recompute_spans_are_the_stream_bit_for_bit(dev):
    """At B=264 a psi recompute CTA re-runs a span of several blocks
    (psi_recompute_blocks on the H100's 132 SMs: 21 of the 43 blocks of 300
    steps at unroll 7, so the last span is one block): the states are still
    the streamed forward's bit for bit; and every block of a span restarts
    from its own checkpoint, as the plain recompute's do: from checkpoints
    that are not the forward's (every other block's halved) the kernel
    matches the plain version within 1e-5 of its largest element."""
    inputs, _ = _train_inputs(dev, 8, 300, B=264)
    kw = dict(norm_eps=inputs.pop("norm_eps"), unroll=UNROLL,
              defer_norm=True)
    log_eps = inputs.pop("log_eps")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert block.psi_recompute_blocks(264, 43, sms) > 1
    _, ys, n2s = block.psi_train_fwd(**inputs, log_eps=log_eps, **kw)
    _, ck = block.psi_train_fwd_ckpt(**inputs, log_eps=log_eps, **kw)
    got = block.psi_recompute(inputs["ab"], inputs["bb"], inputs["rb"], ck,
                              inputs["se"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ys) and torch.equal(got[1], n2s)
    ck[1::2] *= 0.5
    con = (inputs["ab"], inputs["bb"], inputs["rb"], ck, inputs["se"])
    for a, b in zip(block.psi_recompute(*con, **kw),
                    block.psi_recompute_plain(*con, **kw)):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("D, rank_, rc", [(8, 6, 3), (68, 68, 17),
                                          (256, 32, 4)])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_rank_recompute_kernels_match_plain_and_the_stream(dev, D, rank_, rc,
                                                           precision):
    """The partials checkpoint forward (eh, tr, tfin, ck) and the segment
    recompute against their plain versions; the recomputed states, in one
    launch and a segment at a time, equal the streamed forward's bit for
    bit; the recompute adjoint against its plain version, its dse and dt0
    equal to the streamed adjoint's bit for bit and its cotangents within
    1e-5; two runs equal bit for bit."""
    from audio_mps_tpu_torch.ops import rank
    steps = 120
    inputs, cot = _rank_inputs(dev, D, rank_, rc, steps)
    kw = dict(rc=inputs.pop("rc"), norm_eps=inputs.pop("norm_eps"),
              precision=precision, unroll=UNROLL)
    con = dict(ab=inputs["ab"], bb=inputs["bb"], xb=inputs["xb"])
    se = inputs["se"]
    want = rank.rank_partials_fwd_ckpt_plain(**inputs, **kw)
    got = rank.rank_partials_fwd_ckpt(**inputs, **kw)
    for a, b in zip(got, want):
        _close(a, b, TOL[precision])
    eh, tr, tfin, ys = rank.rank_partials_fwd(**inputs, **kw)
    ck = got[3]
    assert torch.equal(got[1], tr) and torch.equal(got[2], tfin)
    _close(rank.rank_partials_recompute(**con, ck=want[3], se=se, **kw),
           rank.rank_partials_recompute_plain(**con, ck=want[3], se=se, **kw),
           TOL[precision])
    assert torch.equal(rank.rank_partials_recompute(**con, ck=ck, se=se,
                                                    **kw), ys)
    for k0, k1 in block.recompute_segments(steps, UNROLL, SEGMENT):
        assert torch.equal(rank.rank_partials_recompute(
            **con, ck=ck[k0 // UNROLL:-(-k1 // UNROLL)], se=se[k0:k1], **kw),
            ys[k0:k1])
    dse, dt0, dy = rank.rank_partials_bwd(**inputs, ys=ys, tr=tr, **cot,
                                          **kw)
    streamed = rank.rank_cotangents(dy, ys, inputs["t0"], se, tr, cot["deh"],
                                    **kw)
    args = dict(con, ck=ck, se=se, tr=tr, **cot)
    runs = [rank.rank_recompute_bwd(**args, segment=SEGMENT, **kw)
            for _ in range(2)]
    plain = rank.rank_recompute_bwd_plain(**dict(args, ck=want[3]),
                                          segment=SEGMENT, **kw)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], plain):
        _close(a, b, TOL[precision])
    assert torch.equal(runs[0][0], dse) and torch.equal(runs[0][1], dt0)
    for a, b in zip(runs[0][2:], streamed):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("family", ["psi", "rho", "rank"])
def test_train_path_runs_without_the_stream(dev, family):
    """kernel_stream="off" on the card (it raised NotImplementedError before
    the recompute adjoints were ported): one value-and-gradient at D=64
    (rho: rank 64; the rank partials: D=68) over 256 steps launches the
    checkpoint forward once and the segment recompute, the adjoint and the
    reductions once a segment (16 segments of one block), never the
    streamed forward; its loss equals the streamed path's bit for bit, its
    six gradients that path's within 1e-5 of their largest element, and
    both match the same call on CPU copies."""
    import dataclasses

    from audio_mps_tpu_torch.ops import grad, rank
    from audio_mps_tpu_torch.weights import (params_to_numpy,
                                             psi_params_from_numpy,
                                             rho_params_from_numpy)
    if family == "psi":
        cfg = CMPSConfig(bond_dim=64, minibatch_size=4)
        p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
        nll, from_np = grad.psi_nll_fused_trainable, psi_params_from_numpy
        wrappers = (block.psi_train_fwd, block.psi_train_fwd_ckpt,
                    block.psi_recompute, block.psi_train_bwd,
                    block.psi_cotangents)
    else:
        p, cfg = _rho_params(dev, 64 if family == "rho" else 68,
                             64 if family == "rho" else 68)
        nll, from_np = grad.rho_nll_fused_trainable, rho_params_from_numpy
        wrappers = ((block.rho_train_fwd, block.rho_train_fwd_ckpt,
                     block.rho_recompute, block.rho_train_bwd,
                     block.rho_cotangents) if family == "rho" else
                    (rank.rank_partials_fwd, rank.rank_partials_fwd_ckpt,
                     rank.rank_partials_recompute, rank.rank_partials_bwd,
                     rank.rank_cotangents))
    off = dataclasses.replace(cfg, kernel_stream="off")
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), 2, 257,
                            cfg.delta_t)
    results = []
    for c in (cfg, off):
        q = from_np(params_to_numpy(p), dev)
        before = [w.launches for w in wrappers]
        loss = nll(q, c, sig, defer_norm=True)
        loss.backward()
        torch.cuda.synchronize()
        results.append((loss, q, [w.launches - b
                                  for w, b in zip(wrappers, before)]))
    assert results[1][2] == [0, 1, 16, 16, 16]
    assert torch.equal(results[0][0], results[1][0])
    for name in p.NAMES:
        _close(getattr(results[1][1], name).grad,
               getattr(results[0][1], name).grad, 1e-5)
    q = from_np(params_to_numpy(p), "cpu")
    want = nll(q, off, sig.cpu(), defer_norm=True)
    want.backward()
    loss, p_off, _ = results[1]
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        _close(getattr(p_off, name).grad.cpu(), getattr(q, name).grad, 1e-3)


# ---------------------------------------------------------------------------
# The split layout (ops/split.py, csrc/psi_split_*.cu)
# ---------------------------------------------------------------------------

SPLIT_SHAPES = [(6, "auto"), (10, "auto"), (8, "split")]


def _split_counts():
    from audio_mps_tpu_torch.ops import split
    return (split.psi_sample_split.launches, split.psi_nll_split.launches,
            split.psi_split_fwd.launches, split.psi_split_bwd.launches)


def _split_inputs(dev, D, layout, steps, B=5):
    from audio_mps_tpu_torch.ops import split
    cfg = CMPSConfig(bond_dim=D, kernel_layout=layout)
    p = init_psi(torch.Generator(dev).manual_seed(D), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(2), B,
                            steps + 1, cfg.delta_t)
    inputs = split.psi_split_inputs(p, cfg, sig)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(1), 3,
                               steps, 1.0)
    g = torch.rand(B, generator=torch.Generator(dev).manual_seed(5),
                   device=dev) + 0.5
    return (split.psi_split_inputs(p, cfg, noise, noise=True), inputs, g)


@pytest.mark.parametrize("D, layout", SPLIT_SHAPES)
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_split_kernels_match_plain(dev, D, layout, precision, defer):
    """Each split kernel against its plain version on the same inputs (the
    adjoint fed the plain forward's checkpoints; unroll 7, so the last
    block is ragged): D=6 and D=10 (the layouts' rule sends them to split)
    and D=8 asked for with kernel_layout="split", each launching once; then
    the adjoint forced to each form (``_form``), over the run and over 5
    steps (fewer than one block)."""
    from audio_mps_tpu_torch.ops import split
    s_in, inputs, g = _split_inputs(dev, D, layout, STEPS[precision])
    names = ("cr", "ci", "rr", "ri", "pc", "ps", "s0r", "s0i", "se")
    args = [inputs[k] for k in names]
    kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
              unroll=7, precision=precision, defer_norm=defer)
    before = _split_counts()
    got = split.psi_sample_split(**s_in, precision=precision)
    _close(got, split.psi_sample_split_plain(**s_in, precision=precision),
           TOL[precision])
    _close(split.psi_nll_split(*args, **kw),
           split.psi_nll_split_plain(*args, **kw), TOL[precision])
    fwd = split.psi_split_fwd_plain(*args, **kw)
    for a, b in zip(split.psi_split_fwd(*args, **kw), fwd):
        _close(a, b, TOL[precision])
    bwd_args = args[:6] + [args[8], g, fwd[1], fwd[2]]
    got = split.psi_split_bwd(*bwd_args, **kw)
    torch.cuda.synchronize()
    want = split.psi_split_bwd_plain(*bwd_args, **kw)
    for a, b in zip(got, want):
        _close(a, b, TOL[precision])
    assert _split_counts() == tuple(c + 1 for c in before)
    se5 = args[8][:5].contiguous()
    fwd5 = split.psi_split_fwd_plain(*args[:8], se5, **kw)
    short = args[:6] + [se5, g, fwd5[1], fwd5[2]]
    want5 = split.psi_split_bwd_plain(*short, **kw)
    for form in split.SPLIT_BWD_FORMS:
        for call, ref in ((bwd_args, want), (short, want5)):
            got = split.psi_split_bwd(*call, **kw, _form=form)
            torch.cuda.synchronize()
            assert split.psi_split_bwd.form == form
            for a, b in zip(got, ref):
                _close(a, b, TOL[precision])
    n = 2 * len(split.SPLIT_BWD_FORMS)
    assert _split_counts() == tuple(c + 1 for c in before[:3]) + (
        before[3] + 1 + n,)


# psi's split sampler (csrc/psi_split_sample.cu): one warp a chain, no CTA
# barrier (D=6, 10, 32), and a CTA of 2, 2, 4 warps (D=33, 64, the ceiling
# 119 of the forwards)
SPLIT_SAMPLE_DS = [6, 10, 32, 33, 64, 119]


@pytest.mark.parametrize("D", SPLIT_SAMPLE_DS)
@pytest.mark.parametrize("N", [1, 8, 133])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_split_sampler_forms_match_plain(dev, D, N, precision):
    """The split sampler in its one-warp and multi-warp forms against its
    plain version (the carried order): highest over 300 steps at TOL,
    default over 16; one launch each."""
    from audio_mps_tpu_torch.ops import split
    cfg = CMPSConfig(bond_dim=D, kernel_layout="split")
    p = init_psi(torch.Generator(dev).manual_seed(D), cfg, device=dev)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(1), N,
                               STEPS[precision], 1.0)
    s_in = split.psi_split_inputs(p, cfg, noise, noise=True)
    before = split.psi_sample_split.launches
    got = split.psi_sample_split(**s_in, precision=precision)
    torch.cuda.synchronize()
    assert got.shape == (STEPS[precision], N)
    assert split.psi_sample_split.launches == before + 1
    _close(got, split.psi_sample_split_plain(**s_in, precision=precision),
           TOL[precision])


def test_split_sampler_smem_and_fits_agree_with_the_kernel(dev):
    """The sampler's shared memory is its Python mirror at every D it could
    take; scan.psi_sampler_fits in the split layout is true to D=120, where
    the sampler launches, and false at D=121, where it raises before any
    launch."""
    from audio_mps_tpu_torch.ops import _build, scan, split
    lib = _build.library()
    for D in range(1, 129):
        assert lib.amt_psi_split_sample_smem_bytes(D) == \
            split.psi_split_sample_smem_bytes(D)
    for D, fits in ((120, True), (121, False)):
        cfg = CMPSConfig(bond_dim=D, kernel_layout="split")
        assert scan.psi_sampler_fits(cfg, dev) is fits
        p = init_psi(torch.Generator(dev).manual_seed(D), cfg, device=dev)
        noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(1),
                                   2, 12, 1.0)
        s_in = split.psi_split_inputs(p, cfg, noise, noise=True)
        before = split.psi_sample_split.launches
        if fits:
            got = split.psi_sample_split(**s_in)
            torch.cuda.synchronize()
            _close(got, split.psi_sample_split_plain(**s_in),
                   TOL["highest"])
            assert split.psi_sample_split.launches == before + 1
        else:
            with pytest.raises(NotImplementedError):
                split.psi_sample_split(**s_in)
            assert split.psi_sample_split.launches == before


@pytest.mark.parametrize("defer", [False, True])
def test_split_adjoint_forms_give_the_same_bits(dev, defer):
    """The two forms of the adjoint (double: a re-run role and a sweep
    role on two slabs; single: one role in turn) run the same arithmetic
    in the same order: at D=10, B=32 over 2048 steps they give the same
    bits in all nine outputs."""
    from audio_mps_tpu_torch.ops import split
    _, inputs, g = _split_inputs(dev, 10, "auto", 2048, B=32)
    names = ("cr", "ci", "rr", "ri", "pc", "ps", "s0r", "s0i", "se")
    args = [inputs[k] for k in names]
    kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
              defer_norm=defer)
    _, ckr, cki = split.psi_split_fwd(*args, **kw)
    runs = [split.psi_split_bwd(*args[:6], args[8], g, ckr, cki, **kw,
                                _form=form)
            for form in split.SPLIT_BWD_FORMS]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_split_adjoint_plans_and_smem_agree_with_the_kernels(dev):
    """The adjoints' byte counts in ops/split.py (the plans' inputs) are the
    kernels' own (amt_*_split_bwd_form_smem_bytes) at every form and
    placement, and the ceilings' counts (amt_*_split_bwd_smem_bytes) are
    the single form's (rho's with its slab in the workspace); on this card
    the plans take the double form at the estimator's D=10 (rho's slabs in
    shared memory), and a launch records what it took."""
    from audio_mps_tpu_torch.ops import _build, split
    lib = _build.library()
    for D in (4, 8, 10, 33, 64, 73, 74):
        for u in (1, 7, 16):
            for form in split.SPLIT_BWD_FORMS:
                assert lib.amt_psi_split_bwd_form_smem_bytes(
                    D, u, int(form == "double")) == \
                    split.psi_split_bwd_smem_bytes(D, u, form)
            assert lib.amt_psi_split_bwd_smem_bytes(D, u) == \
                split.psi_split_bwd_smem_bytes(D, u, "single")
    for D, rank in ((6, 3), (10, 10), (12, 12), (33, 2), (53, 53), (54, 54)):
        for u in (1, 7, 16):
            for form in split.SPLIT_BWD_FORMS:
                for placement in split.SPLIT_BWD_PLACEMENTS:
                    assert lib.amt_rho_split_bwd_form_smem_bytes(
                        D, rank, u, int(form == "double"),
                        int(placement == "smem")) == \
                        split.rho_split_bwd_smem_bytes(D, rank, u, placement,
                                                       form)
            assert lib.amt_rho_split_bwd_smem_bytes(D, rank, u) == \
                split.rho_split_bwd_smem_bytes(D, rank, u, "ws", "single")
    have = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert split.psi_split_bwd_plan(10, 16, have) == "double"
    assert split.rho_split_bwd_plan(10, 10, 16, have) == ("smem", "double")
    _, inputs, g = _split_inputs(dev, 10, "auto", 64, B=4)
    names = ("cr", "ci", "rr", "ri", "pc", "ps", "s0r", "s0i", "se")
    args = [inputs[k] for k in names]
    kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"])
    _, ckr, cki = split.psi_split_fwd(*args, **kw)
    split.psi_split_bwd(*args[:6], args[8], g, ckr, cki, **kw)
    assert split.psi_split_bwd.form == "double"
    _, inputs, g, _ = _rho_split_inputs(dev, 10, 10, "auto", 64, B=4)
    args = [inputs[k] for k in split.RHO_SPLIT_NAMES + ("se",)]
    _, ckr, cki = split.rho_split_fwd(*args, **kw)
    split.rho_split_bwd(*args[:8], args[10], g, ckr, cki, **kw)
    assert split.rho_split_bwd.plan == ("smem", "double")


def test_split_adjoint_is_reproducible_bit_for_bit(dev):
    """The adjoint's per-column cotangent sums are added in a fixed order
    (no atomics): two runs at D=10, B=32 over 2048 steps are equal to the
    bit in all nine outputs."""
    from audio_mps_tpu_torch.ops import split
    _, inputs, g = _split_inputs(dev, 10, "auto", 2048, B=32)
    names = ("cr", "ci", "rr", "ri", "pc", "ps", "s0r", "s0i", "se")
    args = [inputs[k] for k in names]
    kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
              defer_norm=True)
    _, ckr, cki = split.psi_split_fwd(*args, **kw)
    runs = [split.psi_split_bwd(*args[:6], args[8], g, ckr, cki, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("defer", [False, True])
def test_split_train_path_runs_its_two_kernels(dev, defer):
    """One value-and-gradient of the training NLL at D=10 on the card
    launches the split forward and adjoint once each and no block
    training kernel, and matches the same call on CPU copies (the plain
    versions): the loss within 1e-4 relative, each gradient within 1e-3 of
    its largest element."""
    from audio_mps_tpu_torch.ops import grad
    from audio_mps_tpu_torch.weights import (psi_params_from_numpy,
                                             psi_params_to_numpy)
    cfg = CMPSConfig(bond_dim=10, minibatch_size=8)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), 8, 257,
                            cfg.delta_t)
    block_kernels = (block.psi_train_fwd, block.psi_train_fwd_ckpt,
                     block.psi_recompute, block.psi_train_bwd,
                     block.psi_cotangents)
    before, block_before = _split_counts(), [w.launches
                                             for w in block_kernels]
    loss = grad.psi_nll_fused_trainable(p, cfg, sig, defer_norm=defer)
    loss.backward()
    torch.cuda.synchronize()
    assert _split_counts() == (before[0], before[1], before[2] + 1,
                               before[3] + 1)
    assert [w.launches for w in block_kernels] == block_before
    q = psi_params_from_numpy(psi_params_to_numpy(p), "cpu")
    want = grad.psi_nll_fused_trainable(q, cfg, sig.cpu(), defer_norm=defer)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        _close(getattr(p, name).grad.cpu(), getattr(q, name).grad, 1e-3)


def test_train_cli_summaries_sample_through_the_split_kernel(dev, tmp_path,
                                                             monkeypatch):
    """The train CLI's summary samples at D=10 (no multiple of 8) go
    through the split sampler kernel on the card, not the eager loop; the
    step through the split training pair."""
    from audio_mps_tpu_torch import summaries
    from audio_mps_tpu_torch.ops import split
    from audio_mps_tpu_torch.train import parse_args, train

    class Writer:
        def close(self):
            pass

    drawn = []
    monkeypatch.setattr(summaries, "make_writer", lambda logdir: Writer())
    monkeypatch.setattr(summaries, "write_step_summaries",
                        lambda *a, samples=None, **k: drawn.append(samples))
    run, device = parse_args([
        "--mps_model=psi_mps", "--dataset=damped_sine",
        "--sample_duration=65", "--hparams=bond_dim=10,minibatch_size=2",
        f"--logdir={tmp_path}", "--max_steps=1", "--num_samples=2"])
    before = _split_counts()
    train(run, device=device, verbose=False)
    torch.cuda.synchronize()
    assert _split_counts() == (before[0] + 1, before[1], before[2] + 1,
                               before[3] + 1)
    assert drawn[0].shape == (2, 65) and torch.isfinite(drawn[0]).all()


# ---------------------------------------------------------------------------
# rho's split layout (ops/split.py, csrc/rho_split_*.cu)
# ---------------------------------------------------------------------------

# (D, rank, layout): D=6 at rank 3 and D=10 at full rank (the layouts' rule
# sends them to split), D=8 asked for with kernel_layout="split", and a
# segment of two warps and more (D=33, rank 2: 66 threads)
RHO_SPLIT_SHAPES = [(6, 3, "auto"), (10, 10, "auto"), (8, 3, "split"),
                    (33, 2, "auto")]


def _rho_split_counts():
    from audio_mps_tpu_torch.ops import split
    return (split.rho_sample_split.launches, split.rho_nll_split.launches,
            split.rho_split_fwd.launches, split.rho_split_bwd.launches)


def _rho_split_inputs(dev, D, rank, layout, steps, B=5):
    """(sampler inputs for 3 chains, NLL inputs for B examples, a
    non-uniform per-example g, the config)."""
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import split
    cfg = CMPSConfig(bond_dim=D, initial_rank=rank, kernel_layout=layout)
    p = init_rho(torch.Generator(dev).manual_seed(D + rank), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(2), B,
                            steps + 1, cfg.delta_t)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(1), 3,
                               steps, 1.0)
    g = torch.rand(B, generator=torch.Generator(dev).manual_seed(5),
                   device=dev) + 0.5
    return (split.rho_split_inputs(p, cfg, noise, noise=True),
            split.rho_split_inputs(p, cfg, sig), g, cfg)


@pytest.mark.parametrize("D, rank, layout", RHO_SPLIT_SHAPES)
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_rho_split_kernels_match_plain(dev, D, rank, layout, precision,
                                       defer):
    """Each rho split kernel against its plain version on the same inputs
    (the adjoint fed the plain forward's checkpoints; unroll 7, so the last
    block is ragged), each launching once: highest over 300 steps at TOL,
    default over 16; then the adjoint forced to each (placement, form)
    (``_plan``), over the run and over 5 steps (fewer than one block)."""
    from audio_mps_tpu_torch.ops import split
    s_in, inputs, g, _ = _rho_split_inputs(dev, D, rank, layout,
                                           STEPS[precision])
    args = [inputs[k] for k in split.RHO_SPLIT_NAMES + ("se",)]
    kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
              unroll=7, precision=precision, defer_norm=defer)
    before = _rho_split_counts()
    _close(split.rho_sample_split(**s_in, precision=precision),
           split.rho_sample_split_plain(**s_in, precision=precision),
           TOL[precision])
    _close(split.rho_nll_split(*args, **kw),
           split.rho_nll_split_plain(*args, **kw), TOL[precision])
    fwd = split.rho_split_fwd_plain(*args, **kw)
    for a, b in zip(split.rho_split_fwd(*args, **kw), fwd):
        _close(a, b, TOL[precision])
    bwd_args = args[:8] + [args[10], g, fwd[1], fwd[2]]
    got = split.rho_split_bwd(*bwd_args, **kw)
    torch.cuda.synchronize()
    want = split.rho_split_bwd_plain(*bwd_args, **kw)
    for a, b in zip(got, want):
        _close(a, b, TOL[precision])
    assert _rho_split_counts() == tuple(c + 1 for c in before)
    se5 = args[10][:5].contiguous()
    fwd5 = split.rho_split_fwd_plain(*args[:10], se5, **kw)
    short = args[:8] + [se5, g, fwd5[1], fwd5[2]]
    want5 = split.rho_split_bwd_plain(*short, **kw)
    plans = [(p, f) for f in split.SPLIT_BWD_FORMS
             for p in split.SPLIT_BWD_PLACEMENTS]
    for plan in plans:
        for call, ref in ((bwd_args, want), (short, want5)):
            got = split.rho_split_bwd(*call, **kw, _plan=plan)
            torch.cuda.synchronize()
            assert split.rho_split_bwd.plan == plan
            for a, b in zip(got, ref):
                _close(a, b, TOL[precision])
    assert _rho_split_counts() == tuple(c + 1 for c in before[:3]) + (
        before[3] + 1 + 2 * len(plans),)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_rho_split_sampler_at_d12_matches_plain(dev, precision):
    """D=12: the rho NLL takes the block layout (D % 4 == 0), the sampler
    the split one (D % 8 != 0): scan.rho_sample_fused launches the split
    sampler once, and it matches its plain version."""
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import scan, split
    s_in, _, _, cfg = _rho_split_inputs(dev, 12, 3, "auto", STEPS[precision])
    _close(split.rho_sample_split(**s_in, precision=precision),
           split.rho_sample_split_plain(**s_in, precision=precision),
           TOL[precision])
    p = init_rho(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    before = _rho_split_counts()
    wave = scan.rho_sample_fused(p, cfg, s_in["noise"])
    assert wave.shape == (3, STEPS[precision]) and torch.isfinite(wave).all()
    assert _rho_split_counts() == (before[0] + 1,) + before[1:]


# (D, rank, elements a thread): one warp, no CTA barrier (D=6, rank 3);
# one element a thread (D=10, 12, 20); two (D=33), four (D=64 at full
# rank) and eight (D=40, rank 110: 4400 elements).
RHO_SPLIT_SAMPLE_CASES = [(6, 3, 1), (10, 10, 1), (12, 3, 1), (20, 20, 1),
                          (33, 33, 2), (64, 64, 4), (40, 110, 8)]


@pytest.mark.parametrize("D, rank, elems", RHO_SPLIT_SAMPLE_CASES)
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_rho_split_sampler_layouts_match_plain(dev, D, rank, elems,
                                               precision):
    """The rho split sampler at every elements-a-thread instantiation it
    takes against its plain version: highest over 300 steps at TOL,
    default over 16; the launch records the rule's layout. The kernel's
    CTA fits wherever the ceiling does."""
    from audio_mps_tpu_torch.ops import _build, split
    s_in, _, _, _ = _rho_split_inputs(dev, D, rank, "split",
                                      STEPS[precision], B=2)
    before = split.rho_sample_split.launches
    got = split.rho_sample_split(**s_in, precision=precision)
    torch.cuda.synchronize()
    assert split.rho_sample_split.launches == before + 1
    assert split.rho_sample_split.layout == split.rho_split_sample_layout(
        D, rank)
    assert split.rho_sample_split.layout.elems == elems
    _close(got, split.rho_sample_split_plain(**s_in, precision=precision),
           TOL[precision])
    have = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert _build.library().amt_rho_split_sample_smem_bytes(D, rank) <= have


def test_rho_split_sampler_fits_agree_with_the_kernel(dev):
    """scan.rho_sampler_fits in the split layout is true where the split
    sampler launches (D=64 at full rank; D=33, rank 33) and false at D=65
    full rank, where it raises before any launch."""
    from audio_mps_tpu_torch.ops import scan, split
    for D, fits in ((33, True), (64, True), (65, False)):
        cfg = CMPSConfig(bond_dim=D, kernel_layout="split")
        assert scan.rho_sampler_fits(cfg, D, dev) is fits
        s_in, _, _, _ = _rho_split_inputs(dev, D, D, "split", 12, B=2)
        before = split.rho_sample_split.launches
        if fits:
            assert torch.isfinite(split.rho_sample_split(**s_in)).all()
            assert split.rho_sample_split.launches == before + 1
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
                split.rho_sample_split(**s_in)
            assert split.rho_sample_split.launches == before


@pytest.mark.parametrize("defer", [False, True])
def test_rho_split_adjoint_forms_give_the_same_bits(dev, defer):
    """The adjoint's two forms with their slabs in shared memory and in the
    device workspace run the same arithmetic in the same order: at D=10,
    full rank, B=32 over 2048 steps the four give the same bits in all
    eleven outputs."""
    from audio_mps_tpu_torch.ops import split
    _, inputs, g, _ = _rho_split_inputs(dev, 10, 10, "auto", 2048, B=32)
    args = [inputs[k] for k in split.RHO_SPLIT_NAMES + ("se",)]
    kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
              defer_norm=defer)
    _, ckr, cki = split.rho_split_fwd(*args, **kw)
    runs = [split.rho_split_bwd(*args[:8], args[10], g, ckr, cki, **kw,
                                _plan=(p, f))
            for f in split.SPLIT_BWD_FORMS
            for p in split.SPLIT_BWD_PLACEMENTS]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)


def test_rho_split_adjoint_is_reproducible_bit_for_bit(dev):
    """The adjoint's per-example cotangent sums are added in a fixed order
    (no atomics): two runs at D=10, full rank, B=32 over 2048 steps are
    equal to the bit in all eleven outputs."""
    from audio_mps_tpu_torch.ops import split
    _, inputs, g, _ = _rho_split_inputs(dev, 10, 10, "auto", 2048, B=32)
    args = [inputs[k] for k in split.RHO_SPLIT_NAMES + ("se",)]
    kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
              defer_norm=True)
    _, ckr, cki = split.rho_split_fwd(*args, **kw)
    runs = [split.rho_split_bwd(*args[:8], args[10], g, ckr, cki, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_rho_split_ceilings_raise_before_any_launch(dev):
    """The stated ceilings (ops/split.py) are the kernels' own byte counts
    on this card: at full rank the sampler (its ceiling, kept from its
    first design), NLL and training forward take D=64 and not 65, the
    adjoint (unroll 16) D=53 and not 54; past them
    each wrapper raises NotImplementedError and no launch counter moves;
    scan.rho_sampler_fits agrees (true at D=10 full rank and D=12, false
    at D=66 full rank)."""
    from audio_mps_tpu_torch.ops import _build, scan, split
    lib = _build.library()
    have = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for fn, ok, past in (
            (split.rho_split_sample_ceiling_bytes, (64, 64), (65, 65)),
            (lib.amt_rho_split_fwd_smem_bytes, (64, 64), (65, 65)),
            (lambda D, r: lib.amt_rho_split_bwd_smem_bytes(D, r, 16),
             (53, 53), (54, 54))):
        assert fn(*ok) <= have < fn(*past)
    before = _rho_split_counts()
    for D in (65, 54):
        s_in, inputs, g, _ = _rho_split_inputs(dev, D, D, "auto", 20, B=2)
        args = [inputs[k] for k in split.RHO_SPLIT_NAMES + ("se",)]
        kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"])
        ck = torch.zeros(2, D, 2 * D, device=dev)
        calls = [lambda: split.rho_split_bwd(*args[:8], args[10], g, ck, ck,
                                             **kw)]
        if D == 65:
            calls += [lambda: split.rho_sample_split(**s_in),
                      lambda: split.rho_nll_split(*args, **kw),
                      lambda: split.rho_split_fwd(*args, **kw)]
        for call in calls:
            with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
                call()
    assert _rho_split_counts() == before
    for D, rank, fits in ((10, 10, True), (12, 12, True), (66, 66, False)):
        assert scan.rho_sampler_fits(CMPSConfig(bond_dim=D), rank,
                                     dev) is fits


@pytest.mark.parametrize("family, D, rank, plan", [
    ("psi", 33, 1, "double"), ("psi", 63, 1, "double"),
    ("psi", 64, 1, "single"), ("psi", 73, 1, "single"),
    ("rho", 12, 12, ("ws", "double")), ("rho", 17, 17, ("ws", "single")),
    ("rho", 53, 53, ("ws", "single"))])
def test_split_adjoints_at_the_plans_bounds_match_plain(dev, family, D,
                                                        rank, plan):
    """At unroll 16 the plans change form or placement between these
    shapes, up to the ceilings (psi D=73, rho D=53 at full rank): each
    launch takes the plan's and matches its plain version within TOL over
    39 steps, both norms."""
    from audio_mps_tpu_torch.ops import split
    for defer in (True, False):
        if family == "psi":
            _, inputs, g = _split_inputs(dev, D, "auto", 39, B=3)
            args = [inputs[k] for k in ("cr", "ci", "rr", "ri", "pc", "ps",
                                        "s0r", "s0i", "se")]
            fwd, bwd, nc = (split.psi_split_fwd_plain, split.psi_split_bwd,
                            6)
        else:
            _, inputs, g, _ = _rho_split_inputs(dev, D, rank, "auto", 39,
                                                B=2)
            args = [inputs[k] for k in split.RHO_SPLIT_NAMES + ("se",)]
            fwd, bwd, nc = (split.rho_split_fwd_plain, split.rho_split_bwd,
                            8)
        kw = dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
                  unroll=16, defer_norm=defer)
        f = fwd(*args, **kw)
        call = args[:nc] + [args[-1], g, f[1], f[2]]
        got = bwd(*call, **kw)
        torch.cuda.synchronize()
        assert (bwd.form if family == "psi" else bwd.plan) == plan
        want = getattr(split, bwd.__name__ + "_plain")(*call, **kw)
        for a, b in zip(got, want):
            _close(a, b, TOL["highest"])


@pytest.mark.parametrize("defer", [False, True])
def test_rho_split_train_path_runs_its_two_kernels(dev, defer):
    """One value-and-gradient of the rho training NLL at D=10, full rank on
    the card launches the split forward and adjoint once each and no block
    or rank-chunked training kernel, and matches the same call on CPU
    copies (the plain versions): the loss within 1e-4 relative, each
    gradient within 1e-3 of its largest element."""
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import grad, rank
    from audio_mps_tpu_torch.weights import (params_to_numpy,
                                             rho_params_from_numpy)
    cfg = CMPSConfig(bond_dim=10, minibatch_size=8)
    p = init_rho(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), 8, 257,
                            cfg.delta_t)
    others = (block.rho_train_fwd, block.rho_train_fwd_ckpt,
              block.rho_recompute, block.rho_train_bwd, block.rho_cotangents,
              rank.rank_partials_fwd, rank.rank_partials_bwd)
    before, other_before = _rho_split_counts(), [w.launches for w in others]
    loss = grad.rho_nll_fused_trainable(p, cfg, sig, defer_norm=defer)
    loss.backward()
    torch.cuda.synchronize()
    assert _rho_split_counts() == (before[0], before[1], before[2] + 1,
                                   before[3] + 1)
    assert [w.launches for w in others] == other_before
    q = rho_params_from_numpy(params_to_numpy(p), "cpu")
    want = grad.rho_nll_fused_trainable(q, cfg, sig.cpu(), defer_norm=defer)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        _close(getattr(p, name).grad.cpu(), getattr(q, name).grad, 1e-3)


def test_rho_train_cli_summaries_sample_through_the_split_kernel(
        dev, tmp_path, monkeypatch):
    """The train CLI at rho D=10 (no multiple of 4 or 8) takes its step
    through the split training pair and draws its summary samples through
    the split sampler kernel (scan.rho_sample_fused_keyed), not the eager
    loop."""
    from audio_mps_tpu_torch import summaries
    from audio_mps_tpu_torch.train import parse_args, train

    class Writer:
        def close(self):
            pass

    drawn = []
    monkeypatch.setattr(summaries, "make_writer", lambda logdir: Writer())
    monkeypatch.setattr(summaries, "write_step_summaries",
                        lambda *a, samples=None, **k: drawn.append(samples))
    run, device = parse_args([
        "--mps_model=rho_mps", "--dataset=damped_sine",
        "--sample_duration=65", "--hparams=bond_dim=10,minibatch_size=4",
        f"--logdir={tmp_path}", "--max_steps=1", "--num_samples=2"])
    before = _rho_split_counts()
    train(run, device=device, verbose=False)
    torch.cuda.synchronize()
    assert _rho_split_counts() == (before[0] + 1, before[1], before[2] + 1,
                                   before[3] + 1)
    assert drawn[0].shape == (2, 65) and torch.isfinite(drawn[0]).all()


# ---------------------------------------------------------------------------
# The split forward templates (csrc/psi_split_fwd.cuh, rho_split_fwd.cuh):
# one walk and one barrier a step, the loss sums in a ring off the chain,
# rho's columns warp-local where D <= 32
# ---------------------------------------------------------------------------

PSI_SPLIT_NAMES = ("cr", "ci", "rr", "ri", "pc", "ps", "s0r", "s0i", "se")


def _split_fwd_case(dev, family, D, rank, steps, B=3):
    """(the forward's tensor inputs in order, its eps options) of psi or
    rho at D (rank) over ``steps`` samples."""
    from audio_mps_tpu_torch.ops import split
    if family == "psi":
        _, inputs, _ = _split_inputs(dev, D, "auto", steps, B=B)
        names = PSI_SPLIT_NAMES
    else:
        _, inputs, _, _ = _rho_split_inputs(dev, D, rank, "auto", steps, B=B)
        names = split.RHO_SPLIT_NAMES + ("se",)
    return ([inputs[k] for k in names],
            dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"]))


def _split_fwd_fns(family):
    from audio_mps_tpu_torch.ops import split
    if family == "psi":
        return (split.psi_nll_split, split.psi_split_fwd,
                split.psi_nll_split_plain, split.psi_split_fwd_plain)
    return (split.rho_nll_split, split.rho_split_fwd,
            split.rho_nll_split_plain, split.rho_split_fwd_plain)


def test_split_forward_layouts_and_smem_agree_with_the_kernels(dev):
    """ops/split.py's mirrors of the forwards' layouts and byte counts are
    the C launchers' own (amt_rho_split_fwd_layout, amt_*_fwd_smem_bytes)
    at every D to the ceilings, full rank and rank 3, in both rho
    layouts."""
    from audio_mps_tpu_torch.ops import _build, split
    lib = _build.library()
    for D in range(1, 121):
        assert lib.amt_psi_split_fwd_smem_bytes(D) == \
            split.psi_split_fwd_smem_bytes(D)
    for D in range(1, 66):
        for rank in sorted({D, 3}):
            for wl in (True, False):
                want = split.rho_split_fwd_layout(D, rank, wl)
                got = [lib.amt_rho_split_fwd_layout(D, rank, int(wl), f)
                       for f in range(5)]
                assert got == [want.cols, want.threads, want.elems,
                               want.slots, want.smem_bytes], (D, rank, wl)
            assert lib.amt_rho_split_fwd_smem_bytes(D, rank) == \
                split.rho_split_fwd_layout(D, rank).smem_bytes


# (family, D, rank): psi one warp (D=10) and a CTA of 2, 2 and 4 warps
# (D=33, 50 and the ceiling 119); rho warp-local at 3 columns a warp
# (D=10), one (D=20, D=32: 20 and 32 warps), the element layout past D=32
SPLIT_FWD_SHAPES = [("psi", 10, 1), ("psi", 33, 1), ("psi", 50, 1),
                    ("psi", 119, 1), ("rho", 10, 10), ("rho", 20, 20),
                    ("rho", 32, 32), ("rho", 33, 33)]


@pytest.mark.parametrize("family, D, rank", SPLIT_FWD_SHAPES)
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_split_forwards_across_layouts_match_plain(dev, family, D, rank,
                                                   precision, defer):
    """The NLL and the training forward (loss and checkpoints) against
    their plain versions at shapes on both sides of the layouts' bounds,
    unroll 7 (a ragged last block), highest over 300 steps and default
    over 16 at TOL; the NLL's loss is the training forward's bit for bit
    (one template), and rho's element layout forced at D <= 32 matches
    plain too."""
    nll, fwd, nll_plain, fwd_plain = _split_fwd_fns(family)
    args, eps = _split_fwd_case(dev, family, D, rank, STEPS[precision])
    kw = dict(eps, unroll=7, precision=precision, defer_norm=defer)
    want = fwd_plain(*args, **kw)
    got = fwd(*args, **kw)
    for a, b in zip(got, want):
        _close(a, b, TOL[precision])
    loss = nll(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(loss, got[0])
    _close(loss, nll_plain(*args, **kw), TOL[precision])
    if family == "rho" and D <= 32:
        assert fwd.layout.cols > 0 and nll.layout.cols > 0
        got = fwd(*args, **kw, _warp_local=False)
        assert fwd.layout.cols == 0
        for a, b in zip(got, want):
            _close(a, b, TOL[precision])
        assert torch.equal(nll(*args, **kw, _warp_local=False), got[0])


@pytest.mark.parametrize("family, D, rank", [("psi", 10, 1), ("psi", 50, 1),
                                             ("rho", 10, 10),
                                             ("rho", 20, 20),
                                             ("rho", 33, 33)])
@pytest.mark.parametrize("defer", [False, True])
def test_split_forwards_are_reproducible_bit_for_bit(dev, family, D, rank,
                                                     defer):
    """The loss ring adds a flush's parts in a fixed order (no atomics):
    two launches of each forward at B=32 over 2048 steps (unroll 16) give
    the same loss and checkpoints, and the NLL the training forward's
    loss, bit for bit."""
    nll, fwd, _, _ = _split_fwd_fns(family)
    args, eps = _split_fwd_case(dev, family, D, rank, 2048, B=32)
    kw = dict(eps, defer_norm=defer)
    runs = [fwd(*args, **kw) for _ in range(2)]
    losses = [nll(*args, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert torch.equal(losses[0], losses[1])
    assert torch.equal(losses[0], runs[0][0])


# ---------------------------------------------------------------------------
# "default" over a whole run (ROADMAP section C): one bf16 pass a product,
# as on the TPU, against highest, at each NLL kernel's main-path shape
# ---------------------------------------------------------------------------

# (D, rank or None for psi, B, T, delta_t): psi block at the training
# headline, rho block at D=64, rank 64, the split pair at the estimator's
# published shape
DEFAULT_RUN_SHAPES = {"psi_nll_block": (64, None, 128, 16384, 1 / 16000),
                      "rho_nll_block": (64, 64, 8, 16384, 1 / 16000),
                      "psi_nll_split": (10, None, 32, 65536, 1e-3),
                      "rho_nll_split": (10, 10, 32, 65536, 1e-3)}
# max|default - highest| <= bound * max|highest| over a run's per-example
# losses: twice the worst gap of 8 seeds that this test prints, measured
# on an H100 80GB HBM3 at 700 W (PERF.md §6)
DEFAULT_RUN_BOUND = {"psi_nll_block": 0.880, "rho_nll_block": 0.752,
                     "psi_nll_split": 0.161, "rho_nll_split": 0.0403}


@pytest.mark.parametrize("kernel", list(DEFAULT_RUN_SHAPES))
def test_default_precision_over_a_run_stays_within_its_bound(dev, kernel):
    """Each NLL kernel at default against itself at highest over a whole
    run at its main-path shape, for 8 seeds (parameters and batch): the
    worst relative gap of the per-example losses within the committed
    bound. The samplers have none: one rounding that falls the other way
    sends an SDE path elsewhere (held over 16 steps above)."""
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import split
    D, rank, B, T, dt = DEFAULT_RUN_SHAPES[kernel]
    cfg = CMPSConfig(bond_dim=D, initial_rank=rank, minibatch_size=B,
                     delta_t=dt)
    fn = getattr(split if kernel.endswith("split") else block, kernel)
    make = {"psi_nll_block": block.psi_nll_inputs,
            "rho_nll_block": block.rho_nll_inputs,
            "psi_nll_split": split.psi_split_inputs,
            "rho_nll_split": split.rho_split_inputs}[kernel]
    gaps = []
    for seed in range(8):
        p = (init_rho if rank else init_psi)(
            torch.Generator(dev).manual_seed(100 + seed), cfg, device=dev)
        sig = damped_sine_batch(torch.Generator(dev).manual_seed(200 + seed),
                                B, T, dt)
        inputs = make(p, cfg, sig)
        hi = fn(**inputs, precision="highest")
        lo = fn(**inputs, precision="default")
        assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
        gaps.append(((lo - hi).abs().max() / hi.abs().max()).item())
        del inputs, sig
    print(f"{kernel} default vs highest, D={D}, B={B}, T={T}: worst "
          f"{max(gaps):.3e} x max|highest| over 8 seeds "
          f"({', '.join(f'{x:.3e}' for x in gaps)}); "
          f"{torch.cuda.get_device_name(dev)}")
    assert max(gaps) <= DEFAULT_RUN_BOUND[kernel]


# psi's spine/limbs pair (ops/block.py psi_batched_fwd / psi_batched_bwd,
# csrc/psi_batched_fwd.cu and psi_batched_bwd.cu) and the floor probe
# (ops/probe.py, csrc/psi_probe.cu)

def _batched_counts():
    return (block.psi_batched_fwd.launches, block.psi_batched_bwd.launches)


@pytest.mark.parametrize("D", [8, 12, 64])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("unroll", [7, 16])
def test_batched_kernels_match_plain(dev, D, precision, unroll):
    """The batched forward (loss, ck) and adjoint (dse, dt0, dAb, dBb, dRb,
    fed the plain forward's checkpoints) against their plain versions; the
    last block is partial at both unrolls."""
    inputs, g = _train_inputs(dev, D, STEPS[precision])
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              precision=precision, unroll=unroll)
    before = _batched_counts()
    want = block.psi_batched_fwd_plain(**inputs, **kw)
    for a, b in zip(block.psi_batched_fwd(**inputs, **kw), want):
        _close(a, b, TOL[precision])
    con = (inputs["ab"], inputs["bb"], inputs["rb"], want[1], inputs["se"], g)
    got = block.psi_batched_bwd(*con, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == inputs["se"].shape
    for a, b in zip(got, block.psi_batched_bwd_plain(*con, **kw)):
        _close(a, b, TOL[precision])
    assert _batched_counts() == tuple(c + 1 for c in before)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_batched_forward_is_the_checkpoint_forward(dev, precision):
    """The batched forward sums every product and reduction in the order of
    the checkpoint forward (psi_train_fwd_ckpt, deferred norm): its loss
    and checkpoints are the same bits at D=64, over 300 steps of 16-step
    blocks and a partial one."""
    inputs, _ = _train_inputs(dev, 64, 300, B=7)
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              precision=precision, unroll=16)
    loss, ck = block.psi_batched_fwd(**inputs, **kw)
    loss_c, ck_c = block.psi_train_fwd_ckpt(**inputs, **kw, defer_norm=True)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss_c)
    assert torch.equal(ck, ck_c)


def test_batched_adjoint_is_reproducible_bit_for_bit(dev):
    """Each CTA adds its column's cotangents to its own row and the wrapper
    sums the rows in a fixed order (no atomics): two runs at D=64, B=16
    over 1000 steps are equal to the bit in all five outputs."""
    inputs, g = _train_inputs(dev, 64, 1000, B=16)
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              unroll=16)
    _, ck = block.psi_batched_fwd(**inputs, **kw)
    con = (inputs["ab"], inputs["bb"], inputs["rb"], ck, inputs["se"], g)
    runs = [block.psi_batched_bwd(*con, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("unroll", [1, 5, 40, 64])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_batched_adjoint_windows_match_plain(dev, unroll, precision):
    """The adjoint's contraction windows (psi_batched_window: 64 blocks of
    one step, 12 of 5, one of 40 and one of 64 steps) and its tail's chunks
    of 16 steps (several a block at unroll 40 and 64, the last partial)
    against the plain adjoint at D=12 over 300 steps, the last block and the
    last window partial."""
    inputs, g = _train_inputs(dev, 12, 300, B=3)
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              precision=precision, unroll=unroll)
    _, ck = block.psi_batched_fwd_plain(**inputs, **kw)
    con = (inputs["ab"], inputs["bb"], inputs["rb"], ck, inputs["se"], g)
    got = block.psi_batched_bwd(*con, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, block.psi_batched_bwd_plain(*con, **kw)):
        _close(a, b, TOL[precision])


def test_batched_smem_ceiling_raises_before_any_launch(dev):
    """The adjoint keeps the three padded constants and three [2D, K]
    buffers in shared memory: it fits D=64 at unroll 16 and not D=68, where
    both wrappers raise NotImplementedError and no counter moves."""
    from audio_mps_tpu_torch.ops import _build
    lib = _build.library()
    have = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert lib.amt_psi_batched_bwd_smem_bytes(64, 16) <= have
    assert lib.amt_psi_batched_fwd_smem_bytes(64, 16) <= have
    assert lib.amt_psi_batched_bwd_smem_bytes(68, 16) > have
    inputs, g = _train_inputs(dev, 68, 40)
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              unroll=16)
    ck = torch.zeros((3, 136, g.shape[0]), device=dev)
    before = _batched_counts()
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        block.psi_batched_bwd(inputs["ab"], inputs["bb"], inputs["rb"], ck,
                              inputs["se"], g, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        block.psi_batched_fwd(**inputs, **kw)
    assert _batched_counts() == before


def test_batched_train_path_runs_its_two_kernels(dev):
    """psi_nll_block_trainable(batched=True) launches the batched pair once
    each and no other training kernel, and its value and six gradients
    agree with the streamed pair's (the same function, sums in another
    order: value to 1e-6, gradients to 1e-5 of their largest element)."""
    from audio_mps_tpu_torch.weights import (params_to_numpy,
                                             psi_params_from_numpy)
    cfg = CMPSConfig(bond_dim=64, minibatch_size=8, defer_norm=True)
    p0 = init_psi(torch.Generator(dev).manual_seed(9), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(8), 8, 400,
                            cfg.delta_t)
    res = {}
    for batched in (False, True):
        p = psi_params_from_numpy(params_to_numpy(p0), dev)
        before = _batched_counts() + _counts()
        loss = block.psi_nll_block_trainable(p, cfg, sig, defer_norm=True,
                                             batched=batched)
        loss.backward()
        torch.cuda.synchronize()
        moved = tuple(b - a for a, b in zip(before,
                                             _batched_counts() + _counts()))
        assert moved == ((1, 1, 0, 0, 0) if batched else (0, 0, 1, 1, 1))
        res[batched] = (loss.detach(), p)
    (l_s, p_s), (l_b, p_b) = res[False], res[True]
    assert abs((l_b - l_s).item()) <= 1e-6 * abs(l_s.item())
    for name in p_s.NAMES:
        a, b = getattr(p_b, name).grad, getattr(p_s, name).grad
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def _probe_case(dev, B=8, T=300, D=64):
    from audio_mps_tpu_torch.ops import probe
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B)
    p = init_psi(torch.Generator(dev).manual_seed(D), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(3), B, T,
                            cfg.delta_t)
    ins = block.psi_nll_inputs(p, cfg, sig)
    consts = (ins["ab"], ins["bb"], ins["rb"]) + probe.probe_products(
        ins["ab"], ins["bb"])
    return probe, consts, ins


PROBE_VARIANTS = [(False, False), (True, False), (False, True)]


@pytest.mark.parametrize("paired, noloss", PROBE_VARIANTS)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_probe_kernel_matches_plain(dev, paired, noloss, precision):
    """Each probe variant's per-column values against its plain version at
    D=64 and D=12, G=2, over 300 steps (a partial last block of 16)."""
    for D in (12, 64):
        probe, consts, ins = _probe_case(dev, D=D, T=STEPS[precision] + 1)
        kw = dict(G=2, paired=paired, noloss=noloss, precision=precision,
                  unroll=16, log_eps=ins["log_eps"],
                  norm_eps=ins["norm_eps"])
        before = probe.psi_probe_columns.launches
        got = probe.psi_probe_columns(consts, ins["t0"], ins["se"], **kw)
        torch.cuda.synchronize()
        assert probe.psi_probe_columns.launches == before + 1
        _close(got, probe.psi_probe_columns_plain(consts, ins["t0"],
                                                  ins["se"], **kw),
               TOL[precision])


@pytest.mark.parametrize("paired, noloss", PROBE_VARIANTS)
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_probe_columns_do_not_depend_on_the_groups(dev, paired, noloss,
                                                   precision):
    """G columns a CTA run in lockstep with each column's sums in the G=1
    order: the per-column values are the same bits for G = 1, 2 and 4."""
    probe, consts, ins = _probe_case(dev)
    kw = dict(paired=paired, noloss=noloss, precision=precision, unroll=16,
              log_eps=ins["log_eps"], norm_eps=ins["norm_eps"])
    runs = [probe.psi_probe_columns(consts, ins["t0"], ins["se"], G=G, **kw)
            for G in (1, 2, 4)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


# ---------------------------------------------------------------------------
# the cotangent reduction (csrc/psi_cotangents.cu) on its own: random
# streams, every group layout its three wrappers give it
# ---------------------------------------------------------------------------

# (family, D, rank, rc, B): psi's n = 16, 24, 136 and the flagship 128
# (gs = gn = 1); rho's rank lanes (gs = gn = rank) at a rank that is not a
# multiple of 4 (3, B=5: 15 lanes, not a multiple of the 16-lane chunk) and
# at rank 64; the rank partials' examples and segments (gs = rank, gn = rc)
# at D=8 and at D=256 (n = 512, 4 x 4 output tiles) with rc 16
COT_CASES = [("psi", 8, 1, None, 5), ("psi", 12, 1, None, 5),
             ("psi", 68, 1, None, 5), ("psi", 64, 1, None, 128),
             ("rho", 8, 3, None, 5), ("rho", 8, 64, None, 3),
             ("rho", 64, 64, None, 2), ("rank", 8, 6, 3, 5),
             ("rank", 256, 64, 16, 2)]


def _cot_case(dev, family, D, rank_, rc, B, steps, seed=7):
    """(kernel wrapper, plain version, args, keyword args) of one cotangent
    reduction on random streams: steps not a multiple of the step split or
    of the unroll (7), norms in [0.5, 2), so every renormalising step
    rescales."""
    from audio_mps_tpu_torch.ops import rank as rank_ops
    gen = torch.Generator(dev).manual_seed(seed)
    n, L = 2 * D, B * rank_
    groups = B if rc is None else L // rc

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    dy, ys, t0 = randn(steps, n, L), randn(steps, n, L), randn(n, L)
    se = 0.1 * randn(steps, B)
    norms = 0.5 + 1.5 * torch.rand(steps, groups, generator=gen, device=dev)
    dehat = randn(steps, groups)
    args = (dy, ys, t0, se, norms, dehat)
    if family == "rank":
        return (rank_ops.rank_cotangents, rank_ops.rank_cotangents_plain,
                args, dict(rc=rc, unroll=7, norm_eps=1e-12))
    fn = getattr(block, f"{family}_cotangents")
    return fn, getattr(block, f"{family}_cotangents_plain"), args, dict(
        unroll=7, norm_eps=1e-12)


@pytest.mark.parametrize("case", COT_CASES,
                         ids=[f"{c[0]}-D{c[1]}-r{c[2]}-B{c[4]}"
                              for c in COT_CASES])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_cotangent_kernel_matches_plain(dev, case, precision, defer):
    """The reduction kernel against its plain version on the same streams,
    for psi's lanes, rho's rank lanes and the rank partials' examples and
    segments, 301 steps (67 at D=256). The rank partials always defer."""
    family, D, rank_, rc, B = case
    if family == "rank" and not defer:
        defer = True
    fn, plain, args, kw = _cot_case(dev, family, D, rank_, rc, B,
                                    67 if D >= 128 else 301)
    kw["precision"] = precision
    if family != "rank":
        kw["defer_norm"] = defer
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for a, b in zip(got, plain(*args, **kw)):
        _close(a, b, TOL[precision])


@pytest.mark.parametrize("family, D, rank_, rc, B", [
    ("psi", 64, 1, None, 128), ("rho", 64, 64, None, 8),
    ("rank", 256, 256, 16, 2)])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cotangent_kernel_is_reproducible_bit_for_bit(dev, family, D, rank_,
                                                      rc, B, precision):
    """Two launches on the same streams give the same bits: the split over
    steps is fixed, the partials are added in split order, and nothing is
    atomic."""
    fn, _, args, kw = _cot_case(dev, family, D, rank_, rc, B, 300)
    runs = [fn(*args, **kw, precision=precision) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.isfinite(a).all() and torch.equal(a, b)


# ---------------------------------------------------------------------------
# psi's block forward and adjoint at G columns a CTA (csrc/psi_fwd.cuh,
# csrc/psi_train_bwd.cu; ops/block.py psi_columns_per_cta)
# ---------------------------------------------------------------------------

def _psi_all(inputs, g, kw, G):
    """Every psi block kernel at G columns a CTA on the same inputs: the
    NLL, the streamed forward, the checkpoint forward, the recompute from
    those checkpoints (one launch over the run, spans of several blocks),
    the adjoint on the stream and the whole recompute adjoint."""
    log_eps = inputs["log_eps"]
    ins = {k: v for k, v in inputs.items() if k != "log_eps"}
    c = dict(kw, cols_per_cta=G)
    nll = block.psi_nll_block(**ins, log_eps=log_eps, **c)
    loss, ys, n2s = block.psi_train_fwd(**ins, log_eps=log_eps, **c)
    loss_c, ck = block.psi_train_fwd_ckpt(**ins, log_eps=log_eps, **c)
    con = dict(ab=ins["ab"], bb=ins["bb"], rb=ins["rb"], ck=ck, se=ins["se"])
    rys, rn2s = block.psi_recompute(**con, norm_eps=ins["norm_eps"], **c)
    adj = block.psi_train_bwd(**ins, g=g, ys=ys, n2s=n2s, log_eps=log_eps,
                              **c)
    whole = block.psi_recompute_bwd(**con, g=g, log_eps=log_eps,
                                    norm_eps=ins["norm_eps"],
                                    segment=SEGMENT, **c)
    torch.cuda.synchronize()
    return (nll, loss, ys, n2s, loss_c, ck, rys, rn2s, *adj, *whole)


@pytest.mark.parametrize("D", [8, 12, 64])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_psi_columns_give_the_bits_of_one_column(dev, D, precision, defer):
    """For every G the rule can pick at D, on a ragged batch B = 3G + 1
    (the last CTA masks all but one column), each psi block kernel gives
    G = 1's outputs bit for bit; and within each G the NLL, streamed and
    checkpoint losses are one value and the recomputed states the
    stream's."""
    kw = dict(precision=precision, defer_norm=defer, unroll=UNROLL)
    for G in block.PSI_COLS:
        assert max(block.psi_fwd_smem_bytes(D, G),
                   block.psi_bwd_smem_bytes(D, G)) <= block.H100_SMEM_OPTIN
        inputs, g = _train_inputs(dev, D, 200, B=3 * G + 1, seed=G)
        want = _psi_all(inputs, g, kw, 1)
        got = _psi_all(inputs, g, kw, G)
        assert block.psi_train_bwd.cols_per_cta == G
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.isfinite(b).all() and torch.equal(a, b), (G, i)
        nll, loss, ys, n2s, loss_c, _, rys, rn2s = got[:8]
        assert torch.equal(nll, loss) and torch.equal(loss, loss_c)
        assert torch.equal(rys, ys) and torch.equal(rn2s, n2s)


def test_psi_columns_rule_and_smem_agree_with_the_kernels(dev):
    """The Python shared-memory counts are the kernels' own; on this card
    the rule keeps one column a CTA at B=128 and takes the fewest waves
    past one, at most 4 columns (4 at B=1024 on 132 SMs); at D=68, the
    quad layout's last D,
    every G launches (Ab and Bb sit in registers, so no G overflows shared
    memory there), and past it (D=72, asked for the quad layout: the rule
    takes the cluster layout there) or at a G the kernels do not take the
    wrappers raise before any launch."""
    from audio_mps_tpu_torch.ops import _build
    lib = _build.library()
    for D in (8, 12, 64, 68):
        assert lib.amt_psi_train_bwd_tail_smem_bytes(D) == \
            block.psi_tail_smem_bytes(D)
        for G in block.PSI_COLS:
            assert lib.amt_psi_train_fwd_smem_bytes(D, G) == \
                block.psi_fwd_smem_bytes(D, G)
            assert lib.amt_psi_nll_smem_bytes(D, G) == \
                block.psi_fwd_smem_bytes(D, G)
            assert lib.amt_psi_train_bwd_smem_bytes(D, G) == \
                block.psi_bwd_smem_bytes(D, G)
    props = torch.cuda.get_device_properties(dev)
    sms = props.multi_processor_count
    rule = block.psi_columns_per_cta
    assert rule(128, 64, sms) == 1
    assert rule(sms, 64, sms) == 1
    if sms == 132:
        assert rule(1024, 64, sms) == 4
    inputs, g = _train_inputs(dev, 68, 20, B=4)
    before = _counts()
    _, ys, n2s = block.psi_train_fwd(**inputs, cols_per_cta=8)
    block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s, cols_per_cta=4)
    with pytest.raises(ValueError, match="cols_per_cta"):
        block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s, cols_per_cta=3)
    wide, g72 = _train_inputs(dev, 72, 20, B=4)
    with pytest.raises(NotImplementedError, match="registers"):
        block.psi_train_fwd(**wide, _layout="quad")
    with pytest.raises(NotImplementedError, match="registers"):
        block.psi_train_bwd(**wide, g=g72, ys=torch.zeros(20, 144, 4,
                                                          device=dev),
                            n2s=torch.ones(20, 4, device=dev),
                            _layout="quad")
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2])


def test_psi_recompute_spans_at_the_rules_columns_are_the_stream(dev):
    """At B=1024 the rule runs several columns a CTA (8 on 132 SMs) and a
    recompute CTA a span of several blocks: the checkpoint forward's loss
    and the recomputed states are the streamed forward's bit for bit, and
    each equals a forced G=1 run's."""
    inputs, _ = _train_inputs(dev, 8, 300, B=1024)
    kw = dict(norm_eps=inputs.pop("norm_eps"), unroll=UNROLL,
              defer_norm=True)
    log_eps = inputs.pop("log_eps")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = block.psi_columns_per_cta(1024, 8, sms)
    assert G > 1 and block.psi_recompute_blocks(-(-1024 // G), 43, sms) > 1
    runs = []
    for cols in (None, 1):
        loss, ys, n2s = block.psi_train_fwd(**inputs, log_eps=log_eps,
                                            cols_per_cta=cols, **kw)
        loss_c, ck = block.psi_train_fwd_ckpt(**inputs, log_eps=log_eps,
                                              cols_per_cta=cols, **kw)
        got = block.psi_recompute(inputs["ab"], inputs["bb"], inputs["rb"],
                                  ck, inputs["se"], cols_per_cta=cols, **kw)
        torch.cuda.synchronize()
        assert torch.equal(loss, loss_c)
        assert torch.equal(got[0], ys) and torch.equal(got[1], n2s)
        runs.append((loss, ys, n2s, ck))
    assert block.psi_recompute.cols_per_cta == 1
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# psi's adjoint: the chain-free tail and the chain (csrc/psi_train_bwd.cu)
# ---------------------------------------------------------------------------

def _tail_inputs(dev, D, precision, defer, B=7):
    """The training inputs of a ragged batch, the plain forward's streams
    and the plain tail's outputs on them."""
    inputs, g = _train_inputs(dev, D, STEPS[precision], B=B, seed=D + 1)
    kw = dict(norm_eps=inputs.pop("norm_eps"), precision=precision,
              defer_norm=defer, unroll=UNROLL)
    log_eps = inputs.pop("log_eps")
    _, ys, n2s = block.psi_train_fwd_plain(**inputs, log_eps=log_eps, **kw)
    return inputs, g, kw, log_eps, ys, n2s


@pytest.mark.parametrize("D", [8, 12, 64])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_psi_tail_kernel_matches_plain(dev, D, precision, defer):
    """The tail alone (q, ds0, dehat, dn2_new over every step and column)
    against psi_train_bwd_tail_plain on the plain forward's streams, B=7
    (a ragged batch); one launch counted."""
    inputs, g, kw, log_eps, ys, n2s = _tail_inputs(dev, D, precision, defer)
    args = (inputs["rb"], inputs["se"], g, ys, n2s)
    before = block.psi_train_bwd_tail.launches
    got = block.psi_train_bwd_tail(*args, log_eps=log_eps, **kw)
    torch.cuda.synchronize()
    assert block.psi_train_bwd_tail.launches == before + 1
    for a, b in zip(got, block.psi_train_bwd_tail_plain(
            *args, log_eps=log_eps, **kw)):
        _close(a, b, TOL[precision])


@pytest.mark.parametrize("D", [8, 12, 64])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("with_dtfin", [False, True])
def test_psi_tail_and_chain_match_the_plain_adjoint(dev, D, precision, defer,
                                                    with_dtfin):
    """psi_train_bwd (the tail, then the chain, in one call) against
    psi_train_bwd_plain at the existing limits, with and without a
    cotangent dtfin carried in (the recompute adjoint's segments), B=7;
    both kernels' launches counted."""
    inputs, g, kw, log_eps, ys, n2s = _tail_inputs(dev, D, precision, defer)
    dtfin = (0.1 * torch.randn(2 * D, 7, device=dev,
                               generator=torch.Generator(dev).manual_seed(9))
             if with_dtfin else None)
    before = (block.psi_train_bwd.launches, block.psi_train_bwd_tail.launches)
    got = block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s, log_eps=log_eps,
                              dtfin=dtfin, **kw)
    torch.cuda.synchronize()
    assert (block.psi_train_bwd.launches,
            block.psi_train_bwd_tail.launches) == tuple(c + 1 for c in before)
    want = block.psi_train_bwd_plain(**inputs, g=g, ys=ys, n2s=n2s,
                                     log_eps=log_eps, dtfin=dtfin, **kw)
    for a, b in zip(got, want):
        _close(a, b, TOL[precision])


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_psi_adjoint_is_reproducible_bit_for_bit(dev, precision):
    """Two launches of the tail and of the whole adjoint on the same
    streams at D=64 give the same bits (no atomics; every sum in a fixed
    order)."""
    inputs, g, kw, log_eps, ys, n2s = _tail_inputs(dev, 64, precision, True)
    tails = [block.psi_train_bwd_tail(inputs["rb"], inputs["se"], g, ys, n2s,
                                      log_eps=log_eps, **kw)
             for _ in range(2)]
    runs = [block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s,
                                log_eps=log_eps, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*tails):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    for a, b in zip(*runs):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_products_ignore_tf32(dev):
    """Under torch.set_float32_matmul_precision("high") (TF32 on this
    card) the constants, the eager psi and rho losses and the value and
    gradient of the psi training loss through the kernels equal the
    default setting's bit for bit; the setting is restored afterwards."""
    from audio_mps_tpu_torch.models.cell import make_constants
    from audio_mps_tpu_torch.models.params import init_rho
    from audio_mps_tpu_torch.ops import grad
    cfg = CMPSConfig(bond_dim=64, minibatch_size=4, initial_rank=8)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    r = init_rho(torch.Generator(dev).manual_seed(1), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(2), 4, 129,
                            cfg.delta_t)

    def run():
        cc = make_constants(p, cfg)
        out = [cc.Kr, cc.Ki, cc.Cr, cc.Ci, core.psi_nll(p, cfg, sig),
               core.rho_nll(r, cfg, sig)]
        for t in p.parameters():
            t.grad = None
        loss = grad.psi_nll_fused_trainable(p, cfg, sig, defer_norm=True)
        loss.backward()
        torch.cuda.synchronize()
        return out + [loss.detach()] + [t.grad.clone()
                                        for t in p.parameters()]

    want = run()
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        state = (torch.get_float32_matmul_precision(),
                 torch.backends.cuda.matmul.allow_tf32)
        got = run()
        assert (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32) == state
    finally:
        torch.set_float32_matmul_precision(saved)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# rho's block forward and adjoint chain over a thread-block cluster of C CTAs
# an example (csrc/rho_cluster.cuh): every C gives C=1's bits
# ---------------------------------------------------------------------------

def _rho_all(inputs, g, kw, cluster):
    """Every output of the rho forward template's four modes and of the
    adjoint (tail and chain) at one cluster size; the recompute rebuilds
    the run from the checkpoint forward's checkpoints."""
    o = dict(kw, cluster=cluster)
    nll = block.rho_nll_block(**inputs, **o)
    loss, ys, trs = block.rho_train_fwd(**inputs, **o)
    loss_c, ck = block.rho_train_fwd_ckpt(**inputs, **o)
    rys, rtrs = block.rho_recompute(
        inputs["ab"], inputs["bb"], inputs["xb"], ck, inputs["se"],
        **{k: v for k, v in o.items() if k != "log_eps"})
    adj = block.rho_train_bwd(**inputs, g=g, ys=ys, trs=trs, **o)
    torch.cuda.synchronize()
    return (nll, loss, ys, trs, loss_c, ck, rys, rtrs, *adj)


@pytest.mark.parametrize("D, rank", [(64, 64), (16, 64), (8, 8)])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_rho_clusters_give_the_bits_of_one_cta(dev, D, rank, precision,
                                               defer):
    """For every cluster C in {1, 2, 4, 8} that divides the rank's column
    groups, the rho forward in its four modes (the NLL, the streamed and
    the checkpoint forward, the recompute) and the adjoint give C=1's
    outputs bit for bit; and within each C the three losses are one value
    and the recomputed states are the stream's."""
    p, cfg = _rho_params(dev, D, rank)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(7), 3, 201,
                            cfg.delta_t)
    inputs = block.rho_nll_inputs(p, cfg, sig)
    g = torch.rand(3, generator=torch.Generator(dev).manual_seed(8),
                   device=dev) + 0.5
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              precision=precision, defer_norm=defer, unroll=UNROLL)
    groups = -(-rank // 4)
    want = _rho_all(inputs, g, kw, 1)
    for C in (2, 4, 8):
        if groups % C:
            continue
        got = _rho_all(inputs, g, kw, C)
        assert block.rho_train_fwd.cluster == C
        assert block.rho_train_bwd.cluster == C
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.isfinite(b).all() and torch.equal(a, b), (C, i)
    nll, loss, ys, trs, loss_c, _, rys, rtrs = want[:8]
    assert torch.equal(nll, loss) and torch.equal(loss, loss_c)
    assert torch.equal(rys, ys) and torch.equal(rtrs, trs)


def test_rho_cluster_rule_and_smem_agree_with_the_kernels(dev):
    """The Python shared-memory counts and buffer choices are the kernels'
    own; the card's residency feeds the rule, which at the headline (D=64,
    rank 64, B=8) takes clusters of 8 on an H100, and each launch records
    the cluster it took; a cluster the rank's groups do not admit raises
    before any launch."""
    from audio_mps_tpu_torch.ops import _build
    lib = _build.library()
    optin = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    for D, rank in ((8, 1), (8, 3), (12, 8), (64, 60), (64, 64)):
        groups = -(-rank // 4)
        for C in block.RHO_CLUSTERS:
            if groups % C:
                continue
            for rec in (False, True):
                for nbuf in (1, 2):
                    assert lib.amt_rho_fwd_smem_bytes(
                        D, rank, C, int(rec), nbuf) == \
                        block.rho_fwd_smem_bytes(D, rank, C, rec, nbuf)
                assert lib.amt_rho_fwd_buffers(D, rank, C, int(rec)) == \
                    block.rho_fwd_buffers(D, rank, C, rec, optin)
            assert lib.amt_rho_chain_smem_bytes(D, rank, C) == \
                block.rho_chain_smem_bytes(D, rank, C)
            for kernel in ("fwd", "recompute", "chain"):
                assert block.rho_resident_clusters(
                    torch.cuda.current_device(), kernel, D, rank, C) > 0
    p, cfg = _rho_params(dev, 64, 64)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(9), 8, 65,
                            cfg.delta_t)
    inputs = block.rho_nll_inputs(p, cfg, sig)
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              defer_norm=True)
    _, ys, trs = block.rho_train_fwd(**inputs, **kw)
    block.rho_train_bwd(**inputs, g=torch.ones(8, device=dev), ys=ys,
                        trs=trs, **kw)
    torch.cuda.synchronize()
    props = torch.cuda.get_device_properties(dev)
    index = torch.cuda.current_device()
    for fn, kernel in ((block.rho_train_fwd, "fwd"),
                       (block.rho_train_bwd, "chain")):
        want = block.rho_cluster_for(
            64, 8, 64, props.multi_processor_count,
            lambda c: block.rho_resident_clusters(index, kernel, 64, 64, c),
            optin, kernel)
        assert fn.cluster == want
        if props.multi_processor_count == 132:
            assert fn.cluster == 8
    before = (block.rho_nll_block.launches, block.rho_train_fwd.launches)
    inputs_12 = block.rho_nll_inputs(*_rho_params(dev, 12, 12), sig[:2])
    for k in ("log_eps", "norm_eps"):
        inputs_12.pop(k)
    for cluster in (3, 8, 32):
        with pytest.raises(ValueError, match="column groups"):
            block.rho_nll_block(**inputs_12, **kw, cluster=cluster)
        with pytest.raises(ValueError, match="column groups"):
            block.rho_train_fwd(**inputs_12, **kw, cluster=cluster)
    torch.cuda.synchronize()
    assert (block.rho_nll_block.launches,
            block.rho_train_fwd.launches) == before


# ---------------------------------------------------------------------------
# rho's sampler over a thread-block cluster of C CTAs a chain
# (csrc/rho_sample.cu on csrc/rho_cluster.cuh): every C gives C=1's bits
# ---------------------------------------------------------------------------

def _rho_sample_sizes(dev, D, rank):
    """The clusters the rank's column groups admit and the card holds."""
    index = torch.cuda.current_device()
    return [C for C in block.RHO_CLUSTERS if -(-rank // 4) % C == 0
            and block.rho_resident_clusters(index, "sample", D, rank, C) > 0]


@pytest.mark.parametrize("D, rank", [(64, 64), (64, 40), (32, 32), (16, 64),
                                     (8, 8)])
@pytest.mark.parametrize("chains", [8, 1])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_rho_sampler_clusters_give_the_bits_of_one_cta(dev, D, rank, chains,
                                                       precision):
    """For every cluster C in {1, 2, 4, 8, 16} that divides the rank's
    column groups and that the card holds, the sampler's waveform is C=1's
    bit for bit, and each launch records its C (C=1 at D=64 and D=32
    takes the quad tile, at rank 40 with a column group of padding)."""
    p, cfg = _rho_params(dev, D, rank)
    noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(3),
                               chains, 300, 1.0)
    inputs = block.rho_sample_inputs(p, cfg, noise)
    sizes = _rho_sample_sizes(dev, D, rank)
    assert sizes[0] == 1 and len(sizes) > 1
    want = block.rho_sample_block(**inputs, precision=precision, cluster=1)
    torch.cuda.synchronize()
    assert torch.isfinite(want).all()
    for C in sizes[1:]:
        got = block.rho_sample_block(**inputs, precision=precision,
                                     cluster=C)
        torch.cuda.synchronize()
        assert block.rho_sample_block.cluster == C
        assert torch.equal(got, want), C


def test_rho_sampler_rule_and_smem_agree_with_the_kernels(dev):
    """The sampler's Python shared-memory counts and buffer choices are the
    kernel's own, every admitted C below 16 is resident; at the headline
    (D=64, rank 64) the rule takes 8 for 8 chains and, for one chain, 16
    where the card holds it (else 8) on an H100, and the launch records
    the rule's C; a cluster the rank's groups do not admit raises before
    any launch."""
    from audio_mps_tpu_torch.ops import _build
    lib = _build.library()
    optin = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    index = torch.cuda.current_device()
    for D, rank in ((8, 1), (8, 3), (16, 8), (64, 60), (64, 64)):
        for C in block.RHO_CLUSTERS:
            if -(-rank // 4) % C:
                continue
            for nbuf in (1, 2):
                assert lib.amt_rho_sample_smem_bytes(D, rank, C, nbuf) == \
                    block.rho_sample_smem_bytes(D, rank, C, nbuf)
            assert lib.amt_rho_sample_buffers(D, rank, C) == \
                block.rho_sample_buffers(D, rank, C, optin)
            if C < 16:
                assert block.rho_resident_clusters(index, "sample", D, rank,
                                                   C) > 0
    p, cfg = _rho_params(dev, 64, 64)
    props = torch.cuda.get_device_properties(dev)
    held16 = block.rho_resident_clusters(index, "sample", 64, 64, 16)
    for chains in (8, 1):
        noise = core._sample_noise(cfg, torch.Generator(dev).manual_seed(4),
                                   chains, 17, 1.0)
        block.rho_sample_block(**block.rho_sample_inputs(p, cfg, noise))
        torch.cuda.synchronize()
        want = block.rho_cluster_for(
            64, chains, 64, props.multi_processor_count,
            lambda c: block.rho_resident_clusters(index, "sample", 64, 64, c),
            optin, "sample")
        assert block.rho_sample_block.cluster == want
        if props.multi_processor_count == 132:
            assert want == (16 if chains == 1 and held16 > 0 else 8)
    s_in = block.rho_sample_inputs(*_rho_params(dev, 16, 12),
                                   torch.zeros(5, 2, device=dev))
    before = block.rho_sample_block.launches
    for cluster in (3, 8, 32):
        with pytest.raises(ValueError, match="column groups"):
            block.rho_sample_block(**s_in, cluster=cluster)
    torch.cuda.synchronize()
    assert block.rho_sample_block.launches == before


# ---------------------------------------------------------------------------
# psi's block kernels in the cluster layout (ops/cluster.py; csrc/
# psi_cluster*.cu): a column's rows over a thread-block cluster of C CTAs,
# D % 4 == 0 past the quad layout to 256; every C and G give the same bits
# ---------------------------------------------------------------------------

CLUSTER_DS = [72, 128, 256]
# steps of the cluster holds: past one 16-step block and a partial one
CL_STEPS = {"highest": 40, "high": 40, "default": 16}


def _cl_kw(inputs, precision, defer):
    return dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop(
        "norm_eps"), precision=precision, defer_norm=defer, unroll=16)


def _cl_sizes(D):
    """The clusters the layout takes at D whose CTAs fit the card."""
    from audio_mps_tpu_torch.ops import cluster as cl
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    return [C for C in cl.PSI_CLUSTERS if cl.cl_ok(D, C)
            and cl.psi_cluster_fwd_smem_bytes(D, C, 1) <= optin]


@pytest.mark.parametrize("D", CLUSTER_DS)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
def test_cluster_kernels_match_plain(dev, D, precision, defer):
    """The cluster layout's NLL, streamed and checkpoint forwards, tail and
    adjoint (with and without dtfin) against their plain versions at the
    rule's C and G, each counted by its own wrapper; the checkpoint
    recompute re-runs the stream bit for bit."""
    from audio_mps_tpu_torch.ops import cluster as cl
    inputs, g = _train_inputs(dev, D, CL_STEPS[precision], B=3)
    kw = _cl_kw(inputs, precision, defer)
    before = [w.launches for w in cl.WRAPPERS]
    fwd = block.psi_train_fwd_plain(**inputs, **kw)
    got = block.psi_train_fwd(**inputs, **kw)
    assert block.psi_train_fwd.layout == "cluster"
    for a, b in zip(got, fwd):
        _close(a, b, TOL[precision])
    assert torch.equal(block.psi_nll_block(**inputs, **kw), got[0])
    loss_ck, ck = block.psi_train_fwd_ckpt(**inputs, **kw)
    assert torch.equal(loss_ck, got[0])
    _close(ck, block.psi_train_fwd_ckpt_plain(**inputs, **kw)[1],
           TOL[precision])
    rk = {k: v for k, v in kw.items() if k != "log_eps"}
    ys, n2s = block.psi_recompute(inputs["ab"], inputs["bb"], inputs["rb"],
                                  ck, inputs["se"], **rk)
    assert torch.equal(ys, got[1]) and torch.equal(n2s, got[2])
    _, ys, n2s = fwd
    tail = block.psi_train_bwd_tail(inputs["rb"], inputs["se"], g, ys, n2s,
                                    **kw)
    for a, b in zip(tail, block.psi_train_bwd_tail_plain(
            inputs["rb"], inputs["se"], g, ys, n2s, **kw)):
        _close(a, b, TOL[precision])
    dtfin = 0.1 * torch.randn(inputs["t0"].shape, device=dev,
                              generator=torch.Generator(dev).manual_seed(7))
    for dt in (None, dtfin):
        bwd = block.psi_train_bwd_plain(**inputs, g=g, ys=ys, n2s=n2s,
                                        dtfin=dt, **kw)
        for a, b in zip(block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s,
                                            dtfin=dt, **kw), bwd):
            _close(a, b, TOL[precision])
    torch.cuda.synchronize()
    # nll, fwd, ckpt, recompute, tail (alone and in two adjoints), adjoint
    assert [w.launches - b for w, b in zip(cl.WRAPPERS, before)] == \
        [0, 1, 1, 1, 1, 3, 2]


@pytest.mark.parametrize("D", CLUSTER_DS)
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("defer", [False, True])
def test_cluster_sizes_and_columns_give_the_same_bits(dev, D, precision,
                                                      defer):
    """Every cluster C the card holds at D and every G in 1, 2, 4 that fits
    give one set of bits: the NLL, the streamed forward, the adjoint; the
    NLL's loss is the training forward's; the recompute's spans are the
    stream."""
    from audio_mps_tpu_torch.ops import cluster as cl
    inputs, g = _train_inputs(dev, D, 40, B=5)
    kw = _cl_kw(inputs, precision, defer)
    optin = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    ref = None
    for C in _cl_sizes(D):
        for G in cl.PSI_CLUSTER_COLS:
            if max(cl.psi_cluster_fwd_smem_bytes(D, C, G),
                   cl.psi_cluster_chain_smem_bytes(D, C, G)) > optin:
                continue
            o = dict(kw, _layout="cluster", _cluster=C, cols_per_cta=G)
            loss, ys, n2s = block.psi_train_fwd(**inputs, **o)
            nll = block.psi_nll_block(**inputs, **o)
            bwd = block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s, **o)
            torch.cuda.synchronize()
            assert torch.equal(nll, loss)
            got = (loss, ys, n2s) + tuple(bwd)
            if ref is None:
                ref = got
                _, ck = block.psi_train_fwd_ckpt(**inputs, **o)
                rk = {k: v for k, v in o.items() if k != "log_eps"}
                r_ys, r_n2s = block.psi_recompute(
                    inputs["ab"], inputs["bb"], inputs["rb"], ck,
                    inputs["se"], **rk)
                assert torch.equal(r_ys, ys) and torch.equal(r_n2s, n2s)
            else:
                for a, b in zip(got, ref):
                    assert torch.equal(a, b), (C, G)
    assert ref is not None


@pytest.mark.parametrize("D", [88, 128, 256])
@pytest.mark.parametrize("N", [1, 8])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_cluster_sampler_matches_plain(dev, D, N, precision):
    """The cluster sampler (psi_sample_body past D=80) against its plain
    version, and every cluster the card holds at D gives the rule's bits."""
    from audio_mps_tpu_torch.ops import cluster as cl
    assert block.psi_sample_body(D) == "cluster"
    inputs = _psi_sample_inputs(dev, D, N, STEPS[precision])
    before = cl.psi_sample_cluster.launches
    got = block.psi_sample_block(**inputs, precision=precision)
    torch.cuda.synchronize()
    assert cl.psi_sample_cluster.launches == before + 1
    assert cl.psi_sample_cluster.cluster == cl.psi_sample_cluster_for(D)
    _close(got, block.psi_sample_block_plain(**inputs, precision=precision),
           TOL[precision])
    optin = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    for C in cl.PSI_CLUSTERS:
        if cl.cl_ok(D, C) and cl.psi_cluster_sample_smem_bytes(D, C) <= optin:
            other = block.psi_sample_block(**inputs, precision=precision,
                                           _cluster=C)
            torch.cuda.synchronize()
            assert torch.equal(other, got), C


def test_cluster_rule_and_smem_agree_with_the_kernels(dev):
    """The cluster layout's Python byte counts and thread counts are the
    kernels' own; the rule takes the quad layout exactly where
    psi_block_fits holds and at D=128, B=128 on an H100 4 CTAs a cluster
    and 4 columns a cluster; D=260 and a forced quad layout past D=68 raise
    before any launch."""
    from audio_mps_tpu_torch.ops import _build, cluster as cl
    lib = _build.library()
    for D in (8, 12, 68, 72, 76, 128, 192, 252, 256):
        assert lib.amt_psi_cl_tail_smem_bytes(D) == \
            cl.psi_cluster_tail_smem_bytes(D)
        for C in cl.PSI_CLUSTERS:
            ok = cl.cl_ok(D, C)
            assert lib.amt_psi_cl_threads(D, C) == cl.cl_threads(D, C)
            assert lib.amt_psi_cl_sample_smem_bytes(D, C) == (
                cl.psi_cluster_sample_smem_bytes(D, C) if ok else 0)
            for G in cl.PSI_CLUSTER_COLS:
                assert lib.amt_psi_cl_fwd_smem_bytes(D, C, G) == (
                    cl.psi_cluster_fwd_smem_bytes(D, C, G) if ok else 0)
                assert lib.amt_psi_cl_chain_smem_bytes(D, C, G) == (
                    cl.psi_cluster_chain_smem_bytes(D, C, G) if ok else 0)
    props = torch.cuda.get_device_properties(dev)
    if props.multi_processor_count == 132:
        assert cl.psi_block_layout(128, 128, 132,
                                   props.shared_memory_per_block_optin) == \
            ("cluster", 4, 4)
    inputs, _ = _train_inputs(dev, 72, 8, B=2)
    kw = _cl_kw(inputs, "highest", True)
    before = [w.launches for w in cl.WRAPPERS] + list(_counts())
    with pytest.raises(NotImplementedError, match="quad layout"):
        block.psi_train_fwd(**inputs, **kw, _layout="quad")
    wide, _ = _train_inputs(dev, 260, 4, B=1)
    kw = _cl_kw(wide, "highest", True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        block.psi_nll_block(**wide, **kw)
    assert [w.launches for w in cl.WRAPPERS] + list(_counts()) == before


@pytest.mark.parametrize("D", [8, 68] + CLUSTER_DS)
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("B", [1, 3, 5])
def test_cluster_tail_symmetric_product_matches_plain(dev, D, precision,
                                                      defer, B):
    """The cluster tail, one tiled product u = S y with S = Rb + Rb^T (q =
    2 dehat u, ehat = y . u), against block.psi_train_bwd_tail_plain's two
    products at TOL, at lane counts (T-1) B that are not a multiple of the
    tile and at D whose rows are not whole slabs (8, 68: padded); two
    launches are the same bits, each counted by its wrapper."""
    from audio_mps_tpu_torch.ops import cluster as cl
    inputs, g = _train_inputs(dev, D, CL_STEPS[precision], B=B)
    kw = _cl_kw(inputs, precision, defer)
    _, ys, n2s = block.psi_train_fwd_plain(**inputs, **kw)
    args = (inputs["rb"], inputs["se"], g, ys, n2s)
    before = cl.psi_train_bwd_tail_cluster.launches
    got = cl.psi_train_bwd_tail_cluster(*args, **kw)
    again = cl.psi_train_bwd_tail_cluster(*args, **kw)
    torch.cuda.synchronize()
    assert cl.psi_train_bwd_tail_cluster.launches == before + 2
    for a, b, w in zip(got, again,
                       block.psi_train_bwd_tail_plain(*args, **kw)):
        assert torch.equal(a, b)
        _close(a, w, TOL[precision])


@pytest.mark.parametrize("D", [72, 128])
def test_cluster_tail_over_more_tiles_than_ctas(dev, D):
    """Past one wave of persistent CTAs (T=4097, B=7: 28672 lanes, 256
    tiles of 112 at D=72, 448 of 64 at D=128) every tile's outputs match
    the plain version at highest."""
    inputs, g = _train_inputs(dev, D, 4096, B=7)
    kw = _cl_kw(inputs, "highest", True)
    _, ys, n2s = block.psi_train_fwd_plain(**inputs, **kw)
    args = (inputs["rb"], inputs["se"], g, ys, n2s)
    from audio_mps_tpu_torch.ops import cluster as cl
    got = cl.psi_train_bwd_tail_cluster(*args, **kw)
    for a, w in zip(got, block.psi_train_bwd_tail_plain(*args, **kw)):
        _close(a, w, TOL["highest"])


@pytest.mark.parametrize("defer", [False, True])
def test_cluster_forward_refuses_a_cluster_without_room_for_a_loss_warp(
        dev, defer):
    """At D=64 forced into the cluster layout at one CTA a cluster (512 row
    threads: no room for the loss warp) the forward's wrappers raise before
    any launch; at two CTAs a cluster (which has the loss warp) the
    streamed forward matches plain, the NLL's loss is the forward's bit for
    bit and the checkpoint recompute is the stream."""
    from audio_mps_tpu_torch.ops import cluster as cl
    assert cl.cl_threads(64, 1) == cl.CL_THREADS
    assert cl.cl_ok(64, 1) and not cl.cl_fwd_ok(64, 1)
    inputs, _ = _train_inputs(dev, 64, 40, B=5)
    kw = _cl_kw(inputs, "highest", defer)
    rk = {k: v for k, v in kw.items() if k != "log_eps"}
    mats = (inputs["ab"], inputs["bb"], inputs["rb"])
    o = dict(_layout="cluster", _cluster=2)
    got = block.psi_train_fwd(**inputs, **kw, **o)
    nll = block.psi_nll_block(**inputs, **kw, **o)
    _, ck = block.psi_train_fwd_ckpt(**inputs, **kw, **o)
    ys, n2s = block.psi_recompute(*mats, ck, inputs["se"], **rk, **o)
    torch.cuda.synchronize()
    assert torch.equal(nll, got[0])
    assert torch.equal(ys, got[1]) and torch.equal(n2s, got[2])
    for a, w in zip(got, block.psi_train_fwd_plain(**inputs, **kw)):
        _close(a, w, TOL["highest"])
    before = [w.launches for w in cl.WRAPPERS]
    o = dict(_layout="cluster", _cluster=1)
    for call in (lambda: block.psi_train_fwd(**inputs, **kw, **o),
                 lambda: block.psi_nll_block(**inputs, **kw, **o),
                 lambda: block.psi_train_fwd_ckpt(**inputs, **kw, **o),
                 lambda: block.psi_recompute(*mats, ck, inputs["se"], **rk,
                                             **o)):
        with pytest.raises(ValueError, match="loss warp"):
            call()
    torch.cuda.synchronize()
    assert [w.launches for w in cl.WRAPPERS] == before


def test_cluster_tail_plans_agree_with_the_kernel(dev):
    """The tail's lanes a tile (ops/cluster.psi_cluster_tail_plan) are the
    kernel's own (amt_psi_cl_tail_lanes) at every even D to 256 and every
    precision."""
    from audio_mps_tpu_torch.ops import _build, cluster as cl
    lib = _build.library()
    for D in range(2, cl.PSI_CLUSTER_MAX_D + 1, 2):
        for i, p in enumerate(block.PRECISIONS):
            assert lib.amt_psi_cl_tail_lanes(D, i) == \
                cl.psi_cluster_tail_plan(D, p)["nl"], (D, p)


def test_cotangents_at_d128_match_plain_bit_for_bit_twice(dev):
    """psi_cotangents (csrc/psi_cotangents.cu, tiled for any D) at D=128:
    against its plain version, and two launches equal bit for bit."""
    inputs, g = _train_inputs(dev, 128, 40, B=4)
    kw = _cl_kw(inputs, "highest", True)
    _, ys, n2s = block.psi_train_fwd_plain(**inputs, **kw)
    _, _, dy, dehat = block.psi_train_bwd_plain(**inputs, g=g, ys=ys,
                                                n2s=n2s, **kw)
    ck = dict(norm_eps=kw["norm_eps"], precision="highest", defer_norm=True,
              unroll=16)
    cot = (dy, ys, inputs["t0"], inputs["se"], n2s, dehat)
    got = block.psi_cotangents(*cot, **ck)
    again = block.psi_cotangents(*cot, **ck)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, block.psi_cotangents_plain(*cot, **ck)):
        assert torch.equal(a, b)
        _close(a, w, 1e-5)


@pytest.mark.parametrize("stream", ["on", "off"])
def test_cluster_train_path_at_d128(dev, stream):
    """One value-and-gradient of the training NLL at D=128 on the card,
    streamed and with kernel_stream="off", runs through the cluster
    kernels and matches the plain path (the same call on CPU copies)."""
    from audio_mps_tpu_torch.ops import cluster as cl
    from audio_mps_tpu_torch.weights import (psi_params_from_numpy,
                                             psi_params_to_numpy)
    cfg = CMPSConfig(bond_dim=128, minibatch_size=4, kernel_stream=stream)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    sig = damped_sine_batch(torch.Generator(dev).manual_seed(1), 4, 97,
                            cfg.delta_t)
    before = [w.launches for w in cl.WRAPPERS]
    loss = block.psi_nll_block_trainable(p, cfg, sig, defer_norm=True)
    loss.backward()
    torch.cuda.synchronize()
    ran = [w.launches - b for w, b in zip(cl.WRAPPERS, before)]
    # (sampler, nll, fwd, ckpt, recompute, tail, adjoint)
    assert ran[2:] == ([1, 0, 0, 1, 1] if stream == "on" else
                       [0, 1, ran[4], ran[5], ran[6]])
    assert stream == "on" or ran[4] == ran[6] >= 1
    q = psi_params_from_numpy(psi_params_to_numpy(p), "cpu")
    want = block.psi_nll_block_trainable(q, cfg, sig.cpu(), defer_norm=True)
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-4 * abs(want.item())
    for name in q.NAMES:
        _close(getattr(p, name).grad.cpu(), getattr(q, name).grad, 1e-3)


def test_cluster_kernels_index_past_2_pow_31_elements(dev):
    """At D=72, B=1024, T=16385 a [n_steps, 2D, B] stream holds 2.4e9
    elements (9.7 GB): the last column of the cluster forward and adjoint
    over all columns equals, bit for bit, a launch over that column alone
    (every column's arithmetic is its own at any G)."""
    cfg = CMPSConfig(bond_dim=72)
    p = init_psi(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    n_steps, cols = 16384, 1024
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
    assert block.psi_train_fwd.layout == "cluster"
    a_loss, a_ys, a_n2s = block.psi_train_fwd(**alone, **kw)
    assert torch.equal(last(loss), a_loss) and torch.equal(last(ys), a_ys)
    bwd = block.psi_train_bwd(**inputs, g=g, ys=ys, n2s=n2s, **kw)
    a_bwd = block.psi_train_bwd(**alone, g=g[-1:], ys=a_ys, n2s=a_n2s, **kw)
    torch.cuda.synchronize()
    for a, b in zip(bwd, a_bwd):
        assert torch.isfinite(b).all() and torch.equal(last(a), b)
