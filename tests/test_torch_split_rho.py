"""The port's split-layout rho kernels (audio_mps_tpu_torch/ops/split.py:
the plain versions of csrc/rho_split_*.cu) against the JAX package's split
kernels in Pallas interpret mode, on the same numpy inputs, on the CPU:
the forward-only NLL (pallas_scan._make_rho_nll_kernel), the sampler
(pallas_scan._make_rho_sample_kernel), and the training pair of
pallas_grad._rho_fused_nll_factory (forward, and both adjoints through
jax.vjp), then the training path and three Adam steps. D=6 (no multiple of
4: the layouts' rule sends it to split) at rank 3 and at full rank 6, D=4
for the sampler (no multiple of 8), B=3, T=67: the 66 steps end in a
ragged block of 2 at unroll 4 (the JAX kernels statically unroll a block,
so a short one keeps their interpret-mode compiles to seconds)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from audio_mps_tpu import training as jtraining
from audio_mps_tpu.models.cell import make_constants as jmake_constants
from audio_mps_tpu.ops import pallas_grad as jgrad
from audio_mps_tpu.ops import pallas_scan as jscan
from audio_mps_tpu.ops.pallas_scan import _full, _pad_rows
from audio_mps_tpu_torch import training
from audio_mps_tpu_torch.models.params import RhoParams
from audio_mps_tpu_torch.ops import grad, scan, split
from audio_mps_tpu_torch.weights import rho_params_from_numpy
from test_torch_core import np_signals
from test_torch_rho import np_noise, np_rho_params, rho_both, rho_configs
from test_torch_split import GRAD_REL, STATE_REL, VALUE_RTOL, max_rel

B, T, UNROLL = 3, 67, 4
NAMES = RhoParams.NAMES
# the sampler's waveform: the same fp32 steps in another summation order
# (test_torch_rho.py holds the block sampler so)
SAMPLE_RTOL = 2e-5


def kernel_args(hp, tp, sig):
    """The tensor inputs of rho_nll_split / rho_split_fwd for waveforms
    sig, in order, and the options."""
    inputs = split.rho_split_inputs(tp, hp, torch.as_tensor(sig))
    return ([inputs[k] for k in split.RHO_SPLIT_NAMES + ("se",)],
            dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
                 unroll=UNROLL))


def jax_split_inputs(jp, jhp, sig):
    """The inputs of _rho_fused_nll_factory's fused, as
    pallas_grad.rho_nll_pallas_trainable builds them (se repeated over the
    rank lanes and padded to whole blocks)."""
    cc = jmake_constants(jp, jhp)
    rank = jp.Wx.shape[0]
    n_steps = sig.shape[1] - 1
    t_pad = -(-n_steps // UNROLL) * UNROLL
    incs = (sig[:, 1:] - sig[:, :-1]).T / cc.A
    se = jnp.repeat(_pad_rows(incs, t_pad), rank, axis=1)
    h0r, h0i, zmat = jscan.rho_factor_inputs(jp, jhp, B)
    return (cc.Cr, -cc.Ci, cc.Rr, -cc.Ri, cc.Xr.T, cc.Xi.T,
            cc.p_c[:, None], cc.p_s[:, None], h0r, h0i, se, zmat, zmat.T)


def jax_split_fwd(jhp, rank, ins, defer):
    """(loss [B], ckr, cki [n_blocks, D, B * rank]): the forward
    pallas_call of _rho_fused_nll_factory (pallas_grad.py:1224-1254) on
    its kernel _make_rho_fwd_kernel, in interpret mode."""
    D = jhp.bond_dim
    BR = B * rank
    se = ins[10]
    n_blocks = se.shape[0] // UNROLL
    kernel = jgrad._make_rho_fwd_kernel(jhp, UNROLL, T - 1, rank, "highest",
                                        defer)
    loss, ckr, cki = pl.pallas_call(
        kernel, grid=(n_blocks,),
        in_specs=[pl.BlockSpec((1, UNROLL, BR), lambda i: (i, 0, 0)),
                  _full((D, BR)), _full((D, BR))]
        + [_full((D, D))] * 6 + [_full((D, 1))] * 2
        + [_full((BR, B)), _full((B, BR))],
        out_specs=[pl.BlockSpec((1, 1, B), lambda i: (i, 0, 0)),
                   pl.BlockSpec((1, D, BR), lambda i: (i, 0, 0)),
                   pl.BlockSpec((1, D, BR), lambda i: (i, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((n_blocks, 1, B), jnp.float32),
                   jax.ShapeDtypeStruct((n_blocks, D, BR), jnp.float32),
                   jax.ShapeDtypeStruct((n_blocks, D, BR), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((D, BR), jnp.float32),
                        pltpu.VMEM((D, BR), jnp.float32),
                        pltpu.VMEM((1, BR), jnp.float32)],
        interpret=True,
    )(se.reshape(n_blocks, UNROLL, BR), ins[8], ins[9], *ins[:8], ins[11],
      ins[12])
    return loss[-1, 0], ckr, cki


@pytest.mark.parametrize("D, rank, layout, defer", [
    (6, 3, None, False), (6, 3, None, True), (6, 6, None, True),
    (8, 3, "split", False)])
def test_nll_matches_jax_split_kernel(D, rank, layout, defer):
    """scan.rho_nll_fused in the split layout (rho_nll_split_plain on the
    CPU) against pallas_scan.rho_nll_pallas(layout="split"): the mean loss
    rtol 1e-5, and the per-example losses equal the training forward's."""
    hp, jhp = rho_configs(D=D, rank=rank, kernel_layout=layout or "auto")
    jp, tp = rho_both(np_rho_params(D, rank))
    sig = np_signals(B, T)
    assert scan._nll_layout(hp, None) == "split"
    want = float(jscan.rho_nll_pallas(jp, jhp, jnp.asarray(sig),
                                      unroll=UNROLL, interpret=True,
                                      defer_norm=defer, layout="split"))
    got = scan.rho_nll_fused(tp, hp, torch.as_tensor(sig), unroll=UNROLL,
                             defer_norm=defer)
    np.testing.assert_allclose(got.item(), want, rtol=VALUE_RTOL)
    args, kw = kernel_args(hp, tp, sig)
    per_example = split.rho_nll_split(*args, **kw, defer_norm=defer)
    assert per_example.shape == (B,)
    loss, _, _ = split.rho_split_fwd(*args, **kw, defer_norm=defer)
    assert torch.equal(per_example, loss)


@pytest.mark.parametrize("D, rank", [(4, 3), (6, 6)])
def test_sampler_matches_jax_split_kernel(D, rank):
    """scan.rho_sample_fused in the split layout (rho_sample_split_plain on
    the CPU) against pallas_scan.rho_sample_pallas(layout="split") on the
    same noise, rtol 2e-5 of max|JAX|; at D % 8 != 0 an explicit "block"
    resolves to split with a warning, the same waveform."""
    hp, jhp = rho_configs(D=D, rank=rank)
    jp, tp = rho_both(np_rho_params(D, rank))
    noise = np_noise(2, length=T)
    want = np.asarray(jscan.rho_sample_pallas(jp, jhp, jnp.asarray(noise),
                                              unroll=UNROLL, interpret=True,
                                              layout="split"))
    got = scan.rho_sample_fused(tp, hp, torch.as_tensor(noise))
    assert got.shape == (2, T)
    assert max_rel(got, want) <= SAMPLE_RTOL
    with pytest.warns(UserWarning, match="split"):
        again = scan.rho_sample_fused(tp, hp, torch.as_tensor(noise),
                                      layout="block")
    assert torch.equal(again, got)


@pytest.mark.parametrize("rank, defer", [(3, True), (6, False)])
def test_training_forward_matches_jax(rank, defer):
    """rho_split_fwd_plain against the forward of _rho_fused_nll_factory
    (_make_rho_fwd_kernel) at D=6: per-example losses rtol 1e-5, the
    block-entry checkpoints (17 blocks, the last entering the ragged one)
    to 1e-5 of their largest element."""
    D = 6
    hp, jhp = rho_configs(D=D, rank=rank)
    jp, tp = rho_both(np_rho_params(D, rank))
    sig = np_signals(B, T)
    jl, jckr, jcki = jax_split_fwd(jhp, rank, jax_split_inputs(
        jp, jhp, jnp.asarray(sig)), defer)
    args, kw = kernel_args(hp, tp, sig)
    loss, ckr, cki = split.rho_split_fwd(*args, **kw, defer_norm=defer)
    assert ckr.shape == (17, D, B * rank)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=VALUE_RTOL)
    assert max_rel(ckr, jckr) <= STATE_REL
    assert max_rel(cki, jcki) <= STATE_REL


@pytest.mark.parametrize("rank, defer", [(3, True), (6, False)])
def test_adjoint_matches_jax_vjp(rank, defer):
    """rho_split_bwd_plain, fed the plain forward's checkpoints, against
    jax.vjp of _rho_fused_nll_factory's fused (the adjoint
    _make_rho_bwd_kernel_defer :1032 or _make_rho_bwd_kernel :879) at D=6
    for the mean loss (g = 1/B an example): all eleven cotangents to
    max-rel 1e-4; JAX's dse summed over each example's rank lanes, on the
    real rows."""
    D = 6
    hp, jhp = rho_configs(D=D, rank=rank)
    jp, tp = rho_both(np_rho_params(D, rank))
    sig = np_signals(B, T)
    fused = jgrad._rho_fused_nll_factory(jhp, B, T, rank, UNROLL, True,
                                         "highest", defer)
    jl, vjp = jax.vjp(fused, *jax_split_inputs(jp, jhp, jnp.asarray(sig)))
    want = vjp(jnp.float32(1.0))
    args, kw = kernel_args(hp, tp, sig)
    loss, ckr, cki = split.rho_split_fwd(*args, **kw, defer_norm=defer)
    np.testing.assert_allclose(loss.mean().item(), float(jl), rtol=VALUE_RTOL)
    got = split.rho_split_bwd(*args[:8], args[10], torch.full((B,), 1.0 / B),
                              ckr, cki, **kw, defer_norm=defer)
    jdse = np.asarray(want[10]).reshape(-1, B, rank).sum(-1)[:T - 1]
    wanted = (jdse,) + tuple(want[:6]) + (want[6][:, 0], want[7][:, 0],
                                          want[8], want[9])
    names = ("dse", "dccr", "dcci", "drcr", "drci", "dxtr", "dxti", "dpc",
             "dps", "dh0r", "dh0i")
    for name, a, b in zip(names, got, wanted):
        assert a.shape == np.asarray(b).shape, name
        assert max_rel(a, b) < GRAD_REL, name


@pytest.mark.parametrize("rank", [3, 6])
def test_trainable_value_and_grads_match_jax(rank):
    """grad.rho_nll_fused_trainable (RhoSplitNLL over the plain versions)
    against pallas_grad.rho_nll_pallas_trainable(layout="split") at D=6
    with the deferred norm: the loss rtol 1e-5 and the six parameter
    gradients max-rel 1e-4."""
    D = 6
    hp, jhp = rho_configs(D=D, rank=rank)
    d = np_rho_params(D, rank)
    sig = np_signals(B, T)
    tp = rho_params_from_numpy(d, "cpu")
    loss = grad.rho_nll_fused_trainable(tp, hp, torch.as_tensor(sig),
                                        unroll=UNROLL, defer_norm=True)
    loss.backward()
    jp, _ = rho_both(d)
    want, gwant = jax.value_and_grad(
        lambda p: jgrad.rho_nll_pallas_trainable(
            p, jhp, jnp.asarray(sig), unroll=UNROLL, interpret=True,
            defer_norm=True, layout="split"))(jp)
    np.testing.assert_allclose(loss.item(), float(want), rtol=VALUE_RTOL)
    for k in NAMES:
        assert max_rel(getattr(tp, k).grad, getattr(gwant, k)) < GRAD_REL, k


def test_three_adam_steps_match_jax(monkeypatch):
    """Three Adam steps of training.make_train_step("rho_mps", fused=True)
    at D=6, rank 3 (nll_fn_for's kernel path: RhoSplitNLL over the plain
    split versions) against JAX's make_train_step("rho_mps", cfg,
    fused=True) (its split kernels in interpret mode), from the same
    parameters on the same numpy batches: every metric rtol 1e-5 and every
    parameter max-rel 1e-5 after each step. JAX's kernels run at unroll 4
    (its auto_unroll pinned here); the port at its default 16: the deferred
    norm renormalises at other steps, the same value up to rounding."""
    monkeypatch.setattr(jgrad, "auto_unroll", lambda D, cols, unroll: UNROLL)
    hp, jhp = rho_configs(D=6, rank=3)
    d = np_rho_params(6, 3)
    tp = rho_params_from_numpy(d, "cpu")
    _, step = training.make_train_step("rho_mps", hp, tp, fused=True,
                                       device="cpu")
    jp, _ = rho_both(d)
    _, jstep = jtraining.make_train_step("rho_mps", jhp, fused=True)
    state = jtraining.make_optimizer(jhp).init(jp)
    for seed in (1, 2, 3):
        batch = np_signals(B, T, seed=seed)
        jp, state, jm = jstep(jp, state, jnp.asarray(batch))
        tm = step(torch.as_tensor(batch))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        for k in NAMES:
            assert max_rel(getattr(tp, k), getattr(jp, k)) < 1e-5, k


def test_high_refused_and_block_layout_raises():
    """The split layout has no bf16x3: rho training and scoring at high
    raise ValueError (pallas_grad.py:1351-1354, pallas_scan.py:424-427);
    the sampler warns and runs highest (pallas_scan.py:739-743), the same
    waveform bit for bit. An explicit layout="block" at D=6 raises
    in scoring (the block layout needs D % 4 == 0) and NotImplementedError
    in training (no block kernel, monolithic or rank-chunked, takes it)."""
    hp, _ = rho_configs(D=6, rank=3)
    tp = rho_params_from_numpy(np_rho_params(6, 3), "cpu")
    sig = torch.as_tensor(np_signals(B, T))
    with pytest.raises(ValueError, match="block kernel layout"):
        grad.rho_nll_fused_trainable(tp, hp, sig, precision="high")
    with pytest.raises(ValueError, match="block kernel layout"):
        scan.rho_nll_fused(tp, hp, sig, precision="high")
    args, kw = kernel_args(hp, tp, sig)
    with pytest.raises(ValueError):
        split.rho_split_fwd(*args, **kw, precision="high")
    with pytest.raises(ValueError):
        scan.rho_nll_fused(tp, hp, sig, layout="block")
    with pytest.raises(NotImplementedError):
        grad.rho_nll_fused_trainable(tp, hp, sig, layout="block")
    noise = torch.as_tensor(np_noise(2, length=T))
    want = scan.rho_sample_fused(tp, hp, noise, precision="highest")
    with pytest.warns(UserWarning, match="high"):
        got = scan.rho_sample_fused(tp, hp, noise, precision="high")
    assert torch.equal(got, want)
    hp12 = dataclasses.replace(hp, bond_dim=12, kernel_precision="high")
    t12 = rho_params_from_numpy(np_rho_params(12, 3), "cpu")
    with pytest.warns(UserWarning, match="high"):
        scan.rho_sample_fused(t12, hp12, noise)
