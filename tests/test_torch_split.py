"""The port's split-layout psi kernels (audio_mps_tpu_torch/ops/split.py: the
plain versions of csrc/psi_split_*.cu) against the JAX package's split
kernels in Pallas interpret mode, on the same numpy inputs, on the CPU:
the forward-only NLL (pallas_scan._make_psi_nll_kernel), the sampler
(pallas_scan._make_psi_sample_kernel), and the training pair of
pallas_grad._psi_fused_nll_factory (forward, and both adjoints through
jax.vjp). D=6 and D=10 (no multiple of 4: the layouts' rule sends them to
split) and D=8 asked for with layout="split"; B=3, T=67: the 66 steps end
in a ragged block of 2 at unroll 16."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from audio_mps_tpu import config as jconfig
from audio_mps_tpu import training as jtraining
from audio_mps_tpu.models import core as jcore
from audio_mps_tpu.models.cell import make_constants as jmake_constants
from audio_mps_tpu.ops import pallas_grad as jgrad
from audio_mps_tpu.ops import pallas_scan as jscan
from audio_mps_tpu.ops.pallas_scan import _full, _pad_rows
from audio_mps_tpu_torch import training
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.models.params import PsiParams
from audio_mps_tpu_torch.ops import grad, scan, split
from audio_mps_tpu_torch.weights import psi_params_from_numpy
from test_torch_core import both, np_params, np_signals

B, T, UNROLL = 3, 67, 16
NAMES = PsiParams.NAMES
# tests/test_torch_train.py's tolerances: values rtol 1e-5, gradients and
# cotangents max-rel 1e-4 (the JAX kernels against jax.grad of the XLA
# scan, tests/test_pallas_grad.py:28-29)
VALUE_RTOL, GRAD_REL = 1e-5, 1e-4
# the sampler's waveform and the training forward's checkpoints: the same
# fp32 steps in another summation order, 1e-5 of the largest element
STATE_REL = 1e-5
# (D, layout): the layouts' rule sends D=6 and D=10 to split; D=8 asks
SHAPES = [(6, None), (10, None), (8, "split")]


def configs(D, layout=None, **kw):
    base = dict(minibatch_size=B, bond_dim=D, scan_chunk=0,
                kernel_layout=layout or "auto")
    base.update(kw)
    return CMPSConfig(**base), jconfig.CMPSConfig(**base)


def max_rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def jax_split_inputs(jp, jhp, sig):
    """(cr, ci, rr, ri, pc, ps [D,1], s0r, s0i [D,B], se [t_pad, B]) as
    pallas_grad.psi_nll_pallas_trainable builds them."""
    cc = jmake_constants(jp, jhp)
    D = jhp.bond_dim
    n_steps = sig.shape[1] - 1
    t_pad = -(-n_steps // UNROLL) * UNROLL
    incs = (sig[:, 1:] - sig[:, :-1]).T / cc.A
    pr0, pi0 = jcore.psi0(jp, jhp)
    return (cc.Cr, cc.Ci, cc.Rr, cc.Ri, cc.p_c[:, None], cc.p_s[:, None],
            jnp.broadcast_to(pr0[:, None], (D, B)),
            jnp.broadcast_to(pi0[:, None], (D, B)), _pad_rows(incs, t_pad))


def jax_split_fwd(jhp, ins, defer):
    """(loss [B], ckr, cki [n_blocks, D, B]): the forward pallas_call of
    _psi_fused_nll_factory (pallas_grad.py:500-529) on its kernel
    _make_psi_fwd_kernel, in interpret mode."""
    D = jhp.bond_dim
    se = ins[-1]
    n_blocks = se.shape[0] // UNROLL
    kernel = jgrad._make_psi_fwd_kernel(jhp, UNROLL, T - 1, "highest", defer)
    loss, ckr, cki = pl.pallas_call(
        kernel, grid=(n_blocks,),
        in_specs=[pl.BlockSpec((1, UNROLL, B), lambda i: (i, 0, 0)),
                  _full((D, B)), _full((D, B)),
                  _full((D, D)), _full((D, D)), _full((D, D)), _full((D, D)),
                  _full((D, 1)), _full((D, 1))],
        out_specs=[pl.BlockSpec((1, 1, B), lambda i: (i, 0, 0)),
                   pl.BlockSpec((1, D, B), lambda i: (i, 0, 0)),
                   pl.BlockSpec((1, D, B), lambda i: (i, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((n_blocks, 1, B), jnp.float32),
                   jax.ShapeDtypeStruct((n_blocks, D, B), jnp.float32),
                   jax.ShapeDtypeStruct((n_blocks, D, B), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((D, B), jnp.float32),
                        pltpu.VMEM((D, B), jnp.float32),
                        pltpu.VMEM((1, B), jnp.float32)],
        interpret=True,
    )(se.reshape(n_blocks, UNROLL, B), ins[6], ins[7], *ins[:6])
    return loss[-1, 0], ckr, cki


def kernel_args(hp, tp, sig):
    """The tensor inputs of psi_nll_split / psi_split_fwd for waveforms
    sig, in order, and the options."""
    inputs = split.psi_split_inputs(tp, hp, torch.as_tensor(sig))
    names = ("cr", "ci", "rr", "ri", "pc", "ps", "s0r", "s0i", "se")
    return ([inputs[k] for k in names],
            dict(log_eps=inputs["log_eps"], norm_eps=inputs["norm_eps"],
                 unroll=UNROLL))


@pytest.mark.parametrize("D, layout, defer", [
    (6, None, False), (6, None, True), (10, None, False), (10, None, True),
    (8, "split", True)])
def test_nll_matches_jax_split_kernel(D, layout, defer):
    """scan.psi_nll_fused in the split layout (psi_nll_split_plain on the
    CPU) against pallas_scan.psi_nll_pallas(layout="split"): the mean
    loss, and the per-example losses against the training forward's."""
    hp, jhp = configs(D, layout)
    jp, tp = both(np_params(D))
    sig = np_signals(B, T)
    assert scan._nll_layout(hp, None) == "split"
    want = float(jscan.psi_nll_pallas(jp, jhp, jnp.asarray(sig),
                                      interpret=True, defer_norm=defer,
                                      layout="split"))
    got = scan.psi_nll_fused(tp, hp, torch.as_tensor(sig), defer_norm=defer)
    np.testing.assert_allclose(got.item(), want, rtol=VALUE_RTOL)
    args, kw = kernel_args(hp, tp, sig)
    per_example = split.psi_nll_split(*args, **kw, defer_norm=defer)
    assert per_example.shape == (B,)
    loss, _, _ = split.psi_split_fwd(*args, **kw, defer_norm=defer)
    assert torch.equal(per_example, loss)


@pytest.mark.parametrize("D, layout", SHAPES)
def test_sampler_matches_jax_split_kernel(D, layout):
    """scan.psi_sample_fused in the split layout (psi_sample_split_plain on
    the CPU) against pallas_scan.psi_sample_pallas(layout="split") on the
    same noise: the waveform to 1e-5 of max|JAX|. A sampler at D % 8 != 0
    resolves to split even when block is asked for, with a warning."""
    hp, jhp = configs(D, layout)
    jp, tp = both(np_params(D))
    noise = (1e-3 * np.random.default_rng(5).standard_normal((T, B))
             ).astype(np.float32)
    want = np.asarray(jscan.psi_sample_pallas(jp, jhp, jnp.asarray(noise),
                                              interpret=True, layout="split"))
    got = scan.psi_sample_fused(tp, hp, torch.as_tensor(noise))
    assert got.shape == (B, T)
    assert max_rel(got, want) <= STATE_REL
    if D % 8:
        with pytest.warns(UserWarning, match="split"):
            again = scan.psi_sample_fused(tp, hp, torch.as_tensor(noise),
                                          layout="block")
        assert torch.equal(again, got)


@pytest.mark.parametrize("D, layout, defer", [(10, None, True),
                                              (6, None, False),
                                              (8, "split", True)])
def test_training_forward_matches_jax(D, layout, defer):
    """psi_split_fwd_plain against the forward of _psi_fused_nll_factory
    (_make_psi_fwd_kernel): per-example losses rtol 1e-5, the block-entry
    checkpoints (5 blocks, the last entering the ragged one) to 1e-5."""
    hp, jhp = configs(D, layout)
    jp, tp = both(np_params(D))
    sig = np_signals(B, T)
    jl, jckr, jcki = jax_split_fwd(jhp, jax_split_inputs(jp, jhp,
                                                         jnp.asarray(sig)),
                                   defer)
    args, kw = kernel_args(hp, tp, sig)
    loss, ckr, cki = split.psi_split_fwd(*args, **kw, defer_norm=defer)
    assert ckr.shape == (5, D, B)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=VALUE_RTOL)
    assert max_rel(ckr, jckr) <= STATE_REL
    assert max_rel(cki, jcki) <= STATE_REL


@pytest.mark.parametrize("D, layout, defer", [(10, None, True),
                                              (8, "split", False)])
def test_adjoint_matches_jax_vjp(D, layout, defer):
    """psi_split_bwd_plain, fed the plain forward's checkpoints, against
    jax.vjp of _psi_fused_nll_factory's fused (the adjoint
    _make_psi_bwd_kernel_defer :320 or _make_psi_bwd_kernel :172) with a
    non-uniform per-example g: all nine cotangents to max-rel 1e-4, dse on
    the real rows."""
    hp, jhp = configs(D, layout)
    jp, tp = both(np_params(D))
    sig = np_signals(B, T)
    fused = jgrad._psi_fused_nll_factory(jhp, B, T, UNROLL, True, "highest",
                                         defer)
    g = np.linspace(0.5, 1.5, B).astype(np.float32)
    jl, vjp = jax.vjp(fused, *jax_split_inputs(jp, jhp, jnp.asarray(sig)))
    want = vjp(jnp.asarray(g))
    args, kw = kernel_args(hp, tp, sig)
    loss, ckr, cki = split.psi_split_fwd(*args, **kw, defer_norm=defer)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=VALUE_RTOL)
    (dse, dcr, dci, drr, dri, dpc, dps, dp0r, dp0i) = split.psi_split_bwd(
        *args[:6], args[8], torch.as_tensor(g), ckr, cki, **kw,
        defer_norm=defer)
    got = (dcr, dci, drr, dri, dpc[:, None], dps[:, None], dp0r, dp0i, dse)
    names = ("dcr", "dci", "drr", "dri", "dpc", "dps", "dp0r", "dp0i", "dse")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)[:T - 1] if name == "dse" else b
        assert a.shape == np.asarray(b).shape, name
        assert max_rel(a, b) < GRAD_REL, name


def test_trainable_value_and_grads_match_jax():
    """grad.psi_nll_fused_trainable (PsiSplitNLL over the plain versions)
    against pallas_grad.psi_nll_pallas_trainable(layout="split") at the
    estimator's D=10 with the deferred norm: the loss rtol 1e-5 and the six
    parameter gradients max-rel 1e-4. (The adjoint's other cases are held
    cotangent by cotangent in test_adjoint_matches_jax_vjp.)"""
    D, defer = 10, True
    hp, jhp = configs(D)
    d = np_params(D)
    sig = np_signals(B, T)
    tp = psi_params_from_numpy(d, "cpu")
    loss = grad.psi_nll_fused_trainable(tp, hp, torch.as_tensor(sig),
                                        unroll=UNROLL, defer_norm=defer)
    loss.backward()
    jp, _ = both(d)
    want, gwant = jax.value_and_grad(
        lambda p: jgrad.psi_nll_pallas_trainable(
            p, jhp, jnp.asarray(sig), unroll=UNROLL, interpret=True,
            defer_norm=defer, layout="split"))(jp)
    np.testing.assert_allclose(loss.item(), float(want), rtol=VALUE_RTOL)
    for k in NAMES:
        assert max_rel(getattr(tp, k).grad, getattr(gwant, k)) < GRAD_REL, k


def test_high_precision_refused_in_training_and_scoring():
    """The split layout has no bf16x3: training and scoring at high raise
    ValueError (pallas_grad.py:722-725, pallas_scan.py:239-242); the
    sampler warns and runs highest (pallas_scan.py:601-606), the same
    waveform bit for bit. So does the default precision of a block-trained
    model (kernel_precision="high") sampled at D=12."""
    hp, _ = configs(10)
    tp = psi_params_from_numpy(np_params(10), "cpu")
    sig = torch.as_tensor(np_signals(B, T))
    with pytest.raises(ValueError, match="block kernel layout"):
        grad.psi_nll_fused_trainable(tp, hp, sig, precision="high")
    with pytest.raises(ValueError, match="block kernel layout"):
        scan.psi_nll_fused(tp, hp, sig, precision="high")
    args, kw = kernel_args(hp, tp, sig)
    with pytest.raises(ValueError):
        split.psi_split_fwd(*args, **kw, precision="high")
    noise = torch.as_tensor((1e-3 * np.random.default_rng(5).standard_normal(
        (T, B))).astype(np.float32))
    want = scan.psi_sample_fused(tp, hp, noise, precision="highest")
    with pytest.warns(UserWarning, match="high"):
        got = scan.psi_sample_fused(tp, hp, noise, precision="high")
    assert torch.equal(got, want)
    hp12 = dataclasses.replace(hp, bond_dim=12, kernel_precision="high")
    t12 = psi_params_from_numpy(np_params(12), "cpu")
    with pytest.warns(UserWarning, match="high"):
        got = scan.psi_sample_fused(t12, hp12, noise)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(got, scan.psi_sample_fused(t12, hp12, noise,
                                                      precision="highest"))


def test_three_adam_steps_match_jax():
    """Three Adam steps of training.make_train_step(..., fused=True) at D=10
    (PsiSplitNLL over the plain split versions) against JAX's
    make_train_step("psi_mps", cfg, fused=True) (its split kernels in
    interpret mode), from the same parameters on the same numpy batches:
    every metric rtol 1e-5 and every parameter max-rel 1e-5 after each
    step, as tests/test_torch_train.py holds the block path."""
    hp, jhp = configs(10)
    d = np_params(10)
    tp = psi_params_from_numpy(d, "cpu")
    _, step = training.make_train_step("psi_mps", hp, tp, fused=True,
                                       device="cpu")
    jp, _ = both(d)
    _, jstep = jtraining.make_train_step("psi_mps", jhp, fused=True)
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
