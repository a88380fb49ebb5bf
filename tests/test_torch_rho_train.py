"""The port's rho training path (audio_mps_tpu_torch: ops/block.py
RhoBlockNLL and its plain kernel versions, the rho_mps training dispatch,
the train CLI) against the JAX package on the same numpy inputs, on the
CPU. The JAX block kernels run in Pallas interpret mode. D=8, B=3, ranks 3
and 8, T=83: T-1 = 82 is a multiple of neither unroll 16 nor 5, so the
TPU's zero-padded last block is exercised against the port's loop over
the real steps."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import training as jtraining
from audio_mps_tpu.models import core as jcore
from audio_mps_tpu.models.cell import make_constants as jmake_constants
from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu.ops.pallas_scan import _pad_rows
from audio_mps_tpu_torch import training
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.models.params import RhoParams
from audio_mps_tpu_torch.ops import block
from audio_mps_tpu_torch.train import parse_args, train
from audio_mps_tpu_torch.weights import (adam_state_from_numpy, load_params,
                                         rho_params_from_numpy)
from test_torch_core import np_signals
from test_torch_rho import np_rho_params, rho_both, rho_configs
from test_torch_train import GRAD_REL, VALUE_RTOL, max_rel

T = 83
B = 3
NAMES = RhoParams.NAMES
# value rtol 1e-5 and gradient max-rel 1e-4 as for psi (test_torch_train.py).
# At "high" the JAX kernels take their rank segment sums as two bf16 passes
# of a hi/lo split (pallas_block _make_seg_dot, ~2^-17 a term) where the
# port sums in fp32, so the value is held at rtol 1e-4 there, as the
# forward NLL at "high" (test_torch_rho.py).
VALUE_RTOL_HIGH = 1e-4


def port_value_and_grads(fn, d):
    """(value, {name: grad}) of fn(params) on fresh port params from d."""
    tp = rho_params_from_numpy(d, "cpu")
    loss = fn(tp)
    loss.backward()
    return loss.item(), {k: getattr(tp, k).grad for k in NAMES}


@pytest.fixture(scope="module")
def xla_reference():
    """jax.value_and_grad of the XLA factor scan core.rho_nll_factor, per
    rank, on the shared draw."""
    out = {}
    for rank in (3, 8):
        _, jhp = rho_configs(rank=rank)
        jp, _ = rho_both(np_rho_params(8, rank))
        v, g = jax.value_and_grad(jcore.rho_nll_factor)(
            jp, jhp, jnp.asarray(np_signals(B, T)))
        out[rank] = (float(v), {k: np.asarray(getattr(g, k)) for k in NAMES})
    return out


@pytest.mark.parametrize("defer, precision, unroll, stream, rank", [
    (True, "highest", 16, True, 3), (True, "highest", 5, True, 8),
    (True, "high", 16, True, 8), (False, "highest", 16, False, 3),
    (False, "high", 5, False, 8)])
def test_trainable_value_and_grads_match_jax(defer, precision, unroll, stream,
                                             rank, xla_reference):
    """The port's rho_nll_block_trainable (the plain kernel versions under
    RhoBlockNLL) against JAX's rho_nll_block_trainable: the streamed
    batched pair (stream=True), the recompute adjoints (stream=False), and,
    at highest, jax.grad of the XLA factor scan: the value and all six
    parameter gradients, the gradient of A pinning dse."""
    hp, jhp = rho_configs(rank=rank)
    d = np_rho_params(8, rank)
    sig = np_signals(B, T)
    kw = dict(unroll=unroll, precision=precision, defer_norm=defer)
    got, ggot = port_value_and_grads(
        lambda p: block.rho_nll_block_trainable(p, hp, torch.as_tensor(sig),
                                                **kw), d)
    jp, _ = rho_both(d)
    want, gwant = jax.value_and_grad(
        lambda p: jblock.rho_nll_block_trainable(
            p, jhp, jnp.asarray(sig), interpret=True, stream=stream,
            **kw))(jp)
    np.testing.assert_allclose(got, float(want), rtol=VALUE_RTOL
                               if precision == "highest" else VALUE_RTOL_HIGH)
    for k in NAMES:
        assert max_rel(ggot[k], getattr(gwant, k)) < GRAD_REL, k
    if precision == "highest":
        v_xla, g_xla = xla_reference[rank]
        np.testing.assert_allclose(got, v_xla, rtol=VALUE_RTOL)
        for k in NAMES:
            assert max_rel(ggot[k], g_xla[k]) < GRAD_REL, k


def jax_block_inputs(jp, jhp, sig):
    """(ab, bb, xb, t0, zmat, incs [T-1, B]) exactly as the JAX trainable
    builds them."""
    from audio_mps_tpu.ops.pallas_scan import rho_factor_inputs
    cc = jmake_constants(jp, jhp)
    ab, bb, xb = jblock._rho_block_constants(cc)
    h0r, h0i, zmat = rho_factor_inputs(jp, jhp, sig.shape[0])
    t0 = jblock._rho_block_t0(cc, h0r, h0i)
    incs = (sig[:, 1:] - sig[:, :-1]).T / cc.A
    return ab, bb, xb, t0, zmat, incs


@pytest.mark.parametrize("defer, precision", [
    (True, "highest"), (True, "high"), (False, "highest")])
def test_plain_adjoint_matches_the_jax_custom_vjp(defer, precision):
    """dAb, dBb, dXb, dt0 and dse of the plain forward, adjoint and
    cotangents against the custom VJP of _rho_block_factory (the streamed
    batched pair at the deferred norm, the per-step-norm pair otherwise) on
    the same block constants. The JAX factory returns the batch mean, so
    the port's per-example cotangent is 1/B. The JAX dse is per rank lane
    over zero-padded rows: its lanes are summed per example and compared on
    the real steps."""
    rank, unroll = 3, 16
    _, jhp = rho_configs(rank=rank, defer_norm=defer)
    jp, _ = rho_both(np_rho_params(8, rank))
    sig = jnp.asarray(np_signals(B, T))
    ab, bb, xb, t0, zmat, incs = jax_block_inputs(jp, jhp, sig)
    n_steps = T - 1
    t_pad = -(-n_steps // unroll) * unroll
    fused = jblock._rho_block_factory(jhp, B, T, rank, unroll, True,
                                      precision, defer, None, defer)
    g = np.full(B, 1.0 / B, np.float32)
    seb = _pad_rows(incs, t_pad)
    se = jnp.repeat(seb, rank, axis=1)
    loss, vjp = jax.vjp(lambda *a: fused(*a, seb, zmat, zmat.T),
                        ab, bb, xb, t0, se)
    want = dict(zip(("dab", "dbb", "dxb", "dt0", "dse"),
                    vjp(jnp.float32(1.0))))
    want["dse"] = np.asarray(want["dse"])[:n_steps].reshape(
        n_steps, B, rank).sum(-1)

    ins = [torch.as_tensor(np.array(x)) for x in (ab, bb, xb, t0, incs)]
    kw = dict(log_eps=jhp.log_eps, norm_eps=jhp.norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer)
    tloss, ys, trs = block.rho_train_fwd_plain(*ins, **kw)
    dse, dt0, dy, dehat = block.rho_train_bwd_plain(
        *ins, torch.as_tensor(g), ys, trs, **kw)
    del kw["log_eps"]
    dab, dbb, dxb = block.rho_cotangents_plain(dy, ys, ins[3], ins[4], trs,
                                               dehat, **kw)
    np.testing.assert_allclose(
        tloss.mean().item(), float(loss),
        rtol=VALUE_RTOL if precision == "highest" else VALUE_RTOL_HIGH)
    got = dict(dab=dab, dbb=dbb, dxb=dxb, dt0=dt0, dse=dse)
    for k in got:
        assert max_rel(got[k], want[k]) < GRAD_REL, k


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_cotangents_are_the_psi_reduction_over_rank_lanes(precision):
    """The identity the CUDA wrapper rho_cotangents rests on: the psi
    cotangent reduction over the B*rank lanes, fed the per-example se and
    trace repeated over each example's lanes and dehat / 2, gives dAb, dBb
    and dXb of the rho plain version (up to the order of the sums)."""
    rank, unroll = 3, 5
    hp, _ = rho_configs(rank=rank)
    tp = rho_params_from_numpy(np_rho_params(8, rank), "cpu")
    ins = block.rho_nll_inputs(tp, hp, torch.as_tensor(np_signals(B, T)))
    kw = dict(norm_eps=ins.pop("norm_eps"), unroll=unroll,
              precision=precision, defer_norm=True)
    log_eps = ins.pop("log_eps")
    _, ys, trs = block.rho_train_fwd_plain(**ins, log_eps=log_eps, **kw)
    _, _, dy, dehat = block.rho_train_bwd_plain(
        **ins, g=torch.full((B,), 1.0 / B), ys=ys, trs=trs, log_eps=log_eps,
        **kw)
    want = block.rho_cotangents_plain(dy, ys, ins["t0"], ins["se"], trs,
                                      dehat, **kw)
    got = block.psi_cotangents_plain(
        dy, ys, ins["t0"], block._lanes(ins["se"], rank),
        block._lanes(trs, rank), block._lanes(0.5 * dehat, rank), **kw)
    for a, b in zip(got, want):
        assert max_rel(a, b) < 1e-6


@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_jax(fused):
    """Three Adam steps of make_train_step("rho_mps") against JAX's
    make_train_step("rho_mps", cfg, fused=False) (core.rho_nll_factor) on
    the same parameters and batches: every metric to rtol 1e-5 and every
    parameter to max-rel 1e-5 after each step. fused=False is the eager
    core.rho_nll_factor through chunked_scan (scan_chunk=32: two
    checkpointed chunks and a remainder); fused=True is the kernel path (its
    plain versions on the CPU)."""
    hp, jhp = rho_configs(rank=3, scan_chunk=32)
    d = np_rho_params(8, 3)
    tp = rho_params_from_numpy(d, "cpu")
    _, step = training.make_train_step("rho_mps", hp, tp, fused=fused,
                                       device="cpu")
    jp, _ = rho_both(d)
    _, jstep = jtraining.make_train_step("rho_mps", jhp, fused=False)
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
    # the Adam state of the JAX run carries across: one more step each
    adam = state[0]
    moments = {"count": np.asarray(adam.count)}
    for m in ("mu", "nu"):
        moments.update({f"{m}/{k}": np.asarray(getattr(getattr(adam, m), k))
                        for k in NAMES})
    tq = rho_params_from_numpy({k: np.array(getattr(jp, k)) for k in NAMES},
                               "cpu")
    opt, step = training.make_train_step("rho_mps", hp, tq, fused=fused,
                                         device="cpu")
    adam_state_from_numpy(moments, tq, opt)
    batch = np_signals(B, T, seed=4)
    jp, _, _ = jstep(jp, state, jnp.asarray(batch))
    step(torch.as_tensor(batch))
    for k in NAMES:
        assert max_rel(getattr(tq, k), getattr(jp, k)) < 1e-5, k


def test_train_cli_trains_rho_and_restores(tmp_path, capsys):
    """train() with --mps_model=rho_mps on the CPU: two steps, then a
    restart with max_steps=3 restores step 2 and takes one step; params.npz
    holds rho weights."""
    argv = ["--mps_model=rho_mps", "--dataset=damped_sine",
            "--sample_duration=60", f"--logdir={tmp_path}",
            "--hparams=bond_dim=8,minibatch_size=2,initial_rank=3",
            "--device=cpu"]
    run, device = parse_args(argv + ["--max_steps=2"])
    params, metrics = train(run, device=device, verbose=True)
    assert isinstance(params, RhoParams) and params.Wx.shape == (3, 8)
    assert np.isfinite(float(metrics["total_loss"]))
    logdir = run.run_logdir(CMPSConfig().parse(run.hparams))
    ckpts = os.path.join(logdir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["ckpt_2.pt"]
    params3, _ = train(dataclasses.replace(run, max_steps=3), device=device,
                       verbose=True)
    out = capsys.readouterr().out
    assert "step 3:" in out and out.count("step 1:") == 1
    state = torch.load(os.path.join(ckpts, "ckpt_3.pt"), weights_only=True)
    assert state["step"] == 3
    assert all(float(s["step"]) == 3.0
               for s in state["optimizer"]["state"].values())
    saved = load_params(os.path.join(logdir, "params.npz"), "cpu")
    assert isinstance(saved, RhoParams)
    for k in NAMES:
        assert torch.equal(getattr(saved, k), getattr(params3, k))


def test_rho_dispatch_on_cpu():
    """nll_fn_for("rho_mps"): fused=None runs core.rho_nll_factor on a CPU
    tensor, fused=True the kernel path's plain versions; both equal
    core.rho_nll within the value tolerance; the stream policy takes B*rank
    columns."""
    hp, _ = rho_configs(rank=3)
    tp = rho_params_from_numpy(np_rho_params(8, 3), "cpu")
    sig = torch.as_tensor(np_signals(B, T))
    eager = training.nll_fn_for("rho_mps")(tp, hp, sig)
    kern = training.nll_fn_for("rho_mps", fused=True)(tp, hp, sig)
    assert eager.item() == core.rho_nll_factor(tp, hp, sig).item()
    lit = core.rho_nll(tp, hp, sig).item()
    np.testing.assert_allclose(kern.item(), lit, rtol=VALUE_RTOL)
    np.testing.assert_allclose(eager.item(), lit, rtol=VALUE_RTOL)
    off = dataclasses.replace(hp, kernel_stream="off")
    np.testing.assert_allclose(
        block.rho_nll_block_trainable(tp, off, sig).item(),
        block.rho_nll_block_trainable(tp, hp, sig).item(), rtol=0)
    assert block.stream_bytes(64, 8 * 64, 16384) == 2 * 4 * 16383 * 128 * 512
