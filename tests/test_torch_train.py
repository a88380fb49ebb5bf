"""The port's psi training path (audio_mps_tpu_torch: ops/block.py
PsiBlockNLL and its plain kernel versions, models/core.chunked_scan and
regularized_loss, training.py, train.py, weights.adam_state_from_numpy)
against the JAX package on the same numpy inputs, on the CPU. The JAX block
kernels run in Pallas interpret mode. D=8, B=4, T=83: T-1 = 82 is a
multiple of neither unroll 16 nor 8, so the TPU's zero-padded last block is
exercised against the port's loop over the real steps."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu import training as jtraining
from audio_mps_tpu.models import core as jcore
from audio_mps_tpu.models.cell import make_constants as jmake_constants
from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu.ops.pallas_scan import _pad_rows
from audio_mps_tpu_torch import training
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.data import get_audio
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.models.params import PsiParams
from audio_mps_tpu_torch.ops import block, grad, split
from audio_mps_tpu_torch.train import train
from audio_mps_tpu_torch.weights import (adam_state_from_numpy, load_params,
                                         psi_params_from_numpy)
from test_torch_core import both, np_params, np_signals

T = 83
NAMES = PsiParams.NAMES
# value rtol 1e-5 and gradient max-rel 1e-4: the tolerances of
# tests/test_pallas_block.py:33,44 (the JAX block kernels against jax.grad
# of the XLA scan)
VALUE_RTOL, GRAD_REL = 1e-5, 1e-4


def configs(**kw):
    base = dict(minibatch_size=4, bond_dim=8, scan_chunk=0)
    base.update(kw)
    return CMPSConfig(**base), jconfig.CMPSConfig(**base)


def max_rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def port_value_and_grads(fn, d):
    """(value, {name: grad}) of fn(params) on fresh port params from d."""
    tp = psi_params_from_numpy(d, "cpu")
    loss = fn(tp)
    loss.backward()
    return loss.item(), {k: getattr(tp, k).grad for k in NAMES}


@pytest.fixture(scope="module")
def xla_reference():
    """jax.value_and_grad of the XLA scan core.psi_nll on the shared draw."""
    _, jhp = configs()
    jp, _ = both(np_params(8))
    v, g = jax.value_and_grad(jcore.psi_nll)(jp, jhp,
                                             jnp.asarray(np_signals(4, T)))
    return float(v), {k: np.asarray(getattr(g, k)) for k in NAMES}


@pytest.mark.parametrize("defer, precision, unroll, stream", [
    (True, "highest", 16, True), (True, "highest", 16, False),
    (True, "highest", 8, True), (True, "high", 16, True),
    (True, "high", 8, False), (False, "highest", 16, False),
    (False, "high", 8, False)])
def test_trainable_value_and_grads_match_jax(defer, precision, unroll, stream,
                                             xla_reference):
    """The port's psi_nll_block_trainable (the plain kernel versions under
    PsiBlockNLL) against JAX's block kernels with the streamed-states pair
    (stream=True) and the non-streamed pair (stream=False), and, at
    highest, against jax.grad of the XLA scan: the value and all six
    parameter gradients."""
    hp, jhp = configs()
    d = np_params(8)
    sig = np_signals(4, T)
    kw = dict(unroll=unroll, precision=precision, defer_norm=defer)
    got, ggot = port_value_and_grads(
        lambda p: block.psi_nll_block_trainable(p, hp, torch.as_tensor(sig),
                                                **kw), d)
    jp, _ = both(d)
    want, gwant = jax.value_and_grad(
        lambda p: jblock.psi_nll_block_trainable(
            p, jhp, jnp.asarray(sig), interpret=True, stream=stream,
            **kw))(jp)
    np.testing.assert_allclose(got, float(want), rtol=VALUE_RTOL)
    for k in NAMES:
        assert max_rel(ggot[k], getattr(gwant, k)) < GRAD_REL, k
    if precision == "highest":
        v_xla, g_xla = xla_reference
        np.testing.assert_allclose(got, v_xla, rtol=VALUE_RTOL)
        for k in NAMES:
            assert max_rel(ggot[k], g_xla[k]) < GRAD_REL, k


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_backward_dot_menu_matches_jax(precision):
    """dotnt (a @ b.T, the cotangent reductions' product) and dotf on
    operands prepped as the TPU's _make_dot_ops_bwd preps them, summed in
    fp32."""
    rng = np.random.default_rng(6)
    a = rng.standard_normal((16, 40)).astype(np.float32)
    b = rng.standard_normal((16, 40)).astype(np.float32)
    prep, dotf, dotnt = block._make_dot_ops_bwd(precision)
    jprep, _, jdotf, jdotnt = jblock._make_dot_ops_bwd(precision)
    if precision == "default":
        # JAX on the CPU computes "default" in fp32: round its operands to
        # bf16 by hand, as the port's prep does
        def jprep(x):
            return x.astype(jnp.bfloat16).astype(jnp.float32)
    ta, tb = prep(torch.as_tensor(a)), prep(torch.as_tensor(b))
    ja, jb = jprep(jnp.asarray(a)), jprep(jnp.asarray(b))
    np.testing.assert_allclose(dotnt(ta, tb).numpy(),
                               np.asarray(jdotnt(ja, jb)), rtol=1e-5,
                               atol=1e-5)
    tbt = prep(torch.as_tensor(np.ascontiguousarray(b.T)))
    jbt = jprep(jnp.asarray(b.T))
    np.testing.assert_allclose(dotf(ta, tbt).numpy(),
                               np.asarray(jdotf(ja, jbt)), rtol=1e-5,
                               atol=1e-5)


def jax_block_inputs(jp, jhp, sig):
    """(ab, bb, rb, t0, incs [T-1, B]) exactly as the JAX trainable builds
    them."""
    cc = jmake_constants(jp, jhp)
    ab, bb, rb = jblock._psi_block_constants(cc)
    pr0, pi0 = jcore.psi0(jp, jhp)
    B, D = sig.shape[0], jhp.bond_dim
    t0 = jblock._psi_block_t0(cc, jnp.broadcast_to(pr0[:, None], (D, B)),
                              jnp.broadcast_to(pi0[:, None], (D, B)))
    incs = (sig[:, 1:] - sig[:, :-1]).T / cc.A
    return ab, bb, rb, t0, incs


@pytest.mark.parametrize("defer, stream, precision", [
    (True, True, "highest"), (True, True, "high"), (False, False, "highest")])
def test_plain_adjoint_matches_the_jax_custom_vjp(defer, stream, precision):
    """dAb, dBb, dRb, dt0 and dse of the plain forward, adjoint and
    cotangent reduction against the custom VJP of _psi_block_factory on the
    same block constants, with a non-uniform loss cotangent g. The JAX
    kernels run over zero-padded rows; their dse is compared on the real
    steps (autodiff of _pad_rows drops the rest)."""
    _, jhp = configs(defer_norm=defer)
    jp, _ = both(np_params(8))
    sig = jnp.asarray(np_signals(4, T))
    ab, bb, rb, t0, incs = jax_block_inputs(jp, jhp, sig)
    unroll, B = 16, 4
    n_steps = T - 1
    t_pad = -(-n_steps // unroll) * unroll
    fused = jblock._psi_block_factory(jhp, B, T, unroll, True, precision,
                                      defer, None, stream)
    g = np.linspace(0.5, 1.5, B).astype(np.float32)
    loss, vjp = jax.vjp(fused, ab, bb, rb, t0, _pad_rows(incs, t_pad))
    want = dict(zip(("dab", "dbb", "drb", "dt0", "dse"),
                    vjp(jnp.asarray(g))))

    ins = [torch.as_tensor(np.array(x)) for x in (ab, bb, rb, t0, incs)]
    kw = dict(log_eps=jhp.log_eps, norm_eps=jhp.norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer)
    tloss, ys, n2s = block.psi_train_fwd_plain(*ins, **kw)
    dse, dt0, dy, dehat = block.psi_train_bwd_plain(
        *ins, torch.as_tensor(g), ys, n2s, **kw)
    del kw["log_eps"]
    dab, dbb, drb = block.psi_cotangents_plain(dy, ys, ins[3], ins[4], n2s,
                                               dehat, **kw)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(loss),
                               rtol=VALUE_RTOL)
    got = dict(dab=dab, dbb=dbb, drb=drb, dt0=dt0, dse=dse)
    want["dse"] = want["dse"][:n_steps]
    for k in got:
        assert max_rel(got[k], want[k]) < GRAD_REL, k


def make_jax_step(jhp):
    _, jstep = jtraining.make_train_step("psi_mps", jhp, fused=False)
    return jstep


@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_jax(fused):
    """Three Adam steps of make_train_step against JAX's
    make_train_step("psi_mps", cfg, fused=False) on the same parameters and
    batches: every metric to rtol 1e-5 and every parameter to max-rel 1e-5
    after each step (measured: 4e-7 and 6e-8). fused=False is the eager
    core.psi_nll through chunked_scan (scan_chunk=32: two checkpointed
    chunks and a remainder); fused=True is the kernel path (its plain
    versions on the CPU)."""
    hp, jhp = configs(scan_chunk=32)
    d = np_params(8)
    tp = psi_params_from_numpy(d, "cpu")
    _, step = training.make_train_step("psi_mps", hp, tp, fused=fused,
                                       device="cpu")
    jp, _ = both(d)
    jstep = make_jax_step(jhp)
    state = jtraining.make_optimizer(jhp).init(jp)
    for seed in (1, 2, 3):
        batch = np_signals(4, T, seed=seed)
        jp, state, jm = jstep(jp, state, jnp.asarray(batch))
        tm = step(torch.as_tensor(batch))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        for k in NAMES:
            assert max_rel(getattr(tp, k), getattr(jp, k)) < 1e-5, k


def test_adam_state_carries_a_jax_run_across():
    """Two JAX steps, then the parameters and optax's Adam moments carried
    into the port (psi_params_from_numpy, adam_state_from_numpy), then one
    step on each side: the parameters agree to max-rel 1e-6 (measured
    2.5e-8; a fresh Adam state in the port would differ at ~1e-3)."""
    hp, jhp = configs(scan_chunk=32)
    jp, _ = both(np_params(8))
    jstep = make_jax_step(jhp)
    state = jtraining.make_optimizer(jhp).init(jp)
    for seed in (1, 2):
        jp, state, _ = jstep(jp, state, jnp.asarray(np_signals(4, T, seed)))
    adam = state[0]
    moments = {"count": np.asarray(adam.count)}
    for m in ("mu", "nu"):
        moments.update({f"{m}/{k}": np.asarray(getattr(getattr(adam, m), k))
                        for k in NAMES})
    tp = psi_params_from_numpy({k: np.array(getattr(jp, k)) for k in NAMES},
                               "cpu")
    opt, step = training.make_train_step("psi_mps", hp, tp, device="cpu")
    adam_state_from_numpy(moments, tp, opt)
    batch = np_signals(4, T, seed=3)
    jp, _, _ = jstep(jp, state, jnp.asarray(batch))
    step(torch.as_tensor(batch))
    for k in NAMES:
        assert max_rel(getattr(tp, k), getattr(jp, k)) < 1e-6, k
    with pytest.raises(KeyError):
        adam_state_from_numpy({"count": moments["count"]}, tp, opt)


def test_train_cli_restores_its_checkpoint(tmp_path, capsys):
    """train() on the CPU: two steps, then a restart with max_steps=3
    restores step 2 (params and Adam state) and takes one step. The run
    directory holds config.json, the latest checkpoints and params.npz."""
    argv = ["--mps_model=psi_mps", "--dataset=damped_sine",
            "--sample_duration=83", f"--logdir={tmp_path}",
            "--hparams=bond_dim=8,minibatch_size=4"]
    from audio_mps_tpu_torch.train import parse_args
    run, device = parse_args(argv + ["--max_steps=2", "--device=cpu"])
    assert device == "cpu"
    params, metrics = train(run, device=device, verbose=True)
    assert np.isfinite(float(metrics["total_loss"]))
    logdir = run.run_logdir(CMPSConfig().parse(run.hparams))
    ckpts = os.path.join(logdir, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["ckpt_2.pt"]
    after_two = torch.load(os.path.join(ckpts, "ckpt_2.pt"),
                           weights_only=True)
    assert after_two["step"] == 2
    for k in NAMES:
        assert torch.equal(after_two["params"][k], getattr(params, k))

    run3 = dataclasses.replace(run, max_steps=3)
    params3, _ = train(run3, device="cpu", verbose=True)
    out = capsys.readouterr().out
    assert "step 3:" in out and out.count("step 1:") == 1
    assert sorted(os.listdir(ckpts)) == ["ckpt_2.pt", "ckpt_3.pt"]
    state = torch.load(os.path.join(ckpts, "ckpt_3.pt"), weights_only=True)
    assert state["step"] == 3
    assert all(float(s["step"]) == 3.0
               for s in state["optimizer"]["state"].values())
    saved = load_params(os.path.join(logdir, "params.npz"), "cpu")
    for k in NAMES:
        assert torch.equal(getattr(saved, k), getattr(params3, k))
        assert not torch.equal(getattr(params3, k), getattr(params, k))
    with open(os.path.join(logdir, "config.json")) as f:
        assert json.load(f)["cfg"]["bond_dim"] == 8


def test_checkpointer_keeps_the_latest_three(tmp_path):
    tp = psi_params_from_numpy(np_params(8), "cpu")
    hp, _ = configs()
    opt = training.make_optimizer(hp, tp)
    ck = training.Checkpointer(str(tmp_path), save_secs=3600.0)
    assert ck.restore(tp, opt) == 0
    assert not ck.maybe_save(1, tp, opt)
    for s in (1, 2, 3, 4):
        assert ck.maybe_save(s, tp, opt, force=True)
    assert ck.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == [f"ckpt_{s}.pt" for s in (2, 3, 4)]


def test_chunked_scan_gradient_equals_the_plain_loop():
    """The checkpointed chunks of chunked_scan change neither the value nor
    the gradient of the eager loss (chunk 32 over 82 steps against one plain
    loop), and the loss matches JAX's chunked scan."""
    hp, jhp = configs(scan_chunk=32)
    d = np_params(8)
    sig = torch.as_tensor(np_signals(4, T))
    v32, g32 = port_value_and_grads(lambda p: core.psi_nll(p, hp, sig), d)
    v0, g0 = port_value_and_grads(
        lambda p: core.psi_nll(p, dataclasses.replace(hp, scan_chunk=0),
                               sig), d)
    assert v32 == v0
    for k in NAMES:
        assert torch.allclose(g32[k], g0[k], rtol=1e-6, atol=0), k
    jp, _ = both(d)
    np.testing.assert_allclose(v32, float(jcore.psi_nll(
        jp, jhp, jnp.asarray(sig.numpy()))), rtol=VALUE_RTOL)


def test_regularized_loss_matches_jax():
    hp, jhp = configs()
    jp, tp = both(np_params(8))
    nll = torch.tensor(1.5)
    total, (h_sq, r_sq) = core.regularized_loss(nll, tp, hp)
    jtotal, (jh, jr) = jcore.regularized_loss(jnp.float32(1.5), jp, jhp)
    for a, b in ((total, jtotal), (h_sq, jh), (r_sq, jr)):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)


def test_dispatch_and_unported_paths_on_cpu():
    """nll_fn_for: fused=None runs the eager core on a CPU tensor, fused=True
    the kernel path's plain versions; latent raises NotImplementedError
    (rho_mps is ported: tests/test_torch_rho_train.py); the split layout
    (D % 4 != 0) runs the split kernels' plain versions on the CPU
    (ops/split.py, held to JAX in tests/test_torch_split.py), which agree
    with the eager core as the block path does; a file dataset whose
    .tfrecords file is missing raises FileNotFoundError (the data plane is
    ported: tests/test_torch_tfrecord.py)."""
    hp, _ = configs()
    tp = psi_params_from_numpy(np_params(8), "cpu")
    sig = torch.as_tensor(np_signals(4, T))
    eager = training.nll_fn_for("psi_mps")(tp, hp, sig)
    kern = training.nll_fn_for("psi_mps", fused=True)(tp, hp, sig)
    assert eager.item() == core.psi_nll(tp, hp, sig).item()
    np.testing.assert_allclose(kern.item(), eager.item(), rtol=VALUE_RTOL)
    with pytest.raises(NotImplementedError):
        training.nll_fn_for("latent")
    assert callable(training.nll_fn_for("rho_mps"))
    with pytest.raises(ValueError):
        training.nll_fn_for("mps")
    hp6 = dataclasses.replace(hp, bond_dim=6)
    p6 = psi_params_from_numpy(np_params(6), "cpu")
    got6 = grad.psi_nll_fused_trainable(p6, hp6, sig).item()
    assert got6 == split.psi_nll_split_trainable(
        p6, hp6, sig, defer_norm=False).item()
    np.testing.assert_allclose(got6, core.psi_nll(p6, hp6, sig).item(),
                               rtol=VALUE_RTOL)
    with pytest.raises(FileNotFoundError, match="nsynth.tfrecords"):
        get_audio("no_such_dir", "nsynth", hp, device="cpu")
    with pytest.raises(ValueError):
        training.make_train_step("psi_mps", hp, tp, device="meta")


def test_damped_sine_iterator_draws_fresh_batches():
    hp, _ = configs()
    it = get_audio("", "damped_sine", hp, sample_duration=300, seed=4,
                   device="cpu")
    a, b = next(it), next(it)
    again = next(get_audio("", "damped_sine", hp, sample_duration=300, seed=4,
                           device="cpu"))
    assert a.shape == (4, 300) and a.dtype == torch.float32
    assert torch.equal(a, again) and not torch.equal(a, b)


def test_stream_policy_on_cpu(monkeypatch):
    """auto_stream: "off" never streams; "auto" and "on" stream on a CPU
    tensor (no memory bound there). With "off" the loss comes from the
    checkpoint forward and the recompute adjoint's plain versions, whose
    loop is the streamed forward's: the same value, bit for bit."""
    hp, _ = configs()
    assert block.auto_stream(hp, 4, T, "cpu")
    assert block.auto_stream(dataclasses.replace(hp, kernel_stream="on"), 4,
                             T, "cpu")
    assert not block.auto_stream(dataclasses.replace(hp, kernel_stream="off"),
                                 4, T, "cpu")
    assert block.stream_bytes(64, 128, 16384) == 2 * 4 * 16383 * 128 * 128
    tp = psi_params_from_numpy(np_params(8), "cpu")
    sig = torch.as_tensor(np_signals(4, T))
    calls = []
    ckpt = block.psi_train_fwd_ckpt_plain

    def spy(*args, **kwargs):
        calls.append(args[4].shape[0])
        return ckpt(*args, **kwargs)

    monkeypatch.setattr(block, "psi_train_fwd_ckpt_plain", spy)
    off = block.psi_nll_block_trainable(
        tp, dataclasses.replace(hp, kernel_stream="off"), sig)
    assert calls == [T - 1]
    np.testing.assert_allclose(off.item(), block.psi_nll_block_trainable(
        tp, hp, sig).item(), rtol=0)
