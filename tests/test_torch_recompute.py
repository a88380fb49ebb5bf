"""The port's training path without the state stream (kernel_stream="off"):
the checkpoint forwards, the segment recomputes and the recompute adjoints
of psi, rho and the rank partials (audio_mps_tpu_torch/ops/block.py,
ops/rank.py), their plain versions against the JAX package's non-streamed
kernels on the same numpy inputs, on the CPU. The JAX kernels run in
Pallas interpret mode. D=8; T=83 (T-1 = 82 steps, a multiple of neither
unroll 4, 5 nor 16) for psi and rho, T=50 and 65 for the rank partials.

Tolerances (as in tests/test_torch_train.py, test_torch_rho_train.py and
test_torch_rank.py): the value at rtol 1e-5; dse, dt0 and the [2D,2D]
cotangents at max-rel 1e-4 of their largest element; the
checkpoints at max-rel 1e-5; a split into time segments changes only the
order of the cotangent sums, so 1, 2 and 3 segments agree to 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import training as jtraining
from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu.ops import pallas_rank as jrank
from audio_mps_tpu.ops.pallas_scan import _pad_rows
from audio_mps_tpu_torch import training
from audio_mps_tpu_torch.models.params import PsiParams, RhoParams
from audio_mps_tpu_torch.ops import block, rank
from audio_mps_tpu_torch.weights import (psi_params_from_numpy,
                                         rho_params_from_numpy)
from test_torch_core import both, np_params, np_signals
from test_torch_rho import np_rho_params, rho_both, rho_configs
from test_torch_rho_train import jax_block_inputs as rho_jax_inputs
from test_torch_train import GRAD_REL, VALUE_RTOL, max_rel
from test_torch_train import configs as psi_configs
from test_torch_train import jax_block_inputs as psi_jax_inputs

T = 83
CK_REL = 1e-5        # checkpoints, max-rel of their largest element
SEGMENT_REL = 1e-6   # 1, 2 and 3 time segments against each other


def _off(cfg):
    return dataclasses.replace(cfg, kernel_stream="off")


@pytest.mark.parametrize("defer, precision, unroll", [
    (True, "highest", 4), (True, "highest", 16), (False, "highest", 4),
    (True, "high", 16)])
def test_psi_recompute_adjoint_matches_jax(defer, precision, unroll):
    """The plain checkpoint forward (loss, ck) and the plain recompute
    adjoint (dse, dt0, dAb, dBb, dRb, from ck, in the default segments)
    against _psi_block_factory with stream=False: its forward
    _make_psi_fwd_kernel (:461) and its adjoint _make_psi_bwd_kernel_defer
    (:621) or, at defer_norm=False, _make_psi_bwd_kernel (:529). The JAX
    kernels run over zero-padded rows: their dse is compared on the real
    steps."""
    _, jhp = psi_configs(defer_norm=defer)
    jp, _ = both(np_params(8))
    ab, bb, rb, t0, incs = psi_jax_inputs(jp, jhp, jnp.asarray(
        np_signals(4, T)))
    n_steps, B = T - 1, 4
    fused = jblock._psi_block_factory(jhp, B, T, unroll, True, precision,
                                      defer, None, False)
    g = np.linspace(0.5, 1.5, B).astype(np.float32)
    loss, res = fused.fwd(ab, bb, rb, t0, _pad_rows(
        incs, block.n_blocks(n_steps, unroll) * unroll))
    want = dict(zip(("dab", "dbb", "drb", "dt0", "dse"),
                    fused.bwd(res, jnp.asarray(g))))
    want["dse"] = np.asarray(want["dse"])[:n_steps]

    ins = [torch.as_tensor(np.array(x)) for x in (ab, bb, rb, t0, incs)]
    kw = dict(log_eps=jhp.log_eps, norm_eps=jhp.norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer)
    tloss, ck = block.psi_train_fwd_ckpt_plain(*ins, **kw)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(loss),
                               rtol=VALUE_RTOL)
    assert ck.shape == res[4].shape
    assert max_rel(ck, res[4]) < CK_REL
    dse, dt0, dab, dbb, drb = block.psi_recompute_bwd_plain(
        ins[0], ins[1], ins[2], ck, ins[4], torch.as_tensor(g), **kw)
    got = dict(dab=dab, dbb=dbb, drb=drb, dt0=dt0, dse=dse)
    for k in got:
        assert max_rel(got[k], want[k]) < GRAD_REL, k


@pytest.mark.parametrize("batched, defer, rank_, unroll", [
    (True, True, 3, 16), (False, True, 8, 5), (False, False, 3, 5)])
def test_rho_recompute_adjoint_matches_jax(batched, defer, rank_, unroll):
    """The plain rho checkpoint forward and recompute adjoint against
    _rho_block_factory with stream=False: the batched pair
    (_make_rho_bwd_kernel_batched :1438), the non-batched deferred adjoint
    (_make_rho_bwd_kernel_defer :1790) and the per-step norm
    (_make_rho_bwd_kernel :1689), one function on the port's side. The
    JAX factory returns the batch mean (the port's per-example cotangent
    is 1/B) and spreads dse over the rank lanes of zero-padded rows: its
    lanes are summed per example and compared on the real steps."""
    B = 3
    _, jhp = rho_configs(rank=rank_, defer_norm=defer)
    jp, _ = rho_both(np_rho_params(8, rank_))
    ab, bb, xb, t0, zmat, incs = rho_jax_inputs(jp, jhp, jnp.asarray(
        np_signals(B, T)))
    n_steps = T - 1
    fused = jblock._rho_block_factory(jhp, B, T, rank_, unroll, True,
                                      "highest", defer, batched, False)
    seb = _pad_rows(incs, block.n_blocks(n_steps, unroll) * unroll)
    loss, res = fused.fwd(ab, bb, xb, t0, jnp.repeat(seb, rank_, axis=1),
                          seb, zmat, zmat.T)
    want = dict(zip(("dab", "dbb", "dxb", "dt0", "dse"),
                    fused.bwd(res, jnp.float32(1.0))))
    want["dse"] = np.asarray(want["dse"])[:n_steps].reshape(
        n_steps, B, rank_).sum(-1)

    ins = [torch.as_tensor(np.array(x)) for x in (ab, bb, xb, t0, incs)]
    kw = dict(log_eps=jhp.log_eps, norm_eps=jhp.norm_eps, unroll=unroll,
              precision="highest", defer_norm=defer)
    tloss, ck = block.rho_train_fwd_ckpt_plain(*ins, **kw)
    np.testing.assert_allclose(tloss.mean().item(), float(loss),
                               rtol=VALUE_RTOL)
    assert ck.shape == res[7].shape
    assert max_rel(ck, res[7]) < CK_REL
    dse, dt0, dab, dbb, dxb = block.rho_recompute_bwd_plain(
        ins[0], ins[1], ins[2], ck, ins[4], torch.full((B,), 1.0 / B), **kw)
    got = dict(dab=dab, dbb=dbb, dxb=dxb, dt0=dt0, dse=dse)
    for k in got:
        assert max_rel(got[k], want[k]) < GRAD_REL, k


def test_rank_recompute_adjoint_matches_jax():
    """The plain partials checkpoint forward (eh, tr, tfin, ck) and the
    plain recompute adjoint in two time segments (dse, dt0, dAb, dBb, dXb)
    of one chunk of 4 rows against the custom VJP of
    _rank_partials_factory with stream=False (_make_rank_partials_bwd_kernel
    :152), on the same constants, initial rows and cotangents (deh, dtr,
    dtfin)."""
    from test_torch_rank import configs as rank_configs
    r_loc, unroll, B, Tr = 4, 4, 4, 65
    hp, jhp = rank_configs()
    d = np_rho_params(8, 8)
    d.update(Wx=d["Wx"][:r_loc], Wy=d["Wy"][:r_loc])
    _, tp = rho_both(d)
    ins, _ = rank.partials_inputs(tp, hp, torch.as_tensor(np_signals(B, Tr)),
                                  r_loc)
    pins = [ins[k] for k in ("ab", "bb", "xb", "t0", "se")]
    rng = np.random.default_rng(9)
    n_steps, cols = Tr - 1, B * r_loc
    deh = rng.standard_normal((n_steps, B)).astype(np.float32)
    dtr = rng.standard_normal((n_steps, B)).astype(np.float32)
    dtfin = (0.1 * rng.standard_normal((16, cols))).astype(np.float32)
    zmat = jnp.repeat(jnp.eye(B, dtype=jnp.float32), r_loc, axis=0)
    fused = jrank._rank_partials_factory(jhp, B, Tr, r_loc, unroll, True,
                                         "highest", False)
    jins = [jnp.asarray(x.numpy()) for x in pins]
    jins[4] = jnp.repeat(jins[4], r_loc, axis=1)
    outs, res = fused.fwd(*jins, zmat, zmat.T)
    dab, dbb, dxb, dt0, dse = fused.bwd(res, (jnp.asarray(deh),
                                              jnp.asarray(dtr),
                                              jnp.asarray(dtfin)))[:5]

    kw = dict(rc=r_loc, unroll=unroll, norm_eps=hp.norm_eps)
    eh, tr, tfin, ck = rank.rank_partials_fwd_ckpt_plain(*pins, **kw)
    for a, b in zip((eh, tr, tfin), outs):
        assert max_rel(a, b) < 1e-5
    assert max_rel(ck, res[6]) < CK_REL
    got = rank.rank_recompute_bwd_plain(
        pins[0], pins[1], pins[2], ck, pins[4], tr, torch.as_tensor(deh),
        torch.as_tensor(dtr), torch.as_tensor(dtfin), segment=32, **kw)
    want = (np.asarray(dse).reshape(n_steps, B, r_loc).sum(-1), dt0, dab,
            dbb, dxb)
    for name, a, b in zip(("dse", "dt0", "dAb", "dBb", "dXb"), got, want):
        assert max_rel(a, b) < GRAD_REL, name


@pytest.mark.parametrize("rank_chunk", [4, 2])
def test_rank_chunked_off_matches_jax(rank_chunk):
    """rho_nll_rank_chunked with kernel_stream="off" (the checkpoint
    forward once, the recompute adjoint in two time segments of 24 steps
    over T-1 = 49, unroll 4 not dividing it) against JAX's with
    stream=False: the value at rtol 1e-5 and the six gradients at
    test_torch_rank.py's tolerances."""
    from test_torch_rank import (VALUE_TOL, assert_grads_close,
                                 jax_value_and_grads, port_value_and_grads)
    from test_torch_rank import configs as rank_configs
    hp, jhp = rank_configs()
    d = np_rho_params(8, 8)
    sig = np_signals(4, 50)
    kw = dict(rank_chunk=rank_chunk, unroll=4)
    got, ggot = port_value_and_grads(lambda p: rank.rho_nll_rank_chunked(
        p, _off(hp), torch.as_tensor(sig), time_segment=24, **kw), d)
    want, gwant = jax_value_and_grads(lambda p: jrank.rho_nll_rank_chunked(
        p, jhp, jnp.asarray(sig), interpret=True, stream=False, **kw), d)
    np.testing.assert_allclose(got, want, **VALUE_TOL)
    assert_grads_close(ggot, gwant)


def _value_and_grads(fn, tp, names):
    loss = fn(tp)
    loss.backward()
    return loss.item(), {k: getattr(tp, k).grad for k in names}


class _Spy:
    """Records the step counts of a function's calls, then runs it."""

    def __init__(self, monkeypatch, module, name):
        self.fn, self.calls = getattr(module, name), []
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        se = args[4] if len(args) > 4 else kwargs["se"]
        self.calls.append(se.shape[0])
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("family", ["psi", "rho"])
def test_training_nll_off_matches_jax_and_runs_the_recompute(family,
                                                            monkeypatch):
    """training.nll_fn_for(fused=True) with kernel_stream="off" on the CPU:
    the value and six gradients against JAX's training.nll_fn_for at the
    same config (the XLA scan, which its kernels are pinned to). Spies show
    the path: the checkpoint forward ran once over all 82 steps, the
    segment recompute once a segment (the default rule at unroll 16: six
    segments of one block, the last of 2 steps), the adjoint once a segment
    over its steps only, and the streamed forward not at all."""
    if family == "psi":
        hp, jhp = psi_configs(scan_chunk=32)
        d, names = np_params(8), PsiParams.NAMES
        from_np = psi_params_from_numpy
        jp, _ = both(d)
        B = 4
    else:
        hp, jhp = rho_configs(rank=3, scan_chunk=32)
        d = np_rho_params(8, 3)
        names, from_np = RhoParams.NAMES, rho_params_from_numpy
        jp, _ = rho_both(d)
        B = 3
    sig = np_signals(B, T)
    spies = {n: _Spy(monkeypatch, block, f"{family}_{n}") for n in (
        "train_fwd_plain", "train_fwd_ckpt_plain", "recompute_plain",
        "train_bwd_plain")}
    got, ggot = _value_and_grads(
        lambda p: training.nll_fn_for(f"{family}_mps", fused=True)(
            p, _off(hp), torch.as_tensor(sig)), from_np(d, "cpu"), names)
    want, gwant = jax.value_and_grad(
        lambda p: jtraining.nll_fn_for(f"{family}_mps")(
            p, jhp, jnp.asarray(sig)))(jp)
    np.testing.assert_allclose(got, float(want), rtol=VALUE_RTOL)
    for k in names:
        assert max_rel(ggot[k], getattr(gwant, k)) < GRAD_REL, k
    segments = block.recompute_segments(T - 1, 16)
    steps = block.recompute_segment_steps(T - 1, 16)
    assert spies["train_fwd_plain"].calls == []
    assert spies["train_fwd_ckpt_plain"].calls == [T - 1]
    assert len(spies["recompute_plain"].calls) == len(segments) > 1
    assert spies["train_bwd_plain"].calls == [k1 - k0 for k0, k1 in segments]
    assert max(spies["train_bwd_plain"].calls) <= steps


def test_adam_step_off_matches_the_eager_step():
    """One Adam step of make_train_step("psi_mps", fused=True) with
    kernel_stream="off" (the recompute path's plain versions) against the
    eager step (core.psi_nll through chunked_scan) on the same parameters
    and batch: every metric to rtol 1e-5 and every parameter to max-rel
    1e-5, as test_torch_train.py holds the streamed path."""
    hp, _ = psi_configs(scan_chunk=32)
    d = np_params(8)
    batch = torch.as_tensor(np_signals(4, T, seed=2))
    ref = psi_params_from_numpy(d, "cpu")
    _, step = training.make_train_step("psi_mps", hp, ref, fused=False,
                                       device="cpu")
    m_ref = step(batch)
    tp = psi_params_from_numpy(d, "cpu")
    _, step = training.make_train_step("psi_mps", _off(hp), tp, fused=True,
                                       device="cpu")
    m = step(batch)
    for k in m_ref:
        np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-5,
                                   err_msg=k)
    for k in PsiParams.NAMES:
        assert max_rel(getattr(tp, k).detach(), getattr(ref, k).detach()) \
            < 1e-5, k


def _segment_sizes(n_steps, unroll=4):
    """time_segment values that split n_steps into 1, 2 and 3 segments."""
    sizes = [unroll * -(-block.n_blocks(n_steps, unroll) // k)
             for k in (1, 2, 3)]
    assert [len(block.recompute_segments(n_steps, unroll, ts))
            for ts in sizes] == [1, 2, 3]
    return sizes


@pytest.mark.parametrize("family", ["psi", "rho"])
def test_segments_change_only_the_order_of_the_sums(family):
    """The plain recompute adjoint in 1, 2 and 3 time segments (unroll 4:
    21 blocks over 82 steps, the last block short): dse, dt0 and the three
    cotangents within 1e-6 of their largest element (only dt crosses a
    segment boundary; the cotangents add per segment)."""
    if family == "psi":
        hp, _ = psi_configs()
        tp, B = psi_params_from_numpy(np_params(8), "cpu"), 4
    else:
        hp, _ = rho_configs(rank=3)
        tp, B = rho_params_from_numpy(np_rho_params(8, 3), "cpu"), 3
    ins = getattr(block, f"{family}_nll_inputs")(
        tp, hp, torch.as_tensor(np_signals(B, T)))
    kw = dict(log_eps=ins.pop("log_eps"), norm_eps=ins.pop("norm_eps"),
              unroll=4, defer_norm=True)
    _, ck = getattr(block, f"{family}_train_fwd_ckpt_plain")(**ins, **kw)
    con = [ins[k] for k in ("ab", "bb", "rb" if family == "psi" else "xb")]
    g = torch.linspace(0.5, 1.5, B)
    runs = [getattr(block, f"{family}_recompute_bwd_plain")(
        *con, ck, ins["se"], g, segment=ts, **kw)
        for ts in _segment_sizes(T - 1)]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert max_rel(a, b) < SEGMENT_REL


def test_rank_segments_change_only_the_order_of_the_sums():
    """rho_nll_rank_chunked with kernel_stream="off" in 1, 2 and 3 time
    segments (13 blocks of 4 over 49 steps): the value bit for bit, also
    the streamed path's (the forward does not segment), and the six
    gradients within 1e-6 of their largest element."""
    hp, _ = rho_configs(rank=8, minibatch_size=4)
    d = np_rho_params(8, 8)
    sig = torch.as_tensor(np_signals(4, 50))

    def nll(p, cfg, ts):
        return rank.rho_nll_rank_chunked(p, cfg, sig, rank_chunk=4, unroll=4,
                                         time_segment=ts)

    runs = [_value_and_grads(lambda p: nll(p, _off(hp), ts),
                             rho_params_from_numpy(d, "cpu"), RhoParams.NAMES)
            for ts in _segment_sizes(49)]
    stream_value = nll(rho_params_from_numpy(d, "cpu"), hp, None).item()
    for value, grads in runs[1:]:
        assert value == runs[0][0] == stream_value
        for k in RhoParams.NAMES:
            assert max_rel(grads[k], runs[0][1][k]) < SEGMENT_REL, k


def test_stream_policy_picks_the_recompute_path():
    """stream_policy, a pure function of the streams' bytes, the free bytes
    and kernel_stream: "auto" streams while the bytes fit and picks the
    recompute path past them; "on" streams past them too (the TPU's
    forced stream, which skips the budget); "off" never streams; no limit
    (the CPU) streams."""
    assert block.stream_policy(10, 10, "auto")
    assert not block.stream_policy(11, 10, "auto")
    assert block.stream_policy(11, 10, "on")
    assert not block.stream_policy(0, 10, "off")
    assert block.stream_policy(2 ** 40, None, "auto")
    assert not block.stream_policy(2 ** 40, None, "off")
    psi = block.stream_bytes(64, 1024, 16384)
    assert psi == 2 * 4 * 16383 * 128 * 1024      # 17.2 GB: the psi B=1024
    assert not block.stream_policy(psi, 16 * 10 ** 9, "auto")


def test_recompute_segment_rule():
    """Whole blocks; left None, ceil(n_blocks / (2 unroll)) blocks, so a
    segment's ys and dy (two states a step) hold about the checkpoints'
    bytes (one state a block): 512 steps at T=16384, unroll 16; a
    time_segment rounds up to whole blocks and caps at the run; the
    segments cover the steps once, last first."""
    assert block.recompute_segment_steps(16383, 16) == 512
    assert block.recompute_segment_steps(16384, 16) == 512
    assert block.recompute_segment_steps(82, 4) == 12
    assert block.recompute_segment_steps(82, 16) == 16
    assert block.recompute_segment_steps(82, 4, 10) == 12
    assert block.recompute_segment_steps(82, 4, 1000) == 84
    assert block.recompute_segment_steps(0, 4) == 4
    segs = block.recompute_segments(82, 4)
    assert segs[0] == (72, 82) and segs[-1] == (0, 12)
    assert sorted(k for s in segs for k in range(*s)) == list(range(82))
    assert len(block.recompute_segments(16383, 16)) == 32
    ck = block.n_blocks(16383, 16) * 128 * 1024 * 4
    seg = 2 * 512 * 128 * 1024 * 4
    assert ck == seg        # psi B=1024: 0.54 GB of each


def test_psi_recompute_span_rule():
    """A psi recompute CTA re-runs as many blocks as keep four CTAs an SM
    (its load of the constants costs about a block): at B=1024 a whole
    segment of 32 blocks, at B=128 seven, at B=8 one; never past the
    segment, never none."""
    assert block.psi_recompute_blocks(1024, 32, 132) == 32
    assert block.psi_recompute_blocks(128, 32, 132) == 7
    assert block.psi_recompute_blocks(8, 32, 132) == 1
    assert block.psi_recompute_blocks(4096, 3, 132) == 3
    assert block.psi_recompute_blocks(0, 0, 132) == 1
