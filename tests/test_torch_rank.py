"""The port's rank-chunked rho training (audio_mps_tpu_torch/ops/rank.py:
the partials' plain kernel versions under RankPartials, the host
combination, the time segments and the dispatch rule) against the JAX
package's ops/pallas_rank.py on the same numpy inputs, on the CPU. The JAX
partials kernels run in Pallas interpret mode, as tests/test_pallas_rank.py
runs them. D=8, B=4, rank 8, T=65 (and T=50, where unroll 4 does not divide
T-1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu.models.cell import make_constants as jmake_constants
from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu.ops import pallas_rank as jrank
from audio_mps_tpu_torch import training
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.models.params import RhoParams
from audio_mps_tpu_torch.ops import block, rank
from audio_mps_tpu_torch.weights import rho_params_from_numpy
from test_torch_core import np_signals
from test_torch_rho import np_rho_params, rho_both, rho_configs
from test_torch_train import GRAD_REL, max_rel

B, T, D = 4, 65, 8
NAMES = RhoParams.NAMES
# JAX's own tolerances for the chunked path (tests/test_pallas_rank.py):
# the value at rtol 1e-5 / atol 1e-6, the gradients at atol 5e-6 /
# rtol 1e-4 (_assert_grads_close), bf16x3 at rtol 2e-3 / atol 2e-4.
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=5e-6)
HIGH_TOL = dict(rtol=2e-3, atol=2e-4)


def configs(rank_=8, **kw):
    return rho_configs(rank=rank_, minibatch_size=B, **kw)


def port_value_and_grads(fn, d):
    tp = rho_params_from_numpy(d, "cpu")
    loss = fn(tp)
    loss.backward()
    return loss.item(), {k: getattr(tp, k).grad.numpy() for k in NAMES}


def jax_value_and_grads(fn, d):
    jp, _ = rho_both(d)
    v, g = jax.value_and_grad(fn)(jp)
    return float(v), {k: np.asarray(getattr(g, k)) for k in NAMES}


def assert_grads_close(got, want):
    for k in NAMES:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("rank_chunk, time_segment, stream", [
    (8, None, True), (4, None, True), (2, None, True), (1, None, True),
    (4, 8, False), (2, 20, True)])
def test_chunked_value_and_grads_match_jax(rank_chunk, time_segment, stream):
    """rho_nll_rank_chunked's value and six gradients against JAX's at every
    chunking of rank 8, unroll 4, with and without time segments (the
    port's under torch.utils.checkpoint) and with JAX's streamed and
    recompute adjoints."""
    hp, jhp = configs()
    d = np_rho_params(D, 8)
    sig = np_signals(B, T)
    kw = dict(rank_chunk=rank_chunk, unroll=4, time_segment=time_segment)
    got, ggot = port_value_and_grads(lambda p: rank.rho_nll_rank_chunked(
        p, hp, torch.as_tensor(sig), **kw), d)
    want, gwant = jax_value_and_grads(lambda p: jrank.rho_nll_rank_chunked(
        p, jhp, jnp.asarray(sig), interpret=True, stream=stream, **kw), d)
    np.testing.assert_allclose(got, want, **VALUE_TOL)
    assert_grads_close(ggot, gwant)


def test_chunked_low_rank_and_uneven_unroll_match_jax():
    """initial_rank=4 in chunks of 2, T-1 = 49 steps at unroll 4: the port's
    loop over the real steps against JAX's zero-padded last block."""
    hp, jhp = configs(4)
    d = np_rho_params(D, 4)
    sig = np_signals(B, 50)
    kw = dict(rank_chunk=2, unroll=4)
    got, ggot = port_value_and_grads(lambda p: rank.rho_nll_rank_chunked(
        p, hp, torch.as_tensor(sig), **kw), d)
    want, gwant = jax_value_and_grads(lambda p: jrank.rho_nll_rank_chunked(
        p, jhp, jnp.asarray(sig), interpret=True, stream=True, **kw), d)
    np.testing.assert_allclose(got, want, **VALUE_TOL)
    assert_grads_close(ggot, gwant)
    np.testing.assert_allclose(
        got, core.rho_nll_factor(rho_params_from_numpy(d, "cpu"), hp,
                                 torch.as_tensor(sig)).item(), **VALUE_TOL)


def test_chunked_high_precision_matches_jax():
    """bf16x3: the port forms (Ab + s Bb) before its split where JAX splits
    Ab and Bb, so the two agree to the mode's rounding."""
    hp, jhp = configs()
    d = np_rho_params(D, 8)
    sig = np_signals(B, T)
    got = rank.rho_nll_rank_chunked(
        rho_params_from_numpy(d, "cpu"), hp, torch.as_tensor(sig),
        rank_chunk=4, unroll=4, precision="high").item()
    jp, _ = rho_both(d)
    want = float(jrank.rho_nll_rank_chunked(
        jp, jhp, jnp.asarray(sig), rank_chunk=4, unroll=4, interpret=True,
        precision="high"))
    np.testing.assert_allclose(got, want, **HIGH_TOL)


def test_partials_match_jax_at_one_chunk():
    """rho_nll_rank_partials' (ehat, trp, gamma, seb) at the whole rank
    against JAX's (one group)."""
    hp, jhp = configs()
    d = np_rho_params(D, 8)
    sig = np_signals(B, T)
    got = rank.rho_nll_rank_partials(rho_params_from_numpy(d, "cpu"), hp,
                                     torch.as_tensor(sig), unroll=4)
    jp, _ = rho_both(d)
    want = jrank.rho_nll_rank_partials(jp, jhp, jnp.asarray(sig), unroll=4,
                                       interpret=True, stream=True)
    # ehat sums y .* Xb y over an indefinite X, so it is held relative to
    # its largest element (max-rel 1e-5), as trp; gamma is an absolute log
    # scale, a sum of 16 block-exit log traces, held to atol 2e-5 (a
    # relative 2e-5 on e^gamma, which the combination divides out)
    for name, a, b in zip(("ehat", "trp", "gamma"), got[:3], want[:3]):
        assert a.shape == (1, T - 1, B), name
        if name == "gamma":
            np.testing.assert_allclose(a[0].detach().numpy(), np.asarray(b),
                                       rtol=0, atol=2e-5)
        else:
            assert max_rel(a[0], b) < 1e-5, name
    np.testing.assert_allclose(got[3].detach().numpy(), np.asarray(want[3]),
                               rtol=1e-6)


def test_combine_matches_jax_value_and_grads():
    """combine_rank_partials on the same random partials of 3 chunks: the
    value and its gradients with respect to every input."""
    rng = np.random.default_rng(7)
    G, L = 3, 20
    eh = (0.01 * rng.standard_normal((G, L, B))).astype(np.float32)
    trp = rng.uniform(0.5, 1.5, (G, L, B)).astype(np.float32)
    gam = rng.uniform(-3.0, 3.0, (G, L, B)).astype(np.float32)
    seb = (0.1 * rng.standard_normal((L, B))).astype(np.float32)
    hp, jhp = configs()
    ins = [torch.tensor(x, requires_grad=True) for x in (eh, trp, gam, seb)]
    got = rank.combine_rank_partials(*ins, hp)
    got.backward()
    want, gwant = jax.value_and_grad(
        lambda *a: jrank.combine_rank_partials(*a, jhp),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, (eh, trp, gam, seb)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for x, g in zip(ins, gwant):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


def test_plain_adjoint_matches_the_jax_custom_vjp():
    """The plain forward, adjoint and cotangents of one chunk of 4 rows
    against the custom VJP of _rank_partials_factory (streamed) on the same
    block constants, initial rows and cotangents (deh, dtr, dtfin): ehat,
    tr, tfin, and dAb, dBb, dXb, dt0 and dse (JAX's per rank lane, summed
    per example). T-1 = 64 is a whole number of unroll-4 blocks, so tfin
    is the state after the same steps on both sides."""
    r_loc, unroll = 4, 4
    hp, jhp = configs()
    d = np_rho_params(D, 8)
    d.update(Wx=d["Wx"][:r_loc], Wy=d["Wy"][:r_loc])
    jp, tp = rho_both(d)
    sig = np_signals(B, T)
    cc = jmake_constants(jp, jhp)
    ab, bb, xb = jblock._rho_block_constants(cc)
    ins, _ = rank.partials_inputs(tp, hp, torch.as_tensor(sig), r_loc)
    t0 = jnp.asarray(ins["t0"].numpy())
    seb = jnp.asarray(ins["se"].numpy())
    rng = np.random.default_rng(9)
    n_steps, n, cols = T - 1, 2 * D, B * r_loc
    deh = rng.standard_normal((n_steps, B)).astype(np.float32)
    dtr = rng.standard_normal((n_steps, B)).astype(np.float32)
    dtfin = (0.1 * rng.standard_normal((n, cols))).astype(np.float32)
    zmat = jnp.repeat(jnp.eye(B, dtype=jnp.float32), r_loc, axis=0)
    fused = jrank._rank_partials_factory(jhp, B, T, r_loc, unroll, True,
                                         "highest", True)
    outs, vjp = jax.vjp(lambda *a: fused(*a, zmat, zmat.T), ab, bb, xb, t0,
                        jnp.repeat(seb, r_loc, axis=1))
    dab, dbb, dxb, dt0, dse = vjp((jnp.asarray(deh), jnp.asarray(dtr),
                                   jnp.asarray(dtfin)))

    # the port's kernel inputs are its own build of the same constants
    for a, b in zip((ins["ab"], ins["bb"], ins["xb"]), (ab, bb, xb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    kw = dict(rc=r_loc, unroll=unroll, norm_eps=hp.norm_eps)
    pins = [ins[k] for k in ("ab", "bb", "xb", "t0", "se")]
    eh, tr, tfin, ys = rank.rank_partials_fwd_plain(*pins, **kw)
    for a, b in zip((eh, tr, tfin), outs):
        assert max_rel(a, b) < 1e-5
    g_dse, g_dt0, g_dy = rank.rank_partials_bwd_plain(
        *pins, ys, tr, torch.as_tensor(deh), torch.as_tensor(dtr),
        torch.as_tensor(dtfin), **kw)
    g_ab, g_bb, g_xb = rank.rank_cotangents_plain(
        g_dy, ys, ins["t0"], ins["se"], tr, torch.as_tensor(deh), **kw)
    want = dict(dab=dab, dbb=dbb, dxb=dxb, dt0=dt0,
                dse=np.asarray(dse).reshape(n_steps, B, r_loc).sum(-1))
    got = dict(dab=g_ab, dbb=g_bb, dxb=g_xb, dt0=g_dt0, dse=g_dse)
    for k in got:
        assert max_rel(got[k], want[k]) < GRAD_REL, k


@pytest.mark.parametrize("D_, rank_, chunked", [
    (8, 8, False), (64, 64, False), (64, 8, False), (68, 68, True),
    (72, 4, True), (128, 128, True), (256, 256, True), (512, 512, True)])
def test_dispatch_rule(D_, rank_, chunked):
    """The pure rule on the H100's limits: the monolithic kernels up to
    D=64 and rank 64, rank chunks beyond, each a divisor of the rank whose
    segment fits the thread layout and 227 KB; D=256 at rank 256, B=8 takes
    chunks of 16 rows (128 CTAs on 132 SMs)."""
    rc = rank.rho_train_chunk(D_, 8, rank_)
    if not chunked:
        assert rc is None
        return
    assert rank_ % rc == 0 and rank.partials_fits(D_, rc)
    assert rank.partials_smem_bytes(D_, rc) <= rank.H100_SMEM_PER_BLOCK
    if (D_, rank_) == (256, 256):
        assert rc == 16


def test_dispatch_rule_limits():
    """A smaller shared memory sends D=64 chunked; a D whose row groups
    alone pass 256 threads raises; a chunk divides the rank even when it is
    prime."""
    assert rank.rho_train_chunk(64, 8, 64, smem_limit=200_000) is not None
    with pytest.raises(NotImplementedError):
        rank.rho_train_chunk(1028, 8, 4)
    assert rank.rank_chunk_for(256, 8, 13) in (1, 13)
    assert rank.segment_steps(8, 32, 64, 4, "cpu") is None
    assert rank.segment_steps(8, 32, 64, 4, "cpu", time_segment=10) == 12
    assert rank.segment_steps(8, 32, 64, 4, "cpu", time_segment=64) is None


# Clusters of c partials CTAs an H100 80GB HBM3 holds at once at the
# partials CTA's shared memory (cudaOccupancyMaxActiveClusters, c = 1..16).
H100_RESIDENT = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15,
                 9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}


@pytest.mark.parametrize("G, ctas, want", [
    (16, 128, 2),      # the D=256 model: 15 clusters of 8 would take 2 waves
    (16, 128 * 32, 2),  # its segment recompute, 32 blocks a segment
    (16, 3 * 128, 2),  # its adjoint tail, 3 step ranges a segment
    (4, 8, 4), (3, 3, 3), (1, 8, 1), (13, 13, 13), (17, 34, 1),
    (16, 16, 16), (8, 240, 8)])
def test_cluster_rule(G, ctas, want):
    """The cluster of a partials launch: the largest c <= 16 that divides
    an example's G chunks and adds no wave on the card's residency; a
    mapping and a callable give the same, a size the card cannot hold is
    skipped, and an explicit cluster must divide G."""
    assert rank.partials_cluster(G, ctas, H100_RESIDENT) == want
    assert rank.partials_cluster(G, ctas, H100_RESIDENT.get) == want
    none_of_two = {**H100_RESIDENT, 2: 0}
    assert rank.partials_cluster(G, ctas, none_of_two) != 2
    assert rank.launch_cluster(256, 16, G, ctas, "cpu", cluster=1) == 1
    if G > 1:
        with pytest.raises(ValueError, match="divide"):
            rank.launch_cluster(256, 16, G, ctas, "cpu", cluster=G + 1)
    assert rank.tail_split(128, 16384) == 3
    assert rank.tail_split(1, 5) == 5


def test_training_dispatch_runs_chunked_past_d64(monkeypatch):
    """The kernel path at D=68 (past the monolithic kernels) goes through
    the partials, never rho_nll_block_trainable, and equals the eager
    factor scan."""
    cfg = dataclasses.replace(configs()[0], bond_dim=68, initial_rank=8)
    d = np_rho_params(68, 8)
    sig = torch.as_tensor(np_signals(2, 20))

    def refuse(*a, **k):
        raise AssertionError("the monolithic path ran past D=64")

    monkeypatch.setattr(block, "rho_nll_block_trainable", refuse)
    got = training.nll_fn_for("rho_mps", fused=True)(
        rho_params_from_numpy(d, "cpu"), cfg, sig)
    want = core.rho_nll_factor(rho_params_from_numpy(d, "cpu"), cfg, sig)
    np.testing.assert_allclose(got.item(), want.item(), **VALUE_TOL)


def test_adam_step_through_the_chunked_loss_matches_the_eager_step():
    """One Adam step whose NLL is rho_nll_rank_chunked (chunks of 4, two
    time segments) against make_train_step("rho_mps", fused=False) (the
    eager core.rho_nll_factor) on the same parameters and batch: the loss
    and every parameter after the step."""
    hp, _ = configs()
    d = np_rho_params(D, 8)
    batch = torch.as_tensor(np_signals(B, T))
    ref = rho_params_from_numpy(d, "cpu")
    _, step = training.make_train_step("rho_mps", hp, ref, fused=False,
                                       device="cpu")
    m_ref = step(batch)
    tp = rho_params_from_numpy(d, "cpu")
    opt = training.make_optimizer(hp, tp)
    nll = rank.rho_nll_rank_chunked(tp, hp, batch, rank_chunk=4,
                                    time_segment=32)
    total, _ = core.regularized_loss(nll, tp, hp)
    total.backward()
    opt.step()
    np.testing.assert_allclose(nll.item(), m_ref["model_loss"].item(),
                               **VALUE_TOL)
    for k in NAMES:
        assert max_rel(getattr(tp, k).detach(), getattr(ref, k).detach()) \
            < 1e-5, k
