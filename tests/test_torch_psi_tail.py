"""psi's adjoint split into a chain-free tail and a short chain (ops/block.py
psi_train_bwd_tail_plain and psi_train_bwd_chain_plain, the plain versions
of the two kernels of csrc/psi_train_bwd.cu) on the CPU, on numpy inputs
made from a seed: the tail followed by the chain is the plain adjoint
psi_train_bwd_plain, and at D=8 the custom VJP of the JAX package's
_psi_block_factory (its kernels in Pallas interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu.ops.pallas_scan import _pad_rows
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.ops import block
from audio_mps_tpu_torch.weights import psi_params_from_numpy
from test_torch_core import both, np_params, np_signals
from test_torch_train import configs, jax_block_inputs, max_rel

# the split adjoint against the whole one: the same fp32 arithmetic, the
# e-path cotangent q summed before it meets 2 dn2 y. At high a last-bit
# difference in dy can move its bf16 (hi, lo) split, whose dropped lo lo
# term is ~2^-16 of the value: 1e-4 there.
TOL_SPLIT = {"highest": 1e-5, "high": 1e-4}
# against the JAX custom VJP: the same function, every sum in another
# order; at high the bf16 splits again (1.9e-5 of dAb's largest element
# at D=8)
TOL_JAX = {"highest": 1e-5, "high": 1e-4}


def _inputs(D, B, T, seed):
    """The block inputs of seeded numpy weights and waveforms, a loss
    cotangent g [B] and a cotangent of the state after the last step."""
    cfg = CMPSConfig(bond_dim=D)
    p = psi_params_from_numpy(np_params(D, seed=seed), "cpu")
    ins = block.psi_nll_inputs(p, cfg, torch.as_tensor(np_signals(
        B, T, seed=seed + 1)))
    rng = np.random.default_rng(seed + 2)
    g = torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32))
    dtfin = torch.as_tensor(
        (0.1 * rng.standard_normal((2 * D, B))).astype(np.float32))
    return ins, g, dtfin


def _split(ins, g, ys, n2s, dtfin, **kw):
    """(dse, dt0, dy, dehat) of the plain tail, then the plain chain."""
    q, ds0, dehat, dn2_new = block.psi_train_bwd_tail_plain(
        ins["rb"], ins["se"], g, ys, n2s, log_eps=ins["log_eps"], **kw)
    dse, dt0, dy = block.psi_train_bwd_chain_plain(
        ins["ab"], ins["bb"], ins["t0"], ins["se"], ys, n2s, q, ds0,
        dn2_new, dtfin=dtfin, **kw)
    return dse, dt0, dy, dehat


@pytest.mark.parametrize("D", [8, 12])
@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("with_dtfin", [False, True])
def test_tail_then_chain_is_the_plain_adjoint(D, precision, defer,
                                              with_dtfin):
    """On a ragged run of 70 steps at unroll 16 (the last block partial),
    the tail's (q, ds0, dehat, dn2_new) through the chain give
    psi_train_bwd_plain's dse, dt0, dy and dehat within 1e-5 of each one's
    largest element at highest (1e-4 at high), with and without a cotangent
    dtfin carried in."""
    ins, g, dtfin = _inputs(D, 5, 71, seed=D)
    kw = dict(norm_eps=ins["norm_eps"], unroll=16, precision=precision,
              defer_norm=defer)
    _, ys, n2s = block.psi_train_fwd_plain(
        ins["ab"], ins["bb"], ins["rb"], ins["t0"], ins["se"],
        log_eps=ins["log_eps"], **kw)
    dtfin = dtfin if with_dtfin else None
    got = _split(ins, g, ys, n2s, dtfin, **kw)
    want = block.psi_train_bwd_plain(
        ins["ab"], ins["bb"], ins["rb"], ins["t0"], ins["se"], g, ys, n2s,
        log_eps=ins["log_eps"], dtfin=dtfin, **kw)
    for name, a, b in zip(("dse", "dt0", "dy", "dehat"), got, want):
        assert torch.isfinite(a).all(), name
        assert max_rel(a, b) <= TOL_SPLIT[precision], (name, max_rel(a, b))


def test_tail_wrapper_on_the_cpu_is_its_plain_version():
    """On CPU tensors psi_train_bwd_tail runs its plain version and counts
    no launch."""
    ins, g, _ = _inputs(8, 3, 40, seed=3)
    kw = dict(log_eps=ins["log_eps"], norm_eps=ins["norm_eps"], unroll=16,
              defer_norm=True)
    _, ys, n2s = block.psi_train_fwd_plain(
        ins["ab"], ins["bb"], ins["rb"], ins["t0"], ins["se"], **kw)
    before = block.psi_train_bwd_tail.launches
    got = block.psi_train_bwd_tail(ins["rb"], ins["se"], g, ys, n2s, **kw)
    want = block.psi_train_bwd_tail_plain(ins["rb"], ins["se"], g, ys, n2s,
                                          **kw)
    assert block.psi_train_bwd_tail.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("defer, stream, precision", [
    (True, True, "highest"), (True, True, "high"), (False, False, "highest")])
def test_split_adjoint_matches_the_jax_custom_vjp(defer, stream, precision):
    """At D=8, B=4, T=129 (128 steps, whole blocks of 16): dt0 and dse of
    the tail and chain, and dAb, dBb, dRb of the plain reductions on the
    chain's dy, against the custom VJP of _psi_block_factory on the same
    block constants, with a non-uniform loss cotangent g: within 1e-5 of
    each one's largest element at highest, 1e-4 at high."""
    T, B, unroll = 129, 4, 16
    _, jhp = configs(defer_norm=defer)
    jp, _ = both(np_params(8))
    sig = jnp.asarray(np_signals(B, T))
    ab, bb, rb, t0, incs = jax_block_inputs(jp, jhp, sig)
    fused = jblock._psi_block_factory(jhp, B, T, unroll, True, precision,
                                      defer, None, stream)
    g = np.linspace(0.5, 1.5, B).astype(np.float32)
    _, vjp = jax.vjp(fused, ab, bb, rb, t0, _pad_rows(incs, T - 1))
    want = dict(zip(("dab", "dbb", "drb", "dt0", "dse"), vjp(jnp.asarray(g))))

    ins = dict(zip(("ab", "bb", "rb", "t0", "se"),
                   (torch.as_tensor(np.array(x))
                    for x in (ab, bb, rb, t0, incs))))
    ins["log_eps"] = jhp.log_eps
    kw = dict(norm_eps=jhp.norm_eps, unroll=unroll, precision=precision,
              defer_norm=defer)
    _, ys, n2s = block.psi_train_fwd_plain(
        ins["ab"], ins["bb"], ins["rb"], ins["t0"], ins["se"],
        log_eps=jhp.log_eps, **kw)
    dse, dt0, dy, dehat = _split(ins, torch.as_tensor(g), ys, n2s, None,
                                 **kw)
    dab, dbb, drb = block.psi_cotangents_plain(dy, ys, ins["t0"], ins["se"],
                                               n2s, dehat, **kw)
    got = dict(dab=dab, dbb=dbb, drb=drb, dt0=dt0, dse=dse)
    for k in got:
        assert max_rel(got[k], want[k]) <= TOL_JAX[precision], \
            (k, max_rel(got[k], want[k]))
