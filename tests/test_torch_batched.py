"""The port's spine/limbs psi training pair (audio_mps_tpu_torch/ops/block.py
psi_batched_fwd_plain, psi_batched_bwd_plain and PsiBlockNLL's "batched"
mode) against the JAX package's _psi_block_factory with batched=True
(pallas_block._make_psi_fwd_kernel_batched :276 and
_make_psi_bwd_kernel_batched :338) on the same numpy inputs, on the CPU.
The JAX kernels run in Pallas interpret mode. D=8, B=4, T=197 with unroll
8, the shape of tests/test_pallas_block.py::
test_batched_limb_kernels_match_standard: T-1 = 196 is no multiple of 8
(nor of 16), so the TPU's zero-padded last block is exercised against the
port's loop over the real steps.

Tolerances, as in tests/test_torch_train.py: at highest the loss at 1e-5
(the mean at rtol, the per-example losses at max-rel of the largest); dse,
dt0 and the [2D,2D] cotangents at max-rel 1e-4 of their largest element
(the same fp32 arithmetic in another summation order); the checkpoints at
max-rel 1e-5. At high the loss and the checkpoints are held at 1e-4: the
bf16 (hi, lo) splits of states that differ in their last fp32 bits round
apart, ~1e-6 of a step's term, and an example's sum of 196 terms of either
sign sits near 0, so over this run its error reaches ~1e-4 of the largest
loss, as the port's streamed and recompute pairs' does (both give the
same losses as the batched pair here). The plain pair against the port's
recompute path (the same states, blocks summed in another order) at
1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu.ops.pallas_scan import _pad_rows
from audio_mps_tpu_torch.ops import block
from test_torch_core import both, np_params, np_signals
from test_torch_train import (GRAD_REL, NAMES, VALUE_RTOL, configs,
                              jax_block_inputs, max_rel,
                              port_value_and_grads)

T = 197
B = 4
LOSS_REL = {"highest": VALUE_RTOL, "high": GRAD_REL}
CK_REL = {"highest": 1e-5, "high": 1e-4}
RECOMPUTE_REL = 1e-6


def _jax_factory(jhp, unroll, precision):
    return jblock._psi_block_factory(jhp, B, T, unroll, True, precision,
                                     True, True)


@pytest.mark.parametrize("precision, unroll", [
    ("highest", 8), ("highest", 16), ("high", 8)])
def test_plain_pair_matches_the_jax_batched_vjp(precision, unroll):
    """loss and ck of the plain forward, then dAb, dBb, dRb, dt0 and dse of
    the plain adjoint (fed the JAX checkpoints) against the custom VJP of
    the batched factory, with a non-uniform loss cotangent g; the JAX dse
    is compared on its real rows."""
    _, jhp = configs(defer_norm=True)
    jp, _ = both(np_params(8))
    ab, bb, rb, t0, incs = jax_block_inputs(jp, jhp, jnp.asarray(
        np_signals(B, T)))
    n_steps = T - 1
    fused = _jax_factory(jhp, unroll, precision)
    g = np.linspace(0.5, 1.5, B).astype(np.float32)
    loss, res = fused.fwd(ab, bb, rb, t0, _pad_rows(
        incs, block.n_blocks(n_steps, unroll) * unroll))
    want = dict(zip(("dab", "dbb", "drb", "dt0", "dse"),
                    fused.bwd(res, jnp.asarray(g))))
    want["dse"] = np.asarray(want["dse"])[:n_steps]

    ins = [torch.as_tensor(np.array(x)) for x in (ab, bb, rb, t0, incs)]
    kw = dict(log_eps=jhp.log_eps, norm_eps=jhp.norm_eps, unroll=unroll,
              precision=precision)
    tloss, ck = block.psi_batched_fwd_plain(*ins, **kw)
    assert max_rel(tloss, loss) < LOSS_REL[precision]
    assert ck.shape == res[4].shape
    assert max_rel(ck, res[4]) < CK_REL[precision]
    dse, dt0, dab, dbb, drb = block.psi_batched_bwd_plain(
        ins[0], ins[1], ins[2], torch.as_tensor(np.array(res[4])), ins[4],
        torch.as_tensor(g), **kw)
    assert dse.shape == (n_steps, B)
    got = dict(dab=dab, dbb=dbb, drb=drb, dt0=dt0, dse=dse)
    for k in got:
        assert max_rel(got[k], want[k]) < GRAD_REL, k


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_batched_trainable_grads_match_jax(precision):
    """The value and the six parameter gradients through autograd of
    psi_nll_block_trainable(batched=True) against jax.grad of the mean of
    the JAX batched factory over the same block constants
    (test_pallas_block.py:218-232)."""
    hp, jhp = configs(defer_norm=True)
    d = np_params(8, seed=3)
    sig = np_signals(B, T, seed=2)
    unroll = 8
    got, ggot = port_value_and_grads(
        lambda p: block.psi_nll_block_trainable(
            p, hp, torch.as_tensor(sig), unroll=unroll, precision=precision,
            defer_norm=True, batched=True), d)
    jp, _ = both(d)
    fused = _jax_factory(jhp, unroll, precision)

    def jnll(p):
        ab, bb, rb, t0, incs = jax_block_inputs(p, jhp, jnp.asarray(sig))
        se = _pad_rows(incs, block.n_blocks(T - 1, unroll) * unroll)
        return jnp.mean(fused(ab, bb, rb, t0, se))

    want, gwant = jax.value_and_grad(jnll)(jp)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_REL[precision])
    for k in NAMES:
        assert max_rel(ggot[k], getattr(gwant, k)) < GRAD_REL, k


@pytest.mark.parametrize("precision, unroll", [("highest", 8),
                                               ("high", 16)])
def test_plain_pair_equals_the_recompute_path(precision, unroll):
    """The batched pair and the recompute path (psi_train_fwd_ckpt_plain,
    psi_recompute_bwd_plain) compute the same function: the loss and the
    checkpoints exactly, the adjoint within 1e-6 of each output's largest
    element; and the six parameter gradients of the two trainable modes
    within 1e-6."""
    hp, _ = configs(defer_norm=True, kernel_stream="off")
    d = np_params(8)
    sig = torch.as_tensor(np_signals(B, T))
    _, tp = both(d)
    ins = block.psi_nll_inputs(tp, hp, sig)
    eps = dict(log_eps=ins.pop("log_eps"), norm_eps=ins.pop("norm_eps"))
    kw = dict(eps, unroll=unroll, precision=precision)
    loss, ck = block.psi_batched_fwd_plain(**ins, **kw)
    loss_c, ck_c = block.psi_train_fwd_ckpt_plain(**ins, **kw,
                                                  defer_norm=True)
    assert torch.equal(loss, loss_c) and torch.equal(ck, ck_c)
    g = torch.linspace(0.5, 1.5, B)
    con = (ins["ab"], ins["bb"], ins["rb"], ck, ins["se"], g)
    got = block.psi_batched_bwd_plain(*con, **kw)
    want = block.psi_recompute_bwd_plain(*con, **kw, defer_norm=True)
    for label, a, b in zip(("dse", "dt0", "dab", "dbb", "drb"), got, want):
        assert max_rel(a, b) < RECOMPUTE_REL, label
    grads = {}
    for batched in (False, True):
        _, grads[batched] = port_value_and_grads(
            lambda p: block.psi_nll_block_trainable(
                p, hp, sig, unroll=unroll, precision=precision,
                defer_norm=True, batched=batched), d)
    for k in NAMES:
        assert max_rel(grads[True][k], grads[False][k].numpy()) \
            < RECOMPUTE_REL, k


def test_batched_mode_needs_the_deferred_norm():
    """As the TPU factory (pallas_block.py:1110), the batched pair refuses
    the per-step norm."""
    hp, _ = configs(defer_norm=False)
    _, tp = both(np_params(8))
    with pytest.raises(ValueError, match="deferred"):
        block.psi_nll_block_trainable(tp, hp, torch.as_tensor(
            np_signals(B, 33)), unroll=8, defer_norm=False, batched=True)


@pytest.mark.parametrize("unroll, want", [(1, 64), (5, 60), (7, 63),
                                          (16, 64), (17, 51), (40, 40),
                                          (64, 64), (100, 100)])
def test_batched_window_rule(unroll, want):
    """The batched adjoint's contraction window: the most whole blocks
    within 64 steps, at least one block."""
    assert block.psi_batched_window(unroll) == want
    assert want % unroll == 0 and want >= unroll

