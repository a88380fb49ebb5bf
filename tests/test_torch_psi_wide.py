"""psi past the quad layout of its block kernels (D <= 68): D=72 and the
training width of BASELINE config 5, D=128, which the card runs in the
cluster layout (ops/cluster.py, csrc/psi_cluster*.cu), held to the JAX
package on the same numpy inputs, on the CPU. Here every wrapper runs its
plain version (the function the cluster kernels compute; the card tests,
tests/test_torch_cuda.py, hold the kernels to it); JAX's block kernels run
in Pallas interpret mode. B=3, T=33: two 16-step blocks and a one-step
tail. Also the dispatch rule of the cluster layout, a pure function, on an
H100's numbers (132 SMs, 232448 bytes of shared memory a block)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu import training as jtraining
from audio_mps_tpu.models import params as jparams
from audio_mps_tpu.ops import pallas_block as jblock
from audio_mps_tpu_torch import training
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.models.params import PsiParams
from audio_mps_tpu_torch.ops import block, cluster, grad, scan
from audio_mps_tpu_torch.weights import psi_params_from_numpy
from test_torch_core import both, np_params, np_signals

B, T, UNROLL = 3, 33, 16
NAMES = PsiParams.NAMES
SMS, OPTIN = 132, 232448
# value rtol 1e-5 and gradient max-rel 1e-4, as tests/test_torch_train.py
VALUE_RTOL, GRAD_REL = 1e-5, 1e-4


def configs(D, **kw):
    base = dict(minibatch_size=B, bond_dim=D, scan_chunk=0)
    base.update(kw)
    return CMPSConfig(**base), jconfig.CMPSConfig(**base)


def max_rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def jax_made_params(D, seed=0):
    """psi weights made by the JAX package's init, as numpy (the weights
    carry-over: weights.psi_params_from_numpy takes them)."""
    _, jhp = configs(D)
    jp = jparams.init_psi(jax.random.PRNGKey(seed), jhp)
    return {k: np.asarray(getattr(jp, k)) for k in NAMES}


@pytest.mark.parametrize("D", [72, 128])
@pytest.mark.parametrize("stream", [True, False])
def test_trainable_value_and_grads_match_jax_past_the_quad_layout(D, stream):
    """grad.psi_nll_fused_trainable (PsiBlockNLL over the plain versions of
    the cluster kernels: the streamed pair, or with kernel_stream="off" the
    checkpoint forward and the recompute adjoint) against JAX's
    psi_nll_block_trainable with and without its state stream: the value
    and all six parameter gradients."""
    hp, jhp = configs(D, kernel_stream="on" if stream else "off")
    d = np_params(D)
    sig = np_signals(B, T)
    tp = psi_params_from_numpy(d, "cpu")
    loss = grad.psi_nll_fused_trainable(tp, hp, torch.as_tensor(sig),
                                        unroll=UNROLL, defer_norm=True)
    loss.backward()
    jp, _ = both(d)
    want, gwant = jax.value_and_grad(
        lambda p: jblock.psi_nll_block_trainable(
            p, jhp, jnp.asarray(sig), unroll=UNROLL, interpret=True,
            defer_norm=True, stream=stream))(jp)
    np.testing.assert_allclose(loss.item(), float(want), rtol=VALUE_RTOL)
    for k in NAMES:
        assert max_rel(getattr(tp, k).grad, getattr(gwant, k)) < GRAD_REL, k


def test_scoring_and_sampler_match_jax_at_d128():
    """At D=128 with weights made by JAX: scan.psi_nll_fused against JAX's
    psi_nll_block, and the block sampler (the cluster body on the card)
    against JAX's psi_sample_block on the same noise over 24 steps."""
    D = 128
    hp, jhp = configs(D)
    d = jax_made_params(D)
    jp, tp = both(d)
    assert block.psi_sample_body(D) == "cluster"
    sig = np_signals(B, T, seed=3)
    got = scan.psi_nll_fused(tp, hp, torch.as_tensor(sig), unroll=UNROLL)
    want = jblock.psi_nll_block(jp, jhp, jnp.asarray(sig), unroll=UNROLL,
                                interpret=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=VALUE_RTOL)
    noise = core._sample_noise(hp, torch.Generator().manual_seed(5), 2, 24,
                               1.0)
    got = scan.psi_sample_fused(tp, hp, noise)
    want = np.asarray(jblock.psi_sample_block(
        jp, jhp, jnp.asarray(noise.numpy()), interpret=True))
    assert got.shape == (2, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())


def test_three_train_steps_match_jax_at_d72():
    """Three Adam steps of the port's make_train_step on the kernel path
    (PsiBlockNLL over the plain cluster versions) against JAX's
    make_train_step("psi_mps", cfg, fused=False) on the same parameters and
    batches: every metric to rtol 1e-5 and every parameter to max-rel 1e-5
    after each step."""
    hp, jhp = configs(72)
    d = np_params(72)
    tp = psi_params_from_numpy(d, "cpu")
    _, step = training.make_train_step("psi_mps", hp, tp, fused=True,
                                       device="cpu")
    jp, _ = both(d)
    _, jstep = jtraining.make_train_step("psi_mps", jhp, fused=False)
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


def _kernel_inputs(D, steps=20, seed=2):
    hp, _ = configs(D)
    tp = psi_params_from_numpy(np_params(D), "cpu")
    inputs = block.psi_nll_inputs(tp, hp, torch.as_tensor(
        np_signals(B, steps + 1, seed=seed)))
    kw = dict(log_eps=inputs.pop("log_eps"), norm_eps=inputs.pop("norm_eps"),
              unroll=UNROLL, defer_norm=True)
    g = torch.linspace(0.5, 1.5, B)
    return inputs, kw, g


def test_cluster_wrappers_run_their_plain_versions_on_the_cpu():
    """On a CPU tensor each cluster wrapper is its plain version (and
    launches nothing): the NLL, the forwards, the recompute, the tail and
    the adjoint at D=72, the sampler at D=88."""
    inputs, kw, g = _kernel_inputs(72)
    before = [w.launches for w in cluster.WRAPPERS]
    loss, ys, n2s = cluster.psi_train_fwd_cluster(**inputs, **kw)
    for a, b in zip((loss, ys, n2s), block.psi_train_fwd_plain(**inputs,
                                                               **kw)):
        assert torch.equal(a, b)
    assert torch.equal(cluster.psi_nll_cluster(**inputs, **kw),
                       block.psi_nll_block_plain(**inputs, **kw))
    _, ck = cluster.psi_train_fwd_ckpt_cluster(**inputs, **kw)
    rk = {k: v for k, v in kw.items() if k != "log_eps"}
    r = cluster.psi_recompute_cluster(inputs["ab"], inputs["bb"],
                                      inputs["rb"], ck, inputs["se"], **rk)
    for a, b in zip(r, (ys, n2s)):
        assert torch.equal(a, b)
    tail = cluster.psi_train_bwd_tail_cluster(inputs["rb"], inputs["se"], g,
                                              ys, n2s, **kw)
    for a, b in zip(tail, block.psi_train_bwd_tail_plain(
            inputs["rb"], inputs["se"], g, ys, n2s, **kw)):
        assert torch.equal(a, b)
    bwd = cluster.psi_train_bwd_cluster(**inputs, g=g, ys=ys, n2s=n2s, **kw)
    for a, b in zip(bwd, block.psi_train_bwd_plain(**inputs, g=g, ys=ys,
                                                   n2s=n2s, **kw)):
        assert torch.equal(a, b)
    hp, _ = configs(88)
    s_in = block.psi_sample_inputs(
        psi_params_from_numpy(np_params(88), "cpu"), hp,
        core._sample_noise(hp, torch.Generator().manual_seed(1), 2, 12, 1.0))
    assert torch.equal(cluster.psi_sample_cluster(**s_in),
                       block.psi_sample_block_plain(**s_in))
    assert [w.launches for w in cluster.WRAPPERS] == before


def test_layout_rule_is_quad_exactly_where_psi_block_fits():
    """The quad layout (and psi_columns_per_cta's G) at every D % 4 == 0
    where psi_block_fits holds (D <= 68), the cluster layout from 72 to
    256, at batches of one column to past one wave."""
    for Bc in (1, 16, 128, 1024):
        for D in range(4, 257, 4):
            lay, C, G = cluster.psi_block_layout(D, Bc, SMS, OPTIN)
            if block.psi_block_fits(D):
                assert (lay, C) == ("quad", 1), D
                assert G == block.psi_columns_per_cta(Bc, D, SMS, OPTIN)
            else:
                assert lay == "cluster" and D >= 72, D
                assert cluster.cl_ok(D, C) and G in cluster.PSI_CLUSTER_COLS
                assert max(cluster.psi_cluster_fwd_smem_bytes(D, C, G),
                           cluster.psi_cluster_chain_smem_bytes(D, C, G)) \
                    <= OPTIN
                # the smallest cluster that holds the constants
                smaller = [c for c in cluster.PSI_CLUSTERS if c < C
                           and cluster.cl_ok(D, c)
                           and cluster.psi_cluster_fwd_smem_bytes(D, c, 1)
                           <= OPTIN]
                assert not smaller, (D, C)


@pytest.mark.parametrize("D, B_, want", [
    (72, 128, (2, 2)), (72, 1, (2, 1)), (128, 128, (4, 4)),
    (128, 16, (4, 1)), (192, 128, (8, 1)), (256, 16, (16, 2)),
    (256, 128, (16, 2))])
def test_layout_rule_picks_the_cluster_and_columns(D, B_, want):
    """C and G at the slice's shapes on an H100: D=128, B=128 takes 32
    clusters of 4 CTAs, 4 columns each (one wave of 132 SMs); D=256 takes
    16 CTAs a cluster, where G=4's buffers pass the shared memory."""
    assert cluster.psi_block_layout(D, B_, SMS, OPTIN) == ("cluster",) + want


@pytest.mark.parametrize("D", [260, 264, 512, 74, 130])
def test_layout_rule_refuses_past_the_cluster_layout(D):
    """Past D=256, and at D % 4 != 0 (the split layout's), the rule raises
    NotImplementedError naming ROADMAP queue B."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        cluster.psi_block_layout(D, 128, SMS, OPTIN)


@pytest.mark.parametrize("D, fwd, chain, tail, sample", [
    (72, 130176, 88704, 93696, 88272),
    (128, 217088, 151552, 108032, 140544),
    (192, 228864, 155136, 119232, 161664),
    (256, 217088, 151552, 140032, 150016)])
def test_cluster_byte_counts(D, fwd, chain, tail, sample):
    """The byte counts of the cluster layout's CTAs at D=72, 128, 192 and
    256 at the rule's C and G (the card test holds them to the kernels'
    own): three slabs of the CTA's rows of [2D,2D] in the forward, two in
    the chain, the tail's tile (its largest plan of the three precisions),
    the sampler's two slabs at its own cluster."""
    _, C, G = cluster.psi_block_layout(D, 128, SMS, OPTIN)
    assert cluster.psi_cluster_fwd_smem_bytes(D, C, G) == fwd
    assert cluster.psi_cluster_chain_smem_bytes(D, C, G) == chain
    assert cluster.psi_cluster_tail_smem_bytes(D) == tail
    Cs = cluster.psi_sample_cluster_for(D)
    assert cluster.psi_cluster_sample_smem_bytes(D, Cs) == sample
    assert max(fwd, chain, tail, sample) <= OPTIN


def test_sampler_bodies_and_clusters():
    """The block sampler's body: quad to D=64, row at 72 and 80, the
    cluster body from 88 to 256, at the smallest cluster that holds Ab and
    Bb (2 to D=96, 4 at 128, 16 at 256); past 256 the cluster rule
    raises."""
    for D in range(8, 257, 8):
        body = block.psi_sample_body(D)
        assert body == ("quad" if D <= 64 else "row" if D <= 80
                        else "cluster"), D
    assert [cluster.psi_sample_cluster_for(D) for D in (88, 96, 128, 256)] \
        == [2, 2, 4, 16]
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        cluster.psi_sample_cluster_for(264)
