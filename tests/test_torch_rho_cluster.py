"""The cluster rule of the rho block forward and adjoint chain
(``ops/block.rho_cluster_for``) and its shared-memory counts, on the CPU;
and a forced cluster that the rank's column groups do not admit, which
raises before any launch (on the CPU before the plain version runs; on a
card before the kernel launches, in the test marked for the card)."""
import numpy as np
import pytest
import torch

from audio_mps_tpu_torch.ops import block

# An H100's residency at the rho forward's ~200 KB CTA: one CTA an SM, and
# as many clusters as its GPCs hold (15 of 8, as the rank partials'
# clusters measured)
H100_RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15}


@pytest.mark.parametrize("D, B, rank, resident, want", [
    # the headline: B=8 examples of rank 64 in clusters of 8, 64 CTAs
    (64, 8, 64, H100_RESIDENT, 8),
    # rank 3: one column group, one CTA an example
    (64, 8, 3, H100_RESIDENT, 1),
    # B=132 examples already give every SM a CTA
    (64, 132, 64, H100_RESIDENT, 1),
    # 16 examples in clusters of 8 would take two waves of 15 clusters:
    # clusters of 4 (30 resident) keep one
    (64, 16, 64, H100_RESIDENT, 4),
    # a card that holds 7 clusters of 8: 8 examples would take two waves
    (64, 8, 64, {1: 132, 2: 66, 4: 30, 8: 7}, 4),
    # rank 48: 12 column groups, which 8 does not divide
    (64, 8, 48, H100_RESIDENT, 4),
    # clusters of 16 where the card holds enough of them
    (16, 2, 64, {1: 132, 2: 66, 4: 33, 8: 16, 16: 8}, 16),
    # and not where it holds none
    (16, 2, 64, {1: 132, 2: 66, 4: 33, 8: 16, 16: 0}, 8),
])
def test_rho_cluster_rule(D, B, rank, resident, want):
    assert block.rho_cluster_for(D, B, rank, 132, resident) == want
    assert block.rho_cluster_for(D, B, rank, 132,
                                 lambda c: resident.get(c, 0)) == want


@pytest.mark.parametrize("kernel", ["fwd", "recompute", "chain"])
def test_rho_cluster_rule_takes_the_recompute_blocks_and_the_chain(kernel):
    """The recompute's clusters are (example, block) pairs: 8 examples x 32
    blocks already fill the card, so it keeps one CTA each; the forward
    and the chain at B=8 take clusters of 8."""
    got = block.rho_cluster_for(64, 8 * 32, 64, 132, H100_RESIDENT,
                                kernel=kernel)
    assert got == 1
    if kernel != "recompute":
        assert block.rho_cluster_for(64, 8, 64, 132, H100_RESIDENT,
                                     kernel=kernel) == 8


def test_rho_cluster_rule_keeps_the_cta_in_shared_memory():
    """A C whose CTA does not fit the card's shared memory is not taken:
    at a 200 KB limit only clusters whose forward CTA holds its share of
    the segment beside the three constants in that much remain, and none
    below 8 does at D=64, rank 64."""
    sizes = {C: block.rho_fwd_smem_bytes(64, 64, C, nbuf=1)
             for C in block.RHO_CLUSTERS}
    limit = 200_000
    fit = [C for C, b in sizes.items() if b <= limit]
    assert fit and min(fit) >= 8
    assert block.rho_cluster_for(64, 132, 64, 132, {c: 132 // c for c in
                                                    block.RHO_CLUSTERS},
                                 smem_optin=limit) == min(fit)


def test_rho_smem_counts():
    """The forward CTA at D=64, rank 64: one example a CTA fits the H100's
    232448 bytes with one state buffer, not two; clusters of 2 and more
    take two; the recompute (no Xb) takes two at every C; the monolithic
    dispatch bound is the one-buffer CTA at C=1; the chain fits with two
    at every C."""
    optin = block.H100_SMEM_OPTIN
    assert block.rho_fwd_smem_bytes(64, 64, 1, nbuf=1) <= optin
    assert block.rho_fwd_smem_bytes(64, 64, 1, nbuf=2) > optin
    assert [block.rho_fwd_buffers(64, 64, C) for C in block.RHO_CLUSTERS] \
        == [1, 2, 2, 2, 2]
    assert all(block.rho_fwd_buffers(64, 64, C, recompute=True) == 2
               for C in block.RHO_CLUSTERS)
    assert block.rho_train_smem_bytes(64, 64) == \
        block.rho_fwd_smem_bytes(64, 64, 1, nbuf=1)
    assert all(block.rho_chain_smem_bytes(64, 64, C) <= optin
               for C in block.RHO_CLUSTERS)
    # every shape the rho kernels take fits at C=1
    for D in range(4, 65, 4):
        for rank in (1, 3, 17, 60, 64):
            assert block.rho_train_smem_bytes(D, rank) <= optin
            assert block.rho_chain_smem_bytes(D, rank, 1) <= optin


@pytest.mark.parametrize("name", ["rho_nll_block", "rho_train_fwd",
                                  "rho_train_fwd_ckpt", "rho_train_bwd"])
@pytest.mark.parametrize("cluster", [3, 32, 8])
def test_a_forced_cluster_the_groups_do_not_admit_raises(name, cluster):
    """rank 12 has 3 column groups: a cluster of 3 is not a size the
    kernels take, 32 is past them, and 8 does not divide 3."""
    rng = np.random.default_rng(0)
    D, B, rank, T = 4, 2, 12, 5
    n = 2 * D
    t = {k: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
         for k, s in dict(ab=(n, n), bb=(n, n), xb=(n, n),
                          t0=(n, B * rank), se=(T, B)).items()}
    kw = dict(log_eps=-30.0, norm_eps=1e-30, cluster=cluster)
    if name == "rho_train_bwd":
        extra = dict(g=torch.ones(B), ys=torch.zeros(T, n, B * rank),
                     trs=torch.ones(T, B))
    else:
        extra = {}
    with pytest.raises(ValueError, match="column groups"):
        getattr(block, name)(**t, **extra, **kw)


@pytest.mark.parametrize("cluster", [3, 8])
def test_a_forced_recompute_cluster_the_groups_do_not_admit_raises(cluster):
    D, B, rank, T = 4, 2, 12, 5
    n = 2 * D
    z = dict(ab=torch.zeros(n, n), bb=torch.zeros(n, n),
             xb=torch.zeros(n, n), ck=torch.zeros(1, n, B * rank),
             se=torch.zeros(T, B))
    with pytest.raises(ValueError, match="column groups"):
        block.rho_recompute(**z, norm_eps=1e-30, cluster=cluster)


# The sampler (csrc/rho_sample.cu) takes its cluster by the same rule
# (kernel="sample"): an H100 holds 15 clusters of 8 of its ~200 KB CTA and
# 7 of 16, as of the forward's CTA of that size
H100_SAMPLE_RESIDENT = {**H100_RESIDENT, 16: 7}


@pytest.mark.parametrize("chains, resident, want", [
    # 8 chains in clusters of 8 (64 CTAs): 16 would take two waves of 7
    (8, H100_SAMPLE_RESIDENT, 8),
    # one chain over 16 SMs where the card holds a cluster of 16
    (1, H100_SAMPLE_RESIDENT, 16),
    # and over 8 where it holds none
    (1, {**H100_SAMPLE_RESIDENT, 16: 0}, 8),
    # 66 clusters of 2 fill the card in one wave; from 67 chains clusters
    # of 2 would take two, so one CTA a chain (the paired tile)
    (66, H100_SAMPLE_RESIDENT, 2),
    (67, H100_SAMPLE_RESIDENT, 1),
    (132, H100_SAMPLE_RESIDENT, 1),
])
def test_rho_sampler_cluster_rule(chains, resident, want):
    assert block.rho_cluster_for(64, chains, 64, 132, resident,
                                 kernel="sample") == want


def test_rho_sampler_smem_counts():
    """The sampler CTA at D=64, rank 64: the three constants whole beside
    its columns' state. One chain a CTA (C=1) fits the H100 with one state
    buffer, not two; at C=8 two buffers of 8 columns."""
    optin = block.H100_SMEM_OPTIN
    consts = 3 * 128 * 128 * 4
    one = block.rho_sample_smem_bytes(64, 64, 1, nbuf=1)
    assert one == consts + 128 * 64 * 4 + 4 * 3 * 2 * 4 * 16 <= optin
    assert block.rho_sample_smem_bytes(64, 64, 1, nbuf=2) > optin
    assert block.rho_sample_buffers(64, 64, 1) == 1
    assert block.rho_sample_smem_bytes(64, 64, 8) == \
        consts + 2 * 128 * 8 * 4 + 4 * 3 * 2 * 4 * 2
    assert [block.rho_sample_buffers(64, 64, C) for C in block.RHO_CLUSTERS] \
        == [1, 2, 2, 2, 2]
    # every shape the block sampler takes fits at C=1
    for D in range(8, 65, 8):
        for rank in (1, 3, 17, 60, 64):
            assert block.rho_sample_smem_bytes(
                D, rank, 1, block.rho_sample_buffers(D, rank, 1)) <= optin


@pytest.mark.parametrize("cluster", [3, 32, 8])
def test_a_forced_sampler_cluster_the_groups_do_not_admit_raises(
        cluster, monkeypatch):
    """rank 12 has 3 column groups: the sampler refuses the cluster on the
    CPU before its plain version runs."""
    ran = []
    monkeypatch.setattr(block, "rho_sample_block_plain",
                        lambda *a, **k: ran.append(1))
    D, N, rank, T = 8, 2, 12, 5
    n = 2 * D
    z = dict(ab=torch.zeros(n, n), bb=torch.zeros(n, n),
             xb=torch.zeros(n, n), pc=torch.ones(D), ps=torch.zeros(D),
             t0=torch.zeros(n, N * rank), noise=torch.zeros(T, N),
             inv_a=torch.ones(1))
    with pytest.raises(ValueError, match="column groups"):
        block.rho_sample_block(**z, dt=1e-3, norm_eps=1e-30,
                               cluster=cluster)
    assert not ran
