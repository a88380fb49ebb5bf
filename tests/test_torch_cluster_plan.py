"""The pure functions of psi's cluster layout (ops/cluster.py) on an H100's
numbers (132 SMs, 232448 bytes of shared memory a block): the tail's tile
plan (csrc/psi_cluster_bwd.cu ClTailPlan: one tiled product u = S y over
tiles of (step, column) lanes, S's slabs through shared memory), the byte
counts of the forward's and the chain's CTAs, the rows each CTA of a
cluster holds (the point-to-point exchange runs among the CTAs that hold
rows), and the layout rule's choices at D = 72, 128, 192 and 256. The card
test tests/test_torch_cuda.py holds the mirrors to the kernels' own."""
import pytest

from audio_mps_tpu_torch.ops import block, cluster

SMS, OPTIN = 132, 232448


def _plan(threads, np_, rm, rn, rt, lt, smem):
    return dict(threads=threads, np=np_, rm=rm, rn=rn, rt=rt, lt=lt,
                nl=rn * lt, smem=smem)


@pytest.mark.parametrize("D, precision, plan", [
    (72, "highest", _plan(256, 144, 8, 8, 18, 14, 93696)),
    (72, "high", _plan(256, 144, 4, 8, 36, 7, 92352)),
    (128, "highest", _plan(256, 256, 8, 8, 32, 8, 108032)),
    (128, "high", _plan(256, 256, 4, 8, 64, 4, 107264)),
    (128, "default", _plan(256, 256, 8, 8, 32, 8, 108032)),
    (192, "highest", _plan(256, 384, 8, 8, 48, 5, 119232)),
    (256, "highest", _plan(256, 512, 8, 8, 64, 4, 140032)),
    (256, "high", _plan(256, 512, 4, 8, 128, 2, 139648))])
def test_tail_plan_at_the_layouts_widths(D, precision, plan):
    """The tail's tile at the widths the cluster layout trains: 8 rows x 8
    lanes a thread of 256 (4 x 8 at high), the rows padded to whole slabs
    of 16, a tile's lanes as many as the row threads leave; at D=128 two
    CTAs fit an SM at highest (108032 bytes each)."""
    assert cluster.psi_cluster_tail_plan(D, precision) == plan


@pytest.mark.parametrize("precision", block.PRECISIONS)
def test_tail_plan_covers_every_lane_and_row(precision):
    """At every even D the tail takes (2 to 256): the padded rows are whole
    slabs and split evenly over the row threads, each tile's lanes are a
    multiple of 8 (whole float4 of lanes a thread) and at most one a
    thread, the threads fit the CTA, and the CTA fits the card's shared
    memory."""
    for D in range(2, cluster.PSI_CLUSTER_MAX_D + 1, 2):
        p = cluster.psi_cluster_tail_plan(D, precision)
        n = 2 * D
        assert p["np"] % cluster.CL_TAIL_KS == 0, D
        assert n <= p["np"] < n + cluster.CL_TAIL_KS, D
        assert p["rm"] * p["rt"] == p["np"] and p["rm"] % 4 == 0, D
        assert p["rt"] * p["lt"] <= p["threads"], D
        assert p["nl"] == p["rn"] * p["lt"] <= p["threads"], D
        assert p["nl"] % 8 == 0 and p["rn"] % 4 == 0, D
        assert p["smem"] <= OPTIN, D


def test_tail_smem_is_the_most_any_precision_takes():
    """The byte count the wrappers check before a launch is the largest of
    the three precisions' plans, so one check holds for all of them."""
    for D in (8, 12, 68, 72, 128, 192, 252, 256):
        assert cluster.psi_cluster_tail_smem_bytes(D) == max(
            cluster.psi_cluster_tail_plan(D, p)["smem"]
            for p in block.PRECISIONS)


def test_forward_and_chain_bytes_mirror_their_buffers():
    """The forward's CTA holds three slabs of its rows of [2D,2D] and the
    chain's two, beside the state buffers: two parities of the prepped
    vectors of G columns (hi, lo) and two atoms' rings of CL_SLOTS steps."""
    for D in range(72, cluster.PSI_CLUSTER_MAX_D + 1, 4):
        n = 2 * D
        for C in cluster.PSI_CLUSTERS:
            if not cluster.cl_ok(D, C):
                continue
            for G in cluster.PSI_CLUSTER_COLS:
                state = 4 * n * G + 2 * cluster.CL_SLOTS * (n // 8) * G
                slab = n * cluster.cl_rows(D, C)
                assert cluster.psi_cluster_fwd_smem_bytes(D, C, G) == \
                    4 * (3 * slab + state)
                assert cluster.psi_cluster_chain_smem_bytes(D, C, G) == \
                    4 * (2 * slab + state)


def test_every_cta_with_rows_owns_an_atom():
    """The exchange runs among the CTAs that hold rows (ceil(2D / rows a
    CTA) of them; at D=72 and 8 CTAs a cluster the last two hold none):
    each of them owns at least one atom of 8 rows, so it sends to every
    other in every phase, whether the phase carries a state vector or only
    atoms' sums."""
    idle = 0
    for D in range(4, cluster.PSI_CLUSTER_MAX_D + 1, 4):
        n = 2 * D
        for C in cluster.PSI_CLUSTERS:
            if not cluster.cl_ok(D, C):
                continue
            nr = cluster.cl_rows(D, C)
            cw = -(-n // nr)
            assert cw <= C and (cw - 1) * nr < n <= cw * nr, (D, C)
            for r in range(cw):
                assert r * nr // 8 < n // 8, (D, C, r)
            idle += C - cw
    assert idle > 0
    assert -(-144 // cluster.cl_rows(72, 8)) == 6


@pytest.mark.parametrize("D, C, G", [(72, 2, 2), (128, 4, 4), (192, 8, 1),
                                     (256, 16, 2)])
def test_layout_rule_on_an_h100(D, C, G):
    """The rule's clusters and columns at B=128: the smallest cluster whose
    forward and chain CTAs hold their slabs, then the fewest waves."""
    assert cluster.psi_block_layout(D, 128, SMS, OPTIN) == ("cluster", C, G)
    assert max(cluster.psi_cluster_fwd_smem_bytes(D, C, G),
               cluster.psi_cluster_chain_smem_bytes(D, C, G)) <= OPTIN


def test_forward_refuses_only_layouts_without_room_for_its_loss_warp():
    """The forward takes every layout the rule could pick: wherever its
    slabs fit the card at one column, a CTA has room for the loss warp past
    its row threads, except D=64 at one CTA a cluster (512 row threads),
    which the quad layout runs; there the forward's check raises, and the
    rule never picks a cluster the forward refuses."""
    refused = []
    for D in range(4, cluster.PSI_CLUSTER_MAX_D + 1, 4):
        for C in cluster.PSI_CLUSTERS:
            if (cluster.cl_ok(D, C)
                    and cluster.psi_cluster_fwd_smem_bytes(D, C, 1) <= OPTIN
                    and not cluster.cl_fwd_ok(D, C)):
                refused.append((D, C))
        if not block.psi_block_fits(D):
            _, C, G = cluster.psi_block_layout(D, 128, SMS, OPTIN)
            assert cluster.cl_fwd_ok(D, C), D
    assert refused == [(64, 1)]
    assert block.psi_block_fits(64)
    with pytest.raises(ValueError, match="loss warp"):
        cluster.check_cluster_fwd("psi_train_fwd_cluster", 64, 1, 1)
    cluster.check_cluster_fwd("psi_train_fwd_cluster", 64, 2, 1)
