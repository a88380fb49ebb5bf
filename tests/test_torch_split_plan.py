"""The split adjoints' plans (ops/split.py psi_split_bwd_plan and
rho_split_bwd_plan): which form and slab placement each shape takes on an
H100's 232,448 bytes of shared memory a block, and where they refuse.
Pure functions of the shape and the card's shared memory, so they run
here without a card; tests/test_torch_cuda.py holds their byte counts to
the kernels' own and launches every form and placement."""
import pytest

from audio_mps_tpu_torch.ops import split
from audio_mps_tpu_torch.ops.block import H100_SMEM_OPTIN


def test_psi_plan_takes_the_double_form_at_the_estimator_shape():
    assert split.psi_split_bwd_plan(10, 16) == "double"
    assert split.psi_split_bwd_plan(10, 16, H100_SMEM_OPTIN) == "double"


@pytest.mark.parametrize("D, form", [(10, "double"), (63, "double"),
                                     (64, "single"), (73, "single")])
def test_psi_plan_by_bond_dimension(D, form):
    """double while two slabs fit (to D=63 at unroll 16), single to the
    ceiling D=73."""
    assert split.psi_split_bwd_plan(D, 16) == form


def test_psi_plan_refuses_past_its_ceiling():
    """D=74 at unroll 16 needs more than a block's shared memory in either
    form: NotImplementedError, as _check_smem raises."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        split.psi_split_bwd_plan(74, 16)


def test_rho_plan_takes_shared_memory_and_the_double_form_at_d10():
    assert split.rho_split_bwd_plan(10, 10, 16) == ("smem", "double")


@pytest.mark.parametrize("D, rank, plan", [
    (10, 10, ("smem", "double")), (12, 12, ("ws", "double")),
    (16, 16, ("ws", "double")), (17, 17, ("ws", "single")),
    (33, 2, ("smem", "double")), (53, 53, ("ws", "single"))])
def test_rho_plan_by_shape(D, rank, plan):
    """Two slabs in shared memory to D=11 at full rank; the workspace past
    that; the double form while its two roles fit 512 threads (D rank <=
    256); the single form in the workspace at the ceiling D=53."""
    assert split.rho_split_bwd_plan(D, rank, 16) == plan


def test_rho_plan_refuses_past_its_ceiling():
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        split.rho_split_bwd_plan(54, 54, 16)


@pytest.mark.parametrize("D", [4, 10, 33, 73])
def test_psi_single_form_is_the_smaller(D):
    """The single form holds one slab, the double two and the sweep's own
    partials: the single form is the ceiling."""
    single = split.psi_split_bwd_smem_bytes(D, 16, "single")
    assert single < split.psi_split_bwd_smem_bytes(D, 16, "double")


@pytest.mark.parametrize("D, rank", [(4, 3), (10, 10), (33, 2), (53, 53)])
def test_rho_workspace_single_form_is_the_smallest(D, rank):
    least = split.rho_split_bwd_smem_bytes(D, rank, 16, "ws", "single")
    for placement in split.SPLIT_BWD_PLACEMENTS:
        for form in split.SPLIT_BWD_FORMS:
            assert least <= split.rho_split_bwd_smem_bytes(D, rank, 16,
                                                           placement, form)


def test_plans_follow_the_cards_shared_memory():
    """A card with less shared memory a block moves the same shape down the
    order: rho at D=10 full rank to the workspace, then to the single
    form; psi at D=10 to the single form."""
    double_ws = split.rho_split_bwd_smem_bytes(10, 10, 16, "ws", "double")
    assert split.rho_split_bwd_plan(10, 10, 16, double_ws) == ("ws",
                                                               "double")
    single_ws = split.rho_split_bwd_smem_bytes(10, 10, 16, "ws", "single")
    assert split.rho_split_bwd_plan(10, 10, 16, single_ws) == ("ws",
                                                               "single")
    single = split.psi_split_bwd_smem_bytes(10, 16, "single")
    assert split.psi_split_bwd_plan(10, 16, single) == "single"


# The split forwards' layouts (ops/split.py rho_split_fwd_layout and
# psi_split_fwd_smem_bytes, mirrored from csrc/rho_split_fwd.cuh and
# csrc/psi_split_fwd.cuh; tests/test_torch_cuda.py holds them to the
# kernels' own)

@pytest.mark.parametrize("D, rank, cols, warps, elems", [
    (10, 10, 3, 4, 1), (20, 20, 3, 7, 2), (32, 32, 1, 32, 1),
    (16, 16, 2, 8, 1), (12, 12, 2, 6, 1), (6, 3, 5, 1, 1),
    (33, 33, 0, 32, 2), (64, 64, 0, 32, 4), (33, 2, 0, 3, 1)])
def test_rho_forward_layout_by_shape(D, rank, cols, warps, elems):
    """Warp-local where D <= 32 (whole columns a warp: 3 of one element a
    lane at D=10, 3 of two at D=20, one at D=32), the element layout past
    D=32, up to 1024 threads."""
    layout = split.rho_split_fwd_layout(D, rank)
    assert (layout.cols, layout.warps, layout.elems) == (cols, warps, elems)
    assert layout.threads == 32 * warps
    assert layout.elems * layout.threads >= D * rank
    assert layout.slots == (18 if cols else 8)


@pytest.mark.parametrize("D", range(1, 33))
def test_rho_forward_warp_local_columns_fit_their_warp(D):
    """At every D <= 32 and full rank each column lies in one warp: a
    warp's columns are at most its lanes' elements, the warps hold every
    column, and no other power of 2 of elements a lane gives the busiest
    of an SM's four schedulers fewer walks a step (ceil(warps / 4) x
    elements)."""
    layout = split.rho_split_fwd_layout(D, D)
    assert layout.cols * D <= 32 * layout.elems
    assert layout.cols * layout.warps >= D
    walks = -(-layout.warps // 4) * layout.elems
    for elems in (1, 2, 4, 8):
        assert -(-(-(-D // (32 * elems // D))) // 4) * elems >= walks


@pytest.mark.parametrize("D, rank, elems", [(10, 10, 1), (32, 32, 1),
                                            (33, 33, 2), (64, 64, 4)])
def test_rho_forward_element_layout_when_forced(D, rank, elems):
    """warp_local=False takes the element layout at every shape: D rank
    threads rounded to warps, at most 1024, each on a power of 2 of
    elements."""
    layout = split.rho_split_fwd_layout(D, rank, warp_local=False)
    assert layout.cols == 0 and layout.elems == elems
    assert layout.threads == min(1024, -(-D * rank // 32) * 32)


def test_rho_forward_layout_past_32_warps_of_columns():
    """At D=16 a warp holds at most 16 columns (8 elements a lane): rank
    512 takes 32 warps, rank 513 would take 33, so it takes the element
    layout."""
    assert split.rho_split_fwd_layout(16, 512)[:3] == (16, 32, 1024)
    assert split.rho_split_fwd_layout(16, 513).cols == 0


def test_split_forward_ceilings_stay():
    """The forwards' shared memory keeps their ceilings on an H100 (232,448
    bytes a block): psi's NLL and training forward to D=119, rho's to D=64
    at full rank."""
    assert split.psi_split_fwd_smem_bytes(119) <= H100_SMEM_OPTIN
    assert split.psi_split_fwd_smem_bytes(120) > H100_SMEM_OPTIN
    assert split.rho_split_fwd_layout(64, 64).smem_bytes <= H100_SMEM_OPTIN
    assert split.rho_split_fwd_layout(65, 65).smem_bytes > H100_SMEM_OPTIN


@pytest.mark.parametrize("D", [10, 32])
def test_rho_forward_warp_local_layout_fits_to_d32(D):
    """The warp-local layout's ring of each lane's parts fits at every
    D <= 32 at full rank (209,808 bytes at D=32)."""
    assert split.rho_split_fwd_layout(D, D).smem_bytes <= H100_SMEM_OPTIN
