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
