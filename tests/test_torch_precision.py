"""The port's own products run in true fp32 whatever the process-global
matmul setting, as the JAX package pins ``precision="highest"`` on its
complex algebra (``audio_mps_tpu/ops/complexing.py``). Under
``torch.set_float32_matmul_precision("medium")`` (bf16 passes on the CPU's
oneDNN path, TF32 on the card) the constants, the eager losses and a
trainable gradient equal the default setting's outputs bit for bit, and the
caller's setting is left as it was. CPU only; the card's counterpart (at
``"high"``, TF32) is in test_torch_cuda.py."""
import pytest
import torch

from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.data import damped_sine_batch
from audio_mps_tpu_torch.models import core
from audio_mps_tpu_torch.models.cell import make_constants
from audio_mps_tpu_torch.models.params import init_psi, init_rho
from audio_mps_tpu_torch.ops import complexing, grad

CPU = torch.device("cpu")
SETTINGS = ("medium", "high", "highest")
# oneDNN takes its bf16 path for fp32 products from about 24 x 24 up: the
# eager checks run at D=32 and B=32, where "medium" moves an unpinned
# product
D_EAGER = 32


def _params(family, D=D_EAGER):
    cfg = CMPSConfig(bond_dim=D, minibatch_size=3, initial_rank=3,
                     scan_chunk=0)
    init = init_psi if family == "psi" else init_rho
    return init(torch.Generator().manual_seed(D), cfg, device=CPU), cfg


def _signals(cfg, B=32, T=40):
    return damped_sine_batch(torch.Generator().manual_seed(1), B, T,
                             cfg.delta_t)


def _state():
    """The process-global matmul settings a caller could have changed."""
    backends = tuple(b.fp32_precision for b in complexing._matmul_backends())
    return torch.get_float32_matmul_precision(), backends


def _under(setting, fn):
    """fn() under ``setting``; the setting is restored afterwards."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(setting)
    try:
        before = _state()
        out = fn()
        assert _state() == before
        return out
    finally:
        torch.set_float32_matmul_precision(saved)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("family", ["psi", "rho"])
def test_constants_ignore_the_global_setting(family):
    p, cfg = _params(family)

    def run():
        cc = make_constants(p, cfg)
        return [getattr(cc, k) for k in ("Kr", "Ki", "Cr", "Ci", "Xr", "Xi")]

    assert _equal(_under("medium", run), run())


@pytest.mark.parametrize("family, loss", [("psi", "psi_nll"),
                                          ("rho", "rho_nll"),
                                          ("rho", "rho_nll_factor")])
def test_eager_losses_ignore_the_global_setting(family, loss):
    p, cfg = _params(family)
    sig = _signals(cfg)

    def run():
        return getattr(core, loss)(p, cfg, sig)

    assert _equal(_under("medium", run), run())


@pytest.mark.parametrize("D, layout", [(8, "block"), (6, "split")])
def test_trainable_gradient_ignores_the_global_setting(D, layout):
    """Value and gradient of the psi training loss through
    ``grad.psi_nll_fused_trainable`` (the kernels' plain versions on the
    CPU, autograd through the constants, the initial state and the
    increments): autograd runs the backward after the forward's call has
    returned, so its products are pinned too."""
    p, cfg = _params("psi", D)
    sig = _signals(cfg, B=3)

    def run():
        for t in p.parameters():
            t.grad = None
        loss = grad.psi_nll_fused_trainable(p, cfg, sig, unroll=4,
                                            defer_norm=True, layout=layout)
        loss.backward()
        return [loss.detach()] + [t.grad.clone() for t in p.parameters()]

    assert _equal(_under("medium", run), run())


@pytest.mark.parametrize("setting", SETTINGS)
def test_products_restore_the_callers_setting(setting):
    """The pinned product, forward and backward, leaves every global
    setting as the caller had it, and gives the default setting's bits."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 16, 16, generator=g, requires_grad=True)
    b = torch.randn(16, 16, generator=g, requires_grad=True)

    def run():
        out = complexing.matmul(a, b)
        ga, gb = torch.autograd.grad((out * out).sum(), (a, b))
        with complexing.fp32_products():
            bare = a.detach() @ b.detach()
        return out.detach(), ga, gb, bare

    want = run()
    got = _under(setting, run)
    assert _equal(got, want)
    assert torch.equal(want[0], want[3])
