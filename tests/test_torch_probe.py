"""The port's per-step floor probe (audio_mps_tpu_torch/ops/probe.py and the
port's tool audio_mps_tpu_torch/tools/probe8_psi_floor.py) against the JAX
tool tools/probe8_psi_floor.py (build_variant, its kernel in Pallas
interpret mode) on the same numpy inputs, on the CPU, at D=8, B=16, K=4:
every variant (G = 1, 2, 4, each with and without pairing) and the
chain-only diagnostic, at T=65 (16 whole blocks) and T=63 (62 steps, so the
last block runs two zero-padded steps).

Tolerances: the mean over the batch at rtol 1e-5 (tests/test_torch_train.py's
value tolerance: the same fp32 arithmetic in another summation order) at
highest, and at high, where a bf16 split of a state a last bit apart can
round the other way, at 1e-4."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.ops import block, probe
from audio_mps_tpu_torch.tools import probe8_psi_floor as tool
from test_torch_core import both, np_params, np_signals
from test_torch_train import VALUE_RTOL

REPO = Path(__file__).resolve().parents[1]
D, B, K = 8, 16, 4
RTOL = {"highest": VALUE_RTOL, "high": 1e-4}
CASES = [(G, paired, False) for paired in (False, True) for G in (1, 2, 4)]
CASES.append((1, False, True))


@pytest.fixture(scope="module")
def jax_tool():
    """tools/probe8_psi_floor.py loaded as a module (the tools directory is
    no package)."""
    spec = importlib.util.spec_from_file_location(
        "probe8_psi_floor_jax", REPO / "tools" / "probe8_psi_floor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(T):
    d = np_params(D, seed=5)
    jp, tp = both(d)
    sig = np_signals(B, T, seed=4)
    return jp, tp, sig


@pytest.mark.parametrize("T", [65, 63])
@pytest.mark.parametrize("G, paired, noloss", CASES)
def test_probe_variant_matches_the_jax_tool(jax_tool, G, paired, noloss, T):
    """The port's build_variant (plain versions on the CPU) against the JAX
    tool's build_variant in interpret mode, at highest."""
    jp, tp, sig = _inputs(T)
    want = float(jax_tool.build_variant(
        jconfig.CMPSConfig(bond_dim=D, minibatch_size=B), K, "highest", G,
        paired, B, T, True, noloss=noloss)(jp, jnp.asarray(sig)))
    got = tool.build_variant(
        CMPSConfig(bond_dim=D, minibatch_size=B), K, "highest", G, paired, B,
        T, device="cpu", noloss=noloss)(tp, torch.as_tensor(sig)).item()
    np.testing.assert_allclose(got, want, rtol=RTOL["highest"])


@pytest.mark.parametrize("G, paired, noloss", [(2, False, False),
                                               (1, True, False),
                                               (1, False, True)])
def test_probe_variant_matches_the_jax_tool_at_high(jax_tool, G, paired,
                                                    noloss):
    """As above at high (bf16 hi/lo products), on the padded T=63."""
    T = 63
    jp, tp, sig = _inputs(T)
    want = float(jax_tool.build_variant(
        jconfig.CMPSConfig(bond_dim=D, minibatch_size=B), K, "high", G,
        paired, B, T, True, noloss=noloss)(jp, jnp.asarray(sig)))
    got = tool.build_variant(
        CMPSConfig(bond_dim=D, minibatch_size=B), K, "high", G, paired, B, T,
        device="cpu", noloss=noloss)(tp, torch.as_tensor(sig)).item()
    np.testing.assert_allclose(got, want, rtol=RTOL["high"])


def _probe_inputs(T, paired):
    cfg = CMPSConfig(bond_dim=D, minibatch_size=B)
    _, tp, sig = _inputs(T)
    ins = block.psi_nll_inputs(tp, cfg, torch.as_tensor(sig))
    consts = (ins["ab"], ins["bb"], ins["rb"])
    if paired:
        consts += probe.probe_products(ins["ab"], ins["bb"])
    return consts, ins


def test_the_non_paired_nll_is_the_deferred_norm_nll():
    """Without pairing the probe computes the block NLL with the deferred
    norm over the zero-padded steps, whose terms are 0: the same per-column
    values as psi_nll_block_plain over the real steps, bit for bit."""
    consts, ins = _probe_inputs(63, False)
    got = probe.psi_probe_columns_plain(
        consts, ins["t0"], ins["se"], unroll=K, log_eps=ins["log_eps"],
        norm_eps=ins["norm_eps"])
    want = block.psi_nll_block_plain(
        *consts, ins["t0"], ins["se"], log_eps=ins["log_eps"],
        norm_eps=ins["norm_eps"], unroll=K, defer_norm=True)
    assert torch.equal(got, want)


def test_paired_refuses_an_odd_unroll():
    """The JAX tool's range(K // 2) drops a step of every block at an odd
    K; the port raises instead (ROADMAP section C)."""
    consts, ins = _probe_inputs(65, True)
    kw = dict(log_eps=ins["log_eps"], norm_eps=ins["norm_eps"], unroll=5)
    with pytest.raises(ValueError, match="even"):
        probe.psi_probe_nll_plain(consts, ins["t0"], ins["se"], paired=True,
                                  **kw)
    with pytest.raises(ValueError, match="even"):
        probe.psi_probe_nll(consts, ins["t0"], ins["se"], paired=True, **kw)
    # the chain-only diagnostic runs single steps, so an odd K is fine
    assert torch.isfinite(probe.psi_probe_nll_plain(
        consts, ins["t0"], ins["se"], paired=True, noloss=True, **kw))


@pytest.mark.parametrize("G", [3, 8])
def test_the_groups_must_be_one_two_or_four(G):
    consts, ins = _probe_inputs(65, False)
    with pytest.raises(ValueError, match="G"):
        probe.psi_probe_nll(consts, ins["t0"], ins["se"], G=G, unroll=K,
                            log_eps=ins["log_eps"], norm_eps=ins["norm_eps"])


def test_the_tool_runs_its_cpu_pass(capsys):
    """``python -m audio_mps_tpu_torch.tools.probe8_psi_floor --device=cpu``:
    the correctness pass of every variant against core.psi_nll at D=8,
    B=16, T=65, K=4, and no timing."""
    assert tool.main(["--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("rel-err") == len(tool.VARIANTS) * len(tool.PRECISIONS)
    assert "no timing" in out
