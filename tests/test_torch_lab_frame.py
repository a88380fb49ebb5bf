"""The port's lab-frame anchor (audio_mps_tpu_torch/models: the cell.lab_*
seams and reference_transcription.py) against the JAX package's on the
same numpy inputs, on the CPU: the four single-step seams, in the block
form that the port's lab frame runs, at rtol 1e-5;
psi_nll_lab_frame and rho_nll_lab_frame, values at rtol 1e-5 and every
gradient at max-rel 1e-4 (the port's training tests' tolerances), plain
and in checkpointed chunks, one of which does not divide T-1; each against
the port's own rotating-frame core at rtol 2e-4; and three
make_lab_train_step Adam steps against the same steps built from the JAX
transcription and optax, as bench.py builds them."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_mps_tpu import config as jconfig
from audio_mps_tpu.models import cell as jcell
from audio_mps_tpu.models import core as jcore
from audio_mps_tpu.models import reference_transcription as jref
from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.models import cell, core
from audio_mps_tpu_torch.models import reference_transcription as ref
from test_torch_core import both, np_params, np_signals
from test_torch_rho import np_rho_params, rho_both

D, B, T = 8, 3, 67           # T-1 = 66 steps
VALUE_RTOL, GRAD_REL = 1e-5, 1e-4
CORE_RTOL = 2e-4


def configs(**kw):
    base = dict(minibatch_size=B, bond_dim=D, scan_chunk=0)
    base.update(kw)
    return CMPSConfig(**base), jconfig.CMPSConfig(**base)


def max_rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def close(got, want, rtol=VALUE_RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=1e-7)


def _state(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


# t at step 12 (phases f t of a few radians at the init's frequencies) and
# a late step whose running sum has drifted from n * dt in float32
TIMES = [np.float32(12 / 16000), np.float32(16000.37 / 16000)]


def _rho_block(rr, ri):
    """The real [2D, 2D] blocks of a batch of complex [D, D] matrices."""
    rr, ri = (torch.as_tensor(np.array(a)) for a in (rr, ri))
    return torch.cat([torch.cat([rr, -ri], -1), torch.cat([ri, rr], -1)], -2)


@pytest.mark.parametrize("t", TIMES)
def test_psi_seams_match_jax(t):
    """One psi step of the seams that the lab frame runs, on the state
    stacked [re | im] with the operators built once, against the JAX
    seams on the split pairs."""
    hp, jhp = configs()
    jp, tp = both(np_params(D))
    pr, pi = _state((B, D), 4)
    sig = np.random.default_rng(5).standard_normal(B).astype(np.float32)
    want = jcell.lab_update_ancilla_psi(jp, jhp, jnp.asarray(pr),
                                        jnp.asarray(pi), jnp.asarray(sig), t)
    ops = cell.lab_psi_operators(tp, hp)
    phases = cell.lab_phases_psi(ops, torch.tensor(t))
    x = torch.as_tensor(np.concatenate([pr, pi], -1))
    got = cell.lab_update_ancilla_psi(ops, x, torch.as_tensor(sig) / tp.A,
                                      phases)
    close(got, np.concatenate([np.asarray(w) for w in want], -1))
    close(cell.lab_expectation_psi(ops, got, phases),
          jcell.lab_expectation_psi(jp, want[0], want[1], t))


@pytest.mark.parametrize("t", TIMES)
def test_rho_seams_match_jax(t):
    """One rho step of the seams that the lab frame runs, on rho's real
    block with Rt's block built at t, against the JAX seams on the split
    pairs; Rt against JAX's ``_lab_Rt``."""
    hp, jhp = configs()
    jp, tp = rho_both(np_rho_params(D, 3))
    rr, ri = _state((B, D, D), 6)
    sig = np.random.default_rng(7).standard_normal(B).astype(np.float32)
    want = jcell.lab_update_ancilla_rho(jp, jhp, jnp.asarray(rr),
                                        jnp.asarray(ri), jnp.asarray(sig), t)
    ops = cell.lab_rho_operators(tp, hp)
    rt = cell._lab_Rt(ops, torch.tensor(t))
    close(rt, _rho_block(*jcell._lab_Rt(jp, t)))
    got = cell.lab_update_ancilla_rho(ops, rt, _rho_block(rr, ri),
                                      torch.as_tensor(sig) / tp.A)
    close(got, _rho_block(*want))
    close(cell.lab_expectation_rho(rt, got),
          jcell.lab_expectation_rho(jp, want[0], want[1], t))


FAMILIES = {
    "psi": (lambda: both(np_params(D)), ref.psi_nll_lab_frame,
            jref.psi_nll_lab_frame, core.psi_nll),
    "rho": (lambda: rho_both(np_rho_params(D, 3)), ref.rho_nll_lab_frame,
            jref.rho_nll_lab_frame, core.rho_nll),
}


@pytest.mark.parametrize("family, chunk", [("psi", 0), ("rho", 0),
                                           ("rho", 16), ("rho", 33)])
def test_lab_frame_value_and_grads_match_jax(family, chunk):
    """The lab-frame NLL and its six gradients against jax.value_and_grad
    of the JAX transcription; rho's scan_chunk 0 runs plain, 16 leaves a
    remainder of 2 steps after four checkpointed chunks, 33 two chunks
    (psi runs plain at any chunk, as in the JAX package). The same value
    as the port's rotating-frame core to rtol 2e-4."""
    make, fn, jfn, core_fn = FAMILIES[family]
    hp, jhp = configs(scan_chunk=chunk)
    jp, tp = make()
    sig = np_signals(B, T)
    v, g = jax.value_and_grad(jfn)(jp, jhp, jnp.asarray(sig))
    loss = fn(tp, hp, torch.as_tensor(sig))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(v), rtol=VALUE_RTOL)
    for k in tp.NAMES:
        assert max_rel(getattr(tp, k).grad, getattr(g, k)) < GRAD_REL, k
    with torch.no_grad():
        rot = core_fn(tp, hp, torch.as_tensor(sig))
    np.testing.assert_allclose(loss.item(), rot.item(), rtol=CORE_RTOL)


@pytest.mark.parametrize("mps_model", ["psi_mps", "rho_mps"])
def test_three_lab_train_steps_match_jax(mps_model):
    """Three make_lab_train_step Adam steps against bench.py's lab step
    built from the JAX transcription, core.regularized_loss and optax.adam
    at cfg.learning_rate on the same parameters and batches: the total
    loss to rtol 1e-5 and every parameter to max-rel 1e-5 after each; the
    step's model_loss is the lab-frame NLL of the parameters it started
    from."""
    family = mps_model[:3]
    make, _, jfn, _ = FAMILIES[family]
    hp, jhp = configs(scan_chunk=16)
    jp, tp = make()
    opt, step = ref.make_lab_train_step(hp, mps_model, tp)
    assert isinstance(opt, torch.optim.Adam)
    jopt = optax.adam(jhp.learning_rate)
    state = jopt.init(jp)

    def loss_fn(params, batch):
        return jcore.regularized_loss(jfn(params, jhp, batch), params,
                                      jhp)[0]

    @jax.jit
    def jstep(params, state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    for seed in (1, 2, 3):
        batch = np_signals(B, T, seed=seed)
        nll = float(jfn(jp, jhp, jnp.asarray(batch)))
        jp, state, jloss = jstep(jp, state, jnp.asarray(batch))
        metrics = step(torch.as_tensor(batch))
        assert not metrics["total_loss"].requires_grad
        np.testing.assert_allclose(metrics["total_loss"].item(),
                                   float(jloss), rtol=1e-5)
        np.testing.assert_allclose(metrics["model_loss"].item(), nll,
                                   rtol=1e-5)
        for k in tp.NAMES:
            assert max_rel(getattr(tp, k), getattr(jp, k)) < 1e-5, k
