"""The port's estimator-style chunked trainer
(audio_mps_tpu_torch/estimator.py) against the JAX package's
(audio_mps_tpu/estimator.py) on the CPU: the
flags and their defaults, and chunked training with a checkpoint per chunk,
automatic resume and evaluation, at the shapes of tests/test_estimator.py."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from audio_mps_tpu import estimator as jestimator
from audio_mps_tpu_torch import estimator
from audio_mps_tpu_torch.config import CMPSConfig


def test_parse_args_matches_jax():
    """The same flags with the same defaults (the reference's
    training_estimators.py:16-39), plus the port's --device; the same
    parse of a flag list; an unknown flag raises."""
    port = dataclasses.asdict(estimator.EstimatorConfig())
    assert port.pop("device") == "cuda"
    assert port == dataclasses.asdict(jestimator.EstimatorConfig())
    assert (port["bond_d"], port["batch_size"], port["dt"], port["discr"],
            port["sample_duration"]) == (10, 32, 1e-3, False, 2 ** 16)
    argv = ["--bond_d=6", "--discr=true", "--viz_steps=3", "--dt=0.001",
            "--max_steps=7", "--model_dir=/m", "--sample_duration=512"]
    got = dataclasses.asdict(estimator.parse_args(argv + ["--device=cpu"]))
    assert got.pop("device") == "cpu"
    assert got == dataclasses.asdict(jestimator.parse_args(argv))
    assert estimator.parse_args(["--discr"]).discr
    with pytest.raises(ValueError, match="unknown flag"):
        estimator.parse_args(["--bond_dim=6"])


def test_estimator_train_eval_resume(tmp_path):
    """Four steps in chunks of two (a checkpoint at each), evaluation, then
    a fresh Estimator on the same model_dir resumes at step 4 with the
    saved parameters and Adam state and goes on to step 6."""
    cfg = CMPSConfig(minibatch_size=2, bond_dim=3, scan_chunk=32)
    ec = estimator.EstimatorConfig(sample_duration=256, batch_size=2,
                                   device="cpu")
    input_fn = estimator.build_input_fn(ec, cfg)
    est = estimator.Estimator("psi_mps", cfg, str(tmp_path),
                              save_checkpoints_steps=2, device="cpu")
    assert est.global_step == 0
    m = est.train(input_fn, steps=2)
    m = est.train(input_fn, steps=2)
    assert est.global_step == 4
    assert np.isfinite(m["model_loss"])
    ev = est.evaluate(input_fn, steps=2)
    assert np.isfinite(ev["loss"])
    est.close()
    ckdir = tmp_path / "checkpoints"
    assert sorted(os.listdir(ckdir)) == ["ckpt_2.pt", "ckpt_4.pt"]
    saved = torch.load(ckdir / "ckpt_4.pt", weights_only=True)

    est2 = estimator.Estimator("psi_mps", cfg, str(tmp_path),
                               save_checkpoints_steps=2, seed=1,
                               device="cpu")
    assert est2.global_step == 4
    for k in est2.params.NAMES:
        assert torch.equal(getattr(est2.params, k), saved["params"][k]), k
        assert torch.equal(getattr(est2.params, k), getattr(est.params, k))
    assert all(float(s["step"]) == 4.0
               for s in est2.optimizer.state_dict()["state"].values())
    m2 = est2.train(input_fn, steps=2)
    assert est2.global_step == 6
    assert np.isfinite(m2["model_loss"])
    assert not torch.equal(est2.params.Rx, est.params.Rx)


def test_main_trains_chunks_after_a_resume(tmp_path, capsys):
    """main runs max_steps // viz_steps chunks after any resume, as the JAX
    CLI does: 4 steps, then a second call with --max_steps=2 ends at 6."""
    argv = ["--bond_d=3", "--batch_size=2", "--sample_duration=256",
            "--viz_steps=2", f"--model_dir={tmp_path}", "--device=cpu"]
    est = estimator.main(argv + ["--max_steps=4"])
    assert est.global_step == 4
    est = estimator.main(argv + ["--max_steps=2"])
    assert est.global_step == 6
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines()] == [
        "step 2", "step 4", "step 6"]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "ckpt_2.pt", "ckpt_4.pt", "ckpt_6.pt"]


def test_unported_branches_raise(tmp_path):
    """The latent family (ROADMAP queue A item 5) and --data_dir (the
    TFRecord plane, item 1) raise NotImplementedError before training."""
    cfg = CMPSConfig(minibatch_size=2, bond_dim=4)
    with pytest.raises(NotImplementedError, match="latent"):
        estimator.Estimator("latent", cfg, str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="TFRecord"):
        estimator.main([f"--model_dir={tmp_path}", "--device=cpu",
                        "--data_dir=data/pitch_30.tfrecords"])
    assert not os.path.exists(tmp_path / "checkpoints")


def test_discr_trains_rho_through_the_split_kernel_path(tmp_path,
                                                        monkeypatch):
    """--discr=true trains the mixed-state model: on the CPU through the
    kernel path (the Estimator's step and loss built with fused=True:
    RhoSplitNLL over the plain versions of the split kernels, since D=6 is
    no multiple of 4), whose first-step loss under the per-step norm is the
    eager core.rho_nll_factor's (the CPU default) from the same seed to
    rtol 1e-5; two chunks of two steps and an evaluation through it; and
    main(--discr=true) on the CPU trains rho."""
    import functools

    from audio_mps_tpu_torch import training
    from audio_mps_tpu_torch.models.params import RhoParams
    from audio_mps_tpu_torch.ops import split
    calls = []
    plain = split.rho_split_fwd_plain
    monkeypatch.setattr(split, "rho_split_fwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    cfg = CMPSConfig(minibatch_size=2, bond_dim=6, defer_norm=False)
    ec = estimator.EstimatorConfig(sample_duration=256, batch_size=2,
                                   bond_d=6, discr=True, device="cpu")
    input_fn = estimator.build_input_fn(ec, cfg)
    eager = estimator.Estimator("rho_mps", cfg, str(tmp_path / "eager"),
                                device="cpu")
    want = eager.train(input_fn, steps=1)["model_loss"]
    assert not calls
    for name in ("make_train_step", "make_loss_fn"):
        monkeypatch.setattr(estimator, name, functools.partial(
            getattr(training, name), fused=True))
    est = estimator.Estimator("rho_mps", cfg, str(tmp_path / "kernels"),
                              save_checkpoints_steps=2, device="cpu")
    assert isinstance(est.params, RhoParams)
    got = est.train(input_fn, steps=1)["model_loss"]
    assert len(calls) == 1
    np.testing.assert_allclose(got, want, rtol=1e-5)
    m = est.train(input_fn, steps=2)
    m = est.train(input_fn, steps=1)
    assert est.global_step == 4 and np.isfinite(m["model_loss"])
    assert np.isfinite(est.evaluate(input_fn, steps=1)["loss"])
    assert len(calls) == 1 + 3 + 1
    monkeypatch.undo()
    est = estimator.main(["--discr=true", "--bond_d=3", "--batch_size=2",
                          "--sample_duration=64", "--viz_steps=1",
                          "--max_steps=1", f"--model_dir={tmp_path / 'cli'}",
                          "--device=cpu"])
    assert isinstance(est.params, RhoParams) and est.global_step == 1
