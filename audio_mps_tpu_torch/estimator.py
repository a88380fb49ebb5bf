"""Estimator-style chunked training loop of the PyTorch/CUDA port
(counterpart of ``audio_mps_tpu/estimator.py``).

Parity with the reference's legacy ``training_estimators.py`` (a
``tf.estimator`` custom Estimator trained in ``viz_steps`` chunks with a
checkpoint per chunk, reference: training_estimators.py:48-116): an
Estimator owns a model_dir, trains in bounded chunks, checkpoints after
each, and resumes automatically.

CLI (flags mirror training_estimators.py:16-39, plus ``--device``, default
``cuda``, as in the port's other CLIs):

    python -m audio_mps_tpu_torch.estimator --bond_d=10 --dt=0.001 \
        --batch_size=32 --viz_steps=2 --max_steps=5001 --discr=false \
        --model_dir=/tmp/est

At its defaults (psi, D=10, B=32, T=65536) the NLL and its gradient go
through the split-layout kernels on a card (``ops/split.py``: D=10 is no
multiple of 4). ``--discr=true`` trains rho (full rank 10 there) through
rho's split-layout kernels, ``ops/split.rho_nll_split_trainable``.
``--data_dir=<file.tfrecords>`` trains on a file of audio-only Examples
(``data/tfrecord.py``) instead of damped sines. Not ported, and refused
before anything runs: the latent family (ROADMAP queue A: Latent
family).

Randomness: the init draws from a generator seeded with ``--seed``, the
damped-sine batches from one seeded with ``--seed``, on ``--device``; a
``--data_dir`` file is shuffled by numpy's ``default_rng(--seed)``, as in
the JAX package, so both give the same batches.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Iterator

import torch

from .config import CMPSConfig, _coerce
from .data import ArrayDataset, damped_sine_iterator, read_audio_tfrecords
from .data.audio import batches_on
from .device import resolve_device
from .training import (Checkpointer, init_params_for, make_loss_fn,
                       make_train_step)


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Flags of the legacy estimator entry point
    (reference: training_estimators.py:16-39)."""

    viz_steps: int = 2
    max_steps: int = 5001
    bond_d: int = 10
    dt: float = 0.001
    discr: bool = False         # False => pure state (psi), True => rho
    batch_size: int = 32
    model_dir: str = "/tmp/audio_mps_estimator"
    data_dir: str = ""          # empty => damped_sine synthetic
    sample_duration: int = 2 ** 16
    learning_rate: float = 1e-3
    seed: int = 0
    device: str = "cuda"


_TYPES = {f.name: type(f.default)
          for f in dataclasses.fields(EstimatorConfig)}


def parse_args(argv) -> EstimatorConfig:
    """EstimatorConfig from ``--key=value`` flags (``--key`` alone is
    true); an unknown flag raises ``ValueError``."""
    updates = {}
    for arg in argv:
        if not arg.startswith("--"):
            continue
        body = arg[2:]
        k, v = (body.split("=", 1) if "=" in body else (body, "true"))
        if k not in _TYPES:
            raise ValueError(f"unknown flag --{k}")
        updates[k] = _coerce(v, _TYPES[k])
    return dataclasses.replace(EstimatorConfig(), **updates)


class Estimator:
    """Owns a model_dir; trains in chunks with a checkpoint per chunk and
    automatic resume (the reference's chunked ``estimator.train`` loop,
    training_estimators.py:105-115), on ``device``."""

    def __init__(self, mps_model: str, cfg: CMPSConfig, model_dir: str,
                 save_checkpoints_steps=None, seed: int = 0, device="cuda"):
        # None (default) = checkpoint once per train() call, the
        # reference's checkpoint-per-viz-chunk cadence
        # (training_estimators.py:108-115); an int adds an every-N-steps
        # cadence within a call
        if mps_model == "latent":
            raise NotImplementedError(
                "mps_model='latent': the latent family is not ported yet "
                "(ROADMAP queue A: Latent family)")
        dev = resolve_device(device)
        self.mps_model = mps_model
        self.cfg = cfg
        self.model_dir = model_dir
        self.save_checkpoints_steps = save_checkpoints_steps
        self.params = init_params_for(
            mps_model, torch.Generator(dev).manual_seed(seed), cfg,
            device=dev)
        self.optimizer, self._step_fn = make_train_step(
            mps_model, cfg, self.params, device=dev)
        self._loss_fn = make_loss_fn(mps_model, cfg)
        self._ckpt = Checkpointer(os.path.join(model_dir, "checkpoints"),
                                  save_secs=0.0)
        self.global_step = self._ckpt.restore(self.params, self.optimizer)
        # one persistent iterator per input_fn: re-creating a seeded
        # iterator every chunk would replay the same batches
        self._iters = {}

    def train(self, input_fn: Callable[[], Iterator], steps: int,
              verbose: bool = False):
        """Train ``steps`` steps, checkpointing every
        save_checkpoints_steps and, forced, at the end. The iterator
        persists across calls, so chunked training advances through the
        data. Returns the last step's metrics as floats."""
        it = self._iters.get(input_fn)
        if it is None:
            it = self._iters[input_fn] = input_fn()
        metrics = {}
        for _ in range(steps):
            metrics = self._step_fn(next(it))
            self.global_step += 1
            if (self.save_checkpoints_steps
                    and self.global_step % self.save_checkpoints_steps == 0):
                self._ckpt.maybe_save(self.global_step, self.params,
                                      self.optimizer, force=True)
        self._ckpt.maybe_save(self.global_step, self.params, self.optimizer,
                              force=True)
        if verbose and metrics:
            print(f"step {self.global_step}: "
                  f"loss={float(metrics['model_loss']):.6f}", flush=True)
        return {k: float(v) for k, v in metrics.items()}

    def evaluate(self, input_fn: Callable[[], Iterator], steps: int = 1):
        """Mean loss over ``steps`` fresh batches (the reference's
        eval_metric_ops mean loss, training_estimators.py:112)."""
        it = input_fn()
        losses = []
        with torch.no_grad():
            for _ in range(steps):
                _, metrics = self._loss_fn(self.params, next(it))
                losses.append(float(metrics["model_loss"]))
        return {"loss": sum(losses) / len(losses)}

    def close(self):
        """Nothing to release: every save is synchronous."""


def build_input_fn(ec: EstimatorConfig, cfg: CMPSConfig):
    """Batches on ``ec.device`` (reference: training_estimators.py:87-95 —
    shuffle/repeat/batch over the static dataset): the records of
    ``ec.data_dir`` read once into host memory, else the synthetic
    damped-sine batches of the JAX package's fallback."""
    if not ec.data_dir:
        return lambda: damped_sine_iterator(cfg, ec.sample_duration,
                                            seed=ec.seed, device=ec.device)
    dev = resolve_device(ec.device)
    data = read_audio_tfrecords(ec.data_dir,
                                sample_duration=ec.sample_duration)
    return lambda: batches_on(
        ArrayDataset(data, cfg.minibatch_size, seed=ec.seed), dev)


def main(argv=None) -> Estimator:
    """Train ``max_steps // viz_steps`` chunks of ``viz_steps`` steps after
    any resume, as the JAX CLI does; returns the closed Estimator."""
    ec = parse_args(sys.argv[1:] if argv is None else argv)
    cfg = CMPSConfig(minibatch_size=ec.batch_size, bond_dim=ec.bond_d,
                     delta_t=ec.dt, learning_rate=ec.learning_rate)
    mps_model = "rho_mps" if ec.discr else "psi_mps"
    input_fn = build_input_fn(ec, cfg)
    est = Estimator(mps_model, cfg, ec.model_dir,
                    save_checkpoints_steps=ec.viz_steps, seed=ec.seed,
                    device=ec.device)
    # chunked training loop (reference: training_estimators.py:114-115)
    for _ in range(ec.max_steps // ec.viz_steps):
        est.train(input_fn, steps=ec.viz_steps, verbose=True)
    est.close()
    return est


if __name__ == "__main__":
    main()
