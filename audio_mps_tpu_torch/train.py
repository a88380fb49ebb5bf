"""Training CLI of the PyTorch/CUDA port (counterpart of
``audio_mps_tpu/train.py`` on a single device).

    python -m audio_mps_tpu_torch.train --mps_model=psi_mps \
        --dataset=damped_sine --hparams="bond_dim=64,minibatch_size=128" \
        --sample_duration=16384 --logdir=./logging
    python -m audio_mps_tpu_torch.train --mps_model=rho_mps \
        --dataset=damped_sine --hparams="bond_dim=64,minibatch_size=8" \
        --sample_duration=16384 --logdir=./logging

    python -m audio_mps_tpu_torch.train --dataset=guitar \
        --datadir=<dir holding guitar.tfrecords> --logdir=./logging

``--dataset`` is ``damped_sine`` or a file dataset, ``{datadir}/
{dataset}.tfrecords`` of audio-only Examples (guitar, organ, nsynth;
``data/audio.get_audio``; ``tools/make_small_dataset.py`` and
``tools/make_instrument_dataset.py`` write them). The flags are the JAX
CLI's (``config.RunConfig``) plus ``--device``
(default ``cuda``; ``--device=cpu`` runs the eager reference on the CPU).
The run writes into ``{logdir}/{dataset}/{bond_dim}_{delta_t}_
{minibatch_size}``: ``config.json`` (the JAX CLI's format), torch
checkpoints under ``checkpoints/`` every ``--checkpoint_secs`` and on exit,
``params.npz`` on exit (the weights the sample CLI reads), and TensorBoard
summaries where tensorboard is installed. A restart resumes from the
latest checkpoint.

Randomness: the init draws from a generator seeded with ``--seed``, the
damped-sine batches from one seeded with ``--seed`` + 1 (a file dataset
is shuffled by numpy's ``default_rng(--seed)``, as in the JAX CLI, and
streams as ``--stream`` says), the summaries'
samples from one seeded with ``--seed`` + 2, all on ``--device``. The
summaries' samples go through the family's sampler kernel on a card (the
block sampler at D % 8 == 0, the split one elsewhere, each within its
shared memory: ``scan.psi_sampler_fits``, ``scan.rho_sampler_fits``) and
through the eager ``core.sample_psi`` / ``core.sample_rho``, as in the JAX
CLI, on the CPU (psi also on a card where no sampler kernel fits). Where no
rho sampler kernel takes the shape (rho past D=64 at full rank, which
trains rank-chunked), the run raises on a card before its first step
unless the summaries draw no samples (``--visualize=false``). ``--mesh`` and
``--profile_steps`` are not ported and raise.

    python -m audio_mps_tpu_torch.train --mps_model=rho_mps \
        --dataset=damped_sine --hparams="bond_dim=256,minibatch_size=8" \
        --sample_duration=16385 --visualize=false --logdir=./logging
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

from . import summaries as summaries_lib
from .config import CMPSConfig, RunConfig, parse_argv
from .data import get_audio
from .device import resolve_device
from .models import core
from .ops import scan
from .training import Checkpointer, init_params_for, make_train_step
from .weights import save_params


def train(run: RunConfig, cfg: CMPSConfig = None, verbose: bool = True,
          device="cuda"):
    """Run the training loop on ``device``; returns (params, final
    metrics)."""
    cfg = cfg if cfg is not None else CMPSConfig().parse(run.hparams)
    if run.mesh:
        raise NotImplementedError(
            f"--mesh={run.mesh}: multi-device training is not ported yet "
            f"(ROADMAP queue A: Multi-GPU)")
    if run.profile_steps > 0:
        raise NotImplementedError(
            "--profile_steps: the profiler trace of the JAX CLI is not "
            "ported yet (ROADMAP queue A: Benchmark)")
    dev = resolve_device(device)
    params = init_params_for(run.mps_model,
                             torch.Generator(dev).manual_seed(run.seed), cfg,
                             device=dev)
    # a file dataset's shuffle draws the JAX CLI's default_rng(seed), so
    # both CLIs train on the same batches
    data_seed = run.seed + 1 if run.dataset == "damped_sine" else run.seed
    stream = {"auto": None, "true": True, "false": False}[run.stream]
    data_iter = get_audio(run.datadir, run.dataset, cfg,
                          sample_duration=run.sample_duration,
                          seed=data_seed, stream=stream, device=dev)
    fused = {"auto": None, "true": True, "false": False}[run.fused]
    optimizer, step_fn = make_train_step(run.mps_model, cfg, params,
                                         fused=fused, device=dev)

    logdir = run.run_logdir(cfg)
    os.makedirs(logdir, exist_ok=True)
    # the run+model config, so that sampling restores without hparams
    with open(os.path.join(logdir, "config.json"), "w") as f:
        json.dump({"cfg": dataclasses.asdict(cfg),
                   "run": dataclasses.asdict(run)}, f, indent=1)
    ckpt = Checkpointer(os.path.join(logdir, "checkpoints"),
                        save_secs=run.checkpoint_secs)
    start_step = ckpt.restore(params, optimizer)
    writer = summaries_lib.make_writer(logdir)
    sample_gen = torch.Generator(dev).manual_seed(run.seed + 2)
    # the eager loop launches ~30 small ops a sample step on a card
    if run.mps_model == "rho_mps":
        rank = params.Wx.shape[0]
        kernel = dev.type == "cuda" and scan.rho_sampler_fits(cfg, rank, dev)
        sample_fn = scan.rho_sample_fused_keyed if kernel else core.sample_rho
        if (dev.type == "cuda" and not kernel and run.visualize
                and run.num_samples > 0 and writer is not None):
            # no rho sampler kernel takes this shape, and the summaries do
            # not fall back to the eager loop on the card
            writer.close()
            raise NotImplementedError(
                f"no rho sampler kernel takes D={cfg.bond_dim}, rank={rank} "
                f"within shared memory (the block sampler D % 8 == 0, D <= 64 "
                f"and rank <= 64, its CTA 48 D^2 bytes of constants and its "
                f"share of the chain's state at the cluster it takes; the "
                f"split one 24 D^2 + 32 D rank bytes; "
                f"streaming its constants is not ported yet, ROADMAP queue "
                f"B); pass --visualize=false or --num_samples=0, or a "
                f"bond_dim and initial_rank the sampler takes")
    else:
        kernel = dev.type == "cuda" and scan.psi_sampler_fits(cfg, dev)
        sample_fn = scan.psi_sample_fused_keyed if kernel else core.sample_psi

    metrics = {}
    step = start_step
    try:
        while run.max_steps <= 0 or step < run.max_steps:
            batch = next(data_iter)
            metrics = step_fn(batch)
            step += 1
            if step % run.summary_every == 0 or step == start_step + 1:
                m = {k: float(v) for k, v in metrics.items()}
                if verbose:
                    print(f"step {step}: loss={m['model_loss']:.6f} "
                          f"total={m['total_loss']:.6f}", flush=True)
                samples = None
                if (run.visualize and run.num_samples > 0
                        and writer is not None):
                    with torch.no_grad():
                        samples = sample_fn(params, cfg, sample_gen,
                                            run.num_samples,
                                            run.sample_duration)
                summaries_lib.write_step_summaries(
                    writer, step, m, cfg, run, params=params, data=batch,
                    samples=samples)
            ckpt.maybe_save(step, params, optimizer)
    except KeyboardInterrupt:
        if verbose:
            print("interrupted; saving final checkpoint", flush=True)
    finally:
        ckpt.maybe_save(step, params, optimizer, force=True)
        save_params(os.path.join(logdir, "params.npz"), params)
        if writer is not None:
            writer.close()
    return params, metrics


def parse_args(argv):
    """(RunConfig, device) from ``--key=value`` flags: ``--device`` is the
    port's own, every other flag is the JAX CLI's."""
    device = "cuda"
    rest = []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return parse_argv(rest), device


def main(argv=None):
    run, device = parse_args(sys.argv[1:] if argv is None else argv)
    train(run, device=device)


if __name__ == "__main__":
    main()
