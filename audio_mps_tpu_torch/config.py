"""Configuration for the PyTorch/CUDA port of audio-mps-tpu.

A copy of ``audio_mps_tpu/config.py`` with the same fields, defaults and
validation, kept here so that the port never imports the JAX package
(whose ``__init__`` pulls in jax). The knob comments describe the TPU
kernels the options were introduced for; the port reads the same knobs.

Mirrors the reference's two-tier config (reference: train.py:15-44 —
``tf.flags`` for run-level choices + ``tf.contrib.training.HParams`` for model
hyperparameters with ``--hparams="k=v,..."`` overrides), collapsed into two
frozen dataclasses with the same override capability.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


def _coerce(value: str, target_type):
    """Coerce a CLI string to the type of an existing dataclass field."""
    if target_type is bool:
        if value.lower() in ("true", "1", "yes"):
            return True
        if value.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    if target_type is Optional[int] or target_type == Optional[int]:
        return None if value.lower() in ("none", "null", "") else int(value)
    return target_type(value)


@dataclass(frozen=True)
class CMPSConfig:
    """Model hyperparameters.

    Defaults mirror the reference HParams (reference: train.py:41-43):
    ``minibatch_size=8, bond_dim=8, delta_t=1/16000, sigma=1e-4,
    h_reg=200/(pi*16000)^2, r_reg=0.1, initial_rank=None, A=100,
    learning_rate=1e-3``.
    """

    minibatch_size: int = 8
    bond_dim: int = 8
    delta_t: float = 1.0 / 16000.0
    sigma: float = 1e-4
    h_reg: float = 200.0 / (math.pi * 16000.0) ** 2
    r_reg: float = 0.1
    initial_rank: Optional[int] = None
    A: float = 100.0
    learning_rate: float = 1e-3

    # --- TPU-native knobs (no reference counterpart) ---
    # Chunk length for the time scan: the T-axis loop is a scan-of-scans with
    # `jax.checkpoint` on the inner chunk, bounding BPTT memory over T=2^16
    # (the reference fully unrolls BPTT: model.py:140, train.py:91 TODO).
    scan_chunk: int = 256
    # Clamp the argument of -log(1+u) at this floor. The reference silently
    # NaNs when 1+u <= 0 (model.py:169-170); we clamp by default. Set <= 0 to
    # reproduce reference behaviour exactly.
    log_eps: float = 1e-8
    # Trace/norm floor for per-step renormalization (reference model.py:198-203,
    # model.py:327-334 use 1e-12).
    norm_eps: float = 1e-12
    # MXU precision for the fused Pallas training kernels:
    #   "highest" — 6-pass fp32, exact reference parity (default);
    #   "high"    — hand-rolled bf16x3 (hi/lo split, 3 single-pass dots):
    #               ~half the MXU passes of "highest" at ~16-bit mantissa
    #               accuracy (loss rel-err ~1e-6, grad rel-err ~1e-4);
    #               block layout only (Mosaic cannot lower XLA's HIGH);
    #   "default" — raw bf16 passes: fastest, loss rel-err ~1e-3,
    #               grad rel-err ~4e-2 — low-precision-training territory.
    kernel_precision: str = "highest"
    # Layout of the fused training kernels' complex algebra:
    #   "split" — each complex matrix apply is 4 real [D,D]@[D,N] dots;
    #   "block" — complex operators are embedded as real [2D,2D] block
    #     matrices acting on the stacked [2D,N] state, with the per-step
    #     frame rotation folded into the step constants: one full-width
    #     MXU dot per apply, 4x fewer dispatches (ops/pallas_block.py);
    #     requires bond_dim % 4 == 0.
    #   "auto" — block when supported (the measured win on v5e), else split.
    kernel_layout: str = "auto"
    # Deferred in-block normalization for the fused training kernels: the
    # state stays unnormalized within an unrolled block (the update is
    # linear, the rotation unitary), the per-step expectation divides by
    # the previous step's squared norm/trace, and renormalization happens
    # once at block exit. Mathematically exact (parity ~1e-7); measured
    # 0-7% faster fwd+bwd on v5e (biggest at small D where VPU work is a
    # larger fraction).
    defer_norm: bool = True
    # Streamed-states kernels (the r4 backward restructure: the forward
    # streams every per-step state to HBM, the backward drops its serial
    # recompute chain for batched GEMMs — measured 1.18-1.35x on the full
    # train step):
    #   "auto" — on where supported AND the stream fits the measured-safe
    #            HBM budget (ops/pallas_block.auto_stream);
    #   "on"   — force wherever structurally supported (defer_norm block
    #            kernels, tile-aligned lanes), SKIPPING the HBM budget —
    #            oversubscribed streams can page catastrophically (~15x);
    #   "off"  — never stream (the non-streamed fused kernels).
    kernel_stream: str = "auto"
    # Lane padding for the fused PSI kernels when B is not a multiple of
    # 128: a [2D, B] operand is hardware-padded to a full 128-lane tile
    # anyway, so padding B up to 128k executes the SAME MXU passes while
    # unlocking the streamed-states kernels (measured: D=128 B=64 padded
    # runs 1.24-1.29x FASTER in absolute time than unpadded,
    # PSIBATCH_r04.json). Dummy lanes carry zero signals; per-example
    # losses are sliced back, values and grads exact.
    #   "auto" — pad on real TPU when the padded shape streams within the
    #            HBM budget (ops/pallas_block.auto_pad_cols);
    #   "on"   — always pad to the next 128 multiple;
    #   "off"  — never pad.
    kernel_pad_lanes: str = "auto"
    # Latent-conditioned variant (models/latent.py — the working version of
    # the reference's follow_vae.py WIP): latent dimension, MLP width, KL
    # weight, and reconstruction loss ("log" = cMPS NLL, "quadratic" = the
    # WIP's (signal - <x>)^2/2 option, follow_vae.py:69-70).
    latent_dim: int = 8
    latent_hidden: int = 128
    latent_beta: float = 1.0
    latent_loss: str = "log"
    # Free bits (per-latent-dimension KL floor, nats): dimensions whose
    # KL is already below the floor contribute the constant floor to the
    # loss instead — no gradient pressure toward zero — the standard
    # posterior-collapse guard. 0 disables. Measured (r5): the 4-pitch
    # anchor collapses (KL ~0.01, one dominant emission line) at
    # beta=0.15 with 0, and trains with 0.25.
    latent_free_bits: float = 0.0

    def __post_init__(self):
        # Mosaic lowers only HIGHEST and DEFAULT dot precisions; "high" is
        # the hand-rolled bf16x3 emulation in the block-layout kernels.
        if self.kernel_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"kernel_precision must be 'highest', 'high', or 'default',"
                f" got {self.kernel_precision!r}")
        if self.kernel_precision == "high" and (
                self.kernel_layout == "split" or self.bond_dim % 4 != 0):
            raise ValueError(
                "kernel_precision='high' requires the block kernel layout "
                "(kernel_layout in ('auto', 'block') and bond_dim % 4 == 0)")
        if self.kernel_layout not in ("auto", "split", "block"):
            raise ValueError(
                f"kernel_layout must be 'auto', 'split', or 'block',"
                f" got {self.kernel_layout!r}")
        if self.kernel_layout == "block" and self.bond_dim % 4 != 0:
            raise ValueError(
                f"kernel_layout='block' requires bond_dim % 4 == 0,"
                f" got bond_dim={self.bond_dim}")
        if self.kernel_stream not in ("auto", "on", "off"):
            raise ValueError(
                f"kernel_stream must be 'auto', 'on', or 'off', got "
                f"{self.kernel_stream!r}")
        if self.kernel_pad_lanes not in ("auto", "on", "off"):
            raise ValueError(
                f"kernel_pad_lanes must be 'auto', 'on', or 'off', got "
                f"{self.kernel_pad_lanes!r}")
        if self.kernel_stream == "on" and (
                self.kernel_layout == "split" or self.bond_dim % 4 != 0
                or not self.defer_norm):
            raise ValueError(
                "kernel_stream='on' requires the deferred-normalization "
                "block kernels (kernel_layout in ('auto', 'block'), "
                "bond_dim % 4 == 0, defer_norm=True)")
        if self.initial_rank is not None and self.initial_rank < 1:
            raise ValueError(
                f"initial_rank must be >= 1 (or None for full rank), got "
                f"{self.initial_rank}")
        if self.latent_loss not in ("log", "quadratic"):
            raise ValueError(
                f"latent_loss must be 'log' or 'quadratic', got "
                f"{self.latent_loss!r}")
        if self.latent_free_bits < 0:
            raise ValueError(
                f"latent_free_bits must be >= 0, got "
                f"{self.latent_free_bits}")

    def parse(self, overrides: str) -> "CMPSConfig":
        """Apply a comma-separated ``k=v,...`` override string.

        Mirrors ``HParams.parse`` (reference: train.py:44).
        Returns a new config; unknown keys raise.
        """
        if not overrides:
            return self
        fields = {f.name: f for f in dataclasses.fields(self)}
        updates = {}
        for item in overrides.split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"override {item!r} is not of the form k=v")
            k, v = item.split("=", 1)
            k = k.strip()
            if k not in fields:
                raise ValueError(f"unknown hyperparameter {k!r}")
            updates[k] = _coerce(v.strip(), _FIELD_TYPES[k])
        return dataclasses.replace(self, **updates)


# Concrete runtime types for parse(); dataclass .type may be a string under
# `from __future__ import annotations`.
_FIELD_TYPES = {
    "minibatch_size": int,
    "bond_dim": int,
    "delta_t": float,
    "sigma": float,
    "h_reg": float,
    "r_reg": float,
    "initial_rank": Optional[int],
    "A": float,
    "learning_rate": float,
    "scan_chunk": int,
    "log_eps": float,
    "norm_eps": float,
    "kernel_precision": str,
    "kernel_layout": str,
    "defer_norm": bool,
    "kernel_stream": str,
    "kernel_pad_lanes": str,
    "latent_dim": int,
    "latent_hidden": int,
    "latent_beta": float,
    "latent_loss": str,
    "latent_free_bits": float,
}


def parse_mesh_spec(mesh: str):
    """Parse a --mesh spec into (kind, dims).

    'dp' -> ('dp', None);      'dp:4' -> ('dp', 4)
    'rank' -> ('rank', None);  'rank:4' -> ('rank', 4)
    'time' -> ('time', None);  'time:4' -> ('time', 4)
    'dpxrank:2x4' -> ('dpxrank', (2, 4))
    'dpxtime:2x4' -> ('dpxtime', (2, 4))
    'rankxtime:2x4' -> ('rankxtime', (2, 4))
    'dpxrankxtime:2x2x2' -> ('dpxrankxtime', (2, 2, 2))
    """
    err = (f"mesh must be '', 'dp[:N]', 'rank[:N]', 'time[:N]', "
           f"'dpxrank:AxB', 'dpxtime:AxB', 'rankxtime:AxB', or "
           f"'dpxrankxtime:AxBxC', got {mesh!r}")
    kind, sep, dims = mesh.partition(":")
    if kind in ("dp", "rank", "time"):
        if not sep:
            return kind, None
        if dims.isdigit() and int(dims) > 0:
            return kind, int(dims)
        raise ValueError(err)
    if kind in ("dpxrank", "dpxtime", "rankxtime", "dpxrankxtime"):
        parts = dims.split("x")
        n_axes = 3 if kind == "dpxrankxtime" else 2
        if (len(parts) == n_axes and all(p.isdigit() and int(p) > 0
                                         for p in parts)):
            return kind, tuple(int(p) for p in parts)
        raise ValueError(err)
    raise ValueError(err)


@dataclass(frozen=True)
class RunConfig:
    """Run-level flags (reference: train.py:18-33, sample.py:10-14)."""

    mps_model: str = "psi_mps"          # {"rho_mps", "psi_mps", "latent"}
    dataset: str = "damped_sine"        # {"damped_sine", "guitar", "organ", "nsynth"}
    sample_duration: int = 2 ** 16
    sample_rate: int = 16000
    visualize: bool = True
    num_samples: int = 3
    hparams: str = ""                   # k=v,... override string
    datadir: str = "./data"
    logdir: str = "./logging/audio_mps"
    # Training-loop controls (reference used tf.contrib.training.train with
    # save_checkpoint_secs=60 and an unbounded step count: train.py:93-94).
    max_steps: int = 0                  # 0 = run forever
    checkpoint_secs: float = 60.0
    summary_every: int = 10
    seed: int = 0
    # Profiling (SURVEY.md §5: the reference has no tracing; the TPU plan
    # is jax.profiler traces). 0 disables; N captures steps [2, 2+N) into
    # {logdir}/profile for TensorBoard's trace viewer.
    profile_steps: int = 0
    # Fused Pallas train kernels: "auto" (TPU only), "true", "false".
    fused: str = "auto"
    # TFRecord ingestion: "auto" streams files above the size threshold
    # through the reservoir shuffle (data/pipeline.py) instead of loading
    # them into host RAM; "true"/"false" force.
    stream: str = "auto"
    # Multi-chip training from the CLI (every strategy the library has —
    # VERDICT r3 item 3): "" = single device; "dp"/"dp:N" = data-parallel
    # shard_map over all/the first N local devices (mesh size must divide
    # the minibatch); "rank"/"rank:N" = purification-rank tensor
    # parallelism (rho family; axis size must divide the rank);
    # "time"/"time:N" = temporal pipeline (both families; stage count
    # must divide T-1; fused=auto selects the carried-state partials
    # kernels); "dpxrank:AxB" = 2D data x model mesh (DP x TP);
    # "dpxtime:AxB" = 2D data x time mesh (DP x sequence parallelism;
    # the time axis must divide T-1).
    mesh: str = ""

    def __post_init__(self):
        if self.fused not in ("auto", "true", "false"):
            raise ValueError(
                f"fused must be 'auto', 'true', or 'false', got "
                f"{self.fused!r}")
        if self.stream not in ("auto", "true", "false"):
            raise ValueError(
                f"stream must be 'auto', 'true', or 'false', got "
                f"{self.stream!r}")
        if self.mesh:
            parse_mesh_spec(self.mesh)      # raises on malformed specs

    def run_logdir(self, cfg: CMPSConfig) -> str:
        """Run-parameterized logdir (reference: train.py:94)."""
        return (f"{self.logdir}/{self.dataset}/"
                f"{cfg.bond_dim}_{cfg.delta_t}_{cfg.minibatch_size}")


def parse_argv(argv, run: RunConfig = RunConfig()) -> RunConfig:
    """Parse ``--key=value`` style args into a RunConfig."""
    fields = {f.name: f for f in dataclasses.fields(RunConfig)}
    types = {
        "mps_model": str, "dataset": str, "sample_duration": int,
        "sample_rate": int, "visualize": bool, "num_samples": int,
        "hparams": str, "datadir": str, "logdir": str, "max_steps": int,
        "checkpoint_secs": float, "summary_every": int, "seed": int,
        "profile_steps": int, "fused": str, "stream": str, "mesh": str,
    }
    updates = {}
    for arg in argv:
        if not arg.startswith("--"):
            continue
        body = arg[2:]
        if "=" not in body:
            k, v = body, "true"
        else:
            k, v = body.split("=", 1)
        if k in fields:
            updates[k] = _coerce(v, types[k])
        else:
            raise ValueError(f"unknown flag --{k}")
    return dataclasses.replace(run, **updates)
