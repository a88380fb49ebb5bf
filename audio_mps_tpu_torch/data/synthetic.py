"""Synthetic damped-sine batches (port of ``audio_mps_tpu/data/synthetic.py``).

A middle-C (261.6 Hz) sine with 0.1 s exponential decay, gated on at a
per-example onset delay drawn from Gamma(alpha=2, beta=2/delay_time) with
delay_time = T/100 samples (reference: data.py:8-22).
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device

MIDDLE_C_HZ = 261.6
DECAY_TIME_S = 0.1


def damped_sine_batch(generator: torch.Generator, batch_size: int,
                      sample_duration: int, delta_t: float,
                      freq_hz=MIDDLE_C_HZ) -> torch.Tensor:
    """One [batch_size, sample_duration] fp32 batch on the generator's
    device. ``freq_hz`` may be a scalar or a per-example [batch_size]
    sequence.

    Gamma(2, 1) is exactly the sum of two Exp(1) draws, ``-log U1 - log U2``,
    so the onsets need only uniforms from the generator (``1 - U`` keeps
    the argument of the log in (0, 1])."""
    dev = generator.device
    u = torch.rand((batch_size, 2), generator=generator, device=dev,
                   dtype=torch.float32)
    gamma = -torch.log1p(-u).sum(dim=1, keepdim=True)
    delays = gamma * (sample_duration / 100.0 / 2.0)
    n = torch.arange(sample_duration, dtype=torch.float32, device=dev)[None]
    times = (n - delays) * delta_t
    gate = 0.5 * (torch.sign(times) + 1.0)
    f = torch.as_tensor(freq_hz, dtype=torch.float32,
                        device=dev).reshape(-1, 1)
    wave = gate * torch.sin(2.0 * math.pi * f * times) \
        * torch.exp(-times / DECAY_TIME_S)
    return wave.to(torch.float32)


def damped_sine_iterator(cfg, sample_duration: int, seed: int = 0,
                         device="cuda"):
    """Infinite iterator of fresh [minibatch_size, sample_duration] batches
    on ``device``: one generator seeded with ``seed``, advanced by each
    batch's draws."""
    generator = torch.Generator(resolve_device(device)).manual_seed(seed)
    while True:
        yield damped_sine_batch(generator, cfg.minibatch_size,
                                sample_duration, cfg.delta_t)
