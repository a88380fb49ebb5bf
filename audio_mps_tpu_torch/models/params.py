"""Learnable parameters of the cMPS families (port of
``audio_mps_tpu/models/params.py``): the pure state (psi) and the mixed
state (rho).

All complex quantities are stored as real pairs, with the JAX leaf names
(``A, Rx, Ry, freqs`` and ``psi_x, psi_y`` or ``Wx, Wy``) so that weights
cross between the two packages by name (see ``weights.py``).

Initialization follows the JAX package's distributions (R: normal with
stddev ``1/sqrt(r_reg)``; freqs: stddev ``1/sqrt(h_reg)``; psi_0 and W:
TF1's glorot_uniform limits) drawn from an explicit ``torch.Generator``.
The values differ from ``jax.random``'s for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import CMPSConfig
from ..device import resolve_device


def _glorot_uniform(generator, shape):
    """TF1 get_variable default initializer (glorot_uniform) equivalent."""
    if len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        fan_in, fan_out = shape[-2], shape[-1]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


class _Params(nn.Module):
    """fp32 ``nn.Parameter`` leaves named by ``NAMES``."""

    NAMES: tuple = ()

    def __init__(self, **leaves):
        super().__init__()
        if set(leaves) != set(self.NAMES):
            raise TypeError(f"{type(self).__name__} takes {self.NAMES}, got "
                            f"{tuple(leaves)}")
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(
                torch.as_tensor(leaves[name], dtype=torch.float32).clone()))


class PsiParams(_Params):
    """Pure-state parameters (reference: model.py:5-52, 214-222).

    Attributes (all fp32 ``nn.Parameter``):
      A: signal amplitude scale (scalar).
      Rx, Ry: real/imag parts of the D x D measurement operator R, stored
        with whatever diagonal; the model zeroes it at use time.
      freqs: length-D diagonal Hamiltonian.
      psi_x, psi_y: real/imag parts of the initial state [D].
    """

    NAMES = ("A", "Rx", "Ry", "freqs", "psi_x", "psi_y")


class RhoParams(_Params):
    """Mixed-state parameters (reference: model.py:55-67, 118-130): the
    shared leaves and the rho_0 factor W, ``rho_0 = W^dag W / tr(W^dag W)``,
    with Wx, Wy the real/imag parts of W [initial_rank, D]."""

    NAMES = ("A", "Rx", "Ry", "freqs", "Wx", "Wy")


def _complex_in(x, shape, name, device):
    x = np.asarray(x)
    if x.shape != shape:
        raise ValueError(f"{name} shape {x.shape} != {shape}")
    return (torch.as_tensor(x.real.astype(np.float32), device=device),
            torch.as_tensor(x.imag.astype(np.float32), device=device))


def init_common(generator: torch.Generator, cfg: CMPSConfig, freqs_in=None,
                R_in=None, device="cuda") -> dict:
    """The shared parameter leaves; ``freqs_in`` / ``R_in`` are optional
    numpy warm starts (reference: model.py:31-33, 44-46)."""
    dev = resolve_device(device)
    d = cfg.bond_dim
    g = generator
    if R_in is not None:
        Rx, Ry = _complex_in(R_in, (d, d), "R_in", dev)
    else:
        scale = float(1.0 / np.sqrt(cfg.r_reg))
        Rx = scale * torch.randn((d, d), generator=g, device=g.device)
        Ry = scale * torch.randn((d, d), generator=g, device=g.device)
    if freqs_in is not None:
        freqs = _complex_in(freqs_in, (d,), "freqs_in", dev)[0]
    else:
        freqs = float(1.0 / np.sqrt(cfg.h_reg)) * torch.randn(
            (d,), generator=g, device=g.device)
    return dict(A=torch.tensor(cfg.A, dtype=torch.float32, device=dev),
                Rx=Rx.to(dev), Ry=Ry.to(dev), freqs=freqs.to(dev))


def init_psi(generator: torch.Generator, cfg: CMPSConfig, freqs_in=None,
             R_in=None, psi_in=None, device="cuda") -> PsiParams:
    """Random (or warm-started) ``PsiParams`` on ``device``; the random
    draws come from ``generator`` on its own device."""
    common = init_common(generator, cfg, freqs_in=freqs_in, R_in=R_in,
                         device=device)
    dev = common["A"].device
    if psi_in is not None:
        psi_x, psi_y = _complex_in(psi_in, (cfg.bond_dim,), "psi_in", dev)
    else:
        psi_x = _glorot_uniform(generator, (cfg.bond_dim,)).to(dev)
        psi_y = _glorot_uniform(generator, (cfg.bond_dim,)).to(dev)
    return PsiParams(psi_x=psi_x, psi_y=psi_y, **common)


def init_rho(generator: torch.Generator, cfg: CMPSConfig, freqs_in=None,
             R_in=None, W_in=None, device="cuda") -> RhoParams:
    """Random (or warm-started) ``RhoParams`` on ``device``; W is
    [initial_rank, D] (rank D when ``initial_rank`` is None)."""
    common = init_common(generator, cfg, freqs_in=freqs_in, R_in=R_in,
                         device=device)
    dev = common["A"].device
    rank = cfg.initial_rank if cfg.initial_rank is not None else cfg.bond_dim
    shape = (rank, cfg.bond_dim)
    if W_in is not None:
        Wx, Wy = _complex_in(W_in, shape, "W_in", dev)
    else:
        Wx = _glorot_uniform(generator, shape).to(dev)
        Wy = _glorot_uniform(generator, shape).to(dev)
    return RhoParams(Wx=Wx, Wy=Wy, **common)
