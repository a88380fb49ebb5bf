"""Carry weights between the JAX package and the port.

The exchange format is an ``.npz`` of fp32 arrays named after the JAX
leaves: ``A`` (scalar), ``Rx``, ``Ry`` ([D,D]), ``freqs`` ([D]), and the
family's own pair, ``psi_x``, ``psi_y`` ([D]) for psi or ``Wx``, ``Wy``
([rank, D]) for rho. The JAX side writes one from a restored checkpoint
with numpy alone (README, "PyTorch/CUDA port"); ``load_params`` picks the
family from the leaves it finds. The optimizer state crosses the same way
(``adam_state_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.params import PsiParams, RhoParams


def _from_numpy(cls, d: dict, device):
    missing = [k for k in cls.NAMES if k not in d]
    if missing:
        raise KeyError(f"{cls.__name__} weights lack {missing}")
    dev = resolve_device(device)
    return cls(**{k: np.asarray(d[k], np.float32) for k in cls.NAMES}).to(dev)


def psi_params_from_numpy(d: dict, device="cuda") -> PsiParams:
    """``PsiParams`` on ``device`` from a name -> array mapping."""
    return _from_numpy(PsiParams, d, device)


def rho_params_from_numpy(d: dict, device="cuda") -> RhoParams:
    """``RhoParams`` on ``device`` from a name -> array mapping."""
    return _from_numpy(RhoParams, d, device)


def params_to_numpy(p) -> dict:
    """Name -> fp32 numpy array for every leaf of ``p``, ``PsiParams`` or
    ``RhoParams``: the inverse of ``psi_params_from_numpy`` and
    ``rho_params_from_numpy``."""
    return {k: getattr(p, k).detach().cpu().numpy().astype(np.float32)
            for k in p.NAMES}


psi_params_to_numpy = params_to_numpy


def adam_state_from_numpy(d: dict, params, optimizer):
    """Load optax's Adam state into ``optimizer`` (a ``torch.optim.Adam``
    over ``params``, of either family), so that a JAX run resumes in the
    port.

    ``d`` is ``ScaleByAdamState`` flattened to numpy arrays: ``count``
    (the number of steps taken), ``mu/<leaf>`` and ``nu/<leaf>`` for each
    leaf name (the first and second moments; README, "PyTorch/CUDA port",
    shows the JAX lines that write them). optax and torch.optim.Adam share
    the update: bias-corrected m / (sqrt(v) + eps)."""
    want = ["count"] + [f"{m}/{k}" for m in ("mu", "nu")
                        for k in params.NAMES]
    missing = [k for k in want if k not in d]
    if missing:
        raise KeyError(f"Adam state lacks {missing}")
    count = float(np.asarray(d["count"]))
    for name in params.NAMES:
        p = getattr(params, name)
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(d[f"mu/{name}"], np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(d[f"nu/{name}"],
                                                  np.float32),
                                       device=p.device),
        }


def save_params(path, p):
    np.savez(path, **params_to_numpy(p))


def load_params(path, device="cuda"):
    """``RhoParams`` when the file holds ``Wx``/``Wy``, else ``PsiParams``."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    cls = RhoParams if "Wx" in d or "Wy" in d else PsiParams
    return _from_numpy(cls, d, device)
