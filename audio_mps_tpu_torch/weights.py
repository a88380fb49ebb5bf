"""Carry psi weights between the JAX package and the port.

The exchange format is an ``.npz`` with six fp32 arrays named after the
JAX leaves: ``A`` (scalar), ``Rx``, ``Ry`` ([D,D]), ``freqs``, ``psi_x``,
``psi_y`` ([D]). The JAX side writes one from a restored checkpoint with
numpy alone (README, "PyTorch/CUDA port"). The optimizer state crosses the
same way (``adam_state_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.params import PsiParams


def psi_params_from_numpy(d: dict, device="cuda") -> PsiParams:
    """``PsiParams`` on ``device`` from a name -> array mapping."""
    missing = [k for k in PsiParams.NAMES if k not in d]
    if missing:
        raise KeyError(f"psi weights lack {missing}")
    dev = resolve_device(device)
    return PsiParams(**{k: np.asarray(d[k], np.float32)
                        for k in PsiParams.NAMES}).to(dev)


def psi_params_to_numpy(p: PsiParams) -> dict:
    """Name -> fp32 numpy array for every leaf of ``p``."""
    return {k: getattr(p, k).detach().cpu().numpy().astype(np.float32)
            for k in PsiParams.NAMES}


def adam_state_from_numpy(d: dict, params: PsiParams, optimizer):
    """Load optax's Adam state into ``optimizer`` (a ``torch.optim.Adam``
    over ``params``), so that a JAX run resumes in the port.

    ``d`` is ``ScaleByAdamState`` flattened to numpy arrays: ``count``
    (the number of steps taken), ``mu/<leaf>`` and ``nu/<leaf>`` for each
    leaf name (the first and second moments; README, "PyTorch/CUDA port",
    shows the JAX lines that write them). optax and torch.optim.Adam share
    the update: bias-corrected m / (sqrt(v) + eps)."""
    want = ["count"] + [f"{m}/{k}" for m in ("mu", "nu")
                        for k in PsiParams.NAMES]
    missing = [k for k in want if k not in d]
    if missing:
        raise KeyError(f"Adam state lacks {missing}")
    count = float(np.asarray(d["count"]))
    for name in PsiParams.NAMES:
        p = getattr(params, name)
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(d[f"mu/{name}"], np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(d[f"nu/{name}"],
                                                  np.float32),
                                       device=p.device),
        }


def save_params(path, p: PsiParams):
    np.savez(path, **psi_params_to_numpy(p))


def load_params(path, device="cuda") -> PsiParams:
    with np.load(path, allow_pickle=False) as z:
        return psi_params_from_numpy({k: z[k] for k in z.files}, device)
