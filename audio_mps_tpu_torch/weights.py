"""Carry psi weights between the JAX package and the port.

The exchange format is an ``.npz`` with six fp32 arrays named after the
JAX leaves: ``A`` (scalar), ``Rx``, ``Ry`` ([D,D]), ``freqs``, ``psi_x``,
``psi_y`` ([D]). The JAX side writes one from a restored checkpoint with
numpy alone (README, "PyTorch/CUDA port").
"""
from __future__ import annotations

import numpy as np

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


def save_params(path, p: PsiParams):
    np.savez(path, **psi_params_to_numpy(p))


def load_params(path, device="cuda") -> PsiParams:
    with np.load(path, allow_pickle=False) as z:
        return psi_params_from_numpy({k: z[k] for k in z.files}, device)
