"""Training subsystem of the port: the loss, the Adam step and checkpoints
(counterpart of ``audio_mps_tpu/training.py``, psi and rho families).

The step is eager PyTorch: total loss (NLL + h_reg/r_reg, reference:
train.py:55-60), ``backward()``, and ``torch.optim.Adam`` at
``cfg.learning_rate`` (the update of ``optax.adam``; reference:
train.py:88-89). On a card the NLL and its gradient go through the CUDA
kernels of ``ops/block.py``, ``ops/split.py`` or ``ops/rank.py``; there is
no fallback to another path.
Checkpoints are torch state dicts saved on the reference's time cadence
(``save_checkpoint_secs=60``, reference: train.py:93), the latest three
kept, restored on restart.
"""
from __future__ import annotations

import os
import re
import time
from typing import Optional

import torch

from .config import CMPSConfig
from .device import resolve_device
from .models import core
from .models.params import init_psi, init_rho
from .ops.grad import psi_nll_fused_trainable, rho_nll_fused_trainable

_NOT_PORTED = {
    "latent": "the latent family (ROADMAP queue A: Latent family)",
}
# mps_model -> (eager loss, kernel loss, init)
_FAMILIES = {
    "psi_mps": (core.psi_nll, psi_nll_fused_trainable, init_psi),
    # the factor evolution: the value of core.rho_nll at half the FLOPs
    "rho_mps": (core.rho_nll_factor, rho_nll_fused_trainable, init_rho),
}


def _family(mps_model: str):
    if mps_model in _NOT_PORTED:
        raise NotImplementedError(
            f"mps_model={mps_model!r}: {_NOT_PORTED[mps_model]} is not "
            f"ported yet")
    if mps_model not in _FAMILIES:
        raise ValueError(
            f"mps_model must be rho_mps, psi_mps, or latent, got "
            f"{mps_model!r}")
    return _FAMILIES[mps_model]


def nll_fn_for(mps_model: str, fused: Optional[bool] = None):
    """NLL implementation nll(params, cfg, signals) -> scalar.
    ``fused=None`` runs the kernels when the signals lie on a CUDA device
    and the eager loss (``core.psi_nll``, ``core.rho_nll_factor``) on the
    CPU; ``fused=True`` runs the kernel path (its plain versions on the
    CPU); ``fused=False`` runs the eager loss anywhere. psi trains through
    the block kernels at D % 4 == 0 (``ops/block.py``, to D=68) and through
    the split kernels elsewhere or with ``kernel_layout="split"``
    (``ops/split.py``, to D=73 at unroll 16); past a layout's shared-memory
    ceiling the kernel path raises ``NotImplementedError``. Past the
    monolithic rho kernels' ceiling (D > 64 or rank > 64) rho training
    runs rank-chunked through the partials kernels (``ops/rank.py``), as
    the JAX package does past its VMEM ceiling; rho at D % 4 != 0 or with
    ``kernel_layout="split"`` trains through its split kernels
    (``ops/split.py``, to D=53 at full rank and unroll 16). Unlike the JAX
    package, nothing falls back to the scan."""
    eager, kernel, _init = _family(mps_model)

    def nll(params, cfg: CMPSConfig, signals):
        kernels = (signals.device.type == "cuda" if fused is None
                   else fused)
        if not kernels:
            return eager(params, cfg, signals)
        return kernel(params, cfg, signals, precision=cfg.kernel_precision,
                      defer_norm=cfg.defer_norm)
    return nll


def init_params_for(mps_model: str, generator: torch.Generator,
                    cfg: CMPSConfig, device="cuda"):
    """Random parameters on ``device``."""
    return _family(mps_model)[2](generator, cfg, device=device)


def make_optimizer(cfg: CMPSConfig, params):
    """Adam at the reference learning rate (reference: train.py:88-89)."""
    return torch.optim.Adam(params.parameters(), lr=cfg.learning_rate)


def make_loss_fn(mps_model: str, cfg: CMPSConfig,
                 fused: Optional[bool] = None):
    """loss_fn(params, batch) -> (total, metrics), with the metrics of the
    JAX package: model_loss, total_loss, h_l2sqnorm, r_l2sqnorm, A."""
    nll = nll_fn_for(mps_model, fused)

    def loss_fn(params, batch):
        model_loss = nll(params, cfg, batch)
        total, (h_sq, r_sq) = core.regularized_loss(model_loss, params, cfg)
        return total, {"model_loss": model_loss, "total_loss": total,
                       "h_l2sqnorm": h_sq, "r_l2sqnorm": r_sq,
                       "A": params.A}
    return loss_fn


def make_train_step(mps_model: str, cfg: CMPSConfig, params,
                    fused: Optional[bool] = None, device="cuda"):
    """Returns (optimizer, step). ``step(batch) -> metrics`` moves the
    batch to ``device``, takes one Adam step on ``params`` in place and
    returns the metrics of the parameters it started from, detached. A
    checkpoint or a JAX run's Adam state is loaded into the returned
    optimizer."""
    dev = resolve_device(device)
    have = params.A.device
    if have.type != dev.type or dev.index not in (None, have.index):
        raise ValueError(f"params lie on {params.A.device}, the step runs on "
                         f"{dev}")
    optimizer = make_optimizer(cfg, params)
    loss_fn = make_loss_fn(mps_model, cfg, fused)

    def step(batch):
        batch = torch.as_tensor(batch, dtype=torch.float32, device=dev)
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(params, batch)
        total.backward()
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        optimizer.step()
        return metrics

    return optimizer, step


class Checkpointer:
    """Checkpoint/resume of (params, optimizer, step) as torch state dicts,
    one ``ckpt_<step>.pt`` a save (written to a temporary name, then
    renamed). The cadence is the reference's ``save_checkpoint_secs``;
    the latest three files stay, as in the JAX package. Saves are
    synchronous."""

    _NAME = re.compile(r"^ckpt_(\d+)\.pt$")
    MAX_TO_KEEP = 3

    def __init__(self, directory: str, save_secs: float = 60.0):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_secs = save_secs
        self._last_save = time.time()

    def _steps(self):
        found = (self._NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, params, optimizer) -> int:
        """Load the latest checkpoint into ``params`` and ``optimizer`` in
        place; returns its step, or 0 when there is none."""
        step = self.latest_step()
        if step is None:
            return 0
        state = torch.load(self._path(step), map_location=params.A.device,
                           weights_only=True)
        params.load_state_dict(state["params"])
        optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])

    def maybe_save(self, step: int, params, optimizer,
                   force: bool = False) -> bool:
        """Save when the cadence has elapsed (or ``force``); prune to the
        latest ``MAX_TO_KEEP``."""
        now = time.time()
        if not force and now - self._last_save < self.save_secs:
            return False
        path = self._path(step)
        torch.save({"params": params.state_dict(),
                    "optimizer": optimizer.state_dict(), "step": step},
                   path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self._steps()[:-self.MAX_TO_KEEP]:
            os.remove(self._path(old))
        self._last_save = now
        return True
