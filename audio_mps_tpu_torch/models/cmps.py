"""Object API for the pure-state model (port of ``PsiCMPS`` in
``audio_mps_tpu/models/cmps.py``; reference: model.py:206-334).

A thin stateful wrapper over the eager core and the kernels: it owns a
``PsiParams`` module, the config, a device and a ``torch.Generator``, and
exposes the reference's attribute surface (``.loss``, ``.psi_0``, ``.R``,
``.freqs``, ``.A``) and methods (``psi_evolve_with_data``, ``sample``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CMPSConfig
from ..device import resolve_device
from ..ops.complexing import to_numpy
from ..ops.scan import psi_sample_fused
from . import core
from .cell import effective_R
from .params import init_psi


class PsiCMPS:
    """Pure-state variant (reference: model.py:206-334).

    ``data_iterator`` is a [B,T] waveform batch (array or tensor), what
    ``.loss`` and ``psi_evolve_with_data`` consume. ``generator`` seeds the
    parameter init and later sampling; without one, a generator on
    ``device`` is seeded with ``seed``."""

    def __init__(self, hparams: CMPSConfig, data_iterator=None, psi_in=None,
                 freqs_in=None, R_in=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        self.cfg = hparams
        self.device = resolve_device(device)
        self.bond_d = hparams.bond_dim
        self.batch_size = hparams.minibatch_size
        self.h_reg = hparams.h_reg
        self.r_reg = hparams.r_reg
        self.delta_t = hparams.delta_t
        self.sigma = hparams.sigma
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(seed)
        self.generator = generator
        self.params = init_psi(generator, hparams, freqs_in=freqs_in,
                               R_in=R_in, psi_in=psi_in, device=self.device)
        self.data_iterator = data_iterator
        if data_iterator is not None:
            with torch.no_grad():
                self.loss = core.psi_nll(self.params, hparams, self._data())

    def _data(self):
        return torch.as_tensor(np.asarray(self.data_iterator),
                               dtype=torch.float32, device=self.device)

    @property
    def A(self):
        return self.params.A

    @property
    def freqs(self):
        return self.params.freqs

    @property
    def R(self) -> np.ndarray:
        """Effective (zero-diagonal) complex R (reference: model.py:41-42)."""
        return to_numpy(*effective_R(self.params))

    @property
    def psi_0(self) -> np.ndarray:
        return to_numpy(*core.psi0(self.params, self.cfg))

    def psi_evolve_with_data(self) -> np.ndarray:
        """[B, T-1, D] complex trajectory (reference: model.py:231-240)."""
        with torch.no_grad():
            pr, pi = core.psi_evolve_with_data(self.params, self.cfg,
                                               self._data())
        return to_numpy(pr, pi)

    def sample(self, num_samples: int, length: int, temp: float = 1.0,
               generator: Optional[torch.Generator] = None,
               fused: bool = False) -> np.ndarray:
        """[N, length] waveforms (reference: model.py:242-251). ``fused``
        runs the block sampler kernel (``ops/scan.psi_sample_fused``)."""
        generator = generator if generator is not None else self.generator
        noise = core._sample_noise(self.cfg, generator, num_samples, length,
                                   temp).to(self.device)
        with torch.no_grad():
            if fused:
                waves = psi_sample_fused(self.params, self.cfg, noise)
            else:
                waves = core.sample_psi_with_noise(self.params, self.cfg,
                                                   noise)
        return waves.cpu().numpy()
