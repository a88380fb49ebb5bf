"""Object API for the two model families (port of ``RhoCMPS`` and
``PsiCMPS`` in ``audio_mps_tpu/models/cmps.py``; reference: model.py).

Thin stateful wrappers over the eager core and the kernels: each owns a
parameter module, the config, a device and a ``torch.Generator``, and
exposes the reference's attribute surface (``.loss``, ``.rho_0`` /
``.psi_0``, ``.R``, ``.freqs``, ``.A``) and methods (``*_evolve_with_data``,
``rho_evolve_with_sampling``, ``purity``, ``sample``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import CMPSConfig
from ..device import resolve_device
from ..ops.complexing import to_numpy
from ..ops.scan import psi_sample_fused, rho_sample_fused
from . import core
from .cell import effective_R
from .params import init_psi, init_rho


class _CMPS:
    """Shared set-up and attributes. ``data_iterator`` is a [B,T] waveform
    batch (array or tensor), what ``.loss`` and the ``*_evolve_with_data``
    methods consume. ``generator`` seeds the parameter init and later
    sampling; without one, a generator on ``device`` is seeded with
    ``seed``."""

    def __init__(self, hparams: CMPSConfig, data_iterator, seed: int,
                 generator: Optional[torch.Generator], device):
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
        self.data_iterator = data_iterator

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

    def _noise(self, num_samples, length, temp, generator):
        generator = generator if generator is not None else self.generator
        return core._sample_noise(self.cfg, generator, num_samples, length,
                                  temp).to(self.device)


class RhoCMPS(_CMPS):
    """Mixed-state variant (reference: model.py:55-203). ``W_in`` warm-starts
    the rho_0 factor W [initial_rank, D]. ``.loss`` is ``core.rho_nll`` (the
    literal density matrix), as in the JAX class."""

    def __init__(self, hparams: CMPSConfig, data_iterator=None, W_in=None,
                 freqs_in=None, R_in=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(hparams, data_iterator, seed, generator, device)
        self.params = init_rho(self.generator, hparams, freqs_in=freqs_in,
                               R_in=R_in, W_in=W_in, device=self.device)
        self.rank_rho_0 = (hparams.initial_rank if hparams.initial_rank
                           is not None else hparams.bond_dim)
        if data_iterator is not None:
            with torch.no_grad():
                self.loss = core.rho_nll(self.params, hparams, self._data())

    @property
    def rho_0(self) -> np.ndarray:
        return to_numpy(*core.rho0(self.params, self.cfg))

    def rho_evolve_with_data(self) -> np.ndarray:
        """[B, T-1, D, D] complex trajectory (reference: model.py:76-85)."""
        with torch.no_grad():
            rr, ri = core.rho_evolve_with_data(self.params, self.cfg,
                                               self._data())
        return to_numpy(rr, ri)

    def rho_evolve_with_sampling(self, num_samples: int, length: int,
                                 temp: float = 1.0,
                                 generator: Optional[torch.Generator] = None
                                 ) -> np.ndarray:
        """[N, length, D, D] complex trajectory (reference: model.py:87-93)."""
        noise = self._noise(num_samples, length, temp, generator)
        with torch.no_grad():
            rr, ri = core.rho_evolve_with_noise(self.params, self.cfg, noise)
        return to_numpy(rr, ri)

    def purity(self, num_samples: int, length: int, temp: float = 1.0,
               generator: Optional[torch.Generator] = None) -> np.ndarray:
        """[N, length] tr(rho^2) (reference: model.py:95-101)."""
        noise = self._noise(num_samples, length, temp, generator)
        with torch.no_grad():
            p = core.purity_with_noise(self.params, self.cfg, noise)
        return p.cpu().numpy()

    def sample(self, num_samples: int, length: int, temp: float = 1.0,
               generator: Optional[torch.Generator] = None,
               fused: bool = False) -> np.ndarray:
        """[N, length] waveforms (reference: model.py:103-112). ``fused``
        runs the block sampler kernel (``ops/scan.rho_sample_fused``)."""
        noise = self._noise(num_samples, length, temp, generator)
        with torch.no_grad():
            if fused:
                waves = rho_sample_fused(self.params, self.cfg, noise)
            else:
                waves = core.sample_rho_with_noise(self.params, self.cfg,
                                                   noise)
        return waves.cpu().numpy()


class PsiCMPS(_CMPS):
    """Pure-state variant (reference: model.py:206-334)."""

    def __init__(self, hparams: CMPSConfig, data_iterator=None, psi_in=None,
                 freqs_in=None, R_in=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__(hparams, data_iterator, seed, generator, device)
        self.params = init_psi(self.generator, hparams, freqs_in=freqs_in,
                               R_in=R_in, psi_in=psi_in, device=self.device)
        if data_iterator is not None:
            with torch.no_grad():
                self.loss = core.psi_nll(self.params, hparams, self._data())

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
        runs the sampler kernel of the layout ``ops/scan.psi_sample_fused``
        resolves: the block sampler at D % 8 == 0, the split one
        elsewhere."""
        noise = self._noise(num_samples, length, temp, generator)
        with torch.no_grad():
            if fused:
                waves = psi_sample_fused(self.params, self.cfg, noise)
            else:
                waves = core.sample_psi_with_noise(self.params, self.cfg,
                                                   noise)
        return waves.cpu().numpy()
