"""Split real/imaginary complex linear algebra on torch tensors.

The port keeps the JAX package's split form (a "cpair" is a tuple
``(re, im)`` of equal-shape float tensors) so that the eager reference and
the kernels compare like with like against ``audio_mps_tpu``. Every matrix
product the port forms itself runs in true fp32 whatever the
process-global setting (``torch.set_float32_matmul_precision``: TF32 on the
card, bf16 on the CPU's oneDNN path), forward and backward, as the JAX
package pins ``precision="highest"`` on its complex algebra: ``matmul``
below for products that autograd sees, ``fp32_products`` around the
others. Neither changes the caller's setting once it returns.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def _matmul_backends():
    """The fp32 matmul settings of cuBLAS and oneDNN (``fp32_precision``)."""
    return torch.backends.cuda.matmul, torch.backends.mkldnn.matmul


@contextlib.contextmanager
def fp32_products():
    """Run the products inside in true fp32 (no TF32, no bf16 passes), then
    restore the caller's settings exactly."""
    backends = _matmul_backends()
    saved = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, v in zip(backends, saved):
            b.fp32_precision = v


class _Fp32Matmul(torch.autograd.Function):
    """``a @ b`` whose backward products are pinned too: autograd runs the
    backward after any context around the forward has exited."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with fp32_products():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with fp32_products():
            if ctx.needs_input_grad[0]:
                ga = (g @ b.mT).sum_to_size(a.shape)
            if ctx.needs_input_grad[1]:
                gb = (a.mT @ g).sum_to_size(b.shape)
        return ga, gb


def matmul(a, b):
    """``a @ b`` of tensors of two or more dimensions (broadcast over the
    leading ones) in true fp32, its gradient too."""
    return _Fp32Matmul.apply(a, b)


def to_numpy(re, im) -> np.ndarray:
    """Join a cpair back into a numpy complex64 array (host side)."""
    re = re.detach().cpu().numpy().astype(np.complex64)
    im = im.detach().cpu().numpy().astype(np.complex64)
    return re + 1j * im


def cmul(ar, ai, br, bi):
    """Elementwise complex multiply: (a*b).re, (a*b).im."""
    return ar * br - ai * bi, ar * bi + ai * br


def cconj(ar, ai):
    return ar, -ai


def cmatmul(ar, ai, br, bi):
    """Complex matmul of cpairs using 4 real matmuls."""
    return (matmul(ar, br) - matmul(ai, bi),
            matmul(ar, bi) + matmul(ai, br))


def cmatmul_adj_right(ar, ai, br, bi):
    """``A @ B^dagger`` for cpairs: B^dagger = conj(B)^T."""
    bt_r = br.transpose(-1, -2)
    bt_i = -bi.transpose(-1, -2)
    return (matmul(ar, bt_r) - matmul(ai, bt_i),
            matmul(ar, bt_i) + matmul(ai, bt_r))


def cadjoint(ar, ai):
    """Conjugate transpose of the last two axes."""
    return ar.transpose(-1, -2), -ai.transpose(-1, -2)


def ctrace_re(ar):
    """Real part of the trace only needs the real part of the matrix."""
    return ar.diagonal(dim1=-2, dim2=-1).sum(-1)


def gram_adj(ar, ai):
    """``A^dagger @ A`` for a cpair (the R^dag R of the one-step update)."""
    at_r, at_i = cadjoint(ar, ai)
    return cmatmul(at_r, at_i, ar, ai)


def apply_matrix(mr, mi, vr, vi):
    """Apply matrix M [D,D] to a batch of row-vectors v [..., D]: (M v)_a =
    sum_b M_ab v_b, i.e. ``v @ M^T`` in row-vector form."""
    mt_r = mr.T
    mt_i = mi.T
    return (matmul(vr, mt_r) - matmul(vi, mt_i),
            matmul(vr, mt_i) + matmul(vi, mt_r))
