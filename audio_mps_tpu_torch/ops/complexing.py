"""Split real/imaginary complex linear algebra on torch tensors.

The port keeps the JAX package's split form (a "cpair" is a tuple
``(re, im)`` of equal-shape float tensors) so that the eager reference and
the kernels compare like with like against ``audio_mps_tpu``. Matrix
products are plain fp32 ``torch.matmul``; callers on the card keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""
from __future__ import annotations

import numpy as np


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
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def cmatmul_adj_right(ar, ai, br, bi):
    """``A @ B^dagger`` for cpairs: B^dagger = conj(B)^T."""
    bt_r = br.transpose(-1, -2)
    bt_i = -bi.transpose(-1, -2)
    return ar @ bt_r - ai @ bt_i, ar @ bt_i + ai @ bt_r


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
    return vr @ mt_r - vi @ mt_i, vr @ mt_i + vi @ mt_r
