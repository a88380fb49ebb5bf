"""Block-complex psi kernels for Hopper: the SDE sampler and the
forward-only NLL (port of the psi generation and eval half of
``audio_mps_tpu/ops/pallas_block.py``).

Layout (as in the JAX package): every complex operator is embedded as the
real block matrix ``Bk(M) = [[M_r, -M_i], [M_i, M_r]]`` acting on the
stacked state ``[x_r; x_i]`` (``[2D, cols]``), and the per-step frame
rotation is folded into the step constants, so one step is a few
``[2D,2D] @ [2D,cols]`` products plus column reductions.

Each kernel comes as a pair:

* ``*_plain``: the step loop in plain PyTorch. It is the CPU path and the
  version the CUDA kernel is held to on the card.
* the wrapper (``psi_sample_block``, ``psi_nll_block``): a CPU tensor goes
  to the plain version; a CUDA tensor launches the hand-written kernel from
  ``csrc/`` (built by ``ops/_build.py``) or raises. The wrapper counts its
  launches in ``.launches``.

Both take the kernel inputs that ``psi_sample_inputs`` / ``psi_nll_inputs``
build from the parameters, and both are forward-only (no autograd), as the
TPU kernels are.

Precision menu (``_make_dot_ops``; the TPU's ``pallas_block._make_dot_ops``):
``highest`` is fp32; ``high`` splits both operands into bf16 (hi, lo) and
sums ``hi*hi + hi*lo + lo*hi`` in fp32; ``default`` is one bf16 product
with an fp32 sum. The plain versions compute the bf16 products exactly in
fp32, as the kernels do.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import CMPSConfig
from ..models import core
from ..models.cell import make_constants
from . import _build

PRECISIONS = ("highest", "high", "default")


def block_embed(mr, mi):
    """Real [2D,2D] embedding of the complex matrix M = mr + i mi acting on
    stacked [xr; xi] columns."""
    top = torch.cat([mr, -mi], dim=1)
    bot = torch.cat([mi, mr], dim=1)
    return torch.cat([top, bot], dim=0)


def supports_block(cfg: CMPSConfig) -> bool:
    """The block layout's rule (D % 4 == 0), kept from the TPU dispatch."""
    return cfg.bond_dim % 4 == 0


def supports_block_sampler(cfg: CMPSConfig) -> bool:
    """The block sampler's rule (D % 8 == 0), kept from the TPU dispatch."""
    return cfg.bond_dim % 8 == 0


def _psi_block_constants(cc):
    """(Ab, Bb, Rb) with the conj(p) rotation folded in: C~ = C diag(conj p),
    R~ = R diag(conj p); Rb is the bare expectation operator."""
    pc, ps = cc.p_c, cc.p_s
    ctr = cc.Cr * pc[None, :] + cc.Ci * ps[None, :]
    cti = cc.Ci * pc[None, :] - cc.Cr * ps[None, :]
    rtr = cc.Rr * pc[None, :] + cc.Ri * ps[None, :]
    rti = cc.Ri * pc[None, :] - cc.Rr * ps[None, :]
    return (block_embed(ctr, cti), block_embed(rtr, rti),
            block_embed(cc.Rr, cc.Ri))


def _psi_block_t0(cc, pr0, pi0):
    """Stacked kernel-frame initial state t0 = p .* x0 ([2D, cols])."""
    pc, ps = cc.p_c[:, None], cc.p_s[:, None]
    t0r = pr0 * pc - pi0 * ps
    t0i = pi0 * pc + pr0 * ps
    return torch.cat([t0r, t0i], dim=0)


def _psi_t0_broadcast(params, cfg, cc, cols):
    pr0, pi0 = core.psi0(params, cfg)
    D = cfg.bond_dim
    return _psi_block_t0(cc, pr0[:, None].expand(D, cols),
                         pi0[:, None].expand(D, cols))


def _split_bf16(x):
    """Split an fp32 tensor into (hi, lo) bf16 halves with hi + lo == x to
    ~16 mantissa bits."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def _make_dot_ops(precision):
    """(prep, dotf) for the plain versions' products. prep() rounds or
    splits an operand once; dotf(a, b) is a @ b on prepped operands."""
    if precision == "high":
        def prep(x):
            hi, lo = _split_bf16(x)
            return hi.float(), lo.float()

        def dotf(a, b):
            ah, al = a
            bh, bl = b
            return ah @ bh + ah @ bl + al @ bh
        return prep, dotf
    if precision == "default":
        return (lambda x: x.to(torch.bfloat16).float()), torch.matmul
    if precision == "highest":
        return (lambda x: x), torch.matmul
    raise ValueError(f"precision must be one of {PRECISIONS}, got "
                     f"{precision!r}")


def _as_kernel_input(x):
    return x.detach().to(torch.float32).contiguous()


def _check_inputs(name, device, shapes: dict):
    for key, (x, shape) in shapes.items():
        if x.device != device:
            raise ValueError(f"{name}: {key} is on {x.device}, expected "
                             f"{device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous fp32")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if any(s >= 2 ** 31 for s in shape):
            raise ValueError(f"{name}: {key} has a dimension past the "
                             f"kernel's 32-bit sizes: {shape}")


def _check_smem(name, need: int, device, D: int):
    """Raise when the [2D,2D] constants do not fit one block's shared
    memory (streaming them is queued work)."""
    have = torch.cuda.get_device_properties(device) \
        .shared_memory_per_block_optin
    if need > have:
        raise NotImplementedError(
            f"{name} at D={D} needs {need} bytes of shared memory for its "
            f"[2D,2D] constants; the card allows {have} per block. Streaming "
            f"the constants is not ported yet (ROADMAP queue B)")


def _stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


# ===========================================================================
# Sampler (Euler–Maruyama SDE; reference model.py:242-251)
# ===========================================================================

def psi_sample_inputs(params, cfg: CMPSConfig, noise) -> dict:
    """Kernel inputs of ``psi_sample_block`` from parameters and noise
    [T, N] (the TPU's ``pallas_block.psi_sample_block`` preamble)."""
    if not supports_block_sampler(cfg):
        raise ValueError(
            f"block sampler requires bond_dim % 8 == 0, got {cfg.bond_dim}")
    with torch.no_grad():
        cc = make_constants(params, cfg)
        ab, bb, _ = _psi_block_constants(cc)
        t0 = _psi_t0_broadcast(params, cfg, cc, noise.shape[1])
        return dict(ab=_as_kernel_input(ab), bb=_as_kernel_input(bb),
                    pc=_as_kernel_input(cc.p_c), ps=_as_kernel_input(cc.p_s),
                    t0=_as_kernel_input(t0), noise=_as_kernel_input(noise),
                    inv_a=_as_kernel_input((1.0 / cc.A).reshape(1)),
                    dt=float(cfg.delta_t), norm_eps=float(cfg.norm_eps))


@torch.no_grad()
def psi_sample_block_plain(ab, bb, pc, ps, t0, noise, inv_a, *, dt: float,
                           norm_eps: float, precision: str = "highest"):
    """Running waveform [T, N] (the cumulative sum of the increments; the
    caller scales by A and transposes). Plain PyTorch, any device."""
    prep, dotf = _make_dot_ops(precision)
    D = pc.shape[0]
    abp, bbp = prep(ab), prep(bb)
    pc, ps = pc[:, None], ps[:, None]
    t = t0
    samp = torch.zeros_like(noise[:1])
    out = torch.empty_like(noise)
    for k in range(noise.shape[0]):
        tp = prep(t)
        ru = dotf(bbp, tp)                   # R x (reused below)
        rur, rui = ru[:D], ru[D:]
        wr = pc * rur - ps * rui             # w = p .* ru
        wi = pc * rui + ps * rur
        e = 2.0 * torch.sum(t[:D] * wr + t[D:] * wi, dim=0, keepdim=True)
        inc = e * dt + noise[k:k + 1]
        samp = samp + inc
        out[k:k + 1] = samp
        s = inc * inv_a
        y = dotf(abp, tp) + s * ru           # y = C x + (inc/A) R x
        n2 = torch.sum(y * y, dim=0, keepdim=True)
        t = y * torch.rsqrt(torch.clamp(n2, min=norm_eps))
    return out


@torch.no_grad()
def psi_sample_block(ab, bb, pc, ps, t0, noise, inv_a, *, dt: float,
                     norm_eps: float, precision: str = "highest"):
    """Running waveform [T, N]: ``psi_sample_block_plain`` for CPU tensors,
    the CUDA kernel ``csrc/psi_sample.cu`` for CUDA tensors."""
    if noise.device.type == "cpu":
        return psi_sample_block_plain(ab, bb, pc, ps, t0, noise, inv_a,
                                      dt=dt, norm_eps=norm_eps,
                                      precision=precision)
    if noise.device.type != "cuda":
        raise ValueError(f"psi_sample_block: no kernel for {noise.device}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    T, N = noise.shape
    D = pc.shape[0]
    _check_inputs("psi_sample_block", noise.device, dict(
        ab=(ab, (2 * D, 2 * D)), bb=(bb, (2 * D, 2 * D)), pc=(pc, (D,)),
        ps=(ps, (D,)), t0=(t0, (2 * D, N)), noise=(noise, (T, N)),
        inv_a=(inv_a, (1,))))
    lib = _build.library()
    _check_smem("psi_sample_block", lib.amt_psi_sample_smem_bytes(D),
                noise.device, D)
    wave = torch.empty_like(noise)
    if T == 0 or N == 0:
        return wave
    err = lib.amt_psi_sample(
        _ptr(ab), _ptr(bb), _ptr(pc), _ptr(ps), _ptr(t0), _ptr(noise),
        _ptr(inv_a), _ptr(wave), D, T, N, dt, norm_eps,
        PRECISIONS.index(precision), _stream_ptr(noise.device))
    _build.check(lib, err, "psi_sample_block")
    psi_sample_block.launches += 1
    return wave


psi_sample_block.launches = 0


# ===========================================================================
# Forward-only NLL (eval path)
# ===========================================================================

def psi_nll_inputs(params, cfg: CMPSConfig, signals) -> dict:
    """Kernel inputs of ``psi_nll_block`` from parameters and waveforms
    [B, T] (the TPU's ``pallas_block.psi_nll_block`` preamble)."""
    if not supports_block(cfg):
        raise ValueError(
            f"block layout requires bond_dim % 4 == 0, got {cfg.bond_dim}")
    with torch.no_grad():
        cc = make_constants(params, cfg)
        se = (signals[:, 1:] - signals[:, :-1]).T / cc.A      # [T-1, B]
        ab, bb, rb = _psi_block_constants(cc)
        t0 = _psi_t0_broadcast(params, cfg, cc, signals.shape[0])
        log_eps = cfg.log_eps if cfg.log_eps > 0 else float("-inf")
        return dict(ab=_as_kernel_input(ab), bb=_as_kernel_input(bb),
                    rb=_as_kernel_input(rb), t0=_as_kernel_input(t0),
                    se=_as_kernel_input(se), log_eps=float(log_eps),
                    norm_eps=float(cfg.norm_eps))


@torch.no_grad()
def psi_nll_block_plain(ab, bb, rb, t0, se, *, log_eps: float,
                        norm_eps: float, unroll: int = 16,
                        precision: str = "highest",
                        defer_norm: bool = False):
    """Per-example NLL [B] over the increments se [T-1, B] (already divided
    by A). ``defer_norm`` keeps the state unnormalised between
    renormalisations at every ``unroll``-th step, as the TPU kernel does at
    its block exits. Plain PyTorch, any device."""
    prep, dotf = _make_dot_ops(precision)
    abp, bbp, rbp = prep(ab), prep(bb), prep(rb)
    t = t0
    acc = torch.zeros_like(t0[:1])
    n2p = torch.ones_like(acc)
    for k in range(se.shape[0]):
        s = se[k:k + 1]
        tp = prep(t)
        bt = dotf(bbp, tp)                   # R~ t
        y = dotf(abp, tp) + s * bt           # y = C~ t + s R~ t
        ru = dotf(rbp, prep(y))              # R y (expectation)
        e = 2.0 * torch.sum(y * ru, dim=0, keepdim=True)
        n2 = torch.sum(y * y, dim=0, keepdim=True)
        if defer_norm:
            e = e / torch.clamp(n2p, min=norm_eps)
        acc = acc - torch.log(torch.clamp(1.0 + e * s, min=log_eps))
        if defer_norm and (k + 1) % unroll:
            t, n2p = y, n2
        else:
            t = y * torch.rsqrt(torch.clamp(n2, min=norm_eps))
            n2p = torch.ones_like(acc)
    return acc[0]


@torch.no_grad()
def psi_nll_block(ab, bb, rb, t0, se, *, log_eps: float, norm_eps: float,
                  unroll: int = 16, precision: str = "highest",
                  defer_norm: bool = False):
    """Per-example NLL [B]: ``psi_nll_block_plain`` for CPU tensors, the
    CUDA kernel ``csrc/psi_nll.cu`` for CUDA tensors."""
    if se.device.type == "cpu":
        return psi_nll_block_plain(ab, bb, rb, t0, se, log_eps=log_eps,
                                   norm_eps=norm_eps, unroll=unroll,
                                   precision=precision,
                                   defer_norm=defer_norm)
    if se.device.type != "cuda":
        raise ValueError(f"psi_nll_block: no kernel for {se.device}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    n_steps, B = se.shape
    D = t0.shape[0] // 2
    _check_inputs("psi_nll_block", se.device, dict(
        ab=(ab, (2 * D, 2 * D)), bb=(bb, (2 * D, 2 * D)),
        rb=(rb, (2 * D, 2 * D)), t0=(t0, (2 * D, B)), se=(se, (n_steps, B))))
    lib = _build.library()
    _check_smem("psi_nll_block", lib.amt_psi_nll_smem_bytes(D), se.device, D)
    loss = torch.empty((B,), dtype=torch.float32, device=se.device)
    if B == 0:
        return loss
    err = lib.amt_psi_nll(
        _ptr(ab), _ptr(bb), _ptr(rb), _ptr(t0), _ptr(se), _ptr(loss),
        D, n_steps, B, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm),
        _stream_ptr(se.device))
    _build.check(lib, err, "psi_nll_block")
    psi_nll_block.launches += 1
    return loss


psi_nll_block.launches = 0
