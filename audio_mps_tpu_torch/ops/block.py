"""Block-complex kernels for Hopper, psi and rho: the SDE samplers, the
forward-only NLLs and the training NLLs with their adjoints (port of
``audio_mps_tpu/ops/pallas_block.py``).

Layout (as in the JAX package): every complex operator is embedded as the
real block matrix ``Bk(M) = [[M_r, -M_i], [M_i, M_r]]`` acting on the
stacked state ``[x_r; x_i]`` (``[2D, cols]``), and the per-step frame
rotation is folded into the step constants, so one step is a few
``[2D,2D] @ [2D,cols]`` products plus column reductions.

Each kernel comes as a pair:

* ``*_plain``: the step loop in plain PyTorch. It is the CPU path and the
  version the CUDA kernel is held to on the card.
* the wrapper (``psi_sample_block``, ``psi_nll_block``, ``psi_train_fwd``,
  ``psi_train_fwd_ckpt``, ``psi_recompute``, ``psi_train_bwd``,
  ``psi_cotangents``, their ``rho_*`` counterparts, and psi's batched pair
  ``psi_batched_fwd`` / ``psi_batched_bwd``): a CPU tensor goes
  to the plain version; a CUDA tensor launches the hand-written kernel
  from ``csrc/`` (built by ``ops/_build.py``) or raises. The wrapper counts
  its launches in ``.launches``. ``psi_recompute_bwd`` /
  ``rho_recompute_bwd`` chain three of them over time segments, beside
  their own plain versions.

The samplers and the NLLs take the kernel inputs that ``*_sample_inputs``
/ ``*_nll_inputs`` build from the parameters, and are forward-only (no
autograd), as their TPU kernels are. The training functions sit under
``PsiBlockNLL`` / ``RhoBlockNLL``, ``torch.autograd.Function``s whose
inputs (``*_nll_block_trainable*``) are built with autograd, so the
cotangents flow on to the parameters.

Precision menu (``_make_dot_ops``; the TPU's ``pallas_block._make_dot_ops``):
``highest`` is fp32; ``high`` splits both operands into bf16 (hi, lo) and
sums ``hi*hi + hi*lo + lo*hi`` in fp32; ``default`` is one bf16 product
with an fp32 sum. The plain versions compute the bf16 products exactly in
fp32, as the kernels do.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..config import CMPSConfig
from ..models import core
from ..models.cell import make_constants
from . import _build
from .complexing import block_embed, fp32_products, matmul

PRECISIONS = ("highest", "high", "default")


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
    splits an operand once; dotf(a, b) is a @ b on prepped operands, in
    true fp32 whatever the process-global matmul setting (the bf16 parts'
    products are exact in fp32, as the kernels take them)."""
    if precision == "high":
        def prep(x):
            hi, lo = _split_bf16(x)
            return hi.float(), lo.float()

        def dotf(a, b):
            ah, al = a
            bh, bl = b
            with fp32_products():
                return ah @ bh + ah @ bl + al @ bh
        return prep, dotf
    if precision == "default":
        return (lambda x: x.to(torch.bfloat16).float()), matmul
    if precision == "highest":
        return (lambda x: x), matmul
    raise ValueError(f"precision must be one of {PRECISIONS}, got "
                     f"{precision!r}")


def _make_dot_ops_bwd(precision):
    """(prep, dotf, dotnt) for the plain adjoint and cotangents (the TPU's
    ``pallas_block._make_dot_ops_bwd``; its ``rec`` rebuilds values from the
    preps its recompute adjoint saves, where the port's recompute rebuilds
    the states themselves): ``dotnt(a, b)`` is a @ b.T on prepped
    operands, contracting their last axes, in true fp32 as ``dotf``."""
    prep, dotf = _make_dot_ops(precision)
    if precision == "high":
        def dotnt(a, b):
            ah, al = a
            bh, bl = b
            with fp32_products():
                return ah @ bh.T + ah @ bl.T + al @ bh.T
        return prep, dotf, dotnt
    return prep, dotf, (lambda a, b: matmul(a, b.T))


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


def _check_options(precision: str, unroll: int = 1):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")


def _cuda_or_raise(name, x):
    """True for a CPU tensor (the plain version runs), False for a CUDA one
    (the kernel launches); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    return False


def _smem_refusal(name, need: int, have: int, D: int):
    """The error of a kernel whose CTA needs ``need`` bytes of shared
    memory where a block may have ``have``."""
    return NotImplementedError(
        f"{name} at D={D} needs {need} bytes of shared memory for its "
        f"constants; the card allows {have} per block. Streaming "
        f"the constants is not ported yet (ROADMAP queue B)")


def _smem_optin(device) -> int:
    """The dynamic shared memory one block may opt into on ``device``."""
    return torch.cuda.get_device_properties(device) \
        .shared_memory_per_block_optin


def _check_smem(name, need: int, device, D: int):
    """Raise when a kernel's constants (with what else its CTA keeps) do not
    fit one block's shared memory (streaming them is queued work)."""
    have = _smem_optin(device)
    if need > have:
        raise _smem_refusal(name, need, have, D)


def _stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


# ===========================================================================
# psi's block forward and adjoint: G columns a CTA
# ===========================================================================

PSI_COLS = (1, 2, 4, 8)
# the dynamic shared memory one block may opt into on an H100
H100_SMEM_OPTIN = 232448
# psi's block forward and adjoint chain (csrc/psi_fwd.cuh, the quad layout)
PSI_QUAD_J = 34         # the most j of a row a thread holds (kQuadJ)
PSI_QUAD_PITCH = 36     # floats of a vector's quarter (kQuadPitch)
PSI_HIST_PITCH = 24     # floats of a history row (kHistPitch)
PSI_FWD_SLOTS = 18      # the forward's loss ring (kFwdSlots)
PSI_BWD_SLOTS = 32      # the chain's ds ring (kBwdSlots)
PSI_TAIL_COLS = 2       # columns a tail CTA (kTailCols)
PSI_TAIL_STEPS = 8      # steps of a tail chunk (kTailSteps)
PSI_TAIL_PITCH = 12     # floats of a tail chunk row (kTailPitch)
PSI_TAIL_TILES = 34     # the most 4-row tiles of a column (kTailTiles)


def psi_block_fits(D: int) -> bool:
    """Does the quad layout of psi's block forward and adjoint chain take
    bond dimension D: each thread's quarter of a row of Ab and Bb in at
    most ``PSI_QUAD_J`` registers (D <= 68; ``quad_fits``)."""
    return D >= 1 and (2 * D + 3) // 4 <= PSI_QUAD_J


def _quad(D: int) -> tuple:
    """(2D, rows, the limb's Rb^T pitch, warps) of the quad layout (its
    ``Quad``)."""
    n = 2 * D
    rows = -(-n // 8) * 8
    return n, rows, rows + 4, rows // 8


def psi_fwd_smem_bytes(D: int, G: int) -> int:
    """Dynamic shared memory of one CTA of ``csrc/psi_fwd.cuh`` (the NLL,
    the training forwards, the recompute) at G columns a CTA: Rb^T for the
    limb, and for each column it walks side by side (2 from G=2) the double
    buffer of its prepped t, the history of its y (raw, hi, lo), its loss
    ring and 32 partials (its ``fwd_smem_bytes``)."""
    n, _, rp, nw = _quad(D)
    side = 2 if G >= 2 else 1
    return 4 * (n * rp + side * (16 * PSI_QUAD_PITCH + 3 * n * PSI_HIST_PITCH
                                 + PSI_FWD_SLOTS * (2 * nw + 2) + 32))


def psi_tail_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one tail CTA of ``csrc/psi_train_bwd.cu``:
    Rb^T and Rb at a row pitch of the rows rounded up to 8 mod 32, and for
    each of its columns the chunk buffers (y raw, hi, lo; u hi, lo), the
    tiles' partials of ehat and the chunk's factors 2 dehat (its
    ``tail_smem_bytes``)."""
    n, rows, _, _ = _quad(D)
    pitch = rows + (8 - rows % 32) % 32
    return 4 * (2 * n * pitch + PSI_TAIL_COLS * (
        5 * n * PSI_TAIL_PITCH + PSI_TAIL_STEPS * PSI_TAIL_TILES
        + PSI_TAIL_STEPS))


def psi_bwd_smem_bytes(D: int, G: int) -> int:
    """Dynamic shared memory of the adjoint of ``csrc/psi_train_bwd.cu`` at
    G columns a chain CTA: the larger of a tail CTA's and a chain CTA's
    (for each column it walks side by side, 2 from G=2 and 4 from G=4: the
    double buffer of its prepped dy, its ds ring and 32 partials)."""
    _, _, _, nw = _quad(D)
    side = 4 if G >= 4 else (2 if G >= 2 else 1)
    chain = 4 * side * (16 * PSI_QUAD_PITCH + PSI_BWD_SLOTS * nw + 32)
    return max(psi_tail_smem_bytes(D), chain)


# the most columns a CTA the rule takes: the adjoint chain walks up to 4
# side by side (csrc/psi_train_bwd.cu chain_cols)
PSI_COLS_RULE_MAX = 4


def psi_columns_per_cta(B: int, D: int, n_sms: int,
                        smem_optin: int = H100_SMEM_OPTIN) -> int:
    """Columns a CTA G (1, 2 or 4) of psi's block forward and adjoint for
    B columns at bond dimension D on a card of ``n_sms`` SMs: 1 while the
    B CTAs of G = 1 fit one wave, one CTA an SM; past that the G of fewest
    waves, the smallest such, up to ``PSI_COLS_RULE_MAX``, among those at
    which both kernels' CTAs fit ``smem_optin`` (``psi_fwd_smem_bytes``,
    ``psi_bwd_smem_bytes``) at a D the quad layout takes
    (``psi_block_fits``; else 1, and the launch raises). A pure function
    of its arguments, as ``rank.partials_cluster`` is.

    Why: a CTA of the quad layout holds its quarters of Ab and Bb in
    registers (68 a thread at D=64, 512 threads), so one CTA fits an SM.
    The forward walks two of a CTA's columns side by side and takes the
    pairs in turn, the adjoint's chain walks up to 4 side by side (one
    column's barrier and shuffle latencies hide the others'); every column
    keeps G = 1's bits. Measured on an NVIDIA H100 80GB HBM3 at 700 W,
    D=64, B=1024, T=16384, highest (``tools/psi_columns_sweep.py``), at G
    = 1, 2, 4, 8: the checkpoint forward 112.17, 100.04, 100.07, 100.14
    ms, the streamed forward 118.99, 107.26, 107.20, 107.28, the segment
    recompute 104.59, 89.20, 90.49, 90.65, the adjoint (tail and chain)
    243.60, 212.89, 198.09, 197.02 and the whole recompute adjoint 405.14,
    361.10, 342.19, 342.82: the forward gains to 2 columns side by side,
    the chain to 4, and 8 in turn gives nothing more (G=8 stays a choice
    of ``cols_per_cta``)."""
    fits = [G for G in PSI_COLS
            if G <= PSI_COLS_RULE_MAX and psi_block_fits(D)
            and max(psi_fwd_smem_bytes(D, G),
                    psi_bwd_smem_bytes(D, G)) <= smem_optin] or [1]

    def waves(G):
        ctas = -(-B // G)
        return -(-ctas // n_sms)

    return min(fits, key=lambda G: (waves(G), G))


def _check_cols(cols_per_cta):
    if cols_per_cta is not None and cols_per_cta not in PSI_COLS:
        raise ValueError(f"cols_per_cta must be None or one of {PSI_COLS}, "
                         f"got {cols_per_cta!r}")


def _check_psi_block(name, D: int):
    """Raise for a bond dimension past the quad layout's registers."""
    if not psi_block_fits(D):
        raise NotImplementedError(
            f"{name} at D={D}: psi's block kernels hold a thread's quarter "
            f"of each row of Ab and Bb in {PSI_QUAD_J} registers (D <= 68); "
            f"streaming the constants is not ported yet (ROADMAP queue B)")


def _psi_cols(B: int, D: int, device, cols_per_cta, name="psi") -> int:
    """G of a psi block launch on ``device``: ``cols_per_cta``, or None for
    ``psi_columns_per_cta`` on the card's SMs and shared memory; raises
    past the quad layout's D."""
    _check_cols(cols_per_cta)
    _check_psi_block(name, D)
    if cols_per_cta is not None:
        return cols_per_cta
    props = torch.cuda.get_device_properties(device)
    return psi_columns_per_cta(B, D, props.multi_processor_count,
                               props.shared_memory_per_block_optin)


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
    caller scales by A and transposes). The expectation is taken on the
    current state with the p twist, then the state is updated with the
    realised increment / A and renormalised. The state is carried
    unnormalised, in the kernel's order: u_0 = t0 and u_{k+1} = y_k, the
    update before its renorm; step k forms a = Ab u_k and b = Bb u_k,
    applies c_k = rsqrt(max(sum(u_k^2), norm_eps)) (1 at step 0, where t0
    is taken as given) after its products, e_k = 2 c_k^2 E_k with E_k =
    sum_r b_r (pc u_r + ps u_{r+D}) + b_{r+D} (pc u_{r+D} - ps u_r) (the
    twist regrouped by the rows of b) and u_{k+1} = c_k (a + s_k b), the
    same recursion in exact arithmetic. Plain PyTorch, any device."""
    prep, dotf = _make_dot_ops(precision)
    D = pc.shape[0]
    abp, bbp = prep(ab), prep(bb)
    pc, ps = pc[:, None], ps[:, None]
    u = t0
    samp = torch.zeros_like(noise[:1])
    out = torch.empty_like(noise)
    for k in range(noise.shape[0]):
        up = prep(u)
        a, b = dotf(abp, up), dotf(bbp, up)
        ur, ui = u[:D], u[D:]
        E = torch.sum(b[:D] * (pc * ur + ps * ui)
                      + b[D:] * (pc * ui - ps * ur), dim=0, keepdim=True)
        c = (torch.rsqrt(torch.clamp(torch.sum(u * u, dim=0, keepdim=True),
                                     min=norm_eps))
             if k else torch.ones_like(E))
        inc = 2.0 * c * c * E * dt + noise[k:k + 1]
        samp = samp + inc
        out[k:k + 1] = samp
        u = c * (a + (inc * inv_a) * b)
    return out


PSI_SAMPLE_BODIES = ("quad", "row")


def psi_sample_body(D: int) -> str:
    """The body of ``csrc/psi_sample.cu`` at bond dimension D, mirrored from
    its ``psi_sample_quad``: "quad" (the quad layout of psi's block
    forward, a row's quarter of Ab and Bb in each thread's registers) where
    its CTA is at most 512 threads (D <= 64), else "row" (one thread a row,
    Ab^T and Bb^T in shared memory: D=72 and 80 of the sampler's
    D % 8 == 0). A pure function of D."""
    return ("quad" if psi_block_fits(D) and 4 * _quad(D)[1] <= 512
            else "row")


def psi_sample_smem_bytes(D: int, body: Optional[str] = None) -> int:
    """Dynamic shared memory of one sampler CTA (its ``psi_sample_words``):
    the parts of the step's two sums (2 x 16 float2), the step-parity
    buffers of the walk's vector (quad: 4 quarters of 2 x 36 floats; row:
    2 x 2D) and of the raw state [2][2D], and in the row body Ab^T and
    Bb^T."""
    n = 2 * D
    quad = (body or psi_sample_body(D)) == "quad"
    return 4 * (64 + (16 * PSI_QUAD_PITCH if quad else 4 * n) + 2 * n
                + (0 if quad else 2 * n * n))


@torch.no_grad()
def psi_sample_block(ab, bb, pc, ps, t0, noise, inv_a, *, dt: float,
                     norm_eps: float, precision: str = "highest",
                     _body: Optional[str] = None):
    """Running waveform [T, N]: ``psi_sample_block_plain`` for CPU tensors,
    the CUDA kernel ``csrc/psi_sample.cu`` for CUDA tensors, in the body of
    ``psi_sample_body`` (``_body`` forces one; the last launch's in
    ``.body``). Raises NotImplementedError where the row body's constants
    pass one block's shared memory (D > 80)."""
    if _cuda_or_raise("psi_sample_block", noise):
        return psi_sample_block_plain(ab, bb, pc, ps, t0, noise, inv_a,
                                      dt=dt, norm_eps=norm_eps,
                                      precision=precision)
    _check_options(precision)
    T, N = noise.shape
    D = pc.shape[0]
    body = _body or psi_sample_body(D)
    if body not in PSI_SAMPLE_BODIES:
        raise ValueError(f"psi_sample_block: body {body!r}")
    if body == "quad" and psi_sample_body(D) != "quad":
        raise ValueError(f"psi_sample_block: the quad body does not take "
                         f"D={D}")
    _check_inputs("psi_sample_block", noise.device, dict(
        ab=(ab, (2 * D, 2 * D)), bb=(bb, (2 * D, 2 * D)), pc=(pc, (D,)),
        ps=(ps, (D,)), t0=(t0, (2 * D, N)), noise=(noise, (T, N)),
        inv_a=(inv_a, (1,))))
    lib = _build.library()
    _check_smem("psi_sample_block", psi_sample_smem_bytes(D, body),
                noise.device, D)
    wave = torch.empty_like(noise)
    if T == 0 or N == 0:
        return wave
    err = lib.amt_psi_sample(
        _ptr(ab), _ptr(bb), _ptr(pc), _ptr(ps), _ptr(t0), _ptr(noise),
        _ptr(inv_a), _ptr(wave), D, T, N, dt, norm_eps,
        PRECISIONS.index(precision), int(body == "quad"),
        _stream_ptr(noise.device))
    _build.check(lib, err, "psi_sample_block")
    psi_sample_block.launches += 1
    psi_sample_block.body = body
    return wave


psi_sample_block.launches = 0
psi_sample_block.body = None


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


def _renorms(k: int, unroll: int, defer_norm: bool) -> bool:
    """Does step k renormalise its output state? Every step with per-step
    norm; every ``unroll``-th with the deferred norm (the TPU's block
    exits)."""
    return not defer_norm or (k + 1) % unroll == 0


def _psi_chain_plain(ab, bb, rb, t0, se, *, log_eps, norm_eps, unroll,
                     precision, defer_norm, on_step=None, ck=None):
    """The forward step loop shared by the NLL, the training forwards and
    the recompute: per-example NLL [B]; ``on_step(k, y, n2)`` sees each
    post-step state y_k [2D, B] and its squared norm [1, B]; ``ck[j]``
    receives the state entering step j * unroll (the block checkpoints)."""
    prep, dotf = _make_dot_ops(precision)
    abp, bbp, rbp = prep(ab), prep(bb), prep(rb)
    t = t0
    acc = torch.zeros_like(t0[:1])
    n2p = torch.ones_like(acc)
    for k in range(se.shape[0]):
        if ck is not None and k % unroll == 0:
            ck[k // unroll] = t
        s = se[k:k + 1]
        tp = prep(t)
        bt = dotf(bbp, tp)                   # R~ t
        y = dotf(abp, tp) + s * bt           # y = C~ t + s R~ t
        ru = dotf(rbp, prep(y))              # R y (expectation)
        e = 2.0 * torch.sum(y * ru, dim=0, keepdim=True)
        n2 = torch.sum(y * y, dim=0, keepdim=True)
        if on_step is not None:
            on_step(k, y, n2)
        if defer_norm:
            e = e / torch.clamp(n2p, min=norm_eps)
        acc = acc - torch.log(torch.clamp(1.0 + e * s, min=log_eps))
        if _renorms(k, unroll, defer_norm):
            t = y * torch.rsqrt(torch.clamp(n2, min=norm_eps))
            n2p = torch.ones_like(acc)
        else:
            t, n2p = y, n2
    return acc[0]


@torch.no_grad()
def psi_nll_block_plain(ab, bb, rb, t0, se, *, log_eps: float,
                        norm_eps: float, unroll: int = 16,
                        precision: str = "highest",
                        defer_norm: bool = False):
    """Per-example NLL [B] over the increments se [T-1, B] (already divided
    by A). ``defer_norm`` keeps the state unnormalised between
    renormalisations at every ``unroll``-th step, as the TPU kernel does at
    its block exits. Plain PyTorch, any device."""
    return _psi_chain_plain(ab, bb, rb, t0, se, log_eps=log_eps,
                            norm_eps=norm_eps, unroll=unroll,
                            precision=precision, defer_norm=defer_norm)


@torch.no_grad()
def psi_nll_block(ab, bb, rb, t0, se, *, log_eps: float, norm_eps: float,
                  unroll: int = 16, precision: str = "highest",
                  defer_norm: bool = False, cols_per_cta=None):
    """Per-example NLL [B]: ``psi_nll_block_plain`` for CPU tensors, the
    CUDA kernel ``csrc/psi_nll.cu`` for CUDA tensors, ``cols_per_cta``
    columns a CTA (None: ``psi_columns_per_cta``; every G gives the same
    bits)."""
    if _cuda_or_raise("psi_nll_block", se):
        _check_cols(cols_per_cta)
        return psi_nll_block_plain(ab, bb, rb, t0, se, log_eps=log_eps,
                                   norm_eps=norm_eps, unroll=unroll,
                                   precision=precision,
                                   defer_norm=defer_norm)
    _check_options(precision, unroll)
    n_steps, B = se.shape
    D = t0.shape[0] // 2
    _check_inputs("psi_nll_block", se.device, dict(
        ab=(ab, (2 * D, 2 * D)), bb=(bb, (2 * D, 2 * D)),
        rb=(rb, (2 * D, 2 * D)), t0=(t0, (2 * D, B)), se=(se, (n_steps, B))))
    G = _psi_cols(B, D, se.device, cols_per_cta, "psi_nll_block")
    lib = _build.library()
    _check_smem("psi_nll_block", lib.amt_psi_nll_smem_bytes(D, G), se.device,
                D)
    loss = torch.empty((B,), dtype=torch.float32, device=se.device)
    if B == 0:
        return loss
    err = lib.amt_psi_nll(
        _ptr(ab), _ptr(bb), _ptr(rb), _ptr(t0), _ptr(se), _ptr(loss),
        D, n_steps, B, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), G,
        _stream_ptr(se.device))
    _build.check(lib, err, "psi_nll_block")
    psi_nll_block.launches += 1
    psi_nll_block.cols_per_cta = G
    return loss


psi_nll_block.launches = 0
psi_nll_block.cols_per_cta = None


# ===========================================================================
# Training: streamed-states forward, adjoint chain, cotangent reduction, and
# the recompute adjoint
# ===========================================================================
#
# The TPU's training pair (pallas_block._make_psi_fwd_kernel_stream and
# _make_psi_bwd_kernel_stream) is three functions here: the forward streams
# every post-step state y_k and its squared norm; the adjoint runs the serial
# reverse chain over them and emits dse, dt0 and, per step, dy_k and dehat_k;
# a third function reduces those streams to the [2D,2D] cotangents dAb, dBb,
# dRb. Every step's input state t_k is rebuilt from the streams as
# y_{k-1} * scale_{k-1} (t_0 = t0), with the forward's own operations, so it
# is the forward's state bit for bit. The same three also serve the per-step
# norm (defer_norm=False), whose TPU pair is _make_psi_fwd_kernel and
# _make_psi_bwd_kernel.
#
# Without the stream (kernel_stream="off", or "auto" when the stream does
# not fit; the TPU's _make_psi_fwd_kernel with _make_psi_bwd_kernel_defer
# :621 or _make_psi_bwd_kernel :529) the forward keeps only the block-entry
# checkpoints ck [n_blocks, 2D, B] (psi_train_fwd_ckpt). The recompute
# adjoint (psi_recompute_bwd) then runs time segments of whole blocks, last
# first: psi_recompute rebuilds a segment's ys and n2s from its checkpoints,
# every block at once, bit for bit the streamed forward's; the adjoint and
# the reduction above run over the segment, the adjoint carrying dt in from
# the next segment (dtfin), and the host adds the segments' cotangents in a
# fixed order. The card holds ck and one segment's ys and dy.


def _state_scales(n2s, *, norm_eps, unroll, defer_norm):
    """[n_steps, B]: the factor that takes y_k to the next input state
    t_{k+1}, rsqrt(max(n2_k, eps)) on a renormalising step and 1 elsewhere."""
    inv = torch.rsqrt(torch.clamp(n2s, min=norm_eps))
    if not defer_norm:
        return inv
    k = torch.arange(n2s.shape[0], device=n2s.device)
    return torch.where(((k + 1) % unroll == 0)[:, None], inv,
                       torch.ones_like(inv))


def _input_states(t0, ys, scales):
    """t_k for every step [n_steps, 2D, B]: t0, then y_{k-1} scale_{k-1}."""
    ts = torch.cat([t0[None], ys[:-1] * scales[:-1, None, :]], dim=0)
    return ts[:ys.shape[0]]


@torch.no_grad()
def psi_train_fwd_plain(ab, bb, rb, t0, se, *, log_eps: float,
                        norm_eps: float, unroll: int = 16,
                        precision: str = "highest",
                        defer_norm: bool = False):
    """(loss [B], ys [n_steps, 2D, B], n2s [n_steps, B]): the NLL of
    ``psi_nll_block_plain`` plus every post-step state y_k and |y_k|^2.
    Plain PyTorch, any device."""
    n_steps, B = se.shape
    ys = se.new_empty((n_steps, t0.shape[0], B))
    n2s = se.new_empty((n_steps, B))

    def keep(k, y, n2):
        ys[k] = y
        n2s[k] = n2[0]

    loss = _psi_chain_plain(ab, bb, rb, t0, se, log_eps=log_eps,
                            norm_eps=norm_eps, unroll=unroll,
                            precision=precision, defer_norm=defer_norm,
                            on_step=keep)
    return loss, ys, n2s


def n_blocks(n_steps: int, unroll: int) -> int:
    """Blocks of ``unroll`` steps over ``n_steps`` (the last may be
    shorter): the checkpoints of the recompute path."""
    return -(-n_steps // unroll)


@torch.no_grad()
def psi_train_fwd_ckpt_plain(ab, bb, rb, t0, se, *, log_eps: float,
                             norm_eps: float, unroll: int = 16,
                             precision: str = "highest",
                             defer_norm: bool = False):
    """(loss [B], ck [n_blocks, 2D, B]): the NLL of ``psi_nll_block_plain``
    and the state entering every block of ``unroll`` steps, after the
    previous block's exit renorm (the TPU forward's checkpoints,
    ``pallas_block.py:477``). Plain PyTorch, any device."""
    ck = se.new_empty((n_blocks(se.shape[0], unroll),) + tuple(t0.shape))
    loss = _psi_chain_plain(ab, bb, rb, t0, se, log_eps=log_eps,
                            norm_eps=norm_eps, unroll=unroll,
                            precision=precision, defer_norm=defer_norm,
                            ck=ck)
    return loss, ck


@torch.no_grad()
def psi_recompute_plain(ab, bb, rb, ck, se, *, norm_eps: float,
                        unroll: int = 16, precision: str = "highest",
                        defer_norm: bool = False):
    """(ys [n_steps, 2D, B], n2s [n_steps, B]) of a time segment that
    starts at a block entry, every block re-run from its checkpoint ck[j]
    as the forward runs it: what ``psi_train_fwd_plain`` streams over those
    steps. Plain PyTorch, any device."""
    n_steps, B = se.shape
    ys = se.new_empty((n_steps, ck.shape[1], B))
    n2s = se.new_empty((n_steps, B))
    for j in range(n_blocks(n_steps, unroll)):
        k0 = j * unroll

        def keep(k, y, n2):
            ys[k0 + k] = y
            n2s[k0 + k] = n2[0]

        _psi_chain_plain(ab, bb, rb, ck[j], se[k0:k0 + unroll],
                         log_eps=float("-inf"), norm_eps=norm_eps,
                         unroll=unroll, precision=precision,
                         defer_norm=defer_norm, on_step=keep)
    return ys, n2s


@torch.no_grad()
def psi_train_bwd_plain(ab, bb, rb, t0, se, g, ys, n2s, *, log_eps: float,
                        norm_eps: float, unroll: int = 16,
                        precision: str = "highest",
                        defer_norm: bool = False, dtfin=None):
    """Adjoint of ``psi_train_fwd`` for the loss cotangent g [B] and dtfin
    [2D, B], the cotangent of the state after the last step (zero when
    None): (dse [n_steps, B], dt0 [2D, B], dy [n_steps, 2D, B],
    dehat [n_steps, B]).

    The chain-independent work is batched over all steps, as the TPU
    kernel batches it over a block (``RU``, the e/arg/dn2 tail, ``dru`` and
    its ``Rb^T`` product); the loop is the serial chain
    dt <- Ab^T dy + s (Bb^T dy). The dn2 bookkeeping is the TPU's: the dn2
    used at step k is step k+1's dn2_new, a renormalising step seeds its own
    from dt, and a block's first step drops its dn2_new. Plain PyTorch, any
    device."""
    prep, dotf, _ = _make_dot_ops_bwd(precision)
    n_steps = se.shape[0]
    k = torch.arange(n_steps, device=se.device)[:, None]
    # e divides by |y_{k-1}|^2 inside a deferred block, else by 1 (exactly)
    inside = (k % unroll != 0) if defer_norm else torch.zeros_like(k).bool()
    n2prev = torch.cat([torch.ones_like(n2s[:1]), n2s[:-1]])
    n2p = torch.where(inside, n2prev, torch.ones_like(n2prev))
    n2p_c = torch.clamp(n2p, min=norm_eps)
    RU = dotf(prep(rb), prep(ys))                       # Rb y, every step
    ehat = 2.0 * torch.sum(ys * RU, dim=1)
    e = ehat / n2p_c
    arg = torch.clamp(1.0 + e * se, min=log_eps)
    darg = torch.where(arg > log_eps, -g / arg, torch.zeros_like(arg))
    de = darg * se
    ds0 = darg * e
    dehat = de / n2p_c
    dn2_new = torch.where(n2p > norm_eps, -de * e / n2p_c,
                          torch.zeros_like(de))
    RTD = dotf(prep(rb.T), prep((2.0 * dehat)[:, None, :] * ys))
    ts = _input_states(t0, ys, _state_scales(
        n2s, norm_eps=norm_eps, unroll=unroll, defer_norm=defer_norm))

    abT, bbT = prep(ab.T), prep(bb.T)
    dt = torch.zeros_like(t0) if dtfin is None else dtfin
    dn2n = torch.zeros_like(g)
    dy_all = torch.empty_like(ys)
    dse = torch.empty_like(se)
    for k in reversed(range(n_steps)):
        y = ys[k]
        if _renorms(k, unroll, defer_norm):
            inv = torch.rsqrt(torch.clamp(n2s[k], min=norm_eps))
            dinv = torch.sum(dt * y, dim=0)
            dn2 = torch.where(n2s[k] > norm_eps,
                              -0.5 * dinv * inv * inv * inv,
                              torch.zeros_like(dinv))
            dt = dt * inv
        else:
            dn2 = dn2n
        dy = dt + ((y * (2.0 * dn2) + RU[k] * (2.0 * dehat[k])) + RTD[k])
        dy_all[k] = dy
        pdy = prep(dy)
        du = dotf(bbT, pdy)                             # Bb^T dy
        dse[k] = ds0[k] + torch.sum(du * ts[k], dim=0)
        dt = dotf(abT, pdy) + se[k] * du
        dn2n = dn2_new[k]
    return dse, dt, dy_all, dehat


@torch.no_grad()
def psi_train_bwd_tail_plain(rb, se, g, ys, n2s, *, log_eps: float,
                             norm_eps: float, unroll: int = 16,
                             precision: str = "highest",
                             defer_norm: bool = False):
    """The chain-free part of ``psi_train_bwd_plain``, over all steps at
    once: (q [n_steps, 2D, B], ds0 [n_steps, B], dehat [n_steps, B],
    dn2_new [n_steps, B]) with q = Rb y (2 dehat) + Rb^T (2 dehat y) the
    e-path cotangent of y_k, ds0 = darg e the increment's cotangent
    through the loss term, and dn2_new the cotangent of |y_{k-1}|^2 that
    step k-1 of the chain takes inside a deferred block. Plain PyTorch,
    any device."""
    prep, dotf, _ = _make_dot_ops_bwd(precision)
    n_steps = se.shape[0]
    k = torch.arange(n_steps, device=se.device)[:, None]
    # e divides by |y_{k-1}|^2 inside a deferred block, else by 1 (exactly)
    inside = (k % unroll != 0) if defer_norm else torch.zeros_like(k).bool()
    n2prev = torch.cat([torch.ones_like(n2s[:1]), n2s[:-1]])
    n2p = torch.where(inside, n2prev, torch.ones_like(n2prev))
    n2p_c = torch.clamp(n2p, min=norm_eps)
    RU = dotf(prep(rb), prep(ys))                       # Rb y, every step
    ehat = 2.0 * torch.sum(ys * RU, dim=1)
    e = ehat / n2p_c
    arg = torch.clamp(1.0 + e * se, min=log_eps)
    darg = torch.where(arg > log_eps, -g / arg, torch.zeros_like(arg))
    de = darg * se
    dehat = de / n2p_c
    dn2_new = torch.where(n2p > norm_eps, -de * e / n2p_c,
                          torch.zeros_like(de))
    dh2 = (2.0 * dehat)[:, None, :]
    q = RU * dh2 + dotf(prep(rb.T), prep(dh2 * ys))
    return q, darg * e, dehat, dn2_new


@torch.no_grad()
def psi_train_bwd_chain_plain(ab, bb, t0, se, ys, n2s, q, ds0, dn2_new, *,
                              norm_eps: float, unroll: int = 16,
                              precision: str = "highest",
                              defer_norm: bool = False, dtfin=None):
    """The serial part of ``psi_train_bwd_plain`` on the tail's outputs
    (``psi_train_bwd_tail_plain``): (dse, dt0, dy) from the reverse chain
    dy_k = dt' + (2 dn2 y_k + q_k), dt <- Ab^T dy + s (Bb^T dy), dse_k =
    ds0_k + sum((Bb^T dy) .* t_k), where a renormalising step takes dn2
    from dt (and dt' = dt inv) and any other step takes step k+1's
    dn2_new. Plain PyTorch, any device."""
    prep, dotf, _ = _make_dot_ops_bwd(precision)
    n_steps = se.shape[0]
    ts = _input_states(t0, ys, _state_scales(
        n2s, norm_eps=norm_eps, unroll=unroll, defer_norm=defer_norm))
    abT, bbT = prep(ab.T), prep(bb.T)
    dt = torch.zeros_like(t0) if dtfin is None else dtfin
    dn2n = torch.zeros_like(se[0])
    dy_all = torch.empty_like(ys)
    dse = torch.empty_like(se)
    for k in reversed(range(n_steps)):
        y = ys[k]
        if _renorms(k, unroll, defer_norm):
            inv = torch.rsqrt(torch.clamp(n2s[k], min=norm_eps))
            dinv = torch.sum(dt * y, dim=0)
            dn2 = torch.where(n2s[k] > norm_eps,
                              -0.5 * dinv * inv * inv * inv,
                              torch.zeros_like(dinv))
            dt = dt * inv
        else:
            dn2 = dn2n
        dy = dt + (y * (2.0 * dn2) + q[k])
        dy_all[k] = dy
        pdy = prep(dy)
        du = dotf(bbT, pdy)                             # Bb^T dy
        dse[k] = ds0[k] + torch.sum(du * ts[k], dim=0)
        dt = dotf(abT, pdy) + se[k] * du
        dn2n = dn2_new[k]
    return dse, dt, dy_all


@torch.no_grad()
def psi_cotangents_plain(dy, ys, t0, se, n2s, dehat, *, norm_eps: float,
                         unroll: int = 16, precision: str = "highest",
                         defer_norm: bool = False):
    """(dAb, dBb, dRb) [2D, 2D]: sum over steps k and columns of dy t^T,
    dy (s t)^T and dru y^T, dru = 2 dehat y, from the streams of
    ``psi_train_fwd`` and ``psi_train_bwd``. Plain PyTorch, any device."""
    prep, _, dotnt = _make_dot_ops_bwd(precision)
    n = t0.shape[0]

    def lanes(x):                                       # [2D, n_steps * B]
        return x.transpose(0, 1).reshape(n, -1)

    ts = _input_states(t0, ys, _state_scales(
        n2s, norm_eps=norm_eps, unroll=unroll, defer_norm=defer_norm))
    pdy = prep(lanes(dy))
    dab = dotnt(pdy, prep(lanes(ts)))
    dbb = dotnt(pdy, prep(lanes(se[:, None, :] * ts)))
    drb = dotnt(prep(lanes((2.0 * dehat)[:, None, :] * ys)), prep(lanes(ys)))
    return dab, dbb, drb


@torch.no_grad()
def psi_train_fwd(ab, bb, rb, t0, se, *, log_eps: float, norm_eps: float,
                  unroll: int = 16, precision: str = "highest",
                  defer_norm: bool = False, cols_per_cta=None):
    """(loss [B], ys, n2s): ``psi_train_fwd_plain`` for CPU tensors, the
    CUDA kernel ``csrc/psi_train_fwd.cu`` for CUDA tensors, ``cols_per_cta``
    columns a CTA (None: ``psi_columns_per_cta``)."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("psi_train_fwd", se):
        _check_cols(cols_per_cta)
        return psi_train_fwd_plain(ab, bb, rb, t0, se, **kw)
    _check_options(precision, unroll)
    n_steps, B = se.shape
    D = t0.shape[0] // 2
    n = 2 * D
    _check_inputs("psi_train_fwd", se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), rb=(rb, (n, n)), t0=(t0, (n, B)),
        se=(se, (n_steps, B))))
    G = _psi_cols(B, D, se.device, cols_per_cta, "psi_train_fwd")
    lib = _build.library()
    _check_smem("psi_train_fwd", lib.amt_psi_train_fwd_smem_bytes(D, G),
                se.device, D)
    loss = se.new_empty((B,))
    ys = se.new_empty((n_steps, n, B))
    n2s = se.new_empty((n_steps, B))
    if B == 0:
        return loss, ys, n2s
    err = lib.amt_psi_train_fwd(
        _ptr(ab), _ptr(bb), _ptr(rb), _ptr(t0), _ptr(se), _ptr(loss),
        _ptr(ys), _ptr(n2s), D, n_steps, B, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), G,
        _stream_ptr(se.device))
    _build.check(lib, err, "psi_train_fwd")
    psi_train_fwd.launches += 1
    psi_train_fwd.cols_per_cta = G
    return loss, ys, n2s


psi_train_fwd.launches = 0
psi_train_fwd.cols_per_cta = None


@torch.no_grad()
def psi_train_fwd_ckpt(ab, bb, rb, t0, se, *, log_eps: float,
                       norm_eps: float, unroll: int = 16,
                       precision: str = "highest", defer_norm: bool = False,
                       cols_per_cta=None):
    """(loss [B], ck): ``psi_train_fwd_ckpt_plain`` for CPU tensors, the
    CUDA kernel ``csrc/psi_train_fwd.cu`` (its checkpoint mode) for CUDA
    tensors, ``cols_per_cta`` columns a CTA (None:
    ``psi_columns_per_cta``)."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("psi_train_fwd_ckpt", se):
        _check_cols(cols_per_cta)
        return psi_train_fwd_ckpt_plain(ab, bb, rb, t0, se, **kw)
    _check_options(precision, unroll)
    n_steps, B = se.shape
    D = t0.shape[0] // 2
    n = 2 * D
    _check_inputs("psi_train_fwd_ckpt", se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), rb=(rb, (n, n)), t0=(t0, (n, B)),
        se=(se, (n_steps, B))))
    G = _psi_cols(B, D, se.device, cols_per_cta, "psi_train_fwd_ckpt")
    lib = _build.library()
    _check_smem("psi_train_fwd_ckpt",
                lib.amt_psi_train_fwd_smem_bytes(D, G), se.device, D)
    loss = se.new_empty((B,))
    ck = se.new_empty((n_blocks(n_steps, unroll), n, B))
    if B == 0:
        return loss, ck
    err = lib.amt_psi_train_fwd_ckpt(
        _ptr(ab), _ptr(bb), _ptr(rb), _ptr(t0), _ptr(se), _ptr(loss),
        _ptr(ck), D, n_steps, B, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), G,
        _stream_ptr(se.device))
    _build.check(lib, err, "psi_train_fwd_ckpt")
    psi_train_fwd_ckpt.launches += 1
    psi_train_fwd_ckpt.cols_per_cta = G
    return loss, ck


psi_train_fwd_ckpt.launches = 0
psi_train_fwd_ckpt.cols_per_cta = None


def psi_recompute_blocks(cols: int, blocks: int, n_sms: int) -> int:
    """Blocks a CTA of ``csrc/psi_recompute.cu`` re-runs: its load of the
    constants costs about a block's steps, so as many as keep at least four
    CTAs an SM over the segment's ``cols`` x ``blocks`` (one CTA fits an
    SM), at least one and at most the segment."""
    return max(1, min(blocks, cols * blocks // (4 * n_sms)))


@torch.no_grad()
def psi_recompute(ab, bb, rb, ck, se, *, norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False,
                  cols_per_cta=None):
    """(ys, n2s) of a segment: ``psi_recompute_plain`` for CPU tensors, the
    CUDA kernel ``csrc/psi_recompute.cu`` for CUDA tensors, a CTA
    ``cols_per_cta`` columns (None: ``psi_columns_per_cta``) and a span of
    ``psi_recompute_blocks`` blocks."""
    kw = dict(norm_eps=norm_eps, unroll=unroll, precision=precision,
              defer_norm=defer_norm)
    if _cuda_or_raise("psi_recompute", se):
        _check_cols(cols_per_cta)
        return psi_recompute_plain(ab, bb, rb, ck, se, **kw)
    _check_options(precision, unroll)
    n_steps, B = se.shape
    D = ck.shape[1] // 2
    n = 2 * D
    _check_inputs("psi_recompute", se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), rb=(rb, (n, n)),
        ck=(ck, (n_blocks(n_steps, unroll), n, B)), se=(se, (n_steps, B))))
    G = _psi_cols(B, D, se.device, cols_per_cta, "psi_recompute")
    lib = _build.library()
    _check_smem("psi_recompute", lib.amt_psi_train_fwd_smem_bytes(D, G),
                se.device, D)
    ys = se.new_empty((n_steps, n, B))
    n2s = se.new_empty((n_steps, B))
    if B == 0 or n_steps == 0:
        return ys, n2s
    span = psi_recompute_blocks(
        -(-B // G), ck.shape[0],
        torch.cuda.get_device_properties(se.device).multi_processor_count)
    err = lib.amt_psi_recompute(
        _ptr(ab), _ptr(bb), _ptr(rb), _ptr(ck), _ptr(se), _ptr(ys),
        _ptr(n2s), D, n_steps, B, unroll, span, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), G,
        _stream_ptr(se.device))
    _build.check(lib, err, "psi_recompute")
    psi_recompute.launches += 1
    psi_recompute.cols_per_cta = G
    return ys, n2s


psi_recompute.launches = 0
psi_recompute.cols_per_cta = None


@torch.no_grad()
def psi_train_bwd_tail(rb, se, g, ys, n2s, *, log_eps: float,
                       norm_eps: float, unroll: int = 16,
                       precision: str = "highest",
                       defer_norm: bool = False):
    """(q, ds0, dehat, dn2_new): ``psi_train_bwd_tail_plain`` for CPU
    tensors; for CUDA tensors the tail kernel of ``csrc/psi_train_bwd.cu``
    alone (``psi_train_bwd`` launches it before its chain, and counts its
    launches here too)."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("psi_train_bwd_tail", se):
        return psi_train_bwd_tail_plain(rb, se, g, ys, n2s, **kw)
    _check_options(precision, unroll)
    n_steps, B = se.shape
    n = rb.shape[0]
    D = n // 2
    _check_inputs("psi_train_bwd_tail", se.device, dict(
        rb=(rb, (n, n)), se=(se, (n_steps, B)), g=(g, (B,)),
        ys=(ys, (n_steps, n, B)), n2s=(n2s, (n_steps, B))))
    _check_psi_block("psi_train_bwd_tail", D)
    lib = _build.library()
    _check_smem("psi_train_bwd_tail",
                lib.amt_psi_train_bwd_tail_smem_bytes(D), se.device, D)
    q = torch.empty_like(ys)
    ds0 = torch.empty_like(se)
    dehat = torch.empty_like(se)
    dn2_new = torch.empty_like(se)
    if B == 0 or n_steps == 0:
        return q, ds0, dehat, dn2_new
    err = lib.amt_psi_train_bwd_tail(
        _ptr(rb), _ptr(se), _ptr(g), _ptr(ys), _ptr(n2s), _ptr(ds0),
        _ptr(q), _ptr(dehat), _ptr(dn2_new), D, n_steps, B, unroll, log_eps,
        norm_eps, PRECISIONS.index(precision), int(defer_norm),
        _stream_ptr(se.device))
    _build.check(lib, err, "psi_train_bwd_tail")
    psi_train_bwd_tail.launches += 1
    return q, ds0, dehat, dn2_new


psi_train_bwd_tail.launches = 0


@torch.no_grad()
def psi_train_bwd(ab, bb, rb, t0, se, g, ys, n2s, *, log_eps: float,
                  norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False,
                  dtfin=None, cols_per_cta=None):
    """(dse, dt0, dy, dehat): ``psi_train_bwd_plain`` for CPU tensors; for
    CUDA tensors the two kernels of ``csrc/psi_train_bwd.cu`` in one call,
    the tail over all (step, column) pairs (counted in
    ``psi_train_bwd_tail.launches``), then the chain at ``cols_per_cta``
    columns a CTA (None: ``psi_columns_per_cta``)."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm, dtfin=dtfin)
    if _cuda_or_raise("psi_train_bwd", se):
        _check_cols(cols_per_cta)
        return psi_train_bwd_plain(ab, bb, rb, t0, se, g, ys, n2s, **kw)
    _check_options(precision, unroll)
    n_steps, B = se.shape
    D = t0.shape[0] // 2
    n = 2 * D
    _check_inputs("psi_train_bwd", se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), rb=(rb, (n, n)), t0=(t0, (n, B)),
        se=(se, (n_steps, B)), g=(g, (B,)), ys=(ys, (n_steps, n, B)),
        n2s=(n2s, (n_steps, B))))
    if dtfin is not None:
        _check_inputs("psi_train_bwd", se.device,
                      dict(dtfin=(dtfin, (n, B))))
    G = _psi_cols(B, D, se.device, cols_per_cta, "psi_train_bwd")
    lib = _build.library()
    _check_smem("psi_train_bwd", lib.amt_psi_train_bwd_smem_bytes(D, G),
                se.device, D)
    dse = torch.empty_like(se)
    dt0 = torch.empty_like(t0)
    dy = torch.empty_like(ys)
    dehat = torch.empty_like(se)
    dn2_new = torch.empty_like(se)    # the tail's, for the chain
    if B == 0:
        return dse, dt0, dy, dehat
    err = lib.amt_psi_train_bwd(
        _ptr(ab), _ptr(bb), _ptr(rb), _ptr(t0), _ptr(se), _ptr(g), _ptr(ys),
        _ptr(n2s), None if dtfin is None else _ptr(dtfin), _ptr(dse),
        _ptr(dt0), _ptr(dy), _ptr(dehat), _ptr(dn2_new), D, n_steps, B,
        unroll, log_eps, norm_eps, PRECISIONS.index(precision),
        int(defer_norm), G, _stream_ptr(se.device))
    _build.check(lib, err, "psi_train_bwd")
    psi_train_bwd.launches += 1
    if n_steps > 0:
        psi_train_bwd_tail.launches += 1
    psi_train_bwd.cols_per_cta = G
    return dse, dt0, dy, dehat


psi_train_bwd.launches = 0
psi_train_bwd.cols_per_cta = None


@torch.no_grad()
def psi_cotangents(dy, ys, t0, se, n2s, dehat, *, norm_eps: float,
                   unroll: int = 16, precision: str = "highest",
                   defer_norm: bool = False):
    """(dAb, dBb, dRb): ``psi_cotangents_plain`` for CPU tensors, the CUDA
    kernel ``csrc/psi_cotangents.cu`` for CUDA tensors."""
    kw = dict(norm_eps=norm_eps, unroll=unroll, precision=precision,
              defer_norm=defer_norm)
    if _cuda_or_raise("psi_cotangents", se):
        return psi_cotangents_plain(dy, ys, t0, se, n2s, dehat, **kw)
    return _cotangents_kernel(psi_cotangents, dy, ys, t0, se, n2s, dehat,
                              gs=1, gn=1, w_scale=2.0, **kw)


psi_cotangents.launches = 0


def _cotangents_kernel(counted, dy, ys, t0, se, n2s, dehat, *, gs: int,
                       gn: int, w_scale: float, norm_eps: float, unroll: int,
                       precision: str, defer_norm: bool):
    """Launch ``csrc/psi_cotangents.cu`` on CUDA tensors and add one to
    ``counted.launches``: the wrapper whose path the launch belongs to.
    The lanes are t0's columns; ``se`` holds one s an example of ``gs``
    lanes, ``n2s`` and ``dehat`` one norm or trace and one dehat a group of
    ``gn`` lanes; the third cotangent weighs each lane by w_scale * dehat."""
    _check_options(precision, unroll)
    n_steps = se.shape[0]
    n, L = t0.shape
    D = n // 2
    if L % gs or L % gn:
        raise ValueError(f"psi_cotangents: {L} lanes are not whole groups "
                         f"of {gs} and {gn}")
    _check_inputs("psi_cotangents", se.device, dict(
        dy=(dy, (n_steps, n, L)), ys=(ys, (n_steps, n, L)), t0=(t0, (n, L)),
        se=(se, (n_steps, L // gs)), n2s=(n2s, (n_steps, L // gn)),
        dehat=(dehat, (n_steps, L // gn))))
    lib = _build.library()
    work = se.new_empty((lib.amt_psi_cotangents_workspace_floats(D,
                                                                 n_steps),))
    out = se.new_empty((3, n, n))
    err = lib.amt_psi_cotangents(
        _ptr(dy), _ptr(ys), _ptr(t0), _ptr(se), _ptr(n2s), _ptr(dehat),
        _ptr(work), _ptr(out), D, n_steps, L, gs, gn, unroll, norm_eps,
        w_scale, PRECISIONS.index(precision), int(defer_norm),
        _stream_ptr(se.device))
    _build.check(lib, err, "psi_cotangents")
    counted.launches += 1
    return out[0], out[1], out[2]


def recompute_segment_steps(n_steps: int, unroll: int,
                            time_segment: Optional[int] = None) -> int:
    """Steps per time segment of the recompute adjoints, whole blocks of
    ``unroll``: ``time_segment`` rounded up to whole blocks, or, left None,
    ceil(n_blocks / (2 unroll)) blocks, so that one segment's ys and dy
    (twice its steps in states) take about the checkpoints' bytes (one
    state a block): ~T / (2 unroll) steps. The port's own rule, not the
    TPU's ``auto_time_segment``: the recompute path exists to hold memory
    down, so the segment does not grow with free memory."""
    nb = max(1, n_blocks(n_steps, unroll))
    blocks = (-(-nb // (2 * unroll)) if time_segment is None
              else -(-time_segment // unroll))
    return max(1, min(blocks, nb)) * unroll


def recompute_segments(n_steps: int, unroll: int,
                       time_segment: Optional[int] = None) -> list:
    """(k0, k1) of each time segment of the recompute adjoints, last
    first."""
    steps = recompute_segment_steps(n_steps, unroll, time_segment)
    return [(k0, min(k0 + steps, n_steps))
            for k0 in reversed(range(0, n_steps, steps))]


def recompute_segments_bwd(step, ck, se, dse, dt, ab, unroll, segment):
    """The segment loop of the recompute adjoints (psi, rho and the rank
    partials): time segments of whole blocks (``recompute_segments``),
    last first. ``step(k0, k1, cks, s, dt)`` rebuilds the states of steps
    [k0, k1) from their checkpoints ``cks`` (``cks[0]`` the segment's
    entry state) and increments ``s``, runs the adjoint over them with
    ``dt`` carried in from the next segment, and returns (its dse rows, dt
    at the segment's entry, its three [2D,2D] cotangents). The rows go into
    ``dse``; the cotangents are added to zeros like ``ab`` in that fixed
    order. Returns (dse, dt0, *cotangents)."""
    cot = [torch.zeros_like(ab) for _ in range(3)]
    for k0, k1 in recompute_segments(se.shape[0], unroll, segment):
        b0 = k0 // unroll
        d_s, dt, parts = step(k0, k1, ck[b0:b0 + n_blocks(k1 - k0, unroll)],
                              se[k0:k1], dt)
        dse[k0:k1] = d_s
        for acc, part in zip(cot, parts):
            acc += part
    return (dse, dt, *cot)


def _recompute_bwd(fns, ab, bb, cb, ck, se, g, *, log_eps, norm_eps, unroll,
                   precision, defer_norm, segment):
    """The recompute adjoint of psi (cb = Rb) or rho (cb = Xb) from the
    checkpoints ck: (dse, dt0, dAb, dBb, dRb or dXb). ``fns`` = (recompute,
    adjoint, cotangents), the family's plain versions or its kernels, run
    a segment at a time by ``recompute_segments_bwd``. A segment ends at a
    block exit, whose renorm seeds its last step, and the next segment's
    first step drops its dn2_new or dtr_new, so only dt crosses."""
    recompute, adjoint, cotangents = fns
    kw = dict(norm_eps=norm_eps, unroll=unroll, precision=precision,
              defer_norm=defer_norm)

    def step(k0, k1, cks, s, dt):
        ys, norms = recompute(ab, bb, cb, cks, s, **kw)
        d_s, dt, dy, dehat = adjoint(ab, bb, cb, cks[0], s, g, ys, norms,
                                     log_eps=log_eps, dtfin=dt, **kw)
        return d_s, dt, cotangents(dy, ys, cks[0], s, norms, dehat, **kw)

    return recompute_segments_bwd(step, ck, se, torch.empty_like(se),
                                  ck.new_zeros(ck.shape[1:]), ab, unroll,
                                  segment)


@torch.no_grad()
def psi_recompute_bwd_plain(ab, bb, rb, ck, se, g, *, log_eps: float,
                            norm_eps: float, unroll: int = 16,
                            precision: str = "highest",
                            defer_norm: bool = False,
                            segment: Optional[int] = None):
    """The recompute adjoint of ``psi_train_fwd_ckpt`` for the loss
    cotangent g [B]: (dse [n_steps, B], dt0 [2D, B], dAb, dBb, dRb) from the
    checkpoints ck, with no state stream (the TPU's
    ``_make_psi_bwd_kernel_defer`` :621, and ``_make_psi_bwd_kernel`` :529
    at ``defer_norm=False``), over time segments of ``segment`` steps
    (``recompute_segment_steps``): ``psi_recompute_plain``,
    ``psi_train_bwd_plain`` and ``psi_cotangents_plain`` on each. Plain
    PyTorch, any device."""
    return _recompute_bwd(
        (psi_recompute_plain, psi_train_bwd_plain, psi_cotangents_plain),
        ab, bb, rb, ck, se, g, log_eps=log_eps, norm_eps=norm_eps,
        unroll=unroll, precision=precision, defer_norm=defer_norm,
        segment=segment)


@torch.no_grad()
def psi_recompute_bwd(ab, bb, rb, ck, se, g, *, log_eps: float,
                      norm_eps: float, unroll: int = 16,
                      precision: str = "highest", defer_norm: bool = False,
                      segment: Optional[int] = None, cols_per_cta=None):
    """(dse, dt0, dAb, dBb, dRb): ``psi_recompute_bwd_plain`` for CPU
    tensors; for CUDA tensors the same segments through the kernels
    ``psi_recompute``, ``psi_train_bwd`` (its dt carried in; both at
    ``cols_per_cta``) and ``psi_cotangents``, each counting its own
    launches."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm, segment=segment)
    _check_cols(cols_per_cta)
    if _cuda_or_raise("psi_recompute_bwd", se):
        return psi_recompute_bwd_plain(ab, bb, rb, ck, se, g, **kw)
    cols = dict(cols_per_cta=cols_per_cta)
    return _recompute_bwd(
        (functools.partial(psi_recompute, **cols),
         functools.partial(psi_train_bwd, **cols), psi_cotangents),
        ab, bb, rb, ck, se, g, **kw)


# ===========================================================================
# Training: the spine/limbs pair (the TPU's batched=True knob)
# ===========================================================================
#
# The TPU's _make_psi_fwd_kernel_batched (:276) and
# _make_psi_bwd_kernel_batched (:338), deferred norm only: the serial
# "spine" of each unroll-step block is the state recurrence alone, and the
# "limbs" (the expectations Rb y, the loss tail, Rb^T dru and the three
# parameter cotangents) run once a block over all of its states. The
# forward keeps the block checkpoints, as psi_train_fwd_ckpt does; the
# adjoint re-runs each block from its checkpoint inside the same CTA, so
# neither ys nor dy reaches device memory. Off by default, as on the TPU.


def _block_states(abp, bbp, t, s, prep, dotf):
    """[K + 1, 2D, B]: t, then the block's spine y_k = Ab t_k + s_k Bb t_k
    with t_{k+1} = y_k (unnormalised inside a block)."""
    states = [t]
    tp = prep(t)
    for k in range(s.shape[0]):
        y = dotf(abp, tp) + s[k:k + 1] * dotf(bbp, tp)
        tp = prep(y)
        states.append(y)
    return torch.stack(states)


def _block_tail(rbp, ys, prep, dotf):
    """The block's batched limb: (RU = Rb Y, ehat [K, B], n2 [K, B], n2p
    [K, B], the squared norm each step's e divides by: 1 at the block's
    first step, after the entry renorm)."""
    ru = dotf(rbp, prep(ys))
    ehat = 2.0 * torch.sum(ys * ru, dim=1)
    n2 = torch.sum(ys * ys, dim=1)
    n2p = torch.cat([torch.ones_like(n2[:1]), n2[:-1]])
    return ru, ehat, n2, n2p


@torch.no_grad()
def psi_batched_fwd_plain(ab, bb, rb, t0, se, *, log_eps: float,
                          norm_eps: float, unroll: int = 16,
                          precision: str = "highest"):
    """(loss [B], ck [n_blocks, 2D, B]) of the deferred-norm NLL, a block at
    a time: the K-step spine keeps the block's states, one Rb [y_1 .. y_K]
    product gives every ehat, then the per-step loss and the exit renorm
    (``pallas_block.py:307-333``). The last block may be partial. Plain
    PyTorch, any device."""
    prep, dotf = _make_dot_ops(precision)
    abp, bbp, rbp = prep(ab), prep(bb), prep(rb)
    n_steps = se.shape[0]
    ck = se.new_empty((n_blocks(n_steps, unroll),) + tuple(t0.shape))
    t = t0
    acc = torch.zeros_like(t0[0])
    for j in range(ck.shape[0]):
        s = se[j * unroll:(j + 1) * unroll]
        ck[j] = t
        ys = _block_states(abp, bbp, t, s, prep, dotf)[1:]
        _, ehat, n2, n2p = _block_tail(rbp, ys, prep, dotf)
        e = ehat / torch.clamp(n2p, min=norm_eps)
        for k in range(s.shape[0]):
            acc = acc - torch.log(torch.clamp(1.0 + e[k] * s[k],
                                              min=log_eps))
        t = ys[-1] * torch.rsqrt(torch.clamp(n2[-1], min=norm_eps))
    return acc, ck


@torch.no_grad()
def psi_batched_bwd_plain(ab, bb, rb, ck, se, g, *, log_eps: float,
                          norm_eps: float, unroll: int = 16,
                          precision: str = "highest"):
    """Adjoint of ``psi_batched_fwd`` for the loss cotangent g [B]: (dse
    [n_steps, B], dt0 [2D, B], dAb, dBb, dRb), blocks last first
    (``pallas_block.py:338-458``): the spine re-run from ck; the batched
    tail (Rb Y, the forward-computable e, arg, darg, dehat and dn2 rows,
    then Rb^T dRU); the serial reverse spine dy -> (Ab^T dy, Bb^T dy); and
    per block the three lane contractions dy t^T, dy (s t)^T and dru y^T.
    The dn2 bookkeeping is ``psi_train_bwd_plain``'s: the block-exit
    renorm seeds the block's last step, a block's first step drops its
    dn2_new, and with no cotangent after the last real step its dn2 is 0.
    dse has the real steps' rows only. Plain PyTorch, any device."""
    prep, dotf, dotnt = _make_dot_ops_bwd(precision)
    abp, bbp, rbp = prep(ab), prep(bb), prep(rb)
    abT, bbT, rbT = prep(ab.T), prep(bb.T), prep(rb.T)
    n = ab.shape[0]

    def lanes(x):                                       # [2D, K * B]
        return x.transpose(0, 1).reshape(n, -1)

    dse = torch.empty_like(se)
    dt = torch.zeros_like(ck[0])
    dab, dbb, drb = (torch.zeros_like(ab) for _ in range(3))
    for j in reversed(range(ck.shape[0])):
        k0 = j * unroll
        s = se[k0:k0 + unroll]
        states = _block_states(abp, bbp, ck[j], s, prep, dotf)
        ts, ys = states[:-1], states[1:]
        ru, ehat, n2, n2p = _block_tail(rbp, ys, prep, dotf)
        # the block-exit renorm's adjoint seeds the last step
        inv = torch.rsqrt(torch.clamp(n2[-1], min=norm_eps))
        dinv = torch.sum(dt * ys[-1], dim=0)
        dn2_exit = torch.where(n2[-1] > norm_eps,
                               -0.5 * dinv * inv * inv * inv,
                               torch.zeros_like(dinv))
        dt = dt * inv
        n2p_c = torch.clamp(n2p, min=norm_eps)
        e = ehat / n2p_c
        arg = torch.clamp(1.0 + e * s, min=log_eps)
        darg = torch.where(arg > log_eps, -g / arg, torch.zeros_like(arg))
        de = darg * s
        dehat = de / n2p_c
        dn2_new = torch.where(n2p > norm_eps, -de * e / n2p_c,
                              torch.zeros_like(de))
        # the dn2 used at step k: step k+1's dn2_new, the exit's at the last
        dn2 = torch.cat([dn2_new[1:], dn2_exit[None]])
        dru = (2.0 * dehat)[:, None, :] * ys
        c = ((ys * (2.0 * dn2)[:, None, :] + ru * (2.0 * dehat)[:, None, :])
             + dotf(rbT, prep(dru)))
        dys = torch.empty_like(ys)
        for k in reversed(range(s.shape[0])):
            dy = dt + c[k]
            dys[k] = dy
            pdy = prep(dy)
            du = dotf(bbT, pdy)
            dse[k0 + k] = darg[k] * e[k] + torch.sum(du * ts[k], dim=0)
            dt = dotf(abT, pdy) + s[k] * du
        pdy = prep(lanes(dys))
        dab += dotnt(pdy, prep(lanes(ts)))
        dbb += dotnt(pdy, prep(lanes(s[:, None, :] * ts)))
        drb += dotnt(prep(lanes(dru)), prep(lanes(ys)))
    return dse, dt, dab, dbb, drb


def _batched_opts(opts: dict) -> dict:
    """``PsiBlockNLL``'s opts without defer_norm (the batched pair has the
    deferred norm only)."""
    return {k: v for k, v in opts.items() if k != "defer_norm"}


def _batched_checks(name, ab, bb, rb, se, precision, unroll, **more):
    """Check the batched pair's inputs; returns (n_steps, B, D)."""
    _check_options(precision, unroll)
    n_steps, B = se.shape
    n = ab.shape[0]
    _check_inputs(name, se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), rb=(rb, (n, n)),
        se=(se, (n_steps, B)), **{k: (x, shape(n, B)) for k, (x, shape)
                                  in more.items()}))
    return n_steps, B, n // 2


@torch.no_grad()
def psi_batched_fwd(ab, bb, rb, t0, se, *, log_eps: float, norm_eps: float,
                    unroll: int = 16, precision: str = "highest"):
    """(loss [B], ck): ``psi_batched_fwd_plain`` for CPU tensors, the CUDA
    kernel ``csrc/psi_batched_fwd.cu`` (the kBatched mode of
    ``psi_fwd.cuh``) for CUDA tensors."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision)
    if _cuda_or_raise("psi_batched_fwd", se):
        return psi_batched_fwd_plain(ab, bb, rb, t0, se, **kw)
    n_steps, B, D = _batched_checks(
        "psi_batched_fwd", ab, bb, rb, se, precision, unroll,
        t0=(t0, lambda n, b: (n, b)))
    lib = _build.library()
    # the pair runs together: a shape its adjoint's CTA cannot take is
    # refused before the forward
    _check_smem("psi_batched_fwd",
                max(lib.amt_psi_batched_fwd_smem_bytes(D, unroll),
                    lib.amt_psi_batched_bwd_smem_bytes(D, unroll)),
                se.device, D)
    loss = se.new_empty((B,))
    ck = se.new_empty((n_blocks(n_steps, unroll), 2 * D, B))
    if B == 0:
        return loss, ck
    err = lib.amt_psi_batched_fwd(
        _ptr(ab), _ptr(bb), _ptr(rb), _ptr(t0), _ptr(se), _ptr(loss),
        _ptr(ck), D, n_steps, B, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), _stream_ptr(se.device))
    _build.check(lib, err, "psi_batched_fwd")
    psi_batched_fwd.launches += 1
    return loss, ck


psi_batched_fwd.launches = 0


@torch.no_grad()
def psi_batched_window(unroll: int) -> int:
    """Steps of the batched adjoint's contraction window: the most whole
    blocks of ``unroll`` steps within 64, at least one. Each CTA keeps the
    window's t, y and dy vectors in a device scratch and runs its three
    lane contractions once a window, so it reads and writes its row of the
    [B, 3, 2D, 2D] sums once every 64 steps (at unroll 16, 4 blocks). A
    pure function of unroll."""
    return max(1, 64 // unroll) * unroll


def psi_batched_bwd(ab, bb, rb, ck, se, g, *, log_eps: float,
                    norm_eps: float, unroll: int = 16,
                    precision: str = "highest"):
    """(dse, dt0, dAb, dBb, dRb): ``psi_batched_bwd_plain`` for CPU tensors,
    the CUDA kernel ``csrc/psi_batched_bwd.cu`` for CUDA tensors. Each CTA
    adds its column's three [2D,2D] sums, once a contraction window
    (``psi_batched_window``), to its own row of a [B, 3, 2D, 2D] buffer,
    which is summed here over the columns in a fixed order, so two runs are
    equal bit for bit."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision)
    if _cuda_or_raise("psi_batched_bwd", se):
        return psi_batched_bwd_plain(ab, bb, rb, ck, se, g, **kw)
    n_steps, B, D = _batched_checks(
        "psi_batched_bwd", ab, bb, rb, se, precision, unroll,
        ck=(ck, lambda n, b: (n_blocks(se.shape[0], unroll), n, b)),
        g=(g, lambda n, b: (b,)))
    lib = _build.library()
    _check_smem("psi_batched_bwd",
                lib.amt_psi_batched_bwd_smem_bytes(D, unroll), se.device, D)
    n = 2 * D
    dse = torch.empty_like(se)
    dt0 = se.new_empty((n, B))
    # zeros: over no step the kernel writes no row (and dt0 = 0)
    part = se.new_zeros((B, 3, n, n))
    window = psi_batched_window(unroll)
    scratch = se.new_empty(
        (B, lib.amt_psi_batched_bwd_scratch_floats(D, window)))
    if B > 0:
        err = lib.amt_psi_batched_bwd(
            _ptr(ab), _ptr(bb), _ptr(rb), _ptr(ck), _ptr(se), _ptr(g),
            _ptr(dse), _ptr(dt0), _ptr(part), _ptr(scratch), D, n_steps, B,
            unroll, window, log_eps, norm_eps, PRECISIONS.index(precision),
            _stream_ptr(se.device))
        _build.check(lib, err, "psi_batched_bwd")
        psi_batched_bwd.launches += 1
    tot = part.sum(dim=0)
    return dse, dt0, tot[0], tot[1], tot[2]


psi_batched_bwd.launches = 0


class PsiBlockNLL(torch.autograd.Function):
    """Per-example NLL [B] over the block constants with a kernel adjoint:
    the counterpart of ``_psi_block_factory``'s custom VJP
    (``pallas_block.py:1248-1264``). ``forward(ab, bb, rb, t0, se, opts,
    segment)`` returns loss [B]; ``backward(g)`` returns (dAb, dBb, dRb,
    dt0, dse). ``opts`` holds log_eps, norm_eps, unroll, precision and
    defer_norm. ``segment`` None runs the streamed-states pair
    (``psi_train_fwd``, then ``psi_train_bwd`` and ``psi_cotangents`` over
    the whole stream); an int runs the checkpoint forward
    (``psi_train_fwd_ckpt``) and the recompute adjoint
    (``psi_recompute_bwd``) in time segments of that many steps;
    ``"batched"`` runs the spine/limbs pair (``psi_batched_fwd``,
    ``psi_batched_bwd``; the TPU factory's ``batched=True``), which needs
    ``defer_norm``. Only the values handed to the kernels are detached;
    autograd carries the cotangents on to the parameters outside."""

    @staticmethod
    def forward(ctx, ab, bb, rb, t0, se, opts, segment):
        ins = [_as_kernel_input(x) for x in (ab, bb, rb, t0, se)]
        ctx.opts, ctx.segment = opts, segment
        if segment == "batched":
            if not opts["defer_norm"]:
                raise ValueError("the batched kernels implement the "
                                 "deferred-normalization semantics only")
            loss, ck = psi_batched_fwd(*ins, **_batched_opts(opts))
            ctx.save_for_backward(*ins, ck)
        elif segment is None:
            loss, ys, n2s = psi_train_fwd(*ins, **opts)
            ctx.save_for_backward(*ins, ys, n2s)
        else:
            loss, ck = psi_train_fwd_ckpt(*ins, **opts)
            ctx.save_for_backward(*ins, ck)
        return loss

    @staticmethod
    def backward(ctx, g):
        opts, g = ctx.opts, _as_kernel_input(g)
        if ctx.segment == "batched":
            ab, bb, rb, _, se, ck = ctx.saved_tensors
            dse, dt0, dab, dbb, drb = psi_batched_bwd(
                ab, bb, rb, ck, se, g, **_batched_opts(opts))
            return dab, dbb, drb, dt0, dse, None, None
        if ctx.segment is not None:
            ab, bb, rb, _, se, ck = ctx.saved_tensors
            dse, dt0, dab, dbb, drb = psi_recompute_bwd(
                ab, bb, rb, ck, se, g, segment=ctx.segment, **opts)
            return dab, dbb, drb, dt0, dse, None, None
        ab, bb, rb, t0, se, ys, n2s = ctx.saved_tensors
        dse, dt0, dy, dehat = psi_train_bwd(ab, bb, rb, t0, se, g, ys, n2s,
                                            **opts)
        dab, dbb, drb = psi_cotangents(
            dy, ys, t0, se, n2s, dehat, norm_eps=opts["norm_eps"],
            unroll=opts["unroll"], precision=opts["precision"],
            defer_norm=opts["defer_norm"])
        return dab, dbb, drb, dt0, dse, None, None


def stream_bytes(D: int, cols: int, T: int) -> int:
    """Bytes of the two fp32 state streams of one training step: ys from
    the forward and dy from the adjoint, [T-1, 2D, cols] each (cols = B for
    psi, B * rank for rho)."""
    return 2 * 4 * max(T - 1, 0) * 2 * D * cols


def stream_policy(n_bytes: int, free_bytes: Optional[int],
                  kernel_stream: str) -> bool:
    """Do the streamed-states kernels run? The port's own policy in place
    of the TPU's HBM budget (``pallas_block.auto_stream``): "off" never
    streams; "on" always streams, skipping the budget as the TPU's does
    (a stream past the card's memory then fails to allocate); "auto"
    streams when the streams' ``n_bytes`` fit ``free_bytes`` (None: no
    limit). Where nothing streams, the recompute adjoint runs, from the
    block checkpoints."""
    if kernel_stream != "auto":
        return kernel_stream == "on"
    return free_bytes is None or n_bytes <= free_bytes


def auto_stream(cfg: CMPSConfig, cols: int, T: int, device) -> bool:
    """``stream_policy`` for a training step on ``device``: the card's free
    memory bounds the streams on a CUDA device, nothing on the CPU."""
    device = torch.device(device)
    free = (torch.cuda.mem_get_info(device)[0] if device.type == "cuda"
            else None)
    return stream_policy(stream_bytes(cfg.bond_dim, cols, T), free,
                         cfg.kernel_stream)


def _stream_or_segment(cfg: CMPSConfig, cols: int, T: int, device,
                       unroll: int):
    """The ``segment`` argument of ``PsiBlockNLL`` / ``RhoBlockNLL``: None
    when the streamed-states pair runs (``auto_stream``), else the steps
    per time segment of the recompute adjoint."""
    if auto_stream(cfg, cols, T, device):
        return None
    return recompute_segment_steps(T - 1, unroll)


def psi_nll_block_trainable_from_state(params, cfg: CMPSConfig, signals,
                                       psi0_pair, *, unroll: int = 16,
                                       precision: str = "highest",
                                       defer_norm: bool = False,
                                       batched: bool = False):
    """Differentiable block-layout per-example NLL [B] of waveforms [B, T]
    from per-example initial states (pr0, pi0) [B, D] (the TPU's
    ``pallas_block.psi_nll_block_trainable_from_state`` with
    ``reduce="none"``). The block constants, initial state and increments
    are built with autograd; the loss and its adjoint go through
    ``PsiBlockNLL``: the streamed-states pair where ``auto_stream`` lets
    the stream run, else the checkpoint forward and the recompute adjoint
    in time segments of ``recompute_segment_steps``. ``batched`` runs the
    spine/limbs pair instead (the TPU factory's ``batched=True``; off by
    default there and here, and only with ``defer_norm``)."""
    if not supports_block(cfg):
        raise ValueError(
            f"block layout requires bond_dim % 4 == 0, got {cfg.bond_dim}")
    _check_options(precision, unroll)
    B, T = signals.shape
    segment = ("batched" if batched
               else _stream_or_segment(cfg, B, T, signals.device, unroll))
    cc = make_constants(params, cfg)
    se = (signals[:, 1:] - signals[:, :-1]).T / cc.A      # [T-1, B]
    pr0, pi0 = psi0_pair
    ab, bb, rb = _psi_block_constants(cc)
    t0 = _psi_block_t0(cc, pr0.T, pi0.T)
    log_eps = cfg.log_eps if cfg.log_eps > 0 else float("-inf")
    return PsiBlockNLL.apply(ab, bb, rb, t0, se, dict(
        log_eps=float(log_eps), norm_eps=float(cfg.norm_eps), unroll=unroll,
        precision=precision, defer_norm=defer_norm), segment)


def psi_nll_block_trainable(params, cfg: CMPSConfig, signals, *,
                            unroll: int = 16, precision: str = "highest",
                            defer_norm: bool = False, batched: bool = False):
    """Differentiable mean NLL with the model's own initial state
    (semantics of ``core.psi_nll``; the TPU's
    ``pallas_block.psi_nll_block_trainable``)."""
    B = signals.shape[0]
    pr0, pi0 = core.psi0(params, cfg)
    pair = (pr0[None].expand(B, -1), pi0[None].expand(B, -1))
    return psi_nll_block_trainable_from_state(
        params, cfg, signals, pair, unroll=unroll, precision=precision,
        defer_norm=defer_norm, batched=batched).mean()


# ===========================================================================
# rho (mixed state): the purification factor on [2D, B*rank]
# ===========================================================================
#
# The state is H = G^T stacked as [2D, cols], cols = (example or chain) x
# rank: example b owns columns b*rank .. (b+1)*rank - 1. The trace and the
# expectation of an example are sums over its whole column segment, so a
# CUDA kernel gives one CTA one example's segment, and the per-example
# scalars (the increment s, the loss, the trace) are [*, B], not repeated
# over the rank lanes as on the TPU.

def rho_factor_inputs(params, cfg: CMPSConfig, n_cols: int):
    """Normalized initial purification factor H0 = W^T / sqrt(tr(W^dag W))
    tiled over ``n_cols`` examples: (h0r, h0i) [D, n_cols * rank] (the
    TPU's ``pallas_scan.rho_factor_inputs`` without its rank padding and
    0/1 segment matrix: the port runs the real rank, one CTA a segment)."""
    wr, wi = params.Wx, params.Wy
    tr0 = torch.sum(wr * wr + wi * wi)
    inv0 = torch.rsqrt(torch.clamp(tr0, min=cfg.norm_eps))
    return (wr.T * inv0).repeat(1, n_cols), (wi.T * inv0).repeat(1, n_cols)


def _rho_block_constants(cc):
    """(Ab, Bb, Xb) with the diag(p) rotation folded in:
    A~ = conj(C) diag(p), B~ = conj(R) diag(p); Xb embeds X^T."""
    pc, ps = cc.p_c, cc.p_s
    atr = cc.Cr * pc[None, :] + cc.Ci * ps[None, :]
    ati = cc.Cr * ps[None, :] - cc.Ci * pc[None, :]
    btr = cc.Rr * pc[None, :] + cc.Ri * ps[None, :]
    bti = cc.Rr * ps[None, :] - cc.Ri * pc[None, :]
    return (block_embed(atr, ati), block_embed(btr, bti),
            block_embed(cc.Xr.T, cc.Xi.T))


def _rho_sample_xb(cc):
    """The sampler's expectation operator: its expectation acts on the
    current state H = p .* t, so X^T takes the update operators' diag(p)
    fold, (X^T diag(p)) t (``pallas_block.rho_sample_block`` :2356-2363)."""
    pc, ps = cc.p_c[None, :], cc.p_s[None, :]
    return block_embed(cc.Xr.T * pc - cc.Xi.T * ps,
                       cc.Xi.T * pc + cc.Xr.T * ps)


def _rho_block_t0(cc, h0r, h0i):
    """Stacked kernel-frame initial factor t0 = conj(p) .* H0 ([2D, cols])."""
    pc, ps = cc.p_c[:, None], cc.p_s[:, None]
    return torch.cat([h0r * pc + h0i * ps, h0i * pc - h0r * ps], dim=0)


def _lanes(v, rank: int):
    """Per-example values [..., B] repeated over each example's rank lanes
    ([..., B * rank])."""
    return v.repeat_interleave(rank, dim=-1)


def _segment_sum(x, rank: int):
    """Sum of x [..., rows, B * rank] over the rows and each example's rank
    lanes: [..., B]."""
    s = x.sum(dim=-2)
    return s.reshape(s.shape[:-1] + (-1, rank)).sum(dim=-1)


def _rank_of(name, cols: int, n: int) -> int:
    if n <= 0 or cols % n:
        raise ValueError(f"{name}: {cols} state columns are not a whole "
                         f"number of rank segments for {n} examples")
    return cols // n


def rho_sample_inputs(params, cfg: CMPSConfig, noise) -> dict:
    """Kernel inputs of ``rho_sample_block`` from parameters and noise
    [T, N] (the TPU's ``pallas_block.rho_sample_block`` preamble)."""
    if not supports_block_sampler(cfg):
        raise ValueError(
            f"block sampler requires bond_dim % 8 == 0, got {cfg.bond_dim}")
    with torch.no_grad():
        cc = make_constants(params, cfg)
        ab, bb, _ = _rho_block_constants(cc)
        t0 = _rho_block_t0(cc, *rho_factor_inputs(params, cfg,
                                                  noise.shape[1]))
        return dict(ab=_as_kernel_input(ab), bb=_as_kernel_input(bb),
                    xb=_as_kernel_input(_rho_sample_xb(cc)),
                    pc=_as_kernel_input(cc.p_c), ps=_as_kernel_input(cc.p_s),
                    t0=_as_kernel_input(t0), noise=_as_kernel_input(noise),
                    inv_a=_as_kernel_input((1.0 / cc.A).reshape(1)),
                    dt=float(cfg.delta_t), norm_eps=float(cfg.norm_eps))


@torch.no_grad()
def rho_sample_block_plain(ab, bb, xb, pc, ps, t0, noise, inv_a, *,
                           dt: float, norm_eps: float,
                           precision: str = "highest"):
    """Running waveform [T, N] of N chains whose factors are t0
    [2D, N * rank] (the caller scales by A and transposes). The
    expectation is taken on the current state with the conj(p) twist, then
    the factor is updated with the realised increment / A and renormalised
    by its trace. The state is carried unnormalised, in the kernel's order:
    u_0 = t0 and u_{k+1} = y_k, the update before its renorm; step k
    applies c_k = rsqrt(max(sum(u_k^2), norm_eps)) (1 at step 0, where t0
    is taken as given) after its products, e_k = c_k^2 sum(u_k .* v(u_k))
    and u_{k+1} = c_k (Ab u_k + s_k Bb u_k), the same recursion in exact
    arithmetic. Plain PyTorch, any device."""
    prep, dotf = _make_dot_ops(precision)
    D = pc.shape[0]
    rank = _rank_of("rho_sample_block", t0.shape[1], noise.shape[1])
    abp, bbp, xbp = prep(ab), prep(bb), prep(xb)
    pc, ps = pc[:, None], ps[:, None]
    u = t0
    samp = torch.zeros_like(noise[0])
    out = torch.empty_like(noise)
    for k in range(noise.shape[0]):
        up = prep(u)
        gx = dotf(xbp, up)                   # X^T H on the current state
        gxr, gxi = gx[:D], gx[D:]
        vr = pc * gxr + ps * gxi             # v = conj(p) .* gx
        vi = pc * gxi - ps * gxr
        ehat = _segment_sum(u[:D] * vr + u[D:] * vi, rank)
        c = (torch.rsqrt(torch.clamp(_segment_sum(u * u, rank),
                                     min=norm_eps))
             if k else torch.ones_like(ehat))
        inc = c * c * ehat * dt + noise[k]
        samp = samp + inc
        out[k] = samp
        s = _lanes(inc * inv_a, rank)
        u = (dotf(abp, up) + s * dotf(bbp, up)) * _lanes(c, rank)
    return out


def rho_block_fits(D: int, rank: int) -> bool:
    """The rho block kernels' layout (``csrc/rho_cluster.cuh``): an
    example's [2D, rank] segment over a thread-block cluster of C CTAs by
    its ceil(rank/4) column groups, each CTA holding the constants whole
    and its columns as one row x BC columns a thread (BC = 4, 8 or 16, 32
    ceil(2D/32) threads a column block, at most 512 a CTA); the sampler
    and the forward and chain take D % 4 == 0, D <= 64 and 1 <= rank <= 64
    (``rho_cluster_for`` picks C)."""
    return D % 4 == 0 and D <= 64 and 1 <= rank <= 64


# The rho block forward (csrc/rho_fwd.cuh) and adjoint chain
# (csrc/rho_train_bwd.cu) run an example's [2D, rank] segment over a
# thread-block cluster of C CTAs by its rank columns (csrc/rho_cluster.cuh):
# C divides the ceil(rank/4) column groups. The counts below mirror the
# kernels' own (tests/test_torch_cuda.py holds them equal).
RHO_CLUSTERS = (1, 2, 4, 8, 16)
RHO_SLOTS = 16          # steps whose sums wait for one exchange (kRhoSlots)
RHO_CTA_THREADS = 512   # the kernels' launch bound (kRhoCtaThreads)
RHO_PARTS = 3           # part sets of the sums in flight (kRhoParts)


def _rho_layout(D: int, rank: int, C: int) -> tuple:
    """(n, ng, sw, RW) of a rho cluster CTA (``RhoLayout``): the state rows,
    its column groups, its state tile's row width (the columns a thread,
    BC, times the column blocks) and its row warps."""
    n = 2 * D
    ng = -(-rank // 4) // C
    cwid = 4 * ng
    rw = -(-n // 32)
    bc = (4 if cwid <= 4 else
          8 if 32 * rw * -(-cwid // 8) <= RHO_CTA_THREADS else 16)
    return n, ng, -(-cwid // bc) * bc, rw


def _rho_sums_words(D: int, rank: int, C: int, ns: int, nslot: int) -> int:
    _, ng, _, rw = _rho_layout(D, rank, C)
    return (RHO_PARTS * ns * rw * ng + (2 * nslot * ns * ng if C > 1 else 0)
            + nslot * ns)


def rho_fwd_smem_bytes(D: int, rank: int, C: int, recompute: bool = False,
                       nbuf: int = 2) -> int:
    """Dynamic shared memory of one rho forward CTA (``csrc/rho_fwd.cuh``)
    in clusters of C: Ab, Bb, Xb (Xb not for the recompute), ``nbuf``
    state buffers of the CTA's columns, the slots of two sums a step and
    the slots' increments, 4 bytes a word."""
    n, _, sw, _ = _rho_layout(D, rank, C)
    return 4 * ((2 if recompute else 3) * n * n + nbuf * n * sw
                + _rho_sums_words(D, rank, C, 2, RHO_SLOTS) + RHO_SLOTS)


def rho_fwd_buffers(D: int, rank: int, C: int, recompute: bool = False,
                    smem_optin: int = H100_SMEM_OPTIN) -> int:
    """State buffers of a rho forward CTA: two (one barrier a step) where
    they fit ``smem_optin``, else one (C=1 at D=64, rank > 32)."""
    return 2 if rho_fwd_smem_bytes(D, rank, C, recompute, 2) <= smem_optin \
        else 1


def rho_chain_smem_bytes(D: int, rank: int, C: int) -> int:
    """Dynamic shared memory of one rho adjoint-chain CTA
    (``csrc/rho_train_bwd.cu``) in clusters of C: Ab, Bb, two dy buffers
    and the slots of one sum (16 steps' dsum and one dinv)."""
    n, _, sw, _ = _rho_layout(D, rank, C)
    return 4 * (2 * n * n + 2 * n * sw
                + _rho_sums_words(D, rank, C, 1, RHO_SLOTS + 1))


def rho_train_smem_bytes(D: int, rank: int) -> int:
    """The least dynamic shared memory of a rho forward CTA that holds an
    example's whole segment (one CTA an example, one state buffer): the
    monolithic rho kernels take (D, rank) where it fits."""
    return rho_fwd_smem_bytes(D, rank, 1, nbuf=1)


def rho_sample_smem_bytes(D: int, rank: int, C: int, nbuf: int = 2) -> int:
    """Dynamic shared memory of one rho sampler CTA (``csrc/rho_sample.cu``)
    in clusters of C: Ab, Bb, Xs, ``nbuf`` state buffers of the CTA's
    columns (one also carries the expectation's rows for the twist) and
    the part sets of the step's two sums, 4 bytes a word."""
    n, _, sw, _ = _rho_layout(D, rank, C)
    return 4 * (3 * n * n + nbuf * n * sw + _rho_sums_words(D, rank, C, 2, 0))


def rho_sample_buffers(D: int, rank: int, C: int,
                       smem_optin: int = H100_SMEM_OPTIN) -> int:
    """State buffers of a rho sampler CTA: two where they fit
    ``smem_optin``, else one (C=1 at D=64, rank > 32)."""
    return 2 if rho_sample_smem_bytes(D, rank, C, 2) <= smem_optin else 1


def _rho_cta_bytes(kernel: str, D: int, rank: int, C: int,
                   smem_optin: int) -> int:
    if kernel == "chain":
        return rho_chain_smem_bytes(D, rank, C)
    if kernel == "sample":
        return rho_sample_smem_bytes(D, rank, C, rho_sample_buffers(
            D, rank, C, smem_optin))
    recompute = kernel == "recompute"
    return rho_fwd_smem_bytes(D, rank, C, recompute, rho_fwd_buffers(
        D, rank, C, recompute, smem_optin))


def rho_cluster_for(D: int, B: int, rank: int, n_sms: int, resident,
                    smem_optin: int = H100_SMEM_OPTIN,
                    kernel: str = "fwd") -> int:
    """The cluster C of a rho block launch of B clusters (examples; for the
    recompute, examples x blocks; for the sampler, chains) at bond
    dimension D: the largest C in ``RHO_CLUSTERS`` that divides the
    ceil(rank/4) column groups, whose CTA (``kernel``: "fwd", "recompute",
    "chain" or "sample") fits ``smem_optin``, that
    the card holds (``resident(c)``: the c-CTA clusters it holds at once, a
    mapping or a callable; 0 or less: none) and whose B clusters need no
    more waves than the smallest such C's, ceil(B / resident(c)). At
    B >= n_sms the examples alone give every SM a CTA, and the smallest C
    stays. A pure function of its arguments, as ``psi_columns_per_cta``
    and ``rank.partials_cluster`` are. (An H100 at the forward's ~200 KB
    CTA holds 132 CTAs, 66 clusters of 2, 30 of 4 and 15 of 8: B=8 at
    D=64, rank 64 runs in clusters of 8, 64 CTAs; rank 3 has one group and
    stays at 1. The sampler's one chain takes 16 where the card holds a
    cluster of 16.)"""
    if callable(resident):
        res = resident
    else:
        def res(c):
            return resident.get(c, 0)
    G = -(-rank // 4)
    fits = [c for c in RHO_CLUSTERS
            if G % c == 0 and res(c) > 0
            and _rho_cta_bytes(kernel, D, rank, c, smem_optin) <= smem_optin]
    if not fits:
        return 1
    if B >= n_sms:
        return fits[0]

    def waves(c):
        return -(-B // res(c))

    return max(c for c in fits if waves(c) <= waves(fits[0]))


def _check_rho_cluster(name, cluster, rank: int):
    G = -(-rank // 4)
    if cluster is not None and (cluster not in RHO_CLUSTERS or G % cluster):
        raise ValueError(f"{name}: a cluster of {cluster!r} CTAs: it must "
                         f"be one of {RHO_CLUSTERS} and divide the {G} "
                         f"column groups of rank {rank}")


_RHO_MAX_CLUSTERS = {"fwd": "amt_rho_fwd_max_clusters",
                     "recompute": "amt_rho_recompute_max_clusters",
                     "chain": "amt_rho_chain_max_clusters",
                     "sample": "amt_rho_sample_max_clusters"}


@functools.lru_cache(maxsize=None)
def rho_resident_clusters(index: int, kernel: str, D: int, rank: int,
                          c: int) -> int:
    """Clusters of c CTAs of a rho block ``kernel`` card ``index`` holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    lib = _build.library()
    with torch.cuda.device(index):
        got = getattr(lib, _RHO_MAX_CLUSTERS[kernel])(D, rank, c)
    if got < 0:
        _build.check(lib, -got, _RHO_MAX_CLUSTERS[kernel])
    return got


def _rho_cluster(name, kernel: str, D: int, B: int, rank: int, device,
                 cluster) -> int:
    """C of a rho block launch of B clusters on a CUDA ``device``:
    ``cluster`` when given (checked before any launch), else
    ``rho_cluster_for`` on the card's SMs, shared memory and residency."""
    _check_rho_cluster(name, cluster, rank)
    if cluster is not None:
        return cluster
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    props = torch.cuda.get_device_properties(index)
    G = -(-rank // 4)
    return rho_cluster_for(
        D, B, rank, props.multi_processor_count,
        lambda c: (rho_resident_clusters(index, kernel, D, rank, c)
                   if G % c == 0 else 0),
        props.shared_memory_per_block_optin, kernel)


def _check_rho_shape(name, D: int, rank: int):
    if not rho_block_fits(D, rank):
        raise NotImplementedError(
            f"{name} at D={D}, rank={rank}: the rho kernels take D % 4 == 0, "
            f"D <= 64 and 1 <= rank <= 64 (the [2D,2D] constants resident "
            f"in each CTA's shared memory beside its share of an example's "
            f"or a chain's [2D, rank] segment, spread over a cluster by its "
            f"rank columns in the forward, the adjoint and the sampler); rho "
            f"training past that runs rank-chunked (ops/rank.py); sampling "
            f"and scoring there are not ported yet (ROADMAP queue B)")


def rho_sample_cta_bytes(D: int, rank: int, C: int) -> int:
    """The sampler CTA's shared memory at the buffers its launch takes on
    the current card (the kernel's own count)."""
    lib = _build.library()
    return lib.amt_rho_sample_smem_bytes(
        D, rank, C, lib.amt_rho_sample_buffers(D, rank, C))


def rho_sample_fits(D: int, rank: int, device) -> bool:
    """Does the sampler's CTA fit the CUDA ``device``'s opt-in shared
    memory at some cluster the card holds? (The rule's C for one chain is
    the largest that does; 1 where none does.)"""
    C = _rho_cluster("rho_sample_fits", "sample", D, 1, rank, device, None)
    optin = torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin
    return rho_sample_cta_bytes(D, rank, C) <= optin


@torch.no_grad()
def rho_sample_block(ab, bb, xb, pc, ps, t0, noise, inv_a, *, dt: float,
                     norm_eps: float, precision: str = "highest",
                     cluster=None):
    """Running waveform [T, N]: ``rho_sample_block_plain`` for CPU tensors,
    the CUDA kernel ``csrc/rho_sample.cu`` for CUDA tensors, in clusters of
    ``cluster`` CTAs a chain (None: ``rho_cluster_for`` with
    ``kernel="sample"``; every cluster gives the same bits; the last
    launch's in ``.cluster``)."""
    rank = _rank_of("rho_sample_block", t0.shape[1], noise.shape[1])
    if _cuda_or_raise("rho_sample_block", noise):
        _check_rho_cluster("rho_sample_block", cluster, rank)
        return rho_sample_block_plain(ab, bb, xb, pc, ps, t0, noise, inv_a,
                                      dt=dt, norm_eps=norm_eps,
                                      precision=precision)
    _check_options(precision)
    T, N = noise.shape
    D = pc.shape[0]
    _check_rho_shape("rho_sample_block", D, rank)
    n = 2 * D
    _check_inputs("rho_sample_block", noise.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), xb=(xb, (n, n)), pc=(pc, (D,)),
        ps=(ps, (D,)), t0=(t0, (n, N * rank)), noise=(noise, (T, N)),
        inv_a=(inv_a, (1,))))
    C = _rho_cluster("rho_sample_block", "sample", D, N, rank, noise.device,
                     cluster)
    lib = _build.library()
    _check_smem("rho_sample_block", rho_sample_cta_bytes(D, rank, C),
                noise.device, D)
    wave = torch.empty_like(noise)
    if T == 0 or N == 0:
        return wave
    err = lib.amt_rho_sample(
        _ptr(ab), _ptr(bb), _ptr(xb), _ptr(pc), _ptr(ps), _ptr(t0),
        _ptr(noise), _ptr(inv_a), _ptr(wave), D, T, N, rank, dt, norm_eps,
        PRECISIONS.index(precision), C, _stream_ptr(noise.device))
    _build.check(lib, err, "rho_sample_block")
    rho_sample_block.launches += 1
    rho_sample_block.cluster = C
    return wave


rho_sample_block.launches = 0
rho_sample_block.cluster = None


def rho_nll_inputs(params, cfg: CMPSConfig, signals) -> dict:
    """Kernel inputs of ``rho_nll_block`` from parameters and waveforms
    [B, T] (the TPU's ``pallas_block.rho_nll_block`` preamble); ``se`` is
    per example, [T-1, B]."""
    if not supports_block(cfg):
        raise ValueError(
            f"block layout requires bond_dim % 4 == 0, got {cfg.bond_dim}")
    with torch.no_grad():
        cc = make_constants(params, cfg)
        se = (signals[:, 1:] - signals[:, :-1]).T / cc.A      # [T-1, B]
        ab, bb, xb = _rho_block_constants(cc)
        t0 = _rho_block_t0(cc, *rho_factor_inputs(params, cfg,
                                                  signals.shape[0]))
        log_eps = cfg.log_eps if cfg.log_eps > 0 else float("-inf")
        return dict(ab=_as_kernel_input(ab), bb=_as_kernel_input(bb),
                    xb=_as_kernel_input(xb), t0=_as_kernel_input(t0),
                    se=_as_kernel_input(se), log_eps=float(log_eps),
                    norm_eps=float(cfg.norm_eps))


def _rho_chain_plain(ab, bb, xb, t0, se, *, log_eps, norm_eps, unroll,
                     precision, defer_norm, on_step=None, ck=None):
    """The rho forward step loop shared by the NLL, the training forwards
    and the recompute: per-example NLL [B]; ``on_step(k, y, tr)`` sees each
    post-step state y_k [2D, B*rank] and its per-example trace [B];
    ``ck[j]`` receives the factor entering step j * unroll."""
    prep, dotf = _make_dot_ops(precision)
    rank = _rank_of("rho NLL", t0.shape[1], se.shape[1])
    abp, bbp, xbp = prep(ab), prep(bb), prep(xb)
    t = t0
    acc = torch.zeros_like(se[0])
    trp = torch.ones_like(acc)
    for k in range(se.shape[0]):
        if ck is not None and k % unroll == 0:
            ck[k // unroll] = t
        s = se[k]
        tp = prep(t)
        y = dotf(abp, tp) + _lanes(s, rank) * dotf(bbp, tp)
        gx = dotf(xbp, prep(y))              # X^T H'' (expectation)
        ehat = _segment_sum(y * gx, rank)
        tr = _segment_sum(y * y, rank)
        if on_step is not None:
            on_step(k, y, tr)
        e = ehat / torch.clamp(trp, min=norm_eps) if defer_norm else ehat
        acc = acc - torch.log(torch.clamp(1.0 + e * s, min=log_eps))
        if _renorms(k, unroll, defer_norm):
            t = y * _lanes(torch.rsqrt(torch.clamp(tr, min=norm_eps)), rank)
            trp = torch.ones_like(acc)
        else:
            t, trp = y, tr
    return acc


@torch.no_grad()
def rho_nll_block_plain(ab, bb, xb, t0, se, *, log_eps: float,
                        norm_eps: float, unroll: int = 16,
                        precision: str = "highest",
                        defer_norm: bool = False):
    """Per-example NLL [B] over the per-example increments se [T-1, B]
    (already divided by A) of factors t0 [2D, B * rank]. ``defer_norm``
    divides the expectation by the previous step's trace and renormalises
    at every ``unroll``-th step, as the TPU kernel does at its block exits.
    Plain PyTorch, any device."""
    return _rho_chain_plain(ab, bb, xb, t0, se, log_eps=log_eps,
                            norm_eps=norm_eps, unroll=unroll,
                            precision=precision, defer_norm=defer_norm)


def _rho_fwd_bytes(lib, D: int, rank: int, C: int,
                   recompute: bool = False) -> int:
    """The forward CTA's shared memory at the buffers its launch takes on
    the current card."""
    r = int(recompute)
    return lib.amt_rho_fwd_smem_bytes(
        D, rank, C, r, lib.amt_rho_fwd_buffers(D, rank, C, r))


def _rho_fwd_checks(name, ab, bb, xb, t0, se, precision, unroll):
    _check_options(precision, unroll)
    n_steps, B = se.shape
    n = t0.shape[0]
    D = n // 2
    rank = _rank_of(name, t0.shape[1], B)
    _check_rho_shape(name, D, rank)
    _check_inputs(name, se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), xb=(xb, (n, n)),
        t0=(t0, (n, B * rank)), se=(se, (n_steps, B))))
    return n_steps, B, D, rank


@torch.no_grad()
def rho_nll_block(ab, bb, xb, t0, se, *, log_eps: float, norm_eps: float,
                  unroll: int = 16, precision: str = "highest",
                  defer_norm: bool = False, cluster=None):
    """Per-example NLL [B]: ``rho_nll_block_plain`` for CPU tensors, the
    CUDA kernel ``csrc/rho_nll.cu`` for CUDA tensors, in clusters of
    ``cluster`` CTAs an example (None: ``rho_cluster_for``; every cluster
    gives the same bits; the last launch's in ``.cluster``)."""
    if _cuda_or_raise("rho_nll_block", se):
        _check_rho_cluster("rho_nll_block", cluster,
                           _rank_of("rho_nll_block", t0.shape[1],
                                    se.shape[1]))
        return rho_nll_block_plain(ab, bb, xb, t0, se, log_eps=log_eps,
                                   norm_eps=norm_eps, unroll=unroll,
                                   precision=precision,
                                   defer_norm=defer_norm)
    n_steps, B, D, rank = _rho_fwd_checks("rho_nll_block", ab, bb, xb, t0,
                                          se, precision, unroll)
    C = _rho_cluster("rho_nll_block", "fwd", D, B, rank, se.device, cluster)
    lib = _build.library()
    _check_smem("rho_nll_block", _rho_fwd_bytes(lib, D, rank, C),
                se.device, D)
    loss = se.new_empty((B,))
    if B == 0:
        return loss
    err = lib.amt_rho_nll(
        _ptr(ab), _ptr(bb), _ptr(xb), _ptr(t0), _ptr(se), _ptr(loss), D,
        n_steps, B, rank, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), C,
        _stream_ptr(se.device))
    _build.check(lib, err, "rho_nll_block")
    rho_nll_block.launches += 1
    rho_nll_block.cluster = C
    return loss


rho_nll_block.launches = 0
rho_nll_block.cluster = None


# The rho training functions follow the psi ones (see above): the forward
# streams every post-step factor y_k [n_steps, 2D, B*rank] and the
# per-example trace trs [n_steps, B]; the adjoint runs the reverse chain
# over them; the cotangents reduce the streams to dAb, dBb, dXb.

@torch.no_grad()
def rho_train_fwd_plain(ab, bb, xb, t0, se, *, log_eps: float,
                        norm_eps: float, unroll: int = 16,
                        precision: str = "highest",
                        defer_norm: bool = False):
    """(loss [B], ys [n_steps, 2D, B*rank], trs [n_steps, B]): the NLL of
    ``rho_nll_block_plain`` plus every post-step factor and its trace.
    Plain PyTorch, any device."""
    n_steps, B = se.shape
    ys = se.new_empty((n_steps,) + tuple(t0.shape))
    trs = se.new_empty((n_steps, B))

    def keep(k, y, tr):
        ys[k] = y
        trs[k] = tr

    loss = _rho_chain_plain(ab, bb, xb, t0, se, log_eps=log_eps,
                            norm_eps=norm_eps, unroll=unroll,
                            precision=precision, defer_norm=defer_norm,
                            on_step=keep)
    return loss, ys, trs


@torch.no_grad()
def rho_train_fwd_ckpt_plain(ab, bb, xb, t0, se, *, log_eps: float,
                             norm_eps: float, unroll: int = 16,
                             precision: str = "highest",
                             defer_norm: bool = False):
    """(loss [B], ck [n_blocks, 2D, B*rank]): the NLL of
    ``rho_nll_block_plain`` and the factor entering every block of
    ``unroll`` steps, after the previous block's exit renorm (the TPU
    forward's checkpoints). Plain PyTorch, any device."""
    ck = se.new_empty((n_blocks(se.shape[0], unroll),) + tuple(t0.shape))
    loss = _rho_chain_plain(ab, bb, xb, t0, se, log_eps=log_eps,
                            norm_eps=norm_eps, unroll=unroll,
                            precision=precision, defer_norm=defer_norm,
                            ck=ck)
    return loss, ck


@torch.no_grad()
def rho_recompute_plain(ab, bb, xb, ck, se, *, norm_eps: float,
                        unroll: int = 16, precision: str = "highest",
                        defer_norm: bool = False):
    """(ys [n_steps, 2D, B*rank], trs [n_steps, B]) of a time segment that
    starts at a block entry, every block re-run from its checkpoint ck[j]:
    what ``rho_train_fwd_plain`` streams over those steps. Plain PyTorch,
    any device."""
    n_steps = se.shape[0]
    ys = se.new_empty((n_steps,) + tuple(ck.shape[1:]))
    trs = torch.empty_like(se)
    for j in range(n_blocks(n_steps, unroll)):
        k0 = j * unroll

        def keep(k, y, tr):
            ys[k0 + k] = y
            trs[k0 + k] = tr

        _rho_chain_plain(ab, bb, xb, ck[j], se[k0:k0 + unroll],
                         log_eps=float("-inf"), norm_eps=norm_eps,
                         unroll=unroll, precision=precision,
                         defer_norm=defer_norm, on_step=keep)
    return ys, trs


def _rho_input_state(k, t0, ys, scales):
    """t_k [2D, B*rank]: t0, or y_{k-1} times its lane scale."""
    return t0 if k == 0 else ys[k - 1] * scales[k - 1]


@torch.no_grad()
def rho_train_bwd_plain(ab, bb, xb, t0, se, g, ys, trs, *, log_eps: float,
                        norm_eps: float, unroll: int = 16,
                        precision: str = "highest",
                        defer_norm: bool = False, dtfin=None):
    """Adjoint of ``rho_train_fwd`` for the loss cotangent g [B] and dtfin
    [2D, B*rank], the cotangent of the factor after the last step (zero
    when None): (dse [n_steps, B], dt0 [2D, B*rank],
    dy [n_steps, 2D, B*rank], dehat [n_steps, B]).

    Step k in reverse, with dt the cotangent of t_{k+1}: the chain-free
    tail (the TPU's batched precompute, ``pallas_block.py`` :1516-1562)
    gives e, darg, dehat = de / trp and q = dehat (Xb y + Xb^T y); a
    renormalising step seeds dtr from dt, another takes step k+1's dtr_new
    (the cotangent of tr_k through e_{k+1}); then
    dy = dt + (2 dtr y + q), dt <- Ab^T dy + s (Bb^T dy) and
    dse = darg e + sum((Bb^T dy) .* t_k), all per example. Plain PyTorch,
    any device."""
    prep, dotf, _ = _make_dot_ops_bwd(precision)
    n_steps, B = se.shape
    rank = _rank_of("rho_train_bwd", t0.shape[1], B)
    scales = _state_scales(_lanes(trs, rank), norm_eps=norm_eps,
                           unroll=unroll, defer_norm=defer_norm)
    xbp, xbtp = prep(xb), prep(xb.T)
    abT, bbT = prep(ab.T), prep(bb.T)
    dt = torch.zeros_like(t0) if dtfin is None else dtfin
    dtrn = torch.zeros_like(g)
    dy_all = torch.empty_like(ys)
    dse = torch.empty_like(se)
    dehat_all = torch.empty_like(se)
    one = torch.ones_like(g)
    for k in reversed(range(n_steps)):
        y, s = ys[k], se[k]
        # the chain-free tail of step k
        inside = defer_norm and k % unroll != 0
        trp = trs[k - 1] if inside else one
        trp_c = torch.clamp(trp, min=norm_eps)
        py = prep(y)
        gx, xt = dotf(xbp, py), dotf(xbtp, py)
        ehat = _segment_sum(y * gx, rank)
        e = ehat / trp_c if defer_norm else ehat
        arg = torch.clamp(1.0 + e * s, min=log_eps)
        darg = torch.where(arg > log_eps, -g / arg, torch.zeros_like(arg))
        de = darg * s
        dehat = de / trp_c if defer_norm else de
        dtr_new = torch.where(trp > norm_eps, -de * e / trp_c,
                              torch.zeros_like(de))
        q = _lanes(dehat, rank) * (gx + xt)
        # the chain
        if _renorms(k, unroll, defer_norm):
            inv = torch.rsqrt(torch.clamp(trs[k], min=norm_eps))
            dinv = _segment_sum(dt * y, rank)
            dtr = torch.where(trs[k] > norm_eps,
                              -0.5 * dinv * inv * inv * inv,
                              torch.zeros_like(dinv))
            dt = dt * _lanes(inv, rank)
        else:
            dtr = dtrn
        dy = dt + (y * _lanes(2.0 * dtr, rank) + q)
        dy_all[k] = dy
        dehat_all[k] = dehat
        pdy = prep(dy)
        du = dotf(bbT, pdy)                             # Bb^T dy
        tk = _rho_input_state(k, t0, ys, scales)
        dse[k] = darg * e + _segment_sum(du * tk, rank)
        dt = dotf(abT, pdy) + _lanes(s, rank) * du
        dtrn = dtr_new
    return dse, dt, dy_all, dehat_all


@torch.no_grad()
def rho_cotangents_plain(dy, ys, t0, se, trs, dehat, *, norm_eps: float,
                         unroll: int = 16, precision: str = "highest",
                         defer_norm: bool = False):
    """(dAb, dBb, dXb) [2D, 2D]: sums over steps k and columns of dy t^T,
    dy (s t)^T and dehat y y^T (the TPU's dotnt at ``pallas_block.py``
    :1583-1585), from the streams of ``rho_train_fwd`` and
    ``rho_train_bwd``, a chunk of steps at a time. Plain PyTorch, any
    device."""
    prep, _, dotnt = _make_dot_ops_bwd(precision)
    n_steps, B = se.shape
    n, cols = t0.shape
    rank = _rank_of("rho_cotangents", cols, B)
    scales = _state_scales(_lanes(trs, rank), norm_eps=norm_eps,
                           unroll=unroll, defer_norm=defer_norm)
    se_l, dehat_l = _lanes(se, rank), _lanes(dehat, rank)

    def lanes(x):                                       # [2D, steps * cols]
        return x.transpose(0, 1).reshape(n, -1)

    out = [t0.new_zeros((n, n)) for _ in range(3)]
    chunk = 1024
    for k0 in range(0, n_steps, chunk):
        k1 = min(k0 + chunk, n_steps)
        ts = torch.stack([_rho_input_state(k, t0, ys, scales)
                          for k in range(k0, k1)])
        y = ys[k0:k1]
        pdy = prep(lanes(dy[k0:k1]))
        out[0] += dotnt(pdy, prep(lanes(ts)))
        out[1] += dotnt(pdy, prep(lanes(se_l[k0:k1, None, :] * ts)))
        out[2] += dotnt(prep(lanes(dehat_l[k0:k1, None, :] * y)),
                        prep(lanes(y)))
    return tuple(out)


@torch.no_grad()
def rho_train_fwd(ab, bb, xb, t0, se, *, log_eps: float, norm_eps: float,
                  unroll: int = 16, precision: str = "highest",
                  defer_norm: bool = False, cluster=None):
    """(loss [B], ys, trs): ``rho_train_fwd_plain`` for CPU tensors, the
    CUDA kernel ``csrc/rho_train_fwd.cu`` for CUDA tensors, in clusters as
    ``rho_nll_block``."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("rho_train_fwd", se):
        _check_rho_cluster("rho_train_fwd", cluster,
                           _rank_of("rho_train_fwd", t0.shape[1],
                                    se.shape[1]))
        return rho_train_fwd_plain(ab, bb, xb, t0, se, **kw)
    n_steps, B, D, rank = _rho_fwd_checks("rho_train_fwd", ab, bb, xb, t0,
                                          se, precision, unroll)
    C = _rho_cluster("rho_train_fwd", "fwd", D, B, rank, se.device, cluster)
    lib = _build.library()
    _check_smem("rho_train_fwd", _rho_fwd_bytes(lib, D, rank, C),
                se.device, D)
    loss = se.new_empty((B,))
    ys = se.new_empty((n_steps,) + tuple(t0.shape))
    trs = se.new_empty((n_steps, B))
    if B == 0:
        return loss, ys, trs
    err = lib.amt_rho_train_fwd(
        _ptr(ab), _ptr(bb), _ptr(xb), _ptr(t0), _ptr(se), _ptr(loss),
        _ptr(ys), _ptr(trs), D, n_steps, B, rank, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), C,
        _stream_ptr(se.device))
    _build.check(lib, err, "rho_train_fwd")
    rho_train_fwd.launches += 1
    rho_train_fwd.cluster = C
    return loss, ys, trs


rho_train_fwd.launches = 0
rho_train_fwd.cluster = None


@torch.no_grad()
def rho_train_fwd_ckpt(ab, bb, xb, t0, se, *, log_eps: float,
                       norm_eps: float, unroll: int = 16,
                       precision: str = "highest", defer_norm: bool = False,
                       cluster=None):
    """(loss [B], ck): ``rho_train_fwd_ckpt_plain`` for CPU tensors, the
    CUDA kernel ``csrc/rho_train_fwd.cu`` (its checkpoint mode) for CUDA
    tensors, in clusters as ``rho_nll_block``."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm)
    if _cuda_or_raise("rho_train_fwd_ckpt", se):
        _check_rho_cluster("rho_train_fwd_ckpt", cluster,
                           _rank_of("rho_train_fwd_ckpt", t0.shape[1],
                                    se.shape[1]))
        return rho_train_fwd_ckpt_plain(ab, bb, xb, t0, se, **kw)
    n_steps, B, D, rank = _rho_fwd_checks("rho_train_fwd_ckpt", ab, bb, xb,
                                          t0, se, precision, unroll)
    C = _rho_cluster("rho_train_fwd_ckpt", "fwd", D, B, rank, se.device,
                     cluster)
    lib = _build.library()
    _check_smem("rho_train_fwd_ckpt", _rho_fwd_bytes(lib, D, rank, C),
                se.device, D)
    loss = se.new_empty((B,))
    ck = se.new_empty((n_blocks(n_steps, unroll),) + tuple(t0.shape))
    if B == 0:
        return loss, ck
    err = lib.amt_rho_train_fwd_ckpt(
        _ptr(ab), _ptr(bb), _ptr(xb), _ptr(t0), _ptr(se), _ptr(loss),
        _ptr(ck), D, n_steps, B, rank, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), C,
        _stream_ptr(se.device))
    _build.check(lib, err, "rho_train_fwd_ckpt")
    rho_train_fwd_ckpt.launches += 1
    rho_train_fwd_ckpt.cluster = C
    return loss, ck


rho_train_fwd_ckpt.launches = 0
rho_train_fwd_ckpt.cluster = None


@torch.no_grad()
def rho_recompute(ab, bb, xb, ck, se, *, norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False,
                  cluster=None):
    """(ys, trs) of a segment: ``rho_recompute_plain`` for CPU tensors, the
    CUDA kernel ``csrc/rho_recompute.cu`` for CUDA tensors, in clusters of
    ``cluster`` CTAs an (example, block) (None: ``rho_cluster_for`` over
    the B x blocks clusters; the last launch's in ``.cluster``)."""
    kw = dict(norm_eps=norm_eps, unroll=unroll, precision=precision,
              defer_norm=defer_norm)
    if _cuda_or_raise("rho_recompute", se):
        _check_rho_cluster("rho_recompute", cluster,
                           _rank_of("rho_recompute", ck.shape[2],
                                    se.shape[1]))
        return rho_recompute_plain(ab, bb, xb, ck, se, **kw)
    _check_options(precision, unroll)
    n_steps, B = se.shape
    n, cols = ck.shape[1:]
    D = n // 2
    rank = _rank_of("rho_recompute", cols, B)
    _check_rho_shape("rho_recompute", D, rank)
    _check_inputs("rho_recompute", se.device, dict(
        ab=(ab, (n, n)), bb=(bb, (n, n)), xb=(xb, (n, n)),
        ck=(ck, (n_blocks(n_steps, unroll), n, cols)),
        se=(se, (n_steps, B))))
    C = _rho_cluster("rho_recompute", "recompute", D,
                     B * n_blocks(n_steps, unroll), rank, se.device, cluster)
    lib = _build.library()
    _check_smem("rho_recompute", _rho_fwd_bytes(lib, D, rank, C, True),
                se.device, D)
    ys = se.new_empty((n_steps, n, cols))
    trs = torch.empty_like(se)
    if B == 0 or n_steps == 0:
        return ys, trs
    err = lib.amt_rho_recompute(
        _ptr(ab), _ptr(bb), _ptr(xb), _ptr(ck), _ptr(se), _ptr(ys),
        _ptr(trs), D, n_steps, B, rank, unroll, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), C,
        _stream_ptr(se.device))
    _build.check(lib, err, "rho_recompute")
    rho_recompute.launches += 1
    rho_recompute.cluster = C
    return ys, trs


rho_recompute.launches = 0
rho_recompute.cluster = None


@torch.no_grad()
def rho_train_bwd(ab, bb, xb, t0, se, g, ys, trs, *, log_eps: float,
                  norm_eps: float, unroll: int = 16,
                  precision: str = "highest", defer_norm: bool = False,
                  dtfin=None, cluster=None):
    """(dse, dt0, dy, dehat): ``rho_train_bwd_plain`` for CPU tensors, the
    CUDA kernels of ``csrc/rho_train_bwd.cu`` (the chain-free tail over all
    steps at once, then the serial chain in clusters of ``cluster`` CTAs
    an example: None takes ``rho_cluster_for``; every cluster gives the
    same bits; the last launch's in ``.cluster``) for CUDA tensors."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm, dtfin=dtfin)
    if _cuda_or_raise("rho_train_bwd", se):
        _check_rho_cluster("rho_train_bwd", cluster,
                           _rank_of("rho_train_bwd", t0.shape[1],
                                    se.shape[1]))
        return rho_train_bwd_plain(ab, bb, xb, t0, se, g, ys, trs, **kw)
    n_steps, B, D, rank = _rho_fwd_checks("rho_train_bwd", ab, bb, xb, t0,
                                          se, precision, unroll)
    n = 2 * D
    _check_inputs("rho_train_bwd", se.device, dict(
        g=(g, (B,)), ys=(ys, (n_steps, n, B * rank)),
        trs=(trs, (n_steps, B))))
    if dtfin is not None:
        _check_inputs("rho_train_bwd", se.device,
                      dict(dtfin=(dtfin, (n, B * rank))))
    C = _rho_cluster("rho_train_bwd", "chain", D, B, rank, se.device,
                     cluster)
    lib = _build.library()
    _check_smem("rho_train_bwd", max(
        lib.amt_rho_train_bwd_smem_bytes(D, rank),
        lib.amt_rho_chain_smem_bytes(D, rank, C)), se.device, D)
    dse = torch.empty_like(se)
    dt0 = torch.empty_like(t0)
    dy = torch.empty_like(ys)
    dehat = torch.empty_like(se)
    dtrn = torch.empty_like(se)
    if B == 0:
        return dse, dt0, dy, dehat
    if dtfin is None:
        dtfin = torch.zeros_like(t0)
    err = lib.amt_rho_train_bwd(
        _ptr(ab), _ptr(bb), _ptr(xb), _ptr(t0), _ptr(se), _ptr(g), _ptr(ys),
        _ptr(trs), _ptr(dtfin), _ptr(dse), _ptr(dt0), _ptr(dy), _ptr(dehat),
        _ptr(dtrn), D, n_steps, B, rank, unroll, log_eps, norm_eps,
        PRECISIONS.index(precision), int(defer_norm), C,
        _stream_ptr(se.device))
    _build.check(lib, err, "rho_train_bwd")
    rho_train_bwd.launches += 1
    rho_train_bwd.cluster = C
    return dse, dt0, dy, dehat


rho_train_bwd.launches = 0
rho_train_bwd.cluster = None


@torch.no_grad()
def rho_cotangents(dy, ys, t0, se, trs, dehat, *, norm_eps: float,
                   unroll: int = 16, precision: str = "highest",
                   defer_norm: bool = False):
    """(dAb, dBb, dXb): ``rho_cotangents_plain`` for CPU tensors; for CUDA
    tensors the kernel ``csrc/psi_cotangents.cu`` over the B*rank lanes in
    groups of rank (one se, trace and dehat an example): its dRb = sum
    dehat y y^T is dXb, and its state rebuild is the rho forward's. The
    launch counts here only."""
    kw = dict(norm_eps=norm_eps, unroll=unroll, precision=precision,
              defer_norm=defer_norm)
    if _cuda_or_raise("rho_cotangents", se):
        return rho_cotangents_plain(dy, ys, t0, se, trs, dehat, **kw)
    rank = _rank_of("rho_cotangents", t0.shape[1], se.shape[1])
    return _cotangents_kernel(rho_cotangents, dy, ys, t0, se, trs, dehat,
                              gs=rank, gn=rank, w_scale=1.0, **kw)


rho_cotangents.launches = 0


@torch.no_grad()
def rho_recompute_bwd_plain(ab, bb, xb, ck, se, g, *, log_eps: float,
                            norm_eps: float, unroll: int = 16,
                            precision: str = "highest",
                            defer_norm: bool = False,
                            segment: Optional[int] = None):
    """The recompute adjoint of ``rho_train_fwd_ckpt`` for the loss
    cotangent g [B]: (dse [n_steps, B], dt0 [2D, B*rank], dAb, dBb, dXb)
    from the checkpoints ck, with no state stream (the TPU's
    ``_make_rho_bwd_kernel_batched`` with ``stream=False`` :1438 and
    ``_make_rho_bwd_kernel_defer`` :1790, one function; and
    ``_make_rho_bwd_kernel`` :1689 at ``defer_norm=False``), over time
    segments of ``segment`` steps: ``rho_recompute_plain``,
    ``rho_train_bwd_plain`` and ``rho_cotangents_plain`` on each. Plain
    PyTorch, any device."""
    return _recompute_bwd(
        (rho_recompute_plain, rho_train_bwd_plain, rho_cotangents_plain),
        ab, bb, xb, ck, se, g, log_eps=log_eps, norm_eps=norm_eps,
        unroll=unroll, precision=precision, defer_norm=defer_norm,
        segment=segment)


@torch.no_grad()
def rho_recompute_bwd(ab, bb, xb, ck, se, g, *, log_eps: float,
                      norm_eps: float, unroll: int = 16,
                      precision: str = "highest", defer_norm: bool = False,
                      segment: Optional[int] = None):
    """(dse, dt0, dAb, dBb, dXb): ``rho_recompute_bwd_plain`` for CPU
    tensors; for CUDA tensors the same segments through the kernels
    ``rho_recompute``, ``rho_train_bwd`` (its dt carried in) and
    ``rho_cotangents``, each counting its own launches."""
    kw = dict(log_eps=log_eps, norm_eps=norm_eps, unroll=unroll,
              precision=precision, defer_norm=defer_norm, segment=segment)
    if _cuda_or_raise("rho_recompute_bwd", se):
        return rho_recompute_bwd_plain(ab, bb, xb, ck, se, g, **kw)
    return _recompute_bwd((rho_recompute, rho_train_bwd, rho_cotangents),
                          ab, bb, xb, ck, se, g, **kw)


class RhoBlockNLL(torch.autograd.Function):
    """Per-example rho NLL [B] over the block constants with a kernel
    adjoint: the counterpart of ``_rho_block_factory``'s custom VJP
    (``pallas_block.py:2090-2110``). ``forward(ab, bb, xb, t0, se, opts,
    segment)`` returns loss [B] for per-example increments se [T-1, B];
    ``backward(g)`` returns (dAb, dBb, dXb, dt0, dse). ``opts`` and
    ``segment`` as in ``PsiBlockNLL``."""

    @staticmethod
    def forward(ctx, ab, bb, xb, t0, se, opts, segment):
        ins = [_as_kernel_input(x) for x in (ab, bb, xb, t0, se)]
        ctx.opts, ctx.segment = opts, segment
        if segment is None:
            loss, ys, trs = rho_train_fwd(*ins, **opts)
            ctx.save_for_backward(*ins, ys, trs)
        else:
            loss, ck = rho_train_fwd_ckpt(*ins, **opts)
            ctx.save_for_backward(*ins, ck)
        return loss

    @staticmethod
    def backward(ctx, g):
        opts, g = ctx.opts, _as_kernel_input(g)
        if ctx.segment is not None:
            ab, bb, xb, _, se, ck = ctx.saved_tensors
            dse, dt0, dab, dbb, dxb = rho_recompute_bwd(
                ab, bb, xb, ck, se, g, segment=ctx.segment, **opts)
            return dab, dbb, dxb, dt0, dse, None, None
        ab, bb, xb, t0, se, ys, trs = ctx.saved_tensors
        dse, dt0, dy, dehat = rho_train_bwd(ab, bb, xb, t0, se, g, ys, trs,
                                            **opts)
        dab, dbb, dxb = rho_cotangents(
            dy, ys, t0, se, trs, dehat, norm_eps=opts["norm_eps"],
            unroll=opts["unroll"], precision=opts["precision"],
            defer_norm=opts["defer_norm"])
        return dab, dbb, dxb, dt0, dse, None, None


def rho_nll_block_trainable(params, cfg: CMPSConfig, signals, *,
                            unroll: int = 16, precision: str = "highest",
                            defer_norm: bool = False):
    """Differentiable mean rho NLL of waveforms [B, T] in
    purification-factor form (semantics of ``core.rho_nll``; the TPU's
    ``pallas_block.rho_nll_block_trainable``) at the real rank, with no
    padding lanes. The block constants, initial factor and increments are
    built with autograd; the loss and its adjoint go through
    ``RhoBlockNLL``: the streamed-states pair where ``auto_stream`` lets
    the stream run, else the checkpoint forward and the recompute adjoint
    in time segments of ``recompute_segment_steps``."""
    if not supports_block(cfg):
        raise ValueError(
            f"block layout requires bond_dim % 4 == 0, got {cfg.bond_dim}")
    _check_options(precision, unroll)
    B, T = signals.shape
    rank = params.Wx.shape[0]
    segment = _stream_or_segment(cfg, B * rank, T, signals.device, unroll)
    cc = make_constants(params, cfg)
    se = (signals[:, 1:] - signals[:, :-1]).T / cc.A      # [T-1, B]
    ab, bb, xb = _rho_block_constants(cc)
    t0 = _rho_block_t0(cc, *rho_factor_inputs(params, cfg, B))
    log_eps = cfg.log_eps if cfg.log_eps > 0 else float("-inf")
    return RhoBlockNLL.apply(ab, bb, xb, t0, se, dict(
        log_eps=float(log_eps), norm_eps=float(cfg.norm_eps), unroll=unroll,
        precision=precision, defer_norm=defer_norm), segment).mean()
