"""The samplers' carried recursion and their layout rules (CPU).

psi's block sampler (``ops/block.psi_sample_block_plain``, the order of
``csrc/psi_sample.cu``), psi's split sampler
(``ops/split.psi_sample_split_plain``, the order of
``csrc/psi_split_sample.cu``) and rho's split sampler
(``ops/split.rho_sample_split_plain``, the order of
``csrc/rho_split_sample.cu``) carry the state unnormalised and apply the
step's scale after its products. Here each is held, in float64, to the
recursion in the TPU kernels' order (renormalise at every step, the
expectation on the normalised state), written out below: the two are the
same recursion in exact arithmetic, so they agree to rounding. A state
that enters unnormalised shows that step 0 takes it as given (c = 1) in
both. Then the rules that pick each kernel's body or layout, pure
functions of the shape, and the shapes the samplers take.
"""
import numpy as np
import pytest
import torch

from audio_mps_tpu_torch.config import CMPSConfig
from audio_mps_tpu_torch.models.params import init_psi, init_rho
from audio_mps_tpu_torch.ops import block, split

T = 200
CARRY_TOL = 1e-12   # of max|w|, float64 over T steps


def _noise(n, seed=7):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(0.05 * rng.standard_normal((T, n)))


def _double(inputs):
    return {k: v.double() if torch.is_tensor(v) else v
            for k, v in inputs.items()}


def psi_jax_order(ab, bb, pc, ps, t0, noise, inv_a, *, dt, norm_eps):
    """pallas_block._make_psi_sample_kernel's step: the twist on Bb t of
    the normalised state, then renormalise the update."""
    D = pc.shape[0]
    pc, ps = pc[:, None], ps[:, None]
    t, samp, out = t0, 0.0, []
    for k in range(noise.shape[0]):
        ru = bb @ t
        wr = pc * ru[:D] - ps * ru[D:]
        wi = pc * ru[D:] + ps * ru[:D]
        e = 2.0 * torch.sum(t[:D] * wr + t[D:] * wi, dim=0)
        inc = e * dt + noise[k]
        samp = samp + inc
        out.append(samp)
        y = ab @ t + (inc * inv_a) * ru
        t = y * torch.rsqrt(torch.clamp(torch.sum(y * y, dim=0),
                                        min=norm_eps))
    return torch.stack(out)


def psi_split_jax_order(cr, ci, rr, ri, pc, ps, s0r, s0i, noise, inv_a, *,
                        dt, norm_eps):
    """pallas_scan._make_psi_sample_kernel's step: the expectation on the
    current state, the update reusing R psi, renormalise, rotate by
    conj(p)."""
    def cdot(mr, mi, vr, vi):
        return mr @ vr - mi @ vi, mr @ vi + mi @ vr

    pc, ps = pc[:, None], ps[:, None]
    pr, pi, samp, out = s0r, s0i, 0.0, []
    for k in range(noise.shape[0]):
        rur, rui = cdot(rr, ri, pr, pi)
        g1r, g1i = cdot(cr, ci, pr, pi)
        inc = 2.0 * torch.sum(pr * rur + pi * rui, dim=0) * dt + noise[k]
        samp = samp + inc
        out.append(samp)
        s = inc * inv_a
        yr, yi = g1r + s * rur, g1i + s * rui
        inv = torch.rsqrt(torch.clamp(torch.sum(yr * yr + yi * yi, dim=0),
                                      min=norm_eps))
        yr, yi = yr * inv, yi * inv
        pr, pi = yr * pc + yi * ps, yi * pc - yr * ps
    return torch.stack(out)


def rho_split_jax_order(ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i,
                        noise, inv_a, *, dt, norm_eps):
    """pallas_scan._make_rho_sample_kernel's step: the expectation on the
    current factor, the update, renormalise by the trace, rotate by p."""
    rank = h0r.shape[1] // noise.shape[1]

    def cdot(mr, mi, vr, vi):
        return mr @ vr - mi @ vi, mr @ vi + mi @ vr

    def seg(x):
        return x.sum(0).reshape(-1, rank).sum(-1)

    def lanes(v):
        return v.repeat_interleave(rank)

    pc, ps = pc[:, None], ps[:, None]
    hr, hi, samp, out = h0r, h0i, 0.0, []
    for k in range(noise.shape[0]):
        gxr, gxi = cdot(xtr, xti, hr, hi)
        inc = seg(hr * gxr + hi * gxi) * dt + noise[k]
        samp = samp + inc
        out.append(samp)
        s = lanes(inc * inv_a)
        a1r, a1i = cdot(ccr, cci, hr, hi)
        a2r, a2i = cdot(rcr, rci, hr, hi)
        yr, yi = a1r + s * a2r, a1i + s * a2i
        inv = lanes(torch.rsqrt(torch.clamp(seg(yr * yr + yi * yi),
                                            min=norm_eps)))
        yr, yi = yr * inv, yi * inv
        hr, hi = yr * pc - yi * ps, yr * ps + yi * pc
    return torch.stack(out)


def _close(got, want):
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= CARRY_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("scale", [1.0, 1.7])
def test_psi_carried_recursion_is_the_tpu_order(D, scale):
    cfg = CMPSConfig(bond_dim=D)
    p = init_psi(torch.Generator().manual_seed(D), cfg, device="cpu")
    ins = _double(block.psi_sample_inputs(p, cfg, _noise(3)))
    ins["t0"] = ins["t0"] * scale
    got = block.psi_sample_block_plain(**ins)
    want = psi_jax_order(**ins)
    assert got.dtype == torch.float64 and got.shape == (T, 3)
    _close(got, want)


def _unit_phase(ins):
    """p is a phase: |p .* y| = |y| is what lets the state carry its norm
    through the rotation; its fp32 values are unit to rounding (~1e-7), so
    in float64 it is taken normalised."""
    mod = torch.hypot(ins["pc"], ins["ps"])
    ins["pc"], ins["ps"] = ins["pc"] / mod, ins["ps"] / mod


@pytest.mark.parametrize("D", [6, 10, 40, 70])
@pytest.mark.parametrize("scale", [1.0, 1.7])
def test_psi_split_carried_recursion_is_the_tpu_order(D, scale):
    """One warp a chain (D=6, 10) and a CTA of two and three warps (D=40,
    70), each from a state as given and from one scaled by 1.7."""
    cfg = CMPSConfig(bond_dim=D)
    p = init_psi(torch.Generator().manual_seed(D), cfg, device="cpu")
    ins = _double(split.psi_split_inputs(p, cfg, _noise(3), noise=True))
    _unit_phase(ins)
    ins["s0r"] = ins["s0r"] * scale
    ins["s0i"] = ins["s0i"] * scale
    got = split.psi_sample_split_plain(**ins)
    want = psi_split_jax_order(**ins)
    assert got.dtype == torch.float64 and got.shape == (T, 3)
    _close(got, want)


@pytest.mark.parametrize("D, rank", [(6, 3), (10, 10)])
@pytest.mark.parametrize("scale", [1.0, 1.7])
def test_rho_split_carried_recursion_is_the_tpu_order(D, rank, scale):
    cfg = CMPSConfig(bond_dim=D, initial_rank=rank)
    p = init_rho(torch.Generator().manual_seed(D + rank), cfg, device="cpu")
    ins = _double(split.rho_split_inputs(p, cfg, _noise(2), noise=True))
    _unit_phase(ins)
    ins["h0r"] = ins["h0r"] * scale
    ins["h0i"] = ins["h0i"] * scale
    got = split.rho_sample_split_plain(**ins)
    want = rho_split_jax_order(**ins)
    assert got.dtype == torch.float64 and got.shape == (T, 2)
    _close(got, want)


# ---------------------------------------------------------------------------
# The rules: pure functions of the shape

def _parent_psi_sample_bytes(D):
    """The block sampler's shared memory before the quad body: Ab^T, Bb^T
    and three [2D] vectors with 64 reduction floats."""
    n = 2 * D
    return 2 * n * n * 4 + (3 * n + 64) * 4


@pytest.mark.parametrize("D", [8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88])
def test_psi_sample_body_rule(D):
    """quad to D=64, row at 72 and 80, and past them the cluster body
    (csrc/psi_cluster_sample.cu), whose bytes are ops/cluster.py's; the
    one-CTA bodies' bytes at every D."""
    body = block.psi_sample_body(D)
    assert body == ("quad" if D <= 64 else "row" if D <= 80 else "cluster")
    assert body == block.psi_sample_body(D)
    quad_bytes = block.psi_sample_smem_bytes(D, "quad")
    assert quad_bytes == 4 * (64 + 16 * block.PSI_QUAD_PITCH + 4 * D)
    row_bytes = block.psi_sample_smem_bytes(D, "row")
    assert row_bytes == 4 * (64 + 12 * D + 8 * D * D)
    assert block.psi_sample_smem_bytes(D) == (quad_bytes if body == "quad"
                                              else row_bytes)


def test_psi_sampler_takes_the_shapes_it_took():
    """Every D % 8 == 0 up to 80 fits one H100 block, 88 and past do not:
    the same D as the single-body sampler's shared memory allowed."""
    for D in range(8, 201, 8):
        fits = block.psi_sample_smem_bytes(D) <= block.H100_SMEM_OPTIN
        assert fits == (_parent_psi_sample_bytes(D)
                        <= block.H100_SMEM_OPTIN)
        assert fits == (D <= 80)


def test_psi_split_sampler_takes_the_shapes_it_took():
    """The split sampler's CTA is the first design's bytes at every D (C
    and R, two [D] vectors and two 32-float reduction buffers then; C and
    R packed, u as float2 and 32 float2 parts now), so it fits one H100
    block exactly to D=120, as before."""
    for D in range(1, 200):
        first = 4 * 4 * D * D + (2 * D + 64) * 4
        assert split.psi_split_sample_smem_bytes(D) == first
        fits = first <= block.H100_SMEM_OPTIN
        assert fits == (D <= 120)


@pytest.mark.parametrize("D, rank, want", [
    (1, 1, (32, 1)),
    (6, 3, (32, 1)),
    (10, 10, (128, 1)),
    (12, 3, (64, 1)),
    (20, 20, (416, 1)),
    (32, 32, (1024, 1)),
    (33, 33, (1024, 2)),
    (45, 45, (1024, 2)),
    (46, 46, (1024, 4)),
    (64, 64, (1024, 4)),
    (7, 150, (1024, 2)),
    (40, 110, (1024, 8)),
])
def test_rho_split_sample_layout_rule(D, rank, want):
    """The element layout: D rank threads rounded to warps, at most 1024,
    each on the fewest elements, a power of 2, that cover the segment."""
    lay = split.rho_split_sample_layout(D, rank)
    assert tuple(lay) == want
    assert lay == split.rho_split_sample_layout(D, rank)
    assert lay.threads % 32 == 0
    assert lay.threads * lay.elems >= D * rank
    assert lay.elems == 1 or lay.threads * lay.elems // 2 < D * rank


def test_rho_split_sample_layout_refusals():
    """Past 8 elements a thread (past the ceiling) the rule raises."""
    with pytest.raises(ValueError, match="past 8"):
        split.rho_split_sample_layout(100, 100)
    assert split.rho_split_sample_ceiling_bytes(100, 100) > \
        block.H100_SMEM_OPTIN


def test_rho_split_sampler_takes_the_shapes_it_took():
    """The ceiling is the first design's shared memory: D=64 at full rank
    and not 65 on an H100; every shape within it has a layout (up to 8
    elements a thread)."""
    have = block.H100_SMEM_OPTIN
    assert split.rho_split_sample_ceiling_bytes(64, 64) <= have
    assert split.rho_split_sample_ceiling_bytes(65, 65) > have
    for D in range(1, 100):
        for rank in range(1, 2 * D + 1):
            need = split.rho_split_sample_ceiling_bytes(D, rank)
            if need > have:
                break
            lay = split.rho_split_sample_layout(D, rank)
            assert lay.elems <= 8 and lay.threads <= 1024
