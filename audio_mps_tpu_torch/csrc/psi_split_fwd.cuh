// The psi forward chain in the split layout for Hopper, shared by the
// forward-only NLL (psi_split_nll.cu, kNll) and the training forward with
// block checkpoints (psi_split_fwd.cu, kCkpt), with the complex products
// that the split sampler (psi_split_sample.cu) and adjoint
// (psi_split_bwd.cu) use too.
//
// Replaces, with its two modes, the TPU kernels
// audio_mps_tpu/ops/pallas_scan.py _make_psi_nll_kernel (via psi_nll_pallas)
// and audio_mps_tpu/ops/pallas_grad.py _make_psi_fwd_kernel (via
// _psi_fused_nll_factory). The split layout keeps the state as real and
// imaginary columns pr, pi ([D] per example) and the constants C, R as
// real pairs [D,D], and does not fold the frame rotation into them. One
// step, with s the increment / A:
//   y  = C psi + s R psi                      (four real products each)
//   e  = 2 sum(y_r (R y)_r + y_i (R y)_i),  n2 = |y|^2   (column sums)
//   per-step norm:  loss -= log(max(1 + e s, log_eps));
//                   psi = conj(p) .* (y rsqrt(max(n2, eps)))
//   deferred norm:  e /= max(n2_prev, eps); the same loss;
//                   psi = conj(p) .* y, n2_prev = n2, and at every
//                   unroll-th step psi *= rsqrt(max(n2, eps)), n2_prev = 1:
//                   where the TPU kernel renormalises at its block exits.
// kCkpt also writes ckr, cki [n_blocks, D, B], the state entering each
// unroll-step block (normalised in both modes, pallas_grad.py:132-135); the
// adjoint re-runs each block from it.
//
// Design. On the TPU the grid walks time blocks and scratch carries the
// state; here each example is independent, so one CTA owns one example's
// column and loops over all steps, with C and R in dynamic shared memory
// (stored transposed, 16 D^2 bytes) and thread i computing row i. D need not
// be a multiple of anything: a CTA has D threads rounded up to a warp, the
// rows past D idle, and every load is a 4-byte word. The column sums are
// warp shuffles when D <= 32 (one warp) and block reductions beyond.
//
// What bounds it. A step is 12 dependent length-D dot products per thread
// and two barriers, so latency bounds it, not bytes or FLOPs: at D=10,
// B=32 a step takes ~2 us on an H100 (chip_smoke.py) against ~1 ns of
// fp32 FLOPs and ~0.1 ns of device-memory bytes. A CTA is one warp at
// D <= 32, so B=32 fills 32 of the 132 SMs. Several examples per warp,
// reusing each loaded constant across columns, is later work.
#pragma once

#include "common.cuh"

namespace amt {

// The operand as a product sees it: bf16-rounded at kDefault, else as is.
template <int P>
__device__ __forceinline__ float prep(float x) {
  return P == kDefault ? bf16_round(x) : x;
}

// (M v) at row i of complex M = (mr, mi), the j-th element of the row at
// m[j * stride], on the prepped vector v = (vr, vi) of length D: four real
// dots, (mr.vr - mi.vi, mr.vi + mi.vr).
template <int P>
__device__ __forceinline__ void cdot(const uint32_t* mr, const uint32_t* mi,
                                     int stride, const float* vr,
                                     const float* vi, int D, float& outr,
                                     float& outi) {
  float a1, a2, a3, a4;
  dot2_strided<P>(mr, mi, stride, vr, nullptr, D, a1, a2);
  dot2_strided<P>(mr, mi, stride, vi, nullptr, D, a3, a4);
  outr = a1 - a4;
  outi = a3 + a2;
}

// The real adjoint of cdot at row i, walking column i of M (m[j * stride]
// is M[j][i]): (mr^T vr + mi^T vi, mr^T vi - mi^T vr).
template <int P>
__device__ __forceinline__ void cdot_t(const uint32_t* mr, const uint32_t* mi,
                                       int stride, const float* vr,
                                       const float* vi, int D, float& outr,
                                       float& outi) {
  float a1, a2, a3, a4;
  dot2_strided<P>(mr, mi, stride, vr, nullptr, D, a1, a2);
  dot2_strided<P>(mr, mi, stride, vi, nullptr, D, a3, a4);
  outr = a1 + a4;
  outi = a3 - a2;
}

// Three complex products at row (or column) i in one walk over j: A u, B u
// and M w, for packed shared matrices A, B, M (element j of the row at
// m[j * stride]) and prepped vectors u, w of length D. Each of the twelve
// real dots is one fmaf chain over j in order, as dot2_strided's, so each
// result is the bits that cdot (TR false) or cdot_t (TR true) gives it
// alone; walking the three together keeps twelve independent chains in
// flight where cdot runs two. out = (A u, B u, M w), real and imaginary.
// highest and default only (the split kernels refuse high). U unrolls the
// walk; the adjoints take the unroll that ran fastest for each form on an
// H100 at the estimator's shape (psi 1 double, 4 single; rho 2: 4 ran its
// workspace placement at half the speed).
template <int P, bool TR, int U>
__device__ __forceinline__ void cdot3(const uint32_t* ar, const uint32_t* ai,
                                      const uint32_t* br, const uint32_t* bi,
                                      const uint32_t* mr, const uint32_t* mi,
                                      int stride, const float* ur,
                                      const float* ui, const float* wr,
                                      const float* wi, int D,
                                      float (&out)[6]) {
  static_assert(P != kHigh, "the split kernels take highest and default");
  float a[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) a[q] = 0.f;
#pragma unroll (U)
  for (int j = 0; j < D; ++j) {
    const int o = j * stride;
    const float x[4] = {ur[j], ui[j], wr[j], wi[j]};
    const float m[6] = {__uint_as_float(ar[o]), __uint_as_float(ai[o]),
                        __uint_as_float(br[o]), __uint_as_float(bi[o]),
                        __uint_as_float(mr[o]), __uint_as_float(mi[o])};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float vr = x[c == 2 ? 2 : 0], vi = x[c == 2 ? 3 : 1];
      a[4 * c] = fmaf(m[2 * c], vr, a[4 * c]);              // mr . vr
      a[4 * c + 1] = fmaf(m[2 * c + 1], vr, a[4 * c + 1]);  // mi . vr
      a[4 * c + 2] = fmaf(m[2 * c], vi, a[4 * c + 2]);      // mr . vi
      a[4 * c + 3] = fmaf(m[2 * c + 1], vi, a[4 * c + 3]);  // mi . vi
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[2 * c] = TR ? a[4 * c] + a[4 * c + 3] : a[4 * c] - a[4 * c + 3];
    out[2 * c + 1] = TR ? a[4 * c + 2] - a[4 * c + 1]
                        : a[4 * c + 2] + a[4 * c + 1];
  }
}

// Sum of v over the CTA, every thread getting it: warp shuffles for one warp
// (after a warp barrier, so that the shared vectors read before the call
// are not overwritten by a lane that runs ahead), a block reduction
// (block_sum's rule for `red`) beyond.
__device__ __forceinline__ float col_sum(float v, float* red) {
  if (blockDim.x <= 32) {
    __syncwarp();
    return warp_sum(v);
  }
  return block_sum(v, red);
}

__device__ __forceinline__ void col_sum2(float v, float u, float* red,
                                         float& sv, float& su) {
  if (blockDim.x <= 32) {
    __syncwarp();
    sv = warp_sum(v);
    su = warp_sum(u);
  } else {
    block_sum2(v, u, red, sv, su);
  }
}

// Threads per split CTA: one per row, rounded up to whole warps.
__host__ __device__ inline int split_threads(int D) {
  return ((D + 31) / 32) * 32;
}

// The split adjoints (psi_split_bwd.cu, rho_split_bwd.cu). A block's
// per-step scalars, [kStepScalars][unroll] floats a slab: s, |y|^2 (psi) or
// the trace (rho), ehat, and the previous step's |y|^2 or trace.
enum SplitStepScalar { kSs = 0, kSn = 1, kSe = 2, kSnp = 3, kStepScalars = 4 };

// The most threads of a psi adjoint CTA (two roles of D threads rounded to
// warps, D <= 128) and of a rho one in the double form (two roles).
constexpr int kSplitBwdPsiThreads = 256;
constexpr int kSplitBwdRhoPipeThreads = 512;

// The parts of an adjoint a build runs: all three, except in the
// measurement builds of tools/split_adjoint_attribution.py, which compile
// the adjoints with -DAMT_SPLIT_BWD_PARTS=1 (the re-run alone), 2 (the
// sweep alone) or 4 (the outer products alone); the hand-overs between the
// roles stay.
#ifndef AMT_SPLIT_BWD_PARTS
#define AMT_SPLIT_BWD_PARTS 7
#endif
constexpr int kRerunPart = 1, kSweepPart = 2, kOuterPart = 4;
constexpr int kParts = AMT_SPLIT_BWD_PARTS;

// The split kernels take highest and default, as the TPU's do.
template <typename F>
cudaError_t dispatch_split(int precision, bool defer, F&& f) {
  return dispatch(precision, defer, [&](auto p, auto d) -> cudaError_t {
    if constexpr (decltype(p)::value == kHigh) {
      return cudaErrorInvalidValue;
    } else {
      return f(p, d);
    }
  });
}

template <int P, bool DEFER, int MODE>
__global__ void __launch_bounds__(1024)
    psi_split_fwd_kernel(const float* __restrict__ cr,
                         const float* __restrict__ ci,
                         const float* __restrict__ rr,
                         const float* __restrict__ ri,
                         const float* __restrict__ pc,
                         const float* __restrict__ ps,
                         const float* __restrict__ s0r,
                         const float* __restrict__ s0i,
                         const float* __restrict__ se,
                         float* __restrict__ loss, float* __restrict__ ckr,
                         float* __restrict__ cki, int D, int n_steps, int B,
                         int unroll, float log_eps, float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int dd = D * D;
  uint32_t* crt = smem;
  uint32_t* cit = crt + dd;
  uint32_t* rrt = cit + dd;
  uint32_t* rit = rrt + dd;
  float* vr = reinterpret_cast<float*>(rit + dd);  // prepped psi
  float* vi = vr + D;
  float* wr = vi + D;                              // prepped y
  float* wi = wr + D;
  float* red = wi + D;                             // 64 partials

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < D;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(D) * B;

  load_matrix_t<P>(crt, cr, D);
  load_matrix_t<P>(cit, ci, D);
  load_matrix_t<P>(rrt, rr, D);
  load_matrix_t<P>(rit, ri, D);
  const float pci = active ? pc[i] : 0.f;
  const float psi = active ? ps[i] : 0.f;
  float pr = active ? s0r[i * stride + col] : 0.f;
  float pi = active ? s0i[i * stride + col] : 0.f;
  float acc = 0.f;
  float n2p = 1.f;
  float s = n_steps > 0 ? se[col] : 0.f;

  for (int k = 0; k < n_steps; ++k) {
    if (MODE == kCkpt && active && k % unroll == 0) {
      const size_t at = (k / unroll) * plane + i * stride + col;
      ckr[at] = pr;
      cki[at] = pi;
    }
    if (active) {
      vr[i] = prep<P>(pr);
      vi[i] = prep<P>(pi);
    }
    __syncthreads();
    const float s_next = k + 1 < n_steps ? se[(k + 1) * stride + col] : 0.f;
    float yr = 0.f, yi = 0.f;
    if (active) {
      float g1r, g1i, g2r, g2i;
      cdot<P>(crt + i, cit + i, D, vr, vi, D, g1r, g1i);
      cdot<P>(rrt + i, rit + i, D, vr, vi, D, g2r, g2i);
      yr = g1r + s * g2r;
      yi = g1i + s * g2i;
      wr[i] = prep<P>(yr);
      wi[i] = prep<P>(yi);
    }
    __syncthreads();
    float e_part = 0.f;
    if (active) {
      float rur, rui;
      cdot<P>(rrt + i, rit + i, D, wr, wi, D, rur, rui);
      e_part = yr * rur + yi * rui;
    }
    float ehat, n2;
    col_sum2(e_part, yr * yr + yi * yi, red, ehat, n2);
    ehat *= 2.f;
    if (DEFER) {
      const float e = ehat / floor_at(n2p, norm_eps);
      acc -= logf(floor_at(1.f + e * s, log_eps));
      pr = yr * pci + yi * psi;
      pi = yi * pci - yr * psi;
      if ((k + 1) % unroll == 0) {
        const float inv = rsqrtf(floor_at(n2, norm_eps));
        pr *= inv;
        pi *= inv;
        n2p = 1.f;
      } else {
        n2p = n2;
      }
    } else {
      acc -= logf(floor_at(1.f + ehat * s, log_eps));
      const float inv = rsqrtf(floor_at(n2, norm_eps));
      const float tr = yr * inv, ti = yi * inv;
      pr = tr * pci + ti * psi;
      pi = ti * pci - tr * psi;
    }
    s = s_next;
  }
  if (i == 0) loss[col] = acc;
}

// Dynamic shared memory of one forward CTA: C and R (4 bytes an element),
// four [D] vectors and a 64-float reduction buffer.
inline size_t split_fwd_smem_bytes(int D) {
  const size_t d = static_cast<size_t>(D);
  return 4 * d * d * 4 + (4 * d + 64) * 4;
}

// Launch the forward for the runtime precision and norm flag: B CTAs. ckr
// and cki may be null for kNll.
template <int MODE>
cudaError_t launch_split_fwd(const float* cr, const float* ci,
                             const float* rr, const float* ri,
                             const float* pc, const float* ps,
                             const float* s0r, const float* s0i,
                             const float* se, float* loss, float* ckr,
                             float* cki, int D, int n_steps, int B,
                             int unroll, float log_eps, float norm_eps,
                             int precision, bool defer, cudaStream_t stream) {
  if (unroll < 1 || D < 1) return cudaErrorInvalidValue;
  return dispatch_split(precision, defer, [&](auto p, auto d) {
    return launch_smem(
        psi_split_fwd_kernel<decltype(p)::value, decltype(d)::value, MODE>,
        dim3(B), split_threads(D), split_fwd_smem_bytes(D), stream, cr, ci,
        rr, ri, pc, ps, s0r, s0i, se, loss, ckr, cki, D, n_steps, B, unroll,
        log_eps, norm_eps);
  });
}

}  // namespace amt
