// The rho forward chain in the split layout for Hopper, shared by the
// forward-only NLL (rho_split_nll.cu, kNll) and the training forward with
// block checkpoints (rho_split_fwd.cu, kCkpt), with the pieces that the
// split rho sampler (rho_split_sample.cu) and adjoint (rho_split_bwd.cu)
// use too.
//
// Replaces, with its two modes, the TPU kernels
// audio_mps_tpu/ops/pallas_scan.py _make_rho_nll_kernel (via rho_nll_pallas)
// and audio_mps_tpu/ops/pallas_grad.py _make_rho_fwd_kernel (via
// _rho_fused_nll_factory). The state of an example is its purification
// factor segment H = G^T, [D, rank] (its rank lanes of the [D, B * rank]
// factor), as real and imaginary parts; the constants conj(C), conj(R) and
// X^T are real pairs [D,D]. One step, with s the increment / A shared by the
// lanes:
//   y    = conj(C) H + s conj(R) H             (four real products each)
//   gx   = X^T y,  ehat = sum(y_r gx_r + y_i gx_i),  tr = |y|^2
//                                              (sums over the segment)
//   per-step norm:  loss -= log(max(1 + ehat s, log_eps));
//                   H = p .* (y rsqrt(max(tr, eps)))
//   deferred norm:  e = ehat / max(tr_prev, eps), the same loss;
//                   H = p .* y, tr_prev = tr, and at every unroll-th step
//                   H *= rsqrt(max(tr, eps)), tr_prev = 1: where the TPU
//                   kernel renormalises at its block exits.
// kCkpt also writes ckr, cki [n_blocks, D, B * rank], the factor entering
// each unroll-step block (normalised in both modes, pallas_grad.py:841-842,
// :856-859); the adjoint re-runs each block from it.
//
// Design. On the TPU the grid walks time blocks over all B * rank lanes and
// the per-example scalars are [1, B * rank] rows built with 0/1 segment
// matrices; here each example is independent, so one CTA owns one
// example's whole segment and loops over all steps, and e, tr and the loss
// are per-example scalars. The constants sit in dynamic shared memory
// (transposed, 24 D^2 bytes) beside the segment's vectors (8 D rank floats);
// thread t owns the elements t, t + nt, ... of the segment (element
// e = r D + i is row i of lane r), one element a thread up to D rank = 1024,
// and forms row i of each product as a length-D dot over lane r's column.
// D need not be a multiple of anything: every load is a 4-byte word. The
// segment sums are warp shuffles and, past one warp, a block reduction in a
// fixed order.
//
// What bounds it. A step is a few dependent length-D dots a thread and
// three barriers, so latency bounds it, not bytes or FLOPs: at D=10, rank
// 10, B=32 a step needs ~16 ns of fp32 FLOPs over the whole card. A CTA is
// 4 warps there, so B=32 fills 32 of the 132 SMs.
#pragma once

#include "psi_split_fwd.cuh"

namespace amt {

// Threads per rho split CTA: one per element of the [D, rank] segment,
// rounded up to whole warps, at most 1024 (then a thread takes several).
__host__ __device__ inline int rho_split_threads(int D, int rank) {
  const int n = D * rank;
  return n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
}

// The rotation p .* y of the factor's row i.
__device__ __forceinline__ void rotate_p(float yr, float yi, float pc,
                                         float ps, float& hr, float& hi) {
  hr = yr * pc - yi * ps;
  hi = yr * ps + yi * pc;
}

template <int P, bool DEFER, int MODE>
__global__ void __launch_bounds__(1024)
    rho_split_fwd_kernel(const float* __restrict__ ccr,
                         const float* __restrict__ cci,
                         const float* __restrict__ rcr,
                         const float* __restrict__ rci,
                         const float* __restrict__ xtr,
                         const float* __restrict__ xti,
                         const float* __restrict__ pc,
                         const float* __restrict__ ps,
                         const float* __restrict__ h0r,
                         const float* __restrict__ h0i,
                         const float* __restrict__ se,
                         float* __restrict__ loss, float* __restrict__ ckr,
                         float* __restrict__ cki, int D, int n_steps, int B,
                         int rank, int unroll, float log_eps,
                         float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int dd = D * D;
  const int n = D * rank;
  uint32_t* ccrt = smem;                          // transposed constants
  uint32_t* ccit = ccrt + dd;
  uint32_t* rcrt = ccit + dd;
  uint32_t* rcit = rcrt + dd;
  uint32_t* xtrt = rcit + dd;
  uint32_t* xtit = xtrt + dd;
  float* hr = reinterpret_cast<float*>(xtit + dd);  // the factor
  float* hi = hr + n;
  float* vr = hi + n;                              // prepped factor
  float* vi = vr + n;
  float* yr = vi + n;                              // y
  float* yi = yr + n;
  float* wr = yi + n;                              // prepped y
  float* wi = wr + n;
  float* pcs = wi + n;                             // rotation
  float* pss = pcs + D;
  float* red = pss + D;                            // 64 partials

  const int ex = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t lanes = static_cast<size_t>(B) * rank;
  const size_t plane = static_cast<size_t>(D) * lanes;
  const size_t col0 = static_cast<size_t>(ex) * rank;

  load_matrix_t<P>(ccrt, ccr, D);
  load_matrix_t<P>(ccit, cci, D);
  load_matrix_t<P>(rcrt, rcr, D);
  load_matrix_t<P>(rcit, rci, D);
  load_matrix_t<P>(xtrt, xtr, D);
  load_matrix_t<P>(xtit, xti, D);
  for (int i = tid; i < D; i += nt) {
    pcs[i] = pc[i];
    pss[i] = ps[i];
  }
  for (int e = tid; e < n; e += nt) {
    const int r = e / D, i = e - r * D;
    const float a = h0r[i * lanes + col0 + r], b = h0i[i * lanes + col0 + r];
    hr[e] = a;
    hi[e] = b;
    vr[e] = prep<P>(a);
    vi[e] = prep<P>(b);
  }
  float acc = 0.f;
  float trp = 1.f;
  float s = n_steps > 0 ? se[ex] : 0.f;

  for (int k = 0; k < n_steps; ++k) {
    if (MODE == kCkpt && k % unroll == 0) {
      for (int e = tid; e < n; e += nt) {
        const int r = e / D, i = e - r * D;
        const size_t at = (k / unroll) * plane + i * lanes + col0 + r;
        ckr[at] = hr[e];
        cki[at] = hi[e];
      }
    }
    __syncthreads();
    const float s_next =
        k + 1 < n_steps ? se[static_cast<size_t>(k + 1) * B + ex] : 0.f;
    for (int e = tid; e < n; e += nt) {
      const int r = e / D, i = e - r * D;
      float a1r, a1i, a2r, a2i;
      cdot<P>(ccrt + i, ccit + i, D, vr + r * D, vi + r * D, D, a1r, a1i);
      cdot<P>(rcrt + i, rcit + i, D, vr + r * D, vi + r * D, D, a2r, a2i);
      const float y_r = a1r + s * a2r, y_i = a1i + s * a2i;
      yr[e] = y_r;
      yi[e] = y_i;
      wr[e] = prep<P>(y_r);
      wi[e] = prep<P>(y_i);
    }
    __syncthreads();
    float e_part = 0.f, t_part = 0.f;
    for (int e = tid; e < n; e += nt) {
      const int r = e / D, i = e - r * D;
      float gxr, gxi;
      cdot<P>(xtrt + i, xtit + i, D, wr + r * D, wi + r * D, D, gxr, gxi);
      e_part += yr[e] * gxr + yi[e] * gxi;
      t_part += yr[e] * yr[e] + yi[e] * yi[e];
    }
    float ehat, tr;
    col_sum2(e_part, t_part, red, ehat, tr);
    float inv;
    if (DEFER) {
      const float e = ehat / floor_at(trp, norm_eps);
      acc -= logf(floor_at(1.f + e * s, log_eps));
      const bool renorm = (k + 1) % unroll == 0;
      inv = renorm ? rsqrtf(floor_at(tr, norm_eps)) : 1.f;
      trp = renorm ? 1.f : tr;
    } else {
      acc -= logf(floor_at(1.f + ehat * s, log_eps));
      inv = rsqrtf(floor_at(tr, norm_eps));
    }
    for (int e = tid; e < n; e += nt) {
      const int i = e % D;
      float a, b;
      // per-step norm: normalise, then rotate; deferred: rotate, then
      // (at a block exit) renormalise, in the TPU kernels' orders
      if (DEFER) {
        rotate_p(yr[e], yi[e], pcs[i], pss[i], a, b);
        a *= inv;
        b *= inv;
      } else {
        rotate_p(yr[e] * inv, yi[e] * inv, pcs[i], pss[i], a, b);
      }
      hr[e] = a;
      hi[e] = b;
      vr[e] = prep<P>(a);
      vi[e] = prep<P>(b);
    }
    s = s_next;
  }
  if (tid == 0) loss[ex] = acc;
}

// Dynamic shared memory of one forward CTA: conj(C), conj(R), X^T (4 bytes
// an element), eight [D, rank] vectors, pc, ps and 64 reduction floats.
inline size_t rho_split_fwd_smem_bytes(int D, int rank) {
  const size_t d = static_cast<size_t>(D), n = d * rank;
  return 4 * (6 * d * d + 8 * n + 2 * d + 64);
}

// Launch the forward for the runtime precision and norm flag: B CTAs. ckr
// and cki may be null for kNll.
template <int MODE>
cudaError_t launch_rho_split_fwd(const float* ccr, const float* cci,
                                 const float* rcr, const float* rci,
                                 const float* xtr, const float* xti,
                                 const float* pc, const float* ps,
                                 const float* h0r, const float* h0i,
                                 const float* se, float* loss, float* ckr,
                                 float* cki, int D, int n_steps, int B,
                                 int rank, int unroll, float log_eps,
                                 float norm_eps, int precision, bool defer,
                                 cudaStream_t stream) {
  if (unroll < 1 || D < 1 || rank < 1) return cudaErrorInvalidValue;
  return dispatch_split(precision, defer, [&](auto p, auto d) {
    return launch_smem(
        rho_split_fwd_kernel<decltype(p)::value, decltype(d)::value, MODE>,
        dim3(B), rho_split_threads(D, rank), rho_split_fwd_smem_bytes(D, rank),
        stream, ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se, loss, ckr,
        cki, D, n_steps, B, rank, unroll, log_eps, norm_eps);
  });
}

}  // namespace amt
