// The psi forward chain (block-complex layout) for Hopper, shared by the
// forward-only NLL (psi_nll.cu, STREAM=false) and the training forward
// (psi_train_fwd.cu, STREAM=true).
//
// One step on the folded kernel-frame state t ([2D] per example), with s the
// increment / A:
//   y  = Ab t + s (Bb t)
//   ru = Rb y
//   e  = 2 sum(y .* ru),  n2 = sum(y^2)     (one block reduction of both)
//   per-step norm:  loss -= log(max(1 + e s, log_eps));  t = y rsqrt(max(n2, eps))
//   deferred norm:  e /= max(n2_prev, eps); same loss; t = y, n2_prev = n2,
//                   renormalised (and n2_prev = 1) at every unroll-th step,
//                   where the TPU kernel renormalises at its block exits.
// The mean over the batch stays outside; the kernel writes loss[B]. With
// STREAM it also writes ys[k] = y_k ([n_steps, 2D, B]) and n2s[k] = |y_k|^2
// ([n_steps, B]): with them the adjoint (psi_train_bwd.cu) and the cotangent
// reduction (psi_cotangents.cu) rebuild every step's input state
// t_k = y_{k-1} * (renorm ? rsqrt(max(n2, eps)) : 1) with the same
// instructions as here, bit for bit, and no recompute chain.
//
// Design. On the TPU the grid walks time blocks and scratch carries the
// state; here each example is independent, so one CTA owns one example and
// loops over all steps, with Ab, Bb and Rb resident in dynamic shared memory
// (3 x 64 KB = 192 KB at D=64) and thread i computing state row i.
//
// What bounds it. Each step reads the three [2D,2D] constants from shared
// memory once per example (3 x 64 KB at D=64) against 3 x 2 x (2D)^2 FLOPs,
// one FMA per 4-byte shared load, so the shared-memory bandwidth of each SM
// and the per-step latency of three CTA barriers bound it, not device
// memory. At B=128 the grid is 128 CTAs on 132 SMs (one CTA fits an SM at
// 192 KB). The stream write is one 4-byte store per thread per step, strided
// by B between rows (coalesced only within the CTA's column of 2D rows), off
// the dependent-dot path. Several examples per CTA, reusing each loaded
// constant across columns (a warpgroup MMA over the batch), is later work.
#pragma once

#include "common.cuh"

namespace amt {

template <int P, bool DEFER, bool STREAM>
__global__ void __launch_bounds__(1024)
    psi_fwd_kernel(const float* __restrict__ ab, const float* __restrict__ bb,
                   const float* __restrict__ rb, const float* __restrict__ t0,
                   const float* __restrict__ se, float* __restrict__ loss,
                   float* __restrict__ ys, float* __restrict__ n2s, int D,
                   int n_steps, int B, int unroll, float log_eps,
                   float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 2 * D;
  uint32_t* abt = smem;
  uint32_t* bbt = abt + n * n;
  uint32_t* rbt = bbt + n * n;
  float* th = reinterpret_cast<float*>(rbt + n * n);  // prepped state t
  float* tl = th + n;
  float* yh = tl + n;                                 // prepped y
  float* yl = yh + n;
  float* red = yl + n;                                // 2 x 32 partials

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < n;
  // offsets in size_t: n_steps * B, and n_steps * 2D * B of the stream, may
  // pass 2^31
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;

  load_matrix_t<P>(abt, ab, n);
  load_matrix_t<P>(bbt, bb, n);
  load_matrix_t<P>(rbt, rb, n);

  float t = active ? t0[i * stride + col] : 0.f;
  float acc = 0.f;
  float n2p = 1.f;
  float s = n_steps > 0 ? se[col] : 0.f;

  for (int k = 0; k < n_steps; ++k) {
    if (active) store_vec<P>(th, tl, i, t);
    __syncthreads();
    const float s_next = (k + 1 < n_steps) ? se[(k + 1) * stride + col] : 0.f;
    float y = 0.f;
    if (active) {
      float a, b;
      row_dot2<P>(abt, bbt, th, tl, n, i, a, b);
      y = a + s * b;
      store_vec<P>(yh, yl, i, y);
      if (STREAM) ys[k * plane + i * stride + col] = y;
    }
    __syncthreads();
    const float ru = active ? row_dot<P>(rbt, yh, yl, n, i) : 0.f;
    float ehat, n2;
    block_sum2(y * ru, y * y, red, ehat, n2);
    ehat *= 2.f;
    if (STREAM && i == 0) n2s[k * stride + col] = n2;
    if (DEFER) {
      const float e = ehat / floor_at(n2p, norm_eps);
      acc -= logf(floor_at(1.f + e * s, log_eps));
      if ((k + 1) % unroll == 0) {
        t = y * rsqrtf(floor_at(n2, norm_eps));
        n2p = 1.f;
      } else {
        t = y;
        n2p = n2;
      }
    } else {
      acc -= logf(floor_at(1.f + ehat * s, log_eps));
      t = y * rsqrtf(floor_at(n2, norm_eps));
    }
    s = s_next;
  }
  if (i == 0) loss[col] = acc;
}

// Dynamic shared memory of one forward CTA: Ab, Bb, Rb (4 bytes an
// element), four [2D] vectors and a 64-float reduction buffer.
inline size_t fwd_smem_bytes(int D) {
  const size_t n = 2 * static_cast<size_t>(D);
  return 3 * n * n * 4 + (4 * n + 64) * 4;
}

// Launch the forward for the runtime precision and norm flag; ys and n2s
// are written only with STREAM.
template <bool STREAM>
cudaError_t launch_fwd(const float* ab, const float* bb, const float* rb,
                       const float* t0, const float* se, float* loss,
                       float* ys, float* n2s, int D, int n_steps, int B,
                       int unroll, float log_eps, float norm_eps,
                       int precision, bool defer, cudaStream_t stream) {
  return dispatch(precision, defer, [&](auto p, auto d) {
    return launch_smem(
        psi_fwd_kernel<decltype(p)::value, decltype(d)::value, STREAM>, B,
        threads_for(D), fwd_smem_bytes(D), stream, ab, bb, rb, t0, se, loss,
        ys, n2s, D, n_steps, B, unroll, log_eps, norm_eps);
  });
}

}  // namespace amt
