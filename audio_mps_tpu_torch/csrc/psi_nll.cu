// Forward-only psi NLL (block-complex layout) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py psi_nll_block
// (its inline kernel, built on _psi_step / _psi_step_defer). One step on the
// folded kernel-frame state t ([2D] per example), with s the increment / A:
//   y  = Ab t + s (Bb t)
//   ru = Rb y
//   e  = 2 sum(y .* ru),  n2 = sum(y^2)     (one block reduction of both)
//   per-step norm:  loss -= log(max(1 + e s, log_eps));  t = y rsqrt(max(n2, eps))
//   deferred norm:  e /= max(n2_prev, eps); same loss; t = y, n2_prev = n2,
//                   renormalised (and n2_prev = 1) at every unroll-th step,
//                   where the TPU kernel renormalises at its block exits.
// The mean over the batch stays outside; the kernel writes loss[B].
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
// 192 KB). Several examples per CTA, reusing each loaded constant across
// columns (a warpgroup MMA over the batch), is later work.
#include "common.cuh"

namespace amt {

template <int P, bool DEFER>
__global__ void __launch_bounds__(1024)
    psi_nll_kernel(const float* __restrict__ ab, const float* __restrict__ bb,
                   const float* __restrict__ rb, const float* __restrict__ t0,
                   const float* __restrict__ se, float* __restrict__ loss,
                   int D, int n_steps, int B, int unroll, float log_eps,
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
  // offsets into se[n_steps, B] in size_t: n_steps * B may pass 2^31
  const size_t stride = static_cast<size_t>(B);

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
    }
    __syncthreads();
    const float ru = active ? row_dot<P>(rbt, yh, yl, n, i) : 0.f;
    float ehat, n2;
    block_sum2(y * ru, y * y, red, ehat, n2);
    ehat *= 2.f;
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

template <int P, bool DEFER>
cudaError_t launch_nll(const float* ab, const float* bb, const float* rb,
                       const float* t0, const float* se, float* loss, int D,
                       int n_steps, int B, int unroll, float log_eps,
                       float norm_eps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      psi_nll_kernel<P, DEFER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  psi_nll_kernel<P, DEFER><<<B, threads_for(D), smem, stream>>>(
      ab, bb, rb, t0, se, loss, D, n_steps, B, unroll, log_eps, norm_eps);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_nll_p(bool defer, const float* ab, const float* bb,
                         const float* rb, const float* t0, const float* se,
                         float* loss, int D, int n_steps, int B, int unroll,
                         float log_eps, float norm_eps, size_t smem,
                         cudaStream_t stream) {
  if (defer)
    return launch_nll<P, true>(ab, bb, rb, t0, se, loss, D, n_steps, B,
                               unroll, log_eps, norm_eps, smem, stream);
  return launch_nll<P, false>(ab, bb, rb, t0, se, loss, D, n_steps, B, unroll,
                              log_eps, norm_eps, smem, stream);
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one NLL CTA: Ab, Bb, Rb (4 bytes an element),
// four [2D] vectors and a 64-float reduction buffer.
size_t amt_psi_nll_smem_bytes(int D) {
  const size_t n = 2 * static_cast<size_t>(D);
  return 3 * n * n * 4 + (4 * n + 64) * 4;
}

// Per-example NLL loss[B] from se[n_steps, B] (increments / A); see the
// kernel note above. precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_psi_nll(const float* ab, const float* bb, const float* rb,
                const float* t0, const float* se, float* loss, int D,
                int n_steps, int B, int unroll, float log_eps, float norm_eps,
                int precision, int defer_norm, void* stream) {
  const size_t smem = amt_psi_nll_smem_bytes(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool defer = defer_norm != 0;
  switch (precision) {
    case amt::kHighest:
      return amt::launch_nll_p<amt::kHighest>(defer, ab, bb, rb, t0, se, loss,
                                              D, n_steps, B, unroll, log_eps,
                                              norm_eps, smem, st);
    case amt::kHigh:
      return amt::launch_nll_p<amt::kHigh>(defer, ab, bb, rb, t0, se, loss, D,
                                           n_steps, B, unroll, log_eps,
                                           norm_eps, smem, st);
    case amt::kDefault:
      return amt::launch_nll_p<amt::kDefault>(defer, ab, bb, rb, t0, se, loss,
                                              D, n_steps, B, unroll, log_eps,
                                              norm_eps, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
