// psi SDE sampler (Euler–Maruyama, block-complex layout) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py
// _make_psi_sample_kernel (reached through psi_sample_block). Same step as
// the Pallas body, on the folded kernel-frame state t ([2D] per chain):
//   ru  = Bb t                         (R x on the current state x)
//   w   = p .* ru over the two halves  (the e-twist)
//   e   = 2 sum(t .* w)                (block reduction)
//   inc = e dt + noise[k];  samp += inc  (written out: running waveform)
//   y   = Ab t + (inc / A) ru
//   t   = y rsqrt(max(sum(y^2), norm_eps))  (block reduction)
// The A scaling and the transpose of the running waveform stay outside.
//
// Design. On the TPU the grid walks time and scratch carries the state; here
// each chain is independent, so one CTA owns one chain and loops over all T
// steps, with Ab and Bb resident in dynamic shared memory (2 x 64 KB at
// D=64) and thread i computing state row i.
//
// What bounds it. The chain is a serial recursion of T steps, each a pair
// of [2D,2D] x [2D] products plus two CTA-wide reductions. With N=8 chains
// only 8 of 132 SMs have work, so it is latency-bound (per-step sync and
// dot-loop latency), far from both the fp32 FLOP bound and the memory
// bound. Packing several chains per CTA, or a warpgroup MMA over the chain
// columns, is later work.
#include "common.cuh"

namespace amt {

template <int P>
__global__ void __launch_bounds__(1024)
    psi_sample_kernel(const float* __restrict__ ab,
                      const float* __restrict__ bb,
                      const float* __restrict__ pc,
                      const float* __restrict__ ps,
                      const float* __restrict__ t0,
                      const float* __restrict__ noise,
                      const float* __restrict__ inv_a_ptr,
                      float* __restrict__ wave, int D, int T, int N,
                      float dt, float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 2 * D;
  uint32_t* abt = smem;
  uint32_t* bbt = abt + n * n;
  float* th = reinterpret_cast<float*>(bbt + n * n);  // prepped state
  float* tl = th + n;                                 // kHigh lo part
  float* ru = tl + n;                                 // Bb t, for the twist
  float* red_e = ru + n;                              // 32 warp partials
  float* red_n = red_e + 32;                          // 32 warp partials

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < n;
  // offsets into the [T, N] arrays in size_t: T * N may pass 2^31
  const size_t stride = static_cast<size_t>(N);

  load_matrix_t<P>(abt, ab, n);
  load_matrix_t<P>(bbt, bb, n);

  const float inv_a = *inv_a_ptr;
  float my_pc = 0.f, my_ps = 0.f, t = 0.f;
  if (active) {
    const int r = i < D ? i : i - D;
    my_pc = pc[r];
    my_ps = ps[r];
    t = t0[i * stride + col];
  }
  float samp = 0.f;
  float nz = noise[col];

  for (int k = 0; k < T; ++k) {
    if (active) store_vec<P>(th, tl, i, t);
    __syncthreads();
    const float nz_next = (k + 1 < T) ? noise[(k + 1) * stride + col] : 0.f;
    float a = 0.f, b = 0.f;
    if (active) {
      row_dot2<P>(abt, bbt, th, tl, n, i, a, b);  // a = (Ab t)_i, b = ru_i
      ru[i] = b;
    }
    __syncthreads();
    float c = 0.f;
    if (active) {
      // row i < D pairs t_r with w_r = pc ru_r - ps ru_i;
      // row i >= D pairs t_i with w_i = pc ru_i + ps ru_r
      const float w = i < D ? my_pc * b - my_ps * ru[i + D]
                            : my_pc * b + my_ps * ru[i - D];
      c = t * w;
    }
    const float e = 2.f * block_sum(c, red_e);
    const float inc = e * dt + nz;
    samp += inc;
    if (i == 0) wave[k * stride + col] = samp;
    const float s = inc * inv_a;
    const float y = active ? a + s * b : 0.f;
    const float n2 = block_sum(y * y, red_n);
    t = y * rsqrtf(floor_at(n2, norm_eps));
    nz = nz_next;
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one sampler CTA: Ab, Bb (4 bytes an element),
// three [2D] vectors and two 32-float reduction buffers.
size_t amt_psi_sample_smem_bytes(int D) {
  const size_t n = 2 * static_cast<size_t>(D);
  return 2 * n * n * 4 + (3 * n + 64) * 4;
}

// Running waveform wave[T, N] from noise[T, N]; see the kernel note above.
// precision: 0 highest, 1 high, 2 default. Returns a cudaError_t.
int amt_psi_sample(const float* ab, const float* bb, const float* pc,
                   const float* ps, const float* t0, const float* noise,
                   const float* inv_a, float* wave, int D, int T, int N,
                   float dt, float norm_eps, int precision, void* stream) {
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    return amt::launch_smem(amt::psi_sample_kernel<decltype(p)::value>, N,
                            amt::threads_for(D), amt_psi_sample_smem_bytes(D),
                            static_cast<cudaStream_t>(stream), ab, bb, pc, ps,
                            t0, noise, inv_a, wave, D, T, N, dt, norm_eps);
  }));
}

const char* amt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
