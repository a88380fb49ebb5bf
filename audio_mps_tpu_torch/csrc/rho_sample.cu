// rho SDE sampler (Euler–Maruyama, purification factor, block-complex
// layout) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py
// _make_rho_sample_kernel (:2278, reached through rho_sample_block :2333).
// Same step as the Pallas body, on one chain's folded factor segment t
// ([2D, R], R = rank):
//   gx  = Xs t                 (Xs = Bk(X^T diag(p)): the expectation acts on
//                               the CURRENT state H = p .* t)
//   v   = conj(p) .* gx over the two halves
//   e   = sum(t .* v)          (over the segment: a CTA reduction)
//   inc = e dt + noise[k];  samp += inc  (written out: running waveform)
//   y   = Ab t + (inc / A) (Bb t)
//   t   = y rsqrt(max(sum(y .* y), norm_eps))  (a CTA reduction)
// The A scaling and the transpose of the running waveform stay outside; the
// TPU's one-lane-per-chain slice of the waveform is here one value per CTA.
//
// Design. One CTA per chain loops over all T steps with Ab, Bb and Xs
// j-major in dynamic shared memory beside the prepped state tile (3 x 64 KB
// + 32 KB at D=64, R=64: 224 KB) and the thread layout of rho_tile.cuh,
// whose rows pair the real and imaginary halves so the conj(p) twist needs
// no exchange. The expectation's product runs first (e must be known for
// the update); the update's two products then read the same tile.
//
// What bounds it: 3 x 2 x (2D)^2 x R FLOPs per chain-step (6.3 MFLOP at
// D=64, R=64) on the fp32 pipes of one SM per chain; with 8 chains 8 of
// 132 SMs have work, plus two CTA reductions a step. Splitting a chain over
// a thread-block cluster is later work.
#include "rho_tile.cuh"

namespace amt {

template <int P>
__global__ void __launch_bounds__(kRhoMaxThreads)
    rho_sample_kernel(const float* __restrict__ ab,
                      const float* __restrict__ bb,
                      const float* __restrict__ xs,
                      const float* __restrict__ pc,
                      const float* __restrict__ ps,
                      const float* __restrict__ t0,
                      const float* __restrict__ noise,
                      const float* __restrict__ inv_a_ptr,
                      float* __restrict__ wave, int D, int T, int N, int R,
                      float dt, float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const RhoTile tl(D, R);
  const int n = tl.n;
  uint32_t* abt = smem;
  uint32_t* bbt = abt + n * n;
  uint32_t* xst = bbt + n * n;
  uint32_t* st = xst + n * n;
  float* red_e = reinterpret_cast<float*>(st + n * tl.rs);  // 32 partials
  float* red_n = red_e + 32;                                 // 32 partials
  const uint32_t* const upd[2] = {abt, bbt};
  const uint32_t* const expect[1] = {xst};

  const int chain = blockIdx.x;
  // offsets in size_t: T * N and 2D * N*R may pass 2^31
  const size_t stride = static_cast<size_t>(N);
  const size_t cols = static_cast<size_t>(N) * R;
  const size_t col0 = static_cast<size_t>(chain) * R;

  load_matrix_t<P>(abt, ab, n);
  load_matrix_t<P>(bbt, bb, n);
  load_matrix_t<P>(xst, xs, n);
  float my_pc[4], my_ps[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    my_pc[r] = tl.active ? pc[4 * tl.ty + r] : 0.f;
    my_ps[r] = tl.active ? ps[4 * tl.ty + r] : 0.f;
  }
  float t[8][4];
  load_tile(t, t0, cols, col0, tl);
  store_tile<P>(st, tl, t);

  const float inv_a = *inv_a_ptr;
  float samp = 0.f;
  float nz = T > 0 ? noise[chain] : 0.f;
  for (int k = 0; k < T; ++k) {
    __syncthreads();  // the state tile holds t
    const float nz_next = (k + 1 < T) ? noise[(k + 1) * stride + chain] : 0.f;
    float part = 0.f;
    {
      float g[1][8][4];
      tile_products<P, 1>(expect, st, tl, g);
      // rows r < 4 are real parts, r + 4 the imaginary parts of the same
      // components: v_r = pc gx_r + ps gx_i, v_i = pc gx_i - ps gx_r
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!tl.valid(c)) continue;
          const float vr = my_pc[r] * g[0][r][c] + my_ps[r] * g[0][r + 4][c];
          const float vi = my_pc[r] * g[0][r + 4][c] - my_ps[r] * g[0][r][c];
          part += t[r][c] * vr + t[r + 4][c] * vi;
        }
    }
    const float e = block_sum(part, red_e);
    const float inc = e * dt + nz;
    samp += inc;
    if (threadIdx.x == 0) wave[k * stride + chain] = samp;
    const float s = inc * inv_a;
    {
      float a[2][8][4];
      tile_products<P, 2>(upd, st, tl, a);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) t[r][c] = a[0][r][c] + s * a[1][r][c];
    }
    // every thread is past the update's products once the sum returns
    const float tr = block_sum(tile_dot(t, t, tl), red_n);
    const float inv = rsqrtf(floor_at(tr, norm_eps));
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) t[r][c] = t[r][c] * inv;
    store_tile<P>(st, tl, t);
    nz = nz_next;
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one sampler CTA: Ab, Bb, Xs (4 bytes an
// element), the state tile and two 32-float reduction buffers.
size_t amt_rho_sample_smem_bytes(int D, int R) {
  const size_t n = 2 * static_cast<size_t>(D);
  return (3 * n * n + amt::rho_state_words(D, R) + 64) * 4;
}

// Running waveform wave[T, N] from noise[T, N] for N chains whose factors
// are t0[2D, N*R]; see the kernel note above. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_rho_sample(const float* ab, const float* bb, const float* xs,
                   const float* pc, const float* ps, const float* t0,
                   const float* noise, const float* inv_a, float* wave, int D,
                   int T, int N, int R, float dt, float norm_eps,
                   int precision, void* stream) {
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    return amt::launch_smem(amt::rho_sample_kernel<decltype(p)::value>, N,
                            amt::rho_threads(D, R),
                            amt_rho_sample_smem_bytes(D, R),
                            static_cast<cudaStream_t>(stream), ab, bb, xs, pc,
                            ps, t0, noise, inv_a, wave, D, T, N, R, dt,
                            norm_eps);
  }));
}

}  // extern "C"
