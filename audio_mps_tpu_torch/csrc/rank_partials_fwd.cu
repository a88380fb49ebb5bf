// Forward of the rank partials (rho purification factor, block-complex
// layout, a chunk of rank rows at a time) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_rank.py
// _make_rank_partials_fwd_kernel (:80, stream=True). One step on a segment
// of rc columns t ([2D, rc], one example's chunk of rank rows), s the
// example's increment / A:
//   y    = (Ab + s Bb) t                       (one product: the segment
//                                               shares s)
//   gx   = Xb y
//   ehat = sum(y .* gx), tr = sum(y .* y)       (one CTA reduction of both)
//   t    = y, renormalised by rsqrt(max(tr, eps)) at every unroll-th step
// It writes eh[k, j] and tr[k, j] per step and segment j (the partials the
// host combines across chunks), ys[k] = y_k ([n_steps, 2D, cols]: the
// adjoint and the cotangents rebuild t_k = y_{k-1} (* the exit scale) from
// it with these instructions, bit for bit) and the final state tfin, which
// chains time segments. Segment j = b G + g owns columns j rc .. j rc +
// rc - 1 and reads the increment of example b = j / G.
//
// On the TPU the grid walks time blocks of one chunk, with its constants in
// VMEM and the segment sums through a 0/1 matrix; here every chunk of every
// example is one CTA of one launch, looping over all steps, and its sums
// are CTA reductions in a fixed order (no atomics). The constants stream
// from L2 in slabs (rank_partials.cuh); the state tile stays in shared
// memory (y has no tile: it is computed into registers and then replaces t,
// which is dead by then).
//
// What bounds it: 2 products of 2 (2D)^2 rc FLOPs a segment-step (the
// forward of the port's D=256 model, 128 segments of 16 columns, is 35 TFLOP
// over 16384 steps: 525 ms at the fp32 peak); each CTA also reads the three
// constants (3 MiB at D=256) from L2 every step, 16 FMAs a loaded word at
// rc=16, so L2 bandwidth is the other limit. Multicasting the slabs over a
// thread-block cluster with TMA, wgmma and deeper pipelines are later work.
#include "rank_partials.cuh"

namespace amt {

template <int P>
__global__ void __launch_bounds__(kPartialsThreads)
    rank_partials_fwd_kernel(const float* __restrict__ abt,
                             const float* __restrict__ bbt,
                             const float* __restrict__ xbt,
                             const float* __restrict__ t0,
                             const float* __restrict__ se,
                             float* __restrict__ eh, float* __restrict__ tr,
                             float* __restrict__ tfin, float* __restrict__ ys,
                             int D, int n_steps, int B, int S, int rc,
                             int unroll, float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const RhoTile tl(D, rc);
  const int n = tl.n;
  uint32_t* st = smem;
  float* red = reinterpret_cast<float*>(st + n * tl.rs);   // 2 x 32 partials
  uint32_t* slabs = st + partials_base_words(D, rc);
  const float* const upd[2] = {abt, bbt};
  const float* const expect[1] = {xbt};

  const int j = blockIdx.x;
  const int b = j / (S / B);
  // offsets in size_t: the stream holds n_steps * 2D * cols elements
  const size_t cols = static_cast<size_t>(S) * rc;
  const size_t col0 = static_cast<size_t>(j) * rc;
  const size_t plane = static_cast<size_t>(n) * cols;

  float y[8][4];
  load_tile(y, t0, cols, col0, tl);
  store_tile<P>(st, tl, y);
  __syncthreads();
  for (int k = 0; k < n_steps; ++k) {
    const float s = se[static_cast<size_t>(k) * B + b];
    {
      float a[1][8][4];
      stream_products<P, 1, true>(upd, s, st, slabs, tl, a);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) y[r][c] = a[0][r][c];
    }
    store_tile<P>(st, tl, y);
    store_tile_global(ys + k * plane, cols, col0, tl, y);
    __syncthreads();
    float ehat, trv;
    {
      float g[1][8][4];
      stream_products<P, 1, false>(expect, 0.f, st, slabs, tl, g);
      block_sum2(tile_dot(y, g[0], tl), tile_dot(y, y, tl), red, ehat, trv);
    }
    if (threadIdx.x == 0) {
      eh[static_cast<size_t>(k) * S + j] = ehat;
      tr[static_cast<size_t>(k) * S + j] = trv;
    }
    if ((k + 1) % unroll == 0) {
      // every thread is past the Xb product (stream_products synchronised)
      const float inv = rsqrtf(floor_at(trv, norm_eps));
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) y[r][c] = y[r][c] * inv;
      store_tile<P>(st, tl, y);
    }
    __syncthreads();
  }
  store_tile_global(tfin, cols, col0, tl, y);
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of the largest partials CTA (the adjoint chain, two
// staged matrices); the forward and the tail take one.
size_t amt_rank_partials_smem_bytes(int D, int rc) {
  return amt::partials_smem_bytes(D, rc, 2);
}

// eh, tr [n_steps, S], tfin [2D, S*rc] and ys [n_steps, 2D, S*rc] from the
// j-major constants abt, bbt, xbt (the transposes of Ab, Bb, Xb), t0
// [2D, S*rc] and se [n_steps, B]; S segments of rc columns, S / B an
// example. precision: 0 highest, 1 high, 2 default. Returns a cudaError_t.
int amt_rank_partials_fwd(const float* abt, const float* bbt,
                          const float* xbt, const float* t0, const float* se,
                          float* eh, float* tr, float* tfin, float* ys, int D,
                          int n_steps, int B, int S, int rc, int unroll,
                          float norm_eps, int precision, void* stream) {
  if (!amt::partials_fits(D, rc) || B < 1 || S % B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    return amt::launch_smem(
        amt::rank_partials_fwd_kernel<decltype(p)::value>, S,
        amt::kPartialsThreads, amt::partials_smem_bytes(D, rc, 1),
        static_cast<cudaStream_t>(stream), abt, bbt, xbt, t0, se, eh, tr,
        tfin, ys, D, n_steps, B, S, rc, unroll, norm_eps);
  }));
}

}  // extern "C"
