// The rank-partials forward chain (rho purification factor, block-complex
// layout, a chunk of rank rows at a time) for Hopper, shared by the
// training forward with the state stream or with block checkpoints
// (rank_partials_fwd.cu, kStream / kCkpt) and the recompute of the
// recompute adjoint (rank_partials_recompute.cu, kRecompute).
//
// One step on a segment of rc columns t ([2D, rc], one example's chunk of
// rank rows), s the example's increment / A:
//   y    = (Ab + s Bb) t                       (one product: the segment
//                                               shares s)
//   gx   = Xb y
//   ehat = sum(y .* gx), tr = sum(y .* y)       (one CTA reduction of both)
//   t    = y, renormalised by rsqrt(max(tr, eps)) at every unroll-th step
// It writes eh[k, j] and tr[k, j] per step and segment j (the partials the
// host combines across chunks) and the final state tfin, which chains time
// segments; with kStream also ys[k] = y_k ([n_steps, 2D, cols]: the adjoint
// and the cotangents rebuild t_k = y_{k-1} (* the exit scale) from it with
// these instructions, bit for bit), with kCkpt instead ck[j] = t_{j unroll}
// ([n_blocks, 2D, cols], the state entering each unroll-step block). With
// kRecompute CTA (segment, block j) re-runs block j of a time segment from
// its checkpoint t0[j] and writes that block's rows of ys alone: the same
// loop over fewer steps, so bit for bit the kStream forward's rows.
// Segment j = b G + g owns columns j rc .. j rc + rc - 1 and reads the
// increment of example b = j / G.
//
// On the TPU the grid walks time blocks of one chunk, with its constants in
// VMEM and the segment sums through a 0/1 matrix; here every chunk of every
// example is one CTA of one launch, looping over all steps, and its sums
// are CTA reductions in a fixed order (no atomics). The constants stream
// through the ring of rank_partials.cuh: a step walks the slabs of Ab and
// Bb (combined in registers with the CTA's s), then those of Xb, while the
// producer warp keeps the next slabs in flight, across products and steps.
// Clusters of cs CTAs along the segment axis (x) share each slab by
// multicast; the state tile stays in shared memory.
//
// What bounds it: 2 products of 2 (2D)^2 rc FLOPs a segment-step (the
// forward of the port's D=256 model, 128 segments of 16 columns, is 35 TFLOP
// over 16384 steps: 525 ms at the fp32 peak). Staging one 16 KB slab at a
// time through registers behind a CTA barrier a slab took 141.5 us a step
// on an H100 at D=256, highest: 72 of it fetching the 3 MiB of constants
// from L2 (2.8 TB/s), 69 in the inner loop and 20 in the staging and
// barriers, barely overlapped. Here the fetch runs kStages slabs ahead of
// the same inner loop (with Ab + s Bb formed in registers) and hides under
// it: 80.6 us a step, of which the products alone take 75.7
// (rank_partials.cuh). The card holds 15
// clusters of 8 CTAs at this shared memory (120 CTAs) but 66 of 2, so the
// 128 CTAs run in one wave only up to cs = 2 (rank.partials_cluster takes
// the largest cs that adds no wave).
#pragma once

#include "rank_partials.cuh"

namespace amt {

template <int P, int MODE>
__global__ void __launch_bounds__(kPartialsThreads, 1)
    rank_partials_fwd_kernel(const float* __restrict__ abt,
                             const float* __restrict__ bbt,
                             const float* __restrict__ xbt,
                             const float* __restrict__ t0,
                             const float* __restrict__ se,
                             float* __restrict__ eh, float* __restrict__ tr,
                             float* __restrict__ tfin, float* __restrict__ ys,
                             float* __restrict__ ck, int D, int n_steps,
                             int B, int S, int rc, int unroll,
                             float norm_eps) {
  constexpr bool kRows = MODE == kStream || MODE == kRecompute;
  extern __shared__ __align__(128) uint32_t smem[];
  const PartialsSmem sm(smem, D, rc);
  const int n = 2 * D;
  const Product prods[2] = {{{abt, bbt}, 2}, {{xbt, nullptr}, 1}};
  // kRecompute: steps k_lo .. k_hi - 1 of block blockIdx.y from its
  // checkpoint; otherwise every step from t0
  const int k_lo = MODE == kRecompute ? blockIdx.y * unroll : 0;
  const int k_hi =
      MODE == kRecompute ? min(k_lo + unroll, n_steps) : n_steps;
  sm.init();
  if (threadIdx.x >= kConsumers) {
    produce(sm, prods, MODE == kRecompute ? 1 : 2, k_hi - k_lo, n);
  } else {
    const RhoTile tl(D, rc);
    const int j = blockIdx.x;
    const int b = j / (S / B);
    // offsets in size_t: the stream holds n_steps * 2D * cols elements
    const size_t cols = static_cast<size_t>(S) * rc;
    const size_t col0 = static_cast<size_t>(j) * rc;
    const size_t plane = static_cast<size_t>(n) * cols;
    uint32_t q = 0;
    float y[8][4];
    load_tile(y, MODE == kRecompute ? t0 + blockIdx.y * plane : t0, cols,
              col0, tl);
    store_tile<P>(sm.st, tl, y);
    consumer_sync();
    for (int k = k_lo; k < k_hi; ++k) {
      if (MODE == kCkpt && k % unroll == 0)
        store_tile_global(ck + (k / unroll) * plane, cols, col0, tl, y);
      const float s = se[static_cast<size_t>(k) * B + b];
      {
        float a[1][8][4];
        ring_product<P, 1, true>(sm, q, prods[0], s, tl, a);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) y[r][c] = a[0][r][c];
      }
      consumer_sync();   // every consumer is past the product: st is free
      store_tile<P>(sm.st, tl, y);
      if (kRows) store_tile_global(ys + k * plane, cols, col0, tl, y);
      consumer_sync();
      // kRecompute writes the states alone: its blocks end at their exits,
      // so it needs neither the partials nor the exit renorm
      if (MODE == kRecompute) continue;
      float ehat, trv;
      {
        float g[1][8][4];
        ring_product<P, 1, false>(sm, q, prods[1], 0.f, tl, g);
        // (its barrier also puts every consumer past the product)
        consumer_sum2(tile_dot(y, g[0], tl), tile_dot(y, y, tl), sm.red,
                      ehat, trv);
      }
      if (threadIdx.x == 0) {
        eh[static_cast<size_t>(k) * S + j] = ehat;
        tr[static_cast<size_t>(k) * S + j] = trv;
      }
      if ((k + 1) % unroll == 0) {
        const float inv = rsqrtf(floor_at(trv, norm_eps));
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) y[r][c] = y[r][c] * inv;
        store_tile<P>(sm.st, tl, y);
        consumer_sync();
      }
    }
    if (MODE != kRecompute) store_tile_global(tfin, cols, col0, tl, y);
  }
  // no CTA leaves while a peer may still copy to it or arrive on it
  cluster_sync();
}

// Launch the partials forward for the runtime precision: S CTAs, or S x
// n_blocks with kRecompute (t0 then holds the n_blocks checkpoints), in
// clusters of `cluster` segments. The pointers a MODE does not write may be
// null.
template <int MODE>
cudaError_t launch_partials_fwd(const float* abt, const float* bbt,
                                const float* xbt, const float* t0,
                                const float* se, float* eh, float* tr,
                                float* tfin, float* ys, float* ck, int D,
                                int n_steps, int B, int S, int rc, int unroll,
                                float norm_eps, int precision, int cluster,
                                cudaStream_t stream) {
  if (!partials_fits(D, rc) || B < 1 || S % B || unroll < 1 ||
      !cluster_ok(cluster, S / B)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(S, MODE == kRecompute ? (n_steps + unroll - 1) / unroll
                                        : 1);
  if (grid.y == 0) return cudaSuccess;
  return dispatch_precision(precision, [&](auto p) {
    return launch_partials(
        rank_partials_fwd_kernel<decltype(p)::value, MODE>, grid, cluster,
        false, partials_smem_bytes(D, rc), stream, abt, bbt, xbt, t0, se, eh,
        tr, tfin, ys, ck, D, n_steps, B, S, rc, unroll, norm_eps);
  });
}

}  // namespace amt
