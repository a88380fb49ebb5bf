// Streamed adjoint of the rank partials (rank_partials_fwd.cu) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_rank.py
// _make_rank_partials_bwd_kernel_stream (:259): the reverse chain over the
// states the forward streamed, driven by the cotangents of its outputs, deh
// and dtr [n_steps, S] (from the host's combination) and dtfin [2D, cols]
// (from the next time segment; zero after the last). The three [2D,2D]
// cotangents, which the TPU kernel accumulates in its own body
// (:356-358), are the psi cotangent kernel (psi_cotangents.cu) run over the
// lanes; this file hands it dy_k.
//
// Step k in reverse for segment j (example b), with dt the cotangent of
// t_{k+1}, y = y_k, s = se[k, b]:
//   tail (free of the chain, all (step, segment) pairs at once):
//     q = deh[k, j] Xs y, Xs = Xb + Xb^T  (ehat = sum(y .* Xb y); written to
//                                          the dy stream)
//   chain:
//     dtr = dtr[k, j]; at a block exit ((k + 1) % unroll == 0), whose
//       rescale consumed tr_k: inv = rsqrt(max(tr_k, eps)),
//       dtr += tr_k > eps ? -0.5 sum(dt .* y) inv^3 : 0,  dt <- dt inv
//     dy = dt + (2 dtr y + q)
//     dt <- Ab^T dy + s (Bb^T dy);  dse[k, j] = sum((Bb^T dy) .* t_k)
// with t_k = y_{k-1} (* its exit scale) rebuilt from ys with the forward's
// instructions, t_0 = t0. dse is per segment ([n_steps, S]); the host sums
// an example's chunks, where the TPU spreads it over the rank lanes.
//
// Design: two kernels of one call, as rho_train_bwd.cu. The tail owns a
// segment over a range of steps (about 264 CTAs in all) and takes one
// product with the symmetric Xs (the host adds Xb and Xb^T once, the same
// fp32 sums a combine while staging would form); the chain is one CTA a
// segment looping over all steps in reverse, taking Ab^T dy and Bb^T dy as
// two products of one pass over the slabs of Ab and Bb. Both keep
// the segment's prepped tile in shared memory and stream the constants
// through the ring of rank_partials.cuh; clusters of cs CTAs share each
// slab by multicast, along the segment axis (the chain's x, the tail's y:
// the CTAs of a tail cluster cover the same steps of cs segments).
//
// What bounds it: 3 products of 2 (2D)^2 rc FLOPs a segment-step (52.8
// TFLOP at the D=256 model over 16384 steps, 788 ms at the fp32 peak). As
// in the forward (rank_partials.cuh), the products' FMA rate binds and the
// ring hides the fetch of the constants (2 MiB a chain step, 1 MiB a tail
// step at D=256): on an H100 at D=256, highest, the tail and the chain
// take 105.6 us a step, their products alone 99.6, their copies alone
// 44.7 (tools/partials_attribution.py).
#include "rank_partials.cuh"

namespace amt {

constexpr int kTailCtas = 264;   // two waves on 132 SMs

// The step ranges each segment's tail is split into: about kTailCtas CTAs.
inline int tail_split(int S, int n_steps) {
  const int split = (kTailCtas + S - 1) / S;
  return split < n_steps ? split : n_steps;
}

template <int P>
__global__ void __launch_bounds__(kPartialsThreads, 1)
    rank_partials_tail_kernel(const float* __restrict__ xs,
                              const float* __restrict__ ys,
                              const float* __restrict__ deh,
                              float* __restrict__ dys, int D, int n_steps,
                              int S, int rc) {
  extern __shared__ __align__(128) uint32_t smem[];
  const PartialsSmem sm(smem, D, rc);
  const int n = 2 * D;
  const Product sym = {{xs, nullptr}, 1};   // Xs is its own j-major form
  const int nsplit = gridDim.x;
  const int k_lo = static_cast<int>(static_cast<long long>(n_steps) *
                                    blockIdx.x / nsplit);
  const int k_hi = static_cast<int>(static_cast<long long>(n_steps) *
                                    (blockIdx.x + 1) / nsplit);
  sm.init();
  if (threadIdx.x >= kConsumers) {
    produce(sm, &sym, 1, k_hi - k_lo, n);
  } else {
    const RhoTile tl(D, rc);
    const int j = blockIdx.y;
    const size_t cols = static_cast<size_t>(S) * rc;
    const size_t col0 = static_cast<size_t>(j) * rc;
    const size_t plane = static_cast<size_t>(n) * cols;
    uint32_t q = 0;
    for (int k = k_lo; k < k_hi; ++k) {
      float y[8][4];
      load_tile(y, ys + k * plane, cols, col0, tl);
      consumer_sync();   // every consumer is past the previous product
      store_tile<P>(sm.st, tl, y);
      consumer_sync();
      float a[1][8][4];
      ring_product<P, 1, false>(sm, q, sym, 0.f, tl, a);
      const float d = deh[static_cast<size_t>(k) * S + j];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[0][r][c] = d * a[0][r][c];
      store_tile_global(dys + k * plane, cols, col0, tl, a[0]);
    }
  }
  cluster_sync();
}

template <int P>
__global__ void __launch_bounds__(kPartialsThreads, 1)
    rank_partials_chain_kernel(const float* __restrict__ ab,
                               const float* __restrict__ bb,
                               const float* __restrict__ t0,
                               const float* __restrict__ se,
                               const float* __restrict__ ys,
                               const float* __restrict__ tr,
                               const float* __restrict__ dtr,
                               const float* __restrict__ dtfin,
                               float* __restrict__ dse,
                               float* __restrict__ dt0,
                               float* __restrict__ dys, int D, int n_steps,
                               int B, int S, int rc, int unroll,
                               float norm_eps) {
  extern __shared__ __align__(128) uint32_t smem[];
  const PartialsSmem sm(smem, D, rc);
  const int n = 2 * D;
  const Product mats = {{ab, bb}, 2};   // Ab^T dy, Bb^T dy
  sm.init();
  if (threadIdx.x >= kConsumers) {
    produce(sm, &mats, 1, n_steps, n);
  } else {
    const RhoTile tl(D, rc);
    float* red1 = sm.red;        // 8 warp partials each
    float* red2 = sm.red + 32;
    const int j = blockIdx.x;
    const int b = j / (S / B);
    const size_t cols = static_cast<size_t>(S) * rc;
    const size_t col0 = static_cast<size_t>(j) * rc;
    const size_t plane = static_cast<size_t>(n) * cols;
    uint32_t q = 0;
    float dt[8][4], y[8][4];
    load_tile(dt, dtfin, cols, col0, tl);
    if (n_steps > 0) load_tile(y, ys + (n_steps - 1) * plane, cols, col0, tl);
    for (int k = n_steps - 1; k >= 0; --k) {
      const size_t at = static_cast<size_t>(k) * S + j;
      const float s = se[static_cast<size_t>(k) * B + b];
      float dtr_k = dtr[at];
      if ((k + 1) % unroll == 0) {
        const float trk = tr[at];
        const float inv = rsqrtf(floor_at(trk, norm_eps));
        const float dinv = consumer_sum(tile_dot(dt, y, tl), red1);
        dtr_k += trk > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) dt[r][c] = dt[r][c] * inv;
      }
      {
        float qv[8][4];
        load_tile(qv, dys + k * plane, cols, col0, tl);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dt[r][c] = dt[r][c] + (y[r][c] * (2.f * dtr_k) + qv[r][c]);  // dy
      }
      store_tile_global(dys + k * plane, cols, col0, tl, dt);
      // every consumer is past the previous product (the dse sum synced)
      store_tile<P>(sm.st, tl, dt);
      consumer_sync();
      float a[2][8][4];
      ring_product<P, 2, false>(sm, q, mats, 0.f, tl, a);
      // y_{k-1} is the next step's y; t_k is it times its exit scale
      float sc = 1.f;
      bool scaled = false;
      if (k > 0) {
        load_tile(y, ys + (k - 1) * plane, cols, col0, tl);
        if (k % unroll == 0) {
          sc = rsqrtf(floor_at(tr[static_cast<size_t>(k - 1) * S + j],
                               norm_eps));
          scaled = true;
        }
      } else {
        load_tile(y, t0, cols, col0, tl);
      }
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (tl.valid(c)) {
            const float tk = scaled ? y[r][c] * sc : y[r][c];
            part = fmaf(a[1][r][c], tk, part);
          }
      const float dsum = consumer_sum(part, red2);
      if (threadIdx.x == 0) dse[at] = dsum;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dt[r][c] = a[0][r][c] + s * a[1][r][c];
    }
    store_tile_global(dt0, cols, col0, tl, dt);
  }
  cluster_sync();
}

template <int P>
cudaError_t launch_rank_bwd(const float* xs, const float* ab,
                            const float* bb,
                            const float* t0, const float* se,
                            const float* ys, const float* tr,
                            const float* deh, const float* dtr,
                            const float* dtfin, float* dse, float* dt0,
                            float* dys, int D, int n_steps, int B, int S,
                            int rc, int unroll, float norm_eps, int cluster,
                            cudaStream_t stream) {
  const size_t smem = partials_smem_bytes(D, rc);
  if (n_steps > 0) {
    const int split = tail_split(S, n_steps);
    const cudaError_t err = launch_partials(
        rank_partials_tail_kernel<P>, dim3(split, S), cluster, true, smem,
        stream, xs, ys, deh, dys, D, n_steps, S, rc);
    if (err != cudaSuccess) return err;
  }
  return launch_partials(rank_partials_chain_kernel<P>, dim3(S), cluster,
                         false, smem, stream, ab, bb, t0, se, ys, tr, dtr,
                         dtfin, dse, dt0, dys, D, n_steps, B, S, rc, unroll,
                         norm_eps);
}

}  // namespace amt

extern "C" {

// dse [n_steps, S], dt0 [2D, S*rc] and dys [n_steps, 2D, S*rc] from the
// forward's ys and tr and the cotangents deh, dtr [n_steps, S] and dtfin
// [2D, S*rc]. The constants come j-major: xs = Xb + Xb^T (symmetric) for
// the tail, ab and bb (the j-major forms of Ab^T and Bb^T) for the chain.
// See the
// note above. Both kernels run in clusters of `cluster` segments (1 .. 16,
// dividing S / B). precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_rank_partials_bwd(const float* xs, const float* ab, const float* bb,
                          const float* t0, const float* se,
                          const float* ys, const float* tr, const float* deh,
                          const float* dtr, const float* dtfin, float* dse,
                          float* dt0, float* dys, int D, int n_steps, int B,
                          int S, int rc, int unroll, float norm_eps,
                          int precision, int cluster, void* stream) {
  if (!amt::partials_fits(D, rc) || B < 1 || S % B ||
      !amt::cluster_ok(cluster, S / B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    return amt::launch_rank_bwd<decltype(p)::value>(
        xs, ab, bb, t0, se, ys, tr, deh, dtr, dtfin, dse, dt0, dys, D,
        n_steps, B, S, rc, unroll, norm_eps, cluster,
        static_cast<cudaStream_t>(stream));
  }));
}

}  // extern "C"
