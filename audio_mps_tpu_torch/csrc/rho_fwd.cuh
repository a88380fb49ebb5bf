// The rho forward chain (purification factor, block-complex layout) for
// Hopper, shared by the forward-only NLL (rho_nll.cu, kNll), the training
// forward with the state stream or with block checkpoints
// (rho_train_fwd.cu, kStream / kCkpt) and the recompute of the recompute
// adjoint (rho_recompute.cu, kRecompute).
//
// One step on one example's folded factor segment t ([2D, R], R = rank),
// with s the example's increment / A:
//   y    = Ab t + s (Bb t)
//   gx   = Xb y                               (X^T H'', the expectation)
//   ehat = sum(y .* gx), tr = sum(y .* y)      (over the whole segment: one
//                                               CTA reduction of both)
//   per-step norm: loss -= log(max(1 + ehat s, log_eps));
//                  t = y rsqrt(max(tr, eps))
//   deferred norm: e = ehat / max(tr_prev, eps); same loss; t = y,
//                  tr_prev = tr, renormalised (and tr_prev = 1) at every
//                  unroll-th step, where the TPU kernel renormalises at its
//                  block exits.
// The kernel writes loss[B]; the batch mean stays outside. With kStream it
// also writes ys[k] = y_k ([n_steps, 2D, B*R], example b in columns
// b*R .. b*R + R - 1) and trs[k] = tr_k ([n_steps, B]): the adjoint
// (rho_train_bwd.cu) and the cotangents (psi_cotangents.cu over the B*R
// lanes) rebuild each step's input t_k = y_{k-1} * (renorm ? rsqrt(max(tr,
// eps)) : 1) with the instructions used here, bit for bit. With kCkpt it
// writes instead ck[j] = t_{j unroll} ([n_blocks, 2D, B*R]), the factor
// entering each unroll-step block (after the previous block's exit
// renorm). With kRecompute CTA (example, j) re-runs block j of a segment
// from its checkpoint t0[j] and writes that block's rows of ys and trs, no
// loss: the same loop over fewer steps, so bit for bit the kStream
// forward's rows, and a segment's blocks side by side (8 examples x 32
// blocks = 256 CTAs where the forward has 8).
//
// Replaces: the TPU kernels of audio_mps_tpu/ops/pallas_block.py
// rho_nll_block (the inline kernel :2519), _make_rho_fwd_kernel_batched
// (:1366, stream=True, the training default) and _make_rho_fwd_kernel
// (:1602, defer_norm=False). On the TPU the grid walks time blocks, the
// expectation GEMM batches over a block's states and the segment sums go
// through a 0/1 matrix; here a CTA owns an example and loops over all
// steps, and the segment sums are CTA reductions.
//
// Shared memory (rho_tile.cuh): Ab, Bb and Xb j-major, 3 x 64 KB at D=64,
// and one prepped state tile of 32 KB at R=64: 224 KB of the 227 KB a block
// may have. y gets no tile of its own: it is computed into registers, then
// overwrites t in the tile (t is dead by then) for the Xb product, and is
// rescaled in place at a renormalising step.
//
// What bounds it: 3 x 2 x (2D)^2 x R FLOPs per example-step (6.3 MFLOP at
// D=64, R=64) on the fp32 pipes of one SM per example: with B=8 only 8 of
// 132 SMs have work, so it runs at best at 8/132 of the card's fp32 peak.
// Splitting an example over a thread-block cluster, with distributed shared
// memory for the per-step sums, is later work.
#pragma once

#include "rho_tile.cuh"

namespace amt {

template <int P, bool DEFER, int MODE>
__global__ void __launch_bounds__(kRhoMaxThreads)
    rho_fwd_kernel(const float* __restrict__ ab, const float* __restrict__ bb,
                   const float* __restrict__ xb, const float* __restrict__ t0,
                   const float* __restrict__ se, float* __restrict__ loss,
                   float* __restrict__ ys, float* __restrict__ trs,
                   float* __restrict__ ck, int D, int n_steps, int B, int R,
                   int unroll, float log_eps, float norm_eps) {
  constexpr bool kRows = MODE == kStream || MODE == kRecompute;
  extern __shared__ __align__(16) uint32_t smem[];
  const RhoTile tl(D, R);
  const int n = tl.n;
  uint32_t* abt = smem;
  uint32_t* bbt = abt + n * n;
  uint32_t* xbt = bbt + n * n;
  uint32_t* st = xbt + n * n;
  float* red = reinterpret_cast<float*>(st + n * tl.rs);   // 2 x 32 partials
  const uint32_t* const upd[2] = {abt, bbt};
  const uint32_t* const expect[1] = {xbt};

  const int b = blockIdx.x;
  // offsets in size_t: the stream holds n_steps * 2D * B*R elements
  const size_t cols = static_cast<size_t>(B) * R;
  const size_t col0 = static_cast<size_t>(b) * R;
  const size_t plane = static_cast<size_t>(n) * cols;
  const size_t stride = static_cast<size_t>(B);

  load_matrix_t<P>(abt, ab, n);
  load_matrix_t<P>(bbt, bb, n);
  if (MODE != kRecompute) load_matrix_t<P>(xbt, xb, n);
  // kRecompute: steps k_lo .. k_hi - 1 of block blockIdx.y from its
  // checkpoint; otherwise every step from t0
  const int k_lo = MODE == kRecompute ? blockIdx.y * unroll : 0;
  const int k_hi =
      MODE == kRecompute ? min(k_lo + unroll, n_steps) : n_steps;
  float y[8][4];
  load_tile(y, MODE == kRecompute ? t0 + blockIdx.y * plane : t0, cols,
            col0, tl);
  store_tile<P>(st, tl, y);

  float acc = 0.f;
  float trp = 1.f;
  float s = k_lo < k_hi ? se[k_lo * stride + b] : 0.f;
  for (int k = k_lo; k < k_hi; ++k) {
    if (MODE == kCkpt && k % unroll == 0)
      store_tile_global(ck + (k / unroll) * plane, cols, col0, tl, y);
    __syncthreads();  // the state tile holds t_k
    const float s_next = (k + 1 < k_hi) ? se[(k + 1) * stride + b] : 0.f;
    {
      float a[2][8][4];
      tile_products<P, 2>(upd, st, tl, a);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) y[r][c] = a[0][r][c] + s * a[1][r][c];
    }
    __syncthreads();  // every read of t_k is done
    store_tile<P>(st, tl, y);
    if (kRows) store_tile_global(ys + k * plane, cols, col0, tl, y);
    __syncthreads();
    float ehat, tr;
    {
      // the expectation feeds the loss alone, which kRecompute does not
      // write
      float part = 0.f;
      if (MODE != kRecompute) {
        float g[1][8][4];
        tile_products<P, 1>(expect, st, tl, g);
        part = tile_dot(y, g[0], tl);
      }
      block_sum2(part, tile_dot(y, y, tl), red, ehat, tr);
    }
    if (kRows && threadIdx.x == 0) trs[k * stride + b] = tr;
    const float e = DEFER ? ehat / floor_at(trp, norm_eps) : ehat;
    acc -= logf(floor_at(1.f + e * s, log_eps));
    if (!DEFER || (k + 1) % unroll == 0) {
      // every thread is past the Xb product (block_sum2 synchronised)
      const float inv = rsqrtf(floor_at(tr, norm_eps));
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) y[r][c] = y[r][c] * inv;
      store_tile<P>(st, tl, y);
      trp = 1.f;
    } else {
      trp = tr;
    }
    s = s_next;
  }
  if (MODE != kRecompute && threadIdx.x == 0) loss[b] = acc;
}

// Dynamic shared memory of one forward CTA: Ab, Bb, Xb (4 bytes an
// element), the state tile and a 64-float reduction buffer.
inline size_t rho_fwd_smem_bytes(int D, int R) {
  const size_t n = 2 * static_cast<size_t>(D);
  return (3 * n * n + rho_state_words(D, R) + 64) * 4;
}

// Launch the forward for the runtime precision and norm flag: B CTAs, or B
// x n_blocks with kRecompute (t0 then holds the n_blocks checkpoints). The
// pointers a MODE does not write may be null.
template <int MODE>
cudaError_t launch_rho_fwd(const float* ab, const float* bb, const float* xb,
                           const float* t0, const float* se, float* loss,
                           float* ys, float* trs, float* ck, int D,
                           int n_steps, int B, int R, int unroll,
                           float log_eps, float norm_eps, int precision,
                           bool defer, cudaStream_t stream) {
  if (unroll < 1) return cudaErrorInvalidValue;
  const dim3 grid(B, MODE == kRecompute ? (n_steps + unroll - 1) / unroll
                                        : 1);
  if (grid.y == 0) return cudaSuccess;
  return dispatch(precision, defer, [&](auto p, auto d) {
    return launch_smem(
        rho_fwd_kernel<decltype(p)::value, decltype(d)::value, MODE>, grid,
        rho_threads(D, R), rho_fwd_smem_bytes(D, R), stream, ab, bb, xb, t0,
        se, loss, ys, trs, ck, D, n_steps, B, R, unroll, log_eps, norm_eps);
  });
}

}  // namespace amt
