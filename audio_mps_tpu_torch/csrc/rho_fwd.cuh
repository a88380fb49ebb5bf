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
//   ehat = sum(y .* gx), tr = sum(y .* y)      (over the whole segment, in
//                                               one fixed order)
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
// blocks = 256 clusters).
//
// Replaces: the TPU kernels of audio_mps_tpu/ops/pallas_block.py
// rho_nll_block (the inline kernel :2519), _make_rho_fwd_kernel_batched
// (:1366, stream=True, the training default) and _make_rho_fwd_kernel
// (:1602, defer_norm=False). On the TPU the grid walks time blocks, the
// expectation GEMM batches over a block's states and the segment sums go
// through a 0/1 matrix; here a cluster of CTAs owns an example and loops
// over all steps.
//
// Design (rho_cluster.cuh): an example's segment spread over a cluster of
// C CTAs by its rank columns, each CTA with Ab, Bb and Xb j-major in its
// shared memory (3 x 64 KB at D=64; Xb is not loaded with kRecompute) and
// the prepped state of its columns, one row x BC columns a thread. A step
// k reads the state buffer holding t_k = y_{k-1} once for three products:
//   Xb y_{k-1} (the expectation of the previous step, when no exchange
//   ran after it), Ab t_k and Bb t_k, so y_k = Ab t_k + s (Bb t_k),
// then writes y_k to the other buffer and takes one CTA barrier. With two
// buffers the next step's y goes to the buffer this step read, which
// every thread left before the barrier: one barrier a step. Where two
// buffers do not fit the card's shared memory (C=1 at D=64, R > 32) one
// buffer takes a second barrier a step, before y overwrites t. Each step's
// atoms of y .* gx and y .* y go to its slot by warp shuffles (the slot is
// complete once the next step has written its expectation, and is reduced
// after that step's barrier: three part sets, step mod 3, keep a reduce
// clear of the writes of the two steps after it).
// The sums wait in their slots until an exchange, at every renormalising
// step (every unroll-th step and the last with the deferred norm, every
// step without it) and every kRhoSlots steps, where the step's own Xb y
// runs alone: then the CTAs of the cluster agree on each waiting step's
// ehat and tr, in one order whatever C is; every CTA rescales its
// columns, and the CTA of rank 0 adds the steps' losses to its running sum
// (in step order) and writes their traces. So loss, ys, trs and ck are
// the same bits at every C and BC; the recompute (one block a cluster) is
// the streamed forward's rows bit for bit.
//
// What bounds it: 3 x 2 x (2D)^2 x R FLOPs per example-step (6.3 MFLOP at
// D=64, R=64) on the fp32 pipes of C SMs per example (at B=8, C=8: 64 of
// 132 SMs, one 4-warp CTA each), and more so the shared-memory pipeline: a
// row j costs each warp 3 32-bit constant loads and 2 16-byte state
// broadcasts for 24 FMAs a lane, and the pipeline takes a load's 32 lanes'
// bytes whether they are distinct or one broadcast; an exchange costs a
// few CTA barriers and a cluster barrier a block.
#pragma once

#include "rho_cluster.cuh"

namespace amt {

// Words of one forward CTA's dynamic shared memory (host and device): the
// constants (Xb not with kRecompute), nbuf state buffers [2D, sw], the
// sums' slots (2 sums a step) and the slots' increments.
__host__ __device__ inline int rho_fwd_words(int D, int R, int C, int mode,
                                             int nbuf) {
  const RhoLayout L(D, R, C);
  const int nmat = mode == kRecompute ? 2 : 3;
  return nmat * L.n * L.n + nbuf * L.n * L.sw +
         rho_sums_words(L, 2, kRhoSlots) + kRhoSlots;
}

inline size_t rho_fwd_smem_bytes(int D, int R, int C, int mode,
                                 int nbuf) {
  return 4 * static_cast<size_t>(rho_fwd_words(D, R, C, mode, nbuf));
}

// State buffers of a forward CTA: 2 where they fit `optin` bytes, else 1.
inline int rho_fwd_buffers(int D, int R, int C, int mode, int optin) {
  return rho_fwd_smem_bytes(D, R, C, mode, 2) <= static_cast<size_t>(optin)
             ? 2 : 1;
}

template <int P, bool DEFER, int MODE, int BC>
__global__ void __launch_bounds__(kRhoCtaThreads)
    rho_fwd_kernel(const float* __restrict__ ab, const float* __restrict__ bb,
                   const float* __restrict__ xb, const float* __restrict__ t0,
                   const float* __restrict__ se, float* __restrict__ loss,
                   float* __restrict__ ys, float* __restrict__ trs,
                   float* __restrict__ ck, int D, int n_steps, int B, int R,
                   int unroll, float log_eps, float norm_eps, int C,
                   int nbuf) {
  constexpr bool kRows = MODE == kStream || MODE == kRecompute;
  constexpr bool kX = MODE != kRecompute;   // the expectation is needed
  constexpr int kMats = kX ? 3 : 2;
  extern __shared__ __align__(16) uint32_t smem[];
  const RhoLayout L(D, R, C);
  const int cta = blockIdx.x % C;   // the CTA's rank in its cluster
  const int b = blockIdx.x / C;
  const RhoCTile<BC> tl(L, cta);
  const int n = L.n;
  uint32_t* abt = smem;
  uint32_t* bbt = abt + n * n;
  uint32_t* xbt = bbt + n * n;
  // state buffer c at st0 + c * n sw, computed from smem each time (an
  // array of the two pointers lives on the stack, and loads through it
  // lose the shared address space)
  uint32_t* const st0 = smem + kMats * n * n;
  const int bw = n * L.sw;
  float* slots = reinterpret_cast<float*>(st0 + nbuf * bw);
  const RhoSums sums(slots, L, 2, kRhoSlots);
  float* sval = slots + rho_sums_words(L, 2, kRhoSlots);  // thread 0
  const uint32_t* const upd[2] = {abt, bbt};
  const uint32_t* const fused[3] = {abt, bbt, xbt};
  const uint32_t* const expect[1] = {xbt};

  // offsets in size_t: the stream holds n_steps * 2D * B*R elements
  const size_t cols = static_cast<size_t>(B) * R;
  const size_t col0 = static_cast<size_t>(b) * R;
  const size_t plane = static_cast<size_t>(n) * cols;
  const size_t stride = static_cast<size_t>(B);

  load_matrix_t<P>(abt, ab, n);
  load_matrix_t<P>(bbt, bb, n);
  if (kX) load_matrix_t<P>(xbt, xb, n);
  // kRecompute: steps k_lo .. k_hi - 1 of block blockIdx.y from its
  // checkpoint; otherwise every step from t0
  const int k_lo = MODE == kRecompute ? blockIdx.y * unroll : 0;
  const int k_hi =
      MODE == kRecompute ? min(k_lo + unroll, n_steps) : n_steps;
  float y[BC];
  load_ctile(y, MODE == kRecompute ? t0 + blockIdx.y * plane : t0, cols,
             col0, tl);
  store_ctile<P>(st0, tl, y);
  __syncthreads();

  int cur = 0;          // the buffer holding t_k
  int slot = 0;         // steps waiting for the next exchange
  int par = 0;          // the exchange's P set
  bool xpend = false;   // y_{k-1}'s expectation runs in step k
  float acc = 0.f;      // the running loss (thread 0 of rank 0)
  float trp = 1.f;      // the trace e divides by (thread 0)
  float s = k_lo < k_hi ? se[k_lo * stride + b] : 0.f;
  for (int k = k_lo; k < k_hi; ++k) {
    if (MODE == kCkpt && k % unroll == 0)
      store_ctile_global(ck + (k / unroll) * plane, cols, col0, tl, y);
    const float s_next = (k + 1 < k_hi) ? se[(k + 1) * stride + b] : 0.f;
    const bool xk = xpend;   // this step completes step k-1's slot
    {
      float a[3][BC];
      if (kX && xk) {
        ctile_products<P, BC, 3>(fused, st0 + cur * bw, tl, a);
        float pe[BC / 4];
        ctile_dots(y, a[2], tl, pe);
        sums.write((k + kRhoParts - 1) % kRhoParts, 0, tl, pe);
      } else {
        float u[2][BC];
        ctile_products<P, BC, 2>(upd, st0 + cur * bw, tl, u);
#pragma unroll
        for (int c = 0; c < BC; ++c) {
          a[0][c] = u[0][c];
          a[1][c] = u[1][c];
        }
      }
#pragma unroll
      for (int c = 0; c < BC; ++c) y[c] = a[0][c] + s * a[1][c];
    }
    {
      float pt[BC / 4];
      ctile_dots(y, y, tl, pt);
      sums.write(k % kRhoParts, 1, tl, pt);
      if (!kX) {
#pragma unroll
        for (int q = 0; q < BC / 4; ++q) pt[q] = 0.f;
        sums.write(k % kRhoParts, 0, tl, pt);
      }
    }
    if (threadIdx.x == 0) sval[slot] = s;
    const int nxt = nbuf == 2 ? cur ^ 1 : cur;
    if (nbuf == 1) __syncthreads();  // every read of t_k is done
    store_ctile<P>(st0 + nxt * bw, tl, y);
    if (kRows) store_ctile_global(ys + k * plane, cols, col0, tl, y);
    __syncthreads();  // buffer nxt holds y_k; the slots' parts are written
    if (kX && xk)
      sums.reduce((k + kRhoParts - 1) % kRhoParts, slot - 1, par);
    if (!kX) sums.reduce(k % kRhoParts, slot, par);
    ++slot;
    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    if (renorm || slot == kRhoSlots || k + 1 == k_hi) {
      if (kX) {
        // step k's expectation alone, then its slot
        float g[1][BC], pe[BC / 4];
        ctile_products<P, BC, 1>(expect, st0 + nxt * bw, tl, g);
        ctile_dots(y, g[0], tl, pe);
        sums.write(k % kRhoParts, 0, tl, pe);
        __syncthreads();
        sums.reduce(k % kRhoParts, slot - 1, par);
      }
      if (C > 1) {
        cluster_sync();  // every CTA's group sums of the slots are written
        sums.gather(par, slot, -1);
      }
      __syncthreads();  // tot holds the slots' sums
      if (threadIdx.x == 0) {
        for (int i = 0; i < slot; ++i) {
          const int kk = k - slot + 1 + i;
          const float ehat = sums.total(i, 0), tr = sums.total(i, 1);
          if (kRows && cta == 0) trs[kk * stride + b] = tr;
          if (kX) {
            const float e = DEFER ? ehat / floor_at(trp, norm_eps) : ehat;
            acc -= logf(floor_at(1.f + e * sval[i], log_eps));
          }
          trp = (!DEFER || (kk + 1) % unroll == 0) ? 1.f : tr;
        }
      }
      if (renorm) {
        const float inv = rsqrtf(floor_at(sums.total(slot - 1, 1), norm_eps));
#pragma unroll
        for (int c = 0; c < BC; ++c) y[c] = y[c] * inv;
        store_ctile<P>(st0 + nxt * bw, tl, y);
        __syncthreads();  // buffer nxt holds t_{k+1}
      }
      slot = 0;
      par ^= 1;
      xpend = false;
    } else {
      xpend = kX;
    }
    cur = nxt;
    s = s_next;
  }
  if (kX && threadIdx.x == 0 && cta == 0) loss[b] = acc;
  if (C > 1) cluster_sync();  // no CTA leaves while another reads its sums
}

// Launch the forward for the runtime precision and norm flag: B clusters
// of C CTAs, or B x n_blocks with kRecompute (t0 then holds the n_blocks
// checkpoints). The pointers a MODE does not write may be null.
template <int MODE>
cudaError_t launch_rho_fwd(const float* ab, const float* bb, const float* xb,
                           const float* t0, const float* se, float* loss,
                           float* ys, float* trs, float* ck, int D,
                           int n_steps, int B, int R, int unroll,
                           float log_eps, float norm_eps, int precision,
                           bool defer, int C, cudaStream_t stream) {
  if (unroll < 1 || !rho_cluster_ok(C, R)) return cudaErrorInvalidValue;
  const dim3 grid(B * C, MODE == kRecompute ? (n_steps + unroll - 1) / unroll
                                            : 1);
  if (grid.y == 0) return cudaSuccess;
  const int nbuf = rho_fwd_buffers(D, R, C, MODE, smem_optin());
  const RhoLayout L(D, R, C);
  const size_t smem = rho_fwd_smem_bytes(D, R, C, MODE, nbuf);
  return dispatch(precision, defer, [&](auto p, auto d) {
    return dispatch_cols4(L.BC, [&](auto bc) {
      return launch_cluster(
          rho_fwd_kernel<decltype(p)::value, decltype(d)::value, MODE,
                         decltype(bc)::value>,
          grid, L.threads, C, false, smem, stream, ab, bb, xb, t0, se, loss,
          ys, trs, ck, D, n_steps, B, R, unroll, log_eps, norm_eps, C, nbuf);
    });
  });
}

// Clusters of C forward CTAs (highest, deferred norm) the card holds at
// once; a negative cudaError_t when the query fails.
template <int MODE>
int rho_fwd_max_clusters(int D, int R, int C) {
  if (!rho_cluster_ok(C, R)) return -static_cast<int>(cudaErrorInvalidValue);
  const int nbuf = rho_fwd_buffers(D, R, C, MODE, smem_optin());
  const size_t smem = rho_fwd_smem_bytes(D, R, C, MODE, nbuf);
  const RhoLayout L(D, R, C);
  switch (L.BC) {
    case 4:
      return max_active_clusters(rho_fwd_kernel<kHighest, true, MODE, 4>,
                                 L.threads, C, smem);
    case 8:
      return max_active_clusters(rho_fwd_kernel<kHighest, true, MODE, 8>,
                                 L.threads, C, smem);
    default:
      return max_active_clusters(rho_fwd_kernel<kHighest, true, MODE, 16>,
                                 L.threads, C, smem);
  }
}

}  // namespace amt
