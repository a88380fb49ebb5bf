// Adjoint of the rho training forward (purification factor, block-complex
// layout) for Hopper.
//
// Replaces the serial part and the batched tail of the TPU kernels
// audio_mps_tpu/ops/pallas_block.py _make_rho_bwd_kernel_batched (:1438,
// stream=True: the streamed-states adjoint, deferred norm) and
// _make_rho_bwd_kernel (:1689, defer_norm=False): the reverse chain over the
// factors that rho_train_fwd.cu streamed. The three [2D,2D] cotangents,
// which the TPU kernel accumulates in its own body (dotnt :1583-1585), are
// the psi cotangent kernel (psi_cotangents.cu) run over the B*R lanes; this
// file hands it dy_k and dehat_k. It also serves the recompute adjoints
// (_make_rho_bwd_kernel_batched with stream=False :1438,
// _make_rho_bwd_kernel_defer :1790, _make_rho_bwd_kernel :1689 without the
// stream): there it runs over one time segment of whole blocks at a time,
// on the factors rho_recompute.cu rebuilt from the checkpoints, with dtfin
// the cotangent of the factor entering the next segment.
//
// Step k in reverse for example b, with dt the cotangent of t_{k+1} (dtfin
// after the last step), y = y_k, s = se[k], trp the trace e divides by
// (tr_{k-1} inside a deferred block, else 1):
//   tail (free of the chain; the TPU batches it over a block, :1516-1562):
//     gx = Xb y; xt = Xb^T y; ehat = sum(y .* gx)
//     e = DEFER ? ehat / max(trp, eps) : ehat
//     arg = max(1 + e s, log_eps); darg = arg > log_eps ? -g / arg : 0
//     de = darg s; dehat = DEFER ? de / max(trp, eps) : de
//     dtrn = trp > eps ? -de e / max(trp, eps) : 0   (cotangent of tr_{k-1})
//     q = dehat (gx + xt)        (the e-path cotangent of y: written to dy)
//     dse = darg e               (the chain adds its share)
//   chain:
//     renorm step (every step without DEFER, every unroll-th with it):
//       inv = rsqrt(max(tr_k, eps)); dinv = sum(dt .* y)
//       dtr = tr_k > eps ? -0.5 dinv inv^3 : 0;  dt <- dt inv
//     else dtr = step k+1's dtrn (0 after the last step)
//     dy = dt + (2 dtr y + q)
//     dt <- Ab^T dy + s (Bb^T dy);  dse += sum((Bb^T dy) .* t_k)
// This is the TPU kernel's bookkeeping (the dtr used at step k is the
// cotangent of tr_k; a block's first step divides by the constant 1 and its
// dtrn is dropped). The port loops over the real steps only, so the last
// step's dtr is 0, as the TPU's zero-padded steps make it; and dse is
// emitted per example ([n_steps, B]) where the TPU spreads it over the rank
// lanes for jnp.repeat's adjoint to sum back. A segment ends at a block
// exit, whose renorm seeds its last step's dtr from dt, and the next
// segment's first step drops its dtrn: only dt crosses a segment boundary.
//
// Design. Two kernels of one launch. The tail runs over all (step, example)
// pairs at once: a CTA owns one example's segment over a range of steps,
// with Xb j-major for Xb y and Xb as it is for Xb^T y (2 x 64 KB at D=64)
// and the prepped y tile (32 KB). It writes q into the dy stream, which the
// chain then reads and overwrites with dy, so the adjoint needs no stream
// beside ys and dy. The chain loops over all steps in reverse in a cluster
// of C CTAs an example (rho_cluster.cuh: each CTA the dy of its rank
// columns, one row x BC columns a thread), with Ab and Bb as they are (the
// j-major form of the transposes, 2 x 64 KB) and two prepped dy buffers,
// so one CTA barrier a step: dy_k goes to the buffer step k+1 did not
// read. y_k, t_k (rebuilt from ys[k-1] with the forward's instructions,
// so bit for bit the forward's factor) and q are loaded into registers a
// step ahead, off the chain. Its sums take the exchange of rho_cluster.cuh:
// dinv at each renorm step (once a block with the deferred norm), and with
// it the dsum of the steps since the last exchange, which the CTA of rank
// 0 adds to dse. So dse, dt0, dy and dehat are the same bits at every C.
//
// What bounds it: the tail's 2 x 2 (2D)^2 R FLOPs per example-step are
// spread over the whole card (about 264 CTAs); the chain's 2 x 2 (2D)^2 R
// FLOPs per example-step (4.2 MFLOP at D=64, R=64) run on C SMs per
// example (at B=8, C=8: 64 of 132 SMs, 4 warps each); it also reads two
// and writes one [2D, R] slice of the streams a step (96 KB at R=64).
#include "rho_cluster.cuh"

namespace amt {

constexpr int kTailCtas = 264;   // two waves of one 160 KB CTA on 132 SMs

template <int P, bool DEFER>
__global__ void __launch_bounds__(kRhoMaxThreads)
    rho_bwd_tail_kernel(const float* __restrict__ xb,
                        const float* __restrict__ se,
                        const float* __restrict__ g,
                        const float* __restrict__ ys,
                        const float* __restrict__ trs,
                        float* __restrict__ dse, float* __restrict__ dys,
                        float* __restrict__ dehats, float* __restrict__ dtrns,
                        int D, int n_steps, int B, int R, int unroll,
                        float log_eps, float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const RhoTile tl(D, R);
  const int n = tl.n;
  uint32_t* xbt = smem;           // j-major of Xb:   Xb y
  uint32_t* xbm = xbt + n * n;    // j-major of Xb^T: Xb^T y
  uint32_t* st = xbm + n * n;
  float* red = reinterpret_cast<float*>(st + n * tl.rs);   // 32 partials
  const uint32_t* const mats[2] = {xbt, xbm};

  const int b = blockIdx.y;
  const int nsplit = gridDim.x;
  const int k_lo = static_cast<int>(static_cast<long long>(n_steps) *
                                    blockIdx.x / nsplit);
  const int k_hi = static_cast<int>(static_cast<long long>(n_steps) *
                                    (blockIdx.x + 1) / nsplit);
  const size_t stride = static_cast<size_t>(B);
  const size_t cols = static_cast<size_t>(B) * R;
  const size_t col0 = static_cast<size_t>(b) * R;
  const size_t plane = static_cast<size_t>(n) * cols;

  load_matrix_t<P>(xbt, xb, n);
  load_matrix<P>(xbm, xb, n);
  const float gb = g[b];
  for (int k = k_lo; k < k_hi; ++k) {
    float y[8][4];
    load_tile(y, ys + k * plane, cols, col0, tl);
    __syncthreads();  // the previous step's products are done with the tile
    store_tile<P>(st, tl, y);
    __syncthreads();
    float a[2][8][4];
    tile_products<P, 2>(mats, st, tl, a);
    const float ehat = block_sum(tile_dot(y, a[0], tl), red);
    const bool inside = DEFER && k % unroll != 0;
    const float trp = inside ? trs[(k - 1) * stride + b] : 1.f;
    const float trp_c = floor_at(trp, norm_eps);
    const float s = se[k * stride + b];
    const float e = DEFER ? ehat / trp_c : ehat;
    const float arg = floor_at(1.f + e * s, log_eps);
    const float darg = arg > log_eps ? -gb / arg : 0.f;
    const float de = darg * s;
    const float dehat = DEFER ? de / trp_c : de;
    if (threadIdx.x == 0) {
      dse[k * stride + b] = darg * e;
      dehats[k * stride + b] = dehat;
      dtrns[k * stride + b] = trp > norm_eps ? -de * e / trp_c : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        a[0][r][c] = dehat * (a[0][r][c] + a[1][r][c]);
    store_tile_global(dys + k * plane, cols, col0, tl, a[0]);
  }
}

// Words of one chain CTA's dynamic shared memory (host and device): Ab and
// Bb as they are, two dy buffers [2D, sw] and the sums' slots (one sum:
// kRhoSlots steps' dsum and one dinv; part sets 0-1 dsum by step parity,
// 2 dinv).
__host__ __device__ inline int rho_chain_words(int D, int R, int C) {
  const RhoLayout L(D, R, C);
  return 2 * L.n * L.n + 2 * L.n * L.sw +
         rho_sums_words(L, 1, kRhoSlots + 1);
}

inline size_t rho_chain_smem_bytes(int D, int R, int C) {
  return 4 * static_cast<size_t>(rho_chain_words(D, R, C));
}

template <int P, bool DEFER, int BC>
__global__ void __launch_bounds__(kRhoCtaThreads)
    rho_bwd_chain_kernel(const float* __restrict__ ab,
                         const float* __restrict__ bb,
                         const float* __restrict__ t0,
                         const float* __restrict__ se,
                         const float* __restrict__ ys,
                         const float* __restrict__ trs,
                         const float* __restrict__ dtrns,
                         const float* __restrict__ dtfin,
                         float* __restrict__ dse, float* __restrict__ dt0,
                         float* __restrict__ dys, int D, int n_steps, int B,
                         int R, int unroll, float norm_eps, int C) {
  constexpr int kDinv = kRhoSlots;   // the slot of dinv
  extern __shared__ __align__(16) uint32_t smem[];
  const RhoLayout L(D, R, C);
  const int cta = blockIdx.x % C;
  const int b = blockIdx.x / C;
  const RhoCTile<BC> tl(L, cta);
  const int n = L.n;
  uint32_t* abm = smem;           // j-major of Ab^T: Ab^T dy
  uint32_t* bbm = abm + n * n;    // j-major of Bb^T: Bb^T dy
  // dy buffer c at st0 + c * n sw, computed from smem each time (an array
  // of the two pointers lives on the stack, and loads through it lose the
  // shared address space)
  uint32_t* const st0 = smem + 2 * n * n;
  const int bw = n * L.sw;
  const RhoSums sums(reinterpret_cast<float*>(st0 + 2 * bw), L, 1,
                     kRhoSlots + 1);
  const uint32_t* const mats[2] = {abm, bbm};

  const size_t stride = static_cast<size_t>(B);
  const size_t cols = static_cast<size_t>(B) * R;
  const size_t col0 = static_cast<size_t>(b) * R;
  const size_t plane = static_cast<size_t>(n) * cols;

  load_matrix<P>(abm, ab, n);
  load_matrix<P>(bbm, bb, n);

  float dt[BC], y[BC];
  load_ctile(dt, dtfin, cols, col0, tl);
  if (n_steps > 0) load_ctile(y, ys + (n_steps - 1) * plane, cols, col0, tl);
  // step k's inputs, loaded a step ahead so that no global load waits on
  // the chain: q (the tail's part of dy), y_{k-1} (t0 at k = 0), and the
  // scalars
  float q[BC], tk[BC];
  float s = 0.f, tr = 0.f, trq = 0.f, dtrn_k = 0.f;
  auto fetch = [&](int k, float (&qq)[BC], float (&tt)[BC],
                   float& sk, float& trk, float& trqk, float& dk) {
    load_ctile(qq, dys + k * plane, cols, col0, tl);
    load_ctile(tt, k > 0 ? ys + (k - 1) * plane : t0, cols, col0, tl);
    sk = se[k * stride + b];
    trk = trs[k * stride + b];
    trqk = k > 0 ? trs[(k - 1) * stride + b] : 1.f;
    dk = dtrns[k * stride + b];
  };
  if (n_steps > 0) fetch(n_steps - 1, q, tk, s, tr, trq, dtrn_k);
  __syncthreads();  // the constants are in place

  float dtrn = 0.f;   // dtrn of step k+1
  int nsl = 0;        // steps whose dsum waits for the next exchange
  int par = 0;        // the exchange's P set
  int pend = -1;      // the part set of a dsum not yet reduced
  int nxt = 0;
  // the waiting slots' dsum into dse (the tail wrote its share): slot i
  // holds step k_first - i
  auto flush = [&](int k_first) {
    if (threadIdx.x == 0 && cta == 0)
      for (int i = 0; i < nsl; ++i)
        dse[(k_first - i) * stride + b] += sums.total(i, 0);
  };
  for (int k = n_steps - 1; k >= 0; --k) {
    float qk[BC], tkk[BC];
#pragma unroll
    for (int c = 0; c < BC; ++c) {
      qk[c] = q[c];
      tkk[c] = tk[c];
    }
    const float sk = s, trk = tr, trqk = trq, dk = dtrn_k;
    if (k > 0) fetch(k - 1, q, tk, s, tr, trq, dtrn_k);
    // step k-1 renormalised its output: t_k = y_{k-1} rsqrt(max(tr, eps))
    const bool prev_renorm = !DEFER || k % unroll == 0;
    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    float dtr = dtrn;
    if (renorm || nsl == kRhoSlots) {
      if (renorm) {
        float pd[BC / 4];
        ctile_dots(dt, y, tl, pd);
        sums.write(2, 0, tl, pd);
      }
      __syncthreads();  // every part of the exchange is written
      if (pend >= 0) sums.reduce(pend, nsl - 1, par);
      pend = -1;
      if (renorm) sums.reduce(2, kDinv, par);
      if (C > 1) {
        cluster_sync();  // every CTA's group sums are written
        sums.gather(par, nsl, renorm ? kDinv : -1);
      }
      __syncthreads();  // tot holds the sums
      flush(k + nsl);
      if (renorm) {
        const float inv = rsqrtf(floor_at(trk, norm_eps));
        const float dinv = sums.total(kDinv, 0);
        dtr = trk > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
#pragma unroll
        for (int c = 0; c < BC; ++c) dt[c] = dt[c] * inv;
      }
      nsl = 0;
      par ^= 1;
    }
#pragma unroll
    for (int c = 0; c < BC; ++c)
      dt[c] = dt[c] + (y[c] * (2.f * dtr) + qk[c]);   // dy
    store_ctile_global(dys + k * plane, cols, col0, tl, dt);
    store_ctile<P>(st0 + nxt * bw, tl, dt);
    __syncthreads();  // buffer nxt holds dy_k
    if (pend >= 0) sums.reduce(pend, nsl - 1, par);
    // y_{k-1} is the next step's y; t_k is it rescaled
    if (k > 0) {
      const float sc = prev_renorm ? rsqrtf(floor_at(trqk, norm_eps)) : 1.f;
#pragma unroll
      for (int c = 0; c < BC; ++c) {
        y[c] = tkk[c];
        if (prev_renorm) tkk[c] = tkk[c] * sc;
      }
    }
    float a[2][BC];
    ctile_products<P, BC, 2>(mats, st0 + nxt * bw, tl, a);
    {
      float pd[BC / 4];
      ctile_dots(a[1], tkk, tl, pd);
      pend = k & 1;
      sums.write(pend, 0, tl, pd);
    }
    ++nsl;
#pragma unroll
    for (int c = 0; c < BC; ++c) dt[c] = a[0][c] + sk * a[1][c];
    dtrn = dk;
    nxt ^= 1;
  }
  if (nsl > 0) {
    // the last steps' dsum
    __syncthreads();
    sums.reduce(pend, nsl - 1, par);
    if (C > 1) {
      cluster_sync();
      sums.gather(par, nsl, -1);
    }
    __syncthreads();
    flush(nsl - 1);
  }
  store_ctile_global(dt0, cols, col0, tl, dt);
  if (C > 1) cluster_sync();  // no CTA leaves while another reads its sums
}

inline size_t bwd_smem_bytes(int D, int R) {
  const size_t n = 2 * static_cast<size_t>(D);
  return (2 * n * n + rho_state_words(D, R) + 64) * 4;
}

template <int P, bool DEFER>
cudaError_t launch_rho_bwd(const float* ab, const float* bb, const float* xb,
                           const float* t0, const float* se, const float* g,
                           const float* ys, const float* trs,
                           const float* dtfin, float* dse, float* dt0,
                           float* dys, float* dehats, float* dtrns, int D,
                           int n_steps, int B, int R, int unroll,
                           float log_eps, float norm_eps, int C,
                           cudaStream_t stream) {
  if (!rho_cluster_ok(C, R)) return cudaErrorInvalidValue;
  const int threads = rho_threads(D, R);
  const size_t smem = bwd_smem_bytes(D, R);
  if (n_steps > 0) {
    int split = (kTailCtas + B - 1) / B;
    split = split < n_steps ? split : n_steps;
    auto* tail = rho_bwd_tail_kernel<P, DEFER>;
    cudaError_t err = cudaFuncSetAttribute(
        tail, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    tail<<<dim3(split, B), threads, smem, stream>>>(
        xb, se, g, ys, trs, dse, dys, dehats, dtrns, D, n_steps, B, R,
        unroll, log_eps, norm_eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const RhoLayout L(D, R, C);
  return dispatch_cols4(L.BC, [&](auto bc) {
    return launch_cluster(rho_bwd_chain_kernel<P, DEFER, decltype(bc)::value>,
                          dim3(B * C), L.threads, C, false,
                          rho_chain_smem_bytes(D, R, C), stream, ab, bb, t0,
                          se, ys, trs, dtrns, dtfin, dse, dt0, dys, D,
                          n_steps, B, R, unroll, norm_eps, C);
  });
}

// Clusters of C chain CTAs (highest, deferred norm) the card holds at once;
// a negative cudaError_t when the query fails.
inline int rho_chain_max_clusters(int D, int R, int C) {
  if (!rho_cluster_ok(C, R)) return -static_cast<int>(cudaErrorInvalidValue);
  const RhoLayout L(D, R, C);
  const size_t smem = rho_chain_smem_bytes(D, R, C);
  switch (L.BC) {
    case 4:
      return max_active_clusters(rho_bwd_chain_kernel<kHighest, true, 4>,
                                 L.threads, C, smem);
    case 8:
      return max_active_clusters(rho_bwd_chain_kernel<kHighest, true, 8>,
                                 L.threads, C, smem);
    default:
      return max_active_clusters(rho_bwd_chain_kernel<kHighest, true, 16>,
                                 L.threads, C, smem);
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one tail CTA: two [2D,2D] matrices (4 bytes an
// element), the state tile and 64 reduction floats.
size_t amt_rho_train_bwd_smem_bytes(int D, int R) {
  return amt::bwd_smem_bytes(D, R);
}

// Dynamic shared memory of one chain CTA in clusters of C.
size_t amt_rho_chain_smem_bytes(int D, int R, int C) {
  return amt::rho_chain_smem_bytes(D, R, C);
}

// Clusters of C chain CTAs the current card holds at once; a negative
// cudaError_t when the query fails.
int amt_rho_chain_max_clusters(int D, int R, int C) {
  return amt::rho_chain_max_clusters(D, R, C);
}

// dse[n_steps, B], dt0[2D, B*R], dys[n_steps, 2D, B*R] and
// dehats[n_steps, B] from the loss cotangent g[B], the forward's ys and
// trs, and dtfin[2D, B*R], the cotangent of the factor after the last step
// (zeros for one whole run); dtrns[n_steps, B] is scratch. The chain runs
// in clusters of `cluster` CTAs an example. See the kernel note above.
// precision: 0 highest, 1 high, 2 default. Returns a cudaError_t.
int amt_rho_train_bwd(const float* ab, const float* bb, const float* xb,
                      const float* t0, const float* se, const float* g,
                      const float* ys, const float* trs, const float* dtfin,
                      float* dse, float* dt0, float* dys, float* dehats,
                      float* dtrns, int D, int n_steps, int B, int R,
                      int unroll, float log_eps, float norm_eps,
                      int precision, int defer_norm, int cluster,
                      void* stream) {
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::launch_rho_bwd<decltype(p)::value, decltype(d)::value>(
            ab, bb, xb, t0, se, g, ys, trs, dtfin, dse, dt0, dys, dehats,
            dtrns, D, n_steps, B, R, unroll, log_eps, norm_eps, cluster,
            static_cast<cudaStream_t>(stream));
      }));
}

}  // extern "C"
