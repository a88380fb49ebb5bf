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
// beside ys and dy. The chain is one CTA per example looping over all steps
// in reverse, with Ab and Bb as they are (the j-major form of the
// transposes, 2 x 64 KB) and the prepped dy tile (32 KB); y_k, t_k (rebuilt
// from ys[k-1] with the forward's instructions, so bit for bit the
// forward's factor) and q are read from the streams into registers.
//
// What bounds it: the tail's 2 x 2 (2D)^2 R FLOPs per example-step are
// spread over the whole card (about 264 CTAs); the chain's 2 x 2 (2D)^2 R
// FLOPs per example-step (4.2 MFLOP at D=64, R=64) run on one SM per
// example, so at B=8 on 8 of 132 SMs; it also reads two and writes one
// [2D, R] slice of the streams a step (96 KB at R=64).
#include "rho_tile.cuh"

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

template <int P, bool DEFER>
__global__ void __launch_bounds__(kRhoMaxThreads)
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
                         int R, int unroll, float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const RhoTile tl(D, R);
  const int n = tl.n;
  uint32_t* abm = smem;           // j-major of Ab^T: Ab^T dy
  uint32_t* bbm = abm + n * n;    // j-major of Bb^T: Bb^T dy
  uint32_t* st = bbm + n * n;
  float* red1 = reinterpret_cast<float*>(st + n * tl.rs);  // 32 partials
  float* red2 = red1 + 32;                                  // 32 partials
  const uint32_t* const mats[2] = {abm, bbm};

  const int b = blockIdx.x;
  const size_t stride = static_cast<size_t>(B);
  const size_t cols = static_cast<size_t>(B) * R;
  const size_t col0 = static_cast<size_t>(b) * R;
  const size_t plane = static_cast<size_t>(n) * cols;

  load_matrix<P>(abm, ab, n);
  load_matrix<P>(bbm, bb, n);

  float dt[8][4], y[8][4];
  load_tile(dt, dtfin, cols, col0, tl);
  if (n_steps > 0) load_tile(y, ys + (n_steps - 1) * plane, cols, col0, tl);
  float dtrn = 0.f;   // dtrn of step k+1

  for (int k = n_steps - 1; k >= 0; --k) {
    const float s = se[k * stride + b];
    const float tr = trs[k * stride + b];
    // step k-1 renormalised its output: t_k = y_{k-1} rsqrt(max(tr, eps))
    const bool prev_renorm = !DEFER || k % unroll == 0;
    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    float tk[8][4];
    if (k > 0) {
      load_tile(tk, ys + (k - 1) * plane, cols, col0, tl);
    } else {
      load_tile(tk, t0, cols, col0, tl);
    }
    float dtr = dtrn;
    if (renorm) {
      const float inv = rsqrtf(floor_at(tr, norm_eps));
      const float dinv = block_sum(tile_dot(dt, y, tl), red1);
      dtr = tr > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dt[r][c] = dt[r][c] * inv;
    }
    {
      float q[8][4];
      load_tile(q, dys + k * plane, cols, col0, tl);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dt[r][c] = dt[r][c] + (y[r][c] * (2.f * dtr) + q[r][c]);   // dy
    }
    store_tile_global(dys + k * plane, cols, col0, tl, dt);
    __syncthreads();  // the previous step's products are done with the tile
    store_tile<P>(st, tl, dt);
    __syncthreads();
    // y_{k-1} is the next step's y; t_k is it rescaled
    if (k > 0) {
      const float sc =
          prev_renorm ? rsqrtf(floor_at(trs[(k - 1) * stride + b], norm_eps))
                      : 1.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          y[r][c] = tk[r][c];
          if (prev_renorm) tk[r][c] = tk[r][c] * sc;
        }
    }
    float a[2][8][4];
    tile_products<P, 2>(mats, st, tl, a);
    const float dsum = block_sum(tile_dot(a[1], tk, tl), red2);
    if (threadIdx.x == 0) dse[k * stride + b] += dsum;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dt[r][c] = a[0][r][c] + s * a[1][r][c];
    dtrn = dtrns[k * stride + b];
  }
  store_tile_global(dt0, cols, col0, tl, dt);
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
                           float log_eps, float norm_eps,
                           cudaStream_t stream) {
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
  return launch_smem(rho_bwd_chain_kernel<P, DEFER>, B, threads, smem,
                     stream, ab, bb, t0, se, ys, trs, dtrns, dtfin, dse, dt0,
                     dys, D, n_steps, B, R, unroll, norm_eps);
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one adjoint CTA (tail or chain): two [2D,2D]
// matrices (4 bytes an element), the state tile and 64 reduction floats.
size_t amt_rho_train_bwd_smem_bytes(int D, int R) {
  return amt::bwd_smem_bytes(D, R);
}

// dse[n_steps, B], dt0[2D, B*R], dys[n_steps, 2D, B*R] and
// dehats[n_steps, B] from the loss cotangent g[B], the forward's ys and
// trs, and dtfin[2D, B*R], the cotangent of the factor after the last step
// (zeros for one whole run); dtrns[n_steps, B] is scratch. See the kernel
// note above. precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_rho_train_bwd(const float* ab, const float* bb, const float* xb,
                      const float* t0, const float* se, const float* g,
                      const float* ys, const float* trs, const float* dtfin,
                      float* dse, float* dt0, float* dys, float* dehats,
                      float* dtrns, int D, int n_steps, int B, int R,
                      int unroll, float log_eps, float norm_eps,
                      int precision, int defer_norm, void* stream) {
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::launch_rho_bwd<decltype(p)::value, decltype(d)::value>(
            ab, bb, xb, t0, se, g, ys, trs, dtfin, dse, dt0, dys, dehats,
            dtrns, D, n_steps, B, R, unroll, log_eps, norm_eps,
            static_cast<cudaStream_t>(stream));
      }));
}

}  // extern "C"
