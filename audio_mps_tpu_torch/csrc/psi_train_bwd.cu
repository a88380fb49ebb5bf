// Adjoint of the psi training forward (block-complex layout) for Hopper.
//
// Replaces the serial part of the TPU kernels audio_mps_tpu/ops/
// pallas_block.py _make_psi_bwd_kernel_stream (the streamed-states adjoint,
// deferred norm) and _make_psi_bwd_kernel (defer_norm=False): the reverse
// chain over the states that psi_train_fwd.cu streamed. The three [2D,2D]
// cotangent reductions, which the TPU kernel runs in its own body, are
// psi_cotangents.cu; this kernel hands them dy_k and dehat_k. It also
// serves the recompute adjoint (_make_psi_bwd_kernel_defer :621 and
// _make_psi_bwd_kernel :529 without the stream): there it runs over one
// time segment of whole blocks at a time, on the states psi_recompute.cu
// rebuilt from the checkpoints, with dtfin the cotangent of the state
// entering the next segment (the dt0 of that segment's run).
//
// Step k in reverse, with dt the cotangent of t_{k+1} (dtfin after the
// last step, zero without it), y = y_k, s = se[k], n2p the squared norm e
// divides by (n2_{k-1} inside a deferred block, else 1):
//   ru = Rb y; ehat = 2 sum(y .* ru); e = DEFER ? ehat / max(n2p, eps) : ehat
//   arg = max(1 + e s, log_eps); darg = arg > log_eps ? -g / arg : 0
//   de = darg s; ds = darg e; dehat = DEFER ? de / max(n2p, eps) : de
//   dn2_new = n2p > eps ? -de e / max(n2p, eps) : 0   (cotangent of n2_{k-1})
//   renorm step (every step without DEFER, every unroll-th with it):
//     inv = rsqrt(max(n2_k, eps)); dinv = sum(dt .* y)
//     dn2 = n2_k > eps ? -0.5 dinv inv^3 : 0;  dt <- dt inv
//   else dn2 = step k+1's dn2_new (0 after the last step)
//   dy = dt + ((2 dn2 y + 2 dehat ru) + Rb^T (2 dehat y))
//   dt <- Ab^T dy + s (Bb^T dy);  ds += sum((Bb^T dy) .* t_k)
// This is the TPU kernel's dn2 bookkeeping: the dn2 used at step k is step
// k+1's dn2_new, the block-exit renorm seeds the last step of each block,
// and the dn2_new of a block's first step (its n2p is the constant 1) is
// dropped. The port loops over the real steps only, so the last step's dn2
// is 0, as the TPU's zero-padded steps make it. A segment ends at a block
// exit, whose renorm seeds its last step from dt, and the next segment's
// first step drops its dn2_new: so only dt crosses a segment boundary, and
// the segments' dse and dt0 equal one run's bit for bit.
//
// Design. A CTA owns G examples (columns xG .. xG + G - 1, the last group
// masked) and loops over all steps; thread i owns row i of all G. The chain
// needs Rb y, Rb^T dru, Ab^T dy and Bb^T dy: four orientations of three
// [2D,2D] matrices, 256 KB at D=64 if each were stored the way it is read,
// over the 227 KB a block may have. So each matrix is stored once,
// row-major with rows padded to 2D+1 words (3 x 128 x 129 x 4 = 198 KB at
// D=64): thread i walks row i for Rb y and column i for the transposes, and
// both walks are free of bank conflicts. The prepped vectors (y, dru, dy)
// are [2D, G] buffers read as broadcast 16-byte loads (load_cols), so each
// 4-byte load of a matrix feeds G FMAs; the per-column scalars are register
// arrays; one block_sum_cols gives the G columns' (ehat, dinv), another their
// ds sums. Every column's sums run in the G = 1 order (dot_cols /
// dot2_cols are dot_strided / dot2_strided a column, block_sum_cols is
// block_sum2 and block_sum a value), so a column's outputs are the same
// bits for every G. The state y_k is read back from the stream once per
// step (it is t_{k+1} of the step before, so each load serves two steps),
// G adjacent floats of a row.
//
// What bounds it: four [2D,2D] x [2D] products per example per step, each a
// shared-memory walk of one matrix (G FMAs per 4-byte load; at G = 1 one,
// in a dependent chain of 2D FMAs), plus five CTA barriers per step;
// device memory moves one state read and one dy write per step. As
// psi_fwd.cuh, it is bound by shared-memory reads and the chain's latency,
// not by device memory; the wrapper takes G as the forward does
// (ops/block.py psi_columns_per_cta: 1 at B=128, 8 at B=1024 on 132 SMs).
#include "common.cuh"

namespace amt {

// Words of the three padded constants, rounded up to 16-byte alignment for
// the [2D, G] buffers that follow.
__host__ __device__ inline int bwd_matrix_words(int n) {
  return (3 * n * (n + 1) + 3) & ~3;
}

template <int P, bool DEFER, int G>
__global__ void __launch_bounds__(256)
    psi_train_bwd_kernel(const float* __restrict__ ab,
                         const float* __restrict__ bb,
                         const float* __restrict__ rb,
                         const float* __restrict__ t0,
                         const float* __restrict__ se,
                         const float* __restrict__ g,
                         const float* __restrict__ ys,
                         const float* __restrict__ n2s,
                         const float* __restrict__ dtfin,
                         float* __restrict__ dse, float* __restrict__ dt0,
                         float* __restrict__ dys, float* __restrict__ dehats,
                         int D, int n_steps, int B, int unroll, float log_eps,
                         float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 2 * D;
  const int ld = n + 1;
  const int warps = blockDim.x >> 5;
  uint32_t* abm = smem;
  uint32_t* bbm = abm + n * ld;
  uint32_t* rbm = bbm + n * ld;
  float* yh = reinterpret_cast<float*>(smem + bwd_matrix_words(n));  // y
  float* yl = yh + n * G;
  float* uh = yl + n * G;                              // prepped dru
  float* ul = uh + n * G;
  float* wh = ul + n * G;                              // prepped dy
  float* wl = wh + n * G;
  float* red1 = wl + n * G;                            // 2G x warps
  float* red2 = red1 + 2 * G * warps;                  // G x warps

  const int col0 = blockIdx.x * G;
  const int i = threadIdx.x;
  const bool active = i < n;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;
  // the last group's columns past B are masked (one column a CTA never is)
  bool live[G];
#pragma unroll
  for (int q = 0; q < G; ++q) live[q] = G == 1 || col0 + q < B;

  load_matrix_pad<P>(abm, ab, n);
  load_matrix_pad<P>(bbm, bb, n);
  load_matrix_pad<P>(rbm, rb, n);

  float gc[G], dt[G], dn2n[G], y[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const size_t c = col0 + q;
    gc[q] = live[q] ? g[c] : 0.f;
    // the cotangent of t_{k+1}
    dt[q] = (dtfin != nullptr && active && live[q]) ? dtfin[i * stride + c]
                                                    : 0.f;
    dn2n[q] = 0.f;    // dn2_new of step k+1
    y[q] = (active && live[q] && n_steps > 0)
               ? ys[(n_steps - 1) * plane + i * stride + c] : 0.f;
  }

  for (int k = n_steps - 1; k >= 0; --k) {
    // step k-1 renormalised its output: t_k = y_{k-1} rsqrt(max(n2, eps))
    const bool prev_renorm = !DEFER || k % unroll == 0;
    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    float s[G], n2[G], n2prev[G], yp[G], tk[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const size_t c = col0 + q;
      s[q] = live[q] ? se[k * stride + c] : 0.f;
      n2[q] = live[q] ? n2s[k * stride + c] : 1.f;
      n2prev[q] = (k > 0 && live[q]) ? n2s[(k - 1) * stride + c] : 1.f;
      yp[q] = 0.f;
      tk[q] = 0.f;
      if (active && live[q]) {
        if (k > 0) {
          yp[q] = ys[(k - 1) * plane + i * stride + c];
          tk[q] = prev_renorm ? yp[q] * rsqrtf(floor_at(n2prev[q], norm_eps))
                              : yp[q];
        } else {
          tk[q] = t0[i * stride + c];
        }
      }
    }
    if (active) store_cols<P, G>(yh, yl, i, y);
    __syncthreads();
    float ru[G];
#pragma unroll
    for (int q = 0; q < G; ++q) ru[q] = 0.f;
    if (active) dot_cols<P, G>(rbm + i * ld, 1, yh, yl, n, ru);
    float v[2 * G], sums[2 * G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      v[2 * q] = y[q] * ru[q];
      v[2 * q + 1] = dt[q] * y[q];
    }
    block_sum_cols<2 * G>(v, red1, sums);

    float u[G], dtp[G], dn2[G], dehat[G], ds0[G], dn2_new[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      float ehat = sums[2 * q];
      const float dinv = sums[2 * q + 1];
      ehat *= 2.f;
      const float n2p = (DEFER && !prev_renorm) ? n2prev[q] : 1.f;
      const float n2p_c = floor_at(n2p, norm_eps);
      const float e = DEFER ? ehat / n2p_c : ehat;
      const float arg = floor_at(1.f + e * s[q], log_eps);
      const float darg = arg > log_eps ? -gc[q] / arg : 0.f;
      const float de = darg * s[q];
      ds0[q] = darg * e;
      dehat[q] = DEFER ? de / n2p_c : de;
      dn2_new[q] = n2p > norm_eps ? -de * e / n2p_c : 0.f;
      if (renorm) {
        const float inv = rsqrtf(floor_at(n2[q], norm_eps));
        dtp[q] = dt[q] * inv;
        dn2[q] = n2[q] > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
      } else {
        dtp[q] = dt[q];
        dn2[q] = dn2n[q];
      }
      u[q] = (2.f * dehat[q]) * y[q];
    }
    if (active) store_cols<P, G>(uh, ul, i, u);
    __syncthreads();
    float rtd[G];
#pragma unroll
    for (int q = 0; q < G; ++q) rtd[q] = 0.f;
    if (active) dot_cols<P, G>(rbm + i, ld, uh, ul, n, rtd);
    float dy[G];
#pragma unroll
    for (int q = 0; q < G; ++q)
      dy[q] = dtp[q] + ((y[q] * (2.f * dn2[q]) + ru[q] * (2.f * dehat[q])) +
                        rtd[q]);
    if (active) {
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (live[q]) dys[k * plane + i * stride + col0 + q] = dy[q];
      store_cols<P, G>(wh, wl, i, dy);
    }
    if (i == 0) {
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (live[q]) dehats[k * stride + col0 + q] = dehat[q];
    }
    __syncthreads();
    float at[G], du[G];
#pragma unroll
    for (int q = 0; q < G; ++q) at[q] = du[q] = 0.f;
    if (active) dot2_cols<P, G>(abm + i, bbm + i, ld, wh, wl, n, at, du);
    float w[G], dsum[G];
#pragma unroll
    for (int q = 0; q < G; ++q) w[q] = du[q] * tk[q];
    block_sum_cols<G>(w, red2, dsum);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (i == 0 && live[q]) dse[k * stride + col0 + q] = ds0[q] + dsum[q];
      dt[q] = at[q] + s[q] * du[q];
      dn2n[q] = dn2_new[q];
      y[q] = yp[q];
    }
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < G; ++q)
      if (live[q]) dt0[i * stride + col0 + q] = dt[q];
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one adjoint CTA of G columns: Ab, Bb, Rb with
// rows padded to 2D+1 words, six [2D, G] buffers and 3G partials a warp
// (ops/block.py psi_bwd_smem_bytes mirrors it).
size_t amt_psi_train_bwd_smem_bytes(int D, int G) {
  const size_t n = 2 * static_cast<size_t>(D);
  const size_t warps = amt::threads_for(D) / 32;
  return (amt::bwd_matrix_words(static_cast<int>(n)) + 6 * n * G +
          3 * G * warps) * 4;
}

// dse[n_steps, B], dt0[2D, B], dys[n_steps, 2D, B] and dehats[n_steps, B]
// from the loss cotangent g[B], the forward's ys and n2s, and dtfin[2D, B],
// the cotangent of the state after the last step (null: zero), G columns a
// CTA (1, 2, 4 or 8); see the kernel note above. precision: 0 highest,
// 1 high, 2 default. Returns a cudaError_t.
int amt_psi_train_bwd(const float* ab, const float* bb, const float* rb,
                      const float* t0, const float* se, const float* g,
                      const float* ys, const float* n2s, const float* dtfin,
                      float* dse, float* dt0, float* dys, float* dehats,
                      int D, int n_steps, int B, int unroll, float log_eps,
                      float norm_eps, int precision, int defer_norm,
                      int cols_per_cta, void* stream) {
  if (cols_per_cta < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + cols_per_cta - 1) / cols_per_cta);
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::dispatch_cols(cols_per_cta, [&](auto c) {
          return amt::launch_smem(
              amt::psi_train_bwd_kernel<decltype(p)::value,
                                        decltype(d)::value,
                                        decltype(c)::value>,
              grid, amt::threads_for(D),
              amt_psi_train_bwd_smem_bytes(D, decltype(c)::value),
              static_cast<cudaStream_t>(stream), ab, bb, rb, t0, se, g, ys,
              n2s, dtfin, dse, dt0, dys, dehats, D, n_steps, B, unroll,
              log_eps, norm_eps);
        });
      }));
}

}  // extern "C"
