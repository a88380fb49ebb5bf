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
// Design. One CTA per example loops over all steps; thread i owns row i.
// The chain needs Rb y, Rb^T dru, Ab^T dy and Bb^T dy: four orientations of
// three [2D,2D] matrices, 256 KB at D=64 if each were stored the way it is
// read, over the 227 KB a block may have. So each matrix is stored once,
// row-major with rows padded to 2D+1 words (3 x 128 x 129 x 4 = 198 KB at
// D=64): thread i walks row i for Rb y and column i for the transposes, and
// both walks are free of bank conflicts. The state y_k is read back from
// the stream once per step (it is t_{k+1} of the step before, so each load
// serves two steps).
//
// What bounds it: four [2D,2D] x [2D] products per example per step, each a
// shared-memory walk of one matrix (one FMA per 4-byte load), plus five CTA
// barriers per step; device memory moves one state read and one dy write
// per step. As psi_nll.cu, it is bound by shared-memory reads and barrier
// latency, not by device memory.
#include "common.cuh"

namespace amt {

template <int P, bool DEFER>
__global__ void __launch_bounds__(1024)
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
  uint32_t* abm = smem;
  uint32_t* bbm = abm + n * ld;
  uint32_t* rbm = bbm + n * ld;
  float* yh = reinterpret_cast<float*>(rbm + n * ld);  // prepped y
  float* yl = yh + n;
  float* uh = yl + n;                                  // prepped dru
  float* ul = uh + n;
  float* wh = ul + n;                                  // prepped dy
  float* wl = wh + n;
  float* red1 = wl + n;                                // 2 x 32 partials
  float* red2 = red1 + 64;                             // 32 partials

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < n;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;

  load_matrix_pad<P>(abm, ab, n);
  load_matrix_pad<P>(bbm, bb, n);
  load_matrix_pad<P>(rbm, rb, n);

  const float gc = g[col];
  float dt = (dtfin != nullptr && active) ? dtfin[i * stride + col]
                                          : 0.f;   // cotangent of t_{k+1}
  float dn2n = 0.f;    // dn2_new of step k+1
  float y = (active && n_steps > 0)
                ? ys[(n_steps - 1) * plane + i * stride + col] : 0.f;

  for (int k = n_steps - 1; k >= 0; --k) {
    const float s = se[k * stride + col];
    const float n2 = n2s[k * stride + col];
    const float n2prev = k > 0 ? n2s[(k - 1) * stride + col] : 1.f;
    // step k-1 renormalised its output: t_k = y_{k-1} rsqrt(max(n2, eps))
    const bool prev_renorm = !DEFER || k % unroll == 0;
    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    float yp = 0.f, tk = 0.f;
    if (active) {
      if (k > 0) {
        yp = ys[(k - 1) * plane + i * stride + col];
        tk = prev_renorm ? yp * rsqrtf(floor_at(n2prev, norm_eps)) : yp;
      } else {
        tk = t0[i * stride + col];
      }
      store_vec<P>(yh, yl, i, y);
    }
    __syncthreads();
    const float ru =
        active ? dot_strided<P>(rbm + i * ld, 1, yh, yl, n) : 0.f;
    float ehat, dinv;
    block_sum2(y * ru, dt * y, red1, ehat, dinv);
    ehat *= 2.f;

    const float n2p = (DEFER && !prev_renorm) ? n2prev : 1.f;
    const float n2p_c = floor_at(n2p, norm_eps);
    const float e = DEFER ? ehat / n2p_c : ehat;
    const float arg = floor_at(1.f + e * s, log_eps);
    const float darg = arg > log_eps ? -gc / arg : 0.f;
    const float de = darg * s;
    const float ds0 = darg * e;
    const float dehat = DEFER ? de / n2p_c : de;
    const float dn2_new = n2p > norm_eps ? -de * e / n2p_c : 0.f;

    float dtp, dn2;
    if (renorm) {
      const float inv = rsqrtf(floor_at(n2, norm_eps));
      dtp = dt * inv;
      dn2 = n2 > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
    } else {
      dtp = dt;
      dn2 = dn2n;
    }
    if (active) store_vec<P>(uh, ul, i, (2.f * dehat) * y);
    __syncthreads();
    const float rtd = active ? dot_strided<P>(rbm + i, ld, uh, ul, n) : 0.f;
    const float dy = dtp + ((y * (2.f * dn2) + ru * (2.f * dehat)) + rtd);
    if (active) {
      dys[k * plane + i * stride + col] = dy;
      store_vec<P>(wh, wl, i, dy);
    }
    if (i == 0) dehats[k * stride + col] = dehat;
    __syncthreads();
    float at = 0.f, du = 0.f;
    if (active) dot2_strided<P>(abm + i, bbm + i, ld, wh, wl, n, at, du);
    const float dsum = block_sum(du * tk, red2);
    if (i == 0) dse[k * stride + col] = ds0 + dsum;
    dt = at + s * du;
    dn2n = dn2_new;
    y = yp;
  }
  if (active) dt0[i * stride + col] = dt;
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one adjoint CTA: Ab, Bb, Rb with rows padded to
// 2D+1 words, six [2D] vectors and 96 reduction floats.
size_t amt_psi_train_bwd_smem_bytes(int D) {
  const size_t n = 2 * static_cast<size_t>(D);
  return 3 * n * (n + 1) * 4 + (6 * n + 96) * 4;
}

// dse[n_steps, B], dt0[2D, B], dys[n_steps, 2D, B] and dehats[n_steps, B]
// from the loss cotangent g[B], the forward's ys and n2s, and dtfin[2D, B],
// the cotangent of the state after the last step (null: zero); see the
// kernel note above. precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_psi_train_bwd(const float* ab, const float* bb, const float* rb,
                      const float* t0, const float* se, const float* g,
                      const float* ys, const float* n2s, const float* dtfin,
                      float* dse, float* dt0, float* dys, float* dehats,
                      int D, int n_steps, int B, int unroll, float log_eps,
                      float norm_eps, int precision, int defer_norm,
                      void* stream) {
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::launch_smem(
            amt::psi_train_bwd_kernel<decltype(p)::value, decltype(d)::value>,
            B, amt::threads_for(D), amt_psi_train_bwd_smem_bytes(D),
            static_cast<cudaStream_t>(stream), ab, bb, rb, t0, se, g, ys, n2s,
            dtfin, dse, dt0, dys, dehats, D, n_steps, B, unroll, log_eps,
            norm_eps);
      }));
}

}  // extern "C"
