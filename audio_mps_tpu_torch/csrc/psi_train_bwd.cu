// Adjoint of the psi training forward (block-complex layout) for Hopper.
//
// Replaces the serial part and the batched tail of the TPU kernels
// audio_mps_tpu/ops/pallas_block.py _make_psi_bwd_kernel_stream (the
// streamed-states adjoint, deferred norm) and _make_psi_bwd_kernel
// (defer_norm=False): the reverse chain over the states that
// psi_train_fwd.cu streamed. The three [2D,2D] cotangent reductions, which
// the TPU kernel runs in its own body, are psi_cotangents.cu; this file
// hands them dy_k and dehat_k. It also serves the recompute adjoint
// (_make_psi_bwd_kernel_defer :621 and _make_psi_bwd_kernel :529 without the
// stream): there it runs over one time segment of whole blocks at a time, on
// the states psi_recompute.cu rebuilt from the checkpoints, with dtfin the
// cotangent of the state entering the next segment (the dt0 of that
// segment's run).
//
// Step k in reverse, with dt the cotangent of t_{k+1} (dtfin after the last
// step, zero without it), y = y_k, s = se[k], n2p the squared norm e divides
// by (n2_{k-1} inside a deferred block, else 1):
//   tail (free of the chain; the TPU batches it over a block):
//     ru = Rb y; ehat = 2 sum(y .* ru); e = DEFER ? ehat / max(n2p, eps) : ehat
//     arg = max(1 + e s, log_eps); darg = arg > log_eps ? -g / arg : 0
//     de = darg s; ds0 = darg e; dehat = DEFER ? de / max(n2p, eps) : de
//     dn2_new = n2p > eps ? -de e / max(n2p, eps) : 0   (cotangent of n2_{k-1})
//     q = ru (2 dehat) + Rb^T (2 dehat y)   (the e-path cotangent of y)
//   chain:
//     renorm step (every step without DEFER, every unroll-th with it):
//       inv = rsqrt(max(n2_k, eps)); dinv = sum(dt .* y)
//       dn2 = n2_k > eps ? -0.5 dinv inv^3 : 0;  dt <- dt inv
//     else dn2 = step k+1's dn2_new (0 after the last step)
//     dy = dt + (2 dn2 y + q)
//     dt <- Ab^T dy + s (Bb^T dy);  dse = ds0 + sum((Bb^T dy) .* t_k)
// This is the TPU kernel's dn2 bookkeeping: the dn2 used at step k is step
// k+1's dn2_new, the block-exit renorm seeds the last step of each block,
// and the dn2_new of a block's first step (its n2p is the constant 1) is
// dropped. The port loops over the real steps only, so the last step's dn2
// is 0, as the TPU's zero-padded steps make it. A segment ends at a block
// exit, whose renorm seeds its last step from dt, and the next segment's
// first step drops its dn2_new: so only dt crosses a segment boundary, and
// the segments' dse and dt0 equal one run's bit for bit.
//
// Design. Two kernels of one launch. The tail runs over all (step, column)
// pairs at once: a CTA owns kTailCols adjacent columns over a range of
// steps, Rb in shared memory both ways (Rb^T for Rb y, Rb for Rb^T u, rows
// padded to 2D+4 words), and takes the steps kTailSteps at a time: thread
// (lq, rt) of a column forms a 4-row x kTailSteps tile of each product over
// an interleaved quarter of j (each float4 of Rb feeds the chunk's steps,
// each float4 of the states 4 rows), the quarters added by two shuffles.
// It writes q into the dy stream, which the chain then reads and
// overwrites with dy, ds0 into dse, dehat, and dn2_new into a [n_steps, B]
// scratch. The chain runs the forward's quad layout (psi_fwd.cuh): quarter
// q of row i of Ab^T and Bb^T in thread (i, q)'s registers, one walk of
// both a step against a double buffer of the prepped dy, so one CTA
// barrier a step; the CTA sum dinv only at a renorm step (every step
// without DEFER); each warp's part of the ds sum left in a ring and added
// to ds0 every kBwdFlush steps; every input of a step loaded a step ahead.
// A chain CTA takes its G columns one after the other, each with the same
// instructions, so every output is the same bits at every G.
//
// What bounds it: the tail's 2 (2D)^2 FMAs a column-step spread over the
// card (its reads of Rb and the states into registers, 12 lane-floats a
// thread a j for 32 FMAs); the chain's reads of dy into registers (2D
// floats a thread a step) and the latency of its one serial walk (as the
// forward's: 32 FMAs deep at D=64, two shuffles, a barrier); device memory
// moves ys and dy once each in both.
#include "psi_fwd.cuh"

namespace amt {

constexpr int kTailCols = 2;      // columns a tail CTA
constexpr int kTailSteps = 8;     // steps a tail chunk
constexpr int kTailPitch = 12;    // floats of a chunk buffer's row
constexpr int kTailCtas = 528;    // four waves of the card's 132 SMs

constexpr int kTailTiles = 34;    // the most 4-row tiles of a column

// The tail's row pitch of Rb^T and Rb in words: rows rounded up to 8 mod
// 32, so the float4s of a quarter-warp (4 rows j by lq, 2 row tiles) fall
// on distinct banks.
__host__ __device__ inline int tail_pitch(int rows) {
  return rows + ((8 - rows % 32) + 32) % 32;
}

// Dynamic shared memory of one tail CTA: Rb^T and Rb ([2D][tail_pitch]
// each), and for each column its chunk buffers (y raw, hi, lo; u hi, lo:
// [2D][12] each), [kTailSteps][kTailTiles] partials of ehat and the
// chunk's kTailSteps factors 2 dehat.
inline size_t tail_smem_bytes(int D) {
  const Quad L(D);
  const size_t n = L.n;
  return 4 * (2 * n * tail_pitch(L.rows) +
              kTailCols * (5 * n * kTailPitch + kTailSteps * kTailTiles +
                           kTailSteps));
}

// Columns a chain CTA walks side by side at G columns a CTA.
inline int chain_cols(int G) { return G >= 4 ? 4 : (G >= 2 ? 2 : 1); }

// Dynamic shared memory of one chain CTA at G columns a CTA: for each of
// the columns it walks side by side, the double buffer of its prepped dy
// (hi and lo: 4 vectors of 4 quarters), its ds ring [kBwdSlots][nw] and
// dinv's 32 partials.
inline size_t chain_smem_bytes(int D, int G) {
  const Quad L(D);
  return 4 * static_cast<size_t>(chain_cols(G)) *
         (16 * kQuadPitch + kBwdSlots * L.nw + 32);
}

// The tail's product of one chunk for one column: out[r][c] = (M v_c)_{r0+r}
// for the thread's 4 rows and the chunk's kTailSteps states, M read as
// m[j * rp + i] = M[i][j] (packed), v_c from the chunk buffers vh, vl
// ([2D][kTailPitch]); each sum an fmaf chain over j = lq, lq + 4, ... in
// order (kHigh: three, added as quad_sum adds them), the four interleaved
// quarters added (p0 + p1) + (p2 + p3) on every lane of the quad.
template <int P>
__device__ __forceinline__ void tail_product(const uint32_t* m, int rp,
                                             const float* vh,
                                             const float* vl, int n, int lq,
                                             int r0,
                                             float (&out)[4][kTailSteps]) {
  constexpr int kPasses = P == kHigh ? 2 : 1;
  constexpr int kSp = kTailSteps / kPasses;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    float acc[4][kSp][3];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kSp; ++c)
        acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = 0.f;
#pragma unroll 4
    for (int j = lq; j < n; j += 4) {
      const uint4 mv = *reinterpret_cast<const uint4*>(m + j * rp + r0);
      const uint32_t mw[4] = {mv.x, mv.y, mv.z, mv.w};
      float h[kSp], l[kSp];
#pragma unroll
      for (int c = 0; c < kSp; c += 4) {
        const float4 a = ld4(vh + j * kTailPitch + kSp * pass + c);
        const float4 b = P == kHigh ? ld4(vl + j * kTailPitch + kSp * pass + c)
                                    : a;
        h[c] = a.x; h[c + 1] = a.y; h[c + 2] = a.z; h[c + 3] = a.w;
        l[c] = b.x; l[c + 1] = b.y; l[c + 2] = b.z; l[c + 3] = b.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kSp; ++c)
          quad_fma<P>(mw[r], h[c], l[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kSp; ++c)
        out[r][kSp * pass + c] = quad_sum<P>(acc[r][c]);
  }
}

template <int P, bool DEFER>
__global__ void __launch_bounds__(kTailCols * kQuadThreadsBig / 4)
    psi_bwd_tail_kernel(const float* __restrict__ rb,
                        const float* __restrict__ se,
                        const float* __restrict__ g,
                        const float* __restrict__ ys,
                        const float* __restrict__ n2s,
                        float* __restrict__ dse, float* __restrict__ dys,
                        float* __restrict__ dehats, float* __restrict__ dn2ns,
                        int D, int n_steps, int B, int unroll, float log_eps,
                        float norm_eps) {
  extern __shared__ __align__(16) float4 smem4[];
  const Quad L(D);
  const int n = L.n, rp = tail_pitch(L.rows);
  uint32_t* rbt = reinterpret_cast<uint32_t*>(smem4);   // Rb^T: Rb y
  uint32_t* rbm = rbt + n * rp;                         // Rb: Rb^T u
  // this thread's column (rows threads each) and 4-row tile
  const int cc = threadIdx.x / L.rows;
  const int ct = threadIdx.x - cc * L.rows;
  const int lq = ct & 3;
  const int tile = ct >> 2;
  const int r0 = 4 * tile;               // rows r0 .. r0 + 3
  const int ntile = L.rows / 4;
  float* buf = reinterpret_cast<float*>(rbm + n * rp) +
               cc * (5 * n * kTailPitch + kTailSteps * kTailTiles +
                     kTailSteps);
  float* yr = buf;                       // raw y
  float* yh = yr + n * kTailPitch;
  float* yl = yh + n * kTailPitch;
  float* uh = yl + n * kTailPitch;
  float* ul = uh + n * kTailPitch;
  float* red = ul + n * kTailPitch;      // [kTailSteps][kTailTiles]
  float* dh = red + kTailSteps * kTailTiles;   // [kTailSteps]: 2 dehat

  const int b = blockIdx.y * kTailCols + cc;
  const bool live = b < B;
  const int nsplit = gridDim.x;
  const int k_lo = static_cast<int>(static_cast<long long>(n_steps) *
                                    blockIdx.x / nsplit);
  const int k_hi = static_cast<int>(static_cast<long long>(n_steps) *
                                    (blockIdx.x + 1) / nsplit);
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;
  const int own = r0 + lq;               // the row this lane loads and stores
  const bool has_row = own < n && live;
  const size_t at_i = static_cast<size_t>(own) * stride + b;

  for (int idx = threadIdx.x; idx < n * rp; idx += blockDim.x) {
    const int j = idx / rp, i = idx - j * rp;
    rbt[idx] = i < n ? pack_elem<P>(rb[i * n + j]) : 0u;
    rbm[idx] = i < n ? pack_elem<P>(rb[j * n + i]) : 0u;
  }
  const float gb = live ? g[b] : 0.f;
  // the chunk's inputs, loaded a chunk ahead: the lane's row of y, and
  // for lane ct < kTailSteps its step's s and the norm e divides by
  float yn[kTailSteps], sn = 0.f, n2n = 1.f;
  auto load = [&](int c0) {
    const int kn = min(kTailSteps, k_hi - c0);
#pragma unroll
    for (int c = 0; c < kTailSteps; ++c)
      yn[c] = (has_row && c < kn) ? ys[(c0 + c) * plane + at_i] : 0.f;
    if (ct < kn && live) {
      const int k = c0 + ct;
      sn = se[k * stride + b];
      n2n = (DEFER && k % unroll != 0) ? n2s[(k - 1) * stride + b] : 1.f;
    }
  };
  if (k_lo < k_hi) load(k_lo);
  for (int c0 = k_lo; c0 < k_hi; c0 += kTailSteps) {
    const int kn = min(kTailSteps, k_hi - c0);
    float y[kTailSteps];
#pragma unroll
    for (int c = 0; c < kTailSteps; ++c) y[c] = yn[c];
    const float s = sn, n2p = n2n;
    __syncthreads();   // Rb; the last chunk is done with the buffers
    if (own < n) {
#pragma unroll
      for (int c = 0; c < kTailSteps; ++c) {
        yr[own * kTailPitch + c] = y[c];
        store_vec<P>(yh + own * kTailPitch, yl + own * kTailPitch, c, y[c]);
      }
    }
    __syncthreads();
    if (c0 + kTailSteps < k_hi) load(c0 + kTailSteps);
    float ru[4][kTailSteps], rt[4][kTailSteps];
    tail_product<P>(rbt, rp, yh, yl, n, lq, r0, ru);
    // ehat / 2 a step: lane lq takes steps 2 lq and 2 lq + 1 over its
    // tile's rows (an fmaf chain); lane ct < kTailSteps adds the tiles of
    // step ct in order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float e = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < kTailSteps; ++c) {
          if (c == 2 * lq + h && r0 + r < n)
            e = fmaf(yr[(r0 + r) * kTailPitch + c], ru[r][c], e);
        }
      }
      red[(2 * lq + h) * kTailTiles + tile] = e;
    }
    __syncthreads();
    if (ct < kTailSteps) {
      float d2 = 0.f;
      if (ct < kn && live) {
        const int k = c0 + ct;
        float ehat = parts_total(red + ct * kTailTiles, ntile);
        ehat *= 2.f;
        const float n2p_c = floor_at(n2p, norm_eps);
        const float ev = DEFER ? ehat / n2p_c : ehat;
        const float arg = floor_at(1.f + ev * s, log_eps);
        const float darg = arg > log_eps ? -gb / arg : 0.f;
        const float de = darg * s;
        const float dehat = DEFER ? de / n2p_c : de;
        dse[k * stride + b] = darg * ev;
        dehats[k * stride + b] = dehat;
        dn2ns[k * stride + b] = n2p > norm_eps ? -de * ev / n2p_c : 0.f;
        d2 = 2.f * dehat;
      }
      dh[ct] = d2;
    }
    __syncthreads();
    float dh2[kTailSteps];
#pragma unroll
    for (int c = 0; c < kTailSteps; ++c) dh2[c] = dh[c];
    if (own < n) {
#pragma unroll
      for (int c = 0; c < kTailSteps; ++c)
        store_vec<P>(uh + own * kTailPitch, ul + own * kTailPitch, c,
                     dh2[c] * y[c]);
    }
    __syncthreads();
    tail_product<P>(rbm, rp, uh, ul, n, lq, r0, rt);
    if (has_row) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r != lq) continue;
#pragma unroll
        for (int c = 0; c < kTailSteps; ++c)
          if (c < kn)
            dys[(c0 + c) * plane + at_i] = ru[r][c] * dh2[c] + rt[r][c];
      }
    }
  }
}

// The chain walks CI columns a step side by side (chain_cols: 2 or 4 when
// a CTA has as many, so one column's barrier and shuffle latencies hide
// the others'); each column runs the instructions it runs alone.
template <int P, bool DEFER, bool BIG, int CI>
__global__ void __launch_bounds__(BIG ? kQuadThreadsBig : kQuadThreads, 1)
    psi_bwd_chain_kernel(const float* __restrict__ ab,
                         const float* __restrict__ bb,
                         const float* __restrict__ t0,
                         const float* __restrict__ se,
                         const float* __restrict__ ys,
                         const float* __restrict__ n2s,
                         const float* __restrict__ dn2ns,
                         const float* __restrict__ dtfin,
                         float* __restrict__ dse, float* __restrict__ dt0,
                         float* __restrict__ dys, int D, int n_steps, int B,
                         int unroll, int G, float norm_eps) {
  extern __shared__ __align__(16) float4 smem4[];
  const Quad L(D);
  const QuadThread th(L);
  constexpr int kV = 8 * kQuadPitch;              // one column's (hi, lo)
  float* vec = reinterpret_cast<float*>(smem4);   // [2][CI][hi, lo][4][36]
  float* ring = vec + 2 * CI * kV;                // [kBwdSlots][CI][nw]
  float* red = ring + kBwdSlots * CI * L.nw;      // [CI][32]

  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(L.n) * B;
  const bool extra = L.jq > 32;
  const bool rd = th.active;   // this thread reads its row's streams

  uint32_t am[kQuadJ], bm[kQuadJ];
  load_quarter<P, true>(am, ab, L, th);
  load_quarter<P, true>(bm, bb, L, th);
  for (int idx = threadIdx.x; idx < 2 * CI * kV; idx += blockDim.x)
    vec[idx] = 0.f;

  for (int gi = 0; gi < G; gi += CI) {
    int col[CI];
    bool live[CI];
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      col[c] = blockIdx.x * G + gi + c;
      live[c] = gi + c < G && col[c] < B;
    }
    if (!live[0]) break;
    // step k's inputs, loaded a step ahead: y, q; s, n2 and the dn2_new of
    // step k+1; dt, the cotangent of t_{k+1}
    const int k1 = n_steps - 1;
    float dt[CI], y[CI], qv[CI], s[CI], n2[CI], dn2n[CI];
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      const size_t at_i = static_cast<size_t>(th.i) * stride + col[c];
      const bool ok = live[c] && k1 >= 0;
      dt[c] = (dtfin != nullptr && rd && live[c]) ? dtfin[at_i] : 0.f;
      y[c] = (rd && ok) ? ys[k1 * plane + at_i] : 0.f;
      qv[c] = (rd && ok) ? dys[k1 * plane + at_i] : 0.f;
      s[c] = ok ? se[k1 * stride + col[c]] : 0.f;
      n2[c] = ok ? n2s[k1 * stride + col[c]] : 1.f;
      dn2n[c] = 0.f;
    }
    __syncthreads();   // the constants; the last columns' buffers

    // dse[j] = ds0[j] + the total of step j's ds parts, j = k .. k + m - 1
    auto flush = [&](int k, int m) {
      __syncthreads();
      if (th.warp == 0 && th.lane < m) {
        const int j = k + th.lane;
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          if (!live[c]) continue;
          const float r = parts_total(
              ring + ((j % kBwdSlots) * CI + c) * L.nw, L.nw);
          float* d = dse + j * stride + col[c];
          *d = *d + r;
        }
      }
    };

    int pend = 0;   // steps whose ds parts wait in the ring
    for (int k = k1; k >= 0; --k) {
      // step k-1 renormalised its output: t_k = y_{k-1} rsqrt(max(n2, eps))
      const bool prev_renorm = !DEFER || k % unroll == 0;
      const bool renorm = !DEFER || (k + 1) % unroll == 0;
      // step k-1's inputs (and t_k's)
      float yp[CI], qn[CI], sp[CI], n2p[CI], dn2p[CI];
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const size_t at_i = static_cast<size_t>(th.i) * stride + col[c];
        const bool ok = live[c] && k > 0;
        yp[c] = (ok && rd) ? ys[(k - 1) * plane + at_i] : 0.f;
        qn[c] = (ok && rd) ? dys[(k - 1) * plane + at_i] : 0.f;
        sp[c] = ok ? se[(k - 1) * stride + col[c]] : 0.f;
        n2p[c] = ok ? n2s[(k - 1) * stride + col[c]] : 1.f;
        dn2p[c] = ok ? dn2ns[k * stride + col[c]] : 0.f;
      }
      float dtp[CI], dn2[CI];
      if (renorm) {
        float v[CI], dinv[CI];
#pragma unroll
        for (int c = 0; c < CI; ++c) v[c] = th.owner ? dt[c] * y[c] : 0.f;
        quad_cta_sums<CI>(v, red, L.nw, dinv);
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          const float inv = rsqrtf(floor_at(n2[c], norm_eps));
          dtp[c] = dt[c] * inv;
          dn2[c] = n2[c] > norm_eps ? -0.5f * dinv[c] * inv * inv * inv : 0.f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          dtp[c] = dt[c];
          dn2[c] = dn2n[c];
        }
      }
      float* vb = vec + (k & 1) * CI * kV;
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const float dy = dtp[c] + (y[c] * (2.f * dn2[c]) + qv[c]);
        if (th.owner) {
          if (live[c])
            dys[k * plane + static_cast<size_t>(th.i) * stride + col[c]] = dy;
          float* v = vb + c * kV;
          store_vec<P>(v + th.iw, v + 4 * kQuadPitch + th.iw, 0, dy);
        }
      }
      __syncthreads();
      const int qo = th.q * kQuadPitch;
      const int sl = k % kBwdSlots;
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        float at, du;
        const float* v = vb + c * kV;
        quad_walk<P>(am, bm, v + qo, v + 4 * kQuadPitch + qo, extra, at, du);
        const size_t at_i = static_cast<size_t>(th.i) * stride + col[c];
        const float tk =
            k > 0 ? (prev_renorm ? yp[c] * rsqrtf(floor_at(n2p[c], norm_eps))
                                 : yp[c])
                  : ((rd && live[c]) ? t0[at_i] : 0.f);
        const float w = row_sum8(th.owner ? du * tk : 0.f);
        if (th.lane == 0) ring[(sl * CI + c) * L.nw + th.warp] = w;
        dt[c] = at + s[c] * du;
        y[c] = yp[c];
        qv[c] = qn[c];
        s[c] = sp[c];
        n2[c] = n2p[c];
        dn2n[c] = dn2p[c];
      }
      if (++pend == kBwdFlush || k == 0) {
        flush(k, pend);
        pend = 0;
      }
    }
    if (th.owner) {
#pragma unroll
      for (int c = 0; c < CI; ++c)
        if (live[c])
          dt0[static_cast<size_t>(th.i) * stride + col[c]] = dt[c];
    }
    __syncthreads();   // every thread is done with these columns' buffers
  }
}

// The tail over all (step, column) pairs: ceil(B / kTailCols) column pairs,
// each over ceil(kTailCtas / that) ranges of steps.
template <int P, bool DEFER>
cudaError_t launch_tail(const float* rb, const float* se, const float* g,
                        const float* ys, const float* n2s, float* dse,
                        float* dys, float* dehats, float* dn2ns, int D,
                        int n_steps, int B, int unroll, float log_eps,
                        float norm_eps, cudaStream_t stream) {
  if (n_steps <= 0 || B <= 0) return cudaSuccess;
  const int pairs = (B + kTailCols - 1) / kTailCols;
  int split = (kTailCtas + pairs - 1) / pairs;
  split = split < n_steps ? split : n_steps;
  return launch_smem(psi_bwd_tail_kernel<P, DEFER>, dim3(split, pairs),
                     kTailCols * Quad(D).rows, tail_smem_bytes(D), stream, rb,
                     se, g,
                     ys, n2s, dse, dys, dehats, dn2ns, D, n_steps, B, unroll,
                     log_eps, norm_eps);
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of the adjoint at G columns a CTA: the larger of a
// tail CTA's and a chain CTA's (ops/block.py psi_bwd_smem_bytes mirrors it).
size_t amt_psi_train_bwd_smem_bytes(int D, int G) {
  const size_t t = amt::tail_smem_bytes(D), c = amt::chain_smem_bytes(D, G);
  return t > c ? t : c;
}

// Dynamic shared memory of one tail CTA (ops/block.py psi_tail_smem_bytes
// mirrors it).
size_t amt_psi_train_bwd_tail_smem_bytes(int D) {
  return amt::tail_smem_bytes(D);
}

// The tail alone: q into dys[n_steps, 2D, B], ds0 into dse[n_steps, B],
// dehats and dn2ns [n_steps, B] from g[B], ys and n2s; see the note above.
// precision: 0 highest, 1 high, 2 default. Returns a cudaError_t.
int amt_psi_train_bwd_tail(const float* rb, const float* se, const float* g,
                           const float* ys, const float* n2s, float* dse,
                           float* dys, float* dehats, float* dn2ns, int D,
                           int n_steps, int B, int unroll, float log_eps,
                           float norm_eps, int precision, int defer_norm,
                           void* stream) {
  if (unroll < 1 || !amt::quad_fits(D))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::launch_tail<decltype(p)::value, decltype(d)::value>(
            rb, se, g, ys, n2s, dse, dys, dehats, dn2ns, D, n_steps, B,
            unroll, log_eps, norm_eps, static_cast<cudaStream_t>(stream));
      }));
}

// dse[n_steps, B], dt0[2D, B], dys[n_steps, 2D, B] and dehats[n_steps, B]
// from the loss cotangent g[B], the forward's ys and n2s, and dtfin[2D, B],
// the cotangent of the state after the last step (null: zero): the tail,
// then the chain, G columns a chain CTA in turn; dn2ns[n_steps, B] is
// scratch. See the kernel note above. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_psi_train_bwd(const float* ab, const float* bb, const float* rb,
                      const float* t0, const float* se, const float* g,
                      const float* ys, const float* n2s, const float* dtfin,
                      float* dse, float* dt0, float* dys, float* dehats,
                      float* dn2ns, int D, int n_steps, int B, int unroll,
                      float log_eps, float norm_eps, int precision,
                      int defer_norm, int cols_per_cta, void* stream) {
  if (cols_per_cta < 1 || unroll < 1 || !amt::quad_fits(D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const amt::Quad L(D);
  const dim3 grid((B + cols_per_cta - 1) / cols_per_cta);
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        constexpr int kP = decltype(p)::value;
        constexpr bool kD = decltype(d)::value;
        cudaError_t err = amt::launch_tail<kP, kD>(
            rb, se, g, ys, n2s, dse, dys, dehats, dn2ns, D, n_steps, B,
            unroll, log_eps, norm_eps, st);
        if (err != cudaSuccess) return err;
        const auto chain = [&](auto big, auto ci) {
          return amt::launch_smem(
              amt::psi_bwd_chain_kernel<kP, kD, decltype(big)::value,
                                        decltype(ci)::value>,
              grid, L.threads, amt::chain_smem_bytes(D, cols_per_cta), st,
              ab, bb, t0, se, ys, n2s, dn2ns, dtfin, dse, dt0, dys, D,
              n_steps, B, unroll, cols_per_cta, norm_eps);
        };
        return amt::dispatch_bool(L.threads > amt::kQuadThreads, [&](auto big) {
          switch (amt::chain_cols(cols_per_cta)) {
            case 4:
              return chain(big, std::integral_constant<int, 4>{});
            case 2:
              return chain(big, std::integral_constant<int, 2>{});
            default:
              return chain(big, std::integral_constant<int, 1>{});
          }
        });
      }));
}

}  // extern "C"
