// The psi forward chain (block-complex layout) for Hopper, shared by the
// forward-only NLL (psi_nll.cu, kNll), the training forward with the state
// stream (psi_train_fwd.cu, kStream) or with block checkpoints
// (psi_train_fwd.cu, kCkpt; psi_batched_fwd.cu, kBatched), and the
// recompute of the recompute adjoint (psi_recompute.cu, kRecompute); with
// the quad layout that the adjoint chain (psi_train_bwd.cu) shares.
//
// One step on the folded kernel-frame state t ([2D] per example), with s the
// increment / A:
//   y  = Ab t + s (Bb t)
//   ru = Rb y
//   e  = 2 sum(y .* ru),  n2 = sum(y^2)
//   per-step norm:  loss -= log(max(1 + e s, log_eps));  t = y rsqrt(max(n2, eps))
//   deferred norm:  e /= max(n2_prev, eps); same loss; t = y, n2_prev = n2,
//                   renormalised (and n2_prev = 1) at every unroll-th step,
//                   where the TPU kernel renormalises at its block exits.
// The mean over the batch stays outside; the kernel writes loss[B]. What a
// launch writes besides (FwdMode):
//   kStream:    ys[k] = y_k ([n_steps, 2D, B]) and n2s[k] = |y_k|^2
//               ([n_steps, B]): with them the adjoint (psi_train_bwd.cu) and
//               the cotangent reduction (psi_cotangents.cu) rebuild every
//               step's input state t_k = y_{k-1} * (renorm ?
//               rsqrt(max(n2, eps)) : 1) with the same instructions as here,
//               bit for bit, and no recompute chain.
//   kCkpt:      ck[j] = t_{j unroll}, the state entering each unroll-step
//               block ([n_blocks, 2D, B], n_blocks = ceil(n_steps / unroll);
//               the state after the previous block's exit renorm), and no
//               stream: the TPU forward's checkpoints (pallas_block.py :477).
//   kBatched:   kCkpt at the deferred norm and one column a CTA (the TPU's
//               _make_psi_fwd_kernel_batched, pallas_block.py :276, whose
//               spine/limbs split this step's is: the limb below).
//   kRecompute: no loss; CTA (column group, j) re-runs the span (a whole
//               number of blocks) that starts at block j span / unroll of a
//               segment, each block from its own checkpoint in t0 ([blocks,
//               2D, B]), and writes the span's rows of ys and n2s. The
//               spans of a segment are independent, so they run side by
//               side; each CTA runs this loop over its steps, so from the
//               kCkpt forward's checkpoints ys and n2s equal the kStream
//               forward's bit for bit, and from any others they are the
//               plain recompute's function of every checkpoint.
//
// Design: the quad layout. Four threads share a state row: thread (i, q),
// lane 4 (i mod 8) + q of warp i / 8, holds quarter q of row i of Ab and Bb
// (j in [q jq, q jq + jq), jq = ceil(2D / 4): 32 words each at D=64, in
// registers for the whole run) and walks it against the prepped state,
// whose quarters sit in shared memory kQuadPitch floats apart. A CTA of
// 4 x 2D threads (512 at D=64: four warps a scheduler where one thread a
// row gave one) loops over all steps of its G columns, two side by side
// from G=2 (fwd_cols: one column's barrier and shuffle latencies hide the
// other's) and those in turn; every column runs the instructions it runs
// alone, so its outputs are the same bits at every G. The spine of a step
// is one walk (Ab t and Bb t) a column and one CTA barrier; each thread's
// sums are one fmaf chain over its j in order (three at kHigh, added (hi
// hi + hi lo) + lo hi), and the four quarters are added (p0 + p1) + (p2 +
// p3) by two shuffles, every lane of the quad getting the same bits. y
// goes to a history of up to kHist steps in shared memory and each warp's
// part of |y|^2 to a loss ring (FwdRing). Nothing else in a deferred block feeds the next step, so
// the expectation waits for a flush: at a block's end (where the renorm's
// |y|^2 is the only sum on the chain), when the history is full, and after
// the last step. There the limb (fwd_limb) forms Rb y for every step of the
// history at once, a 4-row x 4-step tile a thread over an interleaved
// quarter of j (each load of Rb feeds 4 steps, each load of y 4 rows), and
// the flush takes the totals, the n2s row and the loss terms, with the
// deferred norm's division by |y_{k-1}|^2, so no step's chain holds it. The
// per-step norm keeps |y|^2 on the chain (a second CTA barrier a step).
// `se` is read 32 steps ahead into lane registers.
//
// What bounds it: shared-memory reads into registers, 32 lane-floats a
// cycle an SM: the spine's state, 2D floats a thread a step (512 cycles a
// step at D=64), its seven shuffles a warp, and the limb's two float4s a
// thread a j (256 cycles a step); under them the FMA rate for 3 (2D)^2
// FMAs a column-step (0.22 us on one SM at 1.75 GHz) and the spine's
// latency (32 FMAs deep, two shuffles, a barrier).
#pragma once

#include "common.cuh"

namespace amt {

// ---------------------------------------------------------------------------
// The quad layout (psi_fwd_kernel here, psi_bwd_chain_kernel in
// psi_train_bwd.cu)

constexpr int kQuadJ = 34;              // the most j a thread holds: D <= 68
constexpr int kQuadPitch = 36;          // floats of a vector's quarter
constexpr int kQuadThreads = 512;       // D <= 64 (128 registers a thread)
constexpr int kQuadThreadsBig = 544;    // D <= 68 (4 x 136 rows)
constexpr int kHist = 16;               // steps the forward's limb takes
constexpr int kHistPitch = 24;          // floats of a history row
constexpr int kFwdSlots = 18;           // the forward's loss ring
constexpr int kBwdSlots = 32;           // the chain's ds ring
constexpr int kBwdFlush = 16;           // the chain's steps a flush

// Does the quad layout take bond dimension D (each thread's quarter of a
// row in kQuadJ registers)?
__host__ __device__ inline bool quad_fits(int D) {
  return D >= 1 && (2 * D + 3) / 4 <= kQuadJ;
}

// The sizes of the quad layout at bond dimension D.
struct Quad {
  int n;        // state rows, 2D
  int rows;     // n rounded up to a warp's 8 rows
  int jq;       // j a quarter
  int nw;       // warps
  int threads;
  int rp;       // the limb's Rb^T row pitch in words (rows + 4: the four
                // rows j a quarter-warp loads at once fall on distinct banks)
  __host__ __device__ explicit Quad(int D) {
    n = 2 * D;
    rows = (n + 7) / 8 * 8;
    jq = (n + 3) / 4;
    nw = rows / 8;
    threads = 4 * rows;
    rp = rows + 4;
  }
};

// Thread (row, quarter) of the quad layout and where its row sits in a
// vector buffer.
struct QuadThread {
  int tid, warp, lane, q, i;
  bool active, owner;   // owner: lane q = 0 of an active row writes it
  int iw;
  __device__ explicit QuadThread(const Quad& L) {
    tid = threadIdx.x;
    warp = tid >> 5;
    lane = tid & 31;
    q = lane & 3;
    i = warp * 8 + (lane >> 2);
    active = i < L.n;
    owner = active && q == 0;
    const int iq = active ? i / L.jq : 0;
    iw = iq * kQuadPitch + (active ? i - iq * L.jq : 0);
  }
};

// Quarter q of row i of M (MT: of M^T, i.e. column i of M) packed for
// precision P into registers; zeros past the row and the quarter.
template <int P, bool MT>
__device__ __forceinline__ void load_quarter(uint32_t (&m)[kQuadJ],
                                             const float* __restrict__ src,
                                             const Quad& L,
                                             const QuadThread& th) {
#pragma unroll
  for (int e = 0; e < kQuadJ; ++e) {
    const int j = th.q * L.jq + e;
    const bool ok = th.active && e < L.jq && j < L.n;
    m[e] = ok ? pack_elem<P>(MT ? src[j * L.n + th.i] : src[th.i * L.n + j])
              : 0u;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at4(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// fmaf chains of one matrix word against one prepped element: part 0
// (the value, or kHigh's hi hi), and at kHigh parts 1 (hi lo) and 2 (lo hi).
template <int P>
__device__ __forceinline__ void quad_fma(uint32_t w, float h, float l,
                                         float (&acc)[3]) {
  if (P == kHigh) {
    const float mh = __uint_as_float(w & 0xffff0000u);
    const float ml = __uint_as_float(w << 16);
    acc[0] = fmaf(mh, h, acc[0]);
    acc[1] = fmaf(mh, l, acc[1]);
    acc[2] = fmaf(ml, h, acc[2]);
  } else {
    acc[0] = fmaf(__uint_as_float(w), h, acc[0]);
  }
}

// The quad's sum of a thread's parts (lanes 4k .. 4k + 3): (p0 + p1) +
// (p2 + p3) on every lane.
template <int P>
__device__ __forceinline__ float quad_sum(const float (&acc)[3]) {
  float p = P == kHigh ? (acc[0] + acc[1]) + acc[2] : acc[0];
  p += __shfl_xor_sync(0xffffffffu, p, 1);
  p += __shfl_xor_sync(0xffffffffu, p, 2);
  return p;
}

// One walk of the register quarters am, bm against the prepped vector
// (uh, and at kHigh ul: the thread's quarter, entries past jq zeros):
// oa = (Am u)_i, ob = (Bm u)_i on every lane of the quad.
template <int P>
__device__ __forceinline__ void quad_walk(const uint32_t (&am)[kQuadJ],
                                          const uint32_t (&bm)[kQuadJ],
                                          const float* uh, const float* ul,
                                          bool extra, float& oa, float& ob) {
  float a[3] = {0.f, 0.f, 0.f}, b[3] = {0.f, 0.f, 0.f};
  // chunks 0..7 (j 0..31 of the quarter), then, past D=64, j 32 and 33
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    if (c < 8 || extra) {
      const int ne = c < 8 ? 4 : kQuadJ - 32;
      const float4 uv = ld4(uh + 4 * c);
      const float4 ulv = P == kHigh ? ld4(ul + 4 * c) : uv;
#pragma unroll
      for (int e = 0; e < ne; ++e) {
        const float h = at4(uv, e), l = at4(ulv, e);
        quad_fma<P>(am[4 * c + e], h, l, a);
        quad_fma<P>(bm[4 * c + e], h, l, b);
      }
    }
  }
  oa = quad_sum<P>(a);
  ob = quad_sum<P>(b);
}

// Sum of v over the 8 rows of a warp of the quad layout, where only lane
// q = 0 of a row holds a value and the others 0: xor 16, 8 and 4 pair rows
// 4, 2 and 1 apart (warp_sum's order; its xor 2 and 1 would add zeros).
// Lane 0 holds the warp's part.
__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// The CTA sum of a value held by the rows' owners (zeros elsewhere): each
// warp's part (row_sum8), then the parts added in warp order from part 0,
// every thread getting it. red holds 32 floats and is not written again
// before every thread has passed a later __syncthreads().
__device__ __forceinline__ float quad_cta_sum(float v, float* red, int nw) {
  const float w = row_sum8(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = w;
  __syncthreads();
  float r = red[0];
  for (int p = 1; p < nw; ++p) r += red[p];
  return r;
}

// The warp parts of one step's slot added in warp order from part 0.
__device__ __forceinline__ float parts_total(const float* row, int nw) {
  float r = row[0];
  for (int w = 1; w < nw; ++w) r += row[w];
  return r;
}

// The CTA sums of CI values held by the rows' owners (zeros elsewhere), in
// quad_cta_sum's order each, through one barrier; red holds [CI][32].
template <int CI>
__device__ __forceinline__ void quad_cta_sums(const float (&v)[CI],
                                              float* red, int nw,
                                              float (&out)[CI]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < CI; ++c) {
    const float w = row_sum8(v[c]);
    if (lane == 0) red[c * 32 + warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CI; ++c) out[c] = parts_total(red + c * 32, nw);
}

// The forward's loss ring: the warp parts of ehat and of |y|^2 by step
// ([kFwdSlots][nw] each), the totals of |y|^2 ([kFwdSlots], written at a
// flush) and s ([kFwdSlots]). A flush after step k holds steps p0 - 1 ..
// k, so one comes at least every kHist steps.
struct FwdRing {
  float* e;
  float* t;
  float* tt;
  float* s;
  __device__ FwdRing() : e(nullptr), t(nullptr), tt(nullptr), s(nullptr) {}
  __device__ FwdRing(float* base, int nw)
      : e(base), t(base + kFwdSlots * nw), tt(t + kFwdSlots * nw),
        s(tt + kFwdSlots) {}
};

__host__ __device__ inline int fwd_ring_words(int nw) {
  return kFwdSlots * (2 * nw + 2);
}

// The limb of a flush: for the steps of the history (states 0 .. hn - 1,
// steps p0 .. p0 + hn - 1) each warp's part of ehat_k / 2 = y_k . Rb y_k
// into the ring's e slots. Thread (lq, st, rl) of lane lq + 4 st + 16 rl
// takes rows r0 .. r0 + 3 (r0 = 8 warp + 4 rl) and states 4 st .. 4 st + 3
// over j = lq, lq + 4, ... (each sum one fmaf chain over its j in order,
// at kHigh three, added as quad_sum adds them); the four interleaved
// quarters are added (p0 + p1) + (p2 + p3) by two shuffles; lane lq then
// takes state 4 st + lq: an fmaf chain of y ru over its 4 rows, plus the
// other row tile of its warp (xor 16). rbt[j * rp + i] holds Rb[i][j]
// packed; hist holds the raw y, then the prepped hi and lo parts, [2D][
// kHistPitch] each.
template <int P>
__device__ __forceinline__ void fwd_limb(const uint32_t* rbt,
                                         const float* hist, const Quad& L,
                                         int hn, int p0, float* ring_e) {
  constexpr int kPasses = P == kHigh ? 2 : 1;   // the states in passes
  constexpr int kSp = 4 / kPasses;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lq = lane & 3, st = (lane >> 2) & 3, rl = lane >> 4;
  const int r0 = 8 * warp + 4 * rl;
  const int hp = L.n * kHistPitch;
  const float* yr = hist;
  const float* yh = hist + hp;
  const float* yl = hist + 2 * hp;
  float e = 0.f;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    float acc[4][kSp][3];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kSp; ++c)
        acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = 0.f;
    const int so = 4 * st + kSp * pass;   // the pass's first state
    for (int j = lq; j < L.n; j += 4) {
      const uint4 rv = *reinterpret_cast<const uint4*>(rbt + j * L.rp + r0);
      const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
      float h[kSp], l[kSp];
#pragma unroll
      for (int c = 0; c < kSp; ++c) {
        h[c] = yh[j * kHistPitch + so + c];
        l[c] = P == kHigh ? yl[j * kHistPitch + so + c] : h[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kSp; ++c)
          quad_fma<P>(rw[r], h[c], l[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float yv = r0 + r < L.n ? yr[(r0 + r) * kHistPitch + 4 * st + lq]
                                    : 0.f;
#pragma unroll
      for (int c = 0; c < kSp; ++c) {
        const float ru = quad_sum<P>(acc[r][c]);   // every lane shuffles
        if (lq == kSp * pass + c) e = fmaf(yv, ru, e);
      }
    }
  }
  e += __shfl_xor_sync(0xffffffffu, e, 16);
  const int state = 4 * st + lq;
  if (rl == 0 && state < hn)
    ring_e[((p0 + state) % kFwdSlots) * L.nw + warp] = e;
}

// Columns a forward CTA walks side by side at G columns a CTA (one
// column's barrier and shuffle latencies hide the other's).
__host__ __device__ inline int fwd_cols(int G) { return G >= 2 ? 2 : 1; }

// Words of one column's buffers in a forward CTA: the double buffer of
// its prepped t (hi and lo: 4 vectors of 4 quarters), its history (raw y,
// hi, lo: [2D][kHistPitch] each) and its loss ring.
__host__ __device__ inline int fwd_col_words(const Quad& L) {
  return 16 * kQuadPitch + 3 * L.n * kHistPitch + fwd_ring_words(L.nw);
}

// Dynamic shared memory of one forward CTA at G columns a CTA (every
// mode): Rb^T packed ([2D][rp]), the buffers of each column it walks side
// by side (fwd_cols) and their per-step norm's [32] partials (ops/block.py
// psi_fwd_smem_bytes mirrors it).
__host__ __device__ inline size_t fwd_smem_bytes(int D, int G) {
  const Quad L(D);
  const int ci = fwd_cols(G);
  return 4 * (static_cast<size_t>(L.n) * L.rp +
              static_cast<size_t>(ci) * (fwd_col_words(L) + 32));
}

// The kBatched forward's shared memory: kCkpt's at one column a CTA (the
// unroll no longer sizes it).
inline size_t batched_fwd_smem_bytes(int D, int unroll) {
  (void)unroll;
  return fwd_smem_bytes(D, 1);
}

template <int P, bool DEFER, int MODE, bool BIG, int CI>
__global__ void __launch_bounds__(BIG ? kQuadThreadsBig : kQuadThreads, 1)
    psi_fwd_kernel(const float* __restrict__ ab, const float* __restrict__ bb,
                   const float* __restrict__ rb, const float* __restrict__ t0,
                   const float* __restrict__ se, float* __restrict__ loss,
                   float* __restrict__ ys, float* __restrict__ n2s,
                   float* __restrict__ ck, int D, int n_steps, int B,
                   int unroll, int span, int G, float log_eps,
                   float norm_eps) {
  constexpr bool kExp = MODE != kRecompute;   // the loss and its Rb y
  constexpr bool kRows = MODE == kStream || MODE == kRecompute;
  constexpr bool kCk = MODE == kCkpt || MODE == kBatched;
  extern __shared__ __align__(16) float4 smem4[];
  const Quad L(D);
  const QuadThread th(L);
  uint32_t* rbt = reinterpret_cast<uint32_t*>(smem4);
  float* cols = reinterpret_cast<float*>(rbt + L.n * L.rp);
  const int cw = fwd_col_words(L);
  float* red = cols + CI * cw;                 // [CI][32]
  // column c's buffers: (t hi, t lo) x 2, the history, the loss ring
  float* tbuf[CI];
  float* hist[CI];
  FwdRing R[CI];
#pragma unroll
  for (int c = 0; c < CI; ++c) {
    tbuf[c] = cols + c * cw;
    hist[c] = tbuf[c] + 16 * kQuadPitch;
    R[c] = FwdRing(hist[c] + 3 * L.n * kHistPitch, L.nw);
  }

  const size_t stride = static_cast<size_t>(B);
  // offsets in size_t: n_steps * B, and n_steps * 2D * B of the stream, may
  // pass 2^31
  const size_t plane = static_cast<size_t>(L.n) * B;
  const bool extra = L.jq > 32;

  uint32_t am[kQuadJ], bm[kQuadJ];
  load_quarter<P, false>(am, ab, L, th);
  load_quarter<P, false>(bm, bb, L, th);
  if (kExp) {
    for (int idx = threadIdx.x; idx < L.n * L.rp; idx += blockDim.x) {
      const int j = idx / L.rp, i = idx - j * L.rp;
      rbt[idx] = i < L.n ? pack_elem<P>(rb[i * L.n + j]) : 0u;
    }
  }
#pragma unroll
  for (int c = 0; c < CI; ++c)
    for (int idx = threadIdx.x; idx < 16 * kQuadPitch; idx += blockDim.x)
      tbuf[c][idx] = 0.f;

  // kRecompute: steps k_lo .. k_hi - 1 of span blockIdx.y, each block
  // from its checkpoint (the next one in tck, fetched in a block's last
  // step, replaces the exit renorm); otherwise every step from t0
  const int k_lo = MODE == kRecompute ? blockIdx.y * span : 0;
  const int k_hi = MODE == kRecompute ? min(k_lo + span, n_steps) : n_steps;
  const float* tin = MODE == kRecompute ? t0 + (k_lo / unroll) * plane : t0;

  for (int gi = 0; gi < G; gi += CI) {
    int col[CI];
    bool live[CI];
    size_t at_i[CI];
    float t[CI], tck[CI], acc[CI];
    ChunkedInputs sa[CI];
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      col[c] = blockIdx.x * G + gi + c;
      live[c] = gi + c < G && col[c] < B;
      at_i[c] = static_cast<size_t>(th.i) * stride + col[c];
      t[c] = (th.active && live[c]) ? tin[at_i[c]] : 0.f;
      tck[c] = acc[c] = 0.f;
      sa[c].init(se + k_lo * stride + col[c], stride,
                 live[c] ? k_hi - k_lo : 0);
    }
    if (!live[0]) break;
    __syncthreads();   // the constants; the last columns' buffers

    // Take the limb's ehat of the history's hn steps p0 .. p0 + hn - 1,
    // the totals of |y|^2 (DEFER; kRows writes them to n2s) and the loss
    // terms (warp c mod nw holds column c's acc), after every thread's
    // stores of the steps.
    auto flush = [&](int p0, int hn) {
      __syncthreads();
      if (kExp) {
#pragma unroll
        for (int c = 0; c < CI; ++c)
          fwd_limb<P>(rbt, hist[c], L, hn, p0, R[c].e);
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        if (th.warp != c % L.nw || !live[c]) continue;
        if (DEFER && th.lane < hn) {
          const int j = p0 + th.lane, sl = j % kFwdSlots;
          const float r = parts_total(R[c].t + sl * L.nw, L.nw);
          R[c].tt[sl] = r;
          if (kRows) n2s[j * stride + col[c]] = r;
        }
        __syncwarp();
        if (kExp) {
          float term = 0.f;
          if (th.lane < hn) {
            const int j = p0 + th.lane, sl = j % kFwdSlots;
            float x = 2.f * parts_total(R[c].e + sl * L.nw, L.nw);
            if (DEFER) {
              const float n2p =
                  j % unroll == 0 ? 1.f
                                  : R[c].tt[(j + kFwdSlots - 1) % kFwdSlots];
              x = x / floor_at(n2p, norm_eps);
            }
            term = logf(floor_at(1.f + x * R[c].s[sl], log_eps));
          }
          acc[c] -= warp_sum(term);
        }
      }
      __syncthreads();
    };

    int p0 = k_lo;               // the history's first step
    int kb = 0;                  // the step's place in its block
    int sk = k_lo % kFwdSlots;   // the ring slot of step k
    for (int k = k_lo; k < k_hi; ++k) {
      const int par = ((k - k_lo) & 1) * 8 * kQuadPitch;   // (hi, lo)
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        if (kCk && th.owner && live[c] && kb == 0)
          ck[(k / unroll) * plane + at_i[c]] = t[c];
        float* vb = tbuf[c] + par;
        if (th.owner)
          store_vec<P>(vb + th.iw, vb + 4 * kQuadPitch + th.iw, 0, t[c]);
      }
      __syncthreads();
      const int h = k - p0;
      const bool block_end = kb == unroll - 1;
      float y[CI], t_part[CI];
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        const float s = sa[c].at(k - k_lo);
        if (MODE == kRecompute && th.active && live[c] &&
            (k + 1) % unroll == 0 && k + 1 < k_hi)
          tck[c] = t0[((k + 1) / unroll) * plane + at_i[c]];
        float a, b;
        const float* vb = tbuf[c] + par + th.q * kQuadPitch;
        quad_walk<P>(am, bm, vb, vb + 4 * kQuadPitch, extra, a, b);
        y[c] = a + s * b;
        if (th.owner && live[c]) {
          if (kRows) ys[k * plane + at_i[c]] = y[c];
          if (kExp) {
            float* hr = hist[c] + th.i * kHistPitch + h;
            hr[0] = y[c];
            store_vec<P>(hr + L.n * kHistPitch, hr + 2 * L.n * kHistPitch,
                         0, y[c]);
          }
        }
        t_part[c] = th.owner ? y[c] * y[c] : 0.f;
        if (DEFER) {
          const float w = row_sum8(t_part[c]);
          if (th.lane == 0) R[c].t[sk * L.nw + th.warp] = w;
          t[c] = y[c];
        }
        if (kExp && th.tid == 0) R[c].s[sk] = s;
      }
      if (!DEFER) {
        float n2[CI];
        quad_cta_sums<CI>(t_part, red, L.nw, n2);
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          if (kRows && th.tid == 0 && live[c])
            n2s[k * stride + col[c]] = n2[c];
          t[c] = (MODE == kRecompute && block_end)
                     ? tck[c] : y[c] * rsqrtf(floor_at(n2[c], norm_eps));
        }
      }
      if ((kExp || DEFER) &&
          (k + 1 == k_hi || h + 1 == kHist || (DEFER && block_end))) {
        flush(p0, h + 1);
        if (DEFER && block_end && k + 1 < k_hi) {
#pragma unroll
          for (int c = 0; c < CI; ++c)
            t[c] = MODE == kRecompute
                       ? tck[c]
                       : y[c] * rsqrtf(floor_at(R[c].tt[sk], norm_eps));
        }
        p0 = k + 1;
      }
      kb = block_end ? 0 : kb + 1;
      sk = sk + 1 == kFwdSlots ? 0 : sk + 1;
    }
#pragma unroll
    for (int c = 0; c < CI; ++c)
      if (kExp && th.warp == c % L.nw && th.lane == 0 && live[c])
        loss[col[c]] = acc[c];
    __syncthreads();   // every thread is done with these columns' buffers
  }
}

// Launch the forward for the runtime precision and norm flag, G columns a
// CTA (fwd_cols of them side by side, in turn): ceil(B / G) CTAs, or, with
// kRecompute, ceil(B / G) x ceil(n_steps / span) (t0 then holds the
// segment's checkpoints; span, the steps of one CTA, is a whole number of
// blocks). kBatched takes the deferred norm and G = 1 only and writes loss
// and ck. The pointers a MODE does not write may be null.
template <int MODE>
cudaError_t launch_fwd(const float* ab, const float* bb, const float* rb,
                       const float* t0, const float* se, float* loss,
                       float* ys, float* n2s, float* ck, int D, int n_steps,
                       int B, int unroll, int span, float log_eps,
                       float norm_eps, int precision, bool defer, int G,
                       cudaStream_t stream) {
  if (unroll < 1 || span < unroll || span % unroll || G < 1 || !quad_fits(D))
    return cudaErrorInvalidValue;
  // the batched mode has the deferred norm and one column a CTA only
  if (MODE == kBatched && (!defer || G != 1)) return cudaErrorInvalidValue;
  const dim3 grid((B + G - 1) / G,
                  MODE == kRecompute ? (n_steps + span - 1) / span : 1);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  const Quad L(D);
  const auto launch = [&](auto ci) {
    return dispatch(precision, defer, [&](auto p, auto d) {
      return dispatch_bool(L.threads > kQuadThreads, [&](auto big) {
        return launch_smem(
            psi_fwd_kernel<decltype(p)::value, decltype(d)::value, MODE,
                           decltype(big)::value, decltype(ci)::value>,
            grid, L.threads, fwd_smem_bytes(D, G), stream, ab, bb, rb, t0,
            se, loss, ys, n2s, ck, D, n_steps, B, unroll, span, G, log_eps,
            norm_eps);
      });
    });
  };
  if constexpr (MODE == kBatched) {
    return launch(std::integral_constant<int, 1>{});
  } else {
    return fwd_cols(G) == 2 ? launch(std::integral_constant<int, 2>{})
                            : launch(std::integral_constant<int, 1>{});
  }
}

}  // namespace amt
