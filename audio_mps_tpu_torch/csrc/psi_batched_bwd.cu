// Adjoint of psi's spine/limbs training pair (block-complex layout,
// deferred norm) for Hopper, with its recompute and its parameter
// cotangents in the same CTA.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py
// _make_psi_bwd_kernel_batched (:338; the factory's batched=True). One CTA
// per column loops over the blocks of unroll steps, last first, and for
// each block does what the TPU kernel does in one grid step:
//   1. the spine re-run from the checkpoint ck[j]: y_k = Ab t_k + s_k Bb t_k,
//      t_{k+1} = y_k, into a [2D, K] shared buffer (st);
//   2. the batched tail: RU = Rb Y, ehat_k and n2_k; then the
//      forward-computable e, arg, darg, dehat and dn2_new of every step,
//      dru_k = 2 dehat_k y_k and the chain-independent part
//      c_k = (2 dn2_k y_k + 2 dehat_k RU_k) + Rb^T dru_k (into dyb);
//   3. the serial reverse spine: dy_k = dt + c_k, then
//      dt <- Ab^T dy_k + s_k (Bb^T dy_k), dse_k = darg_k e_k +
//      sum((Bb^T dy_k) .* t_k);
//   4. the three lane contractions dy t^T, dy (s t)^T and dru y^T, added to
//      the CTA's own row of part[B, 3, 2D, 2D] in device memory.
// The dn2 bookkeeping is psi_train_bwd.cu's: the block-exit renorm seeds
// the block's last step (dn2_exit from the dt entering it), a block's first
// step drops its dn2_new (its n2p is the constant 1), and after the last
// real step no cotangent enters (dt = 0, so dn2_exit = 0). The loop runs
// over the real steps only: dse is [n_steps, B], not the TPU's padded rows.
// No ys or dy stream of the run reaches device memory, and there is no
// separate recompute launch.
//
// Design. Ab, Bb and Rb sit once in shared memory, packed, row-major at a
// row pitch of 2D rounded to 4 plus 4 words (4 mod 32 at D=64). The spine
// and the chain run psi_fwd.cuh's quad layout, each on its own constants:
// thread (i, q) holds the quarter q of row i of Ab and Bb for the re-run,
// of Ab^T and Bb^T for the chain, loaded from shared memory into registers
// at the start of each phase (both sets at once would be the whole
// register file: 2 x 68 words at 512 threads), so a step is one walk of
// the prepped vector and one CTA barrier, as in the forward. The quarters
// are interleaved (quarter q holds j = q, q + 4, ...), so the row loads of
// the re-run meet 32 distinct banks and the column loads of the chain two
// lanes a bank. The tail runs chain-free over the block's states in
// register tiles, as psi_train_bwd.cu's tail: thread (lq, stile, rtile)
// forms a 4-row x 4-step tile of Rb Y over every fourth 4-j chunk (four
// 16-byte rows of Rb and four 16-byte step rows of Y feed 64 FMAs), and of
// Rb^T dru over every fourth j (one 16-byte row of Rb and one of dru feed
// 16), the four quarters added by two shuffles; dru is never stored, but
// formed from y as it is loaded. The contractions run once a window of
// blocks (a multiple of unroll up to 64 steps, ops/block.py
// psi_batched_window) from a per-column device scratch of the window's t,
// y and dy vectors and s and 2 dehat, written as each phase makes them:
// the window's vectors come back through the free st and dyb buffers in
// double-buffered cp.async stages, and thread tile (a, b) keeps a 4 x 8
// tile of one sum in registers (32 FMAs for three 16-byte shared loads a
// slot), then adds the window's tile to its row of part, so part is read
// and written once a window, not once a block. (Read straight from the
// scratch, the contractions took 23 of 58 ms at D=64, B=128 on an H100:
// each slot's loads waited on L2.) The wrapper (ops/block.py
// psi_batched_bwd) adds the rows in a fixed order: no atomics, and two
// runs are equal bit for bit.
//
// What bounds it, a column-step at D=64, B=128 on an H100 (each phase
// alone, timed in builds with the others compiled out): the re-run's two
// [2D,2D] x [2D] products ~0.5 us and the chain's two ~0.75 (each a
// 32-FMA-deep walk, two shuffles and a CTA barrier a step), the tail's two
// ~0.6 (64 FMAs for eight 16-byte loads), the three contractions ~0.95
// (4x the FMA time of their 49152 FMAs at 128 lanes an SM; what holds
// them is not measured), the rest ~0.08; device memory moves ck, se,
// dse, the scratch (3 [2D] vectors a step, written once and read three
// times) and part (3 (2D)^2 x 8 bytes a window).
#include "psi_fwd.cuh"

namespace amt {

constexpr int kBatchedChunk = 16;   // the tail's steps a chunk: 4 x 4

// The sizes of one batched adjoint CTA at bond dimension D, unroll K.
struct BatchedBwd {
  Quad L;
  int pitch;   // the constants' row pitch in words
  int kc;      // steps of the block buffers: K rounded to 4
  int kp;      // the state buffers' row pitch: kc + 4 (a tile of the last
               // chunk may read past a row's kc, into the next row or
               // the buffers after st and dyb: finite values whose sums
               // are discarded)
  int np;      // floats of a scratch vector: 2D rounded to 8
  __host__ __device__ BatchedBwd(int D, int K) : L(D) {
    pitch = (L.n + 3) / 4 * 4 + 4;
    kc = (K + 3) / 4 * 4;
    kp = kc + 4;
    np = (L.n + 7) / 8 * 8;
  }
  // floats of one scratch slot: t, y and dy, then s and 2 dehat (padded)
  __host__ __device__ int slot_words() const { return 3 * np + 4; }
  // words of dynamic shared memory: the three constants, st and dyb, the
  // block's entry state, the walk's double buffer, six [kc] scalar rows,
  // the tail's [2][16][nw] parts, 32 CTA-sum parts and the [16][nw] ring
  // of the chain's dse parts
  __host__ __device__ size_t words() const {
    const size_t r = L.rows;
    return 3 * r * pitch + 2 * r * kp + r + 16 * kQuadPitch + 6 * kc +
           3 * kBatchedChunk * L.nw + 32;
  }
};

// The first design's shared memory (padded constants, three [2D, K]
// buffers, three [2D] vectors, four [K] rows and its reductions): the
// ceiling the adjoint keeps, D=64 at unroll 16 on an H100 and not D=68.
__host__ __device__ inline size_t batched_bwd_ceiling_bytes(int D, int K) {
  const size_t n = 2 * static_cast<size_t>(D);
  const size_t kp = (static_cast<size_t>(K) + 7) / 8 * 8 + 4;
  const size_t warps = (n + 31) / 32;
  return ((3 * n * (n + 1) + 3) / 4 * 4 + 3 * n * kp + 3 * n + 4 * kp +
          16 * warps + 32) * 4;
}

// The value a product sees of x: h (and at kHigh the lo part l).
template <int P>
__device__ __forceinline__ void prep_hl(float x, float& h, float& l) {
  if (P == kHigh) {
    split_bf16(x, h, l);
  } else {
    h = P == kDefault ? bf16_round(x) : x;
    l = h;
  }
}

// Quarter q of row i of the packed shared matrix m (COL: of column i) into
// registers, interleaved: m[e] is element j = 4 e + q; zeros past 2D.
template <bool COL>
__device__ __forceinline__ void load_quarter_smem(uint32_t (&m)[kQuadJ],
                                                  const uint32_t* ms,
                                                  int pitch, const Quad& L,
                                                  const QuadThread& th) {
#pragma unroll
  for (int e = 0; e < kQuadJ; ++e) {
    const int j = 4 * e + th.q;
    const bool ok = th.active && j < L.n;
    m[e] = ok ? (COL ? ms[j * pitch + th.i] : ms[th.i * pitch + j]) : 0u;
  }
}

// The tile of Rb Y: out[r][c] = (M v_{k0+c})_{r0+r} for the packed shared
// M (row-major, m[i * pitch + j] = M[i][j]) and the raw states v ([j][kp],
// steps contiguous): the thread takes the 4-j chunks j0 = 4 lq, 4 lq + 16,
// ..., each an fmaf chain in order (kHigh: three, added as quad_sum adds
// them); the four quarters are added by two shuffles, every lane of the
// quad getting the tile.
template <int P>
__device__ __forceinline__ void tile_rows(const uint32_t* m, int pitch,
                                          const float* v, int kp, int n,
                                          int r0, int k0, int lq,
                                          float (&out)[4][4]) {
  float acc[4][4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = 0.f;
  for (int j0 = 4 * lq; j0 < n; j0 += 16) {
    uint32_t mw[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4 w = *reinterpret_cast<const uint4*>(m + (r0 + r) * pitch +
                                                      j0);
      mw[r][0] = w.x;
      mw[r][1] = w.y;
      mw[r][2] = w.z;
      mw[r][3] = w.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 x = ld4(v + (j0 + jj) * kp + k0);
      float h[4], l[4];
      prep_hl<P>(x.x, h[0], l[0]);
      prep_hl<P>(x.y, h[1], l[1]);
      prep_hl<P>(x.z, h[2], l[2]);
      prep_hl<P>(x.w, h[3], l[3]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          quad_fma<P>(mw[r][jj], h[c], l[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = quad_sum<P>(acc[r][c]);
}

// The tile of Rb^T (d .* Y): out[r][c] = sum_j M[j][r0+r] d_c v[j][k0+c],
// the scaled state formed as it is loaded (dru = 2 dehat y, the same bits
// as the plain version's product): the thread takes j = lq, lq + 4, ...
// (one 16-byte row of M and one of v a j), the quarters added as in
// tile_rows.
template <int P>
__device__ __forceinline__ void tile_cols(const uint32_t* m, int pitch,
                                          const float* v, int kp,
                                          const float (&d)[4], int n, int r0,
                                          int k0, int lq,
                                          float (&out)[4][4]) {
  float acc[4][4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = 0.f;
#pragma unroll 2
  for (int j = lq; j < n; j += 4) {
    const uint4 w = *reinterpret_cast<const uint4*>(m + j * pitch + r0);
    const uint32_t mw[4] = {w.x, w.y, w.z, w.w};
    const float4 x = ld4(v + j * kp + k0);
    float h[4], l[4];
    prep_hl<P>(d[0] * x.x, h[0], l[0]);
    prep_hl<P>(d[1] * x.y, h[1], l[1]);
    prep_hl<P>(d[2] * x.z, h[2], l[2]);
    prep_hl<P>(d[3] * x.w, h[3], l[3]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) quad_fma<P>(mw[r], h[c], l[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = quad_sum<P>(acc[r][c]);
}

// One pass of a window's contractions, sum M of dAb += dy t^T (M 0),
// dBb += dy (s t)^T (1), dRb += (2 dehat y) y^T (2) over the window's wn
// slots of the scratch sc, added to the column's row of part (prow:
// [3][2D][2D], zeros before the first window). The slots' left and right
// vectors (and s, 2 dehat) come through shared memory in stages of up to 8
// slots, double-buffered (cp.async, the next stage in flight while this
// one is summed), in `stage` (stage_floats: the free st and dyb buffers).
// Thread tile (a0, bt) keeps a 4 x 8 tile of the sum in registers, rows
// a0 .. a0 + 3 and the columns 4 bt .. and 4 (bt + tb) .. (so a
// quarter-warp's 16-byte loads of the right vector meet distinct banks),
// each entry one fmaf chain over the slots in order (kHigh: hi hi, hi lo
// and lo hi into it in turn); at D <= 64 a thread has at most one tile.
// Every thread of the CTA calls it. (A third stage in flight, or the pass
// kept out of line, ran 1.04-1.11x slower at D=64, B=128 and 1024 on an
// H100.)
template <int P, int M>
__device__ void contract_pass(const float* sc, const BatchedBwd& S, int wn,
                              float* stage, int stage_floats, float* prow) {
  const int n = S.L.n, np = S.np, sw = S.slot_words();
  const int ss = 2 * np + 4;                       // floats of a staged slot
  const int per = np / 2 + 1;                      // its 16-byte pieces
  const int cap = min(8, stage_floats / (2 * ss));  // slots a stage
  const int nst = (wn + cap - 1) / cap;
  const int ta = (n + 3) / 4, tb = (n + 7) / 8;
  const int tid = threadIdx.x;
  const bool has = tid < ta * tb;
  const int a0 = 4 * (tid / tb), bt = tid % tb;
  const int col[2] = {4 * bt, 4 * (bt + tb)};
  // left: dy (M 0, 1) or y, scaled by 2 dehat (M 2); right: t, s t, y
  const int lo = M == 2 ? np : 2 * np;
  const int ro = M == 2 ? np : 0;
  const auto issue = [&](int si) {
    float* buf = stage + (si & 1) * cap * ss;
    const int w0 = si * cap, ns = min(cap, wn - w0);
    for (int c = tid; c < ns * per; c += blockDim.x) {
      const int j = c / per, q = c - j * per;
      const float* src = sc + static_cast<size_t>(w0 + j) * sw;
      float* dst = buf + j * ss;
      if (q < np / 4) {
        cp16(dst + 4 * q, src + lo + 4 * q, 16);
      } else if (q < np / 2) {
        cp16(dst + np + 4 * (q - np / 4), src + ro + 4 * (q - np / 4), 16);
      } else {
        cp16(dst + 2 * np, src + 3 * np, 16);
      }
    }
    cp_commit();
  };
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  issue(0);
  for (int si = 0; si < nst; ++si) {
    if (si + 1 < nst) {
      issue(si + 1);
      cp_wait<1>();   // stage si has landed
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* buf = stage + (si & 1) * cap * ss;
    const int ns = min(cap, wn - si * cap);
    if (has) {
#pragma unroll 2
      for (int j = 0; j < ns; ++j) {
        const float* sl = buf + j * ss;
        const float4 xa = ld4(sl + a0);
        const float4 y0 = ld4(sl + np + col[0]);
        const float4 y1 = ld4(sl + np + col[1]);
        const float xs[4] = {xa.x, xa.y, xa.z, xa.w};
        const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
        float xh[4], xl[4], yh[8], yl[8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          prep_hl<P>(M == 2 ? sl[2 * np + 1] * xs[r] : xs[r], xh[r], xl[r]);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          prep_hl<P>(M == 1 ? sl[2 * np] * ys[c] : ys[c], yh[c], yl[c]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            acc[r][c] = fmaf(xh[r], yh[c], acc[r][c]);
            if (P == kHigh) {
              acc[r][c] = fmaf(xh[r], yl[c], acc[r][c]);
              acc[r][c] = fmaf(xl[r], yh[c], acc[r][c]);
            }
          }
      }
    }
    __syncthreads();   // the stage's buffer is written again at si + 2
  }
  if (!has) return;
  const size_t nn = static_cast<size_t>(n) * n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (a0 + r >= n) continue;
    float* dst = prow + M * nn + static_cast<size_t>(a0 + r) * n;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int b = col[c / 4] + c % 4;
      if (b < n) dst[b] += acc[r][c];
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kQuadThreads, 1)
    psi_batched_bwd_kernel(const float* __restrict__ ab,
                           const float* __restrict__ bb,
                           const float* __restrict__ rb,
                           const float* __restrict__ ck,
                           const float* __restrict__ se,
                           const float* __restrict__ g,
                           float* __restrict__ dse, float* __restrict__ dt0,
                           float* __restrict__ part, float* __restrict__ scr,
                           int D, int n_steps, int B, int unroll, int window,
                           float log_eps, float norm_eps) {
  extern __shared__ __align__(16) float4 smem4[];
  const BatchedBwd S(D, unroll);
  const Quad& L = S.L;
  const QuadThread th(L);
  const int n = L.n, nw = L.nw, pitch = S.pitch, kp = S.kp;
  uint32_t* abm = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* bbm = abm + L.rows * pitch;
  uint32_t* rbm = bbm + L.rows * pitch;
  float* st = reinterpret_cast<float*>(rbm + L.rows * pitch);  // y_k
  float* dyb = st + L.rows * kp;    // 2 dehat RU, then c_k
  float* tin = dyb + L.rows * kp;   // the block's entry state t_0
  float* vb = tin + L.rows;         // [2][hi, lo][4][kQuadPitch]
  float* sv = vb + 16 * kQuadPitch; // s_k
  float* ev = sv + S.kc;            // e_k
  float* dgv = ev + S.kc;           // darg_k
  float* d2v = dgv + S.kc;          // dn2_new_k
  float* dh2 = d2v + S.kc;          // 2 dehat_k
  float* n2v = dh2 + S.kc;          // n2_k
  float* red = n2v + S.kc;          // [2][16][nw]: the tail's parts
  float* red2 = red + 2 * kBatchedChunk * nw;   // [32]: CTA sums
  float* ring = red2 + 32;          // [16][nw]: the chain's dse parts

  const int col = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;
  const size_t nn = static_cast<size_t>(n) * n;
  const bool extra = L.jq > 32;
  // the quad's vector slot of row i: quarter i mod 4, entry i / 4
  const int iw = (th.i & 3) * kQuadPitch + (th.i >> 2);
  const size_t at_i = static_cast<size_t>(th.i) * stride + col;
  // the tail's tile: quarter lq, steps 4 stl .. of a chunk, rows r0 ..
  const int lq = lane & 3, stl = (lane >> 2) & 3;
  const int r0 = 8 * warp + 4 * (lane >> 4);
  float* prow = part + static_cast<size_t>(col) * 3 * nn;
  const int sw = S.slot_words();
  float* sc = scr + static_cast<size_t>(col) * window * sw;

  for (int idx = tid; idx < L.rows * pitch; idx += blockDim.x) {
    const int r = idx / pitch, c = idx - r * pitch;
    const bool ok = r < n && c < n;
    const int at = r * n + c;
    abm[idx] = ok ? pack_elem<P>(ab[at]) : 0u;
    bbm[idx] = ok ? pack_elem<P>(bb[at]) : 0u;
    rbm[idx] = ok ? pack_elem<P>(rb[at]) : 0u;
  }
  for (int idx = tid; idx < 2 * L.rows * kp + L.rows + 16 * kQuadPitch;
       idx += blockDim.x)
    st[idx] = 0.f;

  const float gc = g[col];
  float dt = 0.f;      // the cotangent of the state after the block
  int wn = 0;          // the window's filled slots
  const int n_blocks = (n_steps + unroll - 1) / unroll;
  for (int blk = n_blocks - 1; blk >= 0; --blk) {
    const int k0 = blk * unroll;
    const int kn = min(unroll, n_steps - k0);
    float* slot0 = sc + static_cast<size_t>(wn) * sw;
    __syncthreads();   // the later block is done with every buffer
    float t = th.active ? ck[blk * plane + at_i] : 0.f;
    if (th.owner) tin[th.i] = t;
    for (int k = tid; k < kn; k += blockDim.x) sv[k] = se[(k0 + k) * stride + col];
    uint32_t am[kQuadJ], bm[kQuadJ];
    load_quarter_smem<false>(am, abm, pitch, L, th);
    load_quarter_smem<false>(bm, bbm, pitch, L, th);

    // 1. the spine, re-run from the checkpoint
    for (int k = 0; k < kn; ++k) {
      float* v = vb + (k & 1) * 8 * kQuadPitch;
      float* slot = slot0 + static_cast<size_t>(k) * sw;
      if (th.owner) {
        store_vec<P>(v + iw, v + 4 * kQuadPitch + iw, 0, t);
        slot[th.i] = t;
      }
      __syncthreads();
      float a, b;
      const float* u = v + th.q * kQuadPitch;
      quad_walk<P>(am, bm, u, u + 4 * kQuadPitch, extra, a, b);
      t = a + sv[k] * b;
      if (th.owner) {
        st[th.i * kp + k] = t;
        slot[S.np + th.i] = t;
      }
    }
    __syncthreads();

    // 2a. the tail: RU = Rb Y a chunk at a time; ehat, n2 and every step's
    // scalars; dyb holds 2 dehat RU
    for (int c0 = 0; c0 < kn; c0 += kBatchedChunk) {
      const int kt = c0 + 4 * stl;   // the tile's first step
      float ru[4][4];
      tile_rows<P>(rbm, pitch, st, kp, n, r0, kt, lq, ru);
      float e = 0.f, t2 = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float y = st[(r0 + r) * kp + kt + lq];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c == lq) e = fmaf(y, ru[r][c], e);
        t2 = fmaf(y, y, t2);
      }
      e += __shfl_xor_sync(0xffffffffu, e, 16);
      t2 += __shfl_xor_sync(0xffffffffu, t2, 16);
      if (lane < 16) {
        red[lane * nw + warp] = e;
        red[(kBatchedChunk + lane) * nw + warp] = t2;
      }
      __syncthreads();
      if (tid < kBatchedChunk && c0 + tid < kn) {
        ev[c0 + tid] = 2.f * parts_total(red + tid * nw, nw);
        n2v[c0 + tid] = parts_total(red + (kBatchedChunk + tid) * nw, nw);
      }
      __syncthreads();
      if (tid < kBatchedChunk && c0 + tid < kn) {
        const int k = c0 + tid;
        const float n2p = k == 0 ? 1.f : n2v[k - 1];
        const float s = sv[k];
        const float n2p_c = floor_at(n2p, norm_eps);
        const float e_k = ev[k] / n2p_c;
        const float arg = floor_at(1.f + e_k * s, log_eps);
        const float darg = arg > log_eps ? -gc / arg : 0.f;
        const float de = darg * s;
        const float dehat = de / n2p_c;
        ev[k] = e_k;
        dgv[k] = darg;
        d2v[k] = n2p > norm_eps ? -de * e_k / n2p_c : 0.f;
        dh2[k] = 2.f * dehat;
        float* slot = slot0 + static_cast<size_t>(k) * sw + 3 * S.np;
        slot[0] = s;
        slot[1] = 2.f * dehat;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r != lq || r0 + r >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (kt + c < kn) dyb[(r0 + r) * kp + kt + c] = ru[r][c] * dh2[kt + c];
      }
    }
    // the block-exit renorm's adjoint: dt enters scaled, dn2_exit seeds the
    // last step
    const float dinv = quad_cta_sum(
        th.owner ? dt * st[th.i * kp + kn - 1] : 0.f, red2, nw);
    const float n2x = n2v[kn - 1];
    const float inv = rsqrtf(floor_at(n2x, norm_eps));
    const float dn2_exit =
        n2x > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
    dt *= inv;

    // 2b. c_k = (2 dn2_k y_k + 2 dehat_k RU_k) + Rb^T dru_k
    for (int c0 = 0; c0 < kn; c0 += kBatchedChunk) {
      const int kt = c0 + 4 * stl;
      float d[4], rt[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) d[c] = kt + c < kn ? dh2[kt + c] : 0.f;
      tile_cols<P>(rbm, pitch, st, kp, d, n, r0, kt, lq, rt);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r != lq || r0 + r >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = kt + c;
          if (k >= kn) continue;
          const float dn2 = k + 1 < kn ? d2v[k + 1] : dn2_exit;
          const float y = st[(r0 + r) * kp + k];
          float* q = dyb + (r0 + r) * kp + k;
          *q = (y * (2.f * dn2) + *q) + rt[r][c];
        }
      }
    }
    __syncthreads();

    // 3. the serial reverse spine on Ab^T and Bb^T
    load_quarter_smem<true>(am, abm, pitch, L, th);
    load_quarter_smem<true>(bm, bbm, pitch, L, th);
    int pend = 0;   // steps whose dse parts wait in the ring
    for (int k = kn - 1; k >= 0; --k) {
      float* v = vb + (k & 1) * 8 * kQuadPitch;
      const float dy = th.active ? dt + dyb[th.i * kp + k] : 0.f;
      if (th.owner) {
        store_vec<P>(v + iw, v + 4 * kQuadPitch + iw, 0, dy);
        slot0[static_cast<size_t>(k) * sw + 2 * S.np + th.i] = dy;
      }
      __syncthreads();
      float at, du;
      const float* u = v + th.q * kQuadPitch;
      quad_walk<P>(am, bm, u, u + 4 * kQuadPitch, extra, at, du);
      const float tk = !th.active ? 0.f
                       : (k > 0 ? st[th.i * kp + k - 1] : tin[th.i]);
      const float w = row_sum8(th.owner ? du * tk : 0.f);
      if (lane == 0) ring[(k % kBatchedChunk) * nw + warp] = w;
      dt = at + sv[k] * du;
      if (++pend == kBatchedChunk || k == 0) {
        // dse of steps k .. k + pend - 1; the next step writes the ring
        // only after its barrier
        __syncthreads();
        if (tid < pend) {
          const int j = k + tid;
          dse[(k0 + j) * stride + col] =
              dgv[j] * ev[j] +
              parts_total(ring + (j % kBatchedChunk) * nw, nw);
        }
        pend = 0;
      }
    }

    // 4. the window's contractions, once it is full or the run is done
    wn += kn;
    if (blk == 0 || wn + unroll > window) {
      contract_pass<P, 0>(sc, S, wn, st, 2 * L.rows * kp, prow);
      contract_pass<P, 1>(sc, S, wn, st, 2 * L.rows * kp, prow);
      contract_pass<P, 2>(sc, S, wn, st, 2 * L.rows * kp, prow);
      // the stages used st and dyb: the tail needs their pad rows zero
      for (int idx = tid; idx < 2 * L.rows * kp; idx += blockDim.x)
        st[idx] = 0.f;
      wn = 0;
    }
  }
  if (th.owner) dt0[at_i] = dt;
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one batched adjoint CTA, as the fit rule takes
// it: the larger of the kernel's CTA (amt::BatchedBwd::words) and the
// first design's count (batched_bwd_ceiling_bytes: 231,104 bytes at D=64,
// K=16), so the adjoint takes the shapes it took.
size_t amt_psi_batched_bwd_smem_bytes(int D, int unroll) {
  const size_t own = 4 * amt::BatchedBwd(D, unroll).words();
  const size_t first = amt::batched_bwd_ceiling_bytes(D, unroll);
  return own > first ? own : first;
}

// Floats of one column's scratch for a window of `window` steps: t, y and
// dy ([2D] rounded to 8 each) and s, 2 dehat a step.
size_t amt_psi_batched_bwd_scratch_floats(int D, int window) {
  return static_cast<size_t>(window) * amt::BatchedBwd(D, 1).slot_words();
}

// dse[n_steps, B], dt0[2D, B] and part[B, 3, 2D, 2D] (each column's dAb,
// dBb and dRb added to zeros, for the caller to add over the columns; it
// zero-fills part) from the loss
// cotangent g[B] and the checkpoints ck[ceil(n_steps / unroll), 2D, B] of
// psi_batched_fwd.cu; scr is scratch of B x
// amt_psi_batched_bwd_scratch_floats(D, window) floats, window a multiple
// of unroll (ops/block.py psi_batched_window). See the note above.
// precision: 0 highest, 1 high, 2 default. Returns a cudaError_t.
int amt_psi_batched_bwd(const float* ab, const float* bb, const float* rb,
                        const float* ck, const float* se, const float* g,
                        float* dse, float* dt0, float* part, float* scr,
                        int D, int n_steps, int B, int unroll, int window,
                        float log_eps, float norm_eps, int precision,
                        void* stream) {
  const amt::Quad L(D);
  if (unroll < 1 || window < unroll || window % unroll ||
      !amt::quad_fits(D) || L.threads > amt::kQuadThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    return amt::launch_smem(
        amt::psi_batched_bwd_kernel<decltype(p)::value>, B, L.threads,
        4 * amt::BatchedBwd(D, unroll).words(),
        static_cast<cudaStream_t>(stream), ab, bb, rb, ck, se, g, dse, dt0,
        part, scr, D, n_steps, B, unroll, window, log_eps, norm_eps);
  }));
}

}  // extern "C"
