// Shared pieces of the rho adjoint's tail (rho_train_bwd.cu), the
// sampler's one-CTA tile (rho_sample.cu's QuadTile, with its own thread
// order) and, through rank_partials.cuh, the rank-partials kernels: the
// thread layout over one example's factor segment and the [2D,2D] x
// [2D,R] product on it. The block forward, the adjoint chain and the
// sampler's clusters spread a segment over a cluster instead
// (rho_cluster.cuh, which takes the matrix loads and unpack4 from here).
//
// Layout. A rho example is a segment of R = rank state
// columns, [2D, R]; its trace and expectation are sums over the whole
// segment. So one CTA owns one segment and runs the whole time loop, and the
// per-example sums are CTA reductions in a fixed order (no atomics). The
// CTA has TX = ceil(R/4) column groups and TY = D/4 row groups (D % 4 == 0),
// rounded up to whole warps; thread (ty, tx) = (threadIdx.x / TX,
// threadIdx.x % TX) owns the 8 x 4 tile of rows {4ty + r, D + 4ty + r : r <
// 4} and columns 4tx + c (the real and the imaginary row of a complex
// component in one thread). At D=64, R=64 that is 16 x 16 = 256 threads,
// 32 state elements each.
//
// Shared memory. A product M v reads M "j-major" (mj[j*n + i] = coefficient
// of v[j] in out[i]): four consecutive rows of column j are one 16-byte
// load, the two row groups of a warp are a broadcast, and the state row j
// of the thread's four columns is one 16-byte load. The state tile is
// stored prepped for the precision (see common.cuh), [2D, RS] with RS =
// 4 TX, its padding columns held at zero. The j-major form of M is its
// transpose (load_matrix_t) for M v, and M itself (load_matrix) for M^T v.
//
// The product of one step: 8 x 4 x NM accumulators a thread, one FMA a
// matrix element per column (three at kHigh), 16-byte shared loads.
#pragma once

#include "common.cuh"

namespace amt {

constexpr int kRhoMaxThreads = 256;   // TX, TY <= 16: D <= 64, R <= 64

struct RhoTile {
  int D, n, R, rs, ty, tx;
  bool active;  // the thread owns rows and columns of the segment

  __device__ RhoTile(int D_, int R_) : D(D_), n(2 * D_), R(R_) {
    const int TX = (R + 3) / 4;
    rs = 4 * TX;
    ty = threadIdx.x / TX;
    tx = threadIdx.x - ty * TX;
    active = ty < D / 4;
  }
  __device__ int row(int r) const {
    return r < 4 ? 4 * ty + r : D + 4 * ty + (r - 4);
  }
  __device__ int col(int c) const { return 4 * tx + c; }
  __device__ bool valid(int c) const { return active && col(c) < R; }
};

// Threads of a rho CTA: TX x TY rounded up to whole warps.
inline int rho_threads(int D, int R) {
  const int t = ((R + 3) / 4) * (D / 4);
  return ((t + 31) / 32) * 32;
}

// Words of the prepped state tile [2D, RS].
inline size_t rho_state_words(int D, int R) {
  return 2 * static_cast<size_t>(D) * 4 * ((R + 3) / 4);
}

// Copy the row-major [n,n] matrix src into shared memory as it is, packed
// for precision P (the j-major form of its transpose's products).
template <int P>
__device__ void load_matrix(uint32_t* dst, const float* __restrict__ src,
                            int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
    dst[idx] = pack_elem<P>(src[idx]);
}

// Write the thread's tile x (zero in padding columns) to the prepped state.
template <int P>
__device__ __forceinline__ void store_tile(uint32_t* st, const RhoTile& tl,
                                           const float (&x)[8][4]) {
  if (!tl.active) return;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      st[tl.row(r) * tl.rs + tl.col(c)] =
          pack_elem<P>(tl.col(c) < tl.R ? x[r][c] : 0.f);
}

// Read the thread's tile of a [*, cols] array at column offset col0 (zero
// outside the segment).
__device__ __forceinline__ void load_tile(float (&x)[8][4],
                                          const float* __restrict__ src,
                                          size_t cols, size_t col0,
                                          const RhoTile& tl) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      x[r][c] = tl.valid(c) ? src[tl.row(r) * cols + col0 + tl.col(c)] : 0.f;
}

__device__ __forceinline__ void store_tile_global(float* __restrict__ dst,
                                                  size_t cols, size_t col0,
                                                  const RhoTile& tl,
                                                  const float (&x)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (tl.valid(c)) dst[tl.row(r) * cols + col0 + tl.col(c)] = x[r][c];
}

// Four packed words -> the values (kHigh: the bf16 hi parts in h, the lo
// parts in l).
template <int P>
__device__ __forceinline__ void unpack4(uint4 w, float* h, float* l) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (P == kHigh) {
      h[q] = __uint_as_float(v[q] & 0xffff0000u);
      l[q] = __uint_as_float(v[q] << 16);
    } else {
      h[q] = __uint_as_float(v[q]);
      l[q] = 0.f;
    }
  }
}

// acc[m] = M_m v for NM j-major shared matrices mj[m] over the prepped state
// st: the thread's 8 x 4 tile of each product, summed over j < n in order
// (at kHigh the three bf16 products of each term go into one accumulator).
template <int P, int NM>
__device__ __forceinline__ void tile_products(const uint32_t* const (&mj)[NM],
                                              const uint32_t* st,
                                              const RhoTile& tl,
                                              float (&acc)[NM][8][4]) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][r][c] = 0.f;
  if (!tl.active) return;
  const int n = tl.n;
  const int r0 = 4 * tl.ty, r1 = tl.D + 4 * tl.ty, c0 = 4 * tl.tx;
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    float sh[4], sl[4];
    unpack4<P>(*reinterpret_cast<const uint4*>(st + j * tl.rs + c0), sh, sl);
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float mh[8], ml[8];
      unpack4<P>(*reinterpret_cast<const uint4*>(mj[m] + j * n + r0), mh,
                 ml);
      unpack4<P>(*reinterpret_cast<const uint4*>(mj[m] + j * n + r1),
                 mh + 4, ml + 4);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = fmaf(mh[r], sh[c], acc[m][r][c]);
          if (P == kHigh) {
            a = fmaf(mh[r], sl[c], a);
            a = fmaf(ml[r], sh[c], a);
          }
          acc[m][r][c] = a;
        }
    }
  }
}

// The thread's share of sum(x .* y) over its valid elements.
__device__ __forceinline__ float tile_dot(const float (&x)[8][4],
                                          const float (&y)[8][4],
                                          const RhoTile& tl) {
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (tl.valid(c)) s = fmaf(x[r][c], y[r][c], s);
  return s;
}

}  // namespace amt
