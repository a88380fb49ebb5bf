// Shared pieces of the rank-partials kernels (rank_partials_fwd.cu,
// rank_partials_bwd.cu): [2D,2D] x [2D, rc] products whose constants stream
// from global memory through shared memory.
//
// Layout. A CTA owns one segment of rc state columns (an example's chunk of
// rank rows) with the thread tile of rho_tile.cuh: thread (ty, tx) holds
// rows {4ty + r, D + 4ty + r} x columns 4tx + c, so D/4 x ceil(rc/4) threads
// compute and the CTA has 256 (the rest only help with the loads). The
// segment's prepped state tile [2D, 4 ceil(rc/4)] stays in shared memory.
//
// Constants. At D=256 Ab, Bb and Xb are 1 MiB each and no block holds them,
// so a product M v walks M in slabs of ks rows of its "j-major" form (row j
// holds the coefficients of v[j]; ks x 2D = 4096 words): each thread loads
// its four 16-byte words of the next slab from global memory (the matrices
// are read by every CTA each step and stay in the 50 MB L2) into registers
// while the CTA multiplies the current slab, then packs them for the
// precision into the other of two shared buffers. A product with COMBINE
// forms M = M1 + s M2 while staging (one fmaf an element), which is how the
// forward takes y = (Ab + s Bb) t in one product: the rank rows of an
// example share its increment s.
#pragma once

#include "rho_tile.cuh"

namespace amt {

constexpr int kPartialsThreads = 256;
constexpr int kSlabWords = 4096;
constexpr int kSlabLoads = kSlabWords / 4 / kPartialsThreads;  // 16-byte words

// Rows of M's j-major form in one slab.
__host__ __device__ inline int slab_rows(int n) {
  const int k = kSlabWords / n;
  return k < n ? k : n;
}

// acc[m] += sum over j < count of M_m's j-major row j times row j of the
// prepped state: mj[m] and st point at the first of those rows (rows n
// words apart in mj, RS in st), summed in order (at kHigh the three bf16
// products of each term go into one accumulator). It is the loop of
// rho_tile.cuh's tile_products over a slab; sharing that one function
// slowed the rho adjoint chain by ~6% on the H100, so the two stay apart.
template <int P, int NM>
__device__ __forceinline__ void accumulate_rows(const uint32_t* const* mj,
                                                const uint32_t* st, int count,
                                                const RhoTile& tl,
                                                float (&acc)[NM][8][4]) {
  const int n = tl.n;
  const int r0 = 4 * tl.ty, r1 = tl.D + 4 * tl.ty, c0 = 4 * tl.tx;
#pragma unroll 2
  for (int j = 0; j < count; ++j) {
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

// acc[m] = M_m v over the prepped state st, for NM matrices given j-major
// in global memory (fp32, [n, n] row-major: mg[m][j*n + i] is the
// coefficient of v[j] in out[i]). With COMBINE (NM == 1) the matrix is
// mg[0] + s mg[1]. slabs holds 2 NM buffers of kSlabWords words. Every
// thread of the CTA calls it; it ends with __syncthreads(), so st and slabs
// may be written again on return. The sum over j is in order, as in
// tile_products (accumulate_rows over each slab).
template <int P, int NM, bool COMBINE>
__device__ void stream_products(const float* const* mg, float s,
                                const uint32_t* st, uint32_t* slabs,
                                const RhoTile& tl, float (&acc)[NM][8][4]) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][r][c] = 0.f;
  const int n = tl.n;
  const int ks = slab_rows(n);
  const int nslab = (n + ks - 1) / ks;
  float4 reg[NM][kSlabLoads];

  auto load = [&](int js) {
    const int j0 = js * ks;
    const int words4 = (n - j0 < ks ? n - j0 : ks) * n / 4;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float4* a = reinterpret_cast<const float4*>(
          mg[m] + static_cast<size_t>(j0) * n);
      const float4* b = reinterpret_cast<const float4*>(
          mg[COMBINE ? 1 : m] + static_cast<size_t>(j0) * n);
#pragma unroll
      for (int u = 0; u < kSlabLoads; ++u) {
        const int q = threadIdx.x + u * kPartialsThreads;
        if (q < words4) {
          float4 x = __ldg(a + q);
          if (COMBINE) {
            const float4 y = __ldg(b + q);
            x.x = fmaf(s, y.x, x.x);
            x.y = fmaf(s, y.y, x.y);
            x.z = fmaf(s, y.z, x.z);
            x.w = fmaf(s, y.w, x.w);
          }
          reg[m][u] = x;
        }
      }
    }
  };
  auto store = [&](int js) {
    const int j0 = js * ks;
    const int words4 = (n - j0 < ks ? n - j0 : ks) * n / 4;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      uint4* dst = reinterpret_cast<uint4*>(slabs + (2 * m + (js & 1)) *
                                                        kSlabWords);
#pragma unroll
      for (int u = 0; u < kSlabLoads; ++u) {
        const int q = threadIdx.x + u * kPartialsThreads;
        if (q < words4) {
          const float4 x = reg[m][u];
          dst[q] = make_uint4(pack_elem<P>(x.x), pack_elem<P>(x.y),
                              pack_elem<P>(x.z), pack_elem<P>(x.w));
        }
      }
    }
  };

  load(0);
  store(0);
  __syncthreads();
  for (int js = 0; js < nslab; ++js) {
    if (js + 1 < nslab) load(js + 1);
    if (tl.active) {
      const int j0 = js * ks;
      const uint32_t* slab[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m)
        slab[m] = slabs + (2 * m + (js & 1)) * kSlabWords;
      accumulate_rows<P, NM>(slab, st + j0 * tl.rs, n - j0 < ks ? n - j0 : ks,
                             tl, acc);
    }
    if (js + 1 < nslab) store(js + 1);
    __syncthreads();
  }
}

// Words of the state tile and the reduction floats of a partials CTA.
__host__ __device__ inline int partials_base_words(int D, int rc) {
  return 2 * D * 4 * ((rc + 3) / 4) + 64;
}

// Dynamic shared memory of a partials CTA with NM staged matrices.
inline size_t partials_smem_bytes(int D, int rc, int NM) {
  return (partials_base_words(D, rc) + 2 * NM * kSlabWords) * 4;
}

// A segment's columns and the thread layout fit the partials CTA.
inline bool partials_fits(int D, int rc) {
  return D % 4 == 0 && rc >= 1 && (D / 4) * ((rc + 3) / 4) <= kPartialsThreads;
}

}  // namespace amt
