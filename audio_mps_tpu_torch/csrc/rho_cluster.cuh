// The rho block forward (rho_fwd.cuh), adjoint chain (rho_train_bwd.cu)
// and sampler (rho_sample.cu) over a thread-block cluster: an example's
// (or chain's) [2D, R] segment spread over C CTAs by its rank columns, and
// the per-example sums exchanged between them in a fixed order.
//
// Layout. The segment's R columns form G = ceil(R/4) groups of 4; CTA c of
// an example's cluster owns the ng = G/C groups c ng .. (c+1) ng - 1, all
// 2D rows, and keeps its constants whole in shared memory. A product M t
// acts column by column, so a CTA needs nothing from the others for its
// products; the column sums that couple them (the forward's expectation
// and trace, the adjoint's dinv and dsum) go through the exchange below.
// A thread owns one row i and BC consecutive columns of the CTA's 4 ng:
// a warp is 32 consecutive rows of one column block, so its load of a
// constant row j is one 32-bit word a lane, 128 contiguous bytes, and its
// load of the state row j is the same BC words for every lane (BC/4
// 16-byte broadcasts); each constant word feeds BC FMAs. BC is 8 (4 when
// the CTA has one group; 16 where 8 would need more than 16 warps: C=1 at
// D > 32 and R > 32). At D=64, R=64, C=8: one block of 8 columns, 4 warps,
// 1024 outputs a product. What bounds a step is the shared-memory
// pipeline, which takes a load instruction's 32 lanes' bytes whether they
// are distinct or one broadcast: a row j costs each warp 3 constant words
// and BC state words a lane, for 3 BC FMAs (PERF.md §6 has the tiles
// tried).
//
// Products. Each output element's sum over j runs from j=0 to 2D-1 as one
// fmaf chain (three fmaf a term at kHigh, into one accumulator), as
// tile_products in rho_tile.cuh does: y is the same bits at every tile
// shape and every C. The sum is never split over warps (a split order
// broke a 1e-5 hold of the rank partials).
//
// Sums. A step's sum over the segment (of x .* y, say) is taken in one
// order whatever C and BC are: an atom is the fmaf chain over one row's 4
// columns of a group; a warp adds its 32 rows' atoms of a group by xor
// shuffles (each level a commutative pair sum, so every lane gets the same
// bits); lane 0 writes them to part[rw][g] (rw: the row warp); a group's
// sum is then, from 0.f, the sum over rw in order, and the segment's sum,
// from 0.f, the groups' sums in index order. Sums wait in per-step slots
// (kRhoSlots) until an exchange: under the deferred norm the forward's
// state is rescaled only at block exits, so its CTAs agree once an
// unroll-step block (or every kRhoSlots steps past that); the adjoint
// needs dinv only at renorm steps. At an exchange each CTA's group sums of
// the waiting slots (P, two sets by the exchange's parity, so a CTA that
// runs ahead writes the other set) are read by every CTA of the cluster
// over distributed shared memory (mapa, ld.shared::cluster) after one
// barrier.cluster, and each CTA adds them in group order into tot. At C=1
// the group sums go straight into tot. The sampler exchanges every step
// and skips the reduce: after its cluster barrier every warp reads the
// row warps' parts of each group from the CTA that owns it (warp_totals),
// in the same order.
#pragma once

#include "rho_tile.cuh"

namespace amt {

constexpr int kRhoCtaThreads = 512;   // launch bound of the cluster kernels
constexpr int kRhoSlots = 16;         // steps whose sums wait for one exchange
constexpr int kRhoMaxGroups = 16;     // column groups of 4: R <= 64
constexpr int kRhoMaxCluster = 16;
constexpr int kRhoParts = 3;          // part sets in flight (step mod 3)

// Columns a thread (see the note above): 4 for one group, else 8 unless
// that needs more than 16 warps, then 16.
__host__ __device__ inline int rho_cols_per_thread(int n, int cwid) {
  if (cwid <= 4) return 4;
  return 32 * ((n + 31) / 32) * ((cwid + 7) / 8) <= kRhoCtaThreads ? 8 : 16;
}

// The CTA-level layout of one launch at D, R and the cluster C (host and
// device): the state rows n, the groups G, ng a CTA, its columns cwid, the
// columns a thread BC in NB blocks, the state tile's row width sw = NB BC
// (zero past cwid), the row warps RW and the threads.
struct RhoLayout {
  int n, R, C, G, ng, cwid, BC, NB, sw, RW, threads;

  __host__ __device__ RhoLayout(int D, int R_, int C_) {
    n = 2 * D;
    R = R_;
    C = C_;
    G = (R + 3) / 4;
    ng = G / C;
    cwid = 4 * ng;
    BC = rho_cols_per_thread(n, cwid);
    NB = (cwid + BC - 1) / BC;
    sw = NB * BC;
    RW = (n + 31) / 32;
    threads = 32 * RW * NB;
  }
};

// A cluster size the rho block kernels take at R: 1 .. kRhoMaxCluster,
// dividing the R/4 column groups.
__host__ __device__ inline bool rho_cluster_ok(int C, int R) {
  const int G = (R + 3) / 4;
  return C >= 1 && C <= kRhoMaxCluster && G % C == 0;
}

// The thread's tile: row i, local columns cb0 .. cb0 + BC - 1 of the CTA's
// cwid (global column col0 + local column).
template <int BC>
struct RhoCTile {
  int n, R, cwid, sw, i, cb0, rw, col0;
  bool active;   // the thread owns a row

  __device__ RhoCTile(const RhoLayout& L, int cta) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    n = L.n;
    R = L.R;
    cwid = L.cwid;
    sw = L.sw;
    rw = warp % L.RW;
    i = 32 * rw + lane;
    cb0 = (warp / L.RW) * BC;
    col0 = cta * L.cwid;
    active = i < n;
  }
  __device__ bool valid(int c) const {
    return active && cb0 + c < cwid && col0 + cb0 + c < R;
  }
};

// Write the thread's row of x (zero in padding columns) to the prepped
// state [2D, sw].
template <int P, int BC>
__device__ __forceinline__ void store_ctile(uint32_t* st,
                                            const RhoCTile<BC>& tl,
                                            const float (&x)[BC]) {
  if (!tl.active) return;
  uint32_t* dst = st + tl.i * tl.sw + tl.cb0;
#pragma unroll
  for (int q = 0; q < BC / 4; ++q) {
    uint4 v;
    v.x = pack_elem<P>(tl.valid(4 * q) ? x[4 * q] : 0.f);
    v.y = pack_elem<P>(tl.valid(4 * q + 1) ? x[4 * q + 1] : 0.f);
    v.z = pack_elem<P>(tl.valid(4 * q + 2) ? x[4 * q + 2] : 0.f);
    v.w = pack_elem<P>(tl.valid(4 * q + 3) ? x[4 * q + 3] : 0.f);
    reinterpret_cast<uint4*>(dst)[q] = v;
  }
}

// Read the thread's row of a [*, cols] array whose example columns start
// at col0 (zero outside the segment); 16-byte loads where R % 4 == 0 (a
// group of 4 columns is then valid or padding as a whole, and aligned).
template <int BC>
__device__ __forceinline__ void load_ctile(float (&x)[BC],
                                           const float* __restrict__ src,
                                           size_t cols, size_t col0,
                                           const RhoCTile<BC>& tl) {
  const float* row = src + tl.i * cols + col0 + tl.col0 + tl.cb0;
  if (tl.R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BC / 4; ++q) {
      const float4 v = tl.valid(4 * q)
                           ? reinterpret_cast<const float4*>(row)[q]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < BC; ++c) x[c] = tl.valid(c) ? row[c] : 0.f;
  }
}

template <int BC>
__device__ __forceinline__ void store_ctile_global(
    float* __restrict__ dst, size_t cols, size_t col0,
    const RhoCTile<BC>& tl, const float (&x)[BC]) {
  float* row = dst + tl.i * cols + col0 + tl.col0 + tl.cb0;
  if (tl.R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BC / 4; ++q)
      if (tl.valid(4 * q))
        reinterpret_cast<float4*>(row)[q] =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < BC; ++c)
      if (tl.valid(c)) row[c] = x[c];
  }
}

// The raw words one j of a product reads: the BC state words of row j
// (the same for the whole warp) and the thread's constant of each matrix.
template <int BC, int NM>
struct CtileOps {
  uint4 s[BC / 4];
  uint32_t m[NM];
};

template <int BC, int NM>
__device__ __forceinline__ void ctile_load(CtileOps<BC, NM>& o,
                                           const uint32_t* const (&mj)[NM],
                                           const uint32_t* sp, int sw, int n,
                                           int i, int j) {
#pragma unroll
  for (int q = 0; q < BC / 4; ++q)
    o.s[q] = reinterpret_cast<const uint4*>(sp + j * sw)[q];
#pragma unroll
  for (int m = 0; m < NM; ++m) o.m[m] = mj[m][j * n + i];
}

template <int P>
__device__ __forceinline__ void split_word(uint32_t w, float& h, float& l) {
  if (P == kHigh) {
    h = __uint_as_float(w & 0xffff0000u);
    l = __uint_as_float(w << 16);
  } else {
    h = __uint_as_float(w);
    l = 0.f;
  }
}

template <int P, int BC, int NM>
__device__ __forceinline__ void ctile_fma(const CtileOps<BC, NM>& o,
                                          float (&acc)[NM][BC]) {
  float sh[BC], sl[BC];
#pragma unroll
  for (int q = 0; q < BC / 4; ++q) {
    split_word<P>(o.s[q].x, sh[4 * q], sl[4 * q]);
    split_word<P>(o.s[q].y, sh[4 * q + 1], sl[4 * q + 1]);
    split_word<P>(o.s[q].z, sh[4 * q + 2], sl[4 * q + 2]);
    split_word<P>(o.s[q].w, sh[4 * q + 3], sl[4 * q + 3]);
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    float mh, ml;
    split_word<P>(o.m[m], mh, ml);
#pragma unroll
    for (int c = 0; c < BC; ++c) {
      float a = fmaf(mh, sh[c], acc[m][c]);
      if (P == kHigh) {
        a = fmaf(mh, sl[c], a);
        a = fmaf(ml, sh[c], a);
      }
      acc[m][c] = a;
    }
  }
}

// acc[m] = M_m v for NM j-major shared matrices mj[m] (rows of n words,
// n % 4 == 0) over the prepped state st: the thread's row of each product
// over its BC columns, summed over j < n in order (see the note above).
// The loads of row j are written AHEAD rows ahead of its FMAs (ptxas may
// move them; volatile loads that it keeps in place ran no faster).
template <int P, int BC, int NM>
__device__ __forceinline__ void ctile_products(
    const uint32_t* const (&mj)[NM], const uint32_t* st,
    const RhoCTile<BC>& tl, float (&acc)[NM][BC]) {
  constexpr int AHEAD = BC >= 16 ? 2 : 4;
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int c = 0; c < BC; ++c) acc[m][c] = 0.f;
  if (!tl.active) return;
  const int n = tl.n, i = tl.i, sw = tl.sw;
  const uint32_t* sp = st + tl.cb0;
  CtileOps<BC, NM> o[AHEAD];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) ctile_load(o[u], mj, sp, sw, n, i, u);
  for (int j = 0; j < n; j += AHEAD) {
    // rows past the last reload the last ones (never used)
    const int jn = j + AHEAD < n ? j + AHEAD : n - AHEAD;
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      ctile_fma<P>(o[u], acc);
      ctile_load(o[u], mj, sp, sw, n, i, jn + u);
    }
  }
}

// The warp's sums of x .* y over its 32 rows, one a group of the thread's
// BC columns: the atoms (the group's 4 columns in order, valid elements
// only), then xor shuffles over the lanes. Every lane of the warp must
// call it.
template <int BC>
__device__ __forceinline__ void ctile_dots(const float (&x)[BC],
                                           const float (&y)[BC],
                                           const RhoCTile<BC>& tl,
                                           float (&out)[BC / 4]) {
#pragma unroll
  for (int q = 0; q < BC / 4; ++q) {
    float s = 0.f;
#pragma unroll
    for (int c = 4 * q; c < 4 * q + 4; ++c)
      if (tl.valid(c)) s = fmaf(x[c], y[c], s);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    out[q] = s;
  }
}

// Words of the exchange's slots (host and device): part [kRhoParts][NS]
// [RW][ng], P [2][nslot][NS][ng] (C > 1 only), tot [nslot][NS].
__host__ __device__ inline int rho_sums_words(const RhoLayout& L, int NS,
                                              int nslot) {
  return kRhoParts * NS * L.RW * L.ng +
         (L.C > 1 ? 2 * nslot * NS * L.ng : 0) + nslot * NS;
}

// The slots of the per-example sums and the exchange (see the note above).
struct RhoSums {
  float* part;
  float* P;
  float* tot;
  int NS, nslot, RW, ng, G, C;

  __device__ RhoSums(float* base, const RhoLayout& L, int NS_, int nslot_)
      : NS(NS_), nslot(nslot_), RW(L.RW), ng(L.ng), G(L.G), C(L.C) {
    part = base;
    P = part + kRhoParts * NS * RW * ng;
    tot = P + (C > 1 ? 2 * nslot * NS * ng : 0);
  }

  // The warp sums v of sum `s` (ctile_dots) into part set `k`: lane 0
  // writes them.
  template <int BC>
  __device__ void write(int k, int s, const RhoCTile<BC>& tl,
                        const float (&v)[BC / 4]) const {
    if ((threadIdx.x & 31) == 0) {
      float* dst = part + ((k * NS + s) * RW + tl.rw) * ng + tl.cb0 / 4;
#pragma unroll
      for (int q = 0; q < BC / 4; ++q)
        if (tl.cb0 / 4 + q < ng) dst[q] = v[q];
    }
  }

  // One warp sum v (row warp rw, the CTA's group g) of sum s into part
  // set k.
  __device__ void write_at(int k, int s, int rw, int g, float v) const {
    part[((k * NS + s) * RW + rw) * ng + g] = v;
  }

  // Group g's sum of sum s from part set k.
  __device__ float group(int k, int s, int g) const {
    const float* src = part + (k * NS + s) * RW * ng + g;
    float a = 0.f;
    for (int w = 0; w < RW; ++w) a += src[w * ng];
    return a;
  }

  // Part set k (every part of it written before a CTA barrier that the
  // caller has passed) into slot `slot` of P set `par` (C > 1) or of tot.
  __device__ void reduce(int k, int slot, int par) const {
    const int t = threadIdx.x;
    if (C == 1) {
      if (t < NS) {
        float a = 0.f;
        for (int g = 0; g < G; ++g) a += group(k, t, g);
        tot[slot * NS + t] = a;
      }
    } else if (t < NS * ng) {
      const int s = t % NS, g = t / NS;
      P[((par * nslot + slot) * NS + s) * ng + g] = group(k, s, g);
    }
  }

  // tot of slots [0, n) and, with extra >= 0, of slot `extra`, from every
  // CTA's P set `par` (C > 1; after a cluster_sync that follows every
  // CTA's reduce of them).
  __device__ void gather(int par, int n, int extra) const {
    const int t = threadIdx.x;
    const int m = n + (extra >= 0 ? 1 : 0);
    if (C == 1 || t >= NS * m) return;
    const int slot = t / NS < n ? t / NS : extra, s = t % NS;
    const float* src = P + (par * nslot + slot) * NS * ng + s * ng;
    float v[kRhoMaxGroups];
#pragma unroll
    for (int g = 0; g < kRhoMaxGroups; ++g)
      v[g] = g < G ? ld_cluster(src + g % ng, g / ng) : 0.f;
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < kRhoMaxGroups; ++g)
      if (g < G) a += v[g];
    tot[slot * NS + s] = a;
  }

  __device__ float total(int slot, int s) const { return tot[slot * NS + s]; }

  // The NS sums of part set k over the whole segment, in the order above,
  // read straight from the part set of the CTA that owns each group (no
  // reduce, no P, no tot: slots sized with nslot = 0): lane s G + g of
  // the calling warp adds group g of sum s over its row warps (NS G <=
  // 32), then every lane adds the groups in index order through shuffles,
  // so every lane of every warp gets the same bits. C > 1: over
  // distributed shared memory, after a cluster_sync that follows every
  // CTA's writes of set k; C = 1: after a CTA barrier.
  template <int NSUM>
  __device__ void warp_totals(int k, float (&out)[NSUM]) const {
    constexpr int kMaxRW = 4;   // n <= 128
    const int lane = threadIdx.x & 31;
    float a = 0.f;
    if (lane < NSUM * G) {
      const int s = lane / G, g = lane % G;
      const float* src = part + (k * NS + s) * RW * ng + g % ng;
      float v[kMaxRW];
#pragma unroll
      for (int w = 0; w < kMaxRW; ++w)
        if (w < RW)
          v[w] = C == 1 ? src[w * ng] : ld_cluster(src + w * ng, g / ng);
#pragma unroll
      for (int w = 0; w < kMaxRW; ++w)
        if (w < RW) a += v[w];
    }
#pragma unroll
    for (int s = 0; s < NSUM; ++s) {
      float t = 0.f;
      for (int g = 0; g < G; ++g) t += __shfl_sync(0xffffffffu, a, s * G + g);
      out[s] = t;
    }
  }
};

// The card's opt-in shared memory a block (host).
inline int smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

// f(std::integral_constant<int, BC>{}) for the columns a thread (4, 8 or
// 16).
template <typename F>
cudaError_t dispatch_cols4(int BC, F&& f) {
  switch (BC) {
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    case 16:
      return f(std::integral_constant<int, 16>{});
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace amt
