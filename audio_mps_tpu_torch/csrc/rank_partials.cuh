// Shared pieces of the rank-partials kernels (rank_partials_fwd.cuh,
// rank_partials_bwd.cu): [2D,2D] x [2D, rc] products whose constants stream
// from global memory through a ring of shared-memory stages, which a
// thread-block cluster may share.
//
// Layout. A CTA owns one segment of rc state columns (an example's chunk of
// rank rows) with the thread tile of rho_tile.cuh: thread (ty, tx) of the
// 256 consumer threads holds rows {4ty + r, D + 4ty + r} x columns
// 4tx + c, so D/4 x ceil(rc/4) threads compute; a ninth warp is the
// producer. The segment's prepped state tile [2D, 4 ceil(rc/4)] stays in
// shared memory. Each output element is one fmaf chain over j in order,
// as in tile_products and in the staged kernels these replace, so they
// track their plain versions as closely as those did (an 8 x 8 tile with
// the rows of each slab split between two halves of the CTA, summed once
// a product, ran as fast, but its other order moved the D=256 checkpoint
// forward 1.7e-5 of max|plain| off its plain version over 2048 steps,
// past its 1e-5 hold).
//
// Constants. At D=256 Ab, Bb and Xb are 1 MiB each and no block holds them.
// A product M v walks M in slabs of ks rows of its "j-major" form (row j
// holds the coefficients of v[j]); a slab of one matrix is one contiguous
// run of ks 2D words, so it lands by one bulk copy (cp.async.bulk, no
// tensor map) in a ring stage of 8192 words: ks = 16 rows of one matrix or
// 8 rows each of two (Ab and Bb) at D=256. The producer warp keeps kStages
// slabs in flight under mbarriers (full: the bytes landed; empty: the 8
// consumer warps of every CTA of the cluster are done, each warp arriving
// on the empty barrier of every CTA), so the consumers never wait on a
// CTA-wide barrier between slabs. In a cluster of cs CTAs each CTA copies
// 1/cs of each slab and multicasts it to all cs, so the cluster reads each
// slab from L2 once. The CTAs of a cluster walk the same slabs (the same
// steps), and what a CTA computes does not depend on cs: the same bits land
// in every stage. A product with COMBINE forms M = M1 + s M2 in registers
// from the two raw slabs (one fmaf an element), which is how the forward
// takes y = (Ab + s Bb) t in one product: the multicast slabs are raw, and
// the segments of a cluster may belong to different examples. The
// precision's bf16 split is taken in registers too.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W, D=256, rc=16, highest;
// tools/partials_attribution.py): the products. The forward's two products
// alone take 75.7 us a step against 35 us at the fp32 FMA peak (a thread
// reads 12 or 20 shared words a row j for 32 or 40 FMAs, one 16-byte load
// each; 8 x 8 tiles ran no faster overall, nor did more registers, a
// register prefetch of the next row or deeper unrolling); the copies alone
// take 46.6 us (8.6 TB/s from L2), 27.6 in clusters of 2, which halve the
// L2 reads; the kernel takes 80.6, 82.9 in clusters of 2: the fetch hides
// under the products, and a refill then waits for both CTAs.
#pragma once

#include "rho_tile.cuh"

namespace amt {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kPartialsThreads = kConsumers + 32;   // + the producer warp
constexpr int kStageWords = 8192;                   // a ring stage, 32 KB
constexpr int kStages = 4;
constexpr int kMaxCluster = 16;

// Rows of a matrix's j-major form in a slab of nm matrices.
__host__ __device__ inline int slab_rows(int n, int nm) {
  const int k = kStageWords / nm / n;
  return k < n ? k : n;
}

// Words of the prepped state tile [2D, 4 ceil(rc/4)].
__host__ __device__ inline int partials_state_words(int D, int rc) {
  return 2 * D * 4 * ((rc + 3) / 4);
}

// Dynamic shared memory of a partials CTA: the ring, the state tile, 64
// reduction floats and 2 mbarriers a stage.
inline size_t partials_smem_bytes(int D, int rc) {
  return 4 * static_cast<size_t>(kStages * kStageWords +
                                 partials_state_words(D, rc) + 64) +
         8 * 2 * kStages;
}

// A segment's columns and the thread layout fit the partials CTA.
inline bool partials_fits(int D, int rc) {
  return D % 4 == 0 && rc >= 1 && (D / 4) * ((rc + 3) / 4) <= kConsumers;
}

// ---------------------------------------------------------------------------
// bulk copies (PTX for sm_90; the mbarriers and the cluster are in
// common.cuh)
// ---------------------------------------------------------------------------

// Copy `bytes` (a multiple of 16) from global src to shared dst, completing
// on `bar`; with mask > 1, to dst and bar's offsets in every CTA of the
// cluster that mask names.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint16_t mask) {
  if (mask > 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
        "multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
}

// The consumer warps alone (the producer warp never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Sums over the consumer threads, as block_sum / block_sum2 of common.cuh:
// each thread adds the warp partials in warp order. `red` must not be
// written again before every consumer has passed a later consumer_sync().
__device__ __forceinline__ float consumer_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  consumer_sync();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < kConsumerWarps; ++w) r += red[w];
  return r;
}

__device__ __forceinline__ void consumer_sum2(float v, float u, float* red,
                                              float& sv, float& su) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  u = warp_sum(u);
  if (lane == 0) {
    red[2 * warp] = v;
    red[2 * warp + 1] = u;
  }
  consumer_sync();
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int w = 0; w < kConsumerWarps; ++w) {
    a += red[2 * w];
    b += red[2 * w + 1];
  }
  sv = a;
  su = b;
}

// ---------------------------------------------------------------------------
// The CTA's shared memory and the ring
// ---------------------------------------------------------------------------

struct PartialsSmem {
  float* ring;         // kStages x kStageWords raw fp32 slabs
  uint32_t* st;        // the prepped state tile [2D, rs]
  float* red;          // 64 reduction floats
  uint64_t* full;      // kStages: the stage's bytes landed
  uint64_t* empty;     // kStages: every consumer warp of the cluster is
                       // done with it

  __device__ PartialsSmem(uint32_t* smem, int D, int rc) {
    ring = reinterpret_cast<float*>(smem);
    st = smem + kStages * kStageWords;
    red = reinterpret_cast<float*>(st + partials_state_words(D, rc));
    full = reinterpret_cast<uint64_t*>(red + 64);
    empty = full + kStages;
  }

  // One thread initialises the barriers; the whole cluster then syncs, so
  // no copy or remote arrival reaches a barrier before it exists.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      const int cs = static_cast<int>(cluster_size());
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, kConsumerWarps * cs);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_sync();
  }
};

// A product's constants: m[0], and m[1] when it takes two (COMBINE, or the
// adjoint chain's pair), each [n, n] fp32 j-major in global memory.
struct Product {
  const float* m[2];
  int nm;
};

// The producer warp: fills the ring with the slabs of n_steps steps, each
// step walking the products prods[0 .. np) in order and each product its
// slabs in order, the same sequence the consumers walk. Before lane 0
// refills a stage, every consumer warp of the cluster must be done with the
// stage's last use (the stage's empty barrier, which the whole warp waits
// on: lane 0 waiting alone woke later, 15 us a forward step at D=256);
// then it arms the stage's full barrier with the slab's bytes and copies
// this CTA's piece of each of the slab's matrices to every CTA of the
// cluster.
__device__ inline void produce(const PartialsSmem& sm,
                               const Product* prods, int np, int n_steps,
                               int n) {
  const int lane = threadIdx.x & 31;
  const uint32_t cs = cluster_size(), rank = cluster_rank();
  const uint16_t mask = static_cast<uint16_t>((1u << cs) - 1u);
  uint32_t q = 0;
  for (int k = 0; k < n_steps; ++k)
    for (int p = 0; p < np; ++p) {
      const Product pr = prods[p];
      const int ks = slab_rows(n, pr.nm);
      for (int j0 = 0; j0 < n; j0 += ks, ++q) {
        const int s = static_cast<int>(q % kStages);
        const uint32_t use = q / kStages;
        if (use > 0) mbar_wait(sm.empty + s, (use - 1) & 1);
        if (lane == 0) {
          const int rows = n - j0 < ks ? n - j0 : ks;
          const uint32_t bytes = 4u * rows * n;
          mbar_arrive_expect_tx(sm.full + s, pr.nm * bytes);
          const uint32_t piece = (bytes / 16 + cs - 1) / cs * 16;
          const uint32_t off = rank * piece;
          if (off < bytes) {
            const uint32_t len = bytes - off < piece ? bytes - off : piece;
            for (int m = 0; m < pr.nm; ++m) {
              char* dst = reinterpret_cast<char*>(sm.ring + s * kStageWords +
                                                  m * (kStageWords / pr.nm));
              const char* src = reinterpret_cast<const char*>(
                  pr.m[m] + static_cast<size_t>(j0) * n);
              bulk_copy(dst + off, src + off, len, sm.full + s, mask);
            }
          }
        }
        __syncwarp();
      }
    }
}

// ---------------------------------------------------------------------------
// The consumers' products
// ---------------------------------------------------------------------------

// Split the eight values v for precision P: the bf16 hi parts in h and lo
// parts in l (kHigh), the bf16 rounding (kDefault), or v (kHighest); the
// same values a pack_elem / unpack4 round trip gives.
template <int P>
__device__ __forceinline__ void prep8(const float (&v)[8], float (&h)[8],
                                      float (&l)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (P == kHigh) {
      split_bf16(v[i], h[i], l[i]);
    } else {
      h[i] = P == kDefault ? bf16_round(v[i]) : v[i];
      l[i] = 0.f;
    }
  }
}

// v = the thread's eight rows of a j-major matrix row mj: mj[r0 .. r0 + 3]
// and mj[r1 .. r1 + 3].
__device__ __forceinline__ void load_rows(const float* mj, int r0, int r1,
                                          float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(mj + r0);
  const float4 b = *reinterpret_cast<const float4*>(mj + r1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// acc[m] = M_m v over the prepped state st for NM matrices whose slabs come
// from the ring in its order (q counts them): the thread's 8 x 4 tile of
// each product (rho_tile.cuh's layout), summed over j in order, one fmaf a
// term (three at kHigh, into one accumulator): the order of tile_products,
// so the bits do not depend on how the slabs are cut or who copied them.
// With COMBINE (NM == 1) the slab holds two matrices and M = m[0] + s m[1],
// formed in registers. Every consumer thread calls it; it ends without a
// CTA barrier, so st must not be rewritten before every consumer has
// passed a later consumer_sync().
template <int P, int NM, bool COMBINE>
__device__ void ring_product(const PartialsSmem& sm, uint32_t& q,
                             const Product& pr, float s, const RhoTile& tl,
                             float (&acc)[NM][8][4]) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][r][c] = 0.f;
  const int n = tl.n;
  const int ks = slab_rows(n, pr.nm);
  const int words = kStageWords / pr.nm;
  const int r0 = 4 * tl.ty, r1 = tl.D + 4 * tl.ty;
  const int lane = threadIdx.x & 31;
  const int cs = static_cast<int>(cluster_size());
  for (int j0 = 0; j0 < n; j0 += ks, ++q) {
    const int stg = static_cast<int>(q % kStages);
    mbar_wait(sm.full + stg, (q / kStages) & 1);
    if (tl.active) {
      const int rows = n - j0 < ks ? n - j0 : ks;
      const float* slab = sm.ring + stg * kStageWords;
      const uint32_t* sp = sm.st + j0 * tl.rs + 4 * tl.tx;
#pragma unroll 2
      for (int j = 0; j < rows; ++j) {
        float sh[4], sl[4];
        unpack4<P>(*reinterpret_cast<const uint4*>(sp + j * tl.rs), sh, sl);
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          float mv[8], mh[8], ml[8];
          load_rows(slab + (COMBINE ? 0 : m * words) + j * n, r0, r1, mv);
          if (COMBINE) {
            float bv[8];
            load_rows(slab + words + j * n, r0, r1, bv);
#pragma unroll
            for (int r = 0; r < 8; ++r) mv[r] = fmaf(s, bv[r], mv[r]);
          }
          prep8<P>(mv, mh, ml);
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
    // the warp is done with the stage: tell every CTA of the cluster
    __syncwarp();
    if (cs == 1) {
      if (lane == 0) mbar_arrive(sm.empty + stg);
    } else if (lane < cs) {
      mbar_arrive_cluster(sm.empty + stg, lane);
    }
  }
}

// Launch a partials kernel: gridDim CTAs of kPartialsThreads in clusters
// of `cluster` CTAs along x (along y with cluster_y); a refused launch
// returns its error (launch_cluster, common.cuh).
template <typename... Params, typename... Args>
cudaError_t launch_partials(void (*kernel)(Params...), dim3 grid, int cluster,
                            bool cluster_y, size_t smem, cudaStream_t stream,
                            Args... args) {
  return launch_cluster(kernel, grid, kPartialsThreads, cluster, cluster_y,
                        smem, stream, args...);
}

// Clusters of `cluster` partials CTAs the card holds at once (a negative
// cudaError_t when the query fails).
template <typename... Params>
int max_partials_clusters(void (*kernel)(Params...), int cluster,
                          size_t smem) {
  return max_active_clusters(kernel, kPartialsThreads, cluster, smem);
}

// A cluster size the launches take: 1 .. kMaxCluster, dividing G.
inline bool cluster_ok(int cluster, int G) {
  return cluster >= 1 && cluster <= kMaxCluster && G % cluster == 0;
}

}  // namespace amt
