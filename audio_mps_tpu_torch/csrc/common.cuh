// Shared pieces of the psi kernels (psi_sample.cu, psi_nll.cu,
// psi_train_fwd.cu, psi_train_bwd.cu, psi_cotangents.cu): the precision menu
// on shared-memory matrices, one-row matrix-vector dots, the block
// reduction, the mbarriers and warp roles of the warp-specialised kernels,
// the thread-block cluster helpers (barrier, rank, distributed shared
// memory, launch and residency) and the dispatch of a C entry's runtime
// options to template arguments.
//
// Layout. A chain kernel's CTA owns one column of the stacked state
// [x_r; x_i] (one chain or one example), or G of them (the floor probe,
// psi_probe.cu: load_cols below), and runs the whole time loop itself.
// Thread i computes row i of every [2D,2D] x [2D] product (psi's block
// forward and adjoint chain lay four threads to a row instead: the quad
// layout of psi_fwd.cuh). The
// forward kernels store each [2D,2D] constant in dynamic shared memory
// TRANSPOSED (mT[j*n + i] = M[i][j]), so in the dot loop the threads of a
// warp read consecutive words (no bank conflicts) while the state element
// v[j] is a broadcast. The adjoint needs both M v and M^T v from one copy:
// it stores M row-major with rows padded to n + 1 words (load_matrix_pad),
// so a row walk (stride 1, rows n + 1 apart, n + 1 odd) and a column walk
// (stride n + 1, consecutive columns) both hit 32 distinct banks.
//
// Precision (the TPU's pallas_block._make_dot_ops), as a template argument:
//   kHighest: fp32 values, fp32 FMA;
//   kHigh:    both operands split into bf16 (hi, lo) with round-to-nearest;
//             the sum hi*hi + hi*lo + lo*hi is taken in fp32 (each bf16
//             product is exact in fp32);
//   kDefault: both operands rounded to bf16, one product, fp32 sum.
// A matrix element takes 4 bytes in every mode: the fp32 value (kHighest),
// the bf16-rounded value as fp32 (kDefault), or the packed bf16 pair
// (hi in the upper 16 bits, lo in the lower) for kHigh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace amt {

enum Precision { kHighest = 0, kHigh = 1, kDefault = 2 };

// What a forward chain launch (psi_fwd.cuh, rho_fwd.cuh,
// rank_partials_fwd.cuh) writes besides its per-step or per-example sums:
// nothing (kNll), every step's state (kStream), the state entering each
// unroll-step block (kCkpt), or, with one CTA per (column group, block),
// the states of a segment's blocks re-run from those checkpoints
// (kRecompute). kBatched (psi_fwd.cuh only) writes kCkpt's checkpoints
// from the spine/limbs split of each block.
enum FwdMode { kNll = 0, kStream = 1, kCkpt = 2, kRecompute = 3,
               kBatched = 4 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 (hi, lo) split of x: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = bf16_round(x);
  lo = bf16_round(x - hi);
}

template <int P>
__device__ __forceinline__ uint32_t pack_elem(float x) {
  if (P == kHigh) {
    float hi, lo;
    split_bf16(x, hi, lo);
    return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
  }
  if (P == kDefault) return __float_as_uint(bf16_round(x));
  return __float_as_uint(x);
}

// Copy the row-major [n,n] matrix src into shared memory, transposed and
// packed for precision P. Runs once per CTA.
template <int P>
__device__ void load_matrix_t(uint32_t* dst, const float* __restrict__ src,
                              int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    dst[j * n + i] = pack_elem<P>(src[idx]);
  }
}

// Copy the row-major [n,n] matrix src into shared memory, row-major with a
// row pitch of n + 1 words, packed for precision P. Runs once per CTA.
template <int P>
__device__ void load_matrix_pad(uint32_t* dst, const float* __restrict__ src,
                                int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    dst[i * (n + 1) + j] = pack_elem<P>(src[idx]);
  }
}

// Publish a state element for the next products: vh holds the value
// (kHighest), its bf16 rounding (kDefault) or its bf16 hi part (kHigh);
// vl holds the kHigh lo part.
template <int P>
__device__ __forceinline__ void store_vec(float* vh, float* vl, int i,
                                          float x) {
  if (P == kHigh) {
    float hi, lo;
    split_bf16(x, hi, lo);
    vh[i] = hi;
    vl[i] = lo;
  } else if (P == kDefault) {
    vh[i] = bf16_round(x);
  } else {
    vh[i] = x;
  }
}

// sum_j m1[j*stride] v[j] and sum_j m2[j*stride] v[j] over j < n, for two
// packed shared matrices walked at the same offsets.
template <int P>
__device__ __forceinline__ void dot2_strided(const uint32_t* m1,
                                             const uint32_t* m2, int stride,
                                             const float* vh, const float* vl,
                                             int n, float& out1, float& out2) {
  if (P == kHigh) {
    float a1 = 0.f, a2 = 0.f, a3 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float h = vh[j], l = vl[j];
      const uint32_t w1 = m1[j * stride], w2 = m2[j * stride];
      const float m1h = __uint_as_float(w1 & 0xffff0000u);
      const float m1l = __uint_as_float(w1 << 16);
      const float m2h = __uint_as_float(w2 & 0xffff0000u);
      const float m2l = __uint_as_float(w2 << 16);
      a1 = fmaf(m1h, h, a1);
      a2 = fmaf(m1h, l, a2);
      a3 = fmaf(m1l, h, a3);
      b1 = fmaf(m2h, h, b1);
      b2 = fmaf(m2h, l, b2);
      b3 = fmaf(m2l, h, b3);
    }
    out1 = (a1 + a2) + a3;
    out2 = (b1 + b2) + b3;
  } else {
    float a = 0.f, b = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float v = vh[j];
      a = fmaf(__uint_as_float(m1[j * stride]), v, a);
      b = fmaf(__uint_as_float(m2[j * stride]), v, b);
    }
    out1 = a;
    out2 = b;
  }
}

// sum_j m[j*stride] v[j] over j < n for one packed shared matrix.
template <int P>
__device__ __forceinline__ float dot_strided(const uint32_t* m, int stride,
                                             const float* vh, const float* vl,
                                             int n) {
  if (P == kHigh) {
    float a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float h = vh[j], l = vl[j];
      const uint32_t w = m[j * stride];
      const float mh = __uint_as_float(w & 0xffff0000u);
      const float ml = __uint_as_float(w << 16);
      a1 = fmaf(mh, h, a1);
      a2 = fmaf(mh, l, a2);
      a3 = fmaf(ml, h, a3);
    }
    return (a1 + a2) + a3;
  }
  float a = 0.f;
#pragma unroll 8
  for (int j = 0; j < n; ++j) a = fmaf(__uint_as_float(m[j * stride]), vh[j], a);
  return a;
}

// Row i of (M1 v) and (M2 v) for two transposed shared matrices.
template <int P>
__device__ __forceinline__ void row_dot2(const uint32_t* m1t,
                                         const uint32_t* m2t, const float* vh,
                                         const float* vl, int n, int i,
                                         float& out1, float& out2) {
  dot2_strided<P>(m1t + i, m2t + i, n, vh, vl, n, out1, out2);
}

// Row i of (M v) for one transposed shared matrix.
template <int P>
__device__ __forceinline__ float row_dot(const uint32_t* mt, const float* vh,
                                         const float* vl, int n, int i) {
  return dot_strided<P>(mt + i, n, vh, vl, n);
}

// G columns a CTA (psi_probe.cu). A [n, G] shared buffer holds element j
// of the G columns' vectors at v[j G + g], so a thread reads row j of all G
// in G / 4 broadcast 16-byte loads (G = 2: one 8-byte load) and writes its
// own row i in G stores.
template <int G>
__device__ __forceinline__ void load_cols(const float* v, int j,
                                          float (&x)[G]) {
  const float* row = v + j * G;
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int c = 0; c < G / 4; ++c) {
      const float4 q = reinterpret_cast<const float4*>(row)[c];
      x[4 * c] = q.x;
      x[4 * c + 1] = q.y;
      x[4 * c + 2] = q.z;
      x[4 * c + 3] = q.w;
    }
  } else if constexpr (G == 2) {
    const float2 q = *reinterpret_cast<const float2*>(row);
    x[0] = q.x;
    x[1] = q.y;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) x[g] = row[g];
  }
}

// Publish row i of G columns' states (store_vec, column by column).
template <int P, int G>
__device__ __forceinline__ void store_cols(float* vh, float* vl, int i,
                                           const float (&x)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) store_vec<P>(vh, vl, i * G + g, x[g]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v (and of u) over the CTA. Every thread gets the same value: the
// warp partials are added in warp order by each thread. `red` must not be
// written again before every thread has passed a later __syncthreads().
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  return r;
}

__device__ __forceinline__ void block_sum2(float v, float u, float* red,
                                           float& sv, float& su) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  u = warp_sum(u);
  if (lane == 0) {
    red[2 * warp] = v;
    red[2 * warp + 1] = u;
  }
  __syncthreads();
  float a = 0.f, b = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    a += red[2 * w];
    b += red[2 * w + 1];
  }
  sv = a;
  su = b;
}

// The CTA sums of N values at once: out[q] = sum over threads of v[q].
// Each value takes block_sum's path (a warp_sum, then the warp partials
// added in warp order from 0), so a value's sum is the same bits as
// block_sum / block_sum2 give it. `red` holds N x (warps) floats and must
// not be written again before every thread has passed a later
// __syncthreads().
template <int N>
__device__ __forceinline__ void block_sum_n(const float (&v)[N], float* red,
                                            float (&out)[N]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float w = warp_sum(v[q]);
    if (lane == 0) red[warp * N + q] = w;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) {
    float a = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) a += red[w * N + q];
    out[q] = a;
  }
}

// A column's increments s_k = se[k * stride] read 32 steps ahead: lane q of
// every warp holds s of step c + q of the current 32-step chunk and of the
// next, so a step's s is a shuffle and each global load has a chunk's
// steps to arrive (the split forwards, psi_split_fwd.cuh and
// rho_split_fwd.cuh, and psi's block forward, psi_fwd.cuh). Every thread
// calls at(k) for k = 0, 1, ... in turn; n = 0 (a dead column) reads
// nothing and gives 0.
struct ChunkedInputs {
  const float* p;
  size_t stride;
  int n, lane;
  float cur, next;

  __device__ ChunkedInputs() {}
  __device__ ChunkedInputs(const float* base, size_t stride_, int n_) {
    init(base, stride_, n_);
  }
  __device__ void init(const float* base, size_t stride_, int n_) {
    p = base;
    stride = stride_;
    n = n_;
    lane = threadIdx.x & 31;
    cur = lane < n ? p[lane * stride] : 0.f;
    next = 32 + lane < n ? p[(32 + lane) * stride] : 0.f;
  }
  __device__ float at(int k) {
    const int q = k & 31;
    if (q == 0 && k > 0) {
      cur = next;
      next = k + 32 + lane < n ? p[(k + 32 + lane) * stride] : 0.f;
    }
    return __shfl_sync(0xffffffffu, cur, q);
  }
};

// max(x, floor) that keeps a NaN x (as jnp.maximum / torch.clamp do).
__device__ __forceinline__ float floor_at(float x, float floor) {
  return x < floor ? floor : x;
}

// The shared-memory address of p, as PTX takes it.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async (sm_80+): 16 bytes global -> shared, bytes < 16 zero-filling
// the rest (psi_cotangents.cu's chunks, psi_batched_bwd.cu's contraction
// stages); a group a commit, waited for with at most N groups in flight.
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers (PTX for sm_90): the rank partials' slab ring
// (rank_partials.cuh) and the split adjoints' hand-over of a block between
// warp roles (psi_split_bwd.cu, rho_split_bwd.cu).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Wait for the phase of `bar` with the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive on `bar` and expect `bytes` more of asynchronous copies or stores
// to complete on its current phase (the rank partials' bulk copies, psi's
// cluster exchange).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// mbar_wait with acquire semantics at cluster scope, for a phase completed
// by other CTAs' st.async (psi's cluster exchange). A phase that has not
// completed after ~2^26 polls traps: a miscounted phase ends the launch
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// Thread-block clusters (PTX for sm_90): the rank partials' slab ring
// (rank_partials.cuh), the rho block kernels' exchange of per-example
// sums over the CTAs of an example (rho_cluster.cuh) and psi's cluster
// layout's exchange of state rows (psi_cluster.cuh).

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// cluster_sync in its two halves: work between them overlaps the wait for
// the other CTAs (every thread arrives, then waits, once a phase).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Arrive on the mbarrier at bar's offset in the shared memory of cluster
// CTA `cta` (the default semantics; a cluster-scope release and acquire
// cost 0.37 us a slab on the H100, a third of the forward's step).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\tmapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n\t}" ::
          "r"(smem_addr(bar)),
      "r"(cta)
      : "memory");
}

// The float at p's offset in the shared memory of cluster CTA `cta` (mapa,
// then a distributed-shared-memory load). A cluster_sync() must order it
// after the store it reads.
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t cta) {
  float v;
  asm volatile(
      "{\n\t.reg .b32 ra;\n\tmapa.shared::cluster.u32 ra, %1, %2;\n\t"
      "ld.shared::cluster.f32 %0, [ra];\n\t}"
      : "=f"(v)
      : "r"(smem_addr(p)), "r"(cta)
      : "memory");
  return v;
}

// Write v (a, b; a .. d) to the float (float2, float4) at p's offset in the
// shared memory of cluster CTA `cta` (mapa, then a distributed-shared-memory
// store; psi_cluster.cuh's pushes). A cluster barrier orders it before the
// reads of that CTA.
__device__ __forceinline__ void st_cluster(float* p, uint32_t cta, float v) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\tmapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "st.shared::cluster.f32 [ra], %2;\n\t}" ::"r"(smem_addr(p)),
      "r"(cta), "f"(v)
      : "memory");
}

__device__ __forceinline__ void st_cluster2(float* p, uint32_t cta, float a,
                                            float b) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\tmapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "st.shared::cluster.v2.f32 [ra], {%2, %3};\n\t}" ::"r"(smem_addr(p)),
      "r"(cta), "f"(a), "f"(b)
      : "memory");
}

__device__ __forceinline__ void st_cluster4(float* p, uint32_t cta, float a,
                                            float b, float c, float d) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\tmapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "st.shared::cluster.v4.f32 [ra], {%2, %3, %4, %5};\n\t}" ::"r"(
          smem_addr(p)),
      "r"(cta), "f"(a), "f"(b), "f"(c), "f"(d)
      : "memory");
}

// st.async (sm_90): write v (a, b; a .. d) to the float (float2, float4) at
// p's offset in the shared memory of cluster CTA `cta`, the bytes
// completing on the mbarrier at bar's offset there (psi_cluster.cuh's
// point-to-point exchange): no fence, the receiver's wait on its mbarrier
// orders the data.
__device__ __forceinline__ void st_async(float* p, uint32_t cta, float v,
                                         uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b32 ra, rb;\n\tmapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mapa.shared::cluster.u32 rb, %2, %1;\n\t"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [ra], %3, "
      "[rb];\n\t}" ::"r"(smem_addr(p)),
      "r"(cta), "r"(smem_addr(bar)), "f"(v)
      : "memory");
}

__device__ __forceinline__ void st_async2(float* p, uint32_t cta, float a,
                                          float b, uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b32 ra, rb;\n\tmapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mapa.shared::cluster.u32 rb, %2, %1;\n\t"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [ra], "
      "{%3, %4}, [rb];\n\t}" ::"r"(smem_addr(p)),
      "r"(cta), "r"(smem_addr(bar)), "f"(a), "f"(b)
      : "memory");
}

__device__ __forceinline__ void st_async4(float* p, uint32_t cta, float a,
                                          float b, float c, float d,
                                          uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b32 ra, rb;\n\tmapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mapa.shared::cluster.u32 rb, %2, %1;\n\t"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [ra], "
      "{%3, %4, %5, %6}, [rb];\n\t}" ::"r"(smem_addr(p)),
      "r"(cta), "r"(smem_addr(bar)), "f"(a), "f"(b), "f"(c), "f"(d)
      : "memory");
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory (past the 48 KB
// default) and, past the portable 8, to clusters of `cluster` CTAs.
template <typename... Params>
cudaError_t cluster_attributes(void (*kernel)(Params...), int cluster,
                               size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// gridDim CTAs of `threads` in clusters of `cluster` CTAs along x (along y
// with cluster_y); attr holds the cluster attribute.
inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int cluster,
                                         bool cluster_y, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster_y ? 1 : cluster;
  attr->val.clusterDim.y = cluster_y ? cluster : 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` in clusters (see cluster_config); a refused launch
// returns its error.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                           int cluster, bool cluster_y, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cluster_attributes(kernel, cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, threads, cluster,
                                                cluster_y, smem, stream,
                                                &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of `cluster` CTAs of `kernel` the card holds at once (a
// negative cudaError_t when the query fails).
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), int threads, int cluster,
                        size_t smem) {
  cudaError_t err = cluster_attributes(kernel, cluster, smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(cluster), threads,
                                                cluster, false, smem, nullptr,
                                                &attr);
  int count = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return err == cudaSuccess ? count : -static_cast<int>(err);
}

// A set of whole warps of a CTA that runs one role of a warp-specialised
// kernel: its own barriers count only its threads (bar.sync id, n; a warp
// barrier for one warp), so no role waits on a barrier another role must
// reach. t is the thread's index within the role, warp its warp's.
struct Role {
  int id;   // named barrier (1..15); 0 is __syncthreads
  int n;    // threads, a multiple of 32
  int t;
  int warp;
};

__device__ __forceinline__ void role_sync(const Role& ro) {
  if (ro.n == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(ro.id), "r"(ro.n) : "memory");
  }
}

// Sum of v over the role, every thread of it getting it: warp shuffles for
// one warp, else block_sum's order (the warp partials added in warp order)
// through red[0, warps), which must not be written again before every
// thread of the role has passed a later role_sync.
__device__ __forceinline__ float role_sum(float v, float* red,
                                          const Role& ro) {
  if (ro.n == 32) {
    __syncwarp();
    return warp_sum(v);
  }
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[ro.warp] = v;
  role_sync(ro);
  float r = 0.f;
  for (int w = 0; w < (ro.n >> 5); ++w) r += red[w];
  return r;
}

// Threads per CTA: one per state row, rounded up to whole warps.
inline int threads_for(int D) { return ((2 * D + 31) / 32) * 32; }

// f(std::integral_constant<int, P>{}) for the runtime precision of a C entry
// (0 highest, 1 high, 2 default); an unknown precision is
// cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch_precision(int precision, F&& f) {
  switch (precision) {
    case kHighest:
      return f(std::integral_constant<int, kHighest>{});
    case kHigh:
      return f(std::integral_constant<int, kHigh>{});
    case kDefault:
      return f(std::integral_constant<int, kDefault>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// f(precision constant, std::bool_constant<DEFER>{}) for the runtime
// precision and deferred-norm flag of a C entry.
template <typename F>
cudaError_t dispatch(int precision, bool defer, F&& f) {
  return dispatch_precision(precision, [&](auto p) {
    return defer ? f(p, std::true_type{}) : f(p, std::false_type{});
  });
}

// f(std::true_type{}) or f(std::false_type{}) for a runtime flag of a C
// entry.
template <typename F>
cudaError_t dispatch_bool(bool flag, F&& f) {
  return flag ? f(std::true_type{}) : f(std::false_type{});
}

// f(std::integral_constant<int, G>{}) for the columns a CTA of a C entry
// (1, 2, 4 or 8); any other count is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch_cols(int G, F&& f) {
  switch (G) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// Launch `kernel` on `grid` CTAs of `threads` with `smem` bytes of dynamic
// shared memory (opted in past the 48 KB default); returns the launch error.
template <typename... Params, typename... Args>
cudaError_t launch_smem(void (*kernel)(Params...), dim3 grid, int threads,
                        size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace amt
