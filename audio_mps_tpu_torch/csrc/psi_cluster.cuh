// psi's block kernels past one SM's constants: the cluster layout of the
// forward chain (the NLL psi_cluster_fwd.cu kNll, the training forward with
// the state stream kStream or the block checkpoints kCkpt, and the segment
// recompute kRecompute), of the adjoint chain (psi_cluster_bwd.cu) and of
// the sampler (psi_cluster_sample.cu). The quad layout (psi_fwd.cuh) keeps
// D <= 68; this layout takes every D % 4 == 0 up to 256.
//
// At D=128, Ab and Bb are 2 x (256 x 256) fp32 = 512 KB and Rb 256 KB more:
// no CTA holds them in its registers or its 227 KB of shared memory. Here
// a column's (an example's, a chain's) state rows are spread over a
// thread-block cluster of C CTAs: CTA r holds rows r nr .. r nr + nr - 1 of
// every constant it walks (nr = n / C rounded up to 8 rows, n = 2D), in
// shared memory, packed for the precision, as
//   w[(e nr + il) 4 + q] = M[r nr + il][4 e + q]     (M^T's rows: the adjoint)
// so that the four threads of a row (quarter q takes j = q, q + 4, ...) and
// the 8 rows of a warp read 32 consecutive words. Each CTA forms its rows of
// a step's products against the whole prepped state, which every CTA holds
// in its own shared memory: after its walk a CTA pushes its rows of the new
// state into the buffer of every CTA of the cluster. A cluster carries G
// columns (1, 2 or 4) side by side: every constant word a thread reads
// feeds G FMAs.
//
// The exchange (ClExchange) is point to point: the pushes are st.async,
// each completing its bytes on an mbarrier of the receiving CTA, and each
// CTA waits on its own mbarrier for the phase's bytes. There is no cluster
// barrier a step, whose release also waited for the step's stores of ys
// and loads of se to reach L2. The loss is taken by a warp of its own on
// CTA 0 (cl_loss_warp), off the walks' warps; its arrival gates CTA 0's
// phases, so no ring slot it reads is overwritten before it is done. The
// forward takes only the layouts whose CTA has room for it past the rows
// (cl_fwd_ok: every layout whose slabs fit the card's shared memory). The
// adjoint's ds sums are taken by lanes c < G of warp 0 of CTA 0
// (psi_cluster_bwd.cu), ds0 read a step ahead.
// tools/psi_cluster_attribution.py splits a step into the walk, the
// exchange and the take.
//
// One step of the forward (DEFER: the deferred norm; s = se[k]):
//   y = Ab t + s (Bb t); e = 2 y . (Rb y); n2 = |y|^2
//   t' = y (inside a deferred block) or y rsqrt(max(n2, eps)) (a renorm)
// A step's walk of a deferred block's inside also forms Rb t = Rb y_{k-1},
// the previous step's expectation, so a step is one walk and one phase; a
// renorm step (every unroll-th, every step without DEFER) adds a phase: an
// Rb walk of its own y, the totals of |y|^2, t' formed and pushed.
//
// Bits. Every output is the same bits at every C and every G, as the
// cluster kernels of rho are (rho_cluster.cuh):
//   - a product's row i is the fmaf chain of each quarter over its j in
//     order (three chains at kHigh, added (hi hi + hi lo) + lo hi), the
//     quarters added (p0 + p1) + (p2 + p3) by two shuffles (psi_fwd.cuh's
//     quad_sum): a function of D alone;
//   - a sum over the rows (|y|^2, y . Rb y, the adjoint's dinv and ds) is
//     taken over atoms of 8 rows (row_sum8's tree), and the atoms' sums are
//     added in index order from atom 0: every CTA of a cluster owns whole
//     atoms and pushes its atoms' sums to every CTA, so each reader adds the
//     same values in the same order whatever C is;
//   - a column's arithmetic does not depend on the columns beside it, and
//     every product that meets a sum is written out (fmaf where it fuses,
//     __fmul_rn / __fadd_rn where it does not), so no instantiation of G
//     leaves the compiler a contraction of its own to choose.
// The NLL's loss is the training forward's bit for bit (one template), and
// from the kCkpt forward's checkpoints the kRecompute mode's ys and n2s are
// the kStream forward's (every block restarts from its checkpoint, which
// is the state the forward computed there).
//
// What bounds it: shared-memory reads into registers, then the exchange's
// latency. A thread walks n / 4 j a product and per j reads one packed
// word a constant (32 consecutive words a warp) and G prepped state values
// (four addresses a warp): 7 words a lane a j into registers for 12 FMAs
// at G=4, so at D=128, C=4, 8 warps a CTA, the walk of three products is
// ~3600 cycles (~2 us) of one SM's shared-memory pipe at full rate, and
// the phase's round trip follows it. The card's bound for the forward at
// D=128, B=128, T=16384 is 12.31 ms (3 products).
#pragma once

#include "psi_fwd.cuh"

namespace amt {

constexpr int kClThreads = 512;   // the most threads a CTA (nr <= 128)
constexpr int kClSlots = 4;       // steps whose atoms' sums wait in a ring
constexpr int kClMaxD = 256;      // the widest D the layout takes
constexpr int kClMaxCluster = 16;

// The sizes of the cluster layout at bond dimension D and cluster C.
struct ClLayout {
  int n;        // state rows, 2D
  int C;        // CTAs a cluster
  int nr;       // rows a CTA: n / C rounded up to whole atoms of 8
  int ne;       // j a quarter: n / 4
  int na;       // atoms of the state: n / 8
  int threads;  // 4 nr
  int slab;     // words of one constant's slab: n nr
  int cw;       // CTAs that hold rows: ceil(n / nr) (the rest idle)
  __host__ __device__ ClLayout(int D, int C_) {
    n = 2 * D;
    C = C_ < 1 ? 1 : C_;
    nr = 8 * ((n + 8 * C - 1) / (8 * C));
    ne = n / 4;
    na = n / 8;
    threads = 4 * nr;
    slab = n * nr;
    cw = (n + nr - 1) / nr;
  }
};

// Does the layout take D and C at all (D % 4 == 0 up to kClMaxD; a CTA of
// at most kClThreads threads; C a power of 2 up to kClMaxCluster)?
__host__ __device__ inline bool cl_ok(int D, int C) {
  const bool pow2 = C >= 1 && C <= kClMaxCluster && (C & (C - 1)) == 0;
  return D >= 4 && D % 4 == 0 && D <= kClMaxD && pow2 &&
         ClLayout(D, C).threads <= kClThreads;
}

// Does the forward take D and C: cl_ok, and room in the CTA for the loss
// warp past the rows (the only layout without it whose slabs fit 227 KB is
// D=64 at C=1, which the quad layout runs).
__host__ __device__ inline bool cl_fwd_ok(int D, int C) {
  return cl_ok(D, C) && ClLayout(D, C).threads + 32 <= kClThreads;
}

// Words of a CTA's state buffers: two parities of the prepped vector (hi,
// lo) of G columns, [2][2][n][G], and the atoms' rings of two sums,
// [2][kClSlots][na][G].
__host__ __device__ inline size_t cl_state_words(const ClLayout& L, int G) {
  return 4 * static_cast<size_t>(L.n) * G +
         2 * static_cast<size_t>(kClSlots) * L.na * G;
}

// Dynamic shared memory of one forward CTA (every mode): Ab, Bb and Rb's
// slabs and the state buffers (ops/cluster.py psi_cluster_fwd_smem_bytes
// mirrors it).
__host__ __device__ inline size_t cl_fwd_smem_bytes(int D, int C, int G) {
  const ClLayout L(D, C);
  return 4 * (3 * static_cast<size_t>(L.slab) + cl_state_words(L, G));
}

// Dynamic shared memory of one adjoint-chain CTA: Ab^T and Bb^T's slabs and
// the state buffers.
__host__ __device__ inline size_t cl_chain_smem_bytes(int D, int C, int G) {
  const ClLayout L(D, C);
  return 4 * (2 * static_cast<size_t>(L.slab) + cl_state_words(L, G));
}

// The thread's place: row i = r0 + il of quarter q (lane 4 (il mod 8) + q
// of warp il / 8), its warp's atom, and whether the row is real.
struct ClThread {
  int warp, lane, q, il, i, atom;
  bool active;  // row i < n
  bool owner;   // active and q == 0: writes the row's outputs
  __device__ ClThread(const ClLayout& L, int rank) {
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    q = lane & 3;
    il = 8 * warp + (lane >> 2);
    i = rank * L.nr + il;
    atom = (rank * L.nr) / 8 + warp;
    active = i < L.n;
    owner = active && q == 0;
  }
};

// G consecutive floats at p (16-, 8- or 4-byte aligned) into x.
template <int G>
__device__ __forceinline__ void ld_g(const float* p, float (&x)[G]) {
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

// x into G consecutive floats at p's offset in cluster CTA `cta`, by
// st.async completing on the mbarrier at bar's offset there.
template <int G>
__device__ __forceinline__ void st_async_g(float* p, uint32_t cta,
                                           const float (&x)[G],
                                           uint64_t* bar) {
  if constexpr (G == 4) {
    st_async4(p, cta, x[0], x[1], x[2], x[3], bar);
  } else if constexpr (G == 2) {
    st_async2(p, cta, x[0], x[1], bar);
  } else {
    st_async(p, cta, x[0], bar);
  }
}

// The prepped parts of x for precision P (store_vec's values).
template <int P>
__device__ __forceinline__ void prep_parts(float x, float& h, float& l) {
  if (P == kHigh) {
    split_bf16(x, h, l);
  } else if (P == kDefault) {
    h = bf16_round(x);
    l = 0.f;
  } else {
    h = x;
    l = 0.f;
  }
}

// Load the CTA's slab of the row-major [n,n] matrix m (TRANS: of m^T) into
// w, packed for P: w[(e nr + il) 4 + q] = M[r0 + il][4 e + q], zeros past n.
template <int P, bool TRANS>
__device__ void cl_load_slab(uint32_t* w, const float* __restrict__ m,
                             const ClLayout& L, int r0) {
  const int words = L.slab;
  for (int idx = threadIdx.x; idx < words; idx += blockDim.x) {
    const int q = idx & 3;
    const int rest = idx >> 2;
    const int il = rest % L.nr, e = rest / L.nr;
    const int i = r0 + il, j = 4 * e + q;
    w[idx] = i < L.n ? pack_elem<P>(TRANS ? m[static_cast<size_t>(j) * L.n +
                                               i]
                                          : m[static_cast<size_t>(i) * L.n +
                                              j])
                     : 0u;
  }
}

// out[m][c] = (M_m v_c)_i for the thread's row i and NM slabs ms[m]: over
// j = q, q + 4, ... in order one fmaf chain a quarter (three at kHigh),
// the quarters added by quad_sum on every lane of the row. vh (vl: the kHigh
// lo parts) holds the prepped vectors as [n][G].
template <int P, int NM, int G>
__device__ __forceinline__ void cl_walk(const uint32_t* const (&ms)[NM],
                                        const float* vh, const float* vl,
                                        const ClLayout& L, const ClThread& th,
                                        float (&out)[NM][G]) {
  float acc[NM][G][3];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int c = 0; c < G; ++c)
      acc[m][c][0] = acc[m][c][1] = acc[m][c][2] = 0.f;
  const int mo = th.il * 4 + th.q;
  const int ms_step = L.nr * 4;
#pragma unroll 4
  for (int e = 0; e < L.ne; ++e) {
    const int j = 4 * e + th.q;
    float h[G], l[G];
    ld_g<G>(vh + j * G, h);
    if (P == kHigh) {
      ld_g<G>(vl + j * G, l);
    } else {
#pragma unroll
      for (int c = 0; c < G; ++c) l[c] = h[c];
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const uint32_t w = ms[m][e * ms_step + mo];
#pragma unroll
      for (int c = 0; c < G; ++c) quad_fma<P>(w, h[c], l[c], acc[m][c]);
    }
  }
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int c = 0; c < G; ++c) out[m][c] = quad_sum<P>(acc[m][c]);
}

// Push the prepped parts of the thread's row of x into vector buffer vb
// (hi at vb, lo at vb + n G) of every CTA of the cluster, completing on the
// mbarrier at bar's offset there: the four lanes of the row (all hold x)
// take CTAs q, q + 4, ...
template <int P, int G>
__device__ __forceinline__ void cl_push_vec(float* vb, const float (&x)[G],
                                            const ClLayout& L,
                                            const ClThread& th,
                                            uint64_t* bar) {
  if (!th.active) return;
  float h[G], l[G];
#pragma unroll
  for (int c = 0; c < G; ++c) prep_parts<P>(x[c], h[c], l[c]);
  float* dh = vb + th.i * G;
  float* dl = vb + L.n * G + th.i * G;
  for (int cta = th.q; cta < L.cw; cta += 4) {
    st_async_g<G>(dh, cta, h, bar);
    if (P == kHigh) st_async_g<G>(dl, cta, l, bar);
  }
}

// The atom's sums of x (held by the rows' owners; every lane must call)
// into slot `slot` of ring [kClSlots][na][G] of every CTA of the cluster,
// completing on the mbarrier at bar's offset there: row_sum8 leaves each
// sum on the lanes q = 0, and lane 4 m takes CTAs m, m + 8.
template <int G>
__device__ __forceinline__ void cl_push_atoms(float* ring, int slot,
                                              const float (&x)[G],
                                              const ClLayout& L,
                                              const ClThread& th,
                                              uint64_t* bar) {
  float v[G];
#pragma unroll
  for (int c = 0; c < G; ++c) v[c] = row_sum8(th.owner ? x[c] : 0.f);
  if (th.q != 0 || th.atom >= L.na) return;
  float* dst = ring + (static_cast<size_t>(slot) * L.na + th.atom) * G;
  for (int cta = th.lane >> 2; cta < L.cw; cta += 8)
    st_async_g<G>(dst, cta, v, bar);
}

// Bytes a CTA receives of one push of a state vector (every row, from its
// owner: hi, and lo at kHigh) and of one push of an atoms' ring.
template <int P, int G>
__device__ __forceinline__ uint32_t cl_vec_bytes(const ClLayout& L) {
  return 4u * L.n * G * (P == kHigh ? 2u : 1u);
}

template <int G>
__device__ __forceinline__ uint32_t cl_atom_bytes(const ClLayout& L) {
  return 4u * L.na * G;
}

// Column c's total of slot `slot` of an atoms' ring: the atoms' sums added
// in index order from atom 0 (the loads unrolled ahead of the adds).
template <int G>
__device__ __forceinline__ float cl_total(const float* ring, int slot, int c,
                                          const ClLayout& L) {
  const float* p = ring + static_cast<size_t>(slot) * L.na * G + c;
  float r = p[0];
#pragma unroll 8
  for (int a = 1; a < L.na; ++a) r += p[a * G];
  return r;
}

// The exchange of a step, point to point (see the note above). The CTAs
// that hold rows (L.cw; the others idle) each push their part of phase ph
// (rows of a state vector, atoms' sums: every such CTA sends to every such
// CTA in every phase) into the buffers of parity ph & 1 of every such CTA
// by st.async, completing on that CTA's mbarrier full[ph & 1]; then each
// waits on its own full[ph & 1] for the whole phase. No cluster barrier and
// no fence a step: the receiver's wait orders the data. Why no buffer is
// overwritten before its readers are done: a CTA reads the data of phase
// ph only between its wait for ph and its push of ph + 1, and another CTA
// writes the buffers of parity ph & 1 again only in phase ph + 2, which it
// pushes after its wait for ph + 1, which needs this CTA's push of ph + 1.
// So no CTA's bytes of ph + 2 reach an mbarrier before its phase ph
// completed either; each CTA arms full[ph & 1] (thread 0's arrival with
// the phase's bytes) when it pushes ph, after its wait for ph - 1 (bytes
// that arrive before the arming leave the count negative until it); on
// CTA 0 the phase also waits for the loss warp's arrival (cl_loss_warp).
// The atoms' rings hold kClSlots steps; a reader takes a step at most two
// behind the newest a writer can push.
struct ClExchange {
  uint64_t* full;   // [2] (static shared memory)
  uint32_t ph;      // the phase this CTA pushes, then waits for
  __device__ int parity() const { return static_cast<int>(ph & 1); }
  __device__ uint64_t* bar() const { return full + (ph & 1); }
};

__device__ __forceinline__ ClExchange cl_exchange_init(uint64_t* full,
                                                       int arrivals) {
  if (threadIdx.x == 0) {
    mbar_init(full, arrivals);
    mbar_init(full + 1, arrivals);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return ClExchange{full, 0u};
}

// This CTA's pushes of the phase are issued: arm its mbarrier for the
// phase's `bytes` from the cluster.
__device__ __forceinline__ void cl_exchange_done(const ClExchange& ex,
                                                 uint32_t bytes) {
  if (threadIdx.x == 0) mbar_arrive_expect_tx(ex.bar(), bytes);
}

// Wait for the whole phase, then move to the next.
__device__ __forceinline__ void cl_exchange_wait(ClExchange& ex) {
  mbar_wait_cluster(ex.bar(), (ex.ph >> 1) & 1);
  ++ex.ph;
}

// The loss lane's take of step m (lane lc of the loss warp of CTA 0;
// column col): its |y|^2 total
// (n2s) and with EXP its loss term, in step order; n2prev is |y_{m-1}|^2.
template <int G, bool DEFER, bool EXP, bool ROWS>
__device__ __forceinline__ void cl_take_loss(
    int m, const float* n2a, const float* eha, const float* se, int lc,
    int col, bool live, const ClLayout& L, int unroll, float log_eps,
    float norm_eps, float* n2s, size_t stride, float& acc, float& n2prev) {
  const float n2 = cl_total<G>(n2a, m % kClSlots, lc, L);
  if (ROWS && live) n2s[m * stride + col] = n2;
  if (EXP) {
    float x = 2.f * cl_total<G>(eha, m % kClSlots, lc, L);
    if (DEFER) {
      const float n2p = m % unroll == 0 ? 1.f : n2prev;
      x = x / floor_at(n2p, norm_eps);
    }
    const float s = live ? se[m * stride + col] : 0.f;
    acc -= logf(floor_at(fmaf(x, s, 1.f), log_eps));
  }
  n2prev = n2;
}

// The loss warp of CTA 0: it follows the forward's phases (phase 0,
// then each step's and each renorm or last step's second), taking every
// step whose atoms have arrived, and then arrives on its CTA's mbarrier of
// the phase before it waits for it: the CTA's phase does not complete
// before the warp is done with the steps whose ring slots the phase after
// next overwrites, so the takes leave the walks' warps alone.
template <int G, bool DEFER, int MODE>
__device__ void cl_loss_warp(ClExchange& ex, const float* n2a,
                             const float* eha, const float* se, float* n2s,
                             float* loss, const ClLayout& L, int cl, int B,
                             int k_lo, int k_hi, int unroll, float log_eps,
                             float norm_eps) {
  constexpr bool kExp = MODE != kRecompute;
  constexpr bool kRows = MODE == kStream || MODE == kRecompute;
  const int lane = threadIdx.x & 31;
  const int lc = lane < G ? lane : 0;
  const int col = cl * G + lc;
  const bool live = col < B;
  const size_t stride = static_cast<size_t>(B);
  int lp = k_lo, n2_done = k_lo - 1, eh_done = k_lo - 1;
  float acc = 0.f, n2prev = 1.f;
  auto phase = [&]() {
    if (lane < G)
      for (; lp <= n2_done && (!kExp || lp <= eh_done); ++lp)
        cl_take_loss<G, DEFER, kExp, kRows>(
            lp, n2a, eha, se, lc, col, live, L, unroll, log_eps, norm_eps,
            n2s, stride, acc, n2prev);
    __syncwarp();
    if (lane == 0) mbar_arrive(ex.bar());
    cl_exchange_wait(ex);
  };
  phase();   // the input state
  bool fused = false;
  for (int k = k_lo; k < k_hi; ++k) {
    phase();
    n2_done = k;
    if (kExp && DEFER && fused) eh_done = k - 1;
    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    const bool last = k + 1 == k_hi;
    if ((kExp && last) || (renorm && !last)) {
      phase();
      if (kExp) eh_done = k;
      fused = false;
    } else {
      fused = kExp && DEFER;
    }
  }
  if (lane < G)
    for (; lp < k_hi; ++lp)
      cl_take_loss<G, DEFER, kExp, kRows>(lp, n2a, eha, se, lc, col, live, L,
                                          unroll, log_eps, norm_eps, n2s,
                                          stride, acc, n2prev);
  if (kExp && lane < G && live) loss[col] = acc;
}

// The forward chain (see the note above). Grid: clusters of C CTAs along x,
// one cluster a group of G columns; kRecompute: y = the spans of a segment,
// t0 its checkpoints, span steps (whole blocks) a span.
template <int P, bool DEFER, int MODE, int G>
__global__ void __launch_bounds__(kClThreads, 1)
    psi_cl_fwd_kernel(const float* __restrict__ ab,
                      const float* __restrict__ bb,
                      const float* __restrict__ rb,
                      const float* __restrict__ t0,
                      const float* __restrict__ se, float* __restrict__ loss,
                      float* __restrict__ ys, float* __restrict__ n2s,
                      float* __restrict__ ck, int D, int n_steps, int B,
                      int unroll, int span, int C, float log_eps,
                      float norm_eps) {
  constexpr bool kExp = MODE != kRecompute;   // the loss and its Rb y
  constexpr bool kRows = MODE == kStream || MODE == kRecompute;
  constexpr bool kCk = MODE == kCkpt;
  extern __shared__ __align__(16) float4 smem4[];
  __shared__ uint64_t full[2];
  const ClLayout L(D, C);
  const int rank = static_cast<int>(cluster_rank());
  const ClThread th(L, rank);
  uint32_t* ma = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* mb = ma + L.slab;
  uint32_t* mr = mb + L.slab;
  float* vec = reinterpret_cast<float*>(mr + L.slab);   // [2][hi, lo][n][G]
  const int vw = 2 * L.n * G;                           // one parity
  float* n2a = vec + 2 * vw;                            // [slots][na][G]
  float* eha = n2a + kClSlots * L.na * G;

  // CTA 0's phases also wait for its loss warp's arrival
  ClExchange ex = cl_exchange_init(full, rank == 0 ? 2 : 1);
  cl_load_slab<P, false>(ma, ab, L, rank * L.nr);
  cl_load_slab<P, false>(mb, bb, L, rank * L.nr);
  if (kExp) cl_load_slab<P, false>(mr, rb, L, rank * L.nr);
  for (int idx = threadIdx.x; idx < static_cast<int>(cl_state_words(L, G));
       idx += blockDim.x)
    vec[idx] = 0.f;
  cluster_sync();   // every CTA's buffers and mbarriers set before any push
  if (rank >= L.cw) {   // no rows: nothing to push or wait for
    cluster_sync();
    return;
  }

  const int cl = blockIdx.x / C;
  const int k_lo = MODE == kRecompute ? blockIdx.y * span : 0;
  const int k_hi = MODE == kRecompute ? min(k_lo + span, n_steps) : n_steps;
  if (th.warp >= L.nr / 8) {   // the loss warp (idle past CTA 0)
    if (rank == 0)
      cl_loss_warp<G, DEFER, MODE>(ex, n2a, eha, se, n2s, loss, L, cl, B,
                                   k_lo, k_hi, unroll, log_eps, norm_eps);
    cluster_sync();
    return;
  }
  const size_t stride = static_cast<size_t>(B);
  // offsets in size_t: n_steps * 2D * B of the stream may pass 2^31
  const size_t plane = static_cast<size_t>(L.n) * B;
  int col[G];
  bool live[G];
  size_t at_i[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    col[c] = cl * G + c;
    live[c] = col[c] < B;
    at_i[c] = static_cast<size_t>(th.active ? th.i : 0) * stride +
              (live[c] ? col[c] : 0);
  }
  const bool wr = th.owner;   // this lane writes its row's outputs
  const uint32_t vbytes = cl_vec_bytes<P, G>(L);
  const uint32_t abytes = cl_atom_bytes<G>(L);

  const float* tin = MODE == kRecompute ? t0 + (k_lo / unroll) * plane : t0;

  float t[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    t[c] = (th.active && live[c]) ? tin[at_i[c]] : 0.f;
    if (kCk && wr && live[c] && k_lo < k_hi) ck[at_i[c]] = t[c];
  }
  cl_push_vec<P, G>(vec + ex.parity() * vw, t, L, th, ex.bar());
  cl_exchange_done(ex, vbytes);
  int vcur = ex.parity();   // the parity of the vector the next walk reads
  cl_exchange_wait(ex);

  bool fused = false;   // the walk also forms Rb y_{k-1} (t_k = y_{k-1})
  float yprev[G];
#pragma unroll
  for (int c = 0; c < G; ++c) yprev[c] = 0.f;
  float snext[G];
#pragma unroll
  for (int c = 0; c < G; ++c)
    snext[c] = (live[c] && k_lo < k_hi) ? se[k_lo * stride + col[c]] : 0.f;

  for (int k = k_lo; k < k_hi; ++k) {
    float s[G];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      s[c] = snext[c];
      snext[c] = (live[c] && k + 1 < k_hi) ? se[(k + 1) * stride + col[c]]
                                           : 0.f;
    }
    const float* vh = vec + vcur * vw;
    float a[G], b[G], y[G], xe[G];
    if constexpr (kExp && DEFER) {
      if (fused) {
        float o[3][G];
        const uint32_t* const mm[3] = {ma, mb, mr};
        cl_walk<P, 3, G>(mm, vh, vh + L.n * G, L, th, o);
#pragma unroll
        for (int c = 0; c < G; ++c) {
          a[c] = o[0][c];
          b[c] = o[1][c];
          xe[c] = __fmul_rn(yprev[c], o[2][c]);
        }
      }
    }
    if (!(kExp && DEFER && fused)) {
      float o[2][G];
      const uint32_t* const mm[2] = {ma, mb};
      cl_walk<P, 2, G>(mm, vh, vh + L.n * G, L, th, o);
#pragma unroll
      for (int c = 0; c < G; ++c) {
        a[c] = o[0][c];
        b[c] = o[1][c];
      }
    }
    float sq[G];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      y[c] = fmaf(s[c], b[c], a[c]);
      sq[c] = __fmul_rn(y[c], y[c]);
      yprev[c] = y[c];
    }
    // the step's phase: y_k, its |y|^2 atoms and, fused, step k-1's
    // expectation atoms
    if (kExp && DEFER && fused)
      cl_push_atoms<G>(eha, (k - 1) % kClSlots, xe, L, th, ex.bar());
    cl_push_atoms<G>(n2a, k % kClSlots, sq, L, th, ex.bar());
    cl_push_vec<P, G>(vec + ex.parity() * vw, y, L, th, ex.bar());
    cl_exchange_done(ex, vbytes + (kExp && DEFER && fused ? 2 : 1) * abytes);
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (kRows && wr && live[c]) ys[k * plane + at_i[c]] = y[c];
    vcur = ex.parity();
    cl_exchange_wait(ex);

    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    const bool last = k + 1 == k_hi;
    if ((kExp && last) || (renorm && !last)) {
      // a phase of its own: step k's expectation (an Rb walk of y_k) and,
      // renormalising, the next input state
      uint32_t bytes = 0;
      if (kExp) {
        float o[1][G];
        const uint32_t* const mm[1] = {mr};
        const float* vy = vec + vcur * vw;   // y_k's prepped parts
        cl_walk<P, 1, G>(mm, vy, vy + L.n * G, L, th, o);
        float x[G];
#pragma unroll
        for (int c = 0; c < G; ++c) x[c] = __fmul_rn(y[c], o[0][c]);
        cl_push_atoms<G>(eha, k % kClSlots, x, L, th, ex.bar());
        bytes += abytes;
      }
      if (renorm && !last) {
        const bool exit = (k + 1) % unroll == 0;
        float tn[G];
#pragma unroll
        for (int c = 0; c < G; ++c) {
          if (MODE == kRecompute && exit) {
            tn[c] = (th.active && live[c])
                        ? t0[((k + 1) / unroll) * plane + at_i[c]]
                        : 0.f;
          } else {
            const float n2 = cl_total<G>(n2a, k % kClSlots, c, L);
            tn[c] = __fmul_rn(y[c], rsqrtf(floor_at(n2, norm_eps)));
          }
          if (kCk && exit && wr && live[c])
            ck[((k + 1) / unroll) * plane + at_i[c]] = tn[c];
        }
        cl_push_vec<P, G>(vec + ex.parity() * vw, tn, L, th, ex.bar());
        bytes += vbytes;
      }
      cl_exchange_done(ex, bytes);
      if (renorm && !last) vcur = ex.parity();
      cl_exchange_wait(ex);
      fused = false;
    } else {
      fused = kExp && DEFER;
    }
  }
  cluster_sync();   // no CTA leaves while another may still push to it
}

// Launch the forward for the runtime precision and norm flag: clusters of C
// CTAs, ceil(B / G) of them (with kRecompute, x ceil(n_steps / span) spans
// along y; t0 then holds the segment's checkpoints and span is a whole
// number of blocks). The pointers a MODE does not write may be null.
template <int MODE>
cudaError_t launch_cl_fwd(const float* ab, const float* bb, const float* rb,
                          const float* t0, const float* se, float* loss,
                          float* ys, float* n2s, float* ck, int D,
                          int n_steps, int B, int unroll, int span,
                          float log_eps, float norm_eps, int precision,
                          bool defer, int C, int G, cudaStream_t stream) {
  if (unroll < 1 || span < unroll || span % unroll || !cl_fwd_ok(D, C) ||
      (G != 1 && G != 2 && G != 4))
    return cudaErrorInvalidValue;
  const int clusters = (B + G - 1) / G;
  const dim3 grid(clusters * C,
                  MODE == kRecompute ? (n_steps + span - 1) / span : 1);
  if (clusters == 0 || grid.y == 0) return cudaSuccess;
  const ClLayout L(D, C);
  const size_t smem = cl_fwd_smem_bytes(D, C, G);
  return dispatch(precision, defer, [&](auto p, auto d) {
    constexpr int kP = decltype(p)::value;
    constexpr bool kD = decltype(d)::value;
    const auto go = [&](auto g) {
      constexpr int kG = decltype(g)::value;
      return launch_cluster(psi_cl_fwd_kernel<kP, kD, MODE, kG>, grid,
                            L.threads + 32, C, false, smem,
                            stream, ab, bb, rb,
                            t0, se, loss, ys, n2s, ck, D, n_steps, B, unroll,
                            span, C, log_eps, norm_eps);
    };
    switch (G) {
      case 4:
        return go(std::integral_constant<int, 4>{});
      case 2:
        return go(std::integral_constant<int, 2>{});
      default:
        return go(std::integral_constant<int, 1>{});
    }
  });
}

}  // namespace amt
