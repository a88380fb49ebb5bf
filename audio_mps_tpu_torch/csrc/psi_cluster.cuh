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
// state into the buffer of every CTA of the cluster (st.shared::cluster),
// and one cluster barrier a step makes them visible. A cluster carries G
// columns (1, 2 or 4) side by side: every constant word a thread reads
// feeds G FMAs.
//
// One step of the forward (DEFER: the deferred norm; s = se[k]):
//   y = Ab t + s (Bb t); e = 2 y . (Rb y); n2 = |y|^2
//   t' = y (inside a deferred block) or y rsqrt(max(n2, eps)) (a renorm)
// A step's walk of a deferred block's inside also forms Rb t = Rb y_{k-1},
// the previous step's expectation, so a step is one walk and one cluster
// barrier; a renorm step (every unroll-th, every step without DEFER) adds a
// phase: an Rb walk of its own y, the CTAs' totals of |y|^2, t' formed and
// pushed, and a second barrier. The loss is taken by lanes c < G of warp 0
// of CTA 0 from the steps' sums as they arrive, the flush of psi_fwd.cuh.
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
// What bounds it: shared-memory reads into registers. A thread walks n / 4
// j a product and per j reads one packed word a constant (32 consecutive
// words a warp) and G prepped state values (a broadcast); at D=128, C=4,
// G=4, 8 warps a CTA, the walk of three products is ~0.6 us of one SM's
// shared-memory pipe, plus a cluster barrier a step. The card's bound for
// the forward at D=128, B=128, T=16384 is 12.31 ms (3 products).
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
  __host__ __device__ ClLayout(int D, int C_) {
    n = 2 * D;
    C = C_ < 1 ? 1 : C_;
    nr = 8 * ((n + 8 * C - 1) / (8 * C));
    ne = n / 4;
    na = n / 8;
    threads = 4 * nr;
    slab = n * nr;
  }
};

// Does the layout take D and C at all (D % 4 == 0 up to kClMaxD; a CTA of
// at most kClThreads threads; C a power of 2 up to kClMaxCluster)?
__host__ __device__ inline bool cl_ok(int D, int C) {
  const bool pow2 = C >= 1 && C <= kClMaxCluster && (C & (C - 1)) == 0;
  return D >= 4 && D % 4 == 0 && D <= kClMaxD && pow2 &&
         ClLayout(D, C).threads <= kClThreads;
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

// x into G consecutive floats at p's offset in cluster CTA `cta`.
template <int G>
__device__ __forceinline__ void st_cluster_g(float* p, uint32_t cta,
                                             const float (&x)[G]) {
  if constexpr (G == 4) {
    st_cluster4(p, cta, x[0], x[1], x[2], x[3]);
  } else if constexpr (G == 2) {
    st_cluster2(p, cta, x[0], x[1]);
  } else {
    st_cluster(p, cta, x[0]);
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
// (hi at vb, lo at vb + n G) of every CTA of the cluster: the four lanes of
// the row (all hold x) take CTAs q, q + 4, ...
template <int P, int G>
__device__ __forceinline__ void cl_push_vec(float* vb, const float (&x)[G],
                                            const ClLayout& L,
                                            const ClThread& th) {
  if (!th.active) return;
  float h[G], l[G];
#pragma unroll
  for (int c = 0; c < G; ++c) prep_parts<P>(x[c], h[c], l[c]);
  float* dh = vb + th.i * G;
  float* dl = vb + L.n * G + th.i * G;
  for (int cta = th.q; cta < L.C; cta += 4) {
    st_cluster_g<G>(dh, cta, h);
    if (P == kHigh) st_cluster_g<G>(dl, cta, l);
  }
}

// The atom's sums of x (held by the rows' owners; every lane must call)
// into slot `slot` of ring [kClSlots][na][G] of every CTA of the cluster:
// row_sum8 leaves each sum on the lanes q = 0, and lane 4 m takes CTAs m,
// m + 8.
template <int G>
__device__ __forceinline__ void cl_push_atoms(float* ring, int slot,
                                              const float (&x)[G],
                                              const ClLayout& L,
                                              const ClThread& th) {
  float v[G];
#pragma unroll
  for (int c = 0; c < G; ++c) v[c] = row_sum8(th.owner ? x[c] : 0.f);
  if (th.q != 0 || th.atom >= L.na) return;
  float* dst = ring + (static_cast<size_t>(slot) * L.na + th.atom) * G;
  for (int cta = th.lane >> 2; cta < L.C; cta += 8)
    st_cluster_g<G>(dst, cta, v);
}

// Column c's total of slot `slot` of an atoms' ring: the atoms' sums added
// in index order from atom 0.
template <int G>
__device__ __forceinline__ float cl_total(const float* ring, int slot, int c,
                                          const ClLayout& L) {
  const float* p = ring + static_cast<size_t>(slot) * L.na * G + c;
  float r = p[0];
  for (int a = 1; a < L.na; ++a) r += p[a * G];
  return r;
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

  cl_load_slab<P, false>(ma, ab, L, rank * L.nr);
  cl_load_slab<P, false>(mb, bb, L, rank * L.nr);
  if (kExp) cl_load_slab<P, false>(mr, rb, L, rank * L.nr);
  for (int idx = threadIdx.x; idx < static_cast<int>(cl_state_words(L, G));
       idx += blockDim.x)
    vec[idx] = 0.f;
  cluster_sync();   // every CTA's buffers are zero before any push

  const size_t stride = static_cast<size_t>(B);
  // offsets in size_t: n_steps * 2D * B of the stream may pass 2^31
  const size_t plane = static_cast<size_t>(L.n) * B;
  const int cl = blockIdx.x / C;
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
  const bool lossl = rank == 0 && th.warp == 0 && th.lane < G;
  const int lc = th.lane < G ? th.lane : 0;   // a loss lane's column

  const int k_lo = MODE == kRecompute ? blockIdx.y * span : 0;
  const int k_hi = MODE == kRecompute ? min(k_lo + span, n_steps) : n_steps;
  const float* tin = MODE == kRecompute ? t0 + (k_lo / unroll) * plane : t0;

  float t[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    t[c] = (th.active && live[c]) ? tin[at_i[c]] : 0.f;
    if (kCk && wr && live[c] && k_lo < k_hi) ck[at_i[c]] = t[c];
  }
  cl_push_vec<P, G>(vec, t, L, th);
  cluster_sync();

  // the loss lanes' state: the next step to take, the loss, |y_{k-1}|^2
  int lp = k_lo;
  float acc = 0.f, n2prev = 1.f;
  // take step m: its |y|^2 total (n2s), and with kExp its loss term
  auto take = [&](int m) {
    if (!lossl) return;
    const float n2 = cl_total<G>(n2a, m % kClSlots, lc, L);
    if (kRows && live[lc]) n2s[m * stride + col[lc]] = n2;
    if (kExp) {
      float x = 2.f * cl_total<G>(eha, m % kClSlots, lc, L);
      if (DEFER) {
        const float n2p = m % unroll == 0 ? 1.f : n2prev;
        x = x / floor_at(n2p, norm_eps);
      }
      const float s = live[lc] ? se[m * stride + col[lc]] : 0.f;
      acc -= logf(floor_at(fmaf(x, s, 1.f), log_eps));
    }
    n2prev = n2;
  };

  int cur = 0;          // the parity of the vector the next walk reads
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
    const float* vh = vec + cur * vw;
    float a[G], b[G], y[G];
    if constexpr (kExp && DEFER) {
      if (fused) {
        float o[3][G];
        const uint32_t* const mm[3] = {ma, mb, mr};
        cl_walk<P, 3, G>(mm, vh, vh + L.n * G, L, th, o);
        float x[G];
#pragma unroll
        for (int c = 0; c < G; ++c) {
          a[c] = o[0][c];
          b[c] = o[1][c];
          x[c] = __fmul_rn(yprev[c], o[2][c]);
        }
        cl_push_atoms<G>(eha, (k - 1) % kClSlots, x, L, th);
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
      if (kRows && wr && live[c]) ys[k * plane + at_i[c]] = y[c];
      yprev[c] = y[c];
    }
    cl_push_atoms<G>(n2a, k % kClSlots, sq, L, th);
    cl_push_vec<P, G>(vec + (cur ^ 1) * vw, y, L, th);
    cluster_sync();
    cur ^= 1;
    if (kExp) {
      while (lp < k) take(lp++);   // a fused step's expectation arrived
    } else {
      take(lp++);
    }

    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    const bool last = k + 1 == k_hi;
    if ((kExp && last) || (renorm && !last)) {
      if (kExp) {
        float o[1][G];
        const uint32_t* const mm[1] = {mr};
        const float* vy = vec + cur * vw;   // y_k's prepped parts
        cl_walk<P, 1, G>(mm, vy, vy + L.n * G, L, th, o);
        float x[G];
#pragma unroll
        for (int c = 0; c < G; ++c) x[c] = __fmul_rn(y[c], o[0][c]);
        cl_push_atoms<G>(eha, k % kClSlots, x, L, th);
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
        cl_push_vec<P, G>(vec + (cur ^ 1) * vw, tn, L, th);
      }
      cluster_sync();
      if (renorm && !last) cur ^= 1;
      if (kExp) take(lp++);
      fused = false;
    } else {
      fused = kExp && DEFER;
    }
  }
  if (kExp && lossl && live[lc]) loss[col[lc]] = acc;
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
  if (unroll < 1 || span < unroll || span % unroll || !cl_ok(D, C) ||
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
                            L.threads, C, false, smem, stream, ab, bb, rb,
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
