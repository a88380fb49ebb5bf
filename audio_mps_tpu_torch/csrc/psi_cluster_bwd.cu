// Adjoint of psi's block training forward in the cluster layout (D % 4 == 0,
// 72 to 256 on the main path) for Hopper: the chain-free tail, then the
// reverse chain over a thread-block cluster.
//
// Replaces, past the quad layout's D <= 68, the serial part and the batched
// tail of the TPU kernels audio_mps_tpu/ops/pallas_block.py
// _make_psi_bwd_kernel_stream (:935) and _make_psi_bwd_kernel (:529), and
// the adjoint of _make_psi_bwd_kernel_defer (:621) a time segment at a time
// (dtfin carried in); psi_train_bwd.cu's functions, with its outputs and its
// dn2 bookkeeping (its header, which has the step's algebra). The three
// [2D,2D] cotangent reductions stay psi_cotangents.cu's.
//
// The tail (psi_cl_tail_kernel) is one [2D,2D] x [2D, (T-1) B] product at
// true fp32 (the bf16 splits at kHigh, kDefault), free of the chain. The
// TPU forms ru = Rb y and Rb^T (2 dehat y) (pallas_block.py :996, :1030)
// with one scalar dehat a lane, so with the symmetric S = Rb + Rb^T, formed
// and packed once a launch by a pre-pass,
//   u = S y; ehat = y . u; (ds0, dehat, dn2_new) from ehat; q = (2 dehat) u
// (the rank partials' tail takes the same form, rank_partials_bwd.cu). It is
// shaped as an SGEMM: a CTA takes a tile of nl (step, column) lanes and all
// 2D rows; the tile's prepped y sits in shared memory [2D][nl]; S goes
// through shared memory in slabs of kClTailKs rows j in order, two in flight
// (cp.async, persistent CTAs over the tiles, so the next tile's first slab
// lands under this tile's epilogue); each thread forms a register tile of 8
// rows x 8 lanes (256 threads a CTA, two CTAs an SM at kHighest), each word
// it reads feeding 8 FMAs: 16 words a 64 FMAs, the rate at which an SM's
// shared-memory reads into registers (32 words a cycle) match its fp32 FMAs
// (128 a cycle). At kHigh, whose three fmaf chains an output take three
// registers, 4 rows x 8 lanes. Each output is one fmaf chain over j in
// order (three at kHigh, added (hi hi + hi lo) + lo hi); ehat is each
// thread's fmaf chain over its rows, the row threads' parts added in
// order; q goes back through shared memory to coalesced stores. The tail
// does not depend on C or G.
//
// The chain (psi_cl_chain_kernel) runs the reverse recursion on the
// cluster layout of psi_cluster.cuh and its point-to-point exchange: CTA r
// of a cluster holds rows r nr .. of Ab^T and Bb^T (its rows of dt), a
// step's dy is pushed to every CTA, one phase, one walk of both slabs; a
// renorm step first pushes its atoms of dinv = dt . y, a phase more. The
// ds sums (Bb^T dy) . t_k ride on the next phase and are added to ds0
// (read a step ahead) by lanes c < G of warp 0 of CTA 0 after their CTA's
// next push.
//
// What bounds them: the tail's (2D)^2 FMAs a lane (4.10 ms of the card's
// fp32 rate at D=128, B=128, T=16384) against shared-memory reads of one
// word per 8 FMAs, at that line, and the parts of a tile that do not
// overlap its products: the tile's y loads (a thread keeps kClTailYDepth
// of them in flight; one at a time they took a fifth of the tail), its
// epilogue and q's stores, hidden only by the SM's other CTA.
// tools/psi_cluster_attribution.py's tail_* variants split it. The chain:
// its walk's shared-memory reads and its exchange a step
// (psi_cluster.cuh).
#include "psi_cluster.cuh"

namespace amt {

constexpr int kClTailKs = 16;       // rows j of S a slab
constexpr int kClTailStages = 2;    // slabs in flight

constexpr int kClTailThreads = 256;
constexpr int kClTailLanes = 8;     // lanes a thread
constexpr int kClTailYDepth = 32;   // loads of y in flight a thread

// Rows a tail thread: 4 at kHigh, whose three fmaf chains an output take
// three registers.
__host__ __device__ constexpr int cl_tail_rows(int P) {
  return P == kHigh ? 4 : 8;
}

// The tail's tile at bond dimension D and precision P (ops/cluster.py
// psi_cluster_tail_plan mirrors it): rows padded to whole slabs (zeros),
// rm rows x rn lanes a thread, rt row threads x lt lane threads (at most
// kClTailThreads), nl = rn lt lanes a tile, at most one a thread.
struct ClTailPlan {
  int n, np, rm, rn, rt, lt, nl;
  __host__ __device__ ClTailPlan(int D, int P) {
    constexpr int nt = kClTailThreads;
    n = 2 * D;
    np = kClTailKs * ((n + kClTailKs - 1) / kClTailKs);
    rm = cl_tail_rows(P);
    rn = kClTailLanes;
    rt = np / rm;
    lt = nt / rt < nt / rn ? nt / rt : nt / rn;
    nl = rn * lt;
  }
  // words of the tile's prepped y (hi, and at kHigh lo)
  __host__ __device__ int y_words(int P) const {
    return (P == kHigh ? 2 : 1) * np * nl;
  }
  // dynamic shared memory: S's slabs, the tile's y, the row threads' parts
  // of ehat [rt][nl], four floats a lane (s, n2p, g, 2 dehat) and a lane's
  // offset into ys (8 bytes)
  __host__ __device__ size_t smem_bytes(int P) const {
    return 4 * (static_cast<size_t>(kClTailStages) * kClTailKs * np +
                y_words(P) + static_cast<size_t>(rt) * nl + 4 * nl) +
           8 * static_cast<size_t>(nl);
  }
};

// The tail's shared memory at D: the most any precision takes.
__host__ __device__ inline size_t cl_tail_smem_bytes(int D) {
  size_t m = 0;
  for (int p = kHighest; p <= kDefault; ++p) {
    const size_t b = ClTailPlan(D, p).smem_bytes(p);
    m = b > m ? b : m;
  }
  return m;
}

// out[j n + i] = S[j][i], S = Rb + Rb^T packed for P (symmetric, so also
// S[i][j]: the tail reads row j of S as the column it multiplies y_j by).
template <int P>
__global__ void psi_cl_pack_kernel(const float* __restrict__ rb,
                                   uint32_t* __restrict__ out, int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
       idx < nn; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t j = idx / n, i = idx - j * n;
    out[idx] = pack_elem<P>(rb[i * n + j] + rb[idx]);
  }
}

// A thread's RN lanes of a row of the tile: fours at p, p + gap, ...
template <int RN>
__device__ __forceinline__ void ld_lanes(const float* p, int gap,
                                         float (&x)[RN]) {
#pragma unroll
  for (int g = 0; g < RN / 4; ++g) {
    const float4 a = *reinterpret_cast<const float4*>(p + g * gap);
    x[4 * g] = a.x;
    x[4 * g + 1] = a.y;
    x[4 * g + 2] = a.z;
    x[4 * g + 3] = a.w;
  }
}

template <int P, bool DEFER>
__global__ void __launch_bounds__(kClTailThreads, P == kHigh ? 1 : 2)
    psi_cl_tail_kernel(const uint32_t* __restrict__ sp,
                       const float* __restrict__ se,
                       const float* __restrict__ g,
                       const float* __restrict__ ys,
                       const float* __restrict__ n2s,
                       float* __restrict__ dse, float* __restrict__ dys,
                       float* __restrict__ dehats, float* __restrict__ dn2ns,
                       int D, int n_steps, int B, int unroll, float log_eps,
                       float norm_eps) {
  constexpr int RM = cl_tail_rows(P);    // rows a thread
  constexpr int RN = kClTailLanes;       // lanes a thread
  constexpr int RG = RM / 4;             // its groups of 4 rows
  constexpr int KS = kClTailKs;
  extern __shared__ __align__(16) float4 smem4[];
  const ClTailPlan pl(D, P);
  const int n = pl.n, np = pl.np, nl = pl.nl;
  uint32_t* ss = reinterpret_cast<uint32_t*>(smem4);   // [stages][KS][np]
  float* yh = reinterpret_cast<float*>(ss + kClTailStages * KS * np);
  float* yl = yh + np * nl;                            // kHigh: lo parts
  float* ep = yh + pl.y_words(P);                      // [rt][nl]
  float* ls = ep + pl.rt * nl;                         // [nl] s
  float* ln2 = ls + nl;                                // the n2 e divides by
  float* lgb = ln2 + nl;                               // g
  float* dh = lgb + nl;                                // 2 dehat
  long long* loff = reinterpret_cast<long long*>(dh + nl);   // -1: no lane
  const int tid = threadIdx.x;
  const bool comp = tid < pl.rt * pl.lt;   // holds a register tile
  const int tm = comp ? tid / pl.lt : 0, tn = comp ? tid - tm * pl.lt : 0;
  const int rstride = 4 * pl.rt;           // rows between a thread's groups
  const int gap = 4 * pl.lt;               // lanes between its fours
  const size_t plane = static_cast<size_t>(n) * B;
  const long long total = static_cast<long long>(n_steps) * B;
  const long long ntiles = (total + nl - 1) / nl;
  const int nslab = np / KS;

  // the stages' columns past n stay zero (the copies write columns < n)
  for (int idx = tid; idx < kClTailStages * KS * (np - n);
       idx += blockDim.x) {
    const int r = idx / (np - n);
    ss[r * np + n + (idx - r * (np - n))] = 0u;
  }
  // slab s of S (rows j = s KS ..; zeros past n) into stage st
  auto issue = [&](int s, int st) {
    uint32_t* dst = ss + st * KS * np;
    const int c4 = n / 4;
    for (int idx = tid; idx < KS * c4; idx += blockDim.x) {
      const int r = idx / c4, c = idx - r * c4;
      const int j = s * KS + r;
      cp16(dst + r * np + 4 * c,
           sp + static_cast<size_t>(j < n ? j : 0) * n + 4 * c,
           j < n ? 16 : 0);
    }
    cp_commit();
  };

  long long tile = blockIdx.x;
  if (tile < ntiles) issue(0, 0);
  int stage = 0;   // the stage of the slab the next iteration reads
  for (; tile < ntiles; tile += gridDim.x) {
    const long long f0 = tile * nl;
    if (tid < nl) {
      const long long f = f0 + tid;
      long long off = -1;
      float s = 0.f, n2p = 1.f, gb = 0.f;
      if (f < total) {
        const long long k = f / B, b = f - k * B;
        off = k * static_cast<long long>(plane) + b;
        s = se[f];
        if (DEFER && k % unroll != 0) n2p = n2s[f - B];
        gb = g[b];
      }
      loff[tid] = off;
      ls[tid] = s;
      ln2[tid] = n2p;
      lgb[tid] = gb;
    }
    __syncthreads();
    // the tile's y, kClTailYDepth loads a thread in flight before their
    // stores (the CTA waits on them: they are the tile's first operand)
    constexpr int YD = kClTailYDepth;
    for (int base = tid; base < np * nl; base += YD * kClTailThreads) {
      float yv[YD];
#pragma unroll
      for (int u = 0; u < YD; ++u) {
        const int idx = base + u * kClTailThreads;
        float y = 0.f;
        if (idx < np * nl) {
          const int j = idx / nl, l = idx - j * nl;
          const long long off = loff[l];
          if (j < n && off >= 0)
            y = __ldg(ys + off + static_cast<size_t>(j) * B);
        }
        yv[u] = y;
      }
#pragma unroll
      for (int u = 0; u < YD; ++u) {
        const int idx = base + u * kClTailThreads;
        if (idx < np * nl) store_vec<P>(yh, yl, idx, yv[u]);
      }
    }
    float acc[RM][RN][3];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = 0.f;
    for (int s = 0; s < nslab; ++s) {
      // the next slab (the next tile's first after the last) goes in flight
      if (s + 1 < nslab || tile + gridDim.x < ntiles) {
        issue(s + 1 < nslab ? s + 1 : 0, stage ^ 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      if (comp) {
        const uint32_t* sw = ss + stage * KS * np + 4 * tm;
        const float* vh = yh + (s * KS) * nl + 4 * tn;
        const float* vl = yl + (s * KS) * nl + 4 * tn;
#pragma unroll
        for (int jj = 0; jj < KS; ++jj) {
          uint32_t w[RM];
#pragma unroll
          for (int gq = 0; gq < RG; ++gq) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                sw + jj * np + gq * rstride);
            w[4 * gq] = v.x;
            w[4 * gq + 1] = v.y;
            w[4 * gq + 2] = v.z;
            w[4 * gq + 3] = v.w;
          }
          float h[RN], l[RN];
          ld_lanes<RN>(vh + jj * nl, gap, h);
          if (P == kHigh) {
            ld_lanes<RN>(vl + jj * nl, gap, l);
          } else {
#pragma unroll
            for (int c = 0; c < RN; ++c) l[c] = h[c];
          }
#pragma unroll
          for (int r = 0; r < RM; ++r)
#pragma unroll
            for (int c = 0; c < RN; ++c)
              quad_fma<P>(w[r], h[c], l[c], acc[r][c]);
        }
      }
      __syncthreads();   // every read of this stage is done before its refill
      stage ^= 1;
    }
    // epilogue: u, then the lanes' ehat parts (raw y: the tile's own at
    // kHighest, where y is its prepped vector; re-read otherwise)
    float u[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        u[r][c] = P == kHigh ? (acc[r][c][0] + acc[r][c][1]) + acc[r][c][2]
                             : acc[r][c][0];
    if (comp) {
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const int l = (c >> 2) * gap + 4 * tn + (c & 3);
        const long long off = loff[l];
        float e = 0.f;
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int i = (r >> 2) * rstride + 4 * tm + (r & 3);
          float y;
          if (P == kHighest) {
            y = yh[i * nl + l];
          } else {
            y = (i < n && off >= 0)
                    ? __ldg(ys + off + static_cast<size_t>(i) * B)
                    : 0.f;
          }
          e = fmaf(y, u[r][c], e);
        }
        ep[tm * nl + l] = e;
      }
    }
    __syncthreads();
    if (tid < nl) {
      const long long f = f0 + tid;
      float d2 = 0.f;
      if (f < total) {
        float ehat = ep[tid];
        for (int t = 1; t < pl.rt; ++t) ehat += ep[t * nl + tid];
        const float s = ls[tid], n2p = ln2[tid];
        const float n2p_c = floor_at(n2p, norm_eps);
        const float ev = DEFER ? ehat / n2p_c : ehat;
        const float arg = floor_at(fmaf(ev, s, 1.f), log_eps);
        const float darg = arg > log_eps ? -lgb[tid] / arg : 0.f;
        const float de = darg * s;
        const float dehat = DEFER ? de / n2p_c : de;
        dse[f] = darg * ev;
        dehats[f] = dehat;
        dn2ns[f] = n2p > norm_eps ? -de * ev / n2p_c : 0.f;
        d2 = 2.f * dehat;
      }
      dh[tid] = d2;
    }
    __syncthreads();
    // q = (2 dehat) u through the y buffer (every read of it is done) to
    // coalesced stores
    if (comp) {
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = (r >> 2) * rstride + 4 * tm + (r & 3);
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          const int l = (c >> 2) * gap + 4 * tn + (c & 3);
          yh[i * nl + l] = __fmul_rn(dh[l], u[r][c]);
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * nl; idx += blockDim.x) {
      const int j = idx / nl, l = idx - j * nl;
      const long long off = loff[l];
      if (off >= 0) dys[off + static_cast<size_t>(j) * B] = yh[idx];
    }
    __syncthreads();   // the next tile overwrites the buffers
  }
}

// The reverse chain on the cluster layout (see the note above). Grid:
// clusters of C CTAs along x, one cluster a group of G columns.
template <int P, bool DEFER, int G>
__global__ void __launch_bounds__(kClThreads, 1)
    psi_cl_chain_kernel(const float* __restrict__ ab,
                        const float* __restrict__ bb,
                        const float* __restrict__ t0,
                        const float* __restrict__ se,
                        const float* __restrict__ ys,
                        const float* __restrict__ n2s,
                        const float* __restrict__ dn2ns,
                        const float* __restrict__ dtfin,
                        float* __restrict__ dse, float* __restrict__ dt0,
                        float* __restrict__ dys, int D, int n_steps, int B,
                        int unroll, int C, float norm_eps) {
  extern __shared__ __align__(16) float4 smem4[];
  __shared__ uint64_t full[2];
  const ClLayout L(D, C);
  const int rank = static_cast<int>(cluster_rank());
  const ClThread th(L, rank);
  uint32_t* ma = reinterpret_cast<uint32_t*>(smem4);    // Ab^T's rows
  uint32_t* mb = ma + L.slab;                           // Bb^T's rows
  float* vec = reinterpret_cast<float*>(mb + L.slab);   // [2][hi, lo][n][G]
  const int vw = 2 * L.n * G;
  float* dva = vec + 2 * vw;                            // [slots][na][G]
  float* dsa = dva + kClSlots * L.na * G;

  ClExchange ex = cl_exchange_init(full, 1);
  cl_load_slab<P, true>(ma, ab, L, rank * L.nr);
  cl_load_slab<P, true>(mb, bb, L, rank * L.nr);
  for (int idx = threadIdx.x; idx < static_cast<int>(cl_state_words(L, G));
       idx += blockDim.x)
    vec[idx] = 0.f;

  const size_t stride = static_cast<size_t>(B);
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
  const bool rd = th.active;   // this thread reads its row's streams
  const bool lossl = rank == 0 && th.warp == 0 && th.lane < G;
  const int lc = th.lane < G ? th.lane : 0;
  const uint32_t vbytes = cl_vec_bytes<P, G>(L);
  const uint32_t abytes = cl_atom_bytes<G>(L);

  // dse[m] = ds0[m] + the total of step m's ds atoms: the loss lanes hold
  // the step whose atoms ride the next phase (pend, its ds0 pd0) and the
  // step whose atoms have arrived (rdy, rd0), taken after a push
  int pend = -1, rdy = -1;
  float pd0 = 0.f, rd0 = 0.f;
  auto take = [&]() {
    if (rdy >= 0 && lossl && live[lc])
      dse[rdy * stride + col[lc]] =
          rd0 + cl_total<G>(dsa, rdy % kClSlots, lc, L);
    rdy = -1;
  };
  auto arrived = [&]() {
    rdy = pend;
    rd0 = pd0;
    pend = -1;
  };

  // step k's inputs, loaded a step ahead: y, q; s, n2 and the dn2_new of
  // step k+1; dt, the cotangent of t_{k+1}
  const int k1 = n_steps - 1;
  float dt[G], y[G], qv[G], s[G], n2[G], dn2n[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    const bool ok = live[c] && k1 >= 0;
    dt[c] = (dtfin != nullptr && rd && live[c]) ? dtfin[at_i[c]] : 0.f;
    y[c] = (rd && ok) ? ys[k1 * plane + at_i[c]] : 0.f;
    qv[c] = (rd && ok) ? dys[k1 * plane + at_i[c]] : 0.f;
    s[c] = ok ? se[k1 * stride + col[c]] : 0.f;
    n2[c] = ok ? n2s[k1 * stride + col[c]] : 1.f;
    dn2n[c] = 0.f;
  }
  // every CTA's buffers are zero and its mbarriers set before any push, and
  // every lane of a row has read its q before the row's owner overwrites it
  // with dy (later, the walk's shuffles order a row's lanes)
  cluster_sync();
  if (rank >= L.cw) {   // no rows: nothing to push or wait for
    cluster_sync();
    return;
  }
  for (int k = k1; k >= 0; --k) {
    const bool prev_renorm = !DEFER || k % unroll == 0;
    const bool renorm = !DEFER || (k + 1) % unroll == 0;
    float yp[G], qn[G], sp[G], n2p[G], dn2p[G];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const bool ok = live[c] && k > 0;
      yp[c] = (ok && rd) ? ys[(k - 1) * plane + at_i[c]] : 0.f;
      qn[c] = (ok && rd) ? dys[(k - 1) * plane + at_i[c]] : 0.f;
      sp[c] = ok ? se[(k - 1) * stride + col[c]] : 0.f;
      n2p[c] = ok ? n2s[(k - 1) * stride + col[c]] : 1.f;
      dn2p[c] = ok ? dn2ns[k * stride + col[c]] : 0.f;
    }
    const float dk0 = lossl && live[lc] ? dse[k * stride + col[lc]] : 0.f;
    float dtp[G], dn2[G];
    if (renorm) {
      // a phase of its own: the atoms of dinv = dt . y (and the ds atoms of
      // step k+1)
      float x[G];
#pragma unroll
      for (int c = 0; c < G; ++c) x[c] = __fmul_rn(dt[c], y[c]);
      cl_push_atoms<G>(dva, k % kClSlots, x, L, th, ex.bar());
      cl_exchange_done(ex, (pend >= 0 ? 2 : 1) * abytes);
      take();
      cl_exchange_wait(ex);
      arrived();
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float dinv = cl_total<G>(dva, k % kClSlots, c, L);
        const float inv = rsqrtf(floor_at(n2[c], norm_eps));
        dtp[c] = __fmul_rn(dt[c], inv);
        dn2[c] = n2[c] > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < G; ++c) {
        dtp[c] = dt[c];
        dn2[c] = dn2n[c];
      }
    }
    float dy[G];
#pragma unroll
    for (int c = 0; c < G; ++c)
      dy[c] = __fadd_rn(dtp[c], fmaf(y[c], 2.f * dn2[c], qv[c]));
    const int vb = ex.parity();
    cl_push_vec<P, G>(vec + vb * vw, dy, L, th, ex.bar());
    cl_exchange_done(ex, vbytes + (pend >= 0 ? abytes : 0u));
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (th.owner && live[c]) dys[k * plane + at_i[c]] = dy[c];
    take();
    cl_exchange_wait(ex);
    if (pend >= 0) arrived();
    float o[2][G];
    const uint32_t* const mm[2] = {ma, mb};
    const float* vh = vec + vb * vw;
    cl_walk<P, 2, G>(mm, vh, vh + L.n * G, L, th, o);
    float x[G];
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const float tk =
          k > 0 ? (prev_renorm
                       ? __fmul_rn(yp[c], rsqrtf(floor_at(n2p[c], norm_eps)))
                       : yp[c])
                : ((rd && live[c]) ? t0[at_i[c]] : 0.f);
      x[c] = __fmul_rn(o[1][c], tk);
      dt[c] = fmaf(s[c], o[1][c], o[0][c]);
      y[c] = yp[c];
      qv[c] = qn[c];
      s[c] = sp[c];
      n2[c] = n2p[c];
      dn2n[c] = dn2p[c];
    }
    // step k's ds atoms ride the next phase
    cl_push_atoms<G>(dsa, k % kClSlots, x, L, th, ex.bar());
    pend = k;
    pd0 = dk0;
  }
  if (pend >= 0) {   // the last step's ds atoms: a phase of their own
    cl_exchange_done(ex, abytes);
    take();
    cl_exchange_wait(ex);
    arrived();
    take();
  }
#pragma unroll
  for (int c = 0; c < G; ++c)
    if (th.owner && live[c]) dt0[at_i[c]] = dt[c];
  cluster_sync();   // no CTA leaves while another may still push to it
}

inline int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return v;
}

// Pack S = Rb + Rb^T into sp ((2D)^2 words), then the tail over every
// (step, column) lane: persistent CTAs, as many as the card holds at once.
template <int P, bool DEFER>
cudaError_t launch_cl_tail(const float* rb, uint32_t* sp, const float* se,
                           const float* g, const float* ys, const float* n2s,
                           float* dse, float* dys, float* dehats,
                           float* dn2ns, int D, int n_steps, int B, int unroll,
                           float log_eps, float norm_eps,
                           cudaStream_t stream) {
  if (n_steps <= 0 || B <= 0) return cudaSuccess;
  const int n = 2 * D;
  const int sms = sm_count();
  const int pack_grid = (n * n + 255) / 256 < 4 * sms ? (n * n + 255) / 256
                                                      : 4 * sms;
  cudaError_t err = launch_smem(psi_cl_pack_kernel<P>, dim3(pack_grid), 256,
                                0, stream, rb, sp, n);
  if (err != cudaSuccess) return err;
  const ClTailPlan pl(D, P);
  const size_t smem = pl.smem_bytes(P);
  const auto kernel = psi_cl_tail_kernel<P, DEFER>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kClTailThreads, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (static_cast<long long>(n_steps) * B + pl.nl - 1) / pl.nl;
  const long long most = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(tiles < most ? tiles : most);
  return launch_smem(kernel, dim3(grid), kClTailThreads, smem, stream, sp,
                     se, g, ys, n2s, dse, dys, dehats, dn2ns, D, n_steps, B,
                     unroll, log_eps, norm_eps);
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one tail CTA at D: the most any precision's
// plan takes (ops/cluster.py psi_cluster_tail_smem_bytes mirrors it).
size_t amt_psi_cl_tail_smem_bytes(int D) { return amt::cl_tail_smem_bytes(D); }

// Lanes a tile of the tail at D and precision (0 highest, 1 high, 2
// default; ops/cluster.py psi_cluster_tail_plan mirrors it).
int amt_psi_cl_tail_lanes(int D, int precision) {
  return amt::ClTailPlan(D, precision).nl;
}

// Dynamic shared memory of one chain CTA at D, cluster C and G columns a
// cluster; 0 where the layout does not take D and C.
size_t amt_psi_cl_chain_smem_bytes(int D, int C, int G) {
  return amt::cl_ok(D, C) ? amt::cl_chain_smem_bytes(D, C, G) : 0;
}

// The tail alone: q into dys[n_steps, 2D, B], ds0 into dse[n_steps, B],
// dehats and dn2ns [n_steps, B] from g[B], ys and n2s; rbp is a scratch of
// (2D)^2 words (S packed). precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_psi_cl_tail(const float* rb, void* rbp, const float* se,
                    const float* g, const float* ys, const float* n2s,
                    float* dse, float* dys, float* dehats, float* dn2ns, int D,
                    int n_steps, int B, int unroll, float log_eps,
                    float norm_eps, int precision, int defer_norm,
                    void* stream) {
  if (unroll < 1 || D < 2 || D % 2 || D > amt::kClMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::launch_cl_tail<decltype(p)::value, decltype(d)::value>(
            rb, static_cast<uint32_t*>(rbp), se, g, ys, n2s, dse, dys, dehats,
            dn2ns, D, n_steps, B, unroll, log_eps, norm_eps,
            static_cast<cudaStream_t>(stream));
      }));
}

// dse[n_steps, B], dt0[2D, B], dys[n_steps, 2D, B] and dehats[n_steps, B]
// from g[B], the forward's ys and n2s, and dtfin[2D, B] (null: zero): the
// tail, then the chain in clusters of C CTAs, G columns a cluster; rbp
// ((2D)^2 words) and dn2ns[n_steps, B] are scratch. Returns a
// cudaError_t.
int amt_psi_cl_train_bwd(const float* ab, const float* bb, const float* rb,
                         const float* t0, const float* se, const float* g,
                         const float* ys, const float* n2s,
                         const float* dtfin, float* dse, float* dt0,
                         float* dys, float* dehats, float* dn2ns, void* rbp,
                         int D, int n_steps, int B, int unroll, float log_eps,
                         float norm_eps, int precision, int defer_norm, int C,
                         int G, void* stream) {
  if (unroll < 1 || !amt::cl_ok(D, C) || (G != 1 && G != 2 && G != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const amt::ClLayout L(D, C);
  const dim3 grid(((B + G - 1) / G) * C);
  const size_t smem = amt::cl_chain_smem_bytes(D, C, G);
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        constexpr int kP = decltype(p)::value;
        constexpr bool kD = decltype(d)::value;
        cudaError_t err = amt::launch_cl_tail<kP, kD>(
            rb, static_cast<uint32_t*>(rbp), se, g, ys, n2s, dse, dys,
            dehats, dn2ns, D, n_steps, B, unroll, log_eps, norm_eps, st);
        if (err != cudaSuccess) return err;
        const auto go = [&](auto gc) {
          return amt::launch_cluster(
              amt::psi_cl_chain_kernel<kP, kD, decltype(gc)::value>, grid,
              L.threads, C, false, smem, st, ab, bb, t0, se, ys, n2s, dn2ns,
              dtfin, dse, dt0, dys, D, n_steps, B, unroll, C, norm_eps);
        };
        switch (G) {
          case 4:
            return go(std::integral_constant<int, 4>{});
          case 2:
            return go(std::integral_constant<int, 2>{});
          default:
            return go(std::integral_constant<int, 1>{});
        }
      }));
}

}  // extern "C"
