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
// The tail (psi_cl_tail_kernel) is a batched [2D,2D] x [2D, (T-1) B] product
// pair at true fp32 (the bf16 splits at kHigh, kDefault), free of the chain:
//   ru = Rb y; ehat = 2 y . ru; (ds0, dehat, dn2_new) from ehat;
//   q = ru (2 dehat) + Rb^T (2 dehat y)
// over tiles of kClTailLanes (step, column) lanes: a tile's y (raw and
// prepped) sits in shared memory as [2D][16]; thread (quartet, lane group)
// forms a 4-row x 4-lane tile of each product over every j in order (one
// fmaf chain an output, three at kHigh), Rb read packed from device memory
// (a pre-pass packs Rb^T and Rb once a launch: 2 MB at D=256, resident in
// L2), each 16-byte load feeding 16 FMAs. ehat is the quartets' fmaf
// chains added in quartet order. Where the quad tail holds Rb^T and Rb whole
// in shared memory (psi_train_bwd.cu, 2D (2D+4) words each), this one reads
// them from L2: 512 KB at D=128 do not fit one CTA.
//
// The chain (psi_cl_chain_kernel) runs the reverse recursion on the
// cluster layout of psi_cluster.cuh: CTA r of a cluster holds rows r nr ..
// of Ab^T and Bb^T (its rows of dt), a step's dy is pushed to every CTA,
// one cluster barrier, one walk of both slabs; a renorm step first pushes
// its atoms of dinv = dt . y and takes a barrier more. The ds sums
// (Bb^T dy) . t_k ride on the next exchange and are added to ds0 by lanes
// c < G of warp 0 of CTA 0.
//
// What bounds them: the tail's 2 (2D)^2 FMAs a lane (16.4 ms of the
// card's fp32 rate at D=128, B=128, T=16384 with the chain), its L2 reads of
// Rb (a 16-byte load a 16 FMAs); the chain's shared-memory reads and its
// cluster barrier a step (psi_cluster.cuh).
#include "psi_cluster.cuh"

namespace amt {

constexpr int kClTailLanes = 16;     // (step, column) lanes a tail tile
constexpr int kClTailThreads = 256;  // 64 quartets of rows x 4 lane groups

// Words of one tail CTA's shared memory: y raw, the prepped vector (hi, lo;
// y, then 2 dehat y), ru ([2D][16] each), the quartets' parts of ehat
// [2D/4][16] and the lanes' s, n2p, g and 2 dehat [4][16].
__host__ __device__ inline size_t cl_tail_words(int D) {
  const size_t n = 2 * static_cast<size_t>(D);
  return 4 * n * kClTailLanes + (n / 4) * kClTailLanes + 4 * kClTailLanes;
}

// out[0 .. n^2) = Rb^T packed j-major (out[j n + i] = Rb[i][j]) and
// out[n^2 .. 2 n^2) = Rb packed the same way (out[n^2 + j n + i] = Rb[j][i]):
// the tail's two products read column j of their matrix as a row.
template <int P>
__global__ void psi_cl_pack_kernel(const float* __restrict__ rb,
                                   uint32_t* __restrict__ out, int n) {
  const size_t nn = static_cast<size_t>(n) * n;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) +
                    threadIdx.x;
       idx < nn; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t j = idx / n, i = idx - j * n;
    out[idx] = pack_elem<P>(rb[i * n + j]);
    out[nn + idx] = pack_elem<P>(rb[idx]);
  }
}

// out[r][c] = (M v_c)_{4 qt + r} for the thread's quartet of rows and its
// 4 lanes 4 lg + c, mt[j n + i] = M[i][j] packed, v in [n][16] (vh, and at
// kHigh vl): over j in order one fmaf chain an output (three at kHigh,
// added (hi hi + hi lo) + lo hi).
template <int P>
__device__ __forceinline__ void cl_tail_tile(const uint32_t* __restrict__ mt,
                                             const float* vh, const float* vl,
                                             int n, int qt, int lg,
                                             float (&out)[4][4]) {
  float acc[4][4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = 0.f;
  const uint32_t* mp = mt + 4 * qt;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(
        mp + static_cast<size_t>(j) * n));
    const uint32_t ww[4] = {w.x, w.y, w.z, w.w};
    float h[4], l[4];
    ld_g<4>(vh + j * kClTailLanes + 4 * lg, h);
    if (P == kHigh) {
      ld_g<4>(vl + j * kClTailLanes + 4 * lg, l);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) l[c] = h[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) quad_fma<P>(ww[r], h[c], l[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[r][c] = P == kHigh ? (acc[r][c][0] + acc[r][c][1]) + acc[r][c][2]
                             : acc[r][c][0];
}

template <int P, bool DEFER>
__global__ void __launch_bounds__(kClTailThreads)
    psi_cl_tail_kernel(const uint32_t* __restrict__ rbp,
                       const float* __restrict__ se,
                       const float* __restrict__ g,
                       const float* __restrict__ ys,
                       const float* __restrict__ n2s,
                       float* __restrict__ dse, float* __restrict__ dys,
                       float* __restrict__ dehats, float* __restrict__ dn2ns,
                       int D, int n_steps, int B, int unroll, float log_eps,
                       float norm_eps) {
  extern __shared__ __align__(16) float4 smem4[];
  constexpr int TL = kClTailLanes;
  const int n = 2 * D, nq = n / 4;
  float* yr = reinterpret_cast<float*>(smem4);   // [n][TL] raw y
  float* vh = yr + n * TL;                       // prepped y, then u
  float* vl = vh + n * TL;
  float* ru = vl + n * TL;                       // Rb y
  float* ep = ru + n * TL;                       // [nq][TL] parts of ehat
  float* ls = ep + nq * TL;                      // [TL] s
  float* ln2 = ls + TL;                          // [TL] the n2 e divides by
  float* lg_ = ln2 + TL;                         // [TL] g
  float* dh = lg_ + TL;                          // [TL] 2 dehat
  const uint32_t* rbt = rbp;                                      // Rb y
  const uint32_t* rbm = rbp + static_cast<size_t>(n) * n;         // Rb^T u
  const int tid = threadIdx.x;
  const int lg = tid & 3, qt0 = tid >> 2;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;
  const long long total = static_cast<long long>(n_steps) * B;
  const long long ntiles = (total + TL - 1) / TL;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long f0 = tile * TL;
    for (int idx = tid; idx < n * TL; idx += blockDim.x) {
      const int j = idx / TL, l = idx - j * TL;
      const long long f = f0 + l;
      float y = 0.f;
      if (f < total) {
        const long long k = f / B, b = f - k * B;
        y = ys[k * plane + j * stride + b];
      }
      yr[idx] = y;
      store_vec<P>(vh, vl, idx, y);
    }
    if (tid < TL) {
      const long long f = f0 + tid;
      float s = 0.f, n2p = 1.f, gb = 0.f;
      if (f < total) {
        const long long k = f / B, b = f - k * B;
        s = se[k * stride + b];
        if (DEFER && k % unroll != 0) n2p = n2s[(k - 1) * stride + b];
        gb = g[b];
      }
      ls[tid] = s;
      ln2[tid] = n2p;
      lg_[tid] = gb;
    }
    __syncthreads();
    for (int qt = qt0; qt < nq; qt += 64) {
      float o[4][4];
      cl_tail_tile<P>(rbt, vh, vl, n, qt, lg, o);
      float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * qt + r;
        float yv[4];
        ld_g<4>(yr + i * TL + 4 * lg, yv);
#pragma unroll
        for (int c = 0; c < 4; ++c) e[c] = fmaf(yv[c], o[r][c], e[c]);
        *reinterpret_cast<float4*>(ru + i * TL + 4 * lg) =
            make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      }
      *reinterpret_cast<float4*>(ep + qt * TL + 4 * lg) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();
    if (tid < TL) {
      const long long f = f0 + tid;
      float d2 = 0.f;
      if (f < total) {
        const long long k = f / B, b = f - k * B;
        float ehat = ep[tid];
        for (int qt = 1; qt < nq; ++qt) ehat += ep[qt * TL + tid];
        ehat *= 2.f;
        const float s = ls[tid], n2p = ln2[tid];
        const float n2p_c = floor_at(n2p, norm_eps);
        const float ev = DEFER ? ehat / n2p_c : ehat;
        const float arg = floor_at(fmaf(ev, s, 1.f), log_eps);
        const float darg = arg > log_eps ? -lg_[tid] / arg : 0.f;
        const float de = darg * s;
        const float dehat = DEFER ? de / n2p_c : de;
        dse[k * stride + b] = darg * ev;
        dehats[k * stride + b] = dehat;
        dn2ns[k * stride + b] = n2p > norm_eps ? -de * ev / n2p_c : 0.f;
        d2 = 2.f * dehat;
      }
      dh[tid] = d2;
    }
    __syncthreads();
    for (int idx = tid; idx < n * TL; idx += blockDim.x) {
      const int l = idx % TL;
      store_vec<P>(vh, vl, idx, __fmul_rn(dh[l], yr[idx]));
    }
    __syncthreads();
    for (int qt = qt0; qt < nq; qt += 64) {
      float o[4][4];
      cl_tail_tile<P>(rbm, vh, vl, n, qt, lg, o);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long f = f0 + 4 * lg + c;
        if (f >= total) continue;
        const long long k = f / B, b = f - k * B;
        const float d2 = dh[4 * lg + c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * qt + r;
          dys[k * plane + i * stride + b] =
              fmaf(ru[i * TL + 4 * lg + c], d2, o[r][c]);
        }
      }
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
  const ClLayout L(D, C);
  const int rank = static_cast<int>(cluster_rank());
  const ClThread th(L, rank);
  uint32_t* ma = reinterpret_cast<uint32_t*>(smem4);    // Ab^T's rows
  uint32_t* mb = ma + L.slab;                           // Bb^T's rows
  float* vec = reinterpret_cast<float*>(mb + L.slab);   // [2][hi, lo][n][G]
  const int vw = 2 * L.n * G;
  float* dva = vec + 2 * vw;                            // [slots][na][G]
  float* dsa = dva + kClSlots * L.na * G;

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

  // dse[m] = ds0[m] + the total of step m's ds atoms (after the barrier
  // that follows their push)
  int pend = -1;
  auto take = [&]() {
    if (pend >= 0 && lossl && live[lc]) {
      float* d = dse + pend * stride + col[lc];
      *d = *d + cl_total<G>(dsa, pend % kClSlots, lc, L);
    }
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
  // every CTA's buffers are zero before any push, and every lane of a row
  // has read its q before the row's owner overwrites it with dy
  cluster_sync();
  int cur = 0;
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
    float dtp[G], dn2[G];
    if (renorm) {
      float x[G];
#pragma unroll
      for (int c = 0; c < G; ++c) x[c] = __fmul_rn(dt[c], y[c]);
      cl_push_atoms<G>(dva, k % kClSlots, x, L, th);
      cluster_sync();
      take();
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
    for (int c = 0; c < G; ++c) {
      dy[c] = __fadd_rn(dtp[c], fmaf(y[c], 2.f * dn2[c], qv[c]));
      if (th.owner && live[c]) dys[k * plane + at_i[c]] = dy[c];
    }
    float* vb = vec + cur * vw;
    cl_push_vec<P, G>(vb, dy, L, th);
    cluster_sync();
    take();
    float o[2][G];
    const uint32_t* const mm[2] = {ma, mb};
    cl_walk<P, 2, G>(mm, vb, vb + L.n * G, L, th, o);
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
    cl_push_atoms<G>(dsa, k % kClSlots, x, L, th);
    pend = k;
    cur ^= 1;
  }
  cluster_sync();
  take();
#pragma unroll
  for (int c = 0; c < G; ++c)
    if (th.owner && live[c]) dt0[at_i[c]] = dt[c];
}

inline int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return v;
}

// Pack Rb into rbp (2 (2D)^2 words), then the tail over every (step,
// column) lane: a grid-strided loop over the tiles, two CTAs an SM.
template <int P, bool DEFER>
cudaError_t launch_cl_tail(const float* rb, uint32_t* rbp, const float* se,
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
                                0, stream, rb, rbp, n);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (static_cast<long long>(n_steps) * B + kClTailLanes - 1) / kClTailLanes;
  const int grid = tiles < 2LL * sms ? static_cast<int>(tiles) : 2 * sms;
  return launch_smem(psi_cl_tail_kernel<P, DEFER>, dim3(grid),
                     kClTailThreads, 4 * cl_tail_words(D), stream, rbp, se, g,
                     ys, n2s, dse, dys, dehats, dn2ns, D, n_steps, B, unroll,
                     log_eps, norm_eps);
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one tail CTA at D (ops/cluster.py mirrors it).
size_t amt_psi_cl_tail_smem_bytes(int D) { return 4 * amt::cl_tail_words(D); }

// Dynamic shared memory of one chain CTA at D, cluster C and G columns a
// cluster; 0 where the layout does not take D and C.
size_t amt_psi_cl_chain_smem_bytes(int D, int C, int G) {
  return amt::cl_ok(D, C) ? amt::cl_chain_smem_bytes(D, C, G) : 0;
}

// The tail alone: q into dys[n_steps, 2D, B], ds0 into dse[n_steps, B],
// dehats and dn2ns [n_steps, B] from g[B], ys and n2s; rbp is a scratch of
// 2 (2D)^2 words. precision: 0 highest, 1 high, 2 default. Returns a
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
// (2 (2D)^2 words) and dn2ns[n_steps, B] are scratch. Returns a
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
