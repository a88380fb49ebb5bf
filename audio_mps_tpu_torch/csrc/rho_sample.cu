// rho SDE sampler (Euler–Maruyama, purification factor, block-complex
// layout) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py
// _make_rho_sample_kernel (:2278, reached through rho_sample_block :2333).
// The Pallas body's step, on one chain's folded factor segment t ([2D, R],
// R = rank):
//   gx  = Xs t                 (Xs = Bk(X^T diag(p)): the expectation acts on
//                               the CURRENT state H = p .* t)
//   v   = conj(p) .* gx over the two halves
//   e   = sum(t .* v)          (over the segment)
//   inc = e dt + noise[k];  samp += inc  (written out: running waveform)
//   y   = Ab t + (inc / A) (Bb t)
//   t   = y rsqrt(max(sum(y .* y), norm_eps))
// Here the state is carried unnormalised, u_0 = t0 and u_{k+1} = y_k, so
// that one pass over u_k feeds all three products and one exchange gives
// both of the step's sums:
//   a0, a1, g = Ab u_k, Bb u_k, Xs u_k           (one loop over j)
//   tr = sum(u_k .* u_k) (= tr_{k-1}),  E = sum(u_k .* v(g))
//   c  = rsqrt(max(tr, norm_eps)) (1 at step 0: t0 is taken as given)
//   e  = c^2 E;  inc = e dt + noise[k];  s = inc / A
//   u_{k+1} = c (a0 + s a1)
// the same recursion in exact arithmetic (ops/block.rho_sample_block_plain
// takes this order). The A scaling and the transpose of the running
// waveform stay outside.
//
// Design (rho_cluster.cuh): a chain's segment spread over a cluster of C
// CTAs by its rank columns, each CTA with Ab, Bb and Xs j-major in its
// shared memory (3 x 64 KB at D=64). A step runs the three products in one
// pass over j on the buffer holding u_k, takes the atoms of E and tr into
// the step's part set, passes one cluster barrier, and every warp reads
// the groups' sums from their CTAs (RhoSums::warp_totals) in one order
// whatever C is; u_{k+1} goes to the other buffer (the same one where two
// do not fit), and one CTA barrier closes the step. Two part sets (step
// parity) keep a CTA that runs ahead from overwriting sums another still
// reads. The cluster's rank-0 CTA writes the waveform; every CTA reads the
// chain's noise a step ahead, between the barrier's arrive and its wait.
//
// Two thread tiles, one sum order:
// - QuadTile (D % 32 == 0 and at least 8 column groups a CTA: C <= 2 at
//   D=64, R=64, the rule's from 31 chains on an H100): rho_tile.cuh's 8 x
//   4 tile, rows 4q .. 4q + 3 of a block of 32 and their twins D + 4q + r
//   over one column group, 256 threads at C=1, D=64, R=64. A row j costs
//   a thread six 16-byte constant loads and one of the state for 96 FMAs;
//   the twist stays in the thread, so a step takes one CTA barrier beside
//   the exchange's. With 4 groups a CTA (2 warps) it ran 1.2-1.5x slower
//   than RowTile.
// - RowTile (the rest: C >= 4 at D=64, R=64, the rule's for 8 chains
//   and one): rho_cluster.cuh's, one row x BC columns a thread, so that a
//   CTA of 1 to 4 groups still has 4 to 8 warps. A row j costs a warp 3
//   constant words and BC state words (one broadcast) for 3 BC FMAs. The
//   conj(p) twist couples rows i and i + D, which are different warps:
//   the expectation's rows go through the idle state buffer after a CTA
//   barrier (and a second one where that buffer is the state's).
// The waveform is the same bits at every C and either tile: every product
// is one fmaf chain over j; the twist and the update are written as
// explicit fmaf and __fmul_rn; a sum's atom is one row's fmaf chain over
// a group's 4 columns, and a block of 32 rows adds its atoms as xor-shuffle
// pairs (QuadTile adds the first two levels, within a quad, in the thread).
//
// What bounds it: 3 x 2 x (2D)^2 x R FLOPs per chain-step (6.3 MFLOP at
// D=64, R=64) on the fp32 pipes of C SMs a chain, the shared-memory
// pipeline of each (rho_fwd.cuh), and one cluster barrier a step.
#include "rho_cluster.cuh"

namespace amt {

constexpr int kRhoQuadThreads = 256;   // QuadTile's launch bound: D, R <= 64

// Words of one sampler CTA's dynamic shared memory (host and device): the
// constants, nbuf state buffers [2D, sw] (for RowTile one also carries the
// expectation's rows for the twist) and the part sets of the step's two
// sums.
__host__ __device__ inline int rho_sample_words(int D, int R, int C,
                                                int nbuf) {
  const RhoLayout L(D, R, C);
  return 3 * L.n * L.n + nbuf * L.n * L.sw + rho_sums_words(L, 2, 0);
}

inline size_t rho_sample_smem_bytes(int D, int R, int C, int nbuf) {
  return 4 * static_cast<size_t>(rho_sample_words(D, R, C, nbuf));
}

// State buffers of a sampler CTA: 2 where they fit `optin` bytes, else 1.
inline int rho_sample_buffers(int D, int R, int C, int optin) {
  return rho_sample_smem_bytes(D, R, C, 2) <= static_cast<size_t>(optin)
             ? 2 : 1;
}

// Does a launch at L take QuadTile (see the note above)?
inline bool rho_sample_quad(const RhoLayout& L) {
  return L.n % 64 == 0 && L.ng >= 8;
}

inline int rho_sample_threads(const RhoLayout& L) {
  return rho_sample_quad(L) ? 32 * (L.n / 64) * ((L.ng + 3) / 4)
                            : L.threads;
}

// A row of v = conj(p) .* g: pc g + ps other, with `other` the other
// half's row of g and ps negated on the imaginary half.
__device__ __forceinline__ float twist(float pc, float g, float ps,
                                       float other) {
  return fmaf(ps, other, __fmul_rn(pc, g));
}

// One row x BC columns a thread (rho_cluster.cuh).
template <int P, int BC>
struct RowTile {
  RhoCTile<BC> t;
  int partner;     // the row of the other half of the thread's component
  float pc, ps;    // the twist on the thread's row
  float u[BC];     // u_k
  float a[3][BC];  // Ab u_k, Bb u_k, Xs u_k

  __device__ RowTile(const RhoLayout& L, int cta, const float* pcg,
                     const float* psg)
      : t(L, cta) {
    const int D = L.n / 2;
    const bool re = t.i < D;   // real half: v_r = pc g_r + ps g_i
    const int comp = re ? t.i : t.i - D;
    partner = re ? t.i + D : t.i - D;
    pc = t.active ? pcg[comp] : 0.f;
    ps = t.active ? (re ? psg[comp] : -psg[comp]) : 0.f;
  }
  __device__ void load(const float* t0, size_t cols, size_t col0) {
    load_ctile(u, t0, cols, col0, t);
  }
  __device__ void store(uint32_t* st) const { store_ctile<P>(st, t, u); }
  __device__ void products(const uint32_t* const (&m)[3],
                           const uint32_t* st) {
    ctile_products<P, BC, 3>(m, st, t, a);
  }
  // The step's atoms of E and tr into part set k: the expectation's rows
  // go to the partner's thread through gx (the idle buffer; with
  // one_buf, the state's, once every read of u_k is done).
  __device__ void sums(const RhoSums& S, int k, float* gx, int sw,
                       bool one_buf) const {
    if (one_buf) __syncthreads();
    if (t.active) {
      float4* dst = reinterpret_cast<float4*>(gx + t.i * sw + t.cb0);
#pragma unroll
      for (int q = 0; q < BC / 4; ++q)
        dst[q] = make_float4(a[2][4 * q], a[2][4 * q + 1], a[2][4 * q + 2],
                             a[2][4 * q + 3]);
    }
    __syncthreads();  // the expectation's rows are written
    const float4* src =
        reinterpret_cast<const float4*>(gx + partner * sw + t.cb0);
    float v[BC];
#pragma unroll
    for (int q = 0; q < BC / 4; ++q) {
      const float4 w = t.active ? src[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * q] = twist(pc, a[2][4 * q], ps, w.x);
      v[4 * q + 1] = twist(pc, a[2][4 * q + 1], ps, w.y);
      v[4 * q + 2] = twist(pc, a[2][4 * q + 2], ps, w.z);
      v[4 * q + 3] = twist(pc, a[2][4 * q + 3], ps, w.w);
    }
    float pe[BC / 4], pt[BC / 4];
    ctile_dots(u, v, t, pe);
    ctile_dots(u, u, t, pt);
    S.write(k, 0, t, pe);
    S.write(k, 1, t, pt);
  }
  __device__ void update(float s, float c) {
#pragma unroll
    for (int q = 0; q < BC; ++q) u[q] = __fmul_rn(fmaf(s, a[1][q], a[0][q]), c);
  }
};

// rho_tile.cuh's 8 x 4 tile on the CTA's columns: warp w = b + RB gw (RB
// = D/32 row blocks), lane = gl + 4q; the CTA's column group tx = 4 gw +
// gl, rows 32 b + 4q + r and their twins (ty = 8 b + q). t.R counts the
// segment's columns from the CTA's first, c0.
template <int P>
struct QuadTile {
  RhoTile t;
  int b, RB, c0;
  float pc[4], ps[4];   // the twist on rows 4 ty + r
  float u[8][4];
  float a[3][8][4];

  __device__ QuadTile(const RhoLayout& L, int cta, const float* pcg,
                      const float* psg)
      : t(L.n / 2, L.R - cta * L.cwid) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    c0 = cta * L.cwid;
    RB = L.n / 64;
    b = warp % RB;
    t.tx = 4 * (warp / RB) + (lane & 3);
    t.ty = 8 * b + (lane >> 2);
    t.rs = L.sw;
    t.active = t.tx < L.ng;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pc[r] = t.active ? pcg[4 * t.ty + r] : 0.f;
      ps[r] = t.active ? psg[4 * t.ty + r] : 0.f;
    }
  }
  __device__ void load(const float* t0, size_t cols, size_t col0) {
    load_tile(u, t0, cols, col0 + c0, t);
  }
  __device__ void store(uint32_t* st) const { store_tile<P>(st, t, u); }
  __device__ void products(const uint32_t* const (&m)[3],
                           const uint32_t* st) {
    tile_products<P, 3>(m, st, t, a);
  }
  // The sum of x .* y over the 32 rows of the warp's block (h = 0) or of
  // its twins (h = 1) on the thread's group, as RowTile's warp adds it:
  // the quad's atoms in pairs, then xor shuffles over the 8 quads.
  __device__ float block_dot(const float (&x)[8][4], const float (&y)[8][4],
                             int h) const {
    float at[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (t.valid(c)) s = fmaf(x[4 * h + r][c], y[4 * h + r][c], s);
      at[r] = s;
    }
    float v = (at[0] + at[1]) + (at[2] + at[3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  __device__ void sums(const RhoSums& S, int k, float*, int, bool) const {
    float v[8][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[r][c] = twist(pc[r], a[2][r][c], ps[r], a[2][r + 4][c]);
        v[r + 4][c] = twist(pc[r], a[2][r + 4][c], -ps[r], a[2][r][c]);
      }
    const bool writer = (threadIdx.x & 31) < 4 && t.active;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e = block_dot(u, v, h), tr = block_dot(u, u, h);
      if (writer) {
        S.write_at(k, 0, b + h * RB, t.tx, e);
        S.write_at(k, 1, b + h * RB, t.tx, tr);
      }
    }
  }
  __device__ void update(float s, float c) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        u[r][q] = __fmul_rn(fmaf(s, a[1][r][q], a[0][r][q]), c);
  }
};

// QUAD: QuadTile, else RowTile of BC columns.
template <int P, int BC, bool QUAD>
__global__ void __launch_bounds__(QUAD ? kRhoQuadThreads : kRhoCtaThreads)
    rho_sample_kernel(const float* __restrict__ ab,
                      const float* __restrict__ bb,
                      const float* __restrict__ xs,
                      const float* __restrict__ pc,
                      const float* __restrict__ ps,
                      const float* __restrict__ t0,
                      const float* __restrict__ noise,
                      const float* __restrict__ inv_a_ptr,
                      float* __restrict__ wave, int D, int T, int N, int R,
                      float dt, float norm_eps, int C, int nbuf) {
  using Tile = std::conditional_t<QUAD, QuadTile<P>, RowTile<P, BC>>;
  extern __shared__ __align__(16) uint32_t smem[];
  const RhoLayout L(D, R, C);
  const int cta = blockIdx.x % C;   // the CTA's rank in its cluster
  const int chain = blockIdx.x / C;
  const int n = L.n;
  uint32_t* abt = smem;
  uint32_t* bbt = abt + n * n;
  uint32_t* xst = bbt + n * n;
  // state buffer b at st0 + b * bw, computed from smem each time (see
  // rho_fwd.cuh)
  uint32_t* const st0 = xst + n * n;
  const int bw = n * L.sw;
  const RhoSums sums(reinterpret_cast<float*>(st0 + nbuf * bw), L, 2, 0);
  const uint32_t* const fused[3] = {abt, bbt, xst};

  // offsets in size_t: T * N and 2D * N*R may pass 2^31
  const size_t stride = static_cast<size_t>(N);
  const size_t cols = static_cast<size_t>(N) * R;
  const size_t col0 = static_cast<size_t>(chain) * R;

  load_matrix_t<P>(abt, ab, n);
  load_matrix_t<P>(bbt, bb, n);
  load_matrix_t<P>(xst, xs, n);
  Tile tile(L, cta, pc, ps);
  tile.load(t0, cols, col0);
  tile.store(st0);
  __syncthreads();

  const float inv_a = *inv_a_ptr;
  float samp = 0.f;
  float c = 1.f;
  float nz = T > 0 ? noise[chain] : 0.f;
  int cur = 0;   // the buffer holding u_k
  for (int k = 0; k < T; ++k) {
    tile.products(fused, st0 + cur * bw);
    const int nxt = nbuf == 2 ? cur ^ 1 : cur;
    tile.sums(sums, k & 1, reinterpret_cast<float*>(st0 + nxt * bw), L.sw,
              nbuf == 1);
    float nz_next;
    if (C > 1) {
      cluster_arrive();  // the step's parts are written
      nz_next = k + 1 < T ? noise[(k + 1) * stride + chain] : 0.f;
      cluster_wait();
    } else {
      nz_next = k + 1 < T ? noise[(k + 1) * stride + chain] : 0.f;
      __syncthreads();  // the parts are written; every read of u_k is done
    }
    float tot[2];
    sums.warp_totals(k & 1, tot);
    if (k > 0) c = rsqrtf(floor_at(tot[1], norm_eps));
    const float inc = c * c * tot[0] * dt + nz;
    samp += inc;
    if (cta == 0 && threadIdx.x == 0) wave[k * stride + chain] = samp;
    tile.update(inc * inv_a, c);
    tile.store(st0 + nxt * bw);
    __syncthreads();  // buffer nxt holds u_{k+1}; the twist's reads are done
    cur = nxt;
    nz = nz_next;
  }
  if (C > 1) cluster_sync();  // no CTA leaves while another reads its sums
}

using RhoSampleFn = void (*)(const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             const float*, const float*, float*, int, int,
                             int, int, float, float, int, int);

// The sampler instance a launch at L takes.
template <int P>
RhoSampleFn rho_sample_kernel_for(const RhoLayout& L) {
  if (rho_sample_quad(L)) return rho_sample_kernel<P, 4, true>;
  switch (L.BC) {
    case 4:
      return rho_sample_kernel<P, 4, false>;
    case 8:
      return rho_sample_kernel<P, 8, false>;
    default:
      return rho_sample_kernel<P, 16, false>;
  }
}

// Clusters of C sampler CTAs (highest) the card holds at once; a negative
// cudaError_t when the query fails.
inline int rho_sample_max_clusters(int D, int R, int C) {
  if (!rho_cluster_ok(C, R)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      rho_sample_smem_bytes(D, R, C, rho_sample_buffers(D, R, C, smem_optin()));
  const RhoLayout L(D, R, C);
  return max_active_clusters(rho_sample_kernel_for<kHighest>(L),
                             rho_sample_threads(L), C, smem);
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one sampler CTA in clusters of C with nbuf
// state buffers (see rho_sample_words).
size_t amt_rho_sample_smem_bytes(int D, int R, int C, int nbuf) {
  return amt::rho_sample_smem_bytes(D, R, C, nbuf);
}

// The state buffers a sampler launch takes on the current card.
int amt_rho_sample_buffers(int D, int R, int C) {
  return amt::rho_sample_buffers(D, R, C, amt::smem_optin());
}

int amt_rho_sample_max_clusters(int D, int R, int C) {
  return amt::rho_sample_max_clusters(D, R, C);
}

// Running waveform wave[T, N] from noise[T, N] for N chains whose factors
// are t0[2D, N*R], in clusters of `cluster` CTAs a chain (dividing
// ceil(R/4)); see the kernel note above. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_rho_sample(const float* ab, const float* bb, const float* xs,
                   const float* pc, const float* ps, const float* t0,
                   const float* noise, const float* inv_a, float* wave, int D,
                   int T, int N, int R, float dt, float norm_eps,
                   int precision, int cluster, void* stream) {
  if (!amt::rho_cluster_ok(cluster, R))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const int nbuf = amt::rho_sample_buffers(D, R, cluster, amt::smem_optin());
  const amt::RhoLayout L(D, R, cluster);
  const size_t smem = amt::rho_sample_smem_bytes(D, R, cluster, nbuf);
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    return amt::launch_cluster(
        amt::rho_sample_kernel_for<decltype(p)::value>(L),
        dim3(N * cluster), amt::rho_sample_threads(L), cluster, false, smem,
        static_cast<cudaStream_t>(stream), ab, bb, xs, pc, ps, t0, noise,
        inv_a, wave, D, T, N, R, dt, norm_eps, cluster, nbuf);
  }));
}

}  // extern "C"
