// The three [2D,2D] parameter cotangents of the training adjoints, for
// Hopper: psi's, rho's and the rank partials'.
//
// Replaces the lane-contraction products that the TPU kernels compute in
// their own bodies (audio_mps_tpu/ops/pallas_block.py
// _make_psi_bwd_kernel_stream dotnt at :1035 and :1059-1060, rho's at
// :1583-1585, pallas_rank.py :356-358, accumulated over the grid). For
// lanes c (the state's columns) and steps k:
//   dAb = sum_k sum_c dy_kc t_kc^T     dBb = sum_k sum_c s_k,e(c) dy_kc t_kc^T
//   dRb = sum_k sum_c w_k,g(c) y_kc y_kc^T,   w = w_scale * dehat
// A lane's example e(c) = c / gs owns its increment s (gs = 1 for psi, the
// rank for rho and the rank partials); its group g(c) = c / gn owns its
// norm or trace and its dehat (gn = 1 for psi, the rank for rho, the chunk
// rc for the rank partials). t_0 = t0, and t_k = y_{k-1} * (renorm ?
// rsqrt(max(n2_{k-1}, eps)) : 1) with the forward's own instructions, so
// it equals the forward's state bit for bit.
//
// Precision (the TPU's dotnt): highest multiplies fp32 values on the FMA
// pipes (no TF32); high splits both operands into bf16 (hi, lo) and sums
// hi*hi + hi*lo + lo*hi; default rounds both to bf16 once. high and default
// run on the tensor cores (mma.sync m16n8k16 bf16, fp32 accumulate).
//
// Design. The K axis (steps x lanes) is walked in chunks of KC lanes of one
// step. Two kernels run one after the other, each over (output tile, split
// of the steps) CTAs:
//   - the pair kernel: dAb and dBb. For gs = 1 (psi) it keeps two
//     accumulators and stages dy and t once (s t is formed from the staged
//     t). For gs > 1 a chunk never crosses an example, and the CTA sums
//     P = sum dy t^T over an example's lanes of a step, then adds P to
//     dAb's accumulator and s P to dBb's (kept in shared memory, each
//     thread's own words): one product where psi needs two.
//   - the Gram kernel: dRb from y alone, on the tiles (or, in one tile, the
//     quarters) on and above the diagonal only (y y^T is symmetric; the last
//     pass mirrors them). A tile on the diagonal stages its rows once, as
//     both operands.
// Each chunk is copied global -> shared with cp.async (16-byte vectors when
// the lanes allow it, zero-filled past the tile and the chunk), kStages
// deep, with one barrier a chunk; the per-lane norm, s and dehat come in
// the same copy. While chunk g is multiplied, chunk g + 1 is rebuilt (t
// from y_{k-1}, w y) and chunk g + 2 is in flight.
//   - highest (KC = 16 for psi's pair kernel, else 32): each thread owns
//     an 8 x 8 register tile (4 x 4 to n = 64; rows ty + d r, columns
//     tx + d c, d threads an edge) and reads its operands as float4 along
//     the lanes (LDS.128; a row pitch of KC + 4 words puts eight rows on
//     distinct bank groups). Both kernels' tile is n itself up to n = 136,
//     else 128. The Gram kernel's single tile (n = 80 to 128, step 16)
//     gives its threads only the three quarters on and above the diagonal;
//     past n = 136 it runs the 128 x 128 tiles on and above the diagonal.
//   - high / default (KC = 16): the rebuild also rounds or splits each
//     operand once into bf16 buffers (double-buffered); each warp owns a
//     32 x 32 block (2 x 4 mma tiles), ldmatrix feeds the fragments, and
//     each chunk's products start from zero and are added to the fp32
//     accumulators with FADD, so the tensor cores never carry a long sum.
// Each CTA writes its partial tiles to a workspace; a last kernel sums the
// partials of each element in split order. The splits depend on n_steps
// and n alone, a lane's terms are summed in lane order whatever the other
// lanes are (a zero lane adds exact zeros), and nothing is atomic, so the
// result is the same on every run and for every batch around a lane.
//
// What bounds it: 2 n^2 FLOPs a product a lane-step (n = 2D; three
// products for psi, two for rho and the rank partials) on the fp32 FMA
// pipes at highest, against the dy and y streams read once. An 8 x 8 tile
// reads 16 floats from shared memory for 64 FMAs; on Hopper (128 FMAs and
// 128 shared-memory bytes a clock an SM) that is at the shared-memory
// limit, so these kernels run at about half the FMA peak.
#include "common.cuh"

#include <algorithm>
#include <cstdint>

namespace amt {
namespace {

constexpr int kKcMma = 16;         // lanes a chunk, high / default
constexpr int kStages = 3;         // cp.async stages
constexpr int kHPitch = kKcMma + 8;  // bf16 row pitch, elements (48 bytes)
constexpr int kBigTile = 128;      // the tile past a single-tile n
constexpr int kMaxOneTile = 136;   // the largest n one pair tile covers

// staged fp32 row pitch, words
__host__ __device__ constexpr int pitch(int kc) { return kc + 4; }

enum Job { kPair = 0, kGrouped = 1, kGram = 2 };

struct CotParams {
  const float* dys;
  const float* ys;
  const float* t0;
  const float* se;
  const float* n2s;
  const float* dehats;
  float* partial;
  int n, n_steps, L, gs, gn, n_ex, n_groups, unroll, defer, vec, quarters;
  float norm_eps, w_scale;
  // this kernel's tiling, split and walk; its slots start at slot_base
  int tile, tiles, nsplit, per_step, cpe;
  size_t slot_base;
};

// The tile edge of both kernels at highest (the splits are fixed by it, so
// by n alone).
inline int fp32_tile(int n) {
  return n <= 64 ? (n + 3) / 4 * 4
                 : n <= kMaxOneTile ? (n + 7) / 8 * 8 : kBigTile;
}
inline int edge_tiles(int n, int tile) { return (n + tile - 1) / tile; }
// Whether the Gram kernel's single tile runs as its three quarters on and
// above the diagonal (8 x 8 register tiles, an edge a multiple of 16).
inline bool gram_quarters(int n) {
  return n > 64 && n <= kMaxOneTile && fp32_tile(n) % 16 == 0;
}

// Steps a CTA's split: the pair kernel aims at 264 CTAs (two waves of one
// CTA an SM on 132 SMs) or, past one tile, 528; the Gram kernel the same
// for one tile, else its tiles on and above the diagonal at 132 (one wave).
inline int split_pair(int n, int n_steps) {
  const int t = edge_tiles(n, fp32_tile(n));
  const int want = t == 1 ? 264 : std::max(1, 528 / (t * t));
  return n_steps < 1 ? 1 : std::min(n_steps, want);
}
inline int split_gram(int n, int n_steps) {
  const int t = edge_tiles(n, fp32_tile(n));
  const int want = t == 1 ? 264 : std::max(1, 132 / (t * (t + 1) / 2));
  return n_steps < 1 ? 1 : std::min(n_steps, want);
}

// 4 bytes global -> shared; bytes = 0 writes a zero.
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

struct Chunk {
  int k, c0, m;
  bool flush;  // the last chunk of an example's lanes (pair kernel, gs > 1)
};

// Chunk g of the walk: step g / per_step, then KC lanes at a time over the
// step's lanes, or, when GROUPED, over each example's gs lanes in turn.
template <int KC, bool GROUPED>
__device__ __forceinline__ Chunk decode(const CotParams& p, int g) {
  Chunk ch;
  ch.k = g / p.per_step;
  const int q = g - ch.k * p.per_step;
  if (GROUPED) {
    const int e = q / p.cpe, j = q - e * p.cpe;
    ch.c0 = e * p.gs + j * KC;
    ch.m = min(KC, p.gs - j * KC);
    ch.flush = j == p.cpe - 1;
  } else {
    ch.c0 = q * KC;
    ch.m = min(KC, p.L - ch.c0);
    ch.flush = false;
  }
  return ch;
}

// Whether t_k is y_{k-1} rescaled (else y_{k-1} itself, or t0 at k = 0).
__device__ __forceinline__ bool renorms(const CotParams& p, int k) {
  return k > 0 && (!p.defer || k % p.unroll == 0);
}

// This CTA's output tile: the pair kernel's of the whole grid, the Gram
// kernel's of those with ti <= tj, in row order.
template <int J>
__device__ __forceinline__ void tile_of(const CotParams& p, int& ti,
                                        int& tj) {
  if (J == kGram) {
    int b = blockIdx.x;
    ti = 0;
    while (b >= p.tiles - ti) {
      b -= p.tiles - ti;
      ++ti;
    }
    tj = ti + b;
  } else {
    ti = blockIdx.x / p.tiles;
    tj = blockIdx.x % p.tiles;
  }
}

// A stage: X [T][KC + 4] (dy, or y at rows i0.. for the Gram kernel),
// Y [T][KC + 4] (y_{k-1}, or y at rows j0..), then the chunk's per-lane raw
// norm and s (pair kernel) or dehat (Gram kernel).
template <int KC>
__host__ __device__ constexpr int stage_floats(int T) {
  return 2 * T * pitch(KC) + 2 * KC;
}

// Issue the cp.async copies of chunk g into stage st.
template <int J, int KC>
__device__ __forceinline__ void issue(const CotParams& p, float* st, int T,
                                      int i0, int j0, bool diag, int g) {
  constexpr int kP = pitch(KC), kVec = KC / 4;
  const Chunk ch = decode<KC, J == kGrouped>(p, g);
  const size_t plane = static_cast<size_t>(p.n) * p.L;
  const float* xs;
  const float* ysrc;
  if (J == kGram) {
    xs = p.ys + ch.k * plane;
    ysrc = xs;
  } else {
    xs = p.dys + ch.k * plane;
    ysrc = ch.k > 0 ? p.ys + (ch.k - 1) * plane : p.t0;
  }
  float* X = st;
  float* Y = st + T * kP;
  float* sn2 = st + 2 * T * kP;
  float* sv = sn2 + KC;
  const bool loadx = !(J == kGram && diag);
  if (p.vec) {
    for (int it = threadIdx.x; it < T * kVec; it += blockDim.x) {
      const int r = it / kVec, l = (it % kVec) * 4;
      const int bytes = 4 * max(0, min(4, ch.m - l));
      const int ri = i0 + r, rj = j0 + r;
      if (loadx)
        cp16(X + r * kP + l,
             ri < p.n ? xs + static_cast<size_t>(ri) * p.L + ch.c0 + l : xs,
             ri < p.n ? bytes : 0);
      cp16(Y + r * kP + l,
           rj < p.n ? ysrc + static_cast<size_t>(rj) * p.L + ch.c0 + l : ysrc,
           rj < p.n ? bytes : 0);
    }
  } else {
    for (int it = threadIdx.x; it < T * KC; it += blockDim.x) {
      const int r = it / KC, l = it - r * KC;
      const bool lane_ok = l < ch.m;
      const int ri = i0 + r, rj = j0 + r;
      if (loadx) {
        const bool ok = lane_ok && ri < p.n;
        cp4(X + r * kP + l,
            ok ? xs + static_cast<size_t>(ri) * p.L + ch.c0 + l : xs,
            ok ? 4 : 0);
      }
      const bool ok = lane_ok && rj < p.n;
      cp4(Y + r * kP + l,
          ok ? ysrc + static_cast<size_t>(rj) * p.L + ch.c0 + l : ysrc,
          ok ? 4 : 0);
    }
  }
  for (int l = threadIdx.x; l < KC; l += blockDim.x) {
    if (l < ch.m) {
      const int c = ch.c0 + l;
      if (J == kGram) {
        cp4(sv + l,
            p.dehats + static_cast<size_t>(ch.k) * p.n_groups + c / p.gn, 4);
      } else {
        cp4(sv + l, p.se + static_cast<size_t>(ch.k) * p.n_ex + c / p.gs, 4);
        if (renorms(p, ch.k))
          cp4(sn2 + l,
              p.n2s + static_cast<size_t>(ch.k - 1) * p.n_groups + c / p.gn,
              4);
      }
    } else {
      sv[l] = 0.f;
      sn2[l] = 1.f;
    }
  }
}

// The forward's rescale of four lanes of y_{k-1}.
__device__ __forceinline__ float4 rescale(float4 y, float4 n2, float eps) {
  y.x = y.x * rsqrtf(floor_at(n2.x, eps));
  y.y = y.y * rsqrtf(floor_at(n2.y, eps));
  y.z = y.z * rsqrtf(floor_at(n2.z, eps));
  y.w = y.w * rsqrtf(floor_at(n2.w, eps));
  return y;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// w = w_scale * dehat for four lanes (psi's 2 dehat, as its plain version
// forms it first).
__device__ __forceinline__ float4 weights4(const CotParams& p, float4 d) {
  return make_float4(p.w_scale * d.x, p.w_scale * d.y, p.w_scale * d.z,
                     p.w_scale * d.w);
}

// The pipeline both families share: chunks [g_lo, g_hi) copied kStages deep,
// each rebuilt one chunk ahead of its product, one barrier a chunk.
// rebuild(stage, g - g_lo, g) and compute(stage, g - g_lo, g) are the
// family's.
template <int J, int KC, typename Rebuild, typename Compute>
__device__ __forceinline__ void walk(const CotParams& p, float* sm, int T,
                                     int i0, int j0, bool diag, int g_lo,
                                     int g_hi, Rebuild&& rebuild,
                                     Compute&& compute) {
  const int stage = stage_floats<KC>(T);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (g_lo + s < g_hi)
      issue<J, KC>(p, sm + s * stage, T, i0, j0, diag, g_lo + s);
    cp_commit();
  }
  cp_wait<kStages - 2>();
  __syncthreads();
  if (g_lo < g_hi) rebuild(sm, 0, g_lo);
  for (int g = g_lo; g < g_hi; ++g) {
    cp_wait<kStages - 3>();
    __syncthreads();  // chunk g rebuilt, g + 1 landed, g - 1's stage free
    const int gi = g + kStages - 1;
    if (gi < g_hi)
      issue<J, KC>(p, sm + ((gi - g_lo) % kStages) * stage, T, i0, j0, diag,
                   gi);
    cp_commit();
    if (g + 1 < g_hi)
      rebuild(sm + ((g + 1 - g_lo) % kStages) * stage, g + 1 - g_lo, g + 1);
    compute(sm + ((g - g_lo) % kStages) * stage, g - g_lo, g);
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// highest: fp32 FMA, a TT x TT register tile a thread
// ---------------------------------------------------------------------------

// Rebuild chunk g's operands in place: t = y_{k-1} rescaled (pair
// kernels), w y into X (Gram).
template <int J, int KC>
__device__ __forceinline__ void rebuild_fp32(const CotParams& p, float* st,
                                             int T, bool diag, int g) {
  constexpr int kVec = KC / 4, kP4 = pitch(KC) / 4;
  const Chunk ch = decode<KC, J == kGrouped>(p, g);
  if (J != kGram && !renorms(p, ch.k)) return;
  float4* X4 = reinterpret_cast<float4*>(st);
  float4* Y4 = X4 + T * kP4;
  const float4* sn2 = reinterpret_cast<const float4*>(st + 2 * T * pitch(KC));
  const float4* sv = sn2 + kVec;
  for (int it = threadIdx.x; it < T * kVec; it += blockDim.x) {
    const int v = it % kVec, at = (it / kVec) * kP4 + v;
    if (J == kGram)
      X4[at] = mul4(weights4(p, sv[v]), diag ? Y4[at] : X4[at]);
    else
      Y4[at] = rescale(Y4[at], sn2[v], p.norm_eps);
  }
}

// o += the four lanes of a * b, in lane order.
__device__ __forceinline__ void fma4(float& o, float4 a, float4 b) {
  o = fmaf(a.x, b.x, o);
  o = fmaf(a.y, b.y, o);
  o = fmaf(a.z, b.z, o);
  o = fmaf(a.w, b.w, o);
}

// MAXT: the most threads a launch takes, MINB the CTAs an SM the register
// budget leaves room for (256 threads up to a 128 x 128 tile, 289 for the
// 136 x 136 one; two CTAs of the Gram kernel's quartered tile). KC: the
// lanes a chunk (see launch_job).
template <int J, int TT, int MAXT, int MINB, int KC>
__global__ void __launch_bounds__(MAXT, MINB)
    cot_fp32_kernel(const CotParams p) {
  constexpr int kP4 = pitch(KC) / 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = p.tile, nt = blockDim.x;
  int ti, tj;
  tile_of<J>(p, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  // the thread's rows (oi + ty + d r) and columns (oj + tx + d c) of the
  // tile, or of its quarter (0, 0), (0, T/2) or (T/2, T/2)
  int d = T / TT, tid = threadIdx.x, oi = 0, oj = 0;
  if (J == kGram && p.quarters) {
    d = T / (2 * TT);
    const int q = tid / (d * d);
    tid -= q * d * d;
    oi = q == 2 ? T / 2 : 0;
    oj = q == 0 ? 0 : T / 2;
  }
  const int tx = tid % d, ty = tid / d;
  const bool diag = ti == tj;
  const int split = blockIdx.y;
  const int k_lo = static_cast<int>(static_cast<long long>(p.n_steps) *
                                    split / p.nsplit);
  const int k_hi = static_cast<int>(static_cast<long long>(p.n_steps) *
                                    (split + 1) / p.nsplit);
  // kGrouped: dBb's accumulator, each thread's TT*TT/4 float4s at a stride
  // of nt (its own words)
  float4* acc_b =
      smem4 + kStages * stage_floats<KC>(T) / 4 + threadIdx.x;

  float acc[TT][TT], acc2[TT][TT];  // dAb; dBb (kPair) or P (kGrouped)
#pragma unroll
  for (int r = 0; r < TT; ++r)
#pragma unroll
    for (int c = 0; c < TT; ++c) acc[r][c] = acc2[r][c] = 0.f;
  if (J == kGrouped)
#pragma unroll
    for (int e = 0; e < TT * TT / 4; ++e)
      acc_b[e * nt] = make_float4(0.f, 0.f, 0.f, 0.f);

  auto rebuild = [&](float* st, int, int g) {
    rebuild_fp32<J, KC>(p, st, T, diag, g);
  };
  auto compute = [&](const float* st, int, int g) {
    const float4* xa = reinterpret_cast<const float4*>(st) + (oi + ty) * kP4;
    const float4* yb =
        reinterpret_cast<const float4*>(st) + (T + oj + tx) * kP4;
    const float4* s4 =
        reinterpret_cast<const float4*>(st + 2 * T * pitch(KC) + KC);
    const int step = d * kP4;
#pragma unroll
    for (int kq = 0; kq < KC / 4; ++kq) {
      float4 a[TT];
#pragma unroll
      for (int r = 0; r < TT; ++r) a[r] = xa[r * step + kq];
      float4 s;
      if constexpr (J == kPair) s = s4[kq];
#pragma unroll
      for (int c = 0; c < TT; ++c) {
        const float4 b = yb[c * step + kq];
        if constexpr (J == kGrouped) {
#pragma unroll
          for (int r = 0; r < TT; ++r) fma4(acc2[r][c], a[r], b);
        } else {
#pragma unroll
          for (int r = 0; r < TT; ++r) fma4(acc[r][c], a[r], b);
        }
        if constexpr (J == kPair) {
          const float4 b2 = mul4(s, b);  // s t, as the plain version forms it
#pragma unroll
          for (int r = 0; r < TT; ++r) fma4(acc2[r][c], a[r], b2);
        }
      }
    }
    if (J == kGrouped && decode<KC, true>(p, g).flush) {
      const float s = st[2 * T * pitch(KC) + KC];  // the example's s
#pragma unroll
      for (int e = 0; e < TT * TT / 4; ++e) {
        float4 q = acc_b[e * nt];
        q.x = fmaf(s, acc2[(4 * e) / TT][(4 * e) % TT], q.x);
        q.y = fmaf(s, acc2[(4 * e + 1) / TT][(4 * e + 1) % TT], q.y);
        q.z = fmaf(s, acc2[(4 * e + 2) / TT][(4 * e + 2) % TT], q.z);
        q.w = fmaf(s, acc2[(4 * e + 3) / TT][(4 * e + 3) % TT], q.w);
        acc_b[e * nt] = q;
      }
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int c = 0; c < TT; ++c) {
          acc[r][c] += acc2[r][c];
          acc2[r][c] = 0.f;
        }
    }
  };
  walk<J, KC>(p, sm, T, i0, j0, diag, k_lo * p.per_step, k_hi * p.per_step,
              rebuild, compute);

  const size_t nn = static_cast<size_t>(p.n) * p.n;
  float* out0 = p.partial + p.slot_base + split * nn;
  float* out1 = out0 + p.nsplit * nn;
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const int i = i0 + oi + ty + d * r;
#pragma unroll
    for (int c = 0; c < TT; ++c) {
      const int j = j0 + oj + tx + d * c;
      if (i >= p.n || j >= p.n) continue;
      const size_t at = static_cast<size_t>(i) * p.n + j;
      out0[at] = acc[r][c];
      if (J == kPair) out1[at] = acc2[r][c];
      if (J == kGrouped) {
        const int e = r * TT + c;
        const float4 q = acc_b[(e / 4) * nt];
        out1[at] = (e & 3) == 0 ? q.x : (e & 3) == 1 ? q.y
                                      : (e & 3) == 2 ? q.z : q.w;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// high / default: bf16 mma.sync with fp32 accumulators, 32 x 32 a warp
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float lo_half, float hi_half) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four lanes of one operand row into its bf16 buffers: the rounding
// (default) or the (hi, lo) split (high) of each value, formed once.
template <int P>
__device__ __forceinline__ void put_bf16(__nv_bfloat16* hi, __nv_bfloat16* lo,
                                         int at, float4 x) {
  const float h[4] = {bf16_round(x.x), bf16_round(x.y), bf16_round(x.z),
                      bf16_round(x.w)};
  *reinterpret_cast<uint2*>(hi + at) =
      make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
  if (P == kHigh)
    *reinterpret_cast<uint2*>(lo + at) =
        make_uint2(pack2(x.x - h[0], x.y - h[1]),
                   pack2(x.z - h[2], x.w - h[3]));
}

// Operand buffers of one chunk: A, B, and B2 = s t for psi's pair, each a
// hi part [T][kHPitch] and, at high, a lo part.
template <int J, int P>
struct Bufs {
  static constexpr int kOps = J == kPair ? 3 : 2;
  static constexpr int kParts = P == kHigh ? 2 : 1;
  __nv_bfloat16* base;
  int T;
  __device__ __nv_bfloat16* part(int op, int lo) const {
    return base + static_cast<size_t>(op * kParts + lo) * T * kHPitch;
  }
  static __host__ __device__ int elems(int T) {
    return kOps * kParts * T * kHPitch;
  }
};

template <int J, int P>
__device__ __forceinline__ void rebuild_bf16(const CotParams& p,
                                             const float* st, Bufs<J, P> b,
                                             int T, bool diag, int g) {
  constexpr int KC = kKcMma, kVec = KC / 4, kP4 = pitch(KC) / 4;
  const Chunk ch = decode<KC, J == kGrouped>(p, g);
  const bool scale = J != kGram && renorms(p, ch.k);
  const float4* X4 = reinterpret_cast<const float4*>(st);
  const float4* Y4 = X4 + T * kP4;
  const float4* sn2 =
      reinterpret_cast<const float4*>(st + 2 * T * pitch(KC));
  const float4* sv = sn2 + kVec;
  for (int it = threadIdx.x; it < T * kVec; it += blockDim.x) {
    const int r = it / kVec, v = it % kVec;
    const int at = r * kP4 + v, to = r * kHPitch + 4 * v;
    const float4 y = Y4[at];
    if (J == kGram) {
      put_bf16<P>(b.part(0, 0), b.part(0, 1), to,
                  mul4(weights4(p, sv[v]), diag ? y : X4[at]));
      put_bf16<P>(b.part(1, 0), b.part(1, 1), to, y);
    } else {
      const float4 t = scale ? rescale(y, sn2[v], p.norm_eps) : y;
      put_bf16<P>(b.part(0, 0), b.part(0, 1), to, X4[at]);
      put_bf16<P>(b.part(1, 0), b.part(1, 1), to, t);
      if (J == kPair)
        put_bf16<P>(b.part(2, 0), b.part(2, 1), to, mul4(sv[v], t));
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dst[mt][nt] += this chunk's product of the A fragments with one B
// operand (hi*hi, then hi*lo and lo*hi at high), started from zero.
template <int P>
__device__ __forceinline__ void chunk_product(
    float (&dst)[2][4][4], const uint32_t (&ah)[2][4],
    const uint32_t (&al)[2][4], const __nv_bfloat16* bh,
    const __nv_bfloat16* bl, int boff) {
  uint32_t fh[4][2], fl[4][2];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldmatrix_x4(r, bh + boff + np * 16 * kHPitch);
    fh[2 * np][0] = r[0];
    fh[2 * np][1] = r[1];
    fh[2 * np + 1][0] = r[2];
    fh[2 * np + 1][1] = r[3];
    if (P == kHigh) {
      ldmatrix_x4(r, bl + boff + np * 16 * kHPitch);
      fl[2 * np][0] = r[0];
      fl[2 * np][1] = r[1];
      fl[2 * np + 1][0] = r[2];
      fl[2 * np + 1][1] = r[3];
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(c, ah[mt], fh[nt][0], fh[nt][1]);
      if (P == kHigh) {
        mma_bf16(c, ah[mt], fl[nt][0], fl[nt][1]);
        mma_bf16(c, al[mt], fh[nt][0], fh[nt][1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[mt][nt][q] += c[q];
    }
}

template <int J, int P>
__global__ void __launch_bounds__(512, 1) cot_mma_kernel(const CotParams p) {
  constexpr int KC = kKcMma;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int T = p.tile, nt = blockDim.x;
  int ti, tj;
  tile_of<J>(p, ti, tj);
  const int i0 = ti * T, j0 = tj * T;
  const bool diag = ti == tj;
  const int split = blockIdx.y;
  const int k_lo = static_cast<int>(static_cast<long long>(p.n_steps) *
                                    split / p.nsplit);
  const int k_hi = static_cast<int>(static_cast<long long>(p.n_steps) *
                                    (split + 1) / p.nsplit);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wd = T / 32, wr = warp / wd, wc = warp % wd;
  __nv_bfloat16* hbase = reinterpret_cast<__nv_bfloat16*>(
      sm + kStages * stage_floats<KC>(T));
  const int belems = Bufs<J, P>::elems(T);
  float4* acc_b = reinterpret_cast<float4*>(hbase + 2 * belems) + threadIdx.x;
  // ldmatrix row offsets: A rows (lane & 15) at column (lane >> 4) * 8; B
  // rows ((lane >> 4) << 3) + (lane & 7) at column ((lane >> 3) & 1) * 8
  const int aoff = (wr * 32 + (lane & 15)) * kHPitch + (lane >> 4) * 8;
  const int boff = (wc * 32 + ((lane >> 4) << 3) + (lane & 7)) * kHPitch +
                   ((lane >> 3) & 1) * 8;

  float acc[2][4][4], acc2[2][4][4];  // dAb; dBb (kPair) or P (kGrouped)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][t][q] = acc2[mt][t][q] = 0.f;
  if (J == kGrouped)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc_b[e * nt] = make_float4(0.f, 0.f, 0.f, 0.f);

  auto rebuild = [&](float* st, int rel, int g) {
    rebuild_bf16<J, P>(p, st, Bufs<J, P>{hbase + (rel & 1) * belems, T}, T,
                       diag, g);
  };
  auto compute = [&](const float* st, int rel, int g) {
    const Bufs<J, P> b{hbase + (rel & 1) * belems, T};
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldmatrix_x4(ah[mt], b.part(0, 0) + aoff + mt * 16 * kHPitch);
      if (P == kHigh)
        ldmatrix_x4(al[mt], b.part(0, 1) + aoff + mt * 16 * kHPitch);
    }
    if constexpr (J == kGrouped)
      chunk_product<P>(acc2, ah, al, b.part(1, 0), b.part(1, 1), boff);
    else
      chunk_product<P>(acc, ah, al, b.part(1, 0), b.part(1, 1), boff);
    if constexpr (J == kPair)
      chunk_product<P>(acc2, ah, al, b.part(2, 0), b.part(2, 1), boff);
    if (J == kGrouped && decode<KC, true>(p, g).flush) {
      const float s = st[2 * T * pitch(KC) + KC];  // the example's s
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float4 q = acc_b[e * nt];
        const float* pe = acc2[e >> 2][e & 3];
        q.x = fmaf(s, pe[0], q.x);
        q.y = fmaf(s, pe[1], q.y);
        q.z = fmaf(s, pe[2], q.z);
        q.w = fmaf(s, pe[3], q.w);
        acc_b[e * nt] = q;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[mt][t][q] += acc2[mt][t][q];
            acc2[mt][t][q] = 0.f;
          }
    }
  };
  walk<J, KC>(p, sm, T, i0, j0, diag, k_lo * p.per_step, k_hi * p.per_step,
              rebuild, compute);

  const size_t nn = static_cast<size_t>(p.n) * p.n;
  float* out0 = p.partial + p.slot_base + split * nn;
  float* out1 = out0 + p.nsplit * nn;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float4 qb = make_float4(0.f, 0.f, 0.f, 0.f);
      if (J == kGrouped) qb = acc_b[(mt * 4 + t) * nt];
      const float vb[4] = {qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + wr * 32 + mt * 16 + (lane >> 2) + (q >> 1) * 8;
        const int j = j0 + wc * 32 + t * 8 + (lane & 3) * 2 + (q & 1);
        if (i >= p.n || j >= p.n) continue;
        const size_t at = static_cast<size_t>(i) * p.n + j;
        out0[at] = acc[mt][t][q];
        if (J == kPair) out1[at] = acc2[mt][t][q];
        if (J == kGrouped) out1[at] = vb[q];
      }
    }
}

// out[slot][i][j] = sum over splits, in split order, of the slot's partials:
// dAb and dBb over the pair kernel's splits; dRb over the Gram kernel's,
// read at (j, i) where (i, j) lies below the diagonal tiles it computed.
__global__ void cot_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int n,
                                  int split_p, int split_g, int gtile) {
  const int nn = n * n;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int slot = blockIdx.y;
  if (e >= nn) return;
  const int i = e / n, j = e - i * n;
  const int src = slot == 2 && i / gtile > j / gtile ? j * n + i : e;
  const int nsplit = slot == 2 ? split_g : split_p;
  const float* p = partial + static_cast<size_t>(slot) * split_p * nn + src;
  float s = 0.f;
  for (int q = 0; q < nsplit; ++q) s += p[static_cast<size_t>(q) * nn];
  out[static_cast<size_t>(slot) * nn + e] = s;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The walk of the pair kernel (grouped or not) or of the Gram kernel.
void set_walk(CotParams& p, int job, int kc) {
  if (job == kGrouped) {
    p.cpe = (p.gs + kc - 1) / kc;
    p.per_step = p.n_ex * p.cpe;
  } else {
    p.cpe = 1;
    p.per_step = (p.L + kc - 1) / kc;
  }
}

// Tiles (all, or those on and above the diagonal for the Gram kernel),
// split and slots of one job's launch.
void set_job(CotParams& p, int job, int tile, int kc) {
  p.tile = tile;
  p.tiles = edge_tiles(p.n, tile);
  const size_t nn = static_cast<size_t>(p.n) * p.n;
  const int sp = split_pair(p.n, p.n_steps);
  p.nsplit = job == kGram ? split_gram(p.n, p.n_steps) : sp;
  p.slot_base = job == kGram ? 2 * static_cast<size_t>(sp) * nn : 0;
  set_walk(p, job, kc);
}

inline int job_ctas(const CotParams& p, int job) {
  return job == kGram ? p.tiles * (p.tiles + 1) / 2 : p.tiles * p.tiles;
}

template <int J, int TT, int MAXT, int MINB, int KC>
cudaError_t launch_fp32(CotParams p, cudaStream_t stream) {
  set_job(p, J, fp32_tile(p.n), KC);
  p.quarters = J == kGram && gram_quarters(p.n);
  const int half = p.tile / (2 * TT);
  const int threads = p.quarters ? 3 * half * half
                                 : (p.tile / TT) * (p.tile / TT);
  size_t smem =
      sizeof(float) * kStages * static_cast<size_t>(stage_floats<KC>(p.tile));
  if (J == kGrouped) smem += sizeof(float) * TT * TT * threads;
  return launch_smem(cot_fp32_kernel<J, TT, MAXT, MINB, KC>,
                     dim3(job_ctas(p, J), p.nsplit), threads, smem, stream, p);
}

template <int J, int P>
cudaError_t launch_mma(CotParams p, cudaStream_t stream) {
  set_job(p, J, p.n <= kBigTile ? (p.n + 31) / 32 * 32 : kBigTile, kKcMma);
  const int threads = (p.tile / 32) * (p.tile / 32) * 32;
  size_t smem = sizeof(float) * kStages *
                    static_cast<size_t>(stage_floats<kKcMma>(p.tile)) +
                sizeof(__nv_bfloat16) * 2 *
                    static_cast<size_t>(Bufs<J, P>::elems(p.tile));
  if (J == kGrouped) smem += sizeof(float) * 32 * threads;
  return launch_smem(cot_mma_kernel<J, P>, dim3(job_ctas(p, J), p.nsplit),
                     threads, smem, stream, p);
}

// highest: psi's pair kernel walks 16 lanes a chunk (its two accumulators
// leave no registers to spare for longer unrolled chunks), the others 32
// (half the barriers and rebuilds), as timing both widths on an H100 chose.
template <int J, int P>
cudaError_t launch_job(const CotParams& p, cudaStream_t stream) {
  if constexpr (P == kHighest) {
    constexpr int KC = J == kPair ? 16 : 32;
    const int tile = fp32_tile(p.n);
    if (tile <= 64) return launch_fp32<J, 4, 256, 1, KC>(p, stream);
    if constexpr (J == kGram) {
      if (gram_quarters(p.n)) return launch_fp32<J, 8, 256, 2, KC>(p, stream);
    }
    if (tile <= kBigTile) return launch_fp32<J, 8, 256, 1, KC>(p, stream);
    return launch_fp32<J, 8, 289, 1, KC>(p, stream);
  } else {
    return launch_mma<J, P>(p, stream);
  }
}

template <int P>
cudaError_t launch_cotangents(CotParams p, float* out, cudaStream_t stream) {
  const bool vec = p.L % 4 == 0 && aligned16(p.dys) && aligned16(p.ys) &&
                   aligned16(p.t0);
  p.vec = vec && (p.gs == 1 || p.gs % 4 == 0);
  cudaError_t err = p.gs > 1 ? launch_job<kGrouped, P>(p, stream)
                             : launch_job<kPair, P>(p, stream);
  if (err != cudaSuccess) return err;
  p.vec = vec;
  err = launch_job<kGram, P>(p, stream);
  if (err != cudaSuccess) return err;
  const int nn = p.n * p.n;
  const int gtile = P != kHighest ? (p.n <= kBigTile ? p.n : kBigTile)
                    : gram_quarters(p.n) ? fp32_tile(p.n) / 2 : fp32_tile(p.n);
  cot_reduce_kernel<<<dim3((nn + 255) / 256, 3), 256, 0, stream>>>(
      p.partial, out, p.n, split_pair(p.n, p.n_steps),
      split_gram(p.n, p.n_steps), gtile);
  return cudaGetLastError();
}

}  // namespace
}  // namespace amt

extern "C" {

// Floats of the workspace: the pair kernel's 2 slots x its splits and the
// Gram kernel's slot x its splits, each (2D)^2.
size_t amt_psi_cotangents_workspace_floats(int D, int n_steps) {
  const int n = 2 * D;
  return (2 * static_cast<size_t>(amt::split_pair(n, n_steps)) +
          amt::split_gram(n, n_steps)) *
         static_cast<size_t>(n) * n;
}

// out[3, 2D, 2D] = (dAb, dBb, dRb) from dys/ys [n_steps, 2D, L], t0 [2D, L],
// se [n_steps, L / gs] (one s an example of gs lanes), n2s and dehats
// [n_steps, L / gn] (one norm or trace and one dehat a group of gn lanes);
// dRb weighs each lane by w_scale * dehat. partial holds
// amt_psi_cotangents_workspace_floats floats. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_psi_cotangents(const float* dys, const float* ys, const float* t0,
                       const float* se, const float* n2s, const float* dehats,
                       float* partial, float* out, int D, int n_steps, int L,
                       int gs, int gn, int unroll, float norm_eps,
                       float w_scale, int precision, int defer_norm,
                       void* stream) {
  if (D < 1 || L < 1 || gs < 1 || gn < 1 || L % gs || L % gn || unroll < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  amt::CotParams p{};
  p.dys = dys;
  p.ys = ys;
  p.t0 = t0;
  p.se = se;
  p.n2s = n2s;
  p.dehats = dehats;
  p.partial = partial;
  p.n = 2 * D;
  p.n_steps = n_steps;
  p.L = L;
  p.gs = gs;
  p.gn = gn;
  p.n_ex = L / gs;
  p.n_groups = L / gn;
  p.unroll = unroll;
  p.defer = defer_norm != 0;
  p.norm_eps = norm_eps;
  p.w_scale = w_scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto pc) {
    return amt::launch_cotangents<decltype(pc)::value>(p, out, s);
  }));
}

}  // extern "C"
