// The psi forward chain in the split layout for Hopper, shared by the
// forward-only NLL (psi_split_nll.cu, kNll) and the training forward with
// block checkpoints (psi_split_fwd.cu, kCkpt), with the complex products
// that the split sampler (psi_split_sample.cu) and adjoint
// (psi_split_bwd.cu) use too, and the loss ring that rho's forward
// template (rho_split_fwd.cuh) shares.
//
// Replaces, with its two modes, the TPU kernels
// audio_mps_tpu/ops/pallas_scan.py _make_psi_nll_kernel (via psi_nll_pallas)
// and audio_mps_tpu/ops/pallas_grad.py _make_psi_fwd_kernel (via
// _psi_fused_nll_factory). The split layout keeps the state as real and
// imaginary columns pr, pi ([D] per example) and the constants C, R as
// real pairs [D,D], and does not fold the frame rotation into them. One
// step, with s the increment / A:
//   y  = C psi + s R psi                      (four real products each)
//   e  = 2 sum(y_r (R y)_r + y_i (R y)_i),  n2 = |y|^2   (column sums)
//   per-step norm:  loss -= log(max(1 + e s, log_eps));
//                   psi = conj(p) .* (y rsqrt(max(n2, eps)))
//   deferred norm:  e /= max(n2_prev, eps); the same loss;
//                   psi = conj(p) .* y, n2_prev = n2, and at every
//                   unroll-th step psi *= rsqrt(max(n2, eps)), n2_prev = 1:
//                   where the TPU kernel renormalises at its block exits.
// kCkpt also writes ckr, cki [n_blocks, D, B], the state entering each
// unroll-step block (normalised in both modes, pallas_grad.py:132-135); the
// adjoint re-runs each block from it.
//
// Design. On the TPU the grid walks time blocks and scratch carries the
// state; here each example is independent, so one CTA owns one example's
// column and loops over all steps, thread i on row i (D threads rounded up
// to a warp, the rows past D idle; D need not be a multiple of anything).
// C and R sit in shared memory transposed and packed four to an element,
// (C_r, C_i, R_r, R_i) at [j * D + i]. A step is one walk and one barrier,
// as the adjoint's re-run role (psi_split_bwd.cu): step k forms C x_k,
// R x_k and, for step k-1, R y_{k-1} in one walk over j (cdot3 on the
// packed operands: two 16-byte loads a j, twelve dots in flight), from a
// double buffer of the prepped (x_k, y_{k-1}) that the step before wrote;
// it then writes x_{k+1} and y_k to the other half and synchronises once
// (a warp barrier at D <= 32, one CTA barrier past it). The last step's
// R y is an epilogue walk. Under the deferred norm no sum feeds the next
// step inside a block, so a step leaves its parts of ehat and |y|^2 in the
// loss ring (LossRing below) and the sums and loss terms are taken at a
// flush: at the block's end, where the renormalisation's |y|^2 is the only
// sum on the chain, and at least every kRingSlots - 2 steps. The per-step
// norm keeps |y|^2 on the chain (normalise, then rotate, as the TPU does)
// and takes the same walk and ring for ehat. Each real dot is one fmaf
// chain over j in order, so every product is the bits the one-product
// helpers (cdot) give it; only the order of the sums over rows and of the
// loss terms differ from the plain version's.
//
// What bounds it. The serial chain: latency, not bytes or FLOPs (at D=10,
// B=32 a step takes ~0.6 us on an H100 against ~1 ns of fp32 FLOPs over
// the card, tools/split_forward_sweep.py); a CTA is one warp at D <= 32,
// so B=32 fills 32 of the 132 SMs.
#pragma once

#include "common.cuh"

namespace amt {

// The operand as a product sees it: bf16-rounded at kDefault, else as is.
template <int P>
__device__ __forceinline__ float prep(float x) {
  return P == kDefault ? bf16_round(x) : x;
}

// (M v) at row i of complex M = (mr, mi), the j-th element of the row at
// m[j * stride], on the prepped vector v = (vr, vi) of length D: four real
// dots, (mr.vr - mi.vi, mr.vi + mi.vr).
template <int P>
__device__ __forceinline__ void cdot(const uint32_t* mr, const uint32_t* mi,
                                     int stride, const float* vr,
                                     const float* vi, int D, float& outr,
                                     float& outi) {
  float a1, a2, a3, a4;
  dot2_strided<P>(mr, mi, stride, vr, nullptr, D, a1, a2);
  dot2_strided<P>(mr, mi, stride, vi, nullptr, D, a3, a4);
  outr = a1 - a4;
  outi = a3 + a2;
}

// The real adjoint of cdot at row i, walking column i of M (m[j * stride]
// is M[j][i]): (mr^T vr + mi^T vi, mr^T vi - mi^T vr).
template <int P>
__device__ __forceinline__ void cdot_t(const uint32_t* mr, const uint32_t* mi,
                                       int stride, const float* vr,
                                       const float* vi, int D, float& outr,
                                       float& outi) {
  float a1, a2, a3, a4;
  dot2_strided<P>(mr, mi, stride, vr, nullptr, D, a1, a2);
  dot2_strided<P>(mr, mi, stride, vi, nullptr, D, a3, a4);
  outr = a1 + a4;
  outi = a3 - a2;
}

// Three complex products at row (or column) i in one walk over j: A u, B u
// and M w, for packed shared matrices A, B, M (element j of the row at
// m[j * stride]) and prepped vectors u, w of length D. Each of the twelve
// real dots is one fmaf chain over j in order, as dot2_strided's, so each
// result is the bits that cdot (TR false) or cdot_t (TR true) gives it
// alone; walking the three together keeps twelve independent chains in
// flight where cdot runs two. out = (A u, B u, M w), real and imaginary.
// highest and default only (the split kernels refuse high). U unrolls the
// walk; the adjoints take the unroll that ran fastest for each form on an
// H100 at the estimator's shape (psi 1 double, 4 single; rho 2: 4 ran its
// workspace placement at half the speed).
template <int P, bool TR, int U>
__device__ __forceinline__ void cdot3(const uint32_t* ar, const uint32_t* ai,
                                      const uint32_t* br, const uint32_t* bi,
                                      const uint32_t* mr, const uint32_t* mi,
                                      int stride, const float* ur,
                                      const float* ui, const float* wr,
                                      const float* wi, int D,
                                      float (&out)[6]) {
  static_assert(P != kHigh, "the split kernels take highest and default");
  float a[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) a[q] = 0.f;
#pragma unroll (U)
  for (int j = 0; j < D; ++j) {
    const int o = j * stride;
    const float x[4] = {ur[j], ui[j], wr[j], wi[j]};
    const float m[6] = {__uint_as_float(ar[o]), __uint_as_float(ai[o]),
                        __uint_as_float(br[o]), __uint_as_float(bi[o]),
                        __uint_as_float(mr[o]), __uint_as_float(mi[o])};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float vr = x[c == 2 ? 2 : 0], vi = x[c == 2 ? 3 : 1];
      a[4 * c] = fmaf(m[2 * c], vr, a[4 * c]);              // mr . vr
      a[4 * c + 1] = fmaf(m[2 * c + 1], vr, a[4 * c + 1]);  // mi . vr
      a[4 * c + 2] = fmaf(m[2 * c], vi, a[4 * c + 2]);      // mr . vi
      a[4 * c + 3] = fmaf(m[2 * c + 1], vi, a[4 * c + 3]);  // mi . vi
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[2 * c] = TR ? a[4 * c] + a[4 * c + 3] : a[4 * c] - a[4 * c + 3];
    out[2 * c + 1] = TR ? a[4 * c + 2] - a[4 * c + 1]
                        : a[4 * c + 2] + a[4 * c + 1];
  }
}

// Sum of v over the CTA, every thread getting it: warp shuffles for one warp
// (after a warp barrier, so that the shared vectors read before the call
// are not overwritten by a lane that runs ahead), a block reduction
// (block_sum's rule for `red`) beyond.
__device__ __forceinline__ float col_sum(float v, float* red) {
  if (blockDim.x <= 32) {
    __syncwarp();
    return warp_sum(v);
  }
  return block_sum(v, red);
}

// Threads per split CTA: one per row, rounded up to whole warps.
__host__ __device__ inline int split_threads(int D) {
  return ((D + 31) / 32) * 32;
}

// The split adjoints (psi_split_bwd.cu, rho_split_bwd.cu). A block's
// per-step scalars, [kStepScalars][unroll] floats a slab: s, |y|^2 (psi) or
// the trace (rho), ehat, and the previous step's |y|^2 or trace.
enum SplitStepScalar { kSs = 0, kSn = 1, kSe = 2, kSnp = 3, kStepScalars = 4 };

// The most threads of a psi adjoint CTA (two roles of D threads rounded to
// warps, D <= 128) and of a rho one in the double form (two roles).
constexpr int kSplitBwdPsiThreads = 256;
constexpr int kSplitBwdRhoPipeThreads = 512;

// The parts of an adjoint a build runs: all three, except in the
// measurement builds of tools/split_adjoint_attribution.py, which compile
// the adjoints with -DAMT_SPLIT_BWD_PARTS=1 (the re-run alone), 2 (the
// sweep alone) or 4 (the outer products alone); the hand-overs between the
// roles stay.
#ifndef AMT_SPLIT_BWD_PARTS
#define AMT_SPLIT_BWD_PARTS 7
#endif
constexpr int kRerunPart = 1, kSweepPart = 2, kOuterPart = 4;
constexpr int kParts = AMT_SPLIT_BWD_PARTS;

// The split kernels take highest and default, as the TPU's do.
template <typename F>
cudaError_t dispatch_split(int precision, bool defer, F&& f) {
  return dispatch(precision, defer, [&](auto p, auto d) -> cudaError_t {
    if constexpr (decltype(p)::value == kHigh) {
      return cudaErrorInvalidValue;
    } else {
      return f(p, d);
    }
  });
}

// ---------------------------------------------------------------------------
// The forward templates' packed operands (psi here, rho_split_fwd.cuh)

// The walk's vector at j as (u_r, u_i, w_r, w_i): v[j] itself where it
// packs two vectors, (u_r, u_i, u_r, u_i) where one feeds all three
// products.
__device__ __forceinline__ void walk_vec(const float4& v, float (&x)[4]) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void walk_vec(const float2& v, float (&x)[4]) {
  x[0] = x[2] = v.x;
  x[1] = x[3] = v.y;
}

// Row i of A u, B u and M w in one walk over j, as cdot3 above (TR false),
// on packed operands: ab[j * stride] = (A_r, A_i, B_r, B_i) and m[j *
// stride] = (M_r, M_i) of the row's element j (with M_IS_B, M = B and m
// unused), v[j] = (u_r, u_i, w_r, w_i) a float4, or (u_r, u_i) a float2
// where w = u (rho's sampler: conj(C) u, conj(R) u and X^T u). The twelve
// dots are cdot3's fmaf chains in the same order, so each result is the
// bits cdot3 (and cdot) give it; a j costs two 16-byte loads (one 16- and
// one 8-byte with a float2 v; and one 8-byte load of M), where cdot3 takes
// ten 4-byte ones.
template <int P, bool M_IS_B, int U, typename V>
__device__ __forceinline__ void cdot3(const float4* ab, const float2* m,
                                      int stride, const V* v, int D,
                                      float (&out)[6]) {
  static_assert(P != kHigh, "the split kernels take highest and default");
  float a[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) a[q] = 0.f;
#pragma unroll (U)
  for (int j = 0; j < D; ++j) {
    float x[4];
    walk_vec(v[j], x);
    const float4 c = ab[j * stride];
    float mr = c.z, mi = c.w;
    if constexpr (!M_IS_B) {
      const float2 q = m[j * stride];
      mr = q.x;
      mi = q.y;
    }
    const float mm[6] = {c.x, c.y, c.z, c.w, mr, mi};
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const float vr = x[g == 2 ? 2 : 0], vi = x[g == 2 ? 3 : 1];
      a[4 * g] = fmaf(mm[2 * g], vr, a[4 * g]);              // mr . vr
      a[4 * g + 1] = fmaf(mm[2 * g + 1], vr, a[4 * g + 1]);  // mi . vr
      a[4 * g + 2] = fmaf(mm[2 * g], vi, a[4 * g + 2]);      // mr . vi
      a[4 * g + 3] = fmaf(mm[2 * g + 1], vi, a[4 * g + 3]);  // mi . vi
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    out[2 * g] = a[4 * g] - a[4 * g + 3];
    out[2 * g + 1] = a[4 * g + 2] + a[4 * g + 1];
  }
}

// The operand a product sees of element idx of a row-major [n,n] matrix.
template <int P>
__device__ __forceinline__ float packed(const float* __restrict__ src,
                                        int idx) {
  return __uint_as_float(pack_elem<P>(src[idx]));
}

// Copy the complex row-major [n,n] matrices a = ar + i ai, b = br + i bi
// into shared memory, transposed and packed: dst[j * n + i] = (a_r, a_i,
// b_r, b_i) of element (i, j). Runs once per CTA.
template <int P>
__device__ void load_pair_t(float4* dst, const float* __restrict__ ar,
                            const float* __restrict__ ai,
                            const float* __restrict__ br,
                            const float* __restrict__ bi, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    dst[j * n + i] = make_float4(packed<P>(ar, idx), packed<P>(ai, idx),
                                 packed<P>(br, idx), packed<P>(bi, idx));
  }
}

// The same for one complex matrix: dst[j * n + i] = (m_r, m_i).
template <int P>
__device__ void load_one_t(float2* dst, const float* __restrict__ mr,
                           const float* __restrict__ mi, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    dst[j * n + i] = make_float2(packed<P>(mr, idx), packed<P>(mi, idx));
  }
}

// ---------------------------------------------------------------------------
// The loss ring of the forward templates
//
// A step leaves its parts of the sums that no later step needs, ehat and
// (deferred norm) |y|^2 or the trace, in a ring of `slots` steps with its s:
// each lane its own (`lanes`: the warp-local layouts, whose steps
// synchronise only their warp, so a step has no warp sum either) or each
// warp its warp_sum (the layouts with a CTA barrier a step). A flush takes
// the steps since the last one: each warp adds its lanes' parts in lane
// order, warp 0 their warp parts in warp order, writes the totals of t
// (tt) and takes the loss terms, added by a butterfly into acc. The ring
// holds the steps p0 - 1 .. k of a flush after step k, so a flush comes
// at least every slots - 2 steps. Words (loss_ring_words): the warp parts
// of e and t [slots][nw], tt and s [slots], and with lanes the lane parts
// of e and t [slots][nt].
constexpr int kRingSlots = 18;    // psi; rho's warp-local layout
constexpr int kRingSlotsCta = 8;  // rho's element layout (its D=64 ceiling)

__host__ __device__ inline int loss_ring_words(int nt, int slots,
                                               bool lanes) {
  return slots * (2 * (nt / 32) + 2 + (lanes ? 2 * nt : 0));
}

struct LossRing {
  float* e;   // [slots][nw] warp parts of ehat, by step
  float* t;   // [slots][nw] of |y|^2 or the trace
  float* tt;  // [slots] totals of t (written at a flush)
  float* s;   // [slots]
  float* le;  // [slots][nt] lane parts of ehat (lanes)
  float* lt;  // [slots][nt] of t
  int nt, nw, slots;
  bool lanes;

  __device__ LossRing(float* base, int nt_, int slots_, bool lanes_)
      : nt(nt_), nw(nt_ >> 5), slots(slots_), lanes(lanes_) {
    e = base;
    t = e + slots * nw;
    tt = t + slots * nw;
    s = tt + slots;
    le = s + slots;
    lt = le + (lanes ? slots * nt : 0);
  }
  __device__ float* end() const { return lt + (lanes ? slots * nt : 0); }
  __device__ int slot(int k) const { return k % slots; }

  // Store a step's parts: e of step k-1 (has_e) at slot sl_e, t of step
  // k (with_t) at slot sl_t; a warp sum each unless lanes.
  __device__ void store(int sl_e, bool has_e, float e_part, int sl_t,
                        bool with_t, float t_part) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (lanes) {
      if (has_e) le[sl_e * nt + tid] = e_part;
      if (with_t) lt[sl_t * nt + tid] = t_part;
    } else {
      const float we = has_e ? warp_sum(e_part) : 0.f;
      const float wt = with_t ? warp_sum(t_part) : 0.f;
      if (lane == 0) {
        if (has_e) e[sl_e * nw + warp] = we;
        if (with_t) t[sl_t * nw + warp] = wt;
      }
    }
  }

  // The warp parts of slot sl in warp order.
  __device__ float total(const float* p, int sl) const {
    const float* row = p + sl * nw;
    float r = row[0];
    for (int w = 1; w < nw; ++w) r += row[w];
    return r;
  }

  // Flush the loss terms of steps p0 .. kend - 1 into acc (warp 0's lanes
  // hold it) and the totals of t of steps p0 .. tend - 1 into tt (DEFER):
  // -log(max(1 + scale ehat / n2p s, log_eps)), n2p the total of t of the
  // step before inside a deferred block and 1 at a block's first step (no
  // division at the per-step norm). kend - p0 <= tend - p0 <= 32. Every
  // thread of the CTA calls it, after the ring's last stores; tt is
  // readable by every thread on return.
  template <bool DEFER>
  __device__ void flush(int p0, int kend, int tend, int unroll, float scale,
                        float log_eps, float norm_eps, float& acc) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ne = kend - p0, nn = DEFER ? tend - p0 : 0;
    if (lanes) {
      __syncwarp();
      if (lane < (ne > nn ? ne : nn)) {
        const int sl = slot(p0 + lane);
        const float* pe = le + sl * nt + warp * 32;
        const float* pt = lt + sl * nt + warp * 32;
        float a = 0.f, b = 0.f;
#pragma unroll 8
        for (int l = 0; l < 32; ++l) {
          if (lane < ne) a += pe[l];
          if (lane < nn) b += pt[l];
        }
        if (lane < ne) e[sl * nw + warp] = a;
        if (lane < nn) t[sl * nw + warp] = b;
      }
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < nn) tt[slot(p0 + lane)] = total(t, slot(p0 + lane));
      __syncwarp();
      float term = 0.f;
      if (lane < ne) {
        const int j = p0 + lane, sl = slot(j);
        float x = scale * total(e, sl);
        if (DEFER) {
          const float n2p = j % unroll == 0 ? 1.f : tt[slot(j + slots - 1)];
          x = x / floor_at(n2p, norm_eps);
        }
        term = logf(floor_at(1.f + x * s[sl], log_eps));
      }
      acc -= warp_sum(term);
    }
    __syncthreads();
  }
};

// The per-step norm's sum of v over the CTA at step k: a warp sum for one
// warp, else the warp sums added in warp order through red[32 (k & 1) +
// w], which step k + 2 writes again only after the barriers of step k + 1.
__device__ __forceinline__ float step_sum(float v, float* red, int k) {
  const float w = warp_sum(v);
  if (blockDim.x == 32) return w;
  float* r = red + 32 * (k & 1);
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = w;
  __syncthreads();
  float t = r[0];
  for (int q = 1; q < static_cast<int>(blockDim.x >> 5); ++q) t += r[q];
  return t;
}

// The barrier of a step: the warp's (a warp-local step) or the CTA's.
__device__ __forceinline__ void step_sync(bool warp_only) {
  if (warp_only) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// cdot3's unroll in the forward templates.
constexpr int kFwdPsiU = 8;

// The most threads of a psi forward or sampler CTA (D <= 128; their
// shared memory stops at D=119 and D=120).
constexpr int kSplitFwdPsiThreads = 128;

template <int P, bool DEFER, int MODE>
__global__ void __launch_bounds__(kSplitFwdPsiThreads)
    psi_split_fwd_kernel(const float* __restrict__ cr,
                         const float* __restrict__ ci,
                         const float* __restrict__ rr,
                         const float* __restrict__ ri,
                         const float* __restrict__ pc,
                         const float* __restrict__ ps,
                         const float* __restrict__ s0r,
                         const float* __restrict__ s0i,
                         const float* __restrict__ se,
                         float* __restrict__ loss, float* __restrict__ ckr,
                         float* __restrict__ cki, int D, int n_steps, int B,
                         int unroll, float log_eps, float norm_eps) {
  extern __shared__ __align__(16) float4 smem4[];
  const int nt = blockDim.x;
  const bool one_warp = nt == 32;
  float4* mat = smem4;           // (C, R), transposed and packed
  float4* vb = mat + D * D;      // [2][D]: prepped (x, y of the step
                                 // before), by step parity
  const LossRing ring(reinterpret_cast<float*>(vb + 2 * D), nt, kRingSlots,
                      one_warp);
  float* red = ring.end();       // [2][32]: the per-step norm's sums

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < D;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(D) * B;

  load_pair_t<P>(mat, cr, ci, rr, ri, D);
  const float pci = active ? pc[i] : 0.f;
  const float psi = active ? ps[i] : 0.f;
  float pr = active ? s0r[i * stride + col] : 0.f;
  float pi = active ? s0i[i * stride + col] : 0.f;
  float yr = 0.f, yi = 0.f;  // y of the step before
  float acc = 0.f;           // warp 0: the loss
  int p0 = 0;                // the first step whose loss term is pending
  int kb = 0;                // the step's place in its block
  int sk = 0, skp = 0;       // ring slots of steps k and k - 1
  ChunkedInputs steps(se + col, stride, n_steps);
  __syncthreads();

  for (int k = 0; k < n_steps; ++k) {
    if (MODE == kCkpt && active && kb == 0) {
      const size_t at = (k / unroll) * plane + i * stride + col;
      ckr[at] = pr;
      cki[at] = pi;
    }
    float4* v = vb + (k & 1) * D;
    if (active) {
      v[i] = make_float4(prep<P>(pr), prep<P>(pi), prep<P>(yr),
                         prep<P>(yi));
    }
    step_sync(one_warp);
    const float s = steps.at(k);
    float e_part = 0.f, t_part = 0.f, nyr = 0.f, nyi = 0.f;
    if (active) {
      // C x, R x and, for step k-1, R y (at k = 0 a discarded R 0)
      float o[6];
      cdot3<P, true, kFwdPsiU>(mat + i, nullptr, D, v, D, o);
      nyr = o[0] + s * o[2];
      nyi = o[1] + s * o[3];
      e_part = yr * o[4] + yi * o[5];
      t_part = nyr * nyr + nyi * nyi;
    }
    ring.store(skp, k > 0, e_part, sk, DEFER, t_part);
    if (i == 0) ring.s[sk] = s;
    if (DEFER) {
      pr = nyr * pci + nyi * psi;
      pi = nyi * pci - nyr * psi;
    } else {
      const float inv = rsqrtf(floor_at(step_sum(t_part, red, k), norm_eps));
      const float tr = nyr * inv, ti = nyi * inv;
      pr = tr * pci + ti * psi;
      pi = ti * pci - tr * psi;
    }
    yr = nyr;
    yi = nyi;
    const bool block_end = kb == unroll - 1;
    if (k + 1 < n_steps &&
        ((DEFER && block_end) || k - p0 >= kRingSlots - 2)) {
      // the terms of steps p0 .. k-1, the totals of |y|^2 to step k
      ring.flush<DEFER>(p0, k, k + 1, unroll, 2.f, log_eps, norm_eps, acc);
      if (DEFER && block_end) {
        const float inv = rsqrtf(floor_at(ring.tt[sk], norm_eps));
        pr *= inv;
        pi *= inv;
      }
      p0 = k;
    }
    kb = block_end ? 0 : kb + 1;
    skp = sk;
    sk = sk + 1 == kRingSlots ? 0 : sk + 1;
  }
  if (n_steps > 0) {
    // R y of the last step
    float4* v = vb + (n_steps & 1) * D;
    if (active) v[i] = make_float4(0.f, 0.f, prep<P>(yr), prep<P>(yi));
    step_sync(one_warp);
    float e_part = 0.f;
    if (active) {
      float o[6];
      cdot3<P, true, kFwdPsiU>(mat + i, nullptr, D, v, D, o);
      e_part = yr * o[4] + yi * o[5];
    }
    ring.store(skp, true, e_part, 0, false, 0.f);
    ring.flush<DEFER>(p0, n_steps, n_steps, unroll, 2.f, log_eps, norm_eps,
                      acc);
  }
  if (i == 0) loss[col] = acc;
}

// Dynamic shared memory of one forward CTA: C and R packed (16 D^2 bytes),
// the double buffer of (x, y) (32 D), the loss ring and the per-step
// norm's 64 floats.
inline size_t split_fwd_smem_bytes(int D) {
  const size_t d = static_cast<size_t>(D);
  const int nt = split_threads(D);
  return 4 * (4 * d * d + 8 * d + loss_ring_words(nt, kRingSlots, nt == 32) +
              64);
}

// Launch the forward for the runtime precision and norm flag: B CTAs. ckr
// and cki may be null for kNll.
template <int MODE>
cudaError_t launch_split_fwd(const float* cr, const float* ci,
                             const float* rr, const float* ri,
                             const float* pc, const float* ps,
                             const float* s0r, const float* s0i,
                             const float* se, float* loss, float* ckr,
                             float* cki, int D, int n_steps, int B,
                             int unroll, float log_eps, float norm_eps,
                             int precision, bool defer, cudaStream_t stream) {
  if (unroll < 1 || D < 1 || split_threads(D) > kSplitFwdPsiThreads)
    return cudaErrorInvalidValue;
  return dispatch_split(precision, defer, [&](auto p, auto d) {
    return launch_smem(
        psi_split_fwd_kernel<decltype(p)::value, decltype(d)::value, MODE>,
        dim3(B), split_threads(D), split_fwd_smem_bytes(D), stream, cr, ci,
        rr, ri, pc, ps, s0r, s0i, se, loss, ckr, cki, D, n_steps, B, unroll,
        log_eps, norm_eps);
  });
}

}  // namespace amt
