// The rho forward chain in the split layout for Hopper, shared by the
// forward-only NLL (rho_split_nll.cu, kNll) and the training forward with
// block checkpoints (rho_split_fwd.cu, kCkpt), with the pieces that the
// split rho sampler (rho_split_sample.cu) and adjoint (rho_split_bwd.cu)
// use too.
//
// Replaces, with its two modes, the TPU kernels
// audio_mps_tpu/ops/pallas_scan.py _make_rho_nll_kernel (via rho_nll_pallas)
// and audio_mps_tpu/ops/pallas_grad.py _make_rho_fwd_kernel (via
// _rho_fused_nll_factory). The state of an example is its purification
// factor segment H = G^T, [D, rank] (its rank lanes of the [D, B * rank]
// factor), as real and imaginary parts; the constants conj(C), conj(R) and
// X^T are real pairs [D,D]. One step, with s the increment / A shared by the
// lanes:
//   y    = conj(C) H + s conj(R) H             (four real products each)
//   gx   = X^T y,  ehat = sum(y_r gx_r + y_i gx_i),  tr = |y|^2
//                                              (sums over the segment)
//   per-step norm:  loss -= log(max(1 + ehat s, log_eps));
//                   H = p .* (y rsqrt(max(tr, eps)))
//   deferred norm:  e = ehat / max(tr_prev, eps), the same loss;
//                   H = p .* y, tr_prev = tr, and at every unroll-th step
//                   H *= rsqrt(max(tr, eps)), tr_prev = 1: where the TPU
//                   kernel renormalises at its block exits.
// kCkpt also writes ckr, cki [n_blocks, D, B * rank], the factor entering
// each unroll-step block (normalised in both modes, pallas_grad.py:841-842,
// :856-859); the adjoint re-runs each block from it.
//
// Design. On the TPU the grid walks time blocks over all B * rank lanes and
// the per-example scalars are [1, B * rank] rows built with 0/1 segment
// matrices; here each example is independent, so one CTA owns one
// example's whole segment and loops over all steps, and e, tr and the loss
// are per-example scalars. conj(C) and conj(R) sit in shared memory
// transposed and packed four to an element, X^T two to an element. A step
// is psi's (psi_split_fwd.cuh): one walk over j a segment element (row i
// of lane r) forms conj(C) x_k, conj(R) x_k and, for step k-1, X^T y_{k-1}
// on column r of a double buffer of the prepped (x_k, y_{k-1}), and writes
// the next to the other half before one barrier; ehat and the deferred
// norm's trace go to the loss ring, summed and turned into loss terms at a
// flush (at every block's end, where the renormalisation's trace is the
// only sum on the chain). A step's products for lane r read only column r,
// so where D <= 32 a warp holds whole columns (warp-local: 3 columns a
// warp, 4 warps at D=10, rank 10; rho_split_fwd_layout) and a step
// synchronises only its warp; the sums across warps wait for a flush (the
// per-step norm's trace takes a CTA barrier a step). Past D=32, or where
// the columns would need more than 32 warps, the adjoint re-run role's
// element layout: thread t owns the elements t, t + nt, ...
// (rho_split_threads, up to 1024), one CTA barrier a step.
// ops/split.rho_split_fwd_layout mirrors the rule.
// Each real dot is one fmaf chain over j in order, so every product is
// the bits cdot gives it in any layout; the sums' order is the layout's.
//
// What bounds it. The serial chain: latency, not bytes or FLOPs (at D=10,
// rank 10, B=32 a step takes ~0.8 us on an H100 against ~16 ns of fp32
// FLOPs over the whole card, tools/split_forward_sweep.py); a CTA is 4
// warps there, so B=32 fills 32 of the 132 SMs. Past one warp a
// scheduler, idle lanes cost time: at D=20, rank 20 the element layout
// (13 warps, a CTA barrier a step) runs 1.1x faster than the warp-local
// one (7 warps of 2 elements a lane).
#pragma once

#include "psi_split_fwd.cuh"

namespace amt {

// Threads per rho split CTA: one per element of the [D, rank] segment,
// rounded up to whole warps, at most 1024 (then a thread takes several).
__host__ __device__ inline int rho_split_threads(int D, int rank) {
  const int n = D * rank;
  return n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
}

// The rotation p .* y of the factor's row i.
__device__ __forceinline__ void rotate_p(float yr, float yi, float pc,
                                         float ps, float& hr, float& hi) {
  hr = yr * pc - yi * ps;
  hi = yr * ps + yi * pc;
}

// The forward's layout of an example's [D, rank] segment (mirrored by
// ops/split.rho_split_fwd_layout). Warp-local where D <= 32 (cols > 0):
// each thread takes `elems` elements of its warp's cols = floor(32 elems /
// D) whole columns (lane l's q-th on element l + 32 q of them, row
// (l + 32 q) % D), so a step synchronises its warp alone; elems is the
// power of 2 up to 8 that gives a step the fewest walks on the busiest of
// an SM's four schedulers, ceil(warps / 4) x elems (idle lanes cost
// warps, a thread's elements run in turn), the smallest on a tie, with at
// most 32 warps (D=10, rank 10: one element, 3 columns a warp, 4 warps;
// D=20: two, 3 columns, 7 warps).
// Else, or with warp_local false, the element layout (cols 0:
// rho_split_threads threads, each on up to `elems` elements t, t + nt,
// ..., a power of 2). `slots`: the loss ring's.
struct RhoFwdLayout {
  int cols;
  int threads;
  int elems;
  int slots;
};

__host__ __device__ inline RhoFwdLayout rho_split_fwd_layout(
    int D, int rank, bool warp_local = true) {
  if (warp_local && D <= 32) {
    RhoFwdLayout best = {0, 0, 0, kRingSlots};
    for (int e = 1; e <= 8; e *= 2) {
      const int cols = 32 * e / D;
      const int warps = (rank + cols - 1) / cols;
      const int cost = (warps + 3) / 4 * e;
      if (warps <= 32 &&
          (best.cols == 0 || cost < (best.threads / 32 + 3) / 4 * best.elems))
        best = {cols, 32 * warps, e, kRingSlots};
    }
    if (best.cols > 0) return best;
  }
  const int nt = rho_split_threads(D, rank);
  const int per = (D * rank + nt - 1) / nt;
  int elems = 1;
  while (elems < per) elems *= 2;
  return {0, nt, elems, kRingSlotsCta};
}

// Dynamic shared memory of one forward CTA: conj(C), conj(R) and X^T
// packed (24 D^2 bytes), the double buffer of (x, y) (32 D rank), the loss
// ring and the per-step norm's 64 floats.
inline size_t rho_split_fwd_smem_bytes(int D, int rank,
                                       bool warp_local = true) {
  const RhoFwdLayout l = rho_split_fwd_layout(D, rank, warp_local);
  const size_t d = static_cast<size_t>(D), n = d * rank;
  return 4 * (6 * d * d + 8 * n +
              loss_ring_words(l.threads, l.slots, l.cols > 0) + 64);
}

// This thread's elements e = r D + i of the [D, rank] segment: row,
// column and ownership, in the warp-local layout (cols > 0: lane l's q-th
// on element l + 32 q of its warp's columns) or the element layout (cols 0:
// elements t, t + nt, ...). The split sampler takes the element layout.
template <int E>
__device__ __forceinline__ void rho_split_elements(int D, int rank,
                                                   int cols, int (&row)[E],
                                                   int (&colr)[E],
                                                   bool (&own)[E]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < E; ++q) {
    if (cols > 0) {
      const int l = lane + 32 * q;
      colr[q] = warp * cols + l / D;
      row[q] = l % D;
      own[q] = l < cols * D && colr[q] < rank;
    } else {
      const int e = tid + q * static_cast<int>(blockDim.x);
      colr[q] = e / D;
      row[q] = e - colr[q] * D;
      own[q] = e < D * rank;
    }
  }
}

// cdot3's unroll in rho's forward (64 registers a thread at 1024 threads).
constexpr int kFwdRhoU = 2;

template <int P, bool DEFER, int MODE, int E>
__global__ void __launch_bounds__(1024)
    rho_split_fwd_kernel(const float* __restrict__ ccr,
                         const float* __restrict__ cci,
                         const float* __restrict__ rcr,
                         const float* __restrict__ rci,
                         const float* __restrict__ xtr,
                         const float* __restrict__ xti,
                         const float* __restrict__ pc,
                         const float* __restrict__ ps,
                         const float* __restrict__ h0r,
                         const float* __restrict__ h0i,
                         const float* __restrict__ se,
                         float* __restrict__ loss, float* __restrict__ ckr,
                         float* __restrict__ cki, int D, int n_steps, int B,
                         int rank, int unroll, float log_eps, float norm_eps,
                         int cols) {
  extern __shared__ __align__(16) float4 smem4[];
  const int dd = D * D;
  const int n = D * rank;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const bool wl = cols > 0;  // warp-local
  const int slots = wl ? kRingSlots : kRingSlotsCta;
  float4* mab = smem4;       // (conj(C), conj(R)), transposed and packed
  float4* vb = mab + dd;     // [2][D rank]: prepped (x, y of the step
                             // before), by step parity
  float2* mx = reinterpret_cast<float2*>(vb + 2 * n);  // X^T
  const LossRing ring(reinterpret_cast<float*>(mx + dd), nt, slots, wl);
  float* red = ring.end();   // [2][32]: the per-step norm's sums

  const int ex = blockIdx.x;
  const size_t lanes = static_cast<size_t>(B) * rank;
  const size_t plane = static_cast<size_t>(D) * lanes;
  const size_t col0 = static_cast<size_t>(ex) * rank;

  load_pair_t<P>(mab, ccr, cci, rcr, rci, D);
  load_one_t<P>(mx, xtr, xti, D);
  int row[E], colr[E];
  bool own[E];
  rho_split_elements(D, rank, cols, row, colr, own);
  float pr[E], pi[E], yr[E], yi[E], pcq[E], psq[E];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const size_t at = row[q] * lanes + col0 + colr[q];
    pr[q] = own[q] ? h0r[at] : 0.f;
    pi[q] = own[q] ? h0i[at] : 0.f;
    pcq[q] = own[q] ? pc[row[q]] : 0.f;
    psq[q] = own[q] ? ps[row[q]] : 0.f;
    yr[q] = yi[q] = 0.f;
  }
  float acc = 0.f;  // warp 0: the loss
  int p0 = 0;       // the first step whose loss term is pending
  int kb = 0;       // the step's place in its block
  int sk = 0, skp = 0;
  ChunkedInputs steps(se + ex, static_cast<size_t>(B), n_steps);
  __syncthreads();

  for (int k = 0; k < n_steps; ++k) {
    float4* v = vb + (k & 1) * n;
#pragma unroll
    for (int q = 0; q < E; ++q) {
      if (!own[q]) continue;
      if (MODE == kCkpt && kb == 0) {
        const size_t at = (k / unroll) * plane + row[q] * lanes + col0 +
                          colr[q];
        ckr[at] = pr[q];
        cki[at] = pi[q];
      }
      v[colr[q] * D + row[q]] = make_float4(prep<P>(pr[q]), prep<P>(pi[q]),
                                            prep<P>(yr[q]), prep<P>(yi[q]));
    }
    step_sync(wl);
    const float s = steps.at(k);
    float e_part = 0.f, t_part = 0.f;
#pragma unroll
    for (int q = 0; q < E; ++q) {
      if (!own[q]) continue;
      // conj(C) x, conj(R) x and, for step k-1, X^T y (at k = 0 X^T 0)
      float o[6];
      cdot3<P, false, kFwdRhoU>(mab + row[q], mx + row[q], D,
                                v + colr[q] * D, D, o);
      const float nyr = o[0] + s * o[2], nyi = o[1] + s * o[3];
      e_part += yr[q] * o[4] + yi[q] * o[5];
      t_part += nyr * nyr + nyi * nyi;
      yr[q] = nyr;
      yi[q] = nyi;
      if (DEFER) rotate_p(nyr, nyi, pcq[q], psq[q], pr[q], pi[q]);
    }
    ring.store(skp, k > 0, e_part, sk, DEFER, t_part);
    if (tid == 0) ring.s[sk] = s;
    if (!DEFER) {
      // per-step norm: normalise, then rotate
      const float inv = rsqrtf(floor_at(step_sum(t_part, red, k), norm_eps));
#pragma unroll
      for (int q = 0; q < E; ++q) {
        rotate_p(yr[q] * inv, yi[q] * inv, pcq[q], psq[q], pr[q], pi[q]);
      }
    }
    const bool block_end = kb == unroll - 1;
    if (k + 1 < n_steps &&
        ((DEFER && block_end) || k - p0 >= slots - 2)) {
      // the terms of steps p0 .. k-1, the totals of the trace to step k
      ring.flush<DEFER>(p0, k, k + 1, unroll, 1.f, log_eps, norm_eps, acc);
      if (DEFER && block_end) {
        const float inv = rsqrtf(floor_at(ring.tt[sk], norm_eps));
#pragma unroll
        for (int q = 0; q < E; ++q) {
          pr[q] *= inv;
          pi[q] *= inv;
        }
      }
      p0 = k;
    }
    kb = block_end ? 0 : kb + 1;
    skp = sk;
    sk = sk + 1 == slots ? 0 : sk + 1;
  }
  if (n_steps > 0) {
    // X^T y of the last step
    float4* v = vb + (n_steps & 1) * n;
#pragma unroll
    for (int q = 0; q < E; ++q) {
      if (own[q])
        v[colr[q] * D + row[q]] =
            make_float4(0.f, 0.f, prep<P>(yr[q]), prep<P>(yi[q]));
    }
    step_sync(wl);
    float e_part = 0.f;
#pragma unroll
    for (int q = 0; q < E; ++q) {
      if (!own[q]) continue;
      float o[6];
      cdot3<P, false, kFwdRhoU>(mab + row[q], mx + row[q], D,
                                v + colr[q] * D, D, o);
      e_part += yr[q] * o[4] + yi[q] * o[5];
    }
    ring.store(skp, true, e_part, 0, false, 0.f);
    ring.flush<DEFER>(p0, n_steps, n_steps, unroll, 1.f, log_eps, norm_eps,
                      acc);
  }
  if (tid == 0) loss[ex] = acc;
}

// Launch the forward for the runtime precision and norm flag: B CTAs in
// rho_split_fwd_layout's layout (warp_local false: the element layout at
// every shape). ckr and cki may be null for kNll.
template <int MODE>
cudaError_t launch_rho_split_fwd(const float* ccr, const float* cci,
                                 const float* rcr, const float* rci,
                                 const float* xtr, const float* xti,
                                 const float* pc, const float* ps,
                                 const float* h0r, const float* h0i,
                                 const float* se, float* loss, float* ckr,
                                 float* cki, int D, int n_steps, int B,
                                 int rank, int unroll, float log_eps,
                                 float norm_eps, int precision, bool defer,
                                 bool warp_local, cudaStream_t stream) {
  if (unroll < 1 || D < 1 || rank < 1) return cudaErrorInvalidValue;
  const RhoFwdLayout l = rho_split_fwd_layout(D, rank, warp_local);
  return dispatch_split(precision, defer, [&](auto p, auto d) {
    return dispatch_cols(l.elems, [&](auto e) {
      return launch_smem(
          rho_split_fwd_kernel<decltype(p)::value, decltype(d)::value, MODE,
                               decltype(e)::value>,
          dim3(B), l.threads, rho_split_fwd_smem_bytes(D, rank, warp_local),
          stream, ccr,
          cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se, loss, ckr, cki, D,
          n_steps, B, rank, unroll, log_eps, norm_eps, l.cols);
    });
  });
}

}  // namespace amt
