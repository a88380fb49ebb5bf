// The psi forward chain (block-complex layout) for Hopper, shared by the
// forward-only NLL (psi_nll.cu, kNll), the training forward with the state
// stream (psi_train_fwd.cu, kStream) or with block checkpoints
// (psi_train_fwd.cu, kCkpt), and the recompute of the recompute adjoint
// (psi_recompute.cu, kRecompute).
//
// One step on the folded kernel-frame state t ([2D] per example), with s the
// increment / A:
//   y  = Ab t + s (Bb t)
//   ru = Rb y
//   e  = 2 sum(y .* ru),  n2 = sum(y^2)     (one block reduction of both)
//   per-step norm:  loss -= log(max(1 + e s, log_eps));  t = y rsqrt(max(n2, eps))
//   deferred norm:  e /= max(n2_prev, eps); same loss; t = y, n2_prev = n2,
//                   renormalised (and n2_prev = 1) at every unroll-th step,
//                   where the TPU kernel renormalises at its block exits.
// The mean over the batch stays outside; the kernel writes loss[B]. What a
// launch writes besides (FwdMode):
//   kStream:    ys[k] = y_k ([n_steps, 2D, B]) and n2s[k] = |y_k|^2
//               ([n_steps, B]): with them the adjoint (psi_train_bwd.cu) and
//               the cotangent reduction (psi_cotangents.cu) rebuild every
//               step's input state t_k = y_{k-1} * (renorm ?
//               rsqrt(max(n2, eps)) : 1) with the same instructions as here,
//               bit for bit, and no recompute chain.
//   kCkpt:      ck[j] = t_{j unroll}, the state entering each unroll-step
//               block ([n_blocks, 2D, B], n_blocks = ceil(n_steps / unroll);
//               the state after the previous block's exit renorm), and no
//               stream: the TPU forward's checkpoints (pallas_block.py :477).
//   kRecompute: no loss; CTA (column group, j) re-runs the span (a whole
//               number of blocks) that starts at block j span / unroll of a
//               segment, each block from its own checkpoint in t0 ([blocks,
//               2D, B]), and writes the span's rows of ys and n2s. The
//               spans of a segment are independent, so they run side by
//               side; each CTA runs this loop over its steps, so from the
//               kCkpt forward's checkpoints ys and n2s equal the kStream
//               forward's bit for bit, and from any others they are the
//               plain recompute's function of every checkpoint.
//
// Design. On the TPU the grid walks time blocks and scratch carries the
// state; here each example is independent, so a CTA owns G examples
// (columns xG .. xG + G - 1, the last group masked) and loops over all
// steps, with Ab, Bb and Rb resident in dynamic shared memory (3 x 64 KB =
// 192 KB at D=64) and thread i computing state row i of all G columns. The
// prepped states are [2D, G] buffers (load_cols: broadcast 16-byte loads of
// a row), the per-column scalars (s, the loss, n2p, the next checkpoint)
// are register arrays, and one block_sum_cols gives the G columns' (ehat,
// n2). Every column's sums run in the G = 1 order (dot2_cols / dot_cols
// are dot2_strided / dot_strided a column; block_sum_cols is block_sum2 a
// pair), so a column's loss, ys, n2s and ck are the same bits for every G.
//
// What bounds it. Each step reads the three [2D,2D] constants from shared
// memory once per CTA (3 x 64 KB at D=64) against 3 x 2 x (2D)^2 FLOPs a
// column: G FMAs per 4-byte shared load (3G at high) and G/4 broadcast
// loads of the states, where G = 1 gives one FMA per load and a dependent
// chain of 2D FMAs a product. So the shared-memory bandwidth of each SM, the
// FMA chain's latency and three CTA barriers a step bound it, not device
// memory. One CTA fits an SM at D=64, so the wrappers take G = 1 while B
// CTAs fit one wave (B=128: 128 CTAs on 132 SMs) and past that the G of
// fewest waves (ops/block.py psi_columns_per_cta; B=1024: G=8, 128 CTAs).
// The stream and checkpoint stores write G adjacent floats of a row a step,
// off the dependent-dot path. A recompute CTA loads the constants once for
// its span; their transposed stores conflict in the banks, so the load
// costs about a block of 16 steps, and a span of several blocks amortises
// it.
//
// kBatched (psi_batched_fwd.cu; the TPU's _make_psi_fwd_kernel_batched,
// pallas_block.py :276, deferred norm only): the spine/limbs split. Per
// unroll-step block the serial "spine" is the state recurrence alone,
// y_k = Ab t_k + s_k (Bb t_k) with t_{k+1} = y_k, one CTA barrier a step
// (the prepped state ping-pongs between two vectors); each y_k also goes to
// [2D, K] shared buffers (raw and prepped). The "limb" then runs once a
// block: thread i walks row i of Rb once for a chunk of kLimb states
// (dot_chunk: each 4-byte load of Rb feeds kLimb FMAs where the step loop
// feeds one), and one block_sum_n gives the chunk's ehat_k and n2_k. The
// loss and the exit renorm follow in step order. Every sum runs in the
// order of the kCkpt mode's (dot_chunk's per-state order is row_dot's,
// block_sum_n's is block_sum2's), so loss and ck equal psi_train_fwd_ckpt's
// bit for bit. Shared memory: the three constants, three [2D, K] buffers
// at a row pitch of chunk_pitch(K) words, two prepped vectors and the
// reductions (229,792 bytes at D=64, K=16, of the 232,448 a block may opt
// into).
#pragma once

#include "common.cuh"

namespace amt {

// Dynamic shared memory of one kBatched CTA (see the layout in
// psi_fwd_batched below).
inline size_t batched_fwd_smem_bytes(int D, int unroll) {
  const size_t n = 2 * static_cast<size_t>(D);
  const size_t kp = chunk_pitch(unroll);
  const size_t warps = threads_for(D) / 32;
  return 3 * n * n * 4 +
         (3 * n * kp + 4 * n + 2 * kp + 2 * kLimb * warps) * 4;
}

// The kBatched body of psi_fwd_kernel (deferred norm): loss[col] and the
// block checkpoints ck, one block at a time.
template <int P>
__device__ void psi_fwd_batched(const uint32_t* abt, const uint32_t* bbt,
                                const uint32_t* rbt, uint32_t* free_smem,
                                const float* __restrict__ t0,
                                const float* __restrict__ se,
                                float* __restrict__ loss,
                                float* __restrict__ ck, int n, int n_steps,
                                int B, int unroll, float log_eps,
                                float norm_eps) {
  const int kp = chunk_pitch(unroll);
  // [n, kp] buffers first: 16-byte aligned after the 3 n^2 words
  float* yh = reinterpret_cast<float*>(free_smem);  // prepped y_k, hi
  float* yl = yh + n * kp;                            // kHigh lo parts
  float* yr = yl + n * kp;                            // fp32 y_k
  float* pv = yr + n * kp;              // two prepped states (hi, lo)
  float* sums = pv + 4 * n;             // [kp] x (ehat, n2)
  float* red = sums + 2 * kp;           // 2 kLimb x warps partials

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < n;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;
  const int n_blocks = (n_steps + unroll - 1) / unroll;

  float t = active ? t0[i * stride + col] : 0.f;
  float acc = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * unroll;
    const int kn = min(unroll, n_steps - k0);
    if (active) ck[blk * plane + i * stride + col] = t;
    __syncthreads();   // the last block's limb has read the buffers
    if (active) store_vec<P>(pv, pv + n, i, t);
    // --- the spine: the state chain only
    float s = se[k0 * stride + col];
    float y = 0.f;
    for (int k = 0; k < kn; ++k) {
      __syncthreads();
      const float s_next = k + 1 < kn ? se[(k0 + k + 1) * stride + col] : 0.f;
      const float* ih = pv + 2 * n * (k & 1);
      float* oh = pv + 2 * n * ((k + 1) & 1);
      if (active) {
        float a, b;
        row_dot2<P>(abt, bbt, ih, ih + n, n, i, a, b);
        y = a + s * b;
        store_vec<P>(oh, oh + n, i, y);
        store_vec<P>(yh + i * kp, yl + i * kp, k, y);
        yr[i * kp + k] = y;
      }
      s = s_next;
    }
    __syncthreads();
    // --- the limb: Rb [y_c0 .. y_c0+7] a chunk at a time, then the sums
    for (int c0 = 0; c0 < kn; c0 += kLimb) {
      float ru[kLimb], v[2 * kLimb], out[2 * kLimb];
      if (active) {
        dot_chunk<P, true>(rbt + i, n, yh + c0, yl + c0, kp, n, ru);
      }
#pragma unroll
      for (int q = 0; q < kLimb; ++q) {
        const float yq = active ? yr[i * kp + c0 + q] : 0.f;
        v[2 * q] = active ? yq * ru[q] : 0.f;
        v[2 * q + 1] = yq * yq;
      }
      block_sum_n<2 * kLimb>(v, red, out);
      if (i == 0) {
        for (int q = 0; q < kLimb && c0 + q < kn; ++q) {
          sums[2 * (c0 + q)] = out[2 * q];
          sums[2 * (c0 + q) + 1] = out[2 * q + 1];
        }
      }
      __syncthreads();   // red is written again by the next chunk
    }
    // --- the loss tail in step order, then the exit renorm
    if (i == 0) {
      float n2p = 1.f;
      for (int k = 0; k < kn; ++k) {
        const float sk = se[(k0 + k) * stride + col];
        float ehat = sums[2 * k];
        ehat *= 2.f;
        const float e = ehat / floor_at(n2p, norm_eps);
        acc -= logf(floor_at(1.f + e * sk, log_eps));
        n2p = sums[2 * k + 1];
      }
    }
    t = y * rsqrtf(floor_at(sums[2 * (kn - 1) + 1], norm_eps));
  }
  if (i == 0) loss[col] = acc;
}

// Every mode fits shared memory to D=69 at most (160 threads; kBatched to
// D=66), so past one column a CTA the kernel is compiled for at most 256
// threads a CTA, which leaves the G columns' accumulators (and kBatched's
// chunk) registers; one column a CTA keeps the one-column kernel's
// 1024-thread bound.
template <int P, bool DEFER, int MODE, int G>
__global__ void __launch_bounds__(MODE == kBatched || G > 1 ? 256 : 1024)
    psi_fwd_kernel(const float* __restrict__ ab, const float* __restrict__ bb,
                   const float* __restrict__ rb, const float* __restrict__ t0,
                   const float* __restrict__ se, float* __restrict__ loss,
                   float* __restrict__ ys, float* __restrict__ n2s,
                   float* __restrict__ ck, int D, int n_steps, int B,
                   int unroll, int span, float log_eps, float norm_eps) {
  constexpr bool kRows = MODE == kStream || MODE == kRecompute;
  // the recompute's update products alone run faster less unrolled at
  // G >= 4 (at D=64, B=1024 on an H100 at 700 W: 104 ms at G=8 unrolled
  // once, 138-140 at 2, 4 or 8)
  constexpr int kDotUnroll =
      MODE != kRecompute ? kColsUnroll : (G >= 8 ? 1 : (G >= 4 ? 4 : 8));
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 2 * D;
  uint32_t* abt = smem;
  uint32_t* bbt = abt + n * n;
  uint32_t* rbt = bbt + n * n;
  if constexpr (MODE == kBatched) {
    static_assert(G == 1, "the batched mode runs one column a CTA");
    load_matrix_t<P>(abt, ab, n);
    load_matrix_t<P>(bbt, bb, n);
    load_matrix_t<P>(rbt, rb, n);
    psi_fwd_batched<P>(abt, bbt, rbt, rbt + n * n, t0, se, loss, ck, n,
                       n_steps, B, unroll, log_eps, norm_eps);
    return;
  }
  // [n, G] buffers, 16-byte aligned after the 3 n^2 words (n is even)
  float* th = reinterpret_cast<float*>(rbt + n * n);  // prepped states t
  float* tl = th + n * G;
  float* yh = tl + n * G;                             // prepped y
  float* yl = yh + n * G;
  float* red = yl + n * G;                            // 2G x warps partials

  const int col0 = blockIdx.x * G;
  const int i = threadIdx.x;
  const bool active = i < n;
  // offsets in size_t: n_steps * B, and n_steps * 2D * B of the stream, may
  // pass 2^31
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;
  // the last group's columns past B are masked (one column a CTA never is,
  // and compiles to the unmasked kernel)
  bool live[G];
#pragma unroll
  for (int g = 0; g < G; ++g) live[g] = G == 1 || col0 + g < B;

  load_matrix_t<P>(abt, ab, n);
  load_matrix_t<P>(bbt, bb, n);
  if (MODE != kRecompute) load_matrix_t<P>(rbt, rb, n);

  // kRecompute: steps k_lo .. k_hi - 1 of span blockIdx.y, each block
  // from its checkpoint (the next one in t_ck, fetched in a block's last
  // step, replaces the exit renorm); otherwise every step from t0
  const int k_lo = MODE == kRecompute ? blockIdx.y * span : 0;
  const int k_hi = MODE == kRecompute ? min(k_lo + span, n_steps) : n_steps;
  const float* tin =
      MODE == kRecompute ? t0 + (k_lo / unroll) * plane : t0;
  float t[G], t_ck[G], acc[G], n2p[G], s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    t[g] = (active && live[g]) ? tin[i * stride + col0 + g] : 0.f;
    t_ck[g] = 0.f;
    acc[g] = 0.f;
    n2p[g] = 1.f;
    s[g] = (k_lo < k_hi && live[g]) ? se[k_lo * stride + col0 + g] : 0.f;
  }

  for (int k = k_lo; k < k_hi; ++k) {
    if (MODE == kCkpt && active && k % unroll == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (live[g]) ck[(k / unroll) * plane + i * stride + col0 + g] = t[g];
    }
    if (active) store_cols<P, G>(th, tl, i, t);
    __syncthreads();
    float s_next[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      s_next[g] = (k + 1 < k_hi && live[g])
                      ? se[(k + 1) * stride + col0 + g] : 0.f;
    if (MODE == kRecompute && active && (k + 1) % unroll == 0 &&
        k + 1 < k_hi) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (live[g])
          t_ck[g] = t0[((k + 1) / unroll) * plane + i * stride + col0 + g];
    }
    float y[G];
#pragma unroll
    for (int g = 0; g < G; ++g) y[g] = 0.f;
    if (active) {
      float a[G], b[G];
      dot2_cols<P, G, kDotUnroll>(abt + i, bbt + i, n, th, tl, n, a, b);
#pragma unroll
      for (int g = 0; g < G; ++g) y[g] = a[g] + s[g] * b[g];
      store_cols<P, G>(yh, yl, i, y);
      if (kRows) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (live[g]) ys[k * plane + i * stride + col0 + g] = y[g];
      }
    }
    __syncthreads();
    // the expectation feeds the loss alone, which kRecompute does not write
    float ru[G];
#pragma unroll
    for (int g = 0; g < G; ++g) ru[g] = 0.f;
    if (active && MODE != kRecompute)
      dot_cols<P, G>(rbt + i, n, yh, yl, n, ru);
    float v[2 * G], sums[2 * G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      v[2 * g] = y[g] * ru[g];
      v[2 * g + 1] = y[g] * y[g];
    }
    block_sum_cols<2 * G>(v, red, sums);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float ehat = sums[2 * g];
      const float n2 = sums[2 * g + 1];
      ehat *= 2.f;
      if (kRows && i == 0 && live[g]) n2s[k * stride + col0 + g] = n2;
      if (DEFER) {
        const float e = ehat / floor_at(n2p[g], norm_eps);
        acc[g] -= logf(floor_at(1.f + e * s[g], log_eps));
        if ((k + 1) % unroll == 0) {
          t[g] = MODE == kRecompute ? t_ck[g]
                                    : y[g] * rsqrtf(floor_at(n2, norm_eps));
          n2p[g] = 1.f;
        } else {
          t[g] = y[g];
          n2p[g] = n2;
        }
      } else {
        acc[g] -= logf(floor_at(1.f + ehat * s[g], log_eps));
        t[g] = (MODE == kRecompute && (k + 1) % unroll == 0)
                   ? t_ck[g] : y[g] * rsqrtf(floor_at(n2, norm_eps));
      }
      s[g] = s_next[g];
    }
  }
  if (MODE != kRecompute && i == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (live[g]) loss[col0 + g] = acc[g];
  }
}

// Dynamic shared memory of one forward CTA of G columns: Ab, Bb, Rb (4
// bytes an element), four [2D, G] state buffers and 2G partials a warp
// (ops/block.py psi_fwd_smem_bytes mirrors it).
inline size_t fwd_smem_bytes(int D, int G) {
  const size_t n = 2 * static_cast<size_t>(D);
  const size_t warps = threads_for(D) / 32;
  return 3 * n * n * 4 + (4 * n * G + 2 * G * warps) * 4;
}

// Launch the forward for the runtime precision, norm flag and G columns a
// CTA: ceil(B / G) CTAs, or, with kRecompute, ceil(B / G) x
// ceil(n_steps / span) (t0 then holds the segment's checkpoints; span, the
// steps of one CTA, is a whole number of blocks). kBatched takes the
// deferred norm and G = 1 only and writes loss and ck. The pointers a MODE
// does not write may be null.
template <int MODE>
cudaError_t launch_fwd(const float* ab, const float* bb, const float* rb,
                       const float* t0, const float* se, float* loss,
                       float* ys, float* n2s, float* ck, int D, int n_steps,
                       int B, int unroll, int span, float log_eps,
                       float norm_eps, int precision, bool defer, int G,
                       cudaStream_t stream) {
  if (unroll < 1 || span < unroll || span % unroll || G < 1) {
    return cudaErrorInvalidValue;
  }
  // the batched mode has the deferred norm and one column a CTA only
  if (MODE == kBatched && (!defer || G != 1)) return cudaErrorInvalidValue;
  const dim3 grid((B + G - 1) / G,
                  MODE == kRecompute ? (n_steps + span - 1) / span : 1);
  if (grid.y == 0) return cudaSuccess;
  const auto launch = [&](auto g) {
    constexpr int kG = decltype(g)::value;
    const size_t smem = MODE == kBatched ? batched_fwd_smem_bytes(D, unroll)
                                         : fwd_smem_bytes(D, kG);
    return dispatch(precision, defer, [&](auto p, auto d) {
      return launch_smem(
          psi_fwd_kernel<decltype(p)::value, decltype(d)::value, MODE, kG>,
          grid, threads_for(D), smem, stream, ab, bb, rb, t0, se, loss, ys,
          n2s, ck, D, n_steps, B, unroll, span, log_eps, norm_eps);
    });
  };
  if constexpr (MODE == kBatched) {
    return launch(std::integral_constant<int, 1>{});
  } else {
    return dispatch_cols(G, launch);
  }
}

}  // namespace amt
