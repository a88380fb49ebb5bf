// Adjoint of psi's spine/limbs training pair (block-complex layout,
// deferred norm) for Hopper, with its recompute and its parameter
// cotangents in the same CTA.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py
// _make_psi_bwd_kernel_batched (:338; the factory's batched=True). One CTA
// per column loops over the blocks of unroll steps, last first, and for
// each block does what the TPU kernel does in one grid step:
//   1. the spine re-run from the checkpoint ck[j]: y_k = Ab t_k + s_k Bb t_k,
//      t_{k+1} = y_k, into a [2D, K] shared buffer (st);
//   2. the batched tail, a chunk of kLimb states per walk of an Rb row
//      (dot_chunk): RU = Rb Y and, from one block_sum_n a chunk, ehat_k and
//      n2_k; then the forward-computable e, arg, darg, dehat and dn2_new of
//      every step, dru_k = 2 dehat_k y_k (dru) and the chain-independent
//      part c_k = (2 dn2_k y_k + 2 dehat_k RU_k) + Rb^T dru_k (into dy);
//   3. the serial reverse spine: dy_k = dt + c_k, then
//      dt <- Ab^T dy_k + s_k (Bb^T dy_k), dse_k = darg_k e_k +
//      sum((Bb^T dy_k) .* t_k);
//   4. the block's three lane contractions dy t^T, dy (s t)^T and dru y^T,
//      added to the CTA's own row of part[B, 3, 2D, 2D] in device memory.
// The dn2 bookkeeping is psi_train_bwd.cu's: the block-exit renorm seeds
// the block's last step (dn2_exit from the dt entering it), a block's first
// step drops its dn2_new (its n2p is the constant 1), and after the last
// real step no cotangent enters (dt = 0, so dn2_exit = 0). The loop runs
// over the real steps only: dse is [n_steps, B], not the TPU's padded rows.
// Nothing of ys or dy reaches device memory, and there is no separate
// recompute launch.
//
// Design. The chain needs Rb y, Rb^T dru, Ab^T dy and Bb^T dy, so each
// constant is stored once, row-major with rows padded to 2D+1 words
// (198,144 bytes at D=64; row and column walks both free of bank
// conflicts), as in psi_train_bwd.cu. That leaves 34,304 bytes of the
// 232,448 a block may opt into: the block's states, dru and dy at
// [2D, K] (a row pitch of chunk_pitch(K) words, 30,720 bytes at D=64,
// K=16), the entry state, one prepped vector and the step scalars. The
// TPU's fourth buffer s t is not kept: the contraction forms it from the
// states and s. Without room for prepped copies, every state, dru and dy
// is prepped (bf16 split or rounding) as it is loaded, to the bits that
// store_vec gives. The three [2D,2D] accumulators (192 KB) cannot sit
// beside the constants, so each CTA adds its block's sums to its own row of
// part (one read and one write of 3 (2D)^2 floats a block, by consecutive
// threads on consecutive entries); the wrapper (ops/block.py
// psi_batched_bwd) adds the rows in a fixed order: no atomics, and two
// runs are equal bit for bit. In the contraction thread i owns column i of
// the three sums and keeps its column's states (t_k, s_k t_k, y_k; kCot at
// a time, prepped) in registers, and dy and dru, packed in place once the
// chain is done, come as 16-byte broadcast loads: kCot FMAs for two loads.
//
// What bounds it: per column-step, the re-run's two [2D,2D] x [2D] products
// and the chain's two (one FMA per 4-byte shared load), the tail's two
// (kLimb FMAs a load) and the three contractions (kCot FMAs for two
// loads), with about four CTA barriers a step; device memory moves ck, se,
// dse and the partial rows (3 (2D)^2 x 8 bytes a block, mostly from L2).
// So shared-memory reads and barrier latency bound it.
#include "common.cuh"

namespace amt {

// Row results of (M1 v) and (M2 v) for v[j] = x[j * vstride], x fp32 values
// prepped as they are loaded (the same bits as dot2_strided on store_vec's
// vector), the matrices walked at m[j * mstride].
template <int P>
__device__ __forceinline__ void dot2_raw(const uint32_t* m1,
                                         const uint32_t* m2, int mstride,
                                         const float* x, int vstride, int n,
                                         float& out1, float& out2) {
  if (P == kHigh) {
    float a1 = 0.f, a2 = 0.f, a3 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      float h, l;
      split_bf16(x[j * vstride], h, l);
      const uint32_t w1 = m1[j * mstride], w2 = m2[j * mstride];
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
      float v = x[j * vstride];
      if (P == kDefault) v = bf16_round(v);
      a = fmaf(__uint_as_float(m1[j * mstride]), v, a);
      b = fmaf(__uint_as_float(m2[j * mstride]), v, b);
    }
    out1 = a;
    out2 = b;
  }
}

// States a pass of the cotangent contraction keeps in registers.
constexpr int kCot = 16;

// Words of dynamic shared memory before the [2D, K] buffers: the three
// padded constants, rounded up to keep the buffers 16-byte aligned.
__host__ __device__ inline size_t batched_bwd_const_words(int n) {
  return (3 * static_cast<size_t>(n) * (n + 1) + 3) / 4 * 4;
}

template <int P>
__global__ void __launch_bounds__(256)
    psi_batched_bwd_kernel(const float* __restrict__ ab,
                           const float* __restrict__ bb,
                           const float* __restrict__ rb,
                           const float* __restrict__ ck,
                           const float* __restrict__ se,
                           const float* __restrict__ g,
                           float* __restrict__ dse, float* __restrict__ dt0,
                           float* __restrict__ part, int D, int n_steps,
                           int B, int unroll, float log_eps,
                           float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 2 * D;
  const int ld = n + 1;
  const int kp = chunk_pitch(unroll);
  const int warps = blockDim.x >> 5;
  uint32_t* abm = smem;
  uint32_t* bbm = abm + n * ld;
  uint32_t* rbm = bbm + n * ld;
  float* st = reinterpret_cast<float*>(smem + batched_bwd_const_words(n));
  float* dyb = st + n * kp;     // c_k, then dy_k      [2D, K]
  float* dru = dyb + n * kp;    // 2 dehat_k y_k       [2D, K]
  float* tin = dru + n * kp;    // the block's entry state t_0
  float* wh = tin + n;          // prepped dy_k
  float* wl = wh + n;
  float* sv = wl + n;           // s_k, e_k, darg_k, dn2_new_k
  float* ev = sv + kp;
  float* dgv = ev + kp;
  float* d2v = dgv + kp;
  float* red = d2v + kp;        // 2 kLimb x warps partials
  float* red2 = red + 2 * kLimb * warps;   // 32 partials

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < n;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;
  const size_t nn = static_cast<size_t>(n) * n;
  float* prow = part + col * 3 * nn;
  const int n_blocks = (n_steps + unroll - 1) / unroll;

  load_matrix_pad<P>(abm, ab, n);
  load_matrix_pad<P>(bbm, bb, n);
  load_matrix_pad<P>(rbm, rb, n);

  const float gc = g[col];
  float dt = 0.f;   // the cotangent of the state after the block
  for (int blk = n_blocks - 1; blk >= 0; --blk) {
    const int k0 = blk * unroll;
    const int kn = min(unroll, n_steps - k0);
    __syncthreads();   // the later block is done with every buffer
    if (active) tin[i] = ck[blk * plane + i * stride + col];
    for (int k = i; k < kn; k += blockDim.x)
      sv[k] = se[(k0 + k) * stride + col];
    __syncthreads();

    // 1. the spine, re-run from the checkpoint
    for (int k = 0; k < kn; ++k) {
      if (active) {
        float a, b;
        if (k == 0) {
          dot2_raw<P>(abm + i * ld, bbm + i * ld, 1, tin, 1, n, a, b);
        } else {
          dot2_raw<P>(abm + i * ld, bbm + i * ld, 1, st + (k - 1), kp, n, a,
                      b);
        }
        st[i * kp + k] = a + sv[k] * b;
      }
      __syncthreads();
    }

    // 2a. the tail: RU, ehat and n2 a chunk at a time, then every step's
    // scalars; dy holds 2 dehat RU, dru holds 2 dehat y
    float n2prev = 1.f;   // n2p of the block's first step
    for (int c0 = 0; c0 < kn; c0 += kLimb) {
      float ru[kLimb], v[2 * kLimb], out[2 * kLimb];
      if (active) dot_chunk<P, false>(rbm + i * ld, 1, st + c0, nullptr, kp, n,
                                      ru);
#pragma unroll
      for (int q = 0; q < kLimb; ++q) {
        const float y = active ? st[i * kp + c0 + q] : 0.f;
        v[2 * q] = active ? y * ru[q] : 0.f;
        v[2 * q + 1] = y * y;
      }
      block_sum_n<2 * kLimb>(v, red, out);
#pragma unroll
      for (int q = 0; q < kLimb; ++q) {
        const int k = c0 + q;
        if (k < kn) {
          float ehat = out[2 * q];
          ehat *= 2.f;
          const float s = sv[k];
          const float n2p_c = floor_at(n2prev, norm_eps);
          const float e = ehat / n2p_c;
          const float arg = floor_at(1.f + e * s, log_eps);
          const float darg = arg > log_eps ? -gc / arg : 0.f;
          const float de = darg * s;
          const float dehat = de / n2p_c;
          if (i == 0) {
            ev[k] = e;
            dgv[k] = darg;
            d2v[k] = n2prev > norm_eps ? -de * e / n2p_c : 0.f;
          }
          if (active) {
            dyb[i * kp + k] = ru[q] * (2.f * dehat);
            dru[i * kp + k] = (2.f * dehat) * st[i * kp + k];
          }
          n2prev = out[2 * q + 1];
        }
      }
      __syncthreads();   // red is written again by the next chunk
    }
    // the block-exit renorm's adjoint: dt enters scaled, dn2_exit seeds the
    // last step
    const float dinv =
        block_sum(active ? dt * st[i * kp + kn - 1] : 0.f, red2);
    const float inv = rsqrtf(floor_at(n2prev, norm_eps));
    const float dn2_exit =
        n2prev > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
    dt *= inv;

    // 2b. c_k = (2 dn2_k y_k + 2 dehat_k RU_k) + Rb^T dru_k
    for (int c0 = 0; c0 < kn; c0 += kLimb) {
      float rtd[kLimb];
      if (active) {
        dot_chunk<P, false>(rbm + i, ld, dru + c0, nullptr, kp, n, rtd);
#pragma unroll
        for (int q = 0; q < kLimb; ++q) {
          const int k = c0 + q;
          if (k < kn) {
            const float dn2 = k + 1 < kn ? d2v[k + 1] : dn2_exit;
            const float y = st[i * kp + k];
            dyb[i * kp + k] = (y * (2.f * dn2) + dyb[i * kp + k]) + rtd[q];
          }
        }
      }
    }

    // 3. the serial reverse spine
    for (int k = kn - 1; k >= 0; --k) {
      const float dy = active ? dt + dyb[i * kp + k] : 0.f;
      if (active) {
        dyb[i * kp + k] = dy;
        store_vec<P>(wh, wl, i, dy);
      }
      __syncthreads();
      float at = 0.f, du = 0.f, tk = 0.f;
      if (active) {
        dot2_strided<P>(abm + i, bbm + i, ld, wh, wl, n, at, du);
        tk = k > 0 ? st[i * kp + k - 1] : tin[i];
      }
      const float dsum = block_sum(du * tk, red2);
      if (i == 0) dse[(k0 + k) * stride + col] = dgv[k] * ev[k] + dsum;
      dt = at + sv[k] * du;
    }
    __syncthreads();

    // 4. the block's cotangents into the CTA's row: dAb += dy t^T,
    // dBb += dy (s t)^T, dRb += dru y^T. dy and dru are packed in place
    // once (pack_elem: the kHigh bf16 pair, the kDefault rounding); thread
    // i owns column b = i of all three, keeps its kCot prepped states in
    // registers and walks the rows a, two 16-byte broadcast loads of dy or
    // dru feeding kCot FMAs (3 kCot at kHigh), and adds each row's sums to
    // part (consecutive threads, consecutive words)
    if (active) {
      for (int k = 0; k < kn; ++k) {
        dyb[i * kp + k] = __uint_as_float(pack_elem<P>(dyb[i * kp + k]));
        dru[i * kp + k] = __uint_as_float(pack_elem<P>(dru[i * kp + k]));
      }
    }
    __syncthreads();
    if (active) {
      for (int m = 0; m < 3; ++m) {
        const float* xs = m == 2 ? dru : dyb;
        for (int c0 = 0; c0 < kn; c0 += kCot) {
          float yh[kCot], yl[kCot];
#pragma unroll
          for (int q = 0; q < kCot; ++q) {
            const int k = c0 + q;
            float y = 0.f;
            if (k < kn) {
              y = m == 2 ? st[i * kp + k]
                         : (k > 0 ? st[i * kp + k - 1] : tin[i]);
              if (m == 1) y *= sv[k];
            }
            if (P == kHigh) {
              split_bf16(y, yh[q], yl[q]);
            } else {
              yh[q] = P == kDefault ? bf16_round(y) : y;
              yl[q] = 0.f;
            }
          }
          float* dst = prow + m * nn + i;
          for (int a = 0; a < n; ++a) {
            const float4* row =
                reinterpret_cast<const float4*>(xs + a * kp + c0);
            float a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
            for (int c = 0; c < kCot / 4; ++c) {
              const float4 v = row[c];
              const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int q = 4 * c + r;
                if (c0 + q < kn) {
                  const uint32_t u = __float_as_uint(w[r]);
                  if (P == kHigh) {
                    const float xh = __uint_as_float(u & 0xffff0000u);
                    const float xl = __uint_as_float(u << 16);
                    a1 = fmaf(xh, yh[q], a1);
                    a2 = fmaf(xh, yl[q], a2);
                    a3 = fmaf(xl, yh[q], a3);
                  } else {
                    a1 = fmaf(w[r], yh[q], a1);
                  }
                }
              }
            }
            const float sum = P == kHigh ? (a1 + a2) + a3 : a1;
            const size_t at = static_cast<size_t>(a) * n;
            dst[at] = (blk == n_blocks - 1 && c0 == 0) ? sum : dst[at] + sum;
          }
        }
      }
    }
  }
  if (active) dt0[i * stride + col] = dt;
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one batched adjoint CTA: the padded constants,
// three [2D, K] buffers, three [2D] vectors, four [K] scalar rows and the
// reductions (231,104 bytes at D=64, K=16).
size_t amt_psi_batched_bwd_smem_bytes(int D, int unroll) {
  const size_t n = 2 * static_cast<size_t>(D);
  const size_t kp = amt::chunk_pitch(unroll);
  const size_t warps = amt::threads_for(D) / 32;
  return (amt::batched_bwd_const_words(static_cast<int>(n)) + 3 * n * kp +
          3 * n + 4 * kp + 2 * amt::kLimb * warps + 32) * 4;
}

// dse[n_steps, B], dt0[2D, B] and part[B, 3, 2D, 2D] (each column's dAb,
// dBb and dRb, for the caller to add over the columns) from the loss
// cotangent g[B] and the checkpoints ck[ceil(n_steps / unroll), 2D, B] of
// psi_batched_fwd.cu; see the note above. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_psi_batched_bwd(const float* ab, const float* bb, const float* rb,
                        const float* ck, const float* se, const float* g,
                        float* dse, float* dt0, float* part, int D,
                        int n_steps, int B, int unroll, float log_eps,
                        float norm_eps, int precision, void* stream) {
  if (unroll < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    return amt::launch_smem(
        amt::psi_batched_bwd_kernel<decltype(p)::value>, B,
        amt::threads_for(D), amt_psi_batched_bwd_smem_bytes(D, unroll),
        static_cast<cudaStream_t>(stream), ab, bb, rb, ck, se, g, dse, dt0,
        part, D, n_steps, B, unroll, log_eps, norm_eps);
  }));
}

}  // extern "C"
