// The three [2D,2D] parameter cotangents of the psi training adjoint, for
// Hopper.
//
// Replaces the lane-contraction products that the TPU kernel
// audio_mps_tpu/ops/pallas_block.py _make_psi_bwd_kernel_stream computes in
// its own body (dotnt at :1035 and :1059-1060, accumulated over the grid):
//   dAb = sum_k dy_k t_k^T        dBb = sum_k dy_k (s_k t_k)^T
//   dRb = sum_k dru_k y_k^T,      dru_k = (2 dehat_k) y_k
// each a [2D, M] x [M, 2D] product over M = n_steps * B (step, column)
// pairs. The operands are built on the fly from the streams of
// psi_train_fwd.cu and psi_train_bwd.cu: t_0 = t0, and
// t_k = y_{k-1} * (renorm ? rsqrt(max(n2_{k-1}, eps)) : 1) with the
// forward's own instructions, so it equals the forward's state bit for bit.
//
// Precision (the TPU's dotnt): highest multiplies fp32 values; high splits
// both operands into bf16 (hi, lo) and sums hi*hi + hi*lo + lo*hi in fp32;
// default rounds both operands to bf16 once.
//
// Design. Stage 1: CTA (tile, job, split) owns one 128 x 128 tile of one of
// the three products and a fixed range of steps; it walks its steps 16
// columns at a time, stages the two operand slices in shared memory and
// accumulates an 8 x 8 register tile per thread (rows ty + 16 r, columns
// tx + 16 c, so the operand reads of a warp are a broadcast and 16
// consecutive words). It writes its partial tile to a workspace. Stage 2
// sums the partials of each element in split order. The split is fixed by
// n_steps alone, and nothing is atomic, so the result is the same on every
// run and every card.
//
// What bounds it: 3 x 2 x (2D)^2 x M FLOPs (206 GFLOP at D=64, B=128,
// T=16384) on the fp32 FMA pipes against ~2 GB of streams read, so
// operations (3.1 ms at the fp32 peak). A tensor-core (wgmma) version of
// the high/default menu is later work.
#include "common.cuh"

namespace amt {

constexpr int kTile = 128;     // output tile edge
constexpr int kChunk = 16;     // columns staged per pass
constexpr int kPitch = kTile + 2;  // staged row pitch: conflict-free stores
constexpr int kThreads = 256;  // 16 x 16, an 8 x 8 register tile each
constexpr int kMaxSplit = 88;  // 3 jobs x 88 = 264 CTAs: two per SM

inline int n_split(int n_steps) {
  return n_steps < 1 ? 1 : (n_steps < kMaxSplit ? n_steps : kMaxSplit);
}

template <int P>
__device__ __forceinline__ void stage(float* hi, float* lo, int idx, float x) {
  if (P == kHigh) {
    float h, l;
    split_bf16(x, h, l);
    hi[idx] = h;
    lo[idx] = l;
  } else if (P == kDefault) {
    hi[idx] = bf16_round(x);
  } else {
    hi[idx] = x;
  }
}

// job 0: (dy, t) -> dAb; job 1: (dy, s t) -> dBb; job 2: (dru, y) -> dRb
template <int P, bool DEFER>
__global__ void __launch_bounds__(kThreads)
    psi_cotangents_kernel(const float* __restrict__ dys,
                          const float* __restrict__ ys,
                          const float* __restrict__ t0,
                          const float* __restrict__ se,
                          const float* __restrict__ n2s,
                          const float* __restrict__ dehats,
                          float* __restrict__ partial, int D, int n_steps,
                          int B, int unroll, float norm_eps) {
  __shared__ float xh[kChunk * kPitch], xl[kChunk * kPitch];
  __shared__ float yh[kChunk * kPitch], yl[kChunk * kPitch];
  __shared__ float cs[kChunk], cm[kChunk];  // per-column scale / multiplier

  const int n = 2 * D;
  const int tiles = (n + kTile - 1) / kTile;
  const int i0 = (blockIdx.x / tiles) * kTile;
  const int j0 = (blockIdx.x % tiles) * kTile;
  const int job = blockIdx.y;
  const int split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int k_lo = static_cast<int>(static_cast<long long>(n_steps) * split /
                                    nsplit);
  const int k_hi = static_cast<int>(static_cast<long long>(n_steps) *
                                    (split + 1) / nsplit);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lc = threadIdx.x & (kChunk - 1);   // staged column of this thread
  const int lr = threadIdx.x >> 4;             // first staged row
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(n) * B;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int k = k_lo; k < k_hi; ++k) {
    const bool prev_renorm = !DEFER || k % unroll == 0;
    const float* yk = ys + k * plane;
    const float* yprev = k > 0 ? ys + (k - 1) * plane : t0;
    const float* dyk = dys + k * plane;
    for (int c0 = 0; c0 < B; c0 += kChunk) {
      __syncthreads();  // the previous pass is done with the staging
      if (threadIdx.x < kChunk) {
        const int col = c0 + threadIdx.x;
        float sc = 1.f, m = 0.f;
        if (col < B) {
          if (k > 0 && prev_renorm)
            sc = rsqrtf(floor_at(n2s[(k - 1) * stride + col], norm_eps));
          m = job == 1 ? se[k * stride + col]
                       : 2.f * dehats[k * stride + col];
        }
        cs[threadIdx.x] = sc;
        cm[threadIdx.x] = m;
      }
      __syncthreads();
      const int col = c0 + lc;
      const float sc = cs[lc], m = cm[lc];
#pragma unroll
      for (int q = 0; q < kTile / 16; ++q) {
        const int lrow = lr + 16 * q;
        float xv = 0.f, yv = 0.f;
        if (col < B) {
          const int xi = i0 + lrow, yj = j0 + lrow;
          if (xi < n) {
            const size_t at = xi * stride + col;
            xv = job == 2 ? m * yk[at] : dyk[at];
          }
          if (yj < n) {
            const size_t at = yj * stride + col;
            if (job == 2) {
              yv = yk[at];
            } else {
              const float t = k > 0 && prev_renorm ? yprev[at] * sc
                                                   : yprev[at];
              yv = job == 1 ? m * t : t;
            }
          }
        }
        stage<P>(xh, xl, lc * kPitch + lrow, xv);
        stage<P>(yh, yl, lc * kPitch + lrow, yv);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = xh[kk * kPitch + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = yh[kk * kPitch + tx + 16 * c];
        if (P == kHigh) {
          float al[8], bl[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) al[r] = xl[kk * kPitch + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < 8; ++c) bl[c] = yl[kk * kPitch + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
              acc[r][c] = fmaf(a[r], bl[c], acc[r][c]);
              acc[r][c] = fmaf(al[r], b[c], acc[r][c]);
            }
        } else {
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
      }
    }
  }

  float* out = partial + (static_cast<size_t>(job) * nsplit + split) * n * n;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < n) out[static_cast<size_t>(i) * n + j] = acc[r][c];
    }
  }
}

// out[job][e] = sum over split, in split order, of partial[job][split][e].
__global__ void psi_cotangents_reduce(const float* __restrict__ partial,
                                      float* __restrict__ out, int nn,
                                      int nsplit) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int job = blockIdx.y;
  if (e >= nn) return;
  const float* p = partial + static_cast<size_t>(job) * nsplit * nn + e;
  float s = 0.f;
  for (int q = 0; q < nsplit; ++q) s += p[static_cast<size_t>(q) * nn];
  out[static_cast<size_t>(job) * nn + e] = s;
}

template <int P, bool DEFER>
cudaError_t launch_cotangents(const float* dys, const float* ys,
                              const float* t0, const float* se,
                              const float* n2s, const float* dehats,
                              float* partial, float* out, int D, int n_steps,
                              int B, int unroll, float norm_eps,
                              cudaStream_t stream) {
  const int n = 2 * D;
  const int tiles = (n + kTile - 1) / kTile;
  const int nsplit = n_split(n_steps);
  psi_cotangents_kernel<P, DEFER>
      <<<dim3(tiles * tiles, 3, nsplit), kThreads, 0, stream>>>(
          dys, ys, t0, se, n2s, dehats, partial, D, n_steps, B, unroll,
          norm_eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nn = n * n;
  psi_cotangents_reduce<<<dim3((nn + 255) / 256, 3), 256, 0, stream>>>(
      partial, out, nn, nsplit);
  return cudaGetLastError();
}

}  // namespace amt

extern "C" {

// Floats of the stage-1 workspace: 3 jobs x splits x (2D)^2.
size_t amt_psi_cotangents_workspace_floats(int D, int n_steps) {
  const size_t n = 2 * static_cast<size_t>(D);
  return 3 * static_cast<size_t>(amt::n_split(n_steps)) * n * n;
}

// out[3, 2D, 2D] = (dAb, dBb, dRb) from dys/ys [n_steps, 2D, B], t0 [2D, B],
// se, n2s, dehats [n_steps, B]; partial holds
// amt_psi_cotangents_workspace_floats floats. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_psi_cotangents(const float* dys, const float* ys, const float* t0,
                       const float* se, const float* n2s, const float* dehats,
                       float* partial, float* out, int D, int n_steps, int B,
                       int unroll, float norm_eps, int precision,
                       int defer_norm, void* stream) {
  return static_cast<int>(amt::dispatch(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::launch_cotangents<decltype(p)::value, decltype(d)::value>(
            dys, ys, t0, se, n2s, dehats, partial, out, D, n_steps, B, unroll,
            norm_eps, static_cast<cudaStream_t>(stream));
      }));
}

}  // extern "C"
