// rho SDE sampler (Euler–Maruyama) in the split layout for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_scan.py
// _make_rho_sample_kernel (via rho_sample_pallas), the rho sampler at
// D % 8 != 0 or with kernel_layout="split". One step on the current factor
// segment H ([D, rank] real and imaginary parts per chain), as the
// reference conditions each step on the realised increment
// (model.py:103-112):
//   gx  = X^T H,  e = sum(H_r gx_r + H_i gx_i)   (the expectation on the
//                                                 current state, before the
//                                                 update, pallas_scan.py
//                                                 :694-702)
//   inc = e dt + noise[k];  samp += inc;  wave[k] = samp
//   y   = conj(C) H + (inc / A) conj(R) H
//   H   = p .* (y rsqrt(max(|y|^2, eps)))
// The kernel writes one running sum a chain; the caller multiplies by A
// (pallas_scan.py:786, which picks one of the identical lanes of an
// example, wave[:T, ::rank]).
//
// Design and bound as rho_split_fwd.cuh: one CTA owns one chain's segment
// and loops over all T steps, the constants resident in shared memory,
// thread t on the elements t, t + nt, ... of the segment; the three
// products of a step read the same prepped factor, so they run in one pass,
// and the two segment sums a step (e, then |y|^2) are warp shuffles and a
// block reduction. Latency bounds it; at 8 chains it occupies 8 SMs.
#include "rho_split_fwd.cuh"

namespace amt {

template <int P>
__global__ void __launch_bounds__(1024)
    rho_split_sample_kernel(const float* __restrict__ ccr,
                            const float* __restrict__ cci,
                            const float* __restrict__ rcr,
                            const float* __restrict__ rci,
                            const float* __restrict__ xtr,
                            const float* __restrict__ xti,
                            const float* __restrict__ pc,
                            const float* __restrict__ ps,
                            const float* __restrict__ h0r,
                            const float* __restrict__ h0i,
                            const float* __restrict__ noise,
                            const float* __restrict__ inv_a,
                            float* __restrict__ wave, int D, int T, int N,
                            int rank, float dt, float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int dd = D * D;
  const int n = D * rank;
  uint32_t* ccrt = smem;                          // transposed constants
  uint32_t* ccit = ccrt + dd;
  uint32_t* rcrt = ccit + dd;
  uint32_t* rcit = rcrt + dd;
  uint32_t* xtrt = rcit + dd;
  uint32_t* xtit = xtrt + dd;
  float* hr = reinterpret_cast<float*>(xtit + dd);  // the factor
  float* hi = hr + n;
  float* vr = hi + n;                              // prepped factor
  float* vi = vr + n;
  float* a1r = vi + n;                             // conj(C) H
  float* a1i = a1r + n;
  float* a2r = a1i + n;                            // conj(R) H
  float* a2i = a2r + n;
  float* pcs = a2i + n;                            // rotation
  float* pss = pcs + D;
  float* red = pss + D;                            // 2 x 32 partials

  const int ch = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t lanes = static_cast<size_t>(N) * rank;
  const size_t col0 = static_cast<size_t>(ch) * rank;

  load_matrix_t<P>(ccrt, ccr, D);
  load_matrix_t<P>(ccit, cci, D);
  load_matrix_t<P>(rcrt, rcr, D);
  load_matrix_t<P>(rcit, rci, D);
  load_matrix_t<P>(xtrt, xtr, D);
  load_matrix_t<P>(xtit, xti, D);
  for (int i = tid; i < D; i += nt) {
    pcs[i] = pc[i];
    pss[i] = ps[i];
  }
  for (int e = tid; e < n; e += nt) {
    const int r = e / D, i = e - r * D;
    const float a = h0r[i * lanes + col0 + r], b = h0i[i * lanes + col0 + r];
    hr[e] = a;
    hi[e] = b;
    vr[e] = prep<P>(a);
    vi[e] = prep<P>(b);
  }
  const float ia = inv_a[0];
  float samp = 0.f;
  float z = T > 0 ? noise[ch] : 0.f;

  for (int k = 0; k < T; ++k) {
    __syncthreads();
    const float z_next =
        k + 1 < T ? noise[static_cast<size_t>(k + 1) * N + ch] : 0.f;
    float e_part = 0.f;
    for (int e = tid; e < n; e += nt) {
      const int r = e / D, i = e - r * D;
      const float* xr = vr + r * D;
      const float* xi = vi + r * D;
      float gxr, gxi;
      cdot<P>(xtrt + i, xtit + i, D, xr, xi, D, gxr, gxi);
      e_part += hr[e] * gxr + hi[e] * gxi;
      cdot<P>(ccrt + i, ccit + i, D, xr, xi, D, a1r[e], a1i[e]);
      cdot<P>(rcrt + i, rcit + i, D, xr, xi, D, a2r[e], a2i[e]);
    }
    const float inc = col_sum(e_part, red) * dt + z;
    samp += inc;
    if (tid == 0) wave[static_cast<size_t>(k) * N + ch] = samp;
    const float s = inc * ia;
    float t_part = 0.f;
    for (int e = tid; e < n; e += nt) {
      const float yr = a1r[e] + s * a2r[e], yi = a1i[e] + s * a2i[e];
      a1r[e] = yr;
      a1i[e] = yi;
      t_part += yr * yr + yi * yi;
    }
    const float inv = rsqrtf(floor_at(col_sum(t_part, red + 32), norm_eps));
    for (int e = tid; e < n; e += nt) {
      const int i = e % D;
      float a, b;
      rotate_p(a1r[e] * inv, a1i[e] * inv, pcs[i], pss[i], a, b);
      hr[e] = a;
      hi[e] = b;
      vr[e] = prep<P>(a);
      vi[e] = prep<P>(b);
    }
    z = z_next;
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one sampler CTA: conj(C), conj(R), X^T (4
// bytes an element), eight [D, rank] vectors (the factor, its prepped copy,
// conj(C) H and conj(R) H), pc, ps and 64 reduction floats.
size_t amt_rho_split_sample_smem_bytes(int D, int rank) {
  const size_t d = static_cast<size_t>(D), n = d * rank;
  return 4 * (6 * d * d + 8 * n + 2 * d + 64);
}

// Running waveform wave[T, N] of N chains from noise[T, N] and the factors
// h0r, h0i [D, N * rank]; see the kernel note above. precision: 0 highest,
// 2 default. Returns a cudaError_t.
int amt_rho_split_sample(const float* ccr, const float* cci, const float* rcr,
                         const float* rci, const float* xtr, const float* xti,
                         const float* pc, const float* ps, const float* h0r,
                         const float* h0i, const float* noise,
                         const float* inv_a, float* wave, int D, int T, int N,
                         int rank, float dt, float norm_eps, int precision,
                         void* stream) {
  if (D < 1 || rank < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      amt::dispatch_split(precision, false, [&](auto p, auto) {
        return amt::launch_smem(
            amt::rho_split_sample_kernel<decltype(p)::value>, dim3(N),
            amt::rho_split_threads(D, rank),
            amt_rho_split_sample_smem_bytes(D, rank),
            static_cast<cudaStream_t>(stream), ccr, cci, rcr, rci, xtr, xti,
            pc, ps, h0r, h0i, noise, inv_a, wave, D, T, N, rank, dt,
            norm_eps);
      }));
}

}  // extern "C"
