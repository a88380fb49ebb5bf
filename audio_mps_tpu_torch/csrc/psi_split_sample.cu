// psi SDE sampler (Euler–Maruyama) in the split layout for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_scan.py
// _make_psi_sample_kernel (via psi_sample_pallas), the sampler at
// D % 8 != 0 or with kernel_layout="split". One step on the current state
// psi ([D] real and imaginary columns per chain), as the reference
// conditions each step on the realised increment (model.py:284-288):
//   ru  = R psi                              (four real products)
//   e   = 2 sum(psi_r ru_r + psi_i ru_i)     (the expectation, before the
//                                             update, pallas_scan.py:512-515)
//   inc = e dt + noise[k];  samp += inc;  wave[k] = samp
//   y   = C psi + (inc / A) ru               (ru reused, :520)
//   psi = conj(p) .* (y rsqrt(max(|y|^2, eps)))
// The kernel writes the running sum; the caller multiplies by A
// (pallas_scan.py:646).
//
// Design and bound as psi_split_fwd.cuh: one CTA owns one chain and loops
// over all T steps, C and R resident in shared memory, thread i on row i;
// the two column sums a step are warp shuffles at D <= 32. A step is 8
// dependent length-D dots per thread, so latency bounds it; at 8 chains it
// occupies 8 SMs.
#include "psi_split_fwd.cuh"

namespace amt {

template <int P>
__global__ void __launch_bounds__(1024)
    psi_split_sample_kernel(const float* __restrict__ cr,
                            const float* __restrict__ ci,
                            const float* __restrict__ rr,
                            const float* __restrict__ ri,
                            const float* __restrict__ pc,
                            const float* __restrict__ ps,
                            const float* __restrict__ s0r,
                            const float* __restrict__ s0i,
                            const float* __restrict__ noise,
                            const float* __restrict__ inv_a,
                            float* __restrict__ wave, int D, int T, int N,
                            float dt, float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int dd = D * D;
  uint32_t* crt = smem;
  uint32_t* cit = crt + dd;
  uint32_t* rrt = cit + dd;
  uint32_t* rit = rrt + dd;
  float* vr = reinterpret_cast<float*>(rit + dd);  // prepped psi
  float* vi = vr + D;
  float* red = vi + D;                             // 2 x 32 partials

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const bool active = i < D;
  const size_t stride = static_cast<size_t>(N);

  load_matrix_t<P>(crt, cr, D);
  load_matrix_t<P>(cit, ci, D);
  load_matrix_t<P>(rrt, rr, D);
  load_matrix_t<P>(rit, ri, D);
  const float pci = active ? pc[i] : 0.f;
  const float psi = active ? ps[i] : 0.f;
  const float ia = inv_a[0];
  float pr = active ? s0r[i * stride + col] : 0.f;
  float pi = active ? s0i[i * stride + col] : 0.f;
  float samp = 0.f;
  float z = T > 0 ? noise[col] : 0.f;

  for (int k = 0; k < T; ++k) {
    if (active) {
      vr[i] = prep<P>(pr);
      vi[i] = prep<P>(pi);
    }
    __syncthreads();
    const float z_next = k + 1 < T ? noise[(k + 1) * stride + col] : 0.f;
    float rur = 0.f, rui = 0.f, g1r = 0.f, g1i = 0.f;
    if (active) {
      cdot<P>(rrt + i, rit + i, D, vr, vi, D, rur, rui);
      cdot<P>(crt + i, cit + i, D, vr, vi, D, g1r, g1i);
    }
    const float e = 2.f * col_sum(pr * rur + pi * rui, red);
    const float inc = e * dt + z;
    samp += inc;
    if (i == 0) wave[k * stride + col] = samp;
    const float s = inc * ia;
    float yr = g1r + s * rur;
    float yi = g1i + s * rui;
    const float inv =
        rsqrtf(floor_at(col_sum(yr * yr + yi * yi, red + 32), norm_eps));
    yr *= inv;
    yi *= inv;
    pr = yr * pci + yi * psi;
    pi = yi * pci - yr * psi;
    z = z_next;
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one sampler CTA: C and R (4 bytes an element),
// two [D] vectors and two 32-float reduction buffers.
size_t amt_psi_split_sample_smem_bytes(int D) {
  const size_t d = static_cast<size_t>(D);
  return 4 * d * d * 4 + (2 * d + 64) * 4;
}

// Running waveform wave[T, N] from noise[T, N]; see the kernel note above.
// precision: 0 highest, 2 default. Returns a cudaError_t.
int amt_psi_split_sample(const float* cr, const float* ci, const float* rr,
                         const float* ri, const float* pc, const float* ps,
                         const float* s0r, const float* s0i,
                         const float* noise, const float* inv_a, float* wave,
                         int D, int T, int N, float dt, float norm_eps,
                         int precision, void* stream) {
  if (D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      amt::dispatch_split(precision, false, [&](auto p, auto) {
        return amt::launch_smem(
            amt::psi_split_sample_kernel<decltype(p)::value>, dim3(N),
            amt::split_threads(D), amt_psi_split_sample_smem_bytes(D),
            static_cast<cudaStream_t>(stream), cr, ci, rr, ri, pc, ps, s0r,
            s0i, noise, inv_a, wave, D, T, N, dt, norm_eps);
      }));
}

}  // extern "C"
