// psi SDE sampler (Euler–Maruyama) in the split layout for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_scan.py
// _make_psi_sample_kernel (:485, via psi_sample_pallas :577), the sampler
// at D % 8 != 0 or with kernel_layout="split". The TPU kernel's step, on
// the current state psi ([D] real and imaginary columns per chain; the
// expectation before the update, pallas_scan.py:512-515, as the reference
// conditions each step on the realised increment, model.py:284-288):
//   ru  = R psi;  e = 2 sum(psi_r ru_r + psi_i ru_i)
//   inc = e dt + noise[k];  samp += inc;  wave[k] = samp
//   y   = C psi + (inc / A) ru               (ru reused, :520)
//   psi = conj(p) .* (y rsqrt(max(|y|^2, eps)))
// Here the state is carried unnormalised, as rho_split_sample.cu carries
// its factor: u_0 = psi_0 and u_{k+1} = conj(p) .* y_k (|p| = 1, so
// |u_{k+1}|^2 = |y_k|^2), and step k runs
//   a1, a2 = C u_k, R u_k                     (one walk over j)
//   E  = sum(u_r a2_r + u_i a2_i),  tr = |u_k|^2     (one exchange)
//   c  = rsqrt(max(tr, eps))  (1 at step 0: psi_0 is taken as given)
//   e  = c^2 2 E;  inc = e dt + noise[k];  s = inc / A
//   u_{k+1} = conj(p) .* (c (a1 + s a2))
// the same recursion in exact arithmetic (ops/split.psi_sample_split_plain
// takes this order). The kernel writes the running sum; the caller
// multiplies by A (pallas_scan.py:646).
//
// Design. One CTA owns one chain and loops over all T steps, thread i on
// row i (D threads rounded up to a warp), C and R in shared memory
// transposed and packed four to an element (psi_split_fwd.cuh's
// load_pair_t, as the forwards hold them), so one 16-byte load of the pair
// and one 8-byte broadcast of the prepped u feed both products of a j: the
// eight fmaf chains of cdot2 below, each in cdot's order. A step writes
// the row's prepped u, passes a barrier, walks, and sums (E, tr) as one
// float2 of warp shuffles. At D <= 32 a chain is one warp and a step has
// no CTA barrier: a __syncwarp before the write (every lane has walked the
// last u) and one after it. Past one warp a step has two CTA barriers:
// after the write, and the exchange of the warps' float2 parts; the
// exchange also orders the next step's write after every walk, so u and
// the parts need one buffer each. The noise is read 32 steps ahead into
// lane registers (ChunkedInputs), so no global load sits on a step's path.
//
// What bounds it. The serial chain: latency, not bytes or FLOPs (8 D
// FMAs a thread-step, 8 chains fill 8 of 132 SMs). A step's dependent
// path: the prep and store of u, a barrier, the D-deep fmaf chains, five
// float2 shuffles (and past one warp the parts' exchange), the rsqrt and
// the update.
#include "psi_split_fwd.cuh"

namespace amt {

// Row i of A u and B u in one walk over j for the packed shared pair
// ab[j * stride] = (A_r, A_i, B_r, B_i) of the row's element j and the
// prepped vector v[j] = (u_r, u_i): out = (A u, B u), real and imaginary.
// Each real dot is one fmaf chain over j in order, cdot's, so each result
// is the bits cdot gives it; a j costs one 16-byte and one 8-byte load.
template <int P, int U>
__device__ __forceinline__ void cdot2(const float4* ab, int stride,
                                      const float2* v, int D,
                                      float (&out)[4]) {
  static_assert(P != kHigh, "the split kernels take highest and default");
  float a[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) a[q] = 0.f;
#pragma unroll (U)
  for (int j = 0; j < D; ++j) {
    const float2 x = v[j];
    const float4 c = ab[j * stride];
    const float m[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      a[4 * g] = fmaf(m[2 * g], x.x, a[4 * g]);              // mr . vr
      a[4 * g + 1] = fmaf(m[2 * g + 1], x.x, a[4 * g + 1]);  // mi . vr
      a[4 * g + 2] = fmaf(m[2 * g], x.y, a[4 * g + 2]);      // mr . vi
      a[4 * g + 3] = fmaf(m[2 * g + 1], x.y, a[4 * g + 3]);  // mi . vi
    }
  }
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    out[2 * g] = a[4 * g] - a[4 * g + 3];
    out[2 * g + 1] = a[4 * g + 2] + a[4 * g + 1];
  }
}

template <int P>
__global__ void __launch_bounds__(kSplitFwdPsiThreads)
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
  extern __shared__ __align__(16) float4 smem4[];
  const int nt = blockDim.x;
  const bool one_warp = nt == 32;
  float4* mat = smem4;                                 // (C, R) packed
  float2* v = reinterpret_cast<float2*>(mat + D * D);  // prepped u [D]
  float2* parts = v + D;                               // [32] (E, tr)

  const int col = blockIdx.x;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const bool active = i < D;
  const size_t stride = static_cast<size_t>(N);

  load_pair_t<P>(mat, cr, ci, rr, ri, D);
  const float pci = active ? pc[i] : 0.f;
  const float psi = active ? ps[i] : 0.f;
  const float ia = inv_a[0];
  float ur = active ? s0r[i * stride + col] : 0.f;
  float ui = active ? s0i[i * stride + col] : 0.f;
  float samp = 0.f;
  ChunkedInputs nz(noise + col, stride, T);
  __syncthreads();   // the constants

  for (int k = 0; k < T; ++k) {
    if (one_warp) __syncwarp();   // every lane has walked the last u
    if (active) v[i] = make_float2(prep<P>(ur), prep<P>(ui));
    step_sync(one_warp);
    const float z = nz.at(k);
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (active) cdot2<P, kFwdPsiU>(mat + i, D, v, D, o);
    // the exchange: (E, tr) as one float2, a warp's parts through one CTA
    // barrier past one warp
    float E = ur * o[2] + ui * o[3], tr = ur * ur + ui * ui;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      E += __shfl_xor_sync(0xffffffffu, E, w);
      tr += __shfl_xor_sync(0xffffffffu, tr, w);
    }
    if (!one_warp) {
      if (lane == 0) parts[warp] = make_float2(E, tr);
      __syncthreads();
      float2 p = parts[0];
      for (int w = 1; w < (nt >> 5); ++w) {
        const float2 q = parts[w];
        p.x += q.x;
        p.y += q.y;
      }
      E = p.x;
      tr = p.y;
    }
    const float c = k > 0 ? rsqrtf(floor_at(tr, norm_eps)) : 1.f;
    const float inc = (c * c) * (2.f * E) * dt + z;
    samp += inc;
    if (i == 0) wave[static_cast<size_t>(k) * stride + col] = samp;
    const float s = inc * ia;
    const float yr = c * fmaf(s, o[2], o[0]);
    const float yi = c * fmaf(s, o[3], o[1]);
    ur = yr * pci + yi * psi;
    ui = yi * pci - yr * psi;
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one sampler CTA: C and R packed (16 D^2 bytes),
// the prepped u (8 D) and the exchange's 32 float2 parts (ops/split.py
// psi_split_sample_smem_bytes mirrors it). The first design's count, two
// [D] vectors and two 32-float reduction buffers, was the same bytes, so
// the sampler takes the same D (to 120 on an H100).
size_t amt_psi_split_sample_smem_bytes(int D) {
  const size_t d = static_cast<size_t>(D);
  return 4 * (4 * d * d + 2 * d + 64);
}

// Running waveform wave[T, N] from noise[T, N]; see the kernel note above.
// precision: 0 highest, 2 default. Returns a cudaError_t.
int amt_psi_split_sample(const float* cr, const float* ci, const float* rr,
                         const float* ri, const float* pc, const float* ps,
                         const float* s0r, const float* s0i,
                         const float* noise, const float* inv_a, float* wave,
                         int D, int T, int N, float dt, float norm_eps,
                         int precision, void* stream) {
  if (D < 1 || amt::split_threads(D) > amt::kSplitFwdPsiThreads)
    return static_cast<int>(cudaErrorInvalidValue);
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
