// rho SDE sampler (Euler–Maruyama) in the split layout for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_scan.py
// _make_rho_sample_kernel (:657, via rho_sample_pallas :724), the rho
// sampler at D % 8 != 0 or with kernel_layout="split". The TPU kernel's
// step, on the current factor segment H ([D, rank] real and imaginary parts
// per chain; the expectation on the current state, pallas_scan.py
// :694-702, as the reference conditions each step on the realised
// increment, model.py:103-112):
//   gx  = X^T H,  e = sum(H_r gx_r + H_i gx_i)
//   inc = e dt + noise[k];  samp += inc;  wave[k] = samp
//   y   = conj(C) H + (inc / A) conj(R) H
//   H   = p .* (y rsqrt(max(|y|^2, eps)))
// Here the factor is carried unnormalised, as rho_sample.cu carries its
// block state: u_0 = H_0 and u_{k+1} = p .* y_k (p rotates each row, so
// |u_{k+1}|^2 = |y_k|^2), and step k runs
//   gx, a1, a2 = X^T u_k, conj(C) u_k, conj(R) u_k     (one walk over j)
//   E  = sum(u_r gx_r + u_i gx_i),  tr = |u_k|^2         (one exchange)
//   c  = rsqrt(max(tr, eps))  (1 at step 0: H_0 is taken as given)
//   e  = c^2 E;  inc = e dt + noise[k];  s = inc / A
//   u_{k+1} = p .* (c (a1 + s a2))
// the same recursion in exact arithmetic (ops/split.rho_sample_split_plain
// takes this order). The kernel writes one running sum a chain; the caller
// multiplies by A (pallas_scan.py:786, which picks one of the identical
// lanes of an example, wave[:T, ::rank]).
//
// Design. One CTA owns one chain's segment and loops over all T steps,
// conj(C) and conj(R) transposed and packed four to an element and X^T two
// (rho_split_fwd.cuh's load_pair_t / load_one_t) in shared memory, the
// prepped u of each column in a step-parity buffer. The element layout of
// the forward (rho_split_threads threads, up to 1024, thread t on the
// elements t, t + nt, ...: at most E = 8 a thread, which takes every shape
// within the ceiling below): a step writes its elements' prepped u, passes
// a CTA barrier, walks each element's column once (the forwards' packed
// cdot3 on the one vector: twelve fmaf chains over j) and leaves E's and
// tr's atoms in registers; the two sums then leave each warp together
// (warp shuffles, then one float2 a warp through the exchange's CTA
// barrier, added in warp order). Two CTA barriers a step; none where the
// segment is one warp. (Whole columns a warp at D <= 32, as the forward's
// warp-local layout, save the first barrier but ran no faster: 0.833
// against 0.836 us a step at D=10, rank 10 on an H100, and slower where
// they take two elements a lane.) ops/split.rho_split_sample_layout
// mirrors the layout and the C entry checks it.
//
// What bounds it. The serial chain: latency, not bytes or FLOPs (24 D^2
// FMAs a lane-step, 2.4 KFLOP at D=10; 8 chains fill 8 of 132 SMs). A
// step's dependent path: the element's prep and store, a CTA barrier, the
// D-deep fmaf chains, ten shuffles and the parts' exchange.
#include "rho_split_fwd.cuh"

namespace amt {

// Is (threads, elems) the element layout of the [D, rank] segment:
// rho_split_threads threads, each on up to elems (1, 2, 4 or 8) elements.
__host__ __device__ inline bool rho_split_sample_layout_ok(int D, int rank,
                                                           int threads,
                                                           int elems) {
  return D >= 1 && rank >= 1 &&
         (elems == 1 || elems == 2 || elems == 4 || elems == 8) &&
         threads == rho_split_threads(D, rank) &&
         static_cast<long>(threads) * elems >= static_cast<long>(D) * rank;
}

template <int P, int E>
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
  extern __shared__ __align__(16) float4 smem4[];
  const int dd = D * D;
  const int n = D * rank;
  const int nt = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* mab = smem4;           // (conj(C), conj(R)), transposed and packed
  float2* mx = reinterpret_cast<float2*>(mab + dd);   // X^T
  float2* vb = mx + dd;          // [2][D rank]: prepped u, by step parity
  float2* parts = vb + 2 * n;    // [2][32]: the warps' (E, tr) parts

  const int ch = blockIdx.x;
  const size_t lanes = static_cast<size_t>(N) * rank;
  const size_t col0 = static_cast<size_t>(ch) * rank;

  load_pair_t<P>(mab, ccr, cci, rcr, rci, D);
  load_one_t<P>(mx, xtr, xti, D);
  int row[E], colr[E];
  bool own[E];
  rho_split_elements(D, rank, 0, row, colr, own);
  float ur[E], ui[E], pcq[E], psq[E];
#pragma unroll
  for (int q = 0; q < E; ++q) {
    const size_t at = row[q] * lanes + col0 + colr[q];
    ur[q] = own[q] ? h0r[at] : 0.f;
    ui[q] = own[q] ? h0i[at] : 0.f;
    pcq[q] = own[q] ? pc[row[q]] : 0.f;
    psq[q] = own[q] ? ps[row[q]] : 0.f;
  }
  const float ia = inv_a[0];
  float samp = 0.f;
  ChunkedInputs nz(noise + ch, static_cast<size_t>(N), T);
  __syncthreads();   // the constants

  for (int k = 0; k < T; ++k) {
    float2* v = vb + (k & 1) * n;
#pragma unroll
    for (int q = 0; q < E; ++q)
      if (own[q])
        v[colr[q] * D + row[q]] = make_float2(prep<P>(ur[q]), prep<P>(ui[q]));
    step_sync(nt <= 32);
    const float z = nz.at(k);
    float e_part = 0.f, t_part = 0.f;
    float a1r[E], a1i[E], a2r[E], a2i[E];
#pragma unroll
    for (int q = 0; q < E; ++q) {
      a1r[q] = a1i[q] = a2r[q] = a2i[q] = 0.f;
      if (!own[q]) continue;
      float o[6];
      cdot3<P, false, kFwdRhoU>(mab + row[q], mx + row[q], D,
                                v + colr[q] * D, D, o);
      a1r[q] = o[0];
      a1i[q] = o[1];
      a2r[q] = o[2];
      a2i[q] = o[3];
      e_part += ur[q] * o[4] + ui[q] * o[5];
      t_part += ur[q] * ur[q] + ui[q] * ui[q];
    }
    // the exchange: both sums, a warp's parts through one CTA barrier
    float E_sum = warp_sum(e_part), tr = warp_sum(t_part);
    if (nt > 32) {
      float2* pp = parts + 32 * (k & 1);
      if (lane == 0) pp[warp] = make_float2(E_sum, tr);
      __syncthreads();
      float2 p = pp[0];
      for (int w = 1; w < (nt >> 5); ++w) {
        const float2 o = pp[w];
        p.x += o.x;
        p.y += o.y;
      }
      E_sum = p.x;
      tr = p.y;
    }
    const float c = k > 0 ? rsqrtf(floor_at(tr, norm_eps)) : 1.f;
    const float inc = (c * c) * E_sum * dt + z;
    samp += inc;
    if (tid == 0) wave[static_cast<size_t>(k) * N + ch] = samp;
    const float s = inc * ia;
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const float yr = c * fmaf(s, a2r[q], a1r[q]);
      const float yi = c * fmaf(s, a2i[q], a1i[q]);
      rotate_p(yr, yi, pcq[q], psq[q], ur[q], ui[q]);
    }
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one sampler CTA: conj(C), conj(R) and X^T
// packed (24 D^2 bytes), the step-parity buffers of the prepped u (16 D
// rank) and the parts of the exchange (2 x 32 float2).
size_t amt_rho_split_sample_smem_bytes(int D, int rank) {
  const size_t d = static_cast<size_t>(D), n = d * rank;
  return 4 * (6 * d * d + 4 * n + 128);
}

// Running waveform wave[T, N] of N chains from noise[T, N] and the factors
// h0r, h0i [D, N * rank]; see the kernel note above. (threads, elems):
// the layout (ops/split.rho_split_sample_layout). precision: 0 highest, 2
// default. Returns a cudaError_t.
int amt_rho_split_sample(const float* ccr, const float* cci, const float* rcr,
                         const float* rci, const float* xtr, const float* xti,
                         const float* pc, const float* ps, const float* h0r,
                         const float* h0i, const float* noise,
                         const float* inv_a, float* wave, int D, int T, int N,
                         int rank, int threads, int elems, float dt,
                         float norm_eps, int precision, void* stream) {
  if (!amt::rho_split_sample_layout_ok(D, rank, threads, elems))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      amt::dispatch_split(precision, false, [&](auto p, auto) {
        return amt::dispatch_cols(elems, [&](auto e) {
          return amt::launch_smem(
              amt::rho_split_sample_kernel<decltype(p)::value,
                                           decltype(e)::value>,
              dim3(N), threads, amt_rho_split_sample_smem_bytes(D, rank),
              static_cast<cudaStream_t>(stream), ccr, cci, rcr, rci, xtr,
              xti, pc, ps, h0r, h0i, noise, inv_a, wave, D, T, N, rank, dt,
              norm_eps);
        });
      }));
}

}  // extern "C"
