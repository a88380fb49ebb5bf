// psi SDE sampler (Euler–Maruyama, block-complex layout) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py
// _make_psi_sample_kernel (:2176, reached through psi_sample_block :2225).
// The Pallas body's step, on the folded kernel-frame state t ([2D] per
// chain):
//   ru  = Bb t,  w = p .* ru over the two halves   (the e-twist)
//   e   = 2 sum(t .* w)
//   inc = e dt + noise[k];  samp += inc  (written out: running waveform)
//   y   = Ab t + (inc / A) ru
//   t   = y rsqrt(max(sum(y^2), norm_eps))
// Here the state is carried unnormalised, as rho_sample.cu carries its
// factor: u_0 = t0 and u_{k+1} = y_k, so that one walk over u_k feeds both
// products and one exchange gives both of the step's sums:
//   a, b = Ab u_k, Bb u_k                          (one walk over j)
//   E  = sum_r b_r (pc u_r + ps u_{r+D}) + b_{r+D} (pc u_{r+D} - ps u_r)
//   tr = sum(u_k^2)
//   c  = rsqrt(max(tr, norm_eps))  (1 at step 0: t0 is taken as given)
//   e  = 2 c^2 E;  inc = e dt + noise[k];  s = inc / A
//   u_{k+1} = c (a + s b)
// the same recursion in exact arithmetic (ops/block.psi_sample_block_plain
// takes this order). E regroups 2 sum(t .* w) by the rows of ru: row r's
// atom reads its own b and the state of its twin r +- D, which the walk's
// buffer holds already, so ru is never exchanged. The A scaling and the
// transpose of the running waveform stay outside.
//
// Design. One CTA owns one chain and loops over all T steps; the two sums
// leave each warp as one pair of parts (step parity buffers), added in one
// fixed order by every thread after the step's exchange barrier. Two
// bodies, chosen by ops/block.psi_sample_body (D alone):
// - quad (D <= 64): psi_fwd.cuh's quad layout, 4 x 2D threads (512 at
//   D=64), each holding its quarter of a row of Ab and Bb in registers;
//   one walk a step and two quad shuffles a product. Two CTA barriers a
//   step: the owner of row i writes u_{k+1} (the prepped parts and the raw
//   value) after the exchange; a barrier, the walk, the exchange's
//   barrier. (A one-barrier form, each u_j = c (a_j + s b_j) formed inside
//   the next walk from a and b written beside the parts, gives the same
//   bits but ran slower at every D >= 16 and at high and default: 1.03
//   against 0.82 us a step at D=64, highest, on an H100.)
// - row (D = 72, 80): the parent's layout, one thread a row, Ab^T and Bb^T
//   in shared memory (2 x 100 KB at D=80), the same two-barrier step.
//
// What bounds it. The serial chain of T steps: latency, not bytes or
// FLOPs (2 (2D)^2 FMAs a step, 0.15 us of one SM's fp32 pipes at D=64 and
// 1.75 GHz; 8 chains fill 8 of 132 SMs). A quad step's dependent path: the
// 32-deep fmaf chain of a quarter (throughput-bound at 4 warps a
// scheduler: 64 FMAs a thread), two quad shuffles, three row shuffles,
// two CTA barriers, the parts' eight 16-byte loads and a 4-deep add tree.
#include "psi_fwd.cuh"

namespace amt {

// Warp parts of the step's sums: every body has at most 16 warps (quad at
// D <= 64; row at D <= 80, 5), and the parts past the CTA's stay zero.
constexpr int kSampleParts = 16;

// Does the sampler take the quad body at D (the quad layout at 512 threads
// at most: D <= 64)? ops/block.psi_sample_body mirrors it.
__host__ __device__ inline bool psi_sample_quad(int D) {
  return quad_fits(D) && Quad(D).threads <= kQuadThreads;
}

inline int psi_sample_threads(int D, bool quad) {
  return quad ? Quad(D).threads : threads_for(D);
}

// Words of one sampler CTA's dynamic shared memory: the step parity pairs
// of sum parts (2 x 16 float2), the parity buffers of the prepped u (hi,
// lo) (quad: in 4 quarters; row: [2D] each), the raw u by parity [2][2D],
// and in the row body Ab^T and Bb^T.
__host__ __device__ inline size_t psi_sample_words(int D, bool quad) {
  const size_t n = 2 * static_cast<size_t>(D);
  return 4 * kSampleParts + (quad ? 16 * kQuadPitch : 4 * n) + 2 * n +
         (quad ? 0 : 2 * n * n);
}

// The step's exchange: each warp's parts of E and tr (row_sum8 in the quad
// body, whose rows' values sit on lane q = 0; warp_sum in the row body) go
// to parts[warp] as a float2, one barrier, and every thread adds the 16
// parts in one tree order (zeros past the CTA's warps). parts (16-byte
// aligned) is not written again before every thread has passed the next
// step's barrier.
template <bool QUAD>
__device__ __forceinline__ float2 sample_sums(float ea, float ta,
                                              float* parts) {
  const float we = QUAD ? row_sum8(ea) : warp_sum(ea);
  const float wt = QUAD ? row_sum8(ta) : warp_sum(ta);
  if ((threadIdx.x & 31) == 0)
    reinterpret_cast<float2*>(parts)[threadIdx.x >> 5] = make_float2(we, wt);
  __syncthreads();
  const float4* p4 = reinterpret_cast<const float4*>(parts);
  float e[kSampleParts / 2], t[kSampleParts / 2];
#pragma unroll
  for (int q = 0; q < kSampleParts / 2; ++q) {
    const float4 v = p4[q];
    e[q] = v.x + v.z;
    t[q] = v.y + v.w;
  }
#pragma unroll
  for (int w = kSampleParts / 4; w > 0; w >>= 1) {
#pragma unroll
    for (int q = 0; q < w; ++q) {
      e[q] = e[2 * q] + e[2 * q + 1];
      t[q] = t[2 * q] + t[2 * q + 1];
    }
  }
  return make_float2(e[0], t[0]);
}

template <int P, bool QUAD>
__global__ void __launch_bounds__(QUAD ? kQuadThreads : 1024, 1)
    psi_sample_kernel(const float* __restrict__ ab,
                      const float* __restrict__ bb,
                      const float* __restrict__ pc,
                      const float* __restrict__ ps,
                      const float* __restrict__ t0,
                      const float* __restrict__ noise,
                      const float* __restrict__ inv_a_ptr,
                      float* __restrict__ wave, int D, int T, int N,
                      float dt, float norm_eps) {
  extern __shared__ __align__(16) float4 smem4[];
  const int n = 2 * D;
  const Quad L(D);
  float* parts = reinterpret_cast<float*>(smem4);   // [2][16] float2
  float* vec = parts + 4 * kSampleParts;            // [2][vw]
  const int vw = QUAD ? 8 * kQuadPitch : 2 * n;     // words a parity
  const int lo_off = vw / 2;                        // lo (or b) part
  float* raw = vec + 2 * vw;                        // [2][2D]
  uint32_t* abt = reinterpret_cast<uint32_t*>(raw + 2 * n);   // row body
  uint32_t* bbt = abt + n * n;

  const int col = blockIdx.x;
  // offsets into the [T, N] arrays in size_t: T * N may pass 2^31
  const size_t stride = static_cast<size_t>(N);

  // this thread's row i and where it and its twin sit in the buffers
  int i, iw, q = 0;
  bool active, owner;
  if constexpr (QUAD) {
    const QuadThread th(L);
    i = th.i;
    iw = th.iw;
    q = th.q;
    active = th.active;
    owner = th.owner;
  } else {
    i = threadIdx.x;
    iw = i;
    active = i < n;
    owner = active;
  }
  const int twin = i < D ? i + D : i - D;

  uint32_t am[QUAD ? kQuadJ : 1], bm[QUAD ? kQuadJ : 1];
  if constexpr (QUAD) {
    const QuadThread th(L);
    load_quarter<P, false>(am, ab, L, th);
    load_quarter<P, false>(bm, bb, L, th);
  } else {
    load_matrix_t<P>(abt, ab, n);
    load_matrix_t<P>(bbt, bb, n);
  }
  for (int idx = threadIdx.x; idx < 4 * kSampleParts + 2 * vw + 2 * n;
       idx += blockDim.x)
    parts[idx] = 0.f;
  float my_pc = 0.f, sps = 0.f, u = 0.f;
  if (active) {
    const int r = i < D ? i : i - D;
    my_pc = pc[r];
    sps = i < D ? ps[r] : -ps[r];
    u = t0[i * stride + col];
  }
  const float inv_a = *inv_a_ptr;
  ChunkedInputs nz(noise + col, stride, T);
  __syncthreads();   // the constants; the zeroed buffers
  float a, b, samp = 0.f;

  for (int k = 0; k < T; ++k) {
    const int par = k & 1;
    float* vb = vec + par * vw;
    float* rw = raw + par * n;
    float ut = 0.f;
    if (owner) {
      store_vec<P>(vb, vb + lo_off, iw, u);
      rw[i] = u;
    }
    __syncthreads();
    if (owner) ut = rw[twin];
    if constexpr (QUAD) {
      const float* qv = vb + q * kQuadPitch;
      quad_walk<P>(am, bm, qv, qv + lo_off, false, a, b);
    } else {
      a = b = 0.f;
      if (active) row_dot2<P>(abt, bbt, vb, vb + lo_off, n, i, a, b);
    }
    const float z = nz.at(k);
    const float ea = owner ? b * fmaf(sps, ut, my_pc * u) : 0.f;
    const float ta = owner ? u * u : 0.f;
    const float2 sums = sample_sums<QUAD>(ea, ta, parts + 2 * kSampleParts *
                                                              par);
    const float c = k > 0 ? rsqrtf(floor_at(sums.y, norm_eps)) : 1.f;
    const float e = 2.f * (c * c) * sums.x;
    const float inc = e * dt + z;
    samp += inc;
    if (threadIdx.x == 0) wave[k * stride + col] = samp;
    u = c * fmaf(inc * inv_a, b, a);   // u_{k+1}
  }
}

}  // namespace amt

extern "C" {

// 1 where psi_sample_body(D) is the quad body, else 0 (the row body).
int amt_psi_sample_quad(int D) { return amt::psi_sample_quad(D) ? 1 : 0; }

// Dynamic shared memory of one sampler CTA in the body the rule picks at D.
size_t amt_psi_sample_smem_bytes(int D) {
  return 4 * amt::psi_sample_words(D, amt::psi_sample_quad(D));
}

// Running waveform wave[T, N] from noise[T, N]; see the kernel note above.
// precision: 0 highest, 1 high, 2 default; quad: the body (1 needs
// psi_sample_quad). Returns a cudaError_t.
int amt_psi_sample(const float* ab, const float* bb, const float* pc,
                   const float* ps, const float* t0, const float* noise,
                   const float* inv_a, float* wave, int D, int T, int N,
                   float dt, float norm_eps, int precision, int quad,
                   void* stream) {
  if (D < 1 || (quad && !amt::psi_sample_quad(D)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * amt::psi_sample_words(D, quad != 0);
  const int threads = amt::psi_sample_threads(D, quad != 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return quad ? amt::launch_smem(amt::psi_sample_kernel<P, true>, N,
                                   threads, smem, st, ab, bb, pc, ps, t0,
                                   noise, inv_a, wave, D, T, N, dt, norm_eps)
                : amt::launch_smem(amt::psi_sample_kernel<P, false>, N,
                                   threads, smem, st, ab, bb, pc, ps, t0,
                                   noise, inv_a, wave, D, T, N, dt, norm_eps);
  }));
}

const char* amt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
