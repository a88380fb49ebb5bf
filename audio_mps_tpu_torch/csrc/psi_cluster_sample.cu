// psi SDE sampler (Euler–Maruyama, block-complex layout) in the cluster
// layout (D % 8 == 0, 88 to 256 on the main path) for Hopper.
//
// Replaces, past the one-CTA bodies of psi_sample.cu (D <= 80), the TPU
// kernel audio_mps_tpu/ops/pallas_block.py _make_psi_sample_kernel (:2176,
// reached through psi_sample_block :2225): the function psi_sample.cu
// computes, in its order (the state carried unnormalised, u_0 = t0, u_{k+1}
// = c_k (a + s b) with a, b = Ab u_k, Bb u_k, c_k = rsqrt(max(|u_k|^2,
// eps)) and 1 at step 0, e = 2 c^2 E; ops/block.psi_sample_block_plain).
//
// Design. One chain over a thread-block cluster of C CTAs (psi_cluster.cuh:
// CTA r holds rows r nr .. of Ab and Bb in shared memory, four threads a
// row). A step: each CTA walks its rows of a and b against the whole
// prepped u_k and pushes (a_i, b_i) to every CTA of the cluster; one
// cluster barrier; then every CTA, from the whole a, b and its own copy of
// u_k, forms the step's sums E and |u_k|^2 (atoms of 8 rows, added in index
// order: every CTA gets the same bits) and u_{k+1} itself, so the state is
// never exchanged, only the products: one exchange a step, as in
// psi_sample.cu. Generation waits on one chain's latency, so a chain's cluster
// is the smallest that holds Ab and Bb (ops/cluster.psi_sample_cluster_for:
// 4 at D=128, 16 at D=256).
//
// What bounds it: the serial chain of T steps: a step's walk (2D/4 j a
// thread, a packed word of each constant and a state value a j), a cluster
// barrier and two CTA barriers; 2 (2D)^2 FMAs a step are 0.2 us of one SM
// at D=128 and spread over C SMs.
#include "psi_cluster.cuh"

namespace amt {

// Words of one sampler CTA's shared memory: Ab and Bb's slabs, u_k raw and
// prepped (hi, lo), the gathered (a, b) by step parity [2][n] float2, the
// rows' twist constants pc and +-ps, and the atoms' sums of E and |u|^2.
__host__ __device__ inline size_t cl_sample_words(int D, int C) {
  const ClLayout L(D, C);
  return 2 * static_cast<size_t>(L.slab) + 9 * static_cast<size_t>(L.n) +
         2 * L.na;
}

template <int P>
__global__ void __launch_bounds__(kClThreads, 1)
    psi_cl_sample_kernel(const float* __restrict__ ab,
                         const float* __restrict__ bb,
                         const float* __restrict__ pc,
                         const float* __restrict__ ps,
                         const float* __restrict__ t0,
                         const float* __restrict__ noise,
                         const float* __restrict__ inv_a_ptr,
                         float* __restrict__ wave, int D, int T, int N, int C,
                         float dt, float norm_eps) {
  extern __shared__ __align__(16) float4 smem4[];
  const ClLayout L(D, C);
  const int n = L.n;
  const int rank = static_cast<int>(cluster_rank());
  const ClThread th(L, rank);
  uint32_t* ma = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* mb = ma + L.slab;
  float* ur = reinterpret_cast<float*>(mb + L.slab);   // [n] u_k raw
  float* uh = ur + n;                                  // [n] prepped hi
  float* ul = uh + n;                                  // [n] prepped lo
  float* abuf = ul + n;                                // [2][n] (a, b)
  float* pcs = abuf + 4 * n;                           // [n] pc of the row
  float* sps = pcs + n;                                // [n] +-ps
  float* ea = sps + n;                                 // [na] E's atoms
  float* ta = ea + L.na;                               // [na] |u|^2's atoms

  const int chain = blockIdx.x / C;
  const size_t stride = static_cast<size_t>(N);   // T * N may pass 2^31
  cl_load_slab<P, false>(ma, ab, L, rank * L.nr);
  cl_load_slab<P, false>(mb, bb, L, rank * L.nr);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float u = t0[j * stride + chain];
    ur[j] = u;
    store_vec<P>(uh, ul, j, u);
    const int r = j < D ? j : j - D;
    pcs[j] = pc[r];
    sps[j] = j < D ? ps[r] : -ps[r];
    abuf[2 * j] = abuf[2 * j + 1] = 0.f;
    abuf[2 * n + 2 * j] = abuf[2 * n + 2 * j + 1] = 0.f;
  }
  const float inv_a = *inv_a_ptr;
  cluster_sync();   // every CTA's buffers are set before any push

  const int nw = blockDim.x >> 5;
  float samp = 0.f;
  float z = T > 0 ? noise[chain] : 0.f;
  for (int k = 0; k < T; ++k) {
    const float zk = z;
    if (k + 1 < T) z = noise[(k + 1) * stride + chain];
    float o[2][1];
    const uint32_t* const mm[2] = {ma, mb};
    cl_walk<P, 2, 1>(mm, uh, ul, L, th, o);
    float* ab2 = abuf + (k & 1) * 2 * n;
    if (th.active)
      for (int cta = th.q; cta < C; cta += 4)
        st_cluster2(ab2 + 2 * th.i, cta, o[0][0], o[1][0]);
    cluster_sync();
    // the atoms of E and |u_k|^2: warp w takes rows 32 (w + nw m) + lane,
    // 8-lane groups added by xor 1, 2, 4
    for (int base = 32 * th.warp; base < n; base += 32 * nw) {
      const int j = base + th.lane;
      float e = 0.f, t = 0.f;
      if (j < n) {
        const float u = ur[j];
        const float tw = ur[j < D ? j + D : j - D];
        e = __fmul_rn(ab2[2 * j + 1],
                      fmaf(sps[j], tw, __fmul_rn(pcs[j], u)));
        t = __fmul_rn(u, u);
      }
#pragma unroll
      for (int o2 = 1; o2 < 8; o2 <<= 1) {
        e += __shfl_xor_sync(0xffffffffu, e, o2);
        t += __shfl_xor_sync(0xffffffffu, t, o2);
      }
      if ((th.lane & 7) == 0 && j < n) {
        ea[j >> 3] = e;
        ta[j >> 3] = t;
      }
    }
    __syncthreads();
    float E = ea[0], tr = ta[0];
    for (int a = 1; a < L.na; ++a) {
      E += ea[a];
      tr += ta[a];
    }
    const float c = k > 0 ? rsqrtf(floor_at(tr, norm_eps)) : 1.f;
    const float e = 2.f * (c * c) * E;
    const float inc = fmaf(e, dt, zk);
    samp += inc;
    if (rank == 0 && threadIdx.x == 0) wave[k * stride + chain] = samp;
    const float si = inc * inv_a;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float u = __fmul_rn(c, fmaf(si, ab2[2 * j + 1], ab2[2 * j]));
      ur[j] = u;
      store_vec<P>(uh, ul, j, u);
    }
    __syncthreads();
  }
  cluster_sync();   // no CTA leaves while another may still push to it
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one sampler CTA at D and cluster C; 0 where the
// layout does not take them.
size_t amt_psi_cl_sample_smem_bytes(int D, int C) {
  return amt::cl_ok(D, C) ? 4 * amt::cl_sample_words(D, C) : 0;
}

// Running waveform wave[T, N] from noise[T, N], one chain a cluster of C
// CTAs; see the note above. precision: 0 highest, 1 high, 2 default.
// Returns a cudaError_t.
int amt_psi_cl_sample(const float* ab, const float* bb, const float* pc,
                      const float* ps, const float* t0, const float* noise,
                      const float* inv_a, float* wave, int D, int T, int N,
                      float dt, float norm_eps, int precision, int C,
                      void* stream) {
  if (!amt::cl_ok(D, C)) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaSuccess);
  const amt::ClLayout L(D, C);
  const size_t smem = 4 * amt::cl_sample_words(D, C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(amt::dispatch_precision(precision, [&](auto p) {
    return amt::launch_cluster(amt::psi_cl_sample_kernel<decltype(p)::value>,
                               dim3(N * C), L.threads, C, false, smem, st, ab,
                               bb, pc, ps, t0, noise, inv_a, wave, D, T, N, C,
                               dt, norm_eps);
  }));
}

}  // extern "C"
