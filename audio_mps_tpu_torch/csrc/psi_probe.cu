// The forward-only psi NLL variants of the per-step floor probe
// (block-complex layout, deferred norm) for Hopper.
//
// Replaces the TPU kernel of tools/probe8_psi_floor.py build_variant (its
// inline kernel :62, pallas_call :180), which measures how the serial chain
// of psi's forward restructures:
//   G       the batch in G contiguous groups of H = B / G columns. The TPU
//           interleaves the groups' recurrences so that one group's dots
//           overlap another's latency. Here a CTA runs G columns in
//           lockstep, column c + g H for g < G: each 4-byte shared load of a
//           constant feeds G FMAs, and the G chains' latencies overlap.
//           Every column's sums run in the order of the G = 1 kernel, so a
//           column's value is the same bits for every G.
//   PAIRED  two steps a pass: y1 = Ab t + s0 (Bb t) and
//           y2 = (AA t + s0 AB t) + s1 (BA t + s0 BB t), six products on t
//           that do not wait on each other, halving the serial depth for
//           +50% products. AA = Ab Ab, AB = Ab Bb, BA = Bb Ab and BB = Bb Bb
//           are formed outside the kernel (ops/probe.py, as the TPU tool
//           forms them outside its kernel) and read here from device memory
//           (L2) with plain read-only loads, transposed so that consecutive
//           threads read consecutive words: Ab, Bb and Rb take 192 KB of
//           shared memory at D=64 and the four products (256 KB) do not
//           fit beside them. The loss terms of both steps follow in order.
//   NOLOSS  the state chain alone (two products a step, no expectation and
//           no loss): each column's output is |y|^2 of the last block's
//           final state, before its renorm.
// The loss: e = ehat / max(n2_prev, eps) inside a block, the state
// renormalised at every unroll-th step, loss -= log(max(1 + e s, log_eps)).
// se arrives zero-padded to whole blocks: a padded step's loss term is
// log(1) = 0, but the state evolves through it, which NOLOSS's output sees.
// The kernel writes a value per column; the mean over the batch is taken
// outside.
//
// What bounds it: per column-step, the chain's two [2D,2D] x [2D] products
// (four a pair, plus the four L2-read products when PAIRED) and the
// expectation's one, each a walk of a matrix with one shared load for G
// FMAs, and two or three CTA barriers a step (pass); device memory moves se
// once (and the products' 256 KB a pass from L2 when PAIRED). The chain's
// latency, not the card's FLOPs or bytes, is what the probe measures.
#include "common.cuh"

namespace amt {

// Accumulators of one [2D,2D] x [2D] product row for G columns at precision
// P (kHigh: the hi*hi, hi*lo and lo*hi terms), summed over j in order as
// dot_strided does.
template <int P, int G>
struct RowAcc {
  float a1[G], a2[G], a3[G];

  __device__ __forceinline__ RowAcc() {
#pragma unroll
    for (int g = 0; g < G; ++g) a1[g] = a2[g] = a3[g] = 0.f;
  }

  // add m_ij v_g[j] for the packed matrix element w
  __device__ __forceinline__ void add(uint32_t w, const float (&h)[G],
                                      const float (&l)[G]) {
    if (P == kHigh) {
      const float mh = __uint_as_float(w & 0xffff0000u);
      const float ml = __uint_as_float(w << 16);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        a1[g] = fmaf(mh, h[g], a1[g]);
        a2[g] = fmaf(mh, l[g], a2[g]);
        a3[g] = fmaf(ml, h[g], a3[g]);
      }
    } else {
      const float m = __uint_as_float(w);
#pragma unroll
      for (int g = 0; g < G; ++g) a1[g] = fmaf(m, h[g], a1[g]);
    }
  }

  __device__ __forceinline__ float sum(int g) const {
    return P == kHigh ? (a1[g] + a2[g]) + a3[g] : a1[g];
  }
};

// The G columns' prepped element j of the vectors at v + g * 2n (hi) and
// v + g * 2n + n (kHigh lo).
template <int P, int G>
__device__ __forceinline__ void load_cols(const float* v, int n, int j,
                                          float (&h)[G], float (&l)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    h[g] = v[g * 2 * n + j];
    l[g] = P == kHigh ? v[g * 2 * n + n + j] : 0.f;
  }
}

template <int P, int G>
__device__ __forceinline__ void store_cols(float* v, int n, int i,
                                           const float (&x)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
    store_vec<P>(v + g * 2 * n, v + g * 2 * n + n, i, x[g]);
}

// Rows i of Rb v_g for G columns' prepped vectors at v (rbt transposed).
template <int P, int G>
__device__ __forceinline__ void rb_rows(const uint32_t* rbt, const float* v,
                                        int n, int i, float (&out)[G]) {
  RowAcc<P, G> r;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    float h[G], l[G];
    load_cols<P, G>(v, n, j, h, l);
    r.add(rbt[j * n + i], h, l);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) out[g] = r.sum(g);
}

// MODE: 0 the loss, one step a pass; 1 PAIRED; 2 NOLOSS.
template <int P, int G, int MODE>
__global__ void __launch_bounds__(256)
    psi_probe_kernel(const float* __restrict__ ab,
                     const float* __restrict__ bb,
                     const float* __restrict__ rb,
                     const float* __restrict__ prod_t,
                     const float* __restrict__ t0,
                     const float* __restrict__ se, float* __restrict__ out,
                     int D, int t_pad, int B, int unroll, float log_eps,
                     float norm_eps) {
  constexpr bool kPaired = MODE == 1;
  constexpr bool kNoLoss = MODE == 2;
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 2 * D;
  uint32_t* abt = smem;
  uint32_t* bbt = abt + n * n;
  uint32_t* rbt = bbt + n * n;
  float* th = reinterpret_cast<float*>(rbt + n * n);   // G prepped states
  float* yv = th + G * 2 * n;           // G (PAIRED: 2G) prepped outputs
  float* red = yv + (kPaired ? 2 : 1) * G * 2 * n;

  const int H = B / G;
  const int i = threadIdx.x;
  const bool active = i < n;
  const size_t stride = static_cast<size_t>(B);
  const size_t nn = static_cast<size_t>(n) * n;
  int col[G];
#pragma unroll
  for (int g = 0; g < G; ++g) col[g] = blockIdx.x + g * H;

  load_matrix_t<P>(abt, ab, n);
  load_matrix_t<P>(bbt, bb, n);
  if (!kNoLoss) load_matrix_t<P>(rbt, rb, n);

  float t[G], acc[G], n2p[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    t[g] = active ? t0[i * stride + col[g]] : 0.f;
    acc[g] = 0.f;
    n2p[g] = 1.f;
  }
  if (active) store_cols<P, G>(th, n, i, t);

  const int step = kPaired ? 2 : 1;
  for (int k = 0; k < t_pad; k += step) {
    const int kk = k % unroll;
    const bool block_end = kk + step == unroll;
    float s0[G], s1[G], y[G], y1[G] = {};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s0[g] = se[k * stride + col[g]];
      s1[g] = kPaired ? se[(k + 1) * stride + col[g]] : 0.f;
    }
    // NOLOSS ping-pongs the prepped state between th and yv (one barrier a
    // step); the others publish t in th at the end of each step
    const float* in = (kNoLoss && (k & 1)) ? yv : th;
    float* yo = (kNoLoss && (k & 1)) ? th : yv;
    __syncthreads();
    if (active) {
      RowAcc<P, G> a, b;
      if (kPaired) {
        RowAcc<P, G> aa, a2, ba, b2;
#pragma unroll 2
        for (int j = 0; j < n; ++j) {
          float h[G], l[G];
          load_cols<P, G>(in, n, j, h, l);
          a.add(abt[j * n + i], h, l);
          b.add(bbt[j * n + i], h, l);
          const size_t at = static_cast<size_t>(j) * n + i;
          aa.add(pack_elem<P>(__ldg(prod_t + at)), h, l);
          a2.add(pack_elem<P>(__ldg(prod_t + nn + at)), h, l);
          ba.add(pack_elem<P>(__ldg(prod_t + 2 * nn + at)), h, l);
          b2.add(pack_elem<P>(__ldg(prod_t + 3 * nn + at)), h, l);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          y1[g] = a.sum(g) + s0[g] * b.sum(g);
          y[g] = (aa.sum(g) + s0[g] * a2.sum(g)) +
                 s1[g] * (ba.sum(g) + s0[g] * b2.sum(g));
        }
        store_cols<P, G>(yv, n, i, y1);
        store_cols<P, G>(yv + G * 2 * n, n, i, y);
      } else {
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          float h[G], l[G];
          load_cols<P, G>(in, n, j, h, l);
          a.add(abt[j * n + i], h, l);
          b.add(bbt[j * n + i], h, l);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) y[g] = a.sum(g) + s0[g] * b.sum(g);
        store_cols<P, G>(yo, n, i, y);
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) y[g] = y1[g] = 0.f;
    }

    if (kNoLoss) {
      if (block_end) {
        float v[G], n2[G];
#pragma unroll
        for (int g = 0; g < G; ++g) v[g] = y[g] * y[g];
        block_sum_n<G>(v, red, n2);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g] = n2[g];
          t[g] = y[g] * rsqrtf(floor_at(n2[g], norm_eps));
        }
        if (active) store_cols<P, G>(yo, n, i, t);
      }
      continue;
    }

    __syncthreads();
    constexpr int NV = kPaired ? 4 : 2;
    float v[NV * G], o[NV * G];
    {
      float ru[G];
      if (kPaired) {
        float ru1[G];
        if (active) rb_rows<P, G>(rbt, yv, n, i, ru1);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          v[4 * g] = active ? y1[g] * ru1[g] : 0.f;
          v[4 * g + 1] = y1[g] * y1[g];
        }
        if (active) rb_rows<P, G>(rbt, yv + G * 2 * n, n, i, ru);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          v[4 * g + 2] = active ? y[g] * ru[g] : 0.f;
          v[4 * g + 3] = y[g] * y[g];
        }
      } else {
        if (active) rb_rows<P, G>(rbt, yv, n, i, ru);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          v[2 * g] = active ? y[g] * ru[g] : 0.f;
          v[2 * g + 1] = y[g] * y[g];
        }
      }
    }
    block_sum_n<NV * G>(v, red, o);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float ehat = o[NV * g];
      ehat *= 2.f;
      float e = ehat / floor_at(n2p[g], norm_eps);
      acc[g] -= logf(floor_at(1.f + e * s0[g], log_eps));
      n2p[g] = o[NV * g + 1];
      if (kPaired) {
        ehat = o[NV * g + 2];
        ehat *= 2.f;
        e = ehat / floor_at(n2p[g], norm_eps);
        acc[g] -= logf(floor_at(1.f + e * s1[g], log_eps));
        n2p[g] = o[NV * g + 3];
      }
      if (block_end) {
        t[g] = y[g] * rsqrtf(floor_at(n2p[g], norm_eps));
        n2p[g] = 1.f;
      } else {
        t[g] = y[g];
      }
    }
    if (active) store_cols<P, G>(th, n, i, t);
  }
  if (i == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) out[col[g]] = acc[g];
  }
}

// Dynamic shared memory: Ab, Bb, Rb transposed, G prepped states, G (2G
// paired) prepped outputs and the reductions.
inline size_t probe_smem_bytes(int D, int G, bool paired) {
  const size_t n = 2 * static_cast<size_t>(D);
  const size_t warps = threads_for(D) / 32;
  return 3 * n * n * 4 +
         ((paired ? 3 : 2) * G * 2 * n + 4 * G * warps) * 4;
}

// f(std::integral_constant<int, MODE>{}) for the runtime variant.
template <typename F>
cudaError_t dispatch_mode(int mode, F&& f) {
  switch (mode) {
    case 0:
      return f(std::integral_constant<int, 0>{});
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    default:
      return cudaErrorInvalidValue;
  }
}

template <int G>
cudaError_t launch_probe(const float* ab, const float* bb, const float* rb,
                         const float* prod_t, const float* t0,
                         const float* se, float* out, int D, int t_pad,
                         int B, int unroll, float log_eps, float norm_eps,
                         int precision, int mode, cudaStream_t stream) {
  return dispatch_precision(precision, [&](auto p) {
    return dispatch_mode(mode, [&](auto m) {
      return launch_smem(
          psi_probe_kernel<decltype(p)::value, G, decltype(m)::value>,
          B / G, threads_for(D), probe_smem_bytes(D, G, mode == 1), stream,
          ab, bb, rb, prod_t, t0, se, out, D, t_pad, B, unroll, log_eps,
          norm_eps);
    });
  });
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one probe CTA of G columns (paired: the second
// output vector of each).
size_t amt_psi_probe_smem_bytes(int D, int G, int paired) {
  return amt::probe_smem_bytes(D, G, paired != 0);
}

// Per-column values out[B] of the probe variant (mode 0: the NLL, 1: the
// paired NLL, 2: the chain-only |y|^2) over se[t_pad, B], zero-padded to
// whole blocks of unroll steps (even when paired); prod_t holds AA^T, AB^T,
// BA^T, BB^T ([4, 2D, 2D], read when paired, else may be null). G in
// {1, 2, 4} divides B. precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_psi_probe(const float* ab, const float* bb, const float* rb,
                  const float* prod_t, const float* t0, const float* se,
                  float* out, int D, int t_pad, int B, int unroll, int G,
                  int mode, float log_eps, float norm_eps, int precision,
                  void* stream) {
  if (unroll < 1 || t_pad % unroll || G < 1 || B % G ||
      (mode == 1 && (unroll % 2 || prod_t == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (G) {
    case 1:
      err = amt::launch_probe<1>(ab, bb, rb, prod_t, t0, se, out, D, t_pad,
                                 B, unroll, log_eps, norm_eps, precision,
                                 mode, s);
      break;
    case 2:
      err = amt::launch_probe<2>(ab, bb, rb, prod_t, t0, se, out, D, t_pad,
                                 B, unroll, log_eps, norm_eps, precision,
                                 mode, s);
      break;
    case 4:
      err = amt::launch_probe<4>(ab, bb, rb, prod_t, t0, se, out, D, t_pad,
                                 B, unroll, log_eps, norm_eps, precision,
                                 mode, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
