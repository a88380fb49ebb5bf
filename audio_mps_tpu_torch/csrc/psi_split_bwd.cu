// The psi training adjoint in the split layout for Hopper.
//
// Replaces the TPU kernels audio_mps_tpu/ops/pallas_grad.py
// _make_psi_bwd_kernel_defer (DEFER) and _make_psi_bwd_kernel (the backward
// of _psi_fused_nll_factory). For the per-example loss cotangent g[B] it
// emits dse[n_steps, B], the initial-state cotangent dp0r, dp0i [D, B] and,
// per column, the sums of the parameter cotangents dC, dR (real pairs
// [D,D]) and dpc, dps ([D], the rotation) over its steps into part[B, 4 D^2
// + 2 D]; the caller adds the rows (a fixed-order sum, no atomics).
//
// Per block of `unroll` steps, last first, as the TPU kernel does: re-run
// the block's steps from its checkpoint (ckr, cki: the state entering it)
// keeping, per step, the prepped entry state x, R x, y, R y, |y|^2 and
// 2 Re <y|R|y> in shared memory; then sweep back through the block:
//   deferred norm: at the block exit the renormalisation adjoint seeds
//     dp <- dp inv and dn2 = -dinv inv^3 / 2 (pallas_grad.py:373-381), and
//     each step carries dn2 back from the next step's e = ehat / n2_prev
//     (gated n2_prev > norm_eps, :411-412);
//   per-step norm: each step runs the normalise adjoint (gated n2 >
//     norm_eps, :244-252);
//   both: the rotation adjoint (and its dpc, dps terms), the loss adjoint
//     darg = -g / arg where arg > log_eps (:255-256, :406-407), dy += 2
//     dehat R y + R^T (2 dehat y), ds = darg e + dy . (R x), and
//     dp <- C^T dy + s R^T dy.
// Then the block's [D,D] outer products, dC += dy x^T and dR += dru y^T +
// s dy x^T (with their imaginary partners), are added to the CTA's sums by
// all threads, each owning whole elements. log_eps <= 0 arrives as -inf and
// keeps the reference's NaN (:179, :329).
//
// Design. One CTA owns one column and walks all blocks; C and R sit in
// shared memory row-major with a row pitch of D + 1 words, so that both
// M v (row walk) and M^T v (column walk) read them; thread i owns row i of
// the chain. The checkpoints bound what is recomputed to one block, and a
// block's 12 [D] vectors a step stay in shared memory, not device memory:
// at D=10, unroll 16, the CTA holds 12 KB. Shared memory: C, R (16 D (D+1)
// bytes), the four [D,D] sums (16 D^2), 48 unroll D bytes of block vectors,
// so the kernel takes D <= 73 at unroll 16 on an H100.
//
// What bounds it. The serial chain: a step is ~24 dependent length-D dots
// per thread (12 in the recompute, 12 in the sweep) and ~5 barriers, so
// latency bounds it, as the forward. The outer products run once a block
// over all threads, off the chain.
#include "psi_split_fwd.cuh"

namespace amt {

template <int P, bool DEFER>
__global__ void __launch_bounds__(1024)
    psi_split_bwd_kernel(const float* __restrict__ cr,
                         const float* __restrict__ ci,
                         const float* __restrict__ rr,
                         const float* __restrict__ ri,
                         const float* __restrict__ pc,
                         const float* __restrict__ ps,
                         const float* __restrict__ se,
                         const float* __restrict__ g,
                         const float* __restrict__ ckr,
                         const float* __restrict__ cki,
                         float* __restrict__ dse, float* __restrict__ dp0r,
                         float* __restrict__ dp0i, float* __restrict__ part,
                         int D, int n_steps, int B, int unroll, float log_eps,
                         float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int pitch = D + 1;
  const int dp = D * pitch;
  const int dd = D * D;
  const int ud = unroll * D;
  uint32_t* mcr = smem;                     // row-major, pitch D + 1
  uint32_t* mci = mcr + dp;
  uint32_t* mrr = mci + dp;
  uint32_t* mri = mrr + dp;
  float* acc = reinterpret_cast<float*>(mri + dp);  // [4][D][D] sums
  float* xr = acc + 4 * dd;   // per step of the block, [unroll][D] each:
  float* xi = xr + ud;        //   prepped entry state
  float* g2r = xi + ud;       //   R x
  float* g2i = g2r + ud;
  float* yr_s = g2i + ud;     //   y
  float* yi_s = yr_s + ud;
  float* rur_s = yi_s + ud;   //   R y
  float* rui_s = rur_s + ud;
  float* dyr_s = rui_s + ud;  //   prepped dy
  float* dyi_s = dyr_s + ud;
  float* dur_s = dyi_s + ud;  //   prepped dru = 2 dehat y
  float* dui_s = dur_s + ud;
  float* sc_s = dui_s + ud;   // per step: s, |y|^2, 2 Re<y|R|y>, n2_prev
  float* sc_n2 = sc_s + unroll;
  float* sc_eh = sc_n2 + unroll;
  float* sc_n2p = sc_eh + unroll;
  float* wr = sc_n2p + unroll;  // prepped y of the recompute's step
  float* wi = wr + D;
  float* red = wi + D;          // 64 partials: two buffers of 32

  const int col = blockIdx.x;
  const int i = threadIdx.x;
  const int nt = blockDim.x;
  const bool active = i < D;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(D) * B;

  load_matrix_pad<P>(mcr, cr, D);
  load_matrix_pad<P>(mci, ci, D);
  load_matrix_pad<P>(mrr, rr, D);
  load_matrix_pad<P>(mri, ri, D);
  for (int idx = i; idx < 4 * dd; idx += nt) acc[idx] = 0.f;
  const float pci = active ? pc[i] : 0.f;
  const float psi = active ? ps[i] : 0.f;
  const float gc = g[col];
  float dpr = 0.f, dpi = 0.f;      // cotangent of the state entering a step
  float dpc = 0.f, dps = 0.f;      // rotation cotangents, this column's
  const int n_blocks = (n_steps + unroll - 1) / unroll;

  for (int blk = n_blocks - 1; blk >= 0; --blk) {
    const int k0 = blk * unroll;
    const int L = min(unroll, n_steps - k0);
    // --- re-run the block from its checkpoint
    float pr = active ? ckr[blk * plane + i * stride + col] : 0.f;
    float pi = active ? cki[blk * plane + i * stride + col] : 0.f;
    float n2p = 1.f, n2 = 1.f;
    for (int k = 0; k < L; ++k) {
      const float s = se[(k0 + k) * stride + col];
      if (active) {
        xr[k * D + i] = prep<P>(pr);
        xi[k * D + i] = prep<P>(pi);
      }
      __syncthreads();
      float yr = 0.f, yi = 0.f;
      if (active) {
        float g1r, g1i, h2r, h2i;
        cdot<P>(mcr + i * pitch, mci + i * pitch, 1, xr + k * D, xi + k * D,
                D, g1r, g1i);
        cdot<P>(mrr + i * pitch, mri + i * pitch, 1, xr + k * D, xi + k * D,
                D, h2r, h2i);
        yr = g1r + s * h2r;
        yi = g1i + s * h2i;
        g2r[k * D + i] = h2r;
        g2i[k * D + i] = h2i;
        yr_s[k * D + i] = yr;
        yi_s[k * D + i] = yi;
        wr[i] = prep<P>(yr);
        wi[i] = prep<P>(yi);
      }
      __syncthreads();
      float e_part = 0.f;
      if (active) {
        float rur, rui;
        cdot<P>(mrr + i * pitch, mri + i * pitch, 1, wr, wi, D, rur, rui);
        rur_s[k * D + i] = rur;
        rui_s[k * D + i] = rui;
        e_part = yr * rur + yi * rui;
      }
      float ehat;
      col_sum2(e_part, yr * yr + yi * yi, red, ehat, n2);
      if (i == 0) {
        sc_s[k] = s;
        sc_n2[k] = n2;
        sc_eh[k] = 2.f * ehat;
        sc_n2p[k] = n2p;
      }
      if (DEFER) {
        pr = yr * pci + yi * psi;
        pi = yi * pci - yr * psi;
        n2p = n2;
      } else {
        const float inv = rsqrtf(floor_at(n2, norm_eps));
        const float tr = yr * inv, ti = yi * inv;
        pr = tr * pci + ti * psi;
        pi = ti * pci - tr * psi;
      }
    }
    __syncthreads();
    // --- deferred norm: the block-exit renormalisation adjoint seeds
    // (dp, dn2); pr, pi are the unnormalised exit state, n2 its |y|^2
    float dn2 = 0.f;
    if (DEFER) {
      const float inv = rsqrtf(floor_at(n2, norm_eps));
      const float dinv = col_sum(dpr * pr + dpi * pi, red);
      dpr *= inv;
      dpi *= inv;
      dn2 = n2 > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
    }
    // --- sweep back through the block
    float bpc = 0.f, bps = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      const float s = sc_s[k];
      const float n2k = sc_n2[k];
      const float ehat = sc_eh[k];
      const float n2pk = sc_n2p[k];
      const float yr = active ? yr_s[k * D + i] : 0.f;
      const float yi = active ? yi_s[k * D + i] : 0.f;
      // the loss tail
      const float n2p_c = floor_at(n2pk, norm_eps);
      const float e = DEFER ? ehat / n2p_c : ehat;
      const float arg = floor_at(1.f + e * s, log_eps);
      const float darg = arg > log_eps ? -gc / arg : 0.f;
      const float de = darg * s;
      float ds = darg * e;
      const float dehat = DEFER ? de / n2p_c : de;
      const float dn2_new =
          (DEFER && n2pk > norm_eps) ? -de * e / n2p_c : 0.f;
      // rotation adjoint
      const float inv = DEFER ? 1.f : rsqrtf(floor_at(n2k, norm_eps));
      const float tr = DEFER ? yr : yr * inv;
      const float ti = DEFER ? yi : yi * inv;
      const float dtr = dpr * pci - dpi * psi;
      const float dti = dpr * psi + dpi * pci;
      bpc += dpr * tr + dpi * ti;
      bps += dpr * ti - dpi * tr;
      float dyr, dyi;
      if (DEFER) {
        dyr = dtr;
        dyi = dti;
      } else {
        // the per-step normalise adjoint
        dyr = dtr * inv;
        dyi = dti * inv;
        const float dinv = col_sum(dtr * yr + dti * yi, red);
        dn2 = n2k > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
      }
      const float q = 2.f * dehat;
      dyr = dyr + 2.f * yr * dn2;
      dyi = dyi + 2.f * yi * dn2;
      if (active) {
        dyr = dyr + q * rur_s[k * D + i];
        dyi = dyi + q * rui_s[k * D + i];
        dur_s[k * D + i] = prep<P>(q * yr);
        dui_s[k * D + i] = prep<P>(q * yi);
      }
      __syncthreads();
      float ds_part = 0.f;
      if (active) {
        float ar, ai;
        cdot_t<P>(mrr + i, mri + i, pitch, dur_s + k * D, dui_s + k * D, D,
                  ar, ai);
        dyr = dyr + ar;
        dyi = dyi + ai;
        ds_part = dyr * g2r[k * D + i] + dyi * g2i[k * D + i];
        dyr_s[k * D + i] = prep<P>(dyr);
        dyi_s[k * D + i] = prep<P>(dyi);
      }
      ds += col_sum(ds_part, red + 32);
      __syncthreads();
      if (active) {
        float c_r, c_i, r_r, r_i;
        cdot_t<P>(mcr + i, mci + i, pitch, dyr_s + k * D, dyi_s + k * D, D,
                  c_r, c_i);
        cdot_t<P>(mrr + i, mri + i, pitch, dyr_s + k * D, dyi_s + k * D, D,
                  r_r, r_i);
        dpr = c_r + s * r_r;
        dpi = c_i + s * r_i;
      }
      if (i == 0) dse[(k0 + k) * stride + col] = ds;
      if (DEFER) dn2 = dn2_new;
    }
    dpc += bpc;
    dps += bps;
    // --- the block's [D,D] cotangent terms, every thread on whole elements
    for (int idx = i; idx < dd; idx += nt) {
      const int r = idx / D, c = idx - r * D;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int k = 0; k < L; ++k) {
        const float s = sc_s[k];
        const float dr = dyr_s[k * D + r], di = dyi_s[k * D + r];
        const float x_r = xr[k * D + c], x_i = xi[k * D + c];
        const float ur = dur_s[k * D + r], ui = dui_s[k * D + r];
        const float w_r = prep<P>(yr_s[k * D + c]);
        const float w_i = prep<P>(yi_s[k * D + c]);
        const float X = dr * x_r + di * x_i;
        const float Y = di * x_r - dr * x_i;
        a0 += X;
        a1 += Y;
        a2 += (ur * w_r + ui * w_i) + s * X;
        a3 += (ui * w_r - ur * w_i) + s * Y;
      }
      acc[idx] += a0;
      acc[dd + idx] += a1;
      acc[2 * dd + idx] += a2;
      acc[3 * dd + idx] += a3;
    }
    __syncthreads();
  }
  float* out = part + static_cast<size_t>(col) * (4 * dd + 2 * D);
  for (int idx = i; idx < 4 * dd; idx += nt) out[idx] = acc[idx];
  if (active) {
    out[4 * dd + i] = dpc;
    out[4 * dd + D + i] = dps;
    dp0r[i * stride + col] = dpr;
    dp0i[i * stride + col] = dpi;
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one adjoint CTA: C and R at a row pitch of D + 1
// words, the four [D,D] sums, 12 [D] vectors and 4 scalars a step of a
// block, two [D] vectors and 64 reduction floats, 4 bytes a word.
size_t amt_psi_split_bwd_smem_bytes(int D, int unroll) {
  const size_t d = static_cast<size_t>(D), u = static_cast<size_t>(unroll);
  return 4 * (4 * d * (d + 1) + 4 * d * d + 12 * u * d + 4 * u + 2 * d + 64);
}

// The adjoint of amt_psi_split_fwd for the loss cotangent g[B]; see the
// note above. precision: 0 highest, 2 default. Returns a cudaError_t.
int amt_psi_split_bwd(const float* cr, const float* ci, const float* rr,
                      const float* ri, const float* pc, const float* ps,
                      const float* se, const float* g, const float* ckr,
                      const float* cki, float* dse, float* dp0r, float* dp0i,
                      float* part, int D, int n_steps, int B, int unroll,
                      float log_eps, float norm_eps, int precision,
                      int defer_norm, void* stream) {
  if (unroll < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(amt::dispatch_split(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::launch_smem(
            amt::psi_split_bwd_kernel<decltype(p)::value, decltype(d)::value>,
            dim3(B), amt::split_threads(D),
            amt_psi_split_bwd_smem_bytes(D, unroll),
            static_cast<cudaStream_t>(stream), cr, ci, rr, ri, pc, ps, se, g,
            ckr, cki, dse, dp0r, dp0i, part, D, n_steps, B, unroll, log_eps,
            norm_eps);
      }));
}

}  // extern "C"
