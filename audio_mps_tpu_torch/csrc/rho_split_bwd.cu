// The rho training adjoint in the split layout for Hopper.
//
// Replaces the TPU kernels audio_mps_tpu/ops/pallas_grad.py
// _make_rho_bwd_kernel_defer (DEFER) and _make_rho_bwd_kernel (the backward
// of _rho_fused_nll_factory). For the per-example loss cotangent g[B] it
// emits dse[n_steps, B] (summed over an example's rank lanes, as the TPU's
// VJP of its repeat over them), the initial-factor cotangent dh0r, dh0i
// [D, B * rank] and, per example, the sums of the parameter cotangents
// d conj(C), d conj(R), d X^T (real pairs [D,D]) and dpc, dps ([D], the
// rotation) over its steps into part[B, 6 D^2 + 2 D]; the caller adds the
// rows (a fixed-order sum, no atomics).
//
// Per block of `unroll` steps, last first, as the TPU kernel does: re-run
// the block's steps from its checkpoint (ckr, cki: the factor entering it)
// keeping, per step, the prepped entry factor x, conj(R) x, y and X^T y in
// the CTA's slab of the device workspace `ws`, and s, ehat, tr and the
// previous step's tr in shared memory; then sweep back through the block:
//   deferred norm: at the block exit the renormalisation adjoint seeds
//     dH <- dH inv and dtr = -dinv inv^3 / 2 (pallas_grad.py:1085-1095),
//     and each step carries dtr back from e = ehat / tr_prev (gated
//     tr_prev > norm_eps, :1127-1130);
//   per-step norm: each step runs the normalise adjoint (gated tr >
//     norm_eps, :966-973);
//   both: the rotation adjoint (and its dpc, dps terms), the loss adjoint
//     darg = -g / arg where arg > log_eps, dy += 2 tr-cotangent y +
//     dehat gx + X (dehat y), ds = darg e + sum(dy . conj(R) x), and
//     dH <- conj(C)^T dy + s conj(R)^T dy.
// The prepped dy and dehat y of each step go to the slab too; at the block's
// end the [D,D] outer products d conj(C) += dy x^T, d conj(R) += s dy x^T,
// d X^T += (dehat y) y^T (with their imaginary partners), summed over the
// block's steps and the rank lanes, are added to the example's row of
// `part` by every thread, each owning whole elements. log_eps <= 0 arrives
// as -inf and keeps the reference's NaN.
//
// Design. One CTA owns one example's segment and walks all blocks; conj(C),
// conj(R) and X^T sit in shared memory row-major with a row pitch of D + 1
// words, so that both M v (row walk) and M^T v (column walk) read them;
// thread t owns the elements t, t + nt, ... of the segment. The block's
// saved vectors (12 [D, rank] vectors a step) live in the device workspace,
// not shared memory: 77 KB a CTA at D=10, full rank and unroll 16, read
// back from L2; so shared memory holds only the constants and 14 [D, rank]
// working vectors and the adjoint runs to D=53 at full rank
// (amt_rho_split_bwd_smem_bytes).
//
// What bounds it. The serial chain: a step is a few dependent length-D dots
// a thread and ~3 barriers in the re-run, as many in the sweep, so latency
// bounds it, as the forward. The outer products run once a block over all
// threads, off the chain.
#include "rho_split_fwd.cuh"

namespace amt {

// The workspace vectors of a step, in order.
enum RhoSplitSaved {
  kXr = 0, kXi, kA2r, kA2i, kYr, kYi, kGxr, kGxi, kDyr, kDyi, kDgr, kDgi,
  kSaved
};

template <int P, bool DEFER>
__global__ void __launch_bounds__(1024)
    rho_split_bwd_kernel(const float* __restrict__ ccr,
                         const float* __restrict__ cci,
                         const float* __restrict__ rcr,
                         const float* __restrict__ rci,
                         const float* __restrict__ xtr,
                         const float* __restrict__ xti,
                         const float* __restrict__ pc,
                         const float* __restrict__ ps,
                         const float* __restrict__ se,
                         const float* __restrict__ g,
                         const float* __restrict__ ckr,
                         const float* __restrict__ cki,
                         float* __restrict__ dse, float* __restrict__ dh0r,
                         float* __restrict__ dh0i, float* __restrict__ part,
                         float* __restrict__ ws, int D, int n_steps, int B,
                         int rank, int unroll, float log_eps,
                         float norm_eps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int pitch = D + 1;
  const int dp = D * pitch;
  const int dd = D * D;
  const int n = D * rank;
  uint32_t* mccr = smem;                    // row-major, pitch D + 1
  uint32_t* mcci = mccr + dp;
  uint32_t* mrcr = mcci + dp;
  uint32_t* mrci = mrcr + dp;
  uint32_t* mxtr = mrci + dp;
  uint32_t* mxti = mxtr + dp;
  float* hr = reinterpret_cast<float*>(mxti + dp);  // factor, then y
  float* hi = hr + n;
  float* vr = hi + n;       // prepped factor (the re-run's product input)
  float* vi = vr + n;
  float* wr = vi + n;       // prepped y, then prepped dehat y
  float* wi = wr + n;
  float* dhr = wi + n;      // cotangent of the factor entering a step
  float* dhi = dhr + n;
  float* dyr = dhi + n;     // dy being built
  float* dyi = dyr + n;
  float* pyr = dyi + n;     // prepped dy
  float* pyi = pyr + n;
  float* bpc = pyi + n;     // per-element rotation cotangents
  float* bps = bpc + n;
  float* pcs = bps + n;     // rotation
  float* pss = pcs + D;
  float* sc_s = pss + D;    // per step of the block: s, ehat, tr, tr_prev
  float* sc_eh = sc_s + unroll;
  float* sc_tr = sc_eh + unroll;
  float* sc_trp = sc_tr + unroll;
  float* red = sc_trp + unroll;  // 64 partials: two buffers of 32

  const int ex = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t lanes = static_cast<size_t>(B) * rank;
  const size_t plane = static_cast<size_t>(D) * lanes;
  const size_t col0 = static_cast<size_t>(ex) * rank;
  float* slab = ws + static_cast<size_t>(ex) * unroll * kSaved * n;
  float* out = part + static_cast<size_t>(ex) * (6 * dd + 2 * D);
  auto saved = [&](int k, int v) {
    return slab + (static_cast<size_t>(k) * kSaved + v) * n;
  };

  load_matrix_pad<P>(mccr, ccr, D);
  load_matrix_pad<P>(mcci, cci, D);
  load_matrix_pad<P>(mrcr, rcr, D);
  load_matrix_pad<P>(mrci, rci, D);
  load_matrix_pad<P>(mxtr, xtr, D);
  load_matrix_pad<P>(mxti, xti, D);
  for (int i = tid; i < D; i += nt) {
    pcs[i] = pc[i];
    pss[i] = ps[i];
  }
  for (int idx = tid; idx < dd; idx += nt) {
    for (int m = 0; m < 6; ++m) out[m * dd + idx] = 0.f;
  }
  for (int e = tid; e < n; e += nt) {
    dhr[e] = dhi[e] = 0.f;
    bpc[e] = bps[e] = 0.f;
  }
  const float gex = g[ex];
  const int n_blocks = (n_steps + unroll - 1) / unroll;

  for (int blk = n_blocks - 1; blk >= 0; --blk) {
    const int k0 = blk * unroll;
    const int L = min(unroll, n_steps - k0);
    // --- re-run the block from its checkpoint
    for (int e = tid; e < n; e += nt) {
      const int r = e / D, i = e - r * D;
      const size_t at = blk * plane + i * lanes + col0 + r;
      vr[e] = prep<P>(ckr[at]);
      vi[e] = prep<P>(cki[at]);
    }
    float trp = 1.f, tr = 1.f;
    for (int k = 0; k < L; ++k) {
      const float s = se[static_cast<size_t>(k0 + k) * B + ex];
      __syncthreads();
      for (int e = tid; e < n; e += nt) {
        const int r = e / D, i = e - r * D;
        float a1r, a1i, a2r, a2i;
        cdot<P>(mccr + i * pitch, mcci + i * pitch, 1, vr + r * D,
                vi + r * D, D, a1r, a1i);
        cdot<P>(mrcr + i * pitch, mrci + i * pitch, 1, vr + r * D,
                vi + r * D, D, a2r, a2i);
        const float y_r = a1r + s * a2r, y_i = a1i + s * a2i;
        saved(k, kXr)[e] = vr[e];
        saved(k, kXi)[e] = vi[e];
        saved(k, kA2r)[e] = a2r;
        saved(k, kA2i)[e] = a2i;
        saved(k, kYr)[e] = y_r;
        saved(k, kYi)[e] = y_i;
        hr[e] = y_r;
        hi[e] = y_i;
        wr[e] = prep<P>(y_r);
        wi[e] = prep<P>(y_i);
      }
      __syncthreads();
      float e_part = 0.f, t_part = 0.f;
      for (int e = tid; e < n; e += nt) {
        const int r = e / D, i = e - r * D;
        float gxr, gxi;
        cdot<P>(mxtr + i * pitch, mxti + i * pitch, 1, wr + r * D,
                wi + r * D, D, gxr, gxi);
        saved(k, kGxr)[e] = gxr;
        saved(k, kGxi)[e] = gxi;
        e_part += hr[e] * gxr + hi[e] * gxi;
        t_part += hr[e] * hr[e] + hi[e] * hi[e];
      }
      float ehat;
      col_sum2(e_part, t_part, red, ehat, tr);
      if (tid == 0) {
        sc_s[k] = s;
        sc_eh[k] = ehat;
        sc_tr[k] = tr;
        sc_trp[k] = trp;
      }
      const float inv = DEFER ? 1.f : rsqrtf(floor_at(tr, norm_eps));
      for (int e = tid; e < n; e += nt) {
        const int i = e % D;
        float a, b;
        rotate_p(hr[e] * inv, hi[e] * inv, pcs[i], pss[i], a, b);
        hr[e] = a;   // the unnormalised exit factor under DEFER
        hi[e] = b;
        vr[e] = prep<P>(a);
        vi[e] = prep<P>(b);
      }
      trp = tr;
    }
    __syncthreads();
    // --- deferred norm: the block-exit renormalisation adjoint seeds
    // (dH, dtr); hr, hi are the unnormalised exit factor, tr its trace
    float dtr = 0.f;
    if (DEFER) {
      const float inv = rsqrtf(floor_at(tr, norm_eps));
      float d_part = 0.f;
      for (int e = tid; e < n; e += nt) {
        d_part += dhr[e] * hr[e] + dhi[e] * hi[e];
      }
      const float dinv = col_sum(d_part, red);
      for (int e = tid; e < n; e += nt) {
        dhr[e] *= inv;
        dhi[e] *= inv;
      }
      dtr = tr > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
    }
    // --- sweep back through the block
    for (int k = L - 1; k >= 0; --k) {
      const float s = sc_s[k];
      const float trk = sc_tr[k];
      const float trpk = sc_trp[k];
      // the loss tail, per example
      const float trp_c = floor_at(trpk, norm_eps);
      const float e = DEFER ? sc_eh[k] / trp_c : sc_eh[k];
      const float arg = floor_at(1.f + e * s, log_eps);
      const float darg = arg > log_eps ? -gex / arg : 0.f;
      const float de = darg * s;
      float ds = darg * e;
      const float dehat = DEFER ? de / trp_c : de;
      const float dtr_new =
          (DEFER && trpk > norm_eps) ? -de * e / trp_c : 0.f;
      const float inv = DEFER ? 1.f : rsqrtf(floor_at(trk, norm_eps));
      const float* y_r = saved(k, kYr);
      const float* y_i = saved(k, kYi);
      // rotation adjoint (and, per step, the normalise adjoint's sum)
      float d_part = 0.f;
      for (int e2 = tid; e2 < n; e2 += nt) {
        const int i = e2 % D;
        const float yr = y_r[e2], yi = y_i[e2];
        const float tyr = yr * inv, tyi = yi * inv;
        const float hr_ = dhr[e2], hi_ = dhi[e2];
        const float dtyr = hr_ * pcs[i] + hi_ * pss[i];
        const float dtyi = hi_ * pcs[i] - hr_ * pss[i];
        bpc[e2] += hr_ * tyr + hi_ * tyi;
        bps[e2] += hi_ * tyr - hr_ * tyi;
        dyr[e2] = dtyr;
        dyi[e2] = dtyi;
        d_part += dtyr * yr + dtyi * yi;
      }
      if (!DEFER) {
        const float dinv = col_sum(d_part, red);
        dtr = trk > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
      }
      // dy from the norms and the loss; the prepped dehat y for X (.)
      for (int e2 = tid; e2 < n; e2 += nt) {
        const float yr = y_r[e2], yi = y_i[e2];
        dyr[e2] = dyr[e2] * inv + 2.f * yr * dtr +
                  dehat * saved(k, kGxr)[e2];
        dyi[e2] = dyi[e2] * inv + 2.f * yi * dtr +
                  dehat * saved(k, kGxi)[e2];
        const float gr = prep<P>(dehat * yr), gi = prep<P>(dehat * yi);
        wr[e2] = gr;
        wi[e2] = gi;
        saved(k, kDgr)[e2] = gr;
        saved(k, kDgi)[e2] = gi;
      }
      __syncthreads();
      float ds_part = 0.f;
      for (int e2 = tid; e2 < n; e2 += nt) {
        const int r = e2 / D, i = e2 - r * D;
        float ar, ai;
        cdot_t<P>(mxtr + i, mxti + i, pitch, wr + r * D, wi + r * D, D, ar,
                  ai);
        const float d_r = dyr[e2] + ar, d_i = dyi[e2] + ai;
        ds_part += d_r * saved(k, kA2r)[e2] + d_i * saved(k, kA2i)[e2];
        const float p_r = prep<P>(d_r), p_i = prep<P>(d_i);
        pyr[e2] = p_r;
        pyi[e2] = p_i;
        saved(k, kDyr)[e2] = p_r;
        saved(k, kDyi)[e2] = p_i;
      }
      ds += col_sum(ds_part, red + 32);
      __syncthreads();
      for (int e2 = tid; e2 < n; e2 += nt) {
        const int r = e2 / D, i = e2 - r * D;
        float c_r, c_i, q_r, q_i;
        cdot_t<P>(mccr + i, mcci + i, pitch, pyr + r * D, pyi + r * D, D,
                  c_r, c_i);
        cdot_t<P>(mrcr + i, mrci + i, pitch, pyr + r * D, pyi + r * D, D,
                  q_r, q_i);
        dhr[e2] = c_r + s * q_r;
        dhi[e2] = c_i + s * q_i;
      }
      if (tid == 0) dse[static_cast<size_t>(k0 + k) * B + ex] = ds;
      if (DEFER) dtr = dtr_new;
    }
    __syncthreads();
    // --- the block's [D,D] cotangent terms, every thread on whole elements
    for (int idx = tid; idx < dd; idx += nt) {
      const int a = idx / D, b = idx - a * D;
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, c4 = 0.f, c5 = 0.f;
      for (int k = 0; k < L; ++k) {
        float X = 0.f, Y = 0.f;
        const float* dy_r = saved(k, kDyr);
        const float* dy_i = saved(k, kDyi);
        const float* x_r = saved(k, kXr);
        const float* x_i = saved(k, kXi);
        const float* g_r = saved(k, kDgr);
        const float* g_i = saved(k, kDgi);
        const float* y_r = saved(k, kYr);
        const float* y_i = saved(k, kYi);
        for (int r = 0; r < rank; ++r) {
          const int ea = r * D + a, eb = r * D + b;
          X += dy_r[ea] * x_r[eb] + dy_i[ea] * x_i[eb];
          Y += dy_i[ea] * x_r[eb] - dy_r[ea] * x_i[eb];
          const float wyr = prep<P>(y_r[eb]), wyi = prep<P>(y_i[eb]);
          c4 += g_r[ea] * wyr + g_i[ea] * wyi;
          c5 += g_i[ea] * wyr - g_r[ea] * wyi;
        }
        c0 += X;
        c1 += Y;
        c2 += sc_s[k] * X;
        c3 += sc_s[k] * Y;
      }
      out[idx] += c0;
      out[dd + idx] += c1;
      out[2 * dd + idx] += c2;
      out[3 * dd + idx] += c3;
      out[4 * dd + idx] += c4;
      out[5 * dd + idx] += c5;
    }
    __syncthreads();
  }
  for (int i = tid; i < D; i += nt) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rank; ++r) {
      a += bpc[r * D + i];
      b += bps[r * D + i];
    }
    out[6 * dd + i] = a;
    out[6 * dd + D + i] = b;
  }
  for (int e = tid; e < n; e += nt) {
    const int r = e / D, i = e - r * D;
    dh0r[i * lanes + col0 + r] = dhr[e];
    dh0i[i * lanes + col0 + r] = dhi[e];
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one adjoint CTA: conj(C), conj(R), X^T at a row
// pitch of D + 1 words, 14 [D, rank] working vectors, pc, ps, 4 scalars a
// step of a block and 64 reduction floats, 4 bytes a word.
size_t amt_rho_split_bwd_smem_bytes(int D, int rank, int unroll) {
  const size_t d = static_cast<size_t>(D), n = d * rank;
  return 4 * (6 * d * (d + 1) + 14 * n + 2 * d +
              4 * static_cast<size_t>(unroll) + 64);
}

// Floats of one CTA's slab of the adjoint's device workspace: 12 [D, rank]
// vectors a step of a block.
size_t amt_rho_split_bwd_workspace_floats(int D, int rank, int unroll) {
  return static_cast<size_t>(unroll) * amt::kSaved * D * rank;
}

// The adjoint of amt_rho_split_fwd for the loss cotangent g[B]; ws holds
// B slabs of amt_rho_split_bwd_workspace_floats; see the note above.
// precision: 0 highest, 2 default. Returns a cudaError_t.
int amt_rho_split_bwd(const float* ccr, const float* cci, const float* rcr,
                      const float* rci, const float* xtr, const float* xti,
                      const float* pc, const float* ps, const float* se,
                      const float* g, const float* ckr, const float* cki,
                      float* dse, float* dh0r, float* dh0i, float* part,
                      float* ws, int D, int n_steps, int B, int rank,
                      int unroll, float log_eps, float norm_eps,
                      int precision, int defer_norm, void* stream) {
  if (unroll < 1 || D < 1 || rank < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(amt::dispatch_split(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::launch_smem(
            amt::rho_split_bwd_kernel<decltype(p)::value, decltype(d)::value>,
            dim3(B), amt::rho_split_threads(D, rank),
            amt_rho_split_bwd_smem_bytes(D, rank, unroll),
            static_cast<cudaStream_t>(stream), ccr, cci, rcr, rci, xtr, xti,
            pc, ps, se, g, ckr, cki, dse, dh0r, dh0i, part, ws, D, n_steps, B,
            rank, unroll, log_eps, norm_eps);
      }));
}

}  // extern "C"
