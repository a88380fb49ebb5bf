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
// into a slab that keeps, per step, the prepped entry factor x, conj(R) x,
// y and X^T y, and s, ehat, the trace tr and the previous step's; then
// sweep back through the block:
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
// The sweep adds the prepped dy and dehat y of each step to the slab; then
// the block's [D,D] outer products d conj(C) += dy x^T, d conj(R) += s dy
// x^T, d X^T += (dehat y) y^T (with their imaginary partners), each element
// summed over the block's steps, then the rank lanes, in order, are added
// to the example's row of `part`. log_eps <= 0 arrives as -inf and keeps
// the reference's NaN.
//
// Design. One CTA owns one example's segment and walks all blocks;
// conj(C), conj(R) and X^T sit in shared memory row-major with a row pitch
// of D + 1 words, so that both M v (row walk) and M^T v (column walk) read
// them; thread t of a role owns the elements t, t + nt, ... of the segment
// (nt: D rank threads rounded to warps, at most 1024). Two forms of one
// kernel (PIPE), as psi_split_bwd.cu's:
//   double: a re-run role and a sweep role of nt threads each, two slabs
//     handed over under mbarriers, each role on its own named barrier; the
//     re-run role adds the outer products of a swept block before it
//     re-runs into that slab;
//   single: one slab, one role running re-run, sweep and outer products in
//     turn, where two roles do not fit (2 nt > 512) or their memory does
//     not.
// and two placements of the slabs (SMEM_SLAB): shared memory where they
// fit (at D=10, rank 10, unroll 16 two slabs take 154 KB), else the device
// workspace `ws`, [B, slabs, unroll, 12, D rank] floats, read back from
// L2 (ops/split.rho_split_bwd_plan chooses). The forms and placements run
// the same arithmetic in the same order, so they give the same bits. A
// step's products read their vectors from double buffers in shared memory
// and walk the three matrices together (cdot3): a re-run step forms
// conj(C) x, conj(R) x and, for the step before, X^T y; a sweep step
// conj(C)^T dy, conj(R)^T dy and, for the next step it sweeps, X (dehat
// y). The sums no later step of a chain needs (ehat, the deferred norm's
// trace, ds) are warp sums whose warp partials are added at the block's
// end, and the loss adjoints of a block's steps are taken when its sweep
// starts, so a deferred-norm step has one barrier in each role and no
// division on the sweep's chain.
//
// Shared memory (rho_split_bwd_words): the constants (24 D (D+1) bytes),
// 24 [D, rank] working vectors in the double form (the re-run's two
// double-buffered product inputs and y; the sweep's dH, the rotation
// cotangents, two double-buffered product inputs and X (dehat y)), 14 in
// the single form (the roles' temporaries share), the step scalars and
// warp partials, and the slabs if they are placed there: the single form
// in the workspace takes D <= 53 at full rank and unroll 16.
//
// What bounds it. The serial chains: latency (1.5 ms of fp32 FMAs at D=10,
// rank 10, B=32, T=65536 against ~400 ms); the two roles overlap the
// re-run's chain with the sweep's.
#include "rho_split_fwd.cuh"

namespace amt {


// The slab vectors of a step, in order: [unroll][kSaved][D rank] floats.
enum RhoSplitSaved {
  kXr = 0, kXi, kA2r, kA2i, kYr, kYi, kGxr, kGxi, kDyr, kDyi, kDgr, kDgi,
  kSaved
};

// Words of shared memory of one adjoint CTA (see the note above): 4
// mbarriers, the constants, pc and ps, the warp partials (the re-run's 2
// unroll a warp and the sweep's unroll a warp, each with 64 reduction
// floats; the single form's roles share them), the sweep's loss adjoints
// (3 unroll), the working vectors, the step scalars of each slab and, in
// shared memory, the slabs.
inline size_t rho_split_bwd_words(int D, int rank, int unroll, bool pipe,
                                  bool smem_slab) {
  const size_t d = static_cast<size_t>(D), u = static_cast<size_t>(unroll);
  const size_t n = d * rank, nw = rho_split_threads(D, rank) / 32;
  const size_t slots = pipe ? 2 : 1;
  const size_t red_r = 2 * u * nw + 64, red_s = u * nw + 64;
  return 8 + 6 * d * (d + 1) + 2 * d + (pipe ? red_r + red_s : red_r) +
         3 * u + (pipe ? 24 : 14) * n + slots * kStepScalars * u +
         (smem_slab ? slots * kSaved * u * n : 0);
}

template <int P, bool DEFER, bool PIPE, bool SMEM_SLAB>
__global__ void __launch_bounds__(PIPE ? kSplitBwdRhoPipeThreads : 1024)
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
  constexpr int kU = 2;  // cdot3's unroll, as measured (psi_split_fwd.cuh)
  const int pitch = D + 1;
  const int dp = D * pitch;
  const int dd = D * D;
  const int n = D * rank;
  const int rt = rho_split_threads(D, rank);  // threads a role
  const int nw = rt >> 5;
  const int lane = threadIdx.x & 31;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [2]
  uint64_t* done = full + 2;                           // [2]
  uint32_t* mccr = smem + 8;                // row-major, pitch D + 1
  uint32_t* mcci = mccr + dp;
  uint32_t* mrcr = mcci + dp;
  uint32_t* mrci = mrcr + dp;
  uint32_t* mxtr = mrci + dp;
  uint32_t* mxti = mxtr + dp;
  float* pcs = reinterpret_cast<float*>(mxti + dp);  // rotation
  float* pss = pcs + D;
  // the re-run's warp partials of ehat and the trace a step, then 64
  // reduction floats; the sweep's of ds, then 64 (shared in the single
  // form)
  float* pe = pss + D;
  float* pn = pe + unroll * nw;
  float* red_r = pn + unroll * nw;
  float* pds = PIPE ? red_r + 64 : pe;
  float* red_s = pds + unroll * nw;
  // the sweep's vectors: dH and the rotation cotangents a step carries,
  // then its temporaries (prepped dy and dehat y by step parity, X (dehat
  // y)); the re-run's (prepped x and y by step parity, y) share the
  // temporaries' space in the single form
  float* tails = (PIPE ? red_s : red_r) + 64;  // [3][unroll]
  float* dhr = tails + 3 * unroll;
  float* dhi = dhr + n;
  float* bpc = dhi + n;
  float* bps = bpc + n;
  float* stmp = bps + n;
  float* rtmp = PIPE ? stmp + 10 * n : stmp;
  float* arr = stmp + 8 * n;
  float* ari = arr + n;
  float* hr = rtmp + 8 * n;  // the re-run's y, element-owned
  float* hi = hr + n;
  float* scal0 = rtmp + 10 * n;  // [slots][kStepScalars][unroll]
  float* sslab0 = scal0 + (PIPE ? 2 : 1) * kStepScalars * unroll;
  const size_t slab_floats = static_cast<size_t>(unroll) * kSaved * n;

  const int ex = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const bool sweeper = PIPE && warp >= nw;
  const Role ro{sweeper ? 2 : 1, rt, static_cast<int>(threadIdx.x) -
                                         (sweeper ? rt : 0),
                warp - (sweeper ? nw : 0)};
  const size_t lanes = static_cast<size_t>(B) * rank;
  const size_t plane = static_cast<size_t>(D) * lanes;
  const size_t col0 = static_cast<size_t>(ex) * rank;
  float* out = part + static_cast<size_t>(ex) * (6 * dd + 2 * D);
  const int n_blocks = (n_steps + unroll - 1) / unroll;

  load_matrix_pad<P>(mccr, ccr, D);
  load_matrix_pad<P>(mcci, cci, D);
  load_matrix_pad<P>(mrcr, rcr, D);
  load_matrix_pad<P>(mrci, rci, D);
  load_matrix_pad<P>(mxtr, xtr, D);
  load_matrix_pad<P>(mxti, xti, D);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    pcs[i] = pc[i];
    pss[i] = ps[i];
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    dhr[e] = dhi[e] = 0.f;
    bpc[e] = bps[e] = 0.f;
  }
  if (!sweeper) {
    for (int idx = ro.t; idx < dd; idx += rt) {
      for (int m = 0; m < 6; ++m) out[m * dd + idx] = 0.f;
    }
  }
  if (PIPE && threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q) {
      mbar_init(full + q, rt);
      mbar_init(done + q, rt);
    }
  }
  __syncthreads();
  const float gex = g[ex];

  auto scal = [&](int q) { return scal0 + q * kStepScalars * unroll; };
  auto sc = [&](float* sl, int what, int k) -> float& {
    return sl[what * unroll + k];
  };
  auto slab = [&](int q) {
    return SMEM_SLAB ? sslab0 + q * slab_floats
                     : ws + (static_cast<size_t>(ex) * (PIPE ? 2 : 1) + q) *
                                slab_floats;
  };
  auto saved = [&](float* sv, int k, int v) {
    return sv + (static_cast<size_t>(k) * kSaved + v) * n;
  };
  auto steps = [&](int blk) { return min(unroll, n_steps - blk * unroll); };
  auto total = [&](const float* p, int k) {  // warp partials, warp order
    float r = p[k * nw];
    for (int w = 1; w < nw; ++w) r += p[k * nw + w];
    return r;
  };
  // a [2][D rank] double buffer's real and imaginary halves for parity b
  auto buf_r = [&](float* base, int b) { return base + 2 * (b & 1) * n; };
  auto buf_i = [&](float* base, int b) {
    return base + (2 * (b & 1) + 1) * n;
  };
  float* vbuf = rtmp;          // prepped x
  float* wbuf = rtmp + 4 * n;  // prepped y
  float* pybuf = stmp;         // prepped dy
  float* dgbuf = stmp + 4 * n; // prepped dehat y

  // --- re-run block blk from its checkpoint into slab q
  auto rerun = [&](int blk, int q) {
    float* sl = scal(q);
    float* sv = slab(q);
    const int k0 = blk * unroll, L = steps(blk);
    for (int k = ro.t; k < L; k += rt) {
      sc(sl, kSs, k) = se[static_cast<size_t>(k0 + k) * B + ex];
    }
    for (int e = ro.t; e < n; e += rt) {
      const int r = e / D, i = e - r * D;
      const size_t at = blk * plane + i * lanes + col0 + r;
      const float a = prep<P>(ckr[at]), b = prep<P>(cki[at]);
      buf_r(vbuf, 0)[e] = a;
      buf_i(vbuf, 0)[e] = b;
      saved(sv, 0, kXr)[e] = a;
      saved(sv, 0, kXi)[e] = b;
    }
    for (int k = 0; k < L; ++k) {
      const float* vr = buf_r(vbuf, k);
      const float* vi = buf_i(vbuf, k);
      const float* wr = buf_r(wbuf, k + 1);  // step k-1's
      const float* wi = buf_i(wbuf, k + 1);
      const bool w = k > 0;
      role_sync(ro);
      const float s = sc(sl, kSs, k);
      float e_part = 0.f, t_part = 0.f;
      for (int e = ro.t; e < n; e += rt) {
        const int r = e / D, i = e - r * D;
        // conj(C) x, conj(R) x and, for step k-1, X^T y (at k = 0 a
        // discarded X^T x)
        float o[6];
        cdot3<P, false, kU>(mccr + i * pitch, mcci + i * pitch,
                            mrcr + i * pitch, mrci + i * pitch,
                            mxtr + i * pitch, mxti + i * pitch, 1,
                            vr + r * D, vi + r * D, (w ? wr : vr) + r * D,
                            (w ? wi : vi) + r * D, D, o);
        const float y_r = o[0] + s * o[2], y_i = o[1] + s * o[3];
        saved(sv, k, kA2r)[e] = o[2];
        saved(sv, k, kA2i)[e] = o[3];
        saved(sv, k, kYr)[e] = y_r;
        saved(sv, k, kYi)[e] = y_i;
        if (w) {
          saved(sv, k - 1, kGxr)[e] = o[4];
          saved(sv, k - 1, kGxi)[e] = o[5];
          e_part += hr[e] * o[4] + hi[e] * o[5];
        }
        hr[e] = y_r;
        hi[e] = y_i;
        t_part += y_r * y_r + y_i * y_i;
        if (DEFER) {
          // deferred: rotate (no renormalisation inside a block)
          buf_r(wbuf, k)[e] = prep<P>(y_r);
          buf_i(wbuf, k)[e] = prep<P>(y_i);
          if (k + 1 < L) {
            float a, b;
            rotate_p(y_r, y_i, pcs[i], pss[i], a, b);
            a = prep<P>(a);
            b = prep<P>(b);
            buf_r(vbuf, k + 1)[e] = a;
            buf_i(vbuf, k + 1)[e] = b;
            saved(sv, k + 1, kXr)[e] = a;
            saved(sv, k + 1, kXi)[e] = b;
          }
        }
      }
      if (w) {
        const float ee = warp_sum(e_part);
        if (lane == 0) pe[(k - 1) * nw + ro.warp] = ee;
      }
      if (DEFER) {
        const float tt = warp_sum(t_part);
        if (lane == 0) pn[k * nw + ro.warp] = tt;
      } else {
        // per-step norm: normalise, then rotate
        const float tr = role_sum(t_part, red_r + 32 * (k & 1), ro);
        if (ro.t == 0) sc(sl, kSn, k) = tr;
        const float inv = rsqrtf(floor_at(tr, norm_eps));
        for (int e = ro.t; e < n; e += rt) {
          const int i = e % D;
          buf_r(wbuf, k)[e] = prep<P>(hr[e]);
          buf_i(wbuf, k)[e] = prep<P>(hi[e]);
          if (k + 1 < L) {
            float a, b;
            rotate_p(hr[e] * inv, hi[e] * inv, pcs[i], pss[i], a, b);
            a = prep<P>(a);
            b = prep<P>(b);
            buf_r(vbuf, k + 1)[e] = a;
            buf_i(vbuf, k + 1)[e] = b;
            saved(sv, k + 1, kXr)[e] = a;
            saved(sv, k + 1, kXi)[e] = b;
          }
        }
      }
    }
    // X^T y of the last step
    role_sync(ro);
    float e_part = 0.f;
    for (int e = ro.t; e < n; e += rt) {
      const int r = e / D, i = e - r * D;
      float gxr, gxi;
      cdot<P>(mxtr + i * pitch, mxti + i * pitch, 1,
              buf_r(wbuf, L - 1) + r * D, buf_i(wbuf, L - 1) + r * D, D, gxr,
              gxi);
      saved(sv, L - 1, kGxr)[e] = gxr;
      saved(sv, L - 1, kGxi)[e] = gxi;
      e_part += hr[e] * gxr + hi[e] * gxi;
    }
    const float ee = warp_sum(e_part);
    if (lane == 0) pe[(L - 1) * nw + ro.warp] = ee;
    role_sync(ro);
    for (int k = ro.t; k < L; k += rt) {
      sc(sl, kSe, k) = total(pe, k);
      if (DEFER) {
        sc(sl, kSn, k) = total(pn, k);
        sc(sl, kSnp, k) = k > 0 ? total(pn, k - 1) : 1.f;
      } else {
        sc(sl, kSnp, k) = k > 0 ? sc(sl, kSn, k - 1) : 1.f;
      }
    }
  };

  // --- sweep back through block blk from slab q; dH (dhr, dhi) is the
  // cotangent of the factor leaving the block, then entering it
  int rc = 0;  // reductions taken, for red_s's halves
  auto sweep = [&](int blk, int q) {
    float* sl = scal(q);
    float* sv = slab(q);
    const int k0 = blk * unroll, L = steps(blk);
    struct Tail {
      float ds0, dehat, dtr;
    };
    auto tail = [&](int k) {  // the loss adjoint of step k, per example
      const float s = sc(sl, kSs, k), trpk = sc(sl, kSnp, k);
      const float ehat = sc(sl, kSe, k);
      const float trp_c = floor_at(trpk, norm_eps);
      const float e = DEFER ? ehat / trp_c : ehat;
      const float arg = floor_at(1.f + e * s, log_eps);
      const float darg = arg > log_eps ? -gex / arg : 0.f;
      const float de = darg * s;
      Tail t;
      t.ds0 = darg * e;
      t.dehat = DEFER ? de / trp_c : de;
      t.dtr = (DEFER && trpk > norm_eps) ? -de * e / trp_c : 0.f;
      return t;
    };
    // the loss adjoints of the block's steps, off the chain (read after
    // the barrier below)
    for (int k = ro.t; k < L; k += rt) {
      const Tail tk = tail(k);
      tails[k] = tk.dehat;
      tails[unroll + k] = tk.ds0;
      tails[2 * unroll + k] = tk.dtr;
    }
    // deferred norm: the block-exit renormalisation adjoint seeds (dH,
    // dtr) from the unnormalised exit factor p .* y of the last step
    float dtr = 0.f;
    if (DEFER) {
      float d_part = 0.f;
      for (int e = ro.t; e < n; e += rt) {
        const int i = e % D;
        float a, b;
        rotate_p(saved(sv, L - 1, kYr)[e], saved(sv, L - 1, kYi)[e], pcs[i],
                 pss[i], a, b);
        d_part += dhr[e] * a + dhi[e] * b;
      }
      const float tr = sc(sl, kSn, L - 1);
      const float inv = rsqrtf(floor_at(tr, norm_eps));
      const float dinv = role_sum(d_part, red_s + 32 * (rc++ & 1), ro);
      for (int e = ro.t; e < n; e += rt) {
        dhr[e] *= inv;
        dhi[e] *= inv;
      }
      dtr = tr > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
    }
    // X (dehat y) of the last step
    const float dehat_l = tail(L - 1).dehat;
    for (int e = ro.t; e < n; e += rt) {
      const float a = prep<P>(dehat_l * saved(sv, L - 1, kYr)[e]);
      const float b = prep<P>(dehat_l * saved(sv, L - 1, kYi)[e]);
      buf_r(dgbuf, L)[e] = a;
      buf_i(dgbuf, L)[e] = b;
      saved(sv, L - 1, kDgr)[e] = a;
      saved(sv, L - 1, kDgi)[e] = b;
    }
    role_sync(ro);
    for (int e = ro.t; e < n; e += rt) {
      const int r = e / D, i = e - r * D;
      cdot_t<P>(mxtr + i, mxti + i, pitch, buf_r(dgbuf, L) + r * D,
                buf_i(dgbuf, L) + r * D, D, arr[e], ari[e]);
    }
    for (int k = L - 1; k >= 0; --k) {
      const float s = sc(sl, kSs, k);
      const float trk = sc(sl, kSn, k);
      const float inv = DEFER ? 1.f : rsqrtf(floor_at(trk, norm_eps));
      const float* y_r = saved(sv, k, kYr);
      const float* y_i = saved(sv, k, kYi);
      const float dehat = tails[k];
      const float dehat_n = k > 0 ? tails[k - 1] : 0.f;
      // rotation adjoint (and, per step, the normalise adjoint's sum: a
      // pass of its own, the deferred norm's runs in the pass below)
      if (!DEFER) {
        float d_part = 0.f;
        for (int e = ro.t; e < n; e += rt) {
          const int i = e % D;
          const float yr = y_r[e], yi = y_i[e];
          const float hr_ = dhr[e], hi_ = dhi[e];
          d_part += (hr_ * pcs[i] + hi_ * pss[i]) * yr +
                    (hi_ * pcs[i] - hr_ * pss[i]) * yi;
        }
        const float dinv = role_sum(d_part, red_s + 32 * (rc++ & 1), ro);
        dtr = trk > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
      }
      // dy from the rotation, the norms and the loss; the prepped dy and,
      // for step k-1, dehat y for the products
      float ds_part = 0.f;
      for (int e = ro.t; e < n; e += rt) {
        const int i = e % D;
        const float yr = y_r[e], yi = y_i[e];
        const float tyr = yr * inv, tyi = yi * inv;
        const float hr_ = dhr[e], hi_ = dhi[e];
        const float dtyr = hr_ * pcs[i] + hi_ * pss[i];
        const float dtyi = hi_ * pcs[i] - hr_ * pss[i];
        bpc[e] += hr_ * tyr + hi_ * tyi;
        bps[e] += hi_ * tyr - hr_ * tyi;
        const float d_r = (dtyr * inv + 2.f * yr * dtr) +
                          (dehat * saved(sv, k, kGxr)[e] + arr[e]);
        const float d_i = (dtyi * inv + 2.f * yi * dtr) +
                          (dehat * saved(sv, k, kGxi)[e] + ari[e]);
        ds_part += d_r * saved(sv, k, kA2r)[e] + d_i * saved(sv, k, kA2i)[e];
        const float p_r = prep<P>(d_r), p_i = prep<P>(d_i);
        buf_r(pybuf, k)[e] = p_r;
        buf_i(pybuf, k)[e] = p_i;
        saved(sv, k, kDyr)[e] = p_r;
        saved(sv, k, kDyi)[e] = p_i;
        if (k > 0) {
          const float a = prep<P>(dehat_n * saved(sv, k - 1, kYr)[e]);
          const float b = prep<P>(dehat_n * saved(sv, k - 1, kYi)[e]);
          buf_r(dgbuf, k)[e] = a;
          buf_i(dgbuf, k)[e] = b;
          saved(sv, k - 1, kDgr)[e] = a;
          saved(sv, k - 1, kDgi)[e] = b;
        }
      }
      const float dd_ = warp_sum(ds_part);
      if (lane == 0) pds[k * nw + ro.warp] = dd_;
      role_sync(ro);
      const float* pr = buf_r(pybuf, k);
      const float* pi = buf_i(pybuf, k);
      const float* gr = k > 0 ? buf_r(dgbuf, k) : pr;
      const float* gi = k > 0 ? buf_i(dgbuf, k) : pi;
      for (int e = ro.t; e < n; e += rt) {
        const int r = e / D, i = e - r * D;
        // conj(C)^T dy, conj(R)^T dy and, for step k-1, X (dehat y)
        float o[6];
        cdot3<P, true, kU>(mccr + i, mcci + i, mrcr + i, mrci + i, mxtr + i,
                           mxti + i, pitch, pr + r * D, pi + r * D,
                           gr + r * D, gi + r * D, D, o);
        dhr[e] = o[0] + s * o[2];
        dhi[e] = o[1] + s * o[3];
        arr[e] = o[4];
        ari[e] = o[5];
      }
      if (DEFER) dtr = tails[2 * unroll + k];
    }
    role_sync(ro);
    for (int k = ro.t; k < L; k += rt) {
      dse[static_cast<size_t>(k0 + k) * B + ex] =
          tails[unroll + k] + total(pds, k);
    }
  };

  // --- the [D,D] cotangent terms of a swept block in slab q, by the
  // re-run role (the single form's one role)
  auto outer = [&](int q, int L) {
    float* sl = scal(q);
    float* sv = slab(q);
    for (int idx = ro.t; idx < dd; idx += rt) {
      const int a = idx / D, b = idx - a * D;
      float sums[6];  // the running sums, read ahead of the block's terms
      for (int m = 0; m < 6; ++m) sums[m] = out[m * dd + idx];
      float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, c4 = 0.f, c5 = 0.f;
      for (int k = 0; k < L; ++k) {
        float X = 0.f, Y = 0.f;
        const float* dy_r = saved(sv, k, kDyr) + a;
        const float* dy_i = saved(sv, k, kDyi) + a;
        const float* g_r = saved(sv, k, kDgr) + a;
        const float* g_i = saved(sv, k, kDgi) + a;
        const float* x_r = saved(sv, k, kXr) + b;
        const float* x_i = saved(sv, k, kXi) + b;
        const float* y_r = saved(sv, k, kYr) + b;
        const float* y_i = saved(sv, k, kYi) + b;
#pragma unroll 2
        for (int r = 0; r < rank; ++r) {
          const int o = r * D;
          X += dy_r[o] * x_r[o] + dy_i[o] * x_i[o];
          Y += dy_i[o] * x_r[o] - dy_r[o] * x_i[o];
          const float wyr = prep<P>(y_r[o]), wyi = prep<P>(y_i[o]);
          c4 += g_r[o] * wyr + g_i[o] * wyi;
          c5 += g_i[o] * wyr - g_r[o] * wyi;
        }
        const float s = sc(sl, kSs, k);
        c0 += X;
        c1 += Y;
        c2 += s * X;
        c3 += s * Y;
      }
      out[idx] = sums[0] + c0;
      out[dd + idx] = sums[1] + c1;
      out[2 * dd + idx] = sums[2] + c2;
      out[3 * dd + idx] = sums[3] + c3;
      out[4 * dd + idx] = sums[4] + c4;
      out[5 * dd + idx] = sums[5] + c5;
    }
  };

  if (!PIPE) {
    for (int j = 0; j < n_blocks; ++j) {
      const int blk = n_blocks - 1 - j;
      if (kParts & kRerunPart) rerun(blk, 0);
      role_sync(ro);
      if (kParts & kSweepPart) sweep(blk, 0);
      if (kParts & kOuterPart) outer(0, steps(blk));
      role_sync(ro);
    }
  } else if (!sweeper) {
    // the re-run role: block j into slab j % 2 once the sweep is done
    // with block j-2 there, after that block's outer products
    for (int j = 0; j < n_blocks; ++j) {
      const int blk = n_blocks - 1 - j, q = j & 1;
      if (j >= 2) {
        mbar_wait(done + q, ((j >> 1) - 1) & 1);
        if (kParts & kOuterPart) outer(q, steps(blk + 2));
        role_sync(ro);
      }
      if (kParts & kRerunPart) rerun(blk, q);
      mbar_arrive(full + q);
    }
    for (int j = n_blocks < 2 ? 0 : n_blocks - 2; j < n_blocks; ++j) {
      mbar_wait(done + (j & 1), (j >> 1) & 1);
      if (kParts & kOuterPart) outer(j & 1, steps(n_blocks - 1 - j));
    }
  } else {
    // the sweep role: block j from slab j % 2
    for (int j = 0; j < n_blocks; ++j) {
      const int blk = n_blocks - 1 - j, q = j & 1;
      mbar_wait(full + q, (j >> 1) & 1);
      if (kParts & kSweepPart) sweep(blk, q);
      mbar_arrive(done + q);
    }
  }
  if (!PIPE || sweeper) {
    role_sync(ro);
    for (int i = ro.t; i < D; i += rt) {
      float a = 0.f, b = 0.f;
      for (int r = 0; r < rank; ++r) {
        a += bpc[r * D + i];
        b += bps[r * D + i];
      }
      out[6 * dd + i] = a;
      out[6 * dd + D + i] = b;
    }
    for (int e = ro.t; e < n; e += rt) {
      const int r = e / D, i = e - r * D;
      dh0r[i * lanes + col0 + r] = dhr[e];
      dh0i[i * lanes + col0 + r] = dhi[e];
    }
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one adjoint CTA in the single form with its
// slab in the workspace: the least any form needs, so the ceiling the
// wrappers check.
size_t amt_rho_split_bwd_smem_bytes(int D, int rank, int unroll) {
  return 4 * amt::rho_split_bwd_words(D, rank, unroll, false, false);
}

// Dynamic shared memory of one adjoint CTA in the given form (pipe: the
// double form) and placement (smem_slab: the slabs in shared memory).
size_t amt_rho_split_bwd_form_smem_bytes(int D, int rank, int unroll,
                                         int pipe, int smem_slab) {
  return 4 * amt::rho_split_bwd_words(D, rank, unroll, pipe != 0,
                                      smem_slab != 0);
}

// Floats of one slab of the adjoint's device workspace: 12 [D, rank]
// vectors a step of a block (a CTA holds one in the single form, two in
// the double form).
size_t amt_rho_split_bwd_workspace_floats(int D, int rank, int unroll) {
  return static_cast<size_t>(unroll) * amt::kSaved * D * rank;
}

// The adjoint of amt_rho_split_fwd for the loss cotangent g[B]; ws holds
// B x (1 or 2, by the form) slabs of amt_rho_split_bwd_workspace_floats
// unless smem_slab (then it may be null); see the note above. precision:
// 0 highest, 2 default; pipe: the double form. Returns a cudaError_t.
int amt_rho_split_bwd(const float* ccr, const float* cci, const float* rcr,
                      const float* rci, const float* xtr, const float* xti,
                      const float* pc, const float* ps, const float* se,
                      const float* g, const float* ckr, const float* cki,
                      float* dse, float* dh0r, float* dh0i, float* part,
                      float* ws, int D, int n_steps, int B, int rank,
                      int unroll, float log_eps, float norm_eps,
                      int precision, int defer_norm, int pipe, int smem_slab,
                      void* stream) {
  if (unroll < 1 || D < 1 || rank < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (pipe ? 2 : 1) * amt::rho_split_threads(D, rank);
  if ((pipe && threads > amt::kSplitBwdRhoPipeThreads) ||
      (!smem_slab && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(amt::dispatch_split(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::dispatch_bool(pipe != 0, [&](auto f) {
          return amt::dispatch_bool(smem_slab != 0, [&](auto m) {
            return amt::launch_smem(
                amt::rho_split_bwd_kernel<
                    decltype(p)::value, decltype(d)::value,
                    decltype(f)::value, decltype(m)::value>,
                dim3(B), threads,
                4 * amt::rho_split_bwd_words(D, rank, unroll, pipe != 0,
                                             smem_slab != 0),
                static_cast<cudaStream_t>(stream), ccr, cci, rcr, rci, xtr,
                xti, pc, ps, se, g, ckr, cki, dse, dh0r, dh0i, part, ws, D,
                n_steps, B, rank, unroll, log_eps, norm_eps);
          });
        });
      }));
}

}  // extern "C"
