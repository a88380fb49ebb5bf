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
// into a slab that keeps, per step, the prepped entry state x, R x, y, R y
// and the scalars s, |y|^2, 2 Re <y|R|y> and the previous |y|^2; then sweep
// back through the block:
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
// The block's [D,D] outer products, dC += dy x^T and dR += dru y^T + s dy
// x^T (with their imaginary partners), are then added to the column's
// sums, each element summed over the block's steps in order. log_eps <= 0
// arrives as -inf and keeps the reference's NaN (:179, :329).
//
// Design. One CTA owns one column and walks all blocks; C and R sit in
// shared memory row-major with a row pitch of D + 1 words, so that both
// M v (row walk) and M^T v (column walk) read them; thread i of a role owns
// row i. Two forms of one kernel (PIPE):
//   double: two warp roles of D threads rounded to warps. The re-run role
//     re-runs block b-1 into one slab while the sweep role sweeps block b
//     from the other; each slab passes between them under a pair of
//     mbarriers (full: re-run done; done: sweep done), and each role's
//     steps synchronise on a named barrier of its own warps (a warp barrier
//     for one warp), so neither waits on the other within a block. The
//     re-run role adds the outer products of a swept block before it
//     re-runs into that slab (its chain is the shorter).
//   single: one slab, the same code run by one role in turn (re-run, sweep,
//     outer products), where two slabs do not fit.
// Both forms run the same arithmetic in the same order, so they give the
// same bits. The chains are short: a re-run step forms C x, R x and, for
// the step before, R y in one walk of the rows (cdot3: twelve dots in
// flight); a sweep step forms C^T dy, R^T dy and, for the step after it in
// the sweep, R^T (2 dehat y) in one walk of the columns; the sums that no
// later step of the chain needs (2 Re <y|R|y>, the deferred norm's |y|^2,
// ds) are warp sums whose warp partials are added at the block's end, and
// the loss adjoints of a block's steps are taken when its sweep starts, so
// a deferred-norm step has one barrier in each role and no division on
// the sweep's chain. A block's se is read once when it starts and its dse
// written once when it ends.
//
// Shared memory: C, R (16 D (D+1) bytes), the four [D,D] sums (16 D^2),
// per slab 48 unroll D bytes of vectors and 16 unroll of scalars, a double
// buffer of two [D] vectors and the warp partials
// (psi_split_bwd_words); single takes D <= 73 at unroll 16 on an H100,
// double D <= 63 (ops/split.psi_split_bwd_plan chooses).
//
// What bounds it. The serial chains: latency, not bytes or FLOPs (0.213 ms
// of fp32 FMAs at D=10, B=32, T=65536 against ~250 ms); the two roles
// overlap the re-run's chain with the sweep's.
#include "psi_split_fwd.cuh"

namespace amt {


// The 12 [D] vectors a step of a block keeps in its slab, real then
// imaginary part: [kPsiSaved][unroll][D] words after the slab's scalars.
enum PsiSplitSaved {
  kPx = 0,    // prepped entry state
  kPg = 2,    // R x
  kPy = 4,    // y
  kPu = 6,    // R y
  kPdy = 8,   // prepped dy
  kPq = 10,   // prepped dru = 2 dehat y
  kPsiSaved = 12
};

// Words of shared memory of one adjoint CTA (see the note above): 4
// mbarriers, the constants, the sums, the double buffer, the warp partials
// (the re-run's 2 unroll a warp and the sweep's unroll a warp, each with
// 64 reduction floats; the single form's roles share them), the sweep's
// loss adjoints (3 unroll), and a slab (scalars and vectors) for each of
// the form's slots.
inline size_t psi_split_bwd_words(int D, int unroll, bool pipe) {
  const size_t d = static_cast<size_t>(D), u = static_cast<size_t>(unroll);
  const size_t nw = split_threads(D) / 32, slots = pipe ? 2 : 1;
  const size_t red_r = 2 * u * nw + 64, red_s = u * nw + 64;
  return 8 + 4 * d * (d + 1) + 4 * d * d + 4 * d +
         (pipe ? red_r + red_s : red_r) + 3 * u +
         slots * (kStepScalars * u + kPsiSaved * u * d);
}

template <int P, bool DEFER, bool PIPE>
__global__ void __launch_bounds__(kSplitBwdPsiThreads)
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
  // cdot3's unroll, as measured (psi_split_fwd.cuh)
  constexpr int kU = PIPE ? 1 : 4;
  const int pitch = D + 1;
  const int dp = D * pitch;
  const int dd = D * D;
  const int rt = split_threads(D);  // threads a role
  const int nw = rt >> 5;
  const int lane = threadIdx.x & 31;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [2]
  uint64_t* done = full + 2;                           // [2]
  uint32_t* mcr = smem + 8;                 // row-major, pitch D + 1
  uint32_t* mci = mcr + dp;
  uint32_t* mrr = mci + dp;
  uint32_t* mri = mrr + dp;
  float* acc = reinterpret_cast<float*>(mri + dp);  // [4][D][D] sums
  float* wbuf = acc + 4 * dd;  // [2][2][D]: prepped y of the re-run's
                               // previous step, by its parity
  // the re-run's warp partials of 2 Re<y|R|y> and |y|^2 a step, then 64
  // reduction floats; the sweep's of ds, then 64 (the single form's roles
  // share the space)
  float* pe = wbuf + 4 * D;
  float* pn = pe + unroll * nw;
  float* red_r = pn + unroll * nw;
  float* pds = PIPE ? red_r + 64 : pe;
  float* red_s = pds + unroll * nw;
  float* tails = PIPE ? red_s + 64 : red_r + 64;  // [3][unroll]
  float* slots0 = tails + 3 * unroll;
  const int slot_words = (kStepScalars + kPsiSaved * D) * unroll;

  const int col = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const bool sweeper = PIPE && warp >= nw;
  const Role ro{sweeper ? 2 : 1, rt, static_cast<int>(threadIdx.x) -
                                         (sweeper ? rt : 0),
                warp - (sweeper ? nw : 0)};
  const int i = ro.t;
  const bool active = i < D;
  const size_t stride = static_cast<size_t>(B);
  const size_t plane = static_cast<size_t>(D) * B;
  const int n_blocks = (n_steps + unroll - 1) / unroll;

  load_matrix_pad<P>(mcr, cr, D);
  load_matrix_pad<P>(mci, ci, D);
  load_matrix_pad<P>(mrr, rr, D);
  load_matrix_pad<P>(mri, ri, D);
  for (int idx = threadIdx.x; idx < 4 * dd; idx += blockDim.x) acc[idx] = 0.f;
  if (PIPE && threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q) {
      mbar_init(full + q, rt);
      mbar_init(done + q, rt);
    }
  }
  __syncthreads();
  const float pci = active ? pc[i] : 0.f;
  const float psi = active ? ps[i] : 0.f;
  const float gc = g[col];

  auto slot = [&](int q) { return slots0 + q * slot_words; };
  auto sc = [&](float* sl, int what, int k) -> float& {
    return sl[what * unroll + k];
  };
  auto vec = [&](float* sl, int v, int k) {
    return sl + kStepScalars * unroll + (v * unroll + k) * D;
  };
  auto steps = [&](int blk) { return min(unroll, n_steps - blk * unroll); };

  // --- re-run block blk from its checkpoint into slab sl
  auto rerun = [&](int blk, float* sl) {
    const int k0 = blk * unroll, L = steps(blk);
    for (int k = ro.t; k < L; k += rt) {
      sc(sl, kSs, k) = se[(k0 + k) * stride + col];
    }
    float pr = active ? ckr[blk * plane + i * stride + col] : 0.f;
    float pi = active ? cki[blk * plane + i * stride + col] : 0.f;
    float yr = 0.f, yi = 0.f;  // y of the previous step
    for (int k = 0; k < L; ++k) {
      float* xr = vec(sl, kPx, k);
      float* xi = vec(sl, kPx + 1, k);
      float* wr = wbuf + ((k + 1) & 1) * 2 * D;  // step k-1's buffer
      if (active) {
        xr[i] = prep<P>(pr);
        xi[i] = prep<P>(pi);
        if (k > 0) {
          wr[i] = prep<P>(yr);
          wr[D + i] = prep<P>(yi);
        }
      }
      role_sync(ro);
      const float s = sc(sl, kSs, k);
      float e_part = 0.f, n_part = 0.f, nyr = 0.f, nyi = 0.f;
      if (active) {
        // C x, R x and, for step k-1, R y (at k = 0 a discarded R x)
        float o[6];
        const bool w = k > 0;
        cdot3<P, false, kU>(mcr + i * pitch, mci + i * pitch, mrr + i * pitch,
                            mri + i * pitch, mrr + i * pitch, mri + i * pitch,
                            1, xr, xi, w ? wr : xr, w ? wr + D : xi, D, o);
        nyr = o[0] + s * o[2];
        nyi = o[1] + s * o[3];
        vec(sl, kPg, k)[i] = o[2];
        vec(sl, kPg + 1, k)[i] = o[3];
        vec(sl, kPy, k)[i] = nyr;
        vec(sl, kPy + 1, k)[i] = nyi;
        if (w) {
          vec(sl, kPu, k - 1)[i] = o[4];
          vec(sl, kPu + 1, k - 1)[i] = o[5];
          e_part = yr * o[4] + yi * o[5];
        }
        n_part = nyr * nyr + nyi * nyi;
      }
      if (k > 0) {
        const float e = warp_sum(e_part);
        if (lane == 0) pe[(k - 1) * nw + ro.warp] = e;
      }
      if (DEFER) {
        const float nn = warp_sum(n_part);
        if (lane == 0) pn[k * nw + ro.warp] = nn;
        pr = nyr * pci + nyi * psi;
        pi = nyi * pci - nyr * psi;
      } else {
        const float n2 = role_sum(n_part, red_r + 32 * (k & 1), ro);
        if (ro.t == 0) sc(sl, kSn, k) = n2;
        const float inv = rsqrtf(floor_at(n2, norm_eps));
        const float tr = nyr * inv, ti = nyi * inv;
        pr = tr * pci + ti * psi;
        pi = ti * pci - tr * psi;
      }
      yr = nyr;
      yi = nyi;
    }
    // R y of the last step
    float* wr = wbuf + ((L - 1) & 1) * 2 * D;
    if (active) {
      wr[i] = prep<P>(yr);
      wr[D + i] = prep<P>(yi);
    }
    role_sync(ro);
    float e_part = 0.f;
    if (active) {
      float ur, ui;
      cdot<P>(mrr + i * pitch, mri + i * pitch, 1, wr, wr + D, D, ur, ui);
      vec(sl, kPu, L - 1)[i] = ur;
      vec(sl, kPu + 1, L - 1)[i] = ui;
      e_part = yr * ur + yi * ui;
    }
    const float e = warp_sum(e_part);
    if (lane == 0) pe[(L - 1) * nw + ro.warp] = e;
    role_sync(ro);
    // the block's sums, warp partials in warp order
    auto total = [&](const float* p, int k) {
      float r = p[k * nw];
      for (int w = 1; w < nw; ++w) r += p[k * nw + w];
      return r;
    };
    for (int k = ro.t; k < L; k += rt) {
      sc(sl, kSe, k) = 2.f * total(pe, k);
      if (DEFER) {
        sc(sl, kSn, k) = total(pn, k);
        sc(sl, kSnp, k) = k > 0 ? total(pn, k - 1) : 1.f;
      } else {
        sc(sl, kSnp, k) = 1.f;
      }
    }
  };

  // --- sweep back through block blk from slab sl; dp is the cotangent of
  // the state leaving the block, then entering it
  float dpr = 0.f, dpi = 0.f;  // cotangent of the state entering a step
  float dpc = 0.f, dps = 0.f;  // rotation cotangents, this column's
  int rc = 0;                  // reductions taken, for red_s's halves
  auto sweep = [&](int blk, float* sl) {
    const int k0 = blk * unroll, L = steps(blk);
    struct Tail {
      float ds0, dehat, dn2;
    };
    auto tail = [&](int k) {  // the loss adjoint of step k, per column
      const float s = sc(sl, kSs, k), n2pk = sc(sl, kSnp, k);
      const float ehat = sc(sl, kSe, k);
      const float n2p_c = floor_at(n2pk, norm_eps);
      const float e = DEFER ? ehat / n2p_c : ehat;
      const float arg = floor_at(1.f + e * s, log_eps);
      const float darg = arg > log_eps ? -gc / arg : 0.f;
      const float de = darg * s;
      Tail t;
      t.ds0 = darg * e;
      t.dehat = DEFER ? de / n2p_c : de;
      t.dn2 = (DEFER && n2pk > norm_eps) ? -de * e / n2p_c : 0.f;
      return t;
    };
    // the loss adjoints of the block's steps, off the chain (read after
    // the barrier below)
    for (int k = ro.t; k < L; k += rt) {
      const Tail tk = tail(k);
      tails[k] = tk.dehat;
      tails[unroll + k] = tk.ds0;
      tails[2 * unroll + k] = tk.dn2;
    }
    // deferred norm: the block-exit renormalisation adjoint seeds (dp,
    // dn2) from the unnormalised exit state conj(p) .* y of the last step
    float dn2 = 0.f;
    if (DEFER) {
      float er = 0.f, ei = 0.f;
      if (active) {
        const float yr = vec(sl, kPy, L - 1)[i];
        const float yi = vec(sl, kPy + 1, L - 1)[i];
        er = yr * pci + yi * psi;
        ei = yi * pci - yr * psi;
      }
      const float n2 = sc(sl, kSn, L - 1);
      const float inv = rsqrtf(floor_at(n2, norm_eps));
      const float dinv =
          role_sum(dpr * er + dpi * ei, red_s + 32 * (rc++ & 1), ro);
      dpr *= inv;
      dpi *= inv;
      dn2 = n2 > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
    }
    // R^T (2 dehat y) of the last step
    if (active) {
      const float q = 2.f * tail(L - 1).dehat;
      vec(sl, kPq, L - 1)[i] = prep<P>(q * vec(sl, kPy, L - 1)[i]);
      vec(sl, kPq + 1, L - 1)[i] = prep<P>(q * vec(sl, kPy + 1, L - 1)[i]);
    }
    role_sync(ro);
    float ar = 0.f, ai = 0.f;
    if (active) {
      cdot_t<P>(mrr + i, mri + i, pitch, vec(sl, kPq, L - 1),
                vec(sl, kPq + 1, L - 1), D, ar, ai);
    }
    float bpc = 0.f, bps = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      const float s = sc(sl, kSs, k);
      const float n2k = sc(sl, kSn, k);
      const float q = 2.f * tails[k];
      const float yr = active ? vec(sl, kPy, k)[i] : 0.f;
      const float yi = active ? vec(sl, kPy + 1, k)[i] : 0.f;
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
        const float dinv =
            role_sum(dtr * yr + dti * yi, red_s + 32 * (rc++ & 1), ro);
        dn2 = n2k > norm_eps ? -0.5f * dinv * inv * inv * inv : 0.f;
      }
      dyr = dyr + 2.f * yr * dn2;
      dyi = dyi + 2.f * yi * dn2;
      float ds_part = 0.f;
      if (active) {
        // the loss's terms 2 dehat R y + R^T (2 dehat y)
        dyr = dyr + (q * vec(sl, kPu, k)[i] + ar);
        dyi = dyi + (q * vec(sl, kPu + 1, k)[i] + ai);
        ds_part = dyr * vec(sl, kPg, k)[i] + dyi * vec(sl, kPg + 1, k)[i];
        vec(sl, kPdy, k)[i] = prep<P>(dyr);
        vec(sl, kPdy + 1, k)[i] = prep<P>(dyi);
        if (k > 0) {
          const float qn = 2.f * tails[k - 1];
          vec(sl, kPq, k - 1)[i] = prep<P>(qn * vec(sl, kPy, k - 1)[i]);
          vec(sl, kPq + 1, k - 1)[i] =
              prep<P>(qn * vec(sl, kPy + 1, k - 1)[i]);
        }
      }
      const float d = warp_sum(ds_part);
      if (lane == 0) pds[k * nw + ro.warp] = d;
      role_sync(ro);
      if (active) {
        // C^T dy, R^T dy and, for step k-1, R^T (2 dehat y)
        float o[6];
        const int kq = k > 0 ? k - 1 : k;
        cdot3<P, true, kU>(mcr + i, mci + i, mrr + i, mri + i, mrr + i,
                           mri + i, pitch, vec(sl, kPdy, k),
                           vec(sl, kPdy + 1, k), vec(sl, kPq, kq),
                           vec(sl, kPq + 1, kq), D, o);
        dpr = o[0] + s * o[2];
        dpi = o[1] + s * o[3];
        ar = o[4];
        ai = o[5];
      }
      if (DEFER) dn2 = tails[2 * unroll + k];
    }
    dpc += bpc;
    dps += bps;
    role_sync(ro);
    for (int k = ro.t; k < L; k += rt) {
      float r = pds[k * nw];
      for (int w = 1; w < nw; ++w) r += pds[k * nw + w];
      dse[(k0 + k) * stride + col] = tails[unroll + k] + r;
    }
  };

  // --- the [D,D] cotangent terms of a swept block in slab sl, by the
  // re-run role (the single form's one role)
  auto outer = [&](float* sl, int L) {
    for (int idx = ro.t; idx < dd; idx += rt) {
      const int r = idx / D, c = idx - r * D;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int k = 0; k < L; ++k) {
        const float s = sc(sl, kSs, k);
        const float dr = vec(sl, kPdy, k)[r], di = vec(sl, kPdy + 1, k)[r];
        const float x_r = vec(sl, kPx, k)[c], x_i = vec(sl, kPx + 1, k)[c];
        const float ur = vec(sl, kPq, k)[r], ui = vec(sl, kPq + 1, k)[r];
        const float w_r = prep<P>(vec(sl, kPy, k)[c]);
        const float w_i = prep<P>(vec(sl, kPy + 1, k)[c]);
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
  };

  if (!PIPE) {
    for (int j = 0; j < n_blocks; ++j) {
      const int blk = n_blocks - 1 - j;
      if (kParts & kRerunPart) rerun(blk, slot(0));
      role_sync(ro);
      if (kParts & kSweepPart) sweep(blk, slot(0));
      if (kParts & kOuterPart) outer(slot(0), steps(blk));
      role_sync(ro);
    }
  } else if (!sweeper) {
    // the re-run role: block j into slot j % 2 once the sweep is done
    // with block j-2 there, after that block's outer products
    for (int j = 0; j < n_blocks; ++j) {
      const int blk = n_blocks - 1 - j, q = j & 1;
      if (j >= 2) {
        mbar_wait(done + q, ((j >> 1) - 1) & 1);
        if (kParts & kOuterPart) outer(slot(q), steps(blk + 2));
        role_sync(ro);
      }
      if (kParts & kRerunPart) rerun(blk, slot(q));
      mbar_arrive(full + q);
    }
    for (int j = n_blocks < 2 ? 0 : n_blocks - 2; j < n_blocks; ++j) {
      mbar_wait(done + (j & 1), (j >> 1) & 1);
      if (kParts & kOuterPart) outer(slot(j & 1), steps(n_blocks - 1 - j));
    }
  } else {
    // the sweep role: block j from slot j % 2
    for (int j = 0; j < n_blocks; ++j) {
      const int blk = n_blocks - 1 - j, q = j & 1;
      mbar_wait(full + q, (j >> 1) & 1);
      if (kParts & kSweepPart) sweep(blk, slot(q));
      mbar_arrive(done + q);
    }
  }
  float* out = part + static_cast<size_t>(col) * (4 * dd + 2 * D);
  if (!sweeper) {
    for (int idx = ro.t; idx < dd; idx += rt) {
      for (int m = 0; m < 4; ++m) out[m * dd + idx] = acc[m * dd + idx];
    }
  }
  if ((!PIPE || sweeper) && active) {
    out[4 * dd + i] = dpc;
    out[4 * dd + D + i] = dps;
    dp0r[i * stride + col] = dpr;
    dp0i[i * stride + col] = dpi;
  }
}

}  // namespace amt

extern "C" {

// Dynamic shared memory of one adjoint CTA in the single form: the least
// either form needs, so the ceiling the wrappers check.
size_t amt_psi_split_bwd_smem_bytes(int D, int unroll) {
  return 4 * amt::psi_split_bwd_words(D, unroll, false);
}

// Dynamic shared memory of one adjoint CTA in the given form (pipe: the
// double form).
size_t amt_psi_split_bwd_form_smem_bytes(int D, int unroll, int pipe) {
  return 4 * amt::psi_split_bwd_words(D, unroll, pipe != 0);
}

// The adjoint of amt_psi_split_fwd for the loss cotangent g[B]; see the
// note above. precision: 0 highest, 2 default; pipe: the double form.
// Returns a cudaError_t.
int amt_psi_split_bwd(const float* cr, const float* ci, const float* rr,
                      const float* ri, const float* pc, const float* ps,
                      const float* se, const float* g, const float* ckr,
                      const float* cki, float* dse, float* dp0r, float* dp0i,
                      float* part, int D, int n_steps, int B, int unroll,
                      float log_eps, float norm_eps, int precision,
                      int defer_norm, int pipe, void* stream) {
  const int threads = (pipe ? 2 : 1) * amt::split_threads(D);
  if (unroll < 1 || D < 1 || threads > amt::kSplitBwdPsiThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(amt::dispatch_split(
      precision, defer_norm != 0, [&](auto p, auto d) {
        return amt::dispatch_bool(pipe != 0, [&](auto f) {
          return amt::launch_smem(
              amt::psi_split_bwd_kernel<decltype(p)::value,
                                        decltype(d)::value,
                                        decltype(f)::value>,
              dim3(B), threads,
              4 * amt::psi_split_bwd_words(D, unroll, pipe != 0),
              static_cast<cudaStream_t>(stream), cr, ci, rr, ri, pc, ps, se,
              g, ckr, cki, dse, dp0r, dp0i, part, D, n_steps, B, unroll,
              log_eps, norm_eps);
        });
      }));
}

}  // extern "C"
