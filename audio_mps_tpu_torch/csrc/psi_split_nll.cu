// Forward-only psi NLL in the split layout for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_scan.py
// _make_psi_nll_kernel (via psi_nll_pallas). The kernel is
// psi_split_fwd_kernel of psi_split_fwd.cuh in its kNll mode; the step, the
// design and what bounds it are described there.
#include "psi_split_fwd.cuh"

extern "C" {

// Dynamic shared memory of one NLL CTA (psi_split_fwd.cuh).
size_t amt_psi_split_fwd_smem_bytes(int D) {
  return amt::split_fwd_smem_bytes(D);
}

// Per-example NLL loss[B] from se[n_steps, B] (increments / A); see
// psi_split_fwd.cuh. precision: 0 highest, 2 default (1, high, is refused
// with cudaErrorInvalidValue). Returns a cudaError_t.
int amt_psi_split_nll(const float* cr, const float* ci, const float* rr,
                      const float* ri, const float* pc, const float* ps,
                      const float* s0r, const float* s0i, const float* se,
                      float* loss, int D, int n_steps, int B, int unroll,
                      float log_eps, float norm_eps, int precision,
                      int defer_norm, void* stream) {
  return static_cast<int>(amt::launch_split_fwd<amt::kNll>(
      cr, ci, rr, ri, pc, ps, s0r, s0i, se, loss, nullptr, nullptr, D,
      n_steps, B, unroll, log_eps, norm_eps, precision, defer_norm != 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
