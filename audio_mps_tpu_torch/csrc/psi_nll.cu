// Forward-only psi NLL (block-complex layout) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py psi_nll_block
// (its inline kernel, built on _psi_step / _psi_step_defer). The kernel is
// psi_fwd_kernel of psi_fwd.cuh in its kNll mode; the step, the
// design and what bounds it are described there.
#include "psi_fwd.cuh"

extern "C" {

// Dynamic shared memory of one NLL CTA of G columns (psi_fwd.cuh).
size_t amt_psi_nll_smem_bytes(int D, int G) {
  return amt::fwd_smem_bytes(D, G);
}

// Per-example NLL loss[B] from se[n_steps, B] (increments / A), G columns a
// CTA (1, 2, 4 or 8); see psi_fwd.cuh. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_psi_nll(const float* ab, const float* bb, const float* rb,
                const float* t0, const float* se, float* loss, int D,
                int n_steps, int B, int unroll, float log_eps, float norm_eps,
                int precision, int defer_norm, int cols_per_cta,
                void* stream) {
  return static_cast<int>(amt::launch_fwd<amt::kNll>(
      ab, bb, rb, t0, se, loss, nullptr, nullptr, nullptr, D, n_steps, B,
      unroll, unroll, log_eps, norm_eps, precision, defer_norm != 0,
      cols_per_cta, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
