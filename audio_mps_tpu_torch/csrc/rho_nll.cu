// Forward-only rho NLL (purification factor, block-complex layout) for
// Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py rho_nll_block
// (its inline kernel, :2519, built on _rho_step / _rho_step_defer). The
// kernel is rho_fwd_kernel of rho_fwd.cuh in its kNll mode; the
// step, the design and what bounds it are described there.
#include "rho_fwd.cuh"

extern "C" {

// Per-example NLL loss[B] from se[n_steps, B] (increments / A) and the
// factors t0[2D, B*R], in clusters of `cluster` CTAs an example (dividing
// ceil(R/4)); see rho_fwd.cuh. precision: 0 highest, 1 high, 2 default.
// Returns a cudaError_t.
int amt_rho_nll(const float* ab, const float* bb, const float* xb,
                const float* t0, const float* se, float* loss, int D,
                int n_steps, int B, int R, int unroll, float log_eps,
                float norm_eps, int precision, int defer_norm, int cluster,
                void* stream) {
  return static_cast<int>(amt::launch_rho_fwd<amt::kNll>(
      ab, bb, xb, t0, se, loss, nullptr, nullptr, nullptr, D, n_steps, B, R,
      unroll, log_eps, norm_eps, precision, defer_norm != 0, cluster,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
