// Training forward of the rho NLL (purification factor, block-complex
// layout) for Hopper: the forward-only NLL that also streams every
// post-step factor and its trace.
//
// Replaces the TPU kernels audio_mps_tpu/ops/pallas_block.py
// _make_rho_fwd_kernel_batched (:1366, stream=True: deferred norm, the
// training default) and _make_rho_fwd_kernel (:1602, defer_norm=False).
// The kernel is rho_fwd_kernel of rho_fwd.cuh with the state stream: besides
// loss[B] it writes ys[n_steps, 2D, B*R] and trs[n_steps, B], from which the
// adjoint (rho_train_bwd.cu) and the cotangents rebuild every step's input
// factor bit for bit. The step, the design and what bounds it are described
// there; the stream adds one coalesced store of the segment a step.
#include "rho_fwd.cuh"

extern "C" {

// Dynamic shared memory of one training-forward CTA (rho_fwd.cuh).
size_t amt_rho_train_fwd_smem_bytes(int D, int R) {
  return amt::rho_fwd_smem_bytes(D, R);
}

// loss[B], ys[n_steps, 2D, B*R] and trs[n_steps, B] from se[n_steps, B]
// (increments / A); see rho_fwd.cuh. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_rho_train_fwd(const float* ab, const float* bb, const float* xb,
                      const float* t0, const float* se, float* loss, float* ys,
                      float* trs, int D, int n_steps, int B, int R, int unroll,
                      float log_eps, float norm_eps, int precision,
                      int defer_norm, void* stream) {
  return static_cast<int>(amt::launch_rho_fwd<true>(
      ab, bb, xb, t0, se, loss, ys, trs, D, n_steps, B, R, unroll, log_eps,
      norm_eps, precision, defer_norm != 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
