// The psi training forward in the split layout for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_grad.py
// _make_psi_fwd_kernel (the forward of _psi_fused_nll_factory). The kernel
// is psi_split_fwd_kernel of psi_split_fwd.cuh in its kCkpt mode: the
// per-example loss and the state entering each unroll-step block, from which
// the adjoint (psi_split_bwd.cu) re-runs each block; the step, the design
// and what bounds it are described there.
#include "psi_split_fwd.cuh"

extern "C" {

// Per-example NLL loss[B] and the block checkpoints ckr, cki [n_blocks, D,
// B], n_blocks = ceil(n_steps / unroll), from se[n_steps, B]; see
// psi_split_fwd.cuh. precision: 0 highest, 2 default. Returns a
// cudaError_t.
int amt_psi_split_fwd(const float* cr, const float* ci, const float* rr,
                      const float* ri, const float* pc, const float* ps,
                      const float* s0r, const float* s0i, const float* se,
                      float* loss, float* ckr, float* cki, int D, int n_steps,
                      int B, int unroll, float log_eps, float norm_eps,
                      int precision, int defer_norm, void* stream) {
  return static_cast<int>(amt::launch_split_fwd<amt::kCkpt>(
      cr, ci, rr, ri, pc, ps, s0r, s0i, se, loss, ckr, cki, D, n_steps, B,
      unroll, log_eps, norm_eps, precision, defer_norm != 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
