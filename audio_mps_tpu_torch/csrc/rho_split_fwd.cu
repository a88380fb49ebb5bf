// The rho training forward in the split layout for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_grad.py
// _make_rho_fwd_kernel (the forward of _rho_fused_nll_factory). The kernel
// is rho_split_fwd_kernel of rho_split_fwd.cuh in its kCkpt mode: the
// per-example loss and the factor entering each unroll-step block, from
// which the adjoint (rho_split_bwd.cu) re-runs each block; the step, the
// design and what bounds it are described there.
#include "rho_split_fwd.cuh"

extern "C" {

// Per-example NLL loss[B] and the block checkpoints ckr, cki [n_blocks, D,
// B * rank], n_blocks = ceil(n_steps / unroll), from se[n_steps, B]; see
// rho_split_fwd.cuh. precision: 0 highest, 2 default; warp_local 0 forces
// the element layout. Returns a cudaError_t.
int amt_rho_split_fwd(const float* ccr, const float* cci, const float* rcr,
                      const float* rci, const float* xtr, const float* xti,
                      const float* pc, const float* ps, const float* h0r,
                      const float* h0i, const float* se, float* loss,
                      float* ckr, float* cki, int D, int n_steps, int B,
                      int rank, int unroll, float log_eps, float norm_eps,
                      int precision, int defer_norm, int warp_local,
                      void* stream) {
  return static_cast<int>(amt::launch_rho_split_fwd<amt::kCkpt>(
      ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se, loss, ckr, cki, D,
      n_steps, B, rank, unroll, log_eps, norm_eps, precision, defer_norm != 0,
      warp_local != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
