// Training forward of the psi NLL (block-complex layout) for Hopper: the
// forward-only NLL that also streams every post-step state, or writes the
// block-entry checkpoints instead.
//
// Replaces the TPU kernels audio_mps_tpu/ops/pallas_block.py
// _make_psi_fwd_kernel_stream (deferred norm, the streamed-states forward)
// and _make_psi_fwd_kernel (:461; defer_norm=False, and with the deferred
// norm the forward of the recompute adjoint _make_psi_bwd_kernel_defer,
// :621). The kernel is psi_fwd_kernel of psi_fwd.cuh. With the state stream
// (kStream) it writes, besides loss[B], ys[n_steps, 2D, B] and
// n2s[n_steps, B], from which the adjoint (psi_train_bwd.cu) and the
// cotangent reduction (psi_cotangents.cu) rebuild every step's input state
// bit for bit. With checkpoints (kCkpt) it writes ck[n_blocks, 2D, B], the
// state entering each unroll-step block: 1/unroll of the stream's bytes,
// from which psi_recompute.cu rebuilds a segment's ys and n2s for the same
// adjoint. The step, the design and what bounds it are described there.
#include "psi_fwd.cuh"

extern "C" {

// Dynamic shared memory of one training-forward (or recompute) CTA of G
// columns (psi_fwd.cuh).
size_t amt_psi_train_fwd_smem_bytes(int D, int G) {
  return amt::fwd_smem_bytes(D, G);
}

// loss[B], ys[n_steps, 2D, B] and n2s[n_steps, B] from se[n_steps, B]
// (increments / A), G columns a CTA (1, 2, 4 or 8); see psi_fwd.cuh.
// precision: 0 highest, 1 high, 2 default. Returns a cudaError_t.
int amt_psi_train_fwd(const float* ab, const float* bb, const float* rb,
                      const float* t0, const float* se, float* loss, float* ys,
                      float* n2s, int D, int n_steps, int B, int unroll,
                      float log_eps, float norm_eps, int precision,
                      int defer_norm, int cols_per_cta, void* stream) {
  return static_cast<int>(amt::launch_fwd<amt::kStream>(
      ab, bb, rb, t0, se, loss, ys, n2s, nullptr, D, n_steps, B, unroll,
      unroll, log_eps, norm_eps, precision, defer_norm != 0, cols_per_cta,
      static_cast<cudaStream_t>(stream)));
}

// loss[B] and the checkpoints ck[ceil(n_steps / unroll), 2D, B] from
// se[n_steps, B], G columns a CTA; see psi_fwd.cuh. Returns a cudaError_t.
int amt_psi_train_fwd_ckpt(const float* ab, const float* bb, const float* rb,
                           const float* t0, const float* se, float* loss,
                           float* ck, int D, int n_steps, int B, int unroll,
                           float log_eps, float norm_eps, int precision,
                           int defer_norm, int cols_per_cta, void* stream) {
  return static_cast<int>(amt::launch_fwd<amt::kCkpt>(
      ab, bb, rb, t0, se, loss, nullptr, nullptr, ck, D, n_steps, B, unroll,
      unroll, log_eps, norm_eps, precision, defer_norm != 0, cols_per_cta,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
