// Training forward of the rho NLL (purification factor, block-complex
// layout) for Hopper: the forward-only NLL that also streams every
// post-step factor and its trace, or writes the block-entry checkpoints
// instead.
//
// Replaces the TPU kernels audio_mps_tpu/ops/pallas_block.py
// _make_rho_fwd_kernel_batched (:1366: stream=True, deferred norm, the
// training default; stream=False, the forward of the recompute adjoint)
// and _make_rho_fwd_kernel (:1602: defer_norm=False, and the forward of
// _make_rho_bwd_kernel_defer). The kernel is rho_fwd_kernel of rho_fwd.cuh.
// With the state stream (kStream) it writes, besides loss[B],
// ys[n_steps, 2D, B*R] and trs[n_steps, B], from which the adjoint
// (rho_train_bwd.cu) and the cotangents rebuild every step's input factor
// bit for bit. With checkpoints (kCkpt) it writes ck[n_blocks, 2D, B*R],
// the factor entering each unroll-step block, from which rho_recompute.cu
// rebuilds one time segment's ys and trs at a time. The step, the design
// and what bounds it are described there; the stream adds one coalesced
// store of the segment a step, the checkpoints one a block.
#include "rho_fwd.cuh"

extern "C" {

// Dynamic shared memory of a forward CTA (rho_fwd.cuh) in clusters of C,
// with nbuf state buffers; recompute: the kRecompute CTA (no Xb).
size_t amt_rho_fwd_smem_bytes(int D, int R, int C, int recompute,
                              int nbuf) {
  return amt::rho_fwd_smem_bytes(D, R, C,
                                 recompute ? amt::kRecompute : amt::kStream,
                                 nbuf);
}

// The state buffers a forward launch takes on the current card (2 where
// they fit its shared memory, else 1).
int amt_rho_fwd_buffers(int D, int R, int C, int recompute) {
  return amt::rho_fwd_buffers(D, R, C,
                              recompute ? amt::kRecompute : amt::kStream,
                              amt::smem_optin());
}

// The least dynamic shared memory of a forward CTA that holds an example's
// whole segment (one CTA an example, one state buffer): the monolithic
// rho kernels take (D, R) where it fits.
size_t amt_rho_train_fwd_smem_bytes(int D, int R) {
  return amt::rho_fwd_smem_bytes(D, R, 1, amt::kStream, 1);
}

// Clusters of C forward CTAs (the NLL's, the streamed and the checkpoint
// forward's: one size) the current card holds at once; a negative
// cudaError_t when the query fails.
int amt_rho_fwd_max_clusters(int D, int R, int C) {
  return amt::rho_fwd_max_clusters<amt::kStream>(D, R, C);
}

// loss[B], ys[n_steps, 2D, B*R] and trs[n_steps, B] from se[n_steps, B]
// (increments / A), in clusters of `cluster` CTAs an example; see
// rho_fwd.cuh. precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_rho_train_fwd(const float* ab, const float* bb, const float* xb,
                      const float* t0, const float* se, float* loss, float* ys,
                      float* trs, int D, int n_steps, int B, int R, int unroll,
                      float log_eps, float norm_eps, int precision,
                      int defer_norm, int cluster, void* stream) {
  return static_cast<int>(amt::launch_rho_fwd<amt::kStream>(
      ab, bb, xb, t0, se, loss, ys, trs, nullptr, D, n_steps, B, R, unroll,
      log_eps, norm_eps, precision, defer_norm != 0, cluster,
      static_cast<cudaStream_t>(stream)));
}

// loss[B] and the checkpoints ck[ceil(n_steps / unroll), 2D, B*R] from
// se[n_steps, B]; see rho_fwd.cuh. Returns a cudaError_t.
int amt_rho_train_fwd_ckpt(const float* ab, const float* bb, const float* xb,
                           const float* t0, const float* se, float* loss,
                           float* ck, int D, int n_steps, int B, int R,
                           int unroll, float log_eps, float norm_eps,
                           int precision, int defer_norm, int cluster,
                           void* stream) {
  return static_cast<int>(amt::launch_rho_fwd<amt::kCkpt>(
      ab, bb, xb, t0, se, loss, nullptr, nullptr, ck, D, n_steps, B, R,
      unroll, log_eps, norm_eps, precision, defer_norm != 0, cluster,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
