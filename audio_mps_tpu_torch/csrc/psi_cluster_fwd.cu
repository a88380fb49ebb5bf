// psi's block forward chain in the cluster layout (D % 4 == 0, 72 to 256 on
// the main path) for Hopper: the forward-only NLL, the training forward with
// the state stream or the block checkpoints, and the segment recompute.
//
// Replaces, past the quad layout's D <= 68, the TPU kernels of
// audio_mps_tpu/ops/pallas_block.py: the NLL's inline kernel (:2428, in
// psi_nll_block :2398), _make_psi_fwd_kernel_stream (:875, the streamed
// training forward), _make_psi_fwd_kernel (:461: defer_norm=False, and the
// checkpoint forward of the recompute adjoint) and the re-run of
// _make_psi_bwd_kernel_defer (:621; _make_psi_bwd_kernel :529). These are
// the same functions as psi_nll.cu, psi_train_fwd.cu and psi_recompute.cu
// compute, with the same outputs; the kernel is psi_cl_fwd_kernel of
// psi_cluster.cuh, whose note has the step, the design and what bounds it.
#include "psi_cluster.cuh"

extern "C" {

// Dynamic shared memory of one forward CTA at D, cluster C and G columns a
// cluster; 0 where the layout does not take D and C.
size_t amt_psi_cl_fwd_smem_bytes(int D, int C, int G) {
  return amt::cl_ok(D, C) ? amt::cl_fwd_smem_bytes(D, C, G) : 0;
}

// Threads of one CTA of the layout (forward, chain and sampler).
int amt_psi_cl_threads(int D, int C) { return amt::ClLayout(D, C).threads; }

// Per-example NLL loss[B] from se[n_steps, B]; clusters of C CTAs, G
// columns a cluster. precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_psi_cl_nll(const float* ab, const float* bb, const float* rb,
                   const float* t0, const float* se, float* loss, int D,
                   int n_steps, int B, int unroll, float log_eps,
                   float norm_eps, int precision, int defer_norm, int C, int G,
                   void* stream) {
  return static_cast<int>(amt::launch_cl_fwd<amt::kNll>(
      ab, bb, rb, t0, se, loss, nullptr, nullptr, nullptr, D, n_steps, B,
      unroll, unroll, log_eps, norm_eps, precision, defer_norm != 0, C, G,
      static_cast<cudaStream_t>(stream)));
}

// loss[B], ys[n_steps, 2D, B] and n2s[n_steps, B]; see amt_psi_cl_nll.
int amt_psi_cl_train_fwd(const float* ab, const float* bb, const float* rb,
                         const float* t0, const float* se, float* loss,
                         float* ys, float* n2s, int D, int n_steps, int B,
                         int unroll, float log_eps, float norm_eps,
                         int precision, int defer_norm, int C, int G,
                         void* stream) {
  return static_cast<int>(amt::launch_cl_fwd<amt::kStream>(
      ab, bb, rb, t0, se, loss, ys, n2s, nullptr, D, n_steps, B, unroll,
      unroll, log_eps, norm_eps, precision, defer_norm != 0, C, G,
      static_cast<cudaStream_t>(stream)));
}

// loss[B] and the checkpoints ck[ceil(n_steps / unroll), 2D, B]; see
// amt_psi_cl_nll.
int amt_psi_cl_train_fwd_ckpt(const float* ab, const float* bb,
                              const float* rb, const float* t0,
                              const float* se, float* loss, float* ck, int D,
                              int n_steps, int B, int unroll, float log_eps,
                              float norm_eps, int precision, int defer_norm,
                              int C, int G, void* stream) {
  return static_cast<int>(amt::launch_cl_fwd<amt::kCkpt>(
      ab, bb, rb, t0, se, loss, nullptr, nullptr, ck, D, n_steps, B, unroll,
      unroll, log_eps, norm_eps, precision, defer_norm != 0, C, G,
      static_cast<cudaStream_t>(stream)));
}

// ys[n_steps, 2D, B] and n2s[n_steps, B] of a segment (starting at a block
// entry) from its checkpoints ck[ceil(n_steps / unroll), 2D, B],
// blocks_per_cta blocks a span; rb is not read. Returns a cudaError_t.
int amt_psi_cl_recompute(const float* ab, const float* bb, const float* rb,
                         const float* ck, const float* se, float* ys,
                         float* n2s, int D, int n_steps, int B, int unroll,
                         int blocks_per_cta, float norm_eps, int precision,
                         int defer_norm, int C, int G, void* stream) {
  return static_cast<int>(amt::launch_cl_fwd<amt::kRecompute>(
      ab, bb, rb, ck, se, nullptr, ys, n2s, nullptr, D, n_steps, B, unroll,
      unroll * blocks_per_cta, 0.f, norm_eps, precision, defer_norm != 0, C,
      G, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
