// The recompute of the rho recompute adjoints (purification factor,
// block-complex layout) for Hopper: a segment's factor stream rebuilt from
// the forward's block checkpoints.
//
// Replaces the recompute half of the TPU kernels audio_mps_tpu/ops/
// pallas_block.py _make_rho_bwd_kernel_batched with stream=False (:1438)
// and _make_rho_bwd_kernel_defer (:1790), and, with the per-step norm,
// _make_rho_bwd_kernel (:1689): each grid step there re-evolves its
// unroll-step block from the checkpoint ck before its reverse sweep. The
// first two are one function, which the TPU's factory picks between by its
// 128-lane rule (:1949-1952); here they are one kernel. The training path
// (ops/block.py rho_recompute_bwd) runs time segments of whole blocks,
// last first: this kernel rebuilds the segment's ys and trs from the
// segment's checkpoints, then the streamed adjoint (rho_train_bwd.cu,
// carrying dt in from the next segment) and the cotangents
// (psi_cotangents.cu over the B*R lanes) run over them. The card holds the
// checkpoints and one segment's ys and dy where the streamed path holds
// the whole run's.
//
// The kernel is rho_fwd_kernel of rho_fwd.cuh in its kRecompute mode: CTA
// (example, block j) starts from ck[j] and runs the block's steps (the last
// block of the run may be shorter) with the forward's instructions, so ys
// and trs equal the streamed forward's bit for bit. The TPU's grid is
// serial in time; here a segment's blocks run side by side, so at B=8 a
// segment of 32 blocks is 256 clusters where the forward has 8.
//
// What bounds it: the forward's update products, 2 (2D)^2 R FLOPs each an
// example-step (the expectation Xb y feeds only the loss and is skipped),
// on the fp32 pipes of every SM now, plus each CTA's load of the constants
// from L2 (128 KB at D=64) for at most unroll steps; device memory moves
// the checkpoint read and the ys write.
#include "rho_fwd.cuh"

extern "C" {

// Clusters of C recompute CTAs the current card holds at once; a negative
// cudaError_t when the query fails.
int amt_rho_recompute_max_clusters(int D, int R, int C) {
  return amt::rho_fwd_max_clusters<amt::kRecompute>(D, R, C);
}

// ys[n_steps, 2D, B*R] and trs[n_steps, B] of a segment of n_steps steps
// (se[n_steps, B]) from its checkpoints ck[ceil(n_steps / unroll), 2D,
// B*R]; the segment starts at a block entry; xb is not read. See
// rho_fwd.cuh; in clusters of `cluster` CTAs an (example, block).
// precision: 0 highest, 1 high, 2 default. Returns a cudaError_t.
int amt_rho_recompute(const float* ab, const float* bb, const float* xb,
                      const float* ck, const float* se, float* ys, float* trs,
                      int D, int n_steps, int B, int R, int unroll,
                      float norm_eps, int precision, int defer_norm,
                      int cluster, void* stream) {
  return static_cast<int>(amt::launch_rho_fwd<amt::kRecompute>(
      ab, bb, xb, ck, se, nullptr, ys, trs, nullptr, D, n_steps, B, R,
      unroll, 0.f, norm_eps, precision, defer_norm != 0, cluster,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
