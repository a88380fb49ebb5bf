// The recompute of the psi recompute adjoint (block-complex layout) for
// Hopper: a segment's state stream rebuilt from the forward's block
// checkpoints.
//
// Replaces the recompute half of the TPU kernel audio_mps_tpu/ops/
// pallas_block.py _make_psi_bwd_kernel_defer (:621; and, with the per-step
// norm, _make_psi_bwd_kernel :529): each grid step there re-evolves its
// unroll-step block from the checkpoint ck before its reverse sweep. Here
// the training path (ops/block.py psi_recompute_bwd) runs time segments of
// whole blocks, last first: this kernel rebuilds the segment's ys and n2s
// from the segment's checkpoints, then the streamed adjoint
// (psi_train_bwd.cu, carrying dt in from the next segment) and the
// cotangent reduction (psi_cotangents.cu) run over them. So the card holds
// the checkpoints and one segment's ys and dy where the streamed path holds
// the whole run's.
//
// The kernel is psi_fwd_kernel of psi_fwd.cuh in its kRecompute mode: CTA
// (column group, j) runs the steps of span j (a whole number of blocks;
// the last span of the run may be shorter), each block from its own
// checkpoint, as the plain version does, with the forward's own
// instructions, so from the forward's checkpoints ys and n2s equal the
// streamed forward's bit for bit. Unlike the TPU's grid, which is serial
// in time, the spans are independent and run side by side.
//
// What bounds it: the forward's update products (2 x 2 (2D)^2 FLOPs a
// column-step; the expectation Rb y feeds only the loss and is skipped),
// bound by shared-memory reads and barrier latency as in psi_fwd.cuh, plus
// each CTA's load of Ab and Bb into shared memory (128 KB at D=64, stored
// transposed with bank conflicts): that load costs about as much as a
// block of 16 steps, so the wrapper gives a CTA several blocks
// (ops/block.py psi_recompute_blocks) while the grid still fills the SMs;
// device memory moves the checkpoint read and the ys write.
#include "psi_fwd.cuh"

extern "C" {

// ys[n_steps, 2D, B] and n2s[n_steps, B] of a segment of n_steps steps
// (se[n_steps, B]) from its checkpoints ck[ceil(n_steps / unroll), 2D, B],
// blocks_per_cta blocks and G columns a CTA; the segment starts at a block
// entry; rb is not read. See psi_fwd.cuh. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_psi_recompute(const float* ab, const float* bb, const float* rb,
                      const float* ck, const float* se, float* ys, float* n2s,
                      int D, int n_steps, int B, int unroll,
                      int blocks_per_cta, float norm_eps, int precision,
                      int defer_norm, int cols_per_cta, void* stream) {
  return static_cast<int>(amt::launch_fwd<amt::kRecompute>(
      ab, bb, rb, ck, se, nullptr, ys, n2s, nullptr, D, n_steps, B, unroll,
      unroll * blocks_per_cta, 0.f, norm_eps, precision, defer_norm != 0,
      cols_per_cta, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
