// The recompute of the rank-partials recompute adjoint (rho purification
// factor, block-complex layout, a chunk of rank rows at a time) for
// Hopper: a time segment's state stream rebuilt from the forward's block
// checkpoints.
//
// Replaces the recompute half of the TPU kernel audio_mps_tpu/ops/
// pallas_rank.py _make_rank_partials_bwd_kernel (:152), which re-evolves
// each unroll-step block from its checkpoint ck before its reverse sweep,
// driven by the streamed cotangent rows d ehat, d tr and dtfin. Here the
// training path (ops/rank.py rank_recompute_bwd) runs time segments of
// whole blocks, last first: this kernel rebuilds the segment's ys from the
// segment's checkpoints, then the streamed adjoint (rank_partials_bwd.cu,
// its dtfin carried in from the next segment) and the cotangents
// (psi_cotangents.cu over the lanes) run over them. The forward runs once
// (no torch.utils.checkpoint), and the card holds the checkpoints and one
// segment's ys and dy.
//
// The kernel is rank_partials_fwd_kernel of rank_partials_fwd.cuh in its
// kRecompute mode: CTA (segment of rc columns, block j) starts from ck[j]
// and runs the block's steps (the last block of the run may be shorter)
// with the forward's instructions, so ys equals the streamed forward's bit
// for bit. The partials and the exit renorm are not needed (the forward
// wrote tr), so only the update product runs. A time segment's blocks run
// side by side: 128 segments x 32 blocks = 4096 CTAs at the D=256 model,
// where the forward has 128; the clusters run along the segment axis (x),
// so a cluster's CTAs re-run the same block.
//
// What bounds it: one product of 2 (2D)^2 rc FLOPs a segment-step, with
// (Ab + s Bb) formed in registers from the ring's raw slabs of Ab and Bb
// (2 MiB a CTA-step at D=256), as in the forward (rank_partials_fwd.cuh);
// each CTA also fills the ring afresh for its 16 steps.
#include "rank_partials_fwd.cuh"

extern "C" {

// ys [n_steps, 2D, S*rc] of a time segment of n_steps steps (se
// [n_steps, B]) from its checkpoints ck [ceil(n_steps / unroll), 2D, S*rc]
// and the j-major constants abt, bbt (xbt is not read); the segment starts
// at a block entry; clusters of `cluster` segments. See
// rank_partials_fwd.cuh. precision: 0 highest, 1 high, 2 default. Returns a
// cudaError_t.
int amt_rank_partials_recompute(const float* abt, const float* bbt,
                                const float* ck, const float* se, float* ys,
                                int D, int n_steps, int B, int S, int rc,
                                int unroll, float norm_eps, int precision,
                                int cluster, void* stream) {
  return static_cast<int>(amt::launch_partials_fwd<amt::kRecompute>(
      abt, bbt, nullptr, ck, se, nullptr, nullptr, nullptr, ys, nullptr, D,
      n_steps, B, S, rc, unroll, norm_eps, precision, cluster,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
