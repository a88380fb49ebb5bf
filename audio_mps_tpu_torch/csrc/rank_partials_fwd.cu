// Training forward of the rank partials (rho purification factor,
// block-complex layout, a chunk of rank rows at a time) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_rank.py
// _make_rank_partials_fwd_kernel (:80: stream=True, and stream=False, the
// forward of the recompute adjoint _make_rank_partials_bwd_kernel :152).
// The kernel is rank_partials_fwd_kernel of rank_partials_fwd.cuh: with the
// state stream (kStream) it writes every step's state for the streamed
// adjoint (rank_partials_bwd.cu); with checkpoints (kCkpt) the state
// entering each unroll-step block, from which rank_partials_recompute.cu
// rebuilds one time segment's states at a time for the same adjoint. The
// step, the design and what bounds it are described there.
#include "rank_partials_fwd.cuh"

extern "C" {

// Dynamic shared memory of a partials CTA (every partials kernel takes the
// same).
size_t amt_rank_partials_smem_bytes(int D, int rc) {
  return amt::partials_smem_bytes(D, rc);
}

// Clusters of `cluster` partials CTAs the card holds at once, or a negative
// cudaError_t.
int amt_rank_partials_max_clusters(int D, int rc, int cluster) {
  if (!amt::partials_fits(D, rc) || cluster < 1 ||
      cluster > amt::kMaxCluster) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return amt::max_partials_clusters(
      amt::rank_partials_fwd_kernel<amt::kHighest, amt::kStream>, cluster,
      amt::partials_smem_bytes(D, rc));
}

// eh, tr [n_steps, S], tfin [2D, S*rc] and ys [n_steps, 2D, S*rc] from the
// j-major constants abt, bbt, xbt (the transposes of Ab, Bb, Xb), t0
// [2D, S*rc] and se [n_steps, B]; S segments of rc columns, S / B an
// example, in clusters of `cluster` segments (1 .. 16, dividing S / B).
// precision: 0 highest, 1 high, 2 default. Returns a cudaError_t.
int amt_rank_partials_fwd(const float* abt, const float* bbt,
                          const float* xbt, const float* t0, const float* se,
                          float* eh, float* tr, float* tfin, float* ys, int D,
                          int n_steps, int B, int S, int rc, int unroll,
                          float norm_eps, int precision, int cluster,
                          void* stream) {
  return static_cast<int>(amt::launch_partials_fwd<amt::kStream>(
      abt, bbt, xbt, t0, se, eh, tr, tfin, ys, nullptr, D, n_steps, B, S, rc,
      unroll, norm_eps, precision, cluster,
      static_cast<cudaStream_t>(stream)));
}

// eh, tr [n_steps, S], tfin [2D, S*rc] and the checkpoints
// ck [ceil(n_steps / unroll), 2D, S*rc], as amt_rank_partials_fwd without
// the stream. Returns a cudaError_t.
int amt_rank_partials_fwd_ckpt(const float* abt, const float* bbt,
                               const float* xbt, const float* t0,
                               const float* se, float* eh, float* tr,
                               float* tfin, float* ck, int D, int n_steps,
                               int B, int S, int rc, int unroll,
                               float norm_eps, int precision, int cluster,
                               void* stream) {
  return static_cast<int>(amt::launch_partials_fwd<amt::kCkpt>(
      abt, bbt, xbt, t0, se, eh, tr, tfin, nullptr, ck, D, n_steps, B, S, rc,
      unroll, norm_eps, precision, cluster,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
