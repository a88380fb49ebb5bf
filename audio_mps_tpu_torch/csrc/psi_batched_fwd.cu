// Training forward of psi's spine/limbs pair (block-complex layout,
// deferred norm) for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_block.py
// _make_psi_fwd_kernel_batched (:276), which the factory
// _psi_block_factory runs with batched=True (off by default, on the TPU as
// here). The kernel is psi_fwd_kernel of psi_fwd.cuh in its kBatched mode:
// one CTA per column loops over the blocks; each block's spine runs the
// state recurrence alone, then one walk of Rb per chunk of the block's
// states gives every expectation, and the loss and the exit renorm follow.
// It writes loss[B] and the block checkpoints ck[n_blocks, 2D, B] for the
// adjoint (psi_batched_bwd.cu), the same bits as the checkpoint forward
// (psi_train_fwd.cu, kCkpt) writes.
//
// What bounds it: the spine's two [2D,2D] x [2D] products a step (one FMA
// per 4-byte shared load of Ab or Bb and one of the state, one CTA barrier a
// step) and the limb's Rb product (kChunk FMAs per 4-byte load of Rb, two
// 16-byte broadcast loads of the states); device memory moves se, ck and the
// constants once. So shared-memory reads and the spine's barrier latency
// bound it, as psi_fwd.cuh says of the other modes.
#include "psi_fwd.cuh"

extern "C" {

// Dynamic shared memory of one batched forward CTA (psi_fwd.cuh).
size_t amt_psi_batched_fwd_smem_bytes(int D, int unroll) {
  return amt::batched_fwd_smem_bytes(D, unroll);
}

// loss[B] and ck[ceil(n_steps / unroll), 2D, B] from se[n_steps, B]
// (increments / A), deferred norm; see psi_fwd.cuh. precision: 0 highest,
// 1 high, 2 default. Returns a cudaError_t.
int amt_psi_batched_fwd(const float* ab, const float* bb, const float* rb,
                        const float* t0, const float* se, float* loss,
                        float* ck, int D, int n_steps, int B, int unroll,
                        float log_eps, float norm_eps, int precision,
                        void* stream) {
  return static_cast<int>(amt::launch_fwd<amt::kBatched>(
      ab, bb, rb, t0, se, loss, nullptr, nullptr, ck, D, n_steps, B, unroll,
      unroll, log_eps, norm_eps, precision, true, 1,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
