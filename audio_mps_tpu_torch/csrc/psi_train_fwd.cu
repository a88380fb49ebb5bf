// Training forward of the psi NLL (block-complex layout) for Hopper: the
// forward-only NLL that also streams every post-step state.
//
// Replaces the TPU kernels audio_mps_tpu/ops/pallas_block.py
// _make_psi_fwd_kernel_stream (deferred norm, the streamed-states forward)
// and _make_psi_fwd_kernel (defer_norm=False). The kernel is psi_fwd_kernel
// of psi_fwd.cuh with the state stream: besides loss[B] it writes
// ys[n_steps, 2D, B] and n2s[n_steps, B], from which the adjoint
// (psi_train_bwd.cu) and the cotangent reduction (psi_cotangents.cu)
// rebuild every step's input state bit for bit. The step, the design and
// what bounds it are described there.
#include "psi_fwd.cuh"

extern "C" {

// Dynamic shared memory of one training-forward CTA (psi_fwd.cuh).
size_t amt_psi_train_fwd_smem_bytes(int D) { return amt::fwd_smem_bytes(D); }

// loss[B], ys[n_steps, 2D, B] and n2s[n_steps, B] from se[n_steps, B]
// (increments / A); see psi_fwd.cuh. precision: 0 highest, 1 high,
// 2 default. Returns a cudaError_t.
int amt_psi_train_fwd(const float* ab, const float* bb, const float* rb,
                      const float* t0, const float* se, float* loss, float* ys,
                      float* n2s, int D, int n_steps, int B, int unroll,
                      float log_eps, float norm_eps, int precision,
                      int defer_norm, void* stream) {
  return static_cast<int>(amt::launch_fwd<true>(
      ab, bb, rb, t0, se, loss, ys, n2s, D, n_steps, B, unroll, log_eps,
      norm_eps, precision, defer_norm != 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
