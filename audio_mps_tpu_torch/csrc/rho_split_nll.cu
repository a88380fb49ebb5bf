// Forward-only rho NLL in the split layout for Hopper.
//
// Replaces the TPU kernel audio_mps_tpu/ops/pallas_scan.py
// _make_rho_nll_kernel (via rho_nll_pallas). The kernel is
// rho_split_fwd_kernel of rho_split_fwd.cuh in its kNll mode; the step, the
// design and what bounds it are described there.
#include "rho_split_fwd.cuh"

extern "C" {

// Dynamic shared memory of one NLL or training-forward CTA
// (rho_split_fwd.cuh).
size_t amt_rho_split_fwd_smem_bytes(int D, int rank) {
  return amt::rho_split_fwd_smem_bytes(D, rank);
}

// The layout the NLL and training forward launch for an example's [D,
// rank] segment (rho_split_fwd.cuh; warp_local 0: the element layout at
// every shape), one field: 0 the columns a warp (0: the element layout), 1
// the threads, 2 the elements a thread, 3 the loss ring's slots, 4 the
// dynamic shared memory in bytes.
int amt_rho_split_fwd_layout(int D, int rank, int warp_local, int field) {
  const amt::RhoFwdLayout l =
      amt::rho_split_fwd_layout(D, rank, warp_local != 0);
  const int fields[5] = {
      l.cols, l.threads, l.elems, l.slots,
      static_cast<int>(amt::rho_split_fwd_smem_bytes(D, rank,
                                                     warp_local != 0))};
  return field >= 0 && field < 5 ? fields[field] : -1;
}

// Per-example NLL loss[B] from se[n_steps, B] (increments / A) and the
// factors h0r, h0i [D, B * rank]; see rho_split_fwd.cuh. precision: 0
// highest, 2 default (1, high, is refused with cudaErrorInvalidValue);
// warp_local 0 forces the element layout. Returns a cudaError_t.
int amt_rho_split_nll(const float* ccr, const float* cci, const float* rcr,
                      const float* rci, const float* xtr, const float* xti,
                      const float* pc, const float* ps, const float* h0r,
                      const float* h0i, const float* se, float* loss, int D,
                      int n_steps, int B, int rank, int unroll, float log_eps,
                      float norm_eps, int precision, int defer_norm,
                      int warp_local, void* stream) {
  return static_cast<int>(amt::launch_rho_split_fwd<amt::kNll>(
      ccr, cci, rcr, rci, xtr, xti, pc, ps, h0r, h0i, se, loss, nullptr,
      nullptr, D, n_steps, B, rank, unroll, log_eps, norm_eps, precision,
      defer_norm != 0, warp_local != 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
