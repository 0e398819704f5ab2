// Log-space Forward scan, written by hand for Hopper (sm_90a): the
// (logsumexp, +) semiring case of the kernel template in p7_viterbi.cuh,
// whose header comment gives the recurrence, the bound and the design. It
// is compiled from its own source so that it builds beside the Viterbi
// cases instead of after them.
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_p7.py::_p7_kernel with
// forward=True (launched by p7_pallas_call; forward_pallas(prob_space=
// False)), the careful referee of the probability-space Forward kernel
// (p7_forward_kernel.cu) on long sequences. It takes the eager Viterbi
// kernel's operands (prepare_p7_device: log scores, the full 16-column
// chain at ceil(log2 M_pad) passes, log tr_rows) and carries (M, I, D and
// J/C/N/B in log space), and returns log-odds scores in nats.

#include "p7_viterbi.cuh"

namespace {

unsigned smem_set[kCaseSlots];  // devices whose kernel case allows kMaxSmem

template <int PER, int KT>
struct Case {
  static cudaError_t launch(const ViterbiArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, KT, false>(a, false, false, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_planned(viterbi_kernel<PER, KT, false, true, false>, a, device,
                          smem_set[case_slot(KT, PER)], groups, KT, grid, smem, stream);
  }

  static cudaError_t regs(int* out) {
    return kernel_regs(viterbi_kernel<PER, KT, false, true, false>, out);
  }
};

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128 or 256, or
// kMemThreads for the rows-in-memory case) and `per` name the kernel case,
// with threads * per >= m_pad; the chain runs `n_passes` passes, the first
// `n_chain` rows staged in shared memory with the first `n_trans`
// transition rows; `groups`, `grid` and `smem` are the launch plan
// (checked); `scratch` the rows-in-memory case's rows (null otherwise).
// Returns a cudaError_t.
extern "C" int p7_forward_log_launch(int device, int threads, int per, const void* msc,
                                     const void* isc, const void* trans, const void* chain,
                                     int m_pad, int n_passes, int n_chain, int n_trans,
                                     const void* tokens, int l_pad, const void* lengths,
                                     const void* tr_rows, const void* consts, const void* m_in,
                                     const void* i_in, const void* d_in, const void* s_in,
                                     void* scores, void* m_out, void* i_out, void* d_out,
                                     void* s_out, void* scratch, int b_pad, int groups, int grid,
                                     int smem, void* stream) {
  if (n_passes > 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ViterbiArgs a = make_args(msc, isc, trans, chain, m_pad, n_passes, n_passes, n_chain,
                                  n_trans, tokens, l_pad, lengths, tr_rows, consts, m_in, i_in,
                                  d_in, s_in, scores, m_out, i_out, d_out, s_out, nullptr, b_pad);
  auto* st = static_cast<cudaStream_t>(stream);
  if (threads == kMemThreads) {
    return static_cast<int>(
        launch_mem<false, true, false>(a, scratch, false, per, groups, grid, smem, st));
  }
  return static_cast<int>(with_case<Case>(threads, per, [&](auto c) {
    return decltype(c)::launch(a, device, groups, grid, smem, st);
  }));
}

// Registers a thread of the case uses, for the launch plan.
extern "C" int p7_forward_log_regs(int threads, int per, int* regs) {
  if (threads == kMemThreads) {
    return static_cast<int>(kernel_regs(viterbi_mem_kernel<false, true, false>, regs));
  }
  return static_cast<int>(
      with_case<Case>(threads, per, [&](auto c) { return decltype(c)::regs(regs); }));
}
