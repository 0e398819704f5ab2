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

template <int PER>
cudaError_t launch(const ViterbiArgs& a, cudaStream_t stream) {
  viterbi_kernel<PER, false, true><<<a.b_pad, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. `per` is the number of states a
// thread holds, one of the cases below, with 128 * per >= m_pad; the chain
// runs `n_passes` passes. Returns a cudaError_t.
extern "C" int p7_forward_log_launch(int device, int per, const void* msc, const void* isc,
                                     const void* trans, const void* chain, int m_pad,
                                     int n_passes, const void* tokens, int l_pad,
                                     const void* lengths, const void* tr_rows,
                                     const void* consts, const void* m_in, const void* i_in,
                                     const void* d_in, const void* s_in, void* scores,
                                     void* m_out, void* i_out, void* d_out, void* s_out,
                                     int b_pad, void* stream) {
  if (m_pad < 1 || m_pad > kThreads * per || n_passes < 1 || n_passes > 16 || b_pad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ViterbiArgs a = make_args(msc, isc, trans, chain, m_pad, n_passes, n_passes, tokens,
                                  l_pad, lengths, tr_rows, consts, m_in, i_in, d_in, s_in,
                                  scores, m_out, i_out, d_out, s_out, nullptr, b_pad);
  auto* st = static_cast<cudaStream_t>(stream);
#define LOG_CASE(P) \
  case P:           \
    return static_cast<int>(launch<P>(a, st));
  switch (per) {
    LOG_CASE(1)
    LOG_CASE(2)
    LOG_CASE(3)
    LOG_CASE(4)
    LOG_CASE(5)
    LOG_CASE(6)
    LOG_CASE(7)
    LOG_CASE(8)
    LOG_CASE(9)
    LOG_CASE(10)
    LOG_CASE(11)
    LOG_CASE(12)
    LOG_CASE(13)
    LOG_CASE(14)
    LOG_CASE(15)
    LOG_CASE(16)
    LOG_CASE(17)
    LOG_CASE(18)
    LOG_CASE(19)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LOG_CASE
}
