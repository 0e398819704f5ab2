// Full local Viterbi scan (eager and lazy), written by hand for Hopper
// (sm_90a): the Viterbi cases of the kernel template in p7_viterbi.cuh,
// whose header comment gives the recurrence, the bound and the design.
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_p7.py::_p7_kernel in Viterbi
// mode (the eager kernel) and ::_p7_lazy_kernel (the lazy one), both
// launched by p7_pallas_call. Scores equal the JAX kernels' and the plain
// PyTorch version's bit for bit.

#include "p7_viterbi.cuh"

namespace {

template <int PER>
cudaError_t launch(bool lazy, const ViterbiArgs& a, cudaStream_t stream) {
  if (lazy) {
    viterbi_kernel<PER, true, false><<<a.b_pad, kThreads, 0, stream>>>(a);
  } else {
    viterbi_kernel<PER, false, false><<<a.b_pad, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. `per` is the number of states a
// thread holds, one of the cases below, with 128 * per >= m_pad; `lazy`
// selects the lazy kernel, which runs `k_run` passes under the certificate
// (k_run >= n_passes: the full chain, no certificate). Returns a
// cudaError_t.
extern "C" int p7_viterbi_launch(int device, int per, int lazy, const void* msc,
                                 const void* isc, const void* trans, const void* chain,
                                 int m_pad, int n_passes, int k_run, const void* tokens,
                                 int l_pad, const void* lengths, const void* tr_rows,
                                 const void* consts, const void* m_in, const void* i_in,
                                 const void* d_in, const void* s_in, void* scores,
                                 void* m_out, void* i_out, void* d_out, void* s_out,
                                 void* replays, int b_pad, void* stream) {
  if (m_pad < 1 || m_pad > kThreads * per || n_passes < 1 || n_passes > 15 || k_run < 1 ||
      b_pad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ViterbiArgs a = make_args(msc, isc, trans, chain, m_pad, n_passes, k_run, tokens, l_pad,
                                  lengths, tr_rows, consts, m_in, i_in, d_in, s_in, scores,
                                  m_out, i_out, d_out, s_out, replays, b_pad);
  auto* st = static_cast<cudaStream_t>(stream);
#define P7_CASE(P) \
  case P:          \
    return static_cast<int>(launch<P>(lazy != 0, a, st));
  switch (per) {
    P7_CASE(1)
    P7_CASE(2)
    P7_CASE(3)
    P7_CASE(4)
    P7_CASE(5)
    P7_CASE(6)
    P7_CASE(7)
    P7_CASE(8)
    P7_CASE(9)
    P7_CASE(10)
    P7_CASE(11)
    P7_CASE(12)
    P7_CASE(13)
    P7_CASE(14)
    P7_CASE(15)
    P7_CASE(16)
    P7_CASE(17)
    P7_CASE(18)
    P7_CASE(19)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef P7_CASE
}
