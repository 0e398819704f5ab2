// Upper-bound Viterbi filter scan, written by hand for Hopper (sm_90a): the
// filter case of the kernel template in p7_viterbi.cuh (bf16 emission rows,
// a chain of `window` passes, the tail term, E by e_skip_d), whose header
// comment gives the recurrence, the bound and the design. It is compiled
// from its own source so that it builds beside the other cases.
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_p7.py::_p7_filter_kernel, as
// launched by _p7_filter_padded (HMMER ViterbiFilter's role in the --fast
// cascade). Scores equal the JAX kernel's and the plain PyTorch version's
// (ops/p7_cuda.py::viterbi_filter_scan_plain) bit for bit, and bound the
// exact Viterbi scores from above.

#include "p7_viterbi.cuh"

namespace {

unsigned smem_set[kCaseSlots];  // devices whose kernel case allows kMaxSmem

template <int PER, int KT>
struct Case {
  static cudaError_t launch(const ViterbiArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, KT, true>(a, false, true, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_planned(viterbi_kernel<PER, KT, false, false, true>, a, device,
                          smem_set[case_slot(KT, PER)], groups, KT, grid, smem, stream);
  }

  static cudaError_t regs(int* out) {
    return kernel_regs(viterbi_kernel<PER, KT, false, false, true>, out);
  }
};

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128 or 256, or
// kMemThreads for the rows-in-memory case) and `per` name the kernel case,
// with threads * per >= m_pad; msc/isc are the bf16
// round-up tables [20, m_pad]; `full_passes` = ceil(log2 m_pad) and 1 <=
// window <= full_passes; a tail term (consts[3]) is applied when window <
// full_passes; `e_skip_d` takes E over M alone. `n_chain` of the window's
// chain rows and `n_trans` transition rows are staged; `groups`, `grid` and
// `smem` are the launch plan of ops/p7_cuda.py::plan_launch (checked);
// `scratch` the rows-in-memory case's rows (null otherwise). Returns a
// cudaError_t.
extern "C" int p7_filter_launch(int device, int threads, int per, const void* msc,
                                const void* isc, const void* trans, const void* chain,
                                int m_pad, int full_passes, int window, int n_chain,
                                int n_trans, int e_skip_d, const void* tokens, int l_pad,
                                const void* lengths, const void* tr_rows, const void* consts,
                                const void* m_in, const void* i_in, const void* d_in,
                                const void* s_in, void* scores, void* m_out, void* i_out,
                                void* d_out, void* s_out, void* scratch, int b_pad, int groups,
                                int grid, int smem, void* stream) {
  if (full_passes > 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ViterbiArgs a = make_args(msc, isc, trans, chain, m_pad, full_passes, window, n_chain, n_trans,
                            tokens, l_pad, lengths, tr_rows, consts, m_in, i_in, d_in, s_in,
                            scores, m_out, i_out, d_out, s_out, nullptr, b_pad);
  a.e_skip_d = e_skip_d;
  auto* st = static_cast<cudaStream_t>(stream);
  if (threads == kMemThreads) {
    return static_cast<int>(
        launch_mem<false, false, true>(a, scratch, true, per, groups, grid, smem, st));
  }
  return static_cast<int>(with_case<Case>(threads, per, [&](auto c) {
    return decltype(c)::launch(a, device, groups, grid, smem, st);
  }));
}

// Registers a thread of the case uses, for the launch plan.
extern "C" int p7_filter_regs(int threads, int per, int* regs) {
  if (threads == kMemThreads) {
    return static_cast<int>(kernel_regs(viterbi_mem_kernel<false, false, true>, regs));
  }
  return static_cast<int>(
      with_case<Case>(threads, per, [&](auto c) { return decltype(c)::regs(regs); }));
}
