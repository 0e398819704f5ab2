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

unsigned smem_set[2][kCaseSlots];  // devices whose kernel case allows kMaxSmem

template <int PER, int KT>
struct Case {
  static cudaError_t launch(bool lazy, const ViterbiArgs& a, int device, int groups, int grid,
                            int smem, cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, KT, false>(a, lazy, lazy, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    unsigned& done = smem_set[lazy][case_slot(KT, PER)];
    return lazy ? launch_planned(viterbi_kernel<PER, KT, true, false, false>, a, device, done,
                                 groups, KT, grid, smem, stream)
                : launch_planned(viterbi_kernel<PER, KT, false, false, false>, a, device, done,
                                 groups, KT, grid, smem, stream);
  }

  static cudaError_t regs(bool lazy, int* out) {
    return lazy ? kernel_regs(viterbi_kernel<PER, KT, true, false, false>, out)
                : kernel_regs(viterbi_kernel<PER, KT, false, false, false>, out);
  }
};

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128 or 256, or
// kMemThreads for the rows-in-memory case) and `per` name the kernel case,
// with threads * per >= m_pad; `lazy` selects the lazy kernel, which runs
// `k_run` passes under the certificate (k_run == n_passes: the full chain,
// no certificate). `n_trans` transition rows and `n_chain` chain rows are
// staged in shared memory; `groups` sequences a block, `grid` blocks and
// `smem` bytes of dynamic shared memory are the launch plan of
// ops/p7_cuda.py::plan_launch (checked here); `scratch` holds the
// rows-in-memory case's [grid, kMemRows, m_pad] rows (null otherwise).
// Returns a cudaError_t.
extern "C" int p7_viterbi_launch(int device, int threads, int per, int lazy, const void* msc,
                                 const void* isc, const void* trans, const void* chain,
                                 int m_pad, int n_passes, int k_run, int n_chain, int n_trans,
                                 const void* tokens, int l_pad, const void* lengths,
                                 const void* tr_rows, const void* consts, const void* m_in,
                                 const void* i_in, const void* d_in, const void* s_in,
                                 void* scores, void* m_out, void* i_out, void* d_out,
                                 void* s_out, void* replays, void* scratch, int b_pad,
                                 int groups, int grid, int smem, void* stream) {
  if (n_passes > 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ViterbiArgs a = make_args(msc, isc, trans, chain, m_pad, n_passes, k_run, n_chain,
                                  n_trans, tokens, l_pad, lengths, tr_rows, consts, m_in, i_in,
                                  d_in, s_in, scores, m_out, i_out, d_out, s_out, replays, b_pad);
  auto* st = static_cast<cudaStream_t>(stream);
  if (threads == kMemThreads) {
    return static_cast<int>(
        lazy ? launch_mem<true, false, false>(a, scratch, true, per, groups, grid, smem, st)
             : launch_mem<false, false, false>(a, scratch, false, per, groups, grid, smem, st));
  }
  if (n_passes > 15) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_case<Case>(threads, per, [&](auto c) {
    return decltype(c)::launch(lazy != 0, a, device, groups, grid, smem, st);
  }));
}

// Registers a thread of the case uses (`lazy`: the lazy kernel), for the
// launch plan. Returns a cudaError_t.
extern "C" int p7_viterbi_regs(int threads, int per, int lazy, int* regs) {
  if (threads == kMemThreads) {
    return static_cast<int>(lazy ? kernel_regs(viterbi_mem_kernel<true, false, false>, regs)
                                 : kernel_regs(viterbi_mem_kernel<false, false, false>, regs));
  }
  return static_cast<int>(with_case<Case>(
      threads, per, [&](auto c) { return decltype(c)::regs(lazy != 0, regs); }));
}
