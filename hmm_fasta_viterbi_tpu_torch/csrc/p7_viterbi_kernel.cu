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

unsigned smem_set[2][20];  // devices whose kernel case allows kMaxSmem

template <int PER>
struct Case {
  static cudaError_t launch(bool lazy, const ViterbiArgs& a, int device, int groups, int grid,
                            int smem, cudaStream_t stream) {
    if (!viterbi_plan_ok<PER>(a, lazy, groups, grid, smem)) return cudaErrorInvalidValue;
    cudaError_t err;
    if (lazy) {
      err = allow_smem(viterbi_kernel<PER, true, false>, device, smem_set[1][PER]);
      if (err != cudaSuccess) return err;
      viterbi_kernel<PER, true, false><<<grid, groups * kThreads, smem, stream>>>(a);
    } else {
      err = allow_smem(viterbi_kernel<PER, false, false>, device, smem_set[0][PER]);
      if (err != cudaSuccess) return err;
      viterbi_kernel<PER, false, false><<<grid, groups * kThreads, smem, stream>>>(a);
    }
    return cudaGetLastError();
  }

  static cudaError_t regs(bool lazy, int* out) {
    cudaFuncAttributes attr;
    const cudaError_t err = lazy ? cudaFuncGetAttributes(&attr, viterbi_kernel<PER, true, false>)
                                 : cudaFuncGetAttributes(&attr, viterbi_kernel<PER, false, false>);
    *out = attr.numRegs;
    return err;
  }
};

// Calls Case<per>::fn(args...).
#define P7_CASE(P) \
  case P:          \
    return fn(Case<P>{});

template <typename Fn>
cudaError_t with_per(int per, Fn fn) {
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
      return cudaErrorInvalidValue;
  }
}
#undef P7_CASE

}  // namespace

// Plain C entry point, bound with ctypes. `per` is the number of states a
// thread holds, one of the cases above, with 128 * per >= m_pad; `lazy`
// selects the lazy kernel, which runs `k_run` passes under the certificate
// (k_run == n_passes: the full chain, no certificate). `n_chain` chain
// rows are staged in shared memory; `groups` sequences a block, `grid`
// blocks and `smem` bytes of dynamic shared memory are the launch plan of
// ops/p7_cuda.py::plan_launch (checked here). Returns a cudaError_t.
extern "C" int p7_viterbi_launch(int device, int per, int lazy, const void* msc,
                                 const void* isc, const void* trans, const void* chain,
                                 int m_pad, int n_passes, int k_run, int n_chain,
                                 const void* tokens, int l_pad, const void* lengths,
                                 const void* tr_rows, const void* consts, const void* m_in,
                                 const void* i_in, const void* d_in, const void* s_in,
                                 void* scores, void* m_out, void* i_out, void* d_out,
                                 void* s_out, void* replays, int b_pad, int groups, int grid,
                                 int smem, void* stream) {
  if (n_passes > 15) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ViterbiArgs a = make_args(msc, isc, trans, chain, m_pad, n_passes, k_run, n_chain,
                                  tokens, l_pad, lengths, tr_rows, consts, m_in, i_in, d_in,
                                  s_in, scores, m_out, i_out, d_out, s_out, replays, b_pad);
  auto* st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_per(per, [&](auto c) {
    return decltype(c)::launch(lazy != 0, a, device, groups, grid, smem, st);
  }));
}

// Registers a thread of the `per` case uses (`lazy`: the lazy kernel), for
// the launch plan. Returns a cudaError_t.
extern "C" int p7_viterbi_regs(int per, int lazy, int* regs) {
  return static_cast<int>(
      with_per(per, [&](auto c) { return decltype(c)::regs(lazy != 0, regs); }));
}
