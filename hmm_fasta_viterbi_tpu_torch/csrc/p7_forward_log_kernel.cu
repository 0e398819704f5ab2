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
// J/C/N/B in log space), and returns log-odds scores in nats. Past 4864
// states it runs on the wide block (viterbi_block_kernel) up to
// kBlockThreads * kBlockPerMax states and on clusters of wide blocks
// (viterbi_block_cluster_kernel) past that.

#include "p7_viterbi.cuh"

namespace {

unsigned smem_set[kCaseSlots];       // devices whose kernel case allows kMaxSmem
unsigned pair_smem_set[kPairSlots];  // ... and whose pair case does

template <int PER, int KT>
struct Case {
  static cudaError_t launch(const ViterbiArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, KT, false>(a, false, false, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_planned(viterbi_kernel<PER, KT, false, true, false>, a, device,
                          smem_set[case_slot(PER)], groups, KT, grid, smem, stream);
  }

  static cudaError_t regs(int* out) {
    return kernel_regs(viterbi_kernel<PER, KT, false, true, false>, out);
  }
};

// The cluster pair's case: 2 * 128 * PER states, a block of the pair's
// clusters one half.
template <int PER>
struct PairCase {
  static cudaError_t launch(const ViterbiArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, 128, false, true>(a, false, false, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_cluster(viterbi_pair_kernel<PER, false, true, false>, a, device,
                          pair_smem_set[PER - 10], 2, grid, smem, stream);
  }

  static cudaError_t regs(int* out) {
    return kernel_regs(viterbi_pair_kernel<PER, false, true, false>, out);
  }

  static cudaError_t clusters(int device, int smem, int* out) {
    return cluster_max_clusters(viterbi_pair_kernel<PER, false, true, false>, device,
                                pair_smem_set[PER - 10], 2, smem, out);
  }
};

// The wide block's case: kBlockThreads * PER states, one block a sequence.
unsigned block_smem_set[kBlockSlots];  // devices whose wide block allows kMaxSmem

template <int PER>
struct BlockCase {
  static cudaError_t launch(const ViterbiArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    if (!viterbi_block_plan_ok<PER, kBlockThreads>(a, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_planned(viterbi_block_kernel<PER, kBlockThreads, true>, a, device,
                          block_smem_set[PER - kBlockPerMin], 1, kBlockThreads, grid, smem,
                          stream);
  }

  static cudaError_t regs(int* out) {
    return kernel_regs(viterbi_block_kernel<PER, kBlockThreads, true>, out);
  }
};

// The cluster of wide blocks' case: c * kBlockThreads * PER states, a block
// of the clusters one slice.
unsigned block_cluster_smem_set[kBlockClusterSlots];  // devices whose case allows kMaxSmem

template <int PER>
struct BlockClusterCase {
  using Kernel = void (*)(ViterbiArgs);
  static Kernel kernel() { return viterbi_block_cluster_kernel<PER, kBlockThreads, true>; }

  static cudaError_t launch(const ViterbiArgs& a, int device, int c, int groups, int grid,
                            int smem, cudaStream_t stream) {
    if (!viterbi_block_plan_ok<PER, kBlockThreads>(a, groups, grid, smem, c)) {
      return cudaErrorInvalidValue;
    }
    return launch_cluster(kernel(), a, device, block_cluster_smem_set[PER - kBlockClusterPerMin],
                          c, grid, smem, stream, kBlockThreads);
  }

  static cudaError_t regs(int* out) { return kernel_regs(kernel(), out); }

  static cudaError_t clusters(int device, int c, int smem, int* out) {
    return cluster_max_clusters(kernel(), device,
                                block_cluster_smem_set[PER - kBlockClusterPerMin], c, smem, out,
                                kBlockThreads);
  }
};

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128, or kMemThreads for
// the rows-in-memory case) and `per` name the kernel case, with threads *
// per >= m_pad, `cluster` 2 the cluster pair's (128 threads a block, per
// 10..19, 2 * threads * per >= m_pad), `cluster` 0 the wide block's
// (kBlockThreads threads, per kBlockPerMin..kBlockPerMax) and `cluster` C
// of 2..kMaxBlockCluster with kBlockThreads threads its cluster of wide
// blocks (per kBlockClusterPerMin..kBlockClusterPerMax); the
// chain runs `n_passes` passes, the first `n_chain` rows staged in shared
// memory with the first `n_trans` transition rows; `groups`, `grid` and
// `smem` are the launch plan (checked); `scratch` the rows-in-memory case's
// rows or the wide block's thread-major rows (a cluster of wide blocks': a
// slice a block), null otherwise. Returns a cudaError_t.
extern "C" int p7_forward_log_launch(int device, int threads, int per, int cluster,
                                     const void* msc, const void* isc, const void* trans, const void* chain,
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
  if (cluster == 0) {
    if (threads != kBlockThreads) return static_cast<int>(cudaErrorInvalidValue);
    ViterbiArgs b = a;
    b.tm = static_cast<const float*>(scratch);
    return static_cast<int>(with_block_case<BlockCase>(per, [&](auto c) {
      return decltype(c)::launch(b, device, groups, grid, smem, st);
    }));
  }
  if (threads == kBlockThreads && cluster >= 2) {
    ViterbiArgs b = a;
    b.tm = static_cast<const float*>(scratch);
    return static_cast<int>(with_block_cluster_case<BlockClusterCase>(per, [&](auto c) {
      return decltype(c)::launch(b, device, cluster, groups, grid, smem, st);
    }));
  }
  if (threads == kMemThreads) {
    if (cluster != 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch_mem<false, true, false>(a, scratch, false, per, groups, grid, smem, st));
  }
  if (threads != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 2) {
    return static_cast<int>(with_pair_case<PairCase>(per, [&](auto c) {
      return decltype(c)::launch(a, device, groups, grid, smem, st);
    }));
  }
  if (cluster != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_group_case<Case>(per, [&](auto c) {
    return decltype(c)::launch(a, device, groups, grid, smem, st);
  }));
}

// Registers a thread of the case uses (`cluster` 2: the pair's, 0: the wide
// block's, 2..kMaxBlockCluster at kBlockThreads threads: its cluster of wide
// blocks'), for the launch plan.
extern "C" int p7_forward_log_regs(int threads, int per, int cluster, int* regs) {
  if (cluster == 0) {
    if (threads != kBlockThreads) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        with_block_case<BlockCase>(per, [&](auto c) { return decltype(c)::regs(regs); }));
  }
  if (threads == kBlockThreads && cluster >= 2) {
    return static_cast<int>(with_block_cluster_case<BlockClusterCase>(
        per, [&](auto c) { return decltype(c)::regs(regs); }));
  }
  if (threads == kMemThreads) {
    return static_cast<int>(kernel_regs(viterbi_mem_kernel<false, true, false>, regs));
  }
  if (cluster == 2) {
    return static_cast<int>(
        with_pair_case<PairCase>(per, [&](auto c) { return decltype(c)::regs(regs); }));
  }
  return static_cast<int>(
      with_group_case<Case>(per, [&](auto c) { return decltype(c)::regs(regs); }));
}

// The most clusters of `cluster` blocks (2 at 128 threads: the pair's case
// `per`; 2..kMaxBlockCluster at kBlockThreads: the cluster of wide blocks')
// the card `device` runs at once with `smem` bytes of dynamic shared memory
// a block, for the launch plan. Returns a cudaError_t.
extern "C" int p7_forward_log_clusters(int device, int threads, int per, int cluster, int smem,
                                       int* clusters) {
  if (threads == kBlockThreads) {
    if (cluster < 2 || cluster > kMaxBlockCluster) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(with_block_cluster_case<BlockClusterCase>(per, [&](auto c) {
      return decltype(c)::clusters(device, cluster, smem, clusters);
    }));
  }
  if (threads != 128 || cluster != 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_pair_case<PairCase>(
      per, [&](auto c) { return decltype(c)::clusters(device, smem, clusters); }));
}
