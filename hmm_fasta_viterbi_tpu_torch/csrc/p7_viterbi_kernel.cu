// Full local Viterbi scan (eager and lazy), written by hand for Hopper
// (sm_90a): the Viterbi cases of the kernel template in p7_viterbi.cuh,
// whose header comment gives the recurrence, the bound and the design.
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_p7.py::_p7_kernel in Viterbi
// mode (the eager kernel) and ::_p7_lazy_kernel (the lazy one), both
// launched by p7_pallas_call. Scores equal the JAX kernels' and the plain
// PyTorch version's bit for bit. Past 4864 states the lazy kernel runs on
// C-block clusters (viterbi_cluster_kernel) up to 32,768 states and on
// clusters of wide blocks (viterbi_block_cluster_kernel, its whole-chain
// step) past that, the eager one on the wide block (viterbi_block_kernel) up
// to kBlockThreads * kBlockPerMax states and on clusters of wide blocks past
// that.

#include "p7_viterbi.cuh"

namespace {

unsigned smem_set[2][kCaseSlots];       // devices whose kernel case allows kMaxSmem
unsigned pair_smem_set[2][kPairSlots];  // ... and whose pair case does

template <int PER, int KT>
struct Case {
  static cudaError_t launch(bool lazy, const ViterbiArgs& a, int device, int groups, int grid,
                            int smem, cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, KT, false>(a, lazy, lazy, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    unsigned& done = smem_set[lazy][case_slot(PER)];
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

// The cluster pair's case: 2 * 128 * PER states, a block of the pair's
// clusters one half.
template <int PER>
struct PairCase {
  using Kernel = void (*)(ViterbiArgs);
  static Kernel kernel(bool lazy) {
    return lazy ? viterbi_pair_kernel<PER, true, false, false>
                : viterbi_pair_kernel<PER, false, false, false>;
  }

  static cudaError_t launch(bool lazy, const ViterbiArgs& a, int device, int groups, int grid,
                            int smem, cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, 128, false, true>(a, lazy, lazy, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_cluster(kernel(lazy), a, device, pair_smem_set[lazy][PER - 10], 2, grid,
                          smem, stream);
  }

  static cudaError_t regs(bool lazy, int* out) { return kernel_regs(kernel(lazy), out); }

  static cudaError_t clusters(bool lazy, int device, int smem, int* out) {
    return cluster_max_clusters(kernel(lazy), device, pair_smem_set[lazy][PER - 10], 2, smem,
                                out);
  }
};

// The C-block cluster's case (the lazy kernel past 4864 states): c * 128 *
// PER states, a block of the clusters one slice.
unsigned cluster_smem_set[kClusterSlots];  // devices whose cluster case allows kMaxSmem

template <int PER>
struct ClusterCase {
  using Kernel = void (*)(ViterbiArgs);
  static Kernel kernel() { return viterbi_cluster_kernel<PER, true, false, false>; }

  static cudaError_t launch(const ViterbiArgs& a, int device, int c, int groups, int grid,
                            int smem, cudaStream_t stream) {
    if (!viterbi_cluster_plan_ok<PER, false>(a, true, c, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_cluster(kernel(), a, device, cluster_smem_set[PER - 13], c, grid, smem, stream);
  }

  static cudaError_t regs(int* out) { return kernel_regs(kernel(), out); }

  static cudaError_t clusters(int device, int c, int smem, int* out) {
    return cluster_max_clusters(kernel(), device, cluster_smem_set[PER - 13], c, smem, out);
  }
};

// The wide block's case (the eager kernel past 4864 states): kBlockThreads
// * PER states, one block a sequence.
unsigned block_smem_set[kBlockSlots];  // devices whose wide block allows kMaxSmem

template <int PER>
struct BlockCase {
  static cudaError_t launch(const ViterbiArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    if (!viterbi_block_plan_ok<PER, kBlockThreads>(a, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_planned(viterbi_block_kernel<PER, kBlockThreads, false>, a, device,
                          block_smem_set[PER - kBlockPerMin], 1, kBlockThreads, grid, smem,
                          stream);
  }

  static cudaError_t regs(int* out) {
    return kernel_regs(viterbi_block_kernel<PER, kBlockThreads, false>, out);
  }
};

// The cluster of wide blocks' case (the eager kernel past kBlockThreads *
// kBlockPerMax states, the lazy one past 32,768 with the whole chain, k_run
// == n_passes): c * kBlockThreads * PER states, a block of the clusters one
// slice.
unsigned block_cluster_smem_set[2][kBlockClusterSlots];  // devices whose case allows kMaxSmem

template <int PER>
struct BlockClusterCase {
  using Kernel = void (*)(ViterbiArgs);
  static Kernel kernel(bool lazy) {
    return lazy ? viterbi_block_cluster_kernel<PER, kBlockThreads, false, true>
                : viterbi_block_cluster_kernel<PER, kBlockThreads, false>;
  }

  static cudaError_t launch(bool lazy, const ViterbiArgs& a, int device, int c, int groups,
                            int grid, int smem, cudaStream_t stream) {
    if (!viterbi_block_plan_ok<PER, kBlockThreads>(a, groups, grid, smem, c)) {
      return cudaErrorInvalidValue;
    }
    return launch_cluster(kernel(lazy), a, device,
                          block_cluster_smem_set[lazy][PER - kBlockClusterPerMin], c, grid, smem,
                          stream, kBlockThreads);
  }

  static cudaError_t regs(bool lazy, int* out) { return kernel_regs(kernel(lazy), out); }

  static cudaError_t clusters(bool lazy, int device, int c, int smem, int* out) {
    return cluster_max_clusters(kernel(lazy), device,
                                block_cluster_smem_set[lazy][PER - kBlockClusterPerMin], c, smem,
                                out, kBlockThreads);
  }
};

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128, or kMemThreads for
// the rows-in-memory case) and `per` name the kernel case, with threads *
// per >= m_pad, and `cluster` 2 the cluster pair's (128 threads a block,
// per 10..19, 2 * threads * per >= m_pad), `cluster` C of 3..16 the lazy
// kernel's C-block cluster (per 13..19, C * threads * per >= m_pad, up to
// 16 passes), `cluster` 0 the eager kernel's wide block (kBlockThreads
// threads, per kBlockPerMin..kBlockPerMax), `cluster` C of
// 2..kMaxBlockCluster with kBlockThreads threads its cluster of wide blocks
// (per kBlockClusterPerMin..kBlockClusterPerMax, C * threads * per >=
// m_pad; the lazy kernel's too, with k_run == n_passes, refused otherwise);
// `lazy` selects the lazy kernel, which runs
// `k_run` passes under the certificate (k_run == n_passes: the full chain,
// no certificate). `n_trans` transition rows and `n_chain` chain rows are
// staged in shared memory; `groups` sequences a block, `grid` blocks and
// `smem` bytes of dynamic shared memory are the launch plan of
// ops/p7_cuda.py::plan_launch (checked here); `scratch` holds the
// rows-in-memory case's [grid, kMemRows, m_pad] rows or the wide block's
// thread-major rows, [6 + n_passes, per, kBlockThreads] (a cluster of wide
// blocks': C such slices, block r's at r * (6 + n_passes) * per *
// kBlockThreads), null otherwise. Returns a cudaError_t.
extern "C" int p7_viterbi_launch(int device, int threads, int per, int cluster, int lazy,
                                 const void* msc, const void* isc, const void* trans, const void* chain,
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
  if (cluster == 0) {
    if (lazy || threads != kBlockThreads) return static_cast<int>(cudaErrorInvalidValue);
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
      return decltype(c)::launch(lazy != 0, b, device, cluster, groups, grid, smem, st);
    }));
  }
  if (threads == kMemThreads) {
    if (cluster != 1) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        lazy ? launch_mem<true, false, false>(a, scratch, true, per, groups, grid, smem, st)
             : launch_mem<false, false, false>(a, scratch, false, per, groups, grid, smem, st));
  }
  if (threads != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster >= 3) {
    if (!lazy) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(with_cluster_case<ClusterCase>(per, [&](auto c) {
      return decltype(c)::launch(a, device, cluster, groups, grid, smem, st);
    }));
  }
  if (n_passes > 15) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 2) {
    return static_cast<int>(with_pair_case<PairCase>(per, [&](auto c) {
      return decltype(c)::launch(lazy != 0, a, device, groups, grid, smem, st);
    }));
  }
  if (cluster != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_group_case<Case>(per, [&](auto c) {
    return decltype(c)::launch(lazy != 0, a, device, groups, grid, smem, st);
  }));
}

// Registers a thread of the case uses (`lazy`: the lazy kernel; `cluster`
// 2: the pair's, 3..16: the lazy kernel's C-block cluster's, 0: the eager
// kernel's wide block, 2..kMaxBlockCluster at kBlockThreads threads: the
// eager or lazy kernel's cluster of wide blocks), for the launch plan.
// Returns a cudaError_t.
extern "C" int p7_viterbi_regs(int threads, int per, int cluster, int lazy, int* regs) {
  if (cluster == 0) {
    if (lazy || threads != kBlockThreads) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        with_block_case<BlockCase>(per, [&](auto c) { return decltype(c)::regs(regs); }));
  }
  if (threads == kBlockThreads && cluster >= 2) {
    return static_cast<int>(with_block_cluster_case<BlockClusterCase>(
        per, [&](auto c) { return decltype(c)::regs(lazy != 0, regs); }));
  }
  if (threads == kMemThreads) {
    return static_cast<int>(lazy ? kernel_regs(viterbi_mem_kernel<true, false, false>, regs)
                                 : kernel_regs(viterbi_mem_kernel<false, false, false>, regs));
  }
  if (cluster >= 3) {
    if (!lazy) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        with_cluster_case<ClusterCase>(per, [&](auto c) { return decltype(c)::regs(regs); }));
  }
  if (cluster == 2) {
    return static_cast<int>(
        with_pair_case<PairCase>(per, [&](auto c) { return decltype(c)::regs(lazy != 0, regs); }));
  }
  return static_cast<int>(with_group_case<Case>(
      per, [&](auto c) { return decltype(c)::regs(lazy != 0, regs); }));
}

// The most clusters of `cluster` blocks (2: the pair's case of `per`,
// `lazy`; 3..16: the lazy kernel's C-block cluster; at `threads`
// kBlockThreads, 2..kMaxBlockCluster: the eager or lazy kernel's cluster of
// wide blocks) the card `device` runs at once with `smem` bytes of dynamic
// shared memory a block, for the launch plan. Returns a cudaError_t.
extern "C" int p7_viterbi_clusters(int device, int threads, int per, int cluster, int lazy,
                                   int smem, int* clusters) {
  if (threads == kBlockThreads) {
    if (cluster < 2 || cluster > kMaxBlockCluster) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(with_block_cluster_case<BlockClusterCase>(per, [&](auto c) {
      return decltype(c)::clusters(lazy != 0, device, cluster, smem, clusters);
    }));
  }
  if (threads != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster >= 3) {
    if (!lazy || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(with_cluster_case<ClusterCase>(per, [&](auto c) {
      return decltype(c)::clusters(device, cluster, smem, clusters);
    }));
  }
  if (cluster != 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_pair_case<PairCase>(per, [&](auto c) {
    return decltype(c)::clusters(lazy != 0, device, smem, clusters);
  }));
}
