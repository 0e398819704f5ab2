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
// exact Viterbi scores from above. Past 4864 states it runs on C-block
// clusters (viterbi_cluster_kernel), past 38,912 on C-block clusters of
// 256-thread blocks (viterbi_wide_cluster_kernel).

#include "p7_viterbi.cuh"

namespace {

unsigned smem_set[kCaseSlots];       // devices whose kernel case allows kMaxSmem
unsigned pair_smem_set[kPairSlots];  // ... and whose pair case does

template <int PER, int KT>
struct Case {
  static cudaError_t launch(const ViterbiArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, KT, true>(a, false, true, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_planned(viterbi_kernel<PER, KT, false, false, true>, a, device,
                          smem_set[case_slot(PER)], groups, KT, grid, smem, stream);
  }

  static cudaError_t regs(int* out) {
    return kernel_regs(viterbi_kernel<PER, KT, false, false, true>, out);
  }
};

// The cluster pair's case: 2 * 128 * PER states, a block of the pair's
// clusters one half.
template <int PER>
struct PairCase {
  static cudaError_t launch(const ViterbiArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    if (!viterbi_plan_ok<PER, 128, true, true>(a, false, true, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_cluster(viterbi_pair_kernel<PER, false, false, true>, a, device,
                          pair_smem_set[PER - 10], 2, grid, smem, stream);
  }

  static cudaError_t regs(int* out) {
    return kernel_regs(viterbi_pair_kernel<PER, false, false, true>, out);
  }

  static cudaError_t clusters(int device, int smem, int* out) {
    return cluster_max_clusters(viterbi_pair_kernel<PER, false, false, true>, device,
                                pair_smem_set[PER - 10], 2, smem, out);
  }
};

// The C-block cluster's case (past 4864 states): c * 128 * PER states, a
// block of the clusters one slice.
unsigned cluster_smem_set[kClusterSlots];  // devices whose cluster case allows kMaxSmem

template <int PER>
struct ClusterCase {
  using Kernel = void (*)(ViterbiArgs);
  static Kernel kernel() { return viterbi_cluster_kernel<PER, false, false, true>; }

  static cudaError_t launch(const ViterbiArgs& a, int device, int c, int groups, int grid,
                            int smem, cudaStream_t stream) {
    if (!viterbi_cluster_plan_ok<PER, true>(a, false, c, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_cluster(kernel(), a, device, cluster_smem_set[PER - 13], c, grid, smem, stream);
  }

  static cudaError_t regs(int* out) { return kernel_regs(kernel(), out); }

  static cudaError_t clusters(int device, int c, int smem, int* out) {
    return cluster_max_clusters(kernel(), device, cluster_smem_set[PER - 13], c, smem, out);
  }
};

// The C-block cluster of 256-thread blocks' case (past 38,912 states): c *
// 256 * PER states, a block of the clusters one slice, the staged rows the
// plan names, the rest read from the thread-major rows (ViterbiArgs::tm).
unsigned wide_cluster_smem_set[kWideClusterSlots];  // devices whose case allows kMaxSmem

template <int PER>
struct WideClusterCase {
  using Kernel = void (*)(ViterbiArgs);
  static Kernel kernel() { return viterbi_wide_cluster_kernel<PER>; }

  static cudaError_t launch(const ViterbiArgs& a, int device, int c, int groups, int grid,
                            int smem, cudaStream_t stream) {
    if (!viterbi_wide_cluster_plan_ok<PER>(a, c, groups, grid, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_cluster(kernel(), a, device, wide_cluster_smem_set[PER - kWideClusterPerMin],
                          c, grid, smem, stream, kWideClusterThreads);
  }

  static cudaError_t regs(int* out) { return kernel_regs(kernel(), out); }

  static cudaError_t clusters(int device, int c, int smem, int* out) {
    return cluster_max_clusters(kernel(), device,
                                wide_cluster_smem_set[PER - kWideClusterPerMin], c, smem, out,
                                kWideClusterThreads);
  }
};

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128, or kMemThreads for
// the rows-in-memory case) and `per` name the kernel case, with threads *
// per >= m_pad, and `cluster` 2 the cluster pair's (128 threads a block, per
// 10..19, 2 * threads * per >= m_pad), `cluster` C of 3..16 the C-block
// cluster's (per 13..19, C * threads * per >= m_pad), and `threads`
// kWideClusterThreads with `cluster` C the C-block cluster of 256-thread
// blocks (per 17..19; `scratch` its thread-major rows,
// ops/p7_cuda.py::block_rows at 256 threads, fill -inf); msc/isc are the bf16
// round-up tables [20, m_pad]; `full_passes` = ceil(log2 m_pad) and 1 <=
// window <= full_passes; a tail term (consts[3]) is applied when window <
// full_passes; `e_skip_d` takes E over M alone. `n_chain` of the window's
// chain rows and `n_trans` transition rows are staged; `groups`, `grid` and
// `smem` are the launch plan of ops/p7_cuda.py::plan_launch (checked);
// `scratch` the rows-in-memory case's rows (null otherwise). Returns a
// cudaError_t.
extern "C" int p7_filter_launch(int device, int threads, int per, int cluster,
                                const void* msc, const void* isc, const void* trans, const void* chain,
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
  if (threads == kWideClusterThreads) {
    a.tm = static_cast<const float*>(scratch);
    return static_cast<int>(with_wide_cluster_case<WideClusterCase>(per, [&](auto c) {
      return decltype(c)::launch(a, device, cluster, groups, grid, smem, st);
    }));
  }
  if (threads != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster >= 3) {
    return static_cast<int>(with_cluster_case<ClusterCase>(per, [&](auto c) {
      return decltype(c)::launch(a, device, cluster, groups, grid, smem, st);
    }));
  }
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

// Registers a thread of the case uses, for the launch plan.
extern "C" int p7_filter_regs(int threads, int per, int cluster, int* regs) {
  if (threads == kMemThreads) {
    return static_cast<int>(kernel_regs(viterbi_mem_kernel<false, false, true>, regs));
  }
  if (threads == kWideClusterThreads) {
    return static_cast<int>(with_wide_cluster_case<WideClusterCase>(
        per, [&](auto c) { return decltype(c)::regs(regs); }));
  }
  if (cluster >= 3) {
    return static_cast<int>(
        with_cluster_case<ClusterCase>(per, [&](auto c) { return decltype(c)::regs(regs); }));
  }
  if (cluster == 2) {
    return static_cast<int>(
        with_pair_case<PairCase>(per, [&](auto c) { return decltype(c)::regs(regs); }));
  }
  return static_cast<int>(
      with_group_case<Case>(per, [&](auto c) { return decltype(c)::regs(regs); }));
}

// The most clusters of `cluster` blocks (2: the pair's case `per`; 3..16:
// the C-block cluster's; at `threads` kWideClusterThreads, 2..16: the
// cluster of 256-thread blocks') the card `device` runs at once with `smem`
// bytes of dynamic shared memory a block, for the launch plan. Returns a
// cudaError_t.
extern "C" int p7_filter_clusters(int device, int threads, int per, int cluster, int smem,
                                  int* clusters) {
  if (threads == kWideClusterThreads) {
    if (cluster < 2 || cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(with_wide_cluster_case<WideClusterCase>(per, [&](auto c) {
      return decltype(c)::clusters(device, cluster, smem, clusters);
    }));
  }
  if (threads != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster >= 3) {
    if (cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(with_cluster_case<ClusterCase>(per, [&](auto c) {
      return decltype(c)::clusters(device, cluster, smem, clusters);
    }));
  }
  if (cluster != 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_pair_case<PairCase>(
      per, [&](auto c) { return decltype(c)::clusters(device, smem, clusters); }));
}
