// The blocked state layout and the per-group primitives shared by the p7
// Viterbi / log-space Forward template (p7_viterbi.cuh) and the
// probability-space Forward kernel (p7_forward_kernel.cu).
//
// A block holds G groups of kThreads = 128 threads (G = blockDim.x / 128,
// at most kMaxGroups); each group follows one sequence at a time and walks
// the batch with a stride of gridDim.x * G. Thread t of a group owns the
// contiguous states j = t * PER + k, k < PER, in registers. A row kept in
// shared memory puts state j at sidx(j): thread t's slots at t * SP + k,
// with the per-thread stride SP = PER rounded up to odd, so that 32
// neighbouring threads reading their slot k touch 32 different banks (for
// odd PER, sidx(j) = j).
//
// Each group synchronises on its own named barrier (bar.sync 1 + g, 128),
// so groups never wait on each other; __syncthreads is used only while the
// block stages its step-invariant rows, before the groups part.
//
// Dynamic shared memory, in floats, with ROW = 128 * SP:
//   [n_rows rows of ROW]       the staged constant rows, shared by the groups
//   then per group:
//   [2 rows]                   the shift buffers (alternating)
//   [4 rows]                   the emission rows of two steps: (match,
//                              insert) for even and for odd steps
//   [kRed]                     the reduction scratch (two reductions of 4)
//   [kChunk / 4]               the tokens of the current chunk (int8)
//   [1 row, SAVE only]         two bf16 rows of the row-saving Forward
// Every part is a multiple of 16 bytes. ops/p7_cuda.py::blocked_smem_bytes
// computes the same size; the launchers check it.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;     // residues per token load (and lazy certificate)
constexpr int kMaxGroups = 8;   // 1024 threads; named barriers 1..8
constexpr int kRed = 2 * kWarps;
constexpr int kMaxSmem = 232448;  // bytes a block may use on the H100
constexpr int kMaxDevices = 32;

template <int PER>
__host__ __device__ constexpr int stride() {
  return PER | 1;
}

template <int PER>
__host__ __device__ constexpr int row_floats() {
  return kThreads * stride<PER>();
}

// Floats of dynamic shared memory for n_rows staged rows and `groups` groups.
template <int PER>
__host__ __device__ constexpr size_t smem_floats(int n_rows, int groups, bool save) {
  return static_cast<size_t>(n_rows) * row_floats<PER>() +
         static_cast<size_t>(groups) *
             (6 * row_floats<PER>() + kRed + kChunk / 4 + (save ? row_floats<PER>() : 0));
}

// Shared-memory index of state j.
template <int PER>
__device__ __forceinline__ int sidx(int j) {
  return (PER & 1) ? j : j + j / PER;
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Residue x of a token chunk as a table row: a pad token never indexes it.
__device__ __forceinline__ int token(const int8_t* toks, int x) {
  return min(max(static_cast<int>(toks[x]), 0), 19);
}

__device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(kThreads) : "memory");
}

// OR of `v` over the group; every thread of the group gets it.
__device__ __forceinline__ bool group_any(int bar, bool v) {
  int out;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(out)
      : "r"(static_cast<int>(v)), "r"(bar), "n"(kThreads)
      : "memory");
  return out != 0;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait for every copy this thread committed but the most recent group.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Copy emission rows `aa` of the [20, m_pad] tables into the group's
// buffers at sidx layout (16-byte copies for odd PER, where sidx(j) = j;
// 4-byte ones otherwise). The caller commits.
template <int PER>
__device__ __forceinline__ void prefetch_emissions(float* dm, float* di, const float* msc,
                                                   const float* isc, int aa, int m_pad,
                                                   int t) {
  const float* gm = msc + static_cast<size_t>(aa) * m_pad;
  const float* gi = isc + static_cast<size_t>(aa) * m_pad;
  if constexpr ((PER & 1) != 0) {
    for (int c = t; c < m_pad / 4; c += kThreads) {
      cp_async16(dm + 4 * c, gm + 4 * c);
      cp_async16(di + 4 * c, gi + 4 * c);
    }
  } else {
    for (int j = t; j < m_pad; j += kThreads) {
      cp_async4(dm + sidx<PER>(j), gm + j);
      cp_async4(di + sidx<PER>(j), gi + j);
    }
  }
}

// Block-wide: row `src` [m_pad] into `dst` at sidx layout, `fill` for the
// states m_pad .. 128 * PER - 1.
template <int PER>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int m_pad, float fill) {
  for (int j = threadIdx.x; j < kThreads * PER; j += blockDim.x) {
    dst[sidx<PER>(j)] = j < m_pad ? __ldg(src + j) : fill;
  }
}

// Group-wide: `fill` for the states m_pad .. 128 * PER - 1 of `dst`.
template <int PER>
__device__ __forceinline__ void fill_tail(float* dst, int m_pad, float fill, int t) {
  for (int j = m_pad + t; j < kThreads * PER; j += kThreads) dst[sidx<PER>(j)] = fill;
}

// out[k] = state j - S of v (j = t * PER + k), for S < PER: slots k >= S
// are register moves; the first S come from thread t - 1 through `buf`
// (`fill` in thread 0).
template <int PER, int S>
__device__ __forceinline__ void shift_small(const float (&v)[PER], float (&out)[PER], float fill,
                                            float* buf, int t, int bar) {
  constexpr int SP = stride<PER>();
#pragma unroll
  for (int k = PER - S; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync(bar);
  const int prev = (t > 0 ? t - 1 : 0) * SP + PER - S;
#pragma unroll
  for (int k = 0; k < S; ++k) out[k] = t > 0 ? buf[prev + k] : fill;
#pragma unroll
  for (int k = S; k < PER; ++k) out[k] = v[k - S];
}

// The same for any s: the whole row goes through `buf`.
template <int PER>
__device__ __forceinline__ void shift_big(const float (&v)[PER], float (&out)[PER], int s,
                                          float fill, float* buf, int t, int bar) {
  constexpr int SP = stride<PER>();
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync(bar);
  const int base = t * PER - s;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = base + k;
    out[k] = j >= 0 ? buf[sidx<PER>(j >= 0 ? j : 0)] : fill;
  }
}

// out[k] = state j - s of v, `fill` where j < s: one barrier. The shifts
// by 1, 2, 4, 8 and 16 below PER move registers; larger ones read the row.
template <int PER>
__device__ __forceinline__ void shift(const float (&v)[PER], float (&out)[PER], int s, float fill,
                                      float* buf, int t, int bar) {
  if constexpr (PER > 1) {
    if (s == 1) return shift_small<PER, 1>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 2) {
    if (s == 2) return shift_small<PER, 2>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 4) {
    if (s == 4) return shift_small<PER, 4>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 8) {
    if (s == 8) return shift_small<PER, 8>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 16) {
    if (s == 16) return shift_small<PER, 16>(v, out, fill, buf, t, bar);
  }
  shift_big<PER>(v, out, s, fill, buf, t, bar);
}

// Group-wide max or sum of one value a thread: a warp butterfly, then the
// four warp results combined in a fixed order through `red` (4 floats).
template <bool SUM>
__device__ __forceinline__ float group_reduce(float v, float* red, int t, int bar) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, v, off);
    v = SUM ? v + o : fmaxf(v, o);
  }
  if ((t & 31) == 0) red[t >> 5] = v;
  group_sync(bar);
  return SUM ? (red[0] + red[1]) + (red[2] + red[3])
             : fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

// One carry row of a sequence between global memory [m_pad] (coalesced)
// and the blocked registers, through the shared row `buf`; `fill` past
// m_pad. Each global element is read and written by the same thread (j
// mod 128), so a row stored here and loaded back later needs no fence.
template <int PER>
__device__ __forceinline__ void load_row(float (&v)[PER], const float* g, int m_pad, float fill,
                                         float* buf, int t, int bar) {
  for (int j = t; j < kThreads * PER; j += kThreads) buf[sidx<PER>(j)] = j < m_pad ? g[j] : fill;
  group_sync(bar);
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k] = buf[t * stride<PER>() + k];
  group_sync(bar);  // the buffer is free again
}

template <int PER>
__device__ __forceinline__ void store_row(const float (&v)[PER], float* g, int m_pad, float* buf,
                                          int t, int bar) {
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[t * stride<PER>() + k] = v[k];
  group_sync(bar);
  for (int j = t; j < m_pad; j += kThreads) g[j] = buf[sidx<PER>(j)];
  group_sync(bar);
}

// Sets the largest dynamic shared memory on a kernel once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, unsigned& done) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((done >> device) & 1u) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done |= 1u << device;
  return err;
}

// The launch shape both launchers check: groups in 1..kMaxGroups, a grid,
// and the exact dynamic shared-memory size of smem_floats.
template <int PER>
bool plan_ok(int groups, int grid, int smem_bytes, int n_rows, bool save) {
  return groups >= 1 && groups <= kMaxGroups && grid >= 1 &&
         static_cast<size_t>(smem_bytes) == 4 * smem_floats<PER>(n_rows, groups, save) &&
         smem_bytes <= kMaxSmem;
}

}  // namespace
