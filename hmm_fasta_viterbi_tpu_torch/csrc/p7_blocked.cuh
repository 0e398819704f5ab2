// The blocked state layout and the per-group primitives shared by the p7
// Viterbi / log-space Forward / Viterbi filter template (p7_viterbi.cuh), the
// probability-space Forward kernel (p7_forward_kernel.cu) and the posterior
// backward coverage pass (p7_backward_kernel.cu); and, past 256 * 19 = 4864
// states, the rows-in-memory case's helpers (at the end).
//
// A block holds G groups of KT threads, KT = 128 (M_pad <= 128 * 19 = 2432)
// or 256 (the wide case, M_pad <= 256 * 19 = 4864); G = blockDim.x / KT, at
// most kMaxThreads / KT. Each group follows one sequence at a time and walks
// the batch with a stride of gridDim.x * G. Thread t of a group owns the
// contiguous states j = t * PER + k, k < PER, in registers. A row kept in
// shared memory puts state j at sidx(j): thread t's slots at t * SP + k,
// with the per-thread stride SP = PER rounded up to odd, so that 32
// neighbouring threads reading their slot k touch 32 different banks (for
// odd PER, sidx(j) = j).
//
// Each group synchronises on its own named barrier (bar.sync 1 + g, KT), so
// groups never wait on each other; __syncthreads is used only while the
// block stages its step-invariant rows, before the groups part. The group's
// reductions combine its KT / 32 warps in a fixed order.
//
// Dynamic shared memory, in floats, with ROW = KT * SP:
//   [n_rows rows of ROW]       the staged constant rows, shared by the groups
//   then per group:
//   [2 rows of ROW]            the shift buffers (alternating)
//   [4 rows of EROW]           the emission rows of two steps: (match,
//                              insert) for even and for odd steps; f32 rows
//                              (EROW = ROW) or, for the Viterbi filter, bf16
//                              rows (EROW = KT * HS / 2, see hstride)
//   [2 * KT / 32]              the reduction scratch (two reductions)
//   [kChunk / 4]               the tokens of the current chunk (int8)
//   [1 row, SAVE only]         two bf16 rows of the row-saving Forward
// The backward pass lays out its group's part otherwise
// (backward_group_floats). Every part is a multiple of 16 bytes.
// ops/p7_cuda.py::blocked_smem_bytes computes the same size; the launchers
// check it.
//
// At KT = 128 the six transition rows always fit beside one group (at most
// 7 of the 24 rows of 227 KB at PER = 19); at KT = 256 a row is twice as
// large (19,456 bytes at PER = 19, where one group's own rows and six staged
// transition rows would be 1,024 bytes over the block's 232,448). So the
// launch plan stages the first n_trans transition rows (6 at KT = 128) and
// the first n_chain chain rows; the kernels read the others from global
// memory. Which rows are staged is the plan's choice by shape.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 128;        // residues per token load (and lazy certificate)
constexpr int kMaxThreads = 1024;  // a block: 8 groups of 128 or 4 of 256 (barriers 1..8)
constexpr int kMaxSmem = 232448;   // bytes a block may use on the H100
constexpr int kMaxDevices = 32;
constexpr int kTransRows = 6;      // tmm tmi tmd tim tii tdm

template <int KT>
__host__ __device__ constexpr int warps() {
  return KT / 32;
}

// reduction scratch of a group: two reductions of one value a warp
template <int KT>
__host__ __device__ constexpr int red_floats() {
  return 2 * warps<KT>();
}

template <int PER>
__host__ __device__ constexpr int stride() {
  return PER | 1;
}

template <int PER, int KT>
__host__ __device__ constexpr int row_floats() {
  return KT * stride<PER>();
}

// Halfwords between two threads' slots in a bf16 row: PER for odd PER (the
// row is the global row's contiguous copy; a warp's 16-bit reads of slot k
// hit at most two words a bank), else twice an odd number of words, so that
// a warp's 32-bit reads of a slot pair hit 32 banks.
template <int PER>
__host__ __device__ constexpr int hstride() {
  return (PER & 1) ? PER : 2 * ((PER / 2) | 1);
}

// Floats of one emission row of a group: f32, or bf16 (BF16).
template <int PER, int KT, bool BF16>
__host__ __device__ constexpr int erow_floats() {
  return BF16 ? KT * hstride<PER>() / 2 : row_floats<PER, KT>();
}

// Floats of one group's part of the dynamic shared memory.
template <int PER, int KT, bool BF16>
__host__ __device__ constexpr int group_floats(bool save) {
  return 2 * row_floats<PER, KT>() + 4 * erow_floats<PER, KT, BF16>() + red_floats<KT>() +
         kChunk / 4 + (save ? row_floats<PER, KT>() : 0);
}

// Floats of dynamic shared memory for n_rows staged rows and `groups` groups.
template <int PER, int KT, bool BF16>
__host__ __device__ constexpr size_t smem_floats(int n_rows, int groups, bool save) {
  return static_cast<size_t>(n_rows) * row_floats<PER, KT>() +
         static_cast<size_t>(groups) * group_floats<PER, KT, BF16>(save);
}

// Floats of one group's part of the backward pass's dynamic shared memory:
// two shift rows, the (match, insert) odds rows of two steps, the saved bf16
// forward rows of two steps (hstride layout), the reduction scratch of three
// reductions (the coverage and B sums, the rescale max), the chunk's tokens
// (int8), and its log scales and coverage.
template <int PER, int KT>
__host__ __device__ constexpr int backward_group_floats() {
  return 6 * row_floats<PER, KT>() + 2 * erow_floats<PER, KT, true>() + 3 * warps<KT>() +
         kChunk / 4 + 2 * kChunk;
}

// Shared-memory index of state j.
template <int PER>
__device__ __forceinline__ int sidx(int j) {
  return (PER & 1) ? j : j + j / PER;
}

// Halfword index of state j in a bf16 row.
template <int PER>
__device__ __forceinline__ int hidx(int j) {
  return (j / PER) * hstride<PER>() + j % PER;
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Residue x of a token chunk as a table row: a pad token never indexes it.
__device__ __forceinline__ int token(const int8_t* toks, int x) {
  return min(max(static_cast<int>(toks[x]), 0), 19);
}

template <int KT>
__device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(KT) : "memory");
}

// OR of `v` over the group; every thread of the group gets it.
template <int KT>
__device__ __forceinline__ bool group_any(int bar, bool v) {
  int out;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(out)
      : "r"(static_cast<int>(v)), "r"(bar), "n"(KT)
      : "memory");
  return out != 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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

// Wait for every copy this thread committed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Copy emission rows `aa` of the [20, m_pad] f32 tables into the group's
// buffers at sidx layout (16-byte copies for odd PER, where sidx(j) = j;
// 4-byte ones otherwise). The caller commits.
template <int PER, int KT>
__device__ __forceinline__ void prefetch_emissions(float* dm, float* di, const float* msc,
                                                   const float* isc, int aa, int m_pad,
                                                   int t) {
  const float* gm = msc + static_cast<size_t>(aa) * m_pad;
  const float* gi = isc + static_cast<size_t>(aa) * m_pad;
  if constexpr ((PER & 1) != 0) {
    for (int c = t; c < m_pad / 4; c += KT) {
      cp_async16(dm + 4 * c, gm + 4 * c);
      cp_async16(di + 4 * c, gi + 4 * c);
    }
  } else {
    for (int j = t; j < m_pad; j += KT) {
      cp_async4(dm + sidx<PER>(j), gm + j);
      cp_async4(di + sidx<PER>(j), gi + j);
    }
  }
}

// The same for the [20, m_pad] bf16 tables (the Viterbi filter) at hidx
// layout: 16-byte copies of 8 states where the row is contiguous (M_pad is a
// multiple of 8), 4-byte copies of state pairs otherwise (a pair never
// straddles two threads at even PER). The caller commits.
template <int PER, int KT>
__device__ __forceinline__ void prefetch_emissions_bf16(uint16_t* dm, uint16_t* di,
                                                        const uint16_t* msc,
                                                        const uint16_t* isc, int aa,
                                                        int m_pad, int t) {
  const uint16_t* gm = msc + static_cast<size_t>(aa) * m_pad;
  const uint16_t* gi = isc + static_cast<size_t>(aa) * m_pad;
  if constexpr (hstride<PER>() == PER) {
    for (int c = t; c < m_pad / 8; c += KT) {
      cp_async16(dm + 8 * c, gm + 8 * c);
      cp_async16(di + 8 * c, gi + 8 * c);
    }
  } else {
    for (int j = 2 * t; j < m_pad; j += 2 * KT) {
      cp_async4(dm + hidx<PER>(j), gm + j);
      cp_async4(di + hidx<PER>(j), gi + j);
    }
  }
}

// One bf16 row `src` [m_pad] (the backward pass's saved forward row) into a
// group's buffer at hidx layout, copied as prefetch_emissions_bf16 copies.
// The caller commits.
template <int PER, int KT>
__device__ __forceinline__ void prefetch_row_bf16(uint16_t* dst, const uint16_t* src, int m_pad,
                                                  int t) {
  if constexpr (hstride<PER>() == PER) {
    for (int c = t; c < m_pad / 8; c += KT) cp_async16(dst + 8 * c, src + 8 * c);
  } else {
    for (int j = 2 * t; j < m_pad; j += 2 * KT) cp_async4(dst + hidx<PER>(j), src + j);
  }
}

// Thread t's PER states of a bf16 row, widened to f32 (exact).
template <int PER>
__device__ __forceinline__ void load_bf16(const uint16_t* row, float (&out)[PER], int t) {
  const uint16_t* mine = row + t * hstride<PER>();
  if constexpr ((PER & 1) != 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) out[k] = __uint_as_float(static_cast<uint32_t>(mine[k]) << 16);
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(mine);
#pragma unroll
    for (int k = 0; k < PER / 2; ++k) {
      const uint32_t x = w[k];
      out[2 * k] = __uint_as_float(x << 16);
      out[2 * k + 1] = __uint_as_float(x & 0xffff0000u);
    }
  }
}

// Block-wide: row `src` [m_pad] into `dst` at sidx layout, `fill` for the
// states m_pad .. KT * PER - 1.
template <int PER, int KT>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int m_pad, float fill) {
  for (int j = threadIdx.x; j < KT * PER; j += blockDim.x) {
    dst[sidx<PER>(j)] = j < m_pad ? __ldg(src + j) : fill;
  }
}

// Group-wide: `fill` for the states m_pad .. KT * PER - 1 of `dst`.
template <int PER, int KT>
__device__ __forceinline__ void fill_tail(float* dst, int m_pad, float fill, int t) {
  for (int j = m_pad + t; j < KT * PER; j += KT) dst[sidx<PER>(j)] = fill;
}

// The same for a bf16 row (`fill` as its bits).
template <int PER, int KT>
__device__ __forceinline__ void fill_tail_bf16(uint16_t* dst, int m_pad, uint16_t fill, int t) {
  for (int j = m_pad + t; j < KT * PER; j += KT) dst[hidx<PER>(j)] = fill;
}

// out[k] = state j - S of v (j = t * PER + k), for S < PER: slots k >= S
// are register moves; the first S come from thread t - 1 through `buf`
// (`fill` in thread 0).
template <int PER, int KT, int S>
__device__ __forceinline__ void shift_small(const float (&v)[PER], float (&out)[PER], float fill,
                                            float* buf, int t, int bar) {
  constexpr int SP = stride<PER>();
#pragma unroll
  for (int k = PER - S; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  const int prev = (t > 0 ? t - 1 : 0) * SP + PER - S;
#pragma unroll
  for (int k = 0; k < S; ++k) out[k] = t > 0 ? buf[prev + k] : fill;
#pragma unroll
  for (int k = S; k < PER; ++k) out[k] = v[k - S];
}

// The same for any s: the whole row goes through `buf`.
template <int PER, int KT>
__device__ __forceinline__ void shift_big(const float (&v)[PER], float (&out)[PER], int s,
                                          float fill, float* buf, int t, int bar) {
  constexpr int SP = stride<PER>();
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  const int base = t * PER - s;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = base + k;
    out[k] = j >= 0 ? buf[sidx<PER>(j >= 0 ? j : 0)] : fill;
  }
}

// out[k] = state j - s of v, `fill` where j < s: one barrier. The shifts
// by 1, 2, 4, 8 and 16 below PER move registers; larger ones read the row.
template <int PER, int KT>
__device__ __forceinline__ void shift(const float (&v)[PER], float (&out)[PER], int s, float fill,
                                      float* buf, int t, int bar) {
  if constexpr (PER > 1) {
    if (s == 1) return shift_small<PER, KT, 1>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 2) {
    if (s == 2) return shift_small<PER, KT, 2>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 4) {
    if (s == 4) return shift_small<PER, KT, 4>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 8) {
    if (s == 8) return shift_small<PER, KT, 8>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 16) {
    if (s == 16) return shift_small<PER, KT, 16>(v, out, fill, buf, t, bar);
  }
  shift_big<PER, KT>(v, out, s, fill, buf, t, bar);
}

// The mirror of shift_small, toward lower j: out[k] = state j + S of v, for
// S < PER: slots k < PER - S are register moves; the last S come from thread
// t + 1 through `buf` (`fill` in the group's last thread).
template <int PER, int KT, int S>
__device__ __forceinline__ void shift_up_small(const float (&v)[PER], float (&out)[PER],
                                               float fill, float* buf, int t, int bar) {
  constexpr int SP = stride<PER>();
#pragma unroll
  for (int k = 0; k < S; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  const int next = (t + 1 < KT ? t + 1 : t) * SP;
#pragma unroll
  for (int k = 0; k < S; ++k) out[PER - S + k] = t + 1 < KT ? buf[next + k] : fill;
#pragma unroll
  for (int k = 0; k < PER - S; ++k) out[k] = v[k + S];
}

// The mirror of shift_big: the whole row goes through `buf`.
template <int PER, int KT>
__device__ __forceinline__ void shift_up_big(const float (&v)[PER], float (&out)[PER], int s,
                                             float fill, float* buf, int t, int bar) {
  constexpr int SP = stride<PER>();
  constexpr int N = KT * PER;
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  const int base = t * PER + s;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = base + k;
    out[k] = j < N ? buf[sidx<PER>(j < N ? j : 0)] : fill;
  }
}

// out[k] = state j + s of v, `fill` past the group's KT * PER states: one
// barrier. The shifts by 1, 2, 4, 8 and 16 below PER move registers.
template <int PER, int KT>
__device__ __forceinline__ void shift_up(const float (&v)[PER], float (&out)[PER], int s,
                                         float fill, float* buf, int t, int bar) {
  if constexpr (PER > 1) {
    if (s == 1) return shift_up_small<PER, KT, 1>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 2) {
    if (s == 2) return shift_up_small<PER, KT, 2>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 4) {
    if (s == 4) return shift_up_small<PER, KT, 4>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 8) {
    if (s == 8) return shift_up_small<PER, KT, 8>(v, out, fill, buf, t, bar);
  }
  if constexpr (PER > 16) {
    if (s == 16) return shift_up_small<PER, KT, 16>(v, out, fill, buf, t, bar);
  }
  shift_up_big<PER, KT>(v, out, s, fill, buf, t, bar);
}

// The group's max or sum of its warps' values in `red`, in a fixed order:
// pairs of neighbours, then pairs of pairs.
template <bool SUM, int KT>
__device__ __forceinline__ float combine_warps(const float* red) {
  if constexpr (KT == 128) {
    return SUM ? (red[0] + red[1]) + (red[2] + red[3])
               : fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  } else {
    return SUM ? ((red[0] + red[1]) + (red[2] + red[3])) + ((red[4] + red[5]) + (red[6] + red[7]))
               : fmaxf(fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3])),
                       fmaxf(fmaxf(red[4], red[5]), fmaxf(red[6], red[7])));
  }
}

// A warp's max or sum of one value a thread (a butterfly: every lane gets it).
template <bool SUM>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, v, off);
    v = SUM ? v + o : fmaxf(v, o);
  }
  return v;
}

// Group-wide max or sum of one value a thread: a warp butterfly, then the
// warp results combined in a fixed order through `red` (KT / 32 floats).
template <bool SUM, int KT>
__device__ __forceinline__ float group_reduce(float v, float* red, int t, int bar) {
  static_assert(KT == 128 || KT == 256, "a group is 4 or 8 warps");
  v = warp_reduce<SUM>(v);
  if ((t & 31) == 0) red[t >> 5] = v;
  group_sync<KT>(bar);
  return combine_warps<SUM, KT>(red);
}

// Group-wide sums of two values a thread, each combined as group_reduce
// combines one (`red`: 2 * KT / 32 floats, a's then b's).
template <int KT>
__device__ __forceinline__ void group_sum2(float& a, float& b, float* red, int t, int bar) {
  constexpr int W = warps<KT>();
  a = warp_reduce<true>(a);
  b = warp_reduce<true>(b);
  if ((t & 31) == 0) {
    red[t >> 5] = a;
    red[W + (t >> 5)] = b;
  }
  group_sync<KT>(bar);
  a = combine_warps<true, KT>(red);
  b = combine_warps<true, KT>(red + W);
}

// One carry row of a sequence between global memory [m_pad] (coalesced)
// and the blocked registers, through the shared row `buf`; `fill` past
// m_pad. Each global element is read and written by the same thread (j
// mod KT), so a row stored here and loaded back later needs no fence.
template <int PER, int KT>
__device__ __forceinline__ void load_row(float (&v)[PER], const float* g, int m_pad, float fill,
                                         float* buf, int t, int bar) {
  for (int j = t; j < KT * PER; j += KT) buf[sidx<PER>(j)] = j < m_pad ? g[j] : fill;
  group_sync<KT>(bar);
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k] = buf[t * stride<PER>() + k];
  group_sync<KT>(bar);  // the buffer is free again
}

template <int PER, int KT>
__device__ __forceinline__ void store_row(const float (&v)[PER], float* g, int m_pad, float* buf,
                                          int t, int bar) {
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[t * stride<PER>() + k] = v[k];
  group_sync<KT>(bar);
  for (int j = t; j < m_pad; j += KT) g[j] = buf[sidx<PER>(j)];
  group_sync<KT>(bar);
}

// The step-invariant transition rows as a thread reads them: row q, slot k
// from the block's staged rows (q < n_trans; always at KT = 128) or from
// global memory [6, m_pad] (`fill` past m_pad).
template <int PER, int KT>
struct TransRows {
  const float* staged;  // the block's staged rows, at this thread's offset
  const float* global;  // [8, m_pad]
  int n_trans;
  int m_pad;
  int j0;  // t * PER
  float fill;

  __device__ __forceinline__ float operator()(int q, int k) const {
    if (KT == 128 || q < n_trans) return staged[q * row_floats<PER, KT>() + k];
    const int j = j0 + k;
    return j < m_pad ? __ldg(global + q * m_pad + j) : fill;
  }
};

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

// The launch shape every launcher checks: groups in 1..kMaxThreads / KT, a
// grid, n_trans staged transition rows (all six at KT = 128), and the exact
// dynamic shared-memory size of smem_floats.
template <int PER, int KT, bool BF16>
bool plan_ok(int groups, int grid, int smem_bytes, int n_rows, int n_trans, bool save) {
  return groups >= 1 && groups * KT <= kMaxThreads && grid >= 1 && n_trans >= 0 &&
         n_trans <= kTransRows && (KT != 128 || n_trans == kTransRows) &&
         static_cast<size_t>(smem_bytes) == 4 * smem_floats<PER, KT, BF16>(n_rows, groups, save) &&
         smem_bytes <= kMaxSmem;
}

// Calls fn(Case<per, threads>{}) for the kernel cases a source instantiates:
// 128 threads with 1..19 states a thread, 256 threads with 10..19 (the
// widths past 128 * 19 = 2432).
#define P7_CASE(P, T) \
  case P:             \
    return fn(Case<P, T>{});

template <template <int, int> class Case, typename Fn>
cudaError_t with_case(int threads, int per, Fn fn) {
  if (threads == 128) {
    switch (per) {
      P7_CASE(1, 128)
      P7_CASE(2, 128)
      P7_CASE(3, 128)
      P7_CASE(4, 128)
      P7_CASE(5, 128)
      P7_CASE(6, 128)
      P7_CASE(7, 128)
      P7_CASE(8, 128)
      P7_CASE(9, 128)
      P7_CASE(10, 128)
      P7_CASE(11, 128)
      P7_CASE(12, 128)
      P7_CASE(13, 128)
      P7_CASE(14, 128)
      P7_CASE(15, 128)
      P7_CASE(16, 128)
      P7_CASE(17, 128)
      P7_CASE(18, 128)
      P7_CASE(19, 128)
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (threads == 256) {
    switch (per) {
      P7_CASE(10, 256)
      P7_CASE(11, 256)
      P7_CASE(12, 256)
      P7_CASE(13, 256)
      P7_CASE(14, 256)
      P7_CASE(15, 256)
      P7_CASE(16, 256)
      P7_CASE(17, 256)
      P7_CASE(18, 256)
      P7_CASE(19, 256)
      default:
        return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
#undef P7_CASE

// Index of a kernel case in per-case tables: [0, 19) at 128 threads, [19,
// 29) at 256.
__host__ inline int case_slot(int threads, int per) {
  return threads == 128 ? per - 1 : 19 + per - 10;
}
constexpr int kCaseSlots = 29;

// -- the rows-in-memory case --------------------------------------------------
//
// Past 256 * 19 = 4864 states (up to 65536, the 16-row chain) neither a
// group's registers nor an SM's shared memory hold the DP rows. One block of
// kMemThreads threads follows one sequence (G = 1, a persistent grid) and
// keeps every row in global memory: kMemRows scratch rows of m_pad floats a
// block, [grid, kMemRows, m_pad], which the wrapper allocates (they stay in
// L2 while they fit), the rows of the last step and of this one by parity,
// and two rows for the chain's passes. Thread t handles the states t,
// t + kMemThreads, ...: it walks the row a tile of kMemThreads contiguous
// states at a time, so a warp's loads and stores are coalesced. A step is a
// chain of phases, each a loop over the thread's states that reads what was
// written before the last __syncthreads and writes only its own states, so
// the block barrier orders every dependency across threads; a thread reads
// back its own writes without one. The constant rows are read from global
// memory (L2). The case is meant to be right, not fast: it runs the register
// cases' float32 operations on the same operands.
constexpr int kMemThreads = 1024;
constexpr int kMemWarps = kMemThreads / 32;
constexpr int kMemRows = 8;

// Row r of this block's scratch rows.
__device__ __forceinline__ float* mem_row(float* scratch, int r, int m_pad) {
  return scratch + (static_cast<size_t>(blockIdx.x) * kMemRows + r) * m_pad;
}

// Block-wide max or sum of one value a thread: a warp butterfly, then the
// 32 warps' values in a fixed order (pairs of neighbours, then pairs of
// pairs). `red` holds 2 * kMemWarps floats; calls alternate halves (`n`
// counts them), so a call never writes the half whose readers the last
// call's barrier has not yet passed.
struct BlockReduce {
  float* red;
  int n;

  template <bool SUM>
  __device__ __forceinline__ float run(float v) {
    float* r = red + kMemWarps * (n++ & 1);
    v = warp_reduce<SUM>(v);
    if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
    __syncthreads();
    float x[kMemWarps / 2];
#pragma unroll
    for (int i = 0; i < kMemWarps / 2; ++i) {
      x[i] = SUM ? r[2 * i] + r[2 * i + 1] : fmaxf(r[2 * i], r[2 * i + 1]);
    }
#pragma unroll
    for (int w = kMemWarps / 4; w >= 1; w >>= 1) {
#pragma unroll
      for (int i = 0; i < w; ++i) {
        x[i] = SUM ? x[2 * i] + x[2 * i + 1] : fmaxf(x[2 * i], x[2 * i + 1]);
      }
    }
    return x[0];
  }
};

// The launch shape of the rows-in-memory case: one group of kMemThreads
// threads a block, no dynamic shared memory, kMemThreads * per >= m_pad, and
// the scratch rows.
inline bool mem_plan_ok(int m_pad, int per, int groups, int grid, int smem, const void* scratch) {
  return m_pad >= 1 && static_cast<long>(kMemThreads) * per >= m_pad && groups == 1 &&
         grid >= 1 && smem == 0 && scratch != nullptr;
}

}  // namespace
