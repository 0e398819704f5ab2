// The blocked state layout and the per-group primitives shared by the p7
// Viterbi / log-space Forward / Viterbi filter template (p7_viterbi.cuh), the
// probability-space Forward kernel (p7_forward_kernel.cu) and the posterior
// backward coverage pass (p7_backward_kernel.cu); the cluster pair's
// primitives, which every template's wide case runs on (after the group's),
// and the C-block cluster's, which the lazy, filter, Forward and backward
// cases run on past 2 * 2432 = 4864 states, each with its mirror toward
// lower j (the backward pass's), with the step's shift and reduction
// wrappers and the clusters' launches; the wide block's cases and shared
// memory (the eager and log-space cases past 4864 states, one block of
// kBlockThreads a sequence; block_reduce is its reduction) and their
// clusters of wide blocks past 9216 (wide_cluster_collect is their E);
// and the rows-in-memory case's helpers (at the end).
//
// A block holds G groups of KT = 128 threads (M_pad <= 128 * 19 = 2432;
// wider cases run on the clusters, below); G = blockDim.x / KT, at
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
// The six transition rows always fit beside one group (at most 7 of the 24
// rows of 227 KB at PER = 19), and so in a block of a cluster. So the
// launch plan stages all six and the first n_chain chain rows; the kernels
// read the other chain rows from global memory. Which rows are staged is
// the plan's choice by shape.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cluster.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 128;        // residues per token load (and lazy certificate)
constexpr int kMaxThreads = 1024;  // a block: 8 groups of 128 (barriers 1..8)
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

// The cluster pair's exchange area, after a block's group: two rows of
// the partner's states for the larger shifts, the slots of two exchanges (one
// value of each warp of both blocks), the halo slots of each smaller shift
// (kHaloSlots values a shift: the two shifts by one, then pass p of the
// chain at 2 + p), two slots of the rows' release signals (and two of
// padding), then the mbarriers (8 bytes each): one a halo, two for the
// exchanges, two for the rows and two for their release. XV is the values
// an exchange carries a warp (2: the backward pass's, pair_reduce2).
constexpr int kHaloIds = 2 + 16;
constexpr int kHaloSlots = 16;
constexpr int kPairBars = kHaloIds + 2 + 2 + 2;
template <int PER, int KT, int XV = 1>
__host__ __device__ constexpr int pair_floats() {
  return 2 * row_floats<PER, KT>() + XV * 2 * 2 * warps<KT>() + kHaloIds * kHaloSlots + 4 +
         2 * kPairBars;
}

// The passes of a chain whose shift (1, 2, 4, 8, 16 below PER) moves
// registers and a halo; the later ones are the larger shifts.
template <int PER>
__host__ __device__ constexpr int small_passes() {
  return PER > 16 ? 5 : PER > 8 ? 4 : PER > 4 ? 3 : PER > 2 ? 2 : PER > 1 ? 1 : 0;
}

// The same for a block of the cluster pair: n_rows staged rows, its one
// group (`save`: the row-saving Forward's) and the pair's exchange area.
template <int PER, int KT, bool BF16>
__host__ __device__ constexpr size_t pair_smem_floats(int n_rows, bool save = false) {
  return smem_floats<PER, KT, BF16>(n_rows, 1, save) + pair_floats<PER, KT>();
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

// The first n states of one bf16 row `src` (the backward pass's saved
// forward row, or a cluster block's slice of it: n a multiple of 8, `src`
// 16-byte aligned) into a group's buffer at hidx layout, copied as
// prefetch_emissions_bf16 copies. The caller commits.
template <int PER, int KT>
__device__ __forceinline__ void prefetch_row_bf16(uint16_t* dst, const uint16_t* src, int n,
                                                  int t) {
  if constexpr (hstride<PER>() == PER) {
    for (int c = t; c < n / 8; c += KT) cp_async16(dst + 8 * c, src + 8 * c);
  } else {
    for (int j = 2 * t; j < n; j += 2 * KT) cp_async4(dst + hidx<PER>(j), src + j);
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
// pairs of neighbours, then pairs of pairs (4 or 8 warps; a wide block's 32
// combine by wide_cluster_collect or block_reduce).
template <bool SUM, int KT>
__device__ __forceinline__ float combine_warps(const float* red) {
  static_assert(KT == 128 || KT == 256, "4 or 8 warps");
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
  static_assert(KT == 128, "a group is 4 warps");
  v = warp_reduce<SUM>(v);
  if ((t & 31) == 0) red[t >> 5] = v;
  group_sync<KT>(bar);
  return combine_warps<SUM, KT>(red);
}

// The same for the wide block's one group of KT = 512 or 1024 threads: a
// warp butterfly, then lane l of every warp takes warp (l mod KT / 32)'s
// value from `red` and a butterfly over the lanes combines the KT / 32 of
// them in a fixed order. Every thread gets the same value bit for bit: a
// butterfly's two partners compute each combine with its operands swapped,
// and the max and the sum are commutative.
template <bool SUM, int KT>
__device__ __forceinline__ float block_reduce(float v, float* red, int t, int bar) {
  constexpr int W = warps<KT>();
  static_assert(W >= 2 && W <= 32 && (W & (W - 1)) == 0, "a block of 2..32 warps");
  v = warp_reduce<SUM>(v);
  if ((t & 31) == 0) red[t >> 5] = v;
  group_sync<KT>(bar);
  v = red[t & (W - 1)];
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, v, off);
    v = SUM ? v + o : fmaxf(v, o);
  }
  return v;
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

// -- the cluster pair ------------------------------------------------------------
//
// Past 128 * 19 = 2432 states (up to 2 * 2432 = 4864) every template's
// cases run one sequence on a pair of groups of KT = 128
// threads, one in
// each block of a 2-block thread-block cluster, a group a block. Block r
// owns the states r * KT * PER + t * PER + k, the normal-width layout of its
// half: it stages its half of every constant row, and its registers, shift
// buffers and emission rows hold its half of the DP rows. Each phase that
// crosses threads crosses the pair; shifts go toward higher j, so block 0
// needs nothing of block 1 but the reductions' values:
//  * a shift by S below PER (1, 2, 4, 8, 16): block 0's last thread stores
//    its last S states into block 1's halo slots of that shift with
//    asynchronous stores (st.async at the address mapa gives) that complete
//    the transaction of block 1's halo mbarrier; block 1's thread 0 arrives
//    on it expecting 4 * S bytes and waits (acquire at cluster scope). The
//    rest of the shift is the group's, on its named barrier;
//  * a larger shift by s: the threads of block 0 that hold its last min(s,
//    KT * PER) states store them into one of block 1's two rows by
//    st.async, completing that row's mbarrier, which block 1 waits on; the
//    rows alternate by larger shift within a step, and before block 0
//    stores into a row again block 1 has released it (a 4-byte st.async
//    into block 0's release slot once its group read the row);
//  * a reduction (E, the filter's tail max, the lazy certificate's OR, the
//    Forward's rescale max): each
//    warp's value goes into both blocks' exchange slots by st.async, each
//    block waits for all eight on its exchange mbarrier and combines them
//    in one fixed order, block 0's warps then block 1's, so both get the
//    same value bit for bit.
// With every phase on the cluster's barrier instead (a release at cluster
// scope each, cluster.cuh), the lazy case took 7.0 us a step at 4770 states
// (24.5 ms at 64 x 3500) against 2.7 us (9.3 ms) this way, measured on an
// H100.
// No halo or exchange slot is written again before its reader is done with
// it: each step ends in an exchange (E) that needs both blocks' values, so
// block 0, which waits for nothing else, runs at most one step ahead, and
// each block's next value to the other depends on what it read; the
// exchange slots and barriers alternate by exchange.
//
// The mirror (the backward pass's shifts toward lower j, pair_shift_up):
// block 1 sends to block 0 on the same slots and mbarriers. A shift by S
// below PER: block 1's thread 0 stores its first S states into block 0's
// halo of that shift, block 0's last thread waits for 4 * S bytes; a larger
// shift by s: the threads of block 1 that hold its first min(s, KT * PER)
// states store them into one of block 0's two rows at their own index,
// released by block 0 as block 1 releases the upward rows. Its reductions
// (pair_reduce2) carry two values a warp in one exchange, in the same fixed
// order. Its slot reuse rests on the backward step's own order: every step
// *begins* with an exchange that needs both blocks' values (the coverage
// and B sums), which each block sends only after its last halo and row read
// of the step before; so block 1, which waits for nothing but the
// exchanges, runs at most one step ahead, and no block stores step n + 1's
// halos or rows before their reader is done with step n's.

// A block's place in the cluster pair (alone: rank 0, col0 0, m_real
// m_pad, nothing else read) and its exchange state: its shared exchange
// area, the partner's (cluster addresses), and the phase of each mbarrier
// it waits on, by bit.
struct Pair {
  int rank;
  int col0;    // the block's first state
  int m_real;  // the block's real states (m_pad's part in its half)
  float* rows;    // [2][row_floats]: the sender's states, for the larger shifts
  float* xslots;  // [2][XV * 2 * KT / 32] exchange slots
  float* halo;    // [kHaloIds][kHaloSlots]
  unsigned hbar;  // shared address of halo mbarrier 0 (then 8 bytes each)
  unsigned xbar;  // ... of exchange mbarrier 0
  unsigned rbar;  // ... of row mbarrier 0 (the receiving block waits)
  unsigned fbar;  // ... of release mbarrier 0 (the sending block waits)
  // the receiver's (block 1's; the mirror's: block 0's), for the sender's stores
  unsigned peer_halo, peer_hbar, peer_rows, peer_rbar;
  // the sender's (block 0's; the mirror's: block 1's), for the receiver's releases
  unsigned peer_fslot, peer_fbar;
  unsigned self_x, self_xbar, peer_x, peer_xbar;  // both blocks' slots and barriers
  unsigned hphase;  // halo mbarriers' phases (the receiving thread waits)
  unsigned xphase;  // exchange mbarriers' phases
  unsigned rphase;  // row (receiver) or release (sender) mbarriers' phases
  int xn;           // exchanges sent
};

// The pair's exchange area at `area` (pair_floats<PER, KT, XV>() floats,
// 16-byte aligned); thread 0 initialises the mbarriers (the caller fences
// and synchronises the cluster before anyone arrives on them).
template <int PER, int KT, int XV = 1>
__device__ __forceinline__ void pair_setup(Pair& pr, float* area, int t) {
  constexpr int X = XV * 2 * 2 * warps<KT>();
  pr.rows = area;
  pr.xslots = area + 2 * row_floats<PER, KT>();
  pr.halo = pr.xslots + X;
  float* fslots = pr.halo + kHaloIds * kHaloSlots;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(fslots + 4);
  pr.hbar = smem_addr(bars);
  pr.xbar = smem_addr(bars + kHaloIds);
  pr.rbar = smem_addr(bars + kHaloIds + 2);
  pr.fbar = smem_addr(bars + kHaloIds + 4);
  if (t == 0) {
    for (int i = 0; i < kPairBars; ++i) mbar_init(bars + i);
  }
  const unsigned peer = pr.rank ^ 1;
  pr.peer_halo = peer_addr(pr.halo, 1);
  pr.peer_hbar = peer_addr(bars, 1);
  pr.peer_rows = peer_addr(pr.rows, 1);
  pr.peer_rbar = peer_addr(bars + kHaloIds + 2, 1);
  pr.peer_fslot = peer_addr(fslots, 0);
  pr.peer_fbar = peer_addr(bars + kHaloIds + 4, 0);
  pr.self_x = peer_addr(pr.xslots, pr.rank);
  pr.self_xbar = peer_addr(bars + kHaloIds, pr.rank);
  pr.peer_x = peer_addr(pr.xslots, peer);
  pr.peer_xbar = peer_addr(bars + kHaloIds, peer);
  pr.hphase = 0;
  pr.xphase = 0;
  pr.rphase = 0;
  pr.xn = 0;
}

// The mirror's pair (the backward pass's, pair_shift_up): the area with two
// values an exchange slot, and the stores' and releases' targets turned
// round: block 1 stores into block 0's halos and rows, block 0 releases
// block 1's rows.
template <int PER, int KT>
__device__ __forceinline__ void pair_setup_up(Pair& pr, float* area, int t) {
  pair_setup<PER, KT, 2>(pr, area, t);
  float* fslots = pr.halo + kHaloIds * kHaloSlots;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(fslots + 4);
  pr.peer_halo = peer_addr(pr.halo, 0);
  pr.peer_hbar = peer_addr(bars, 0);
  pr.peer_rows = peer_addr(pr.rows, 0);
  pr.peer_rbar = peer_addr(bars + kHaloIds + 2, 0);
  pr.peer_fslot = peer_addr(fslots, 1);
  pr.peer_fbar = peer_addr(bars + kHaloIds + 4, 1);
}

// out[k] = state j - S of the pair's row (j = col0 + t * PER + k), for S <
// PER: slots k >= S are register moves; the first S come from thread t - 1
// through `buf`, in block 1's thread 0 from block 0's last thread through
// halo `id`, in block 0's thread 0 `fill`.
template <int PER, int KT, int S>
__device__ __forceinline__ void pair_shift_small(const float (&v)[PER], float (&out)[PER],
                                                 float fill, float* buf, int t, int bar, Pair& pr,
                                                 int id) {
  static_assert(S <= kHaloSlots, "a small shift's halo");
  constexpr int SP = stride<PER>();
  if (pr.rank == 0 && t == KT - 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      st_async(pr.peer_halo + 4 * (id * kHaloSlots + k), v[PER - S + k], pr.peer_hbar + 8 * id);
    }
  }
#pragma unroll
  for (int k = PER - S; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  if (t > 0) {
    const int prev = (t - 1) * SP + PER - S;
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = buf[prev + k];
  } else if (pr.rank == 1) {
    mbar_expect(pr.hbar + 8 * id, 4 * S);
    mbar_wait(pr.hbar + 8 * id, (pr.hphase >> id) & 1u);
    pr.hphase ^= 1u << id;
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = pr.halo[id * kHaloSlots + k];
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = fill;
  }
#pragma unroll
  for (int k = S; k < PER; ++k) out[k] = v[k - S];
}

// The same for any s: the whole row goes through `buf` on the group's
// barrier; block 1's states below s take block 0's last min(s, KT * PER)
// states from row i & 1 of block 1's two rows (i: the larger shift's index
// in this step's n larger shifts), which block 0 stores there once block 1
// has released the row's use i - 2. The release may complete the row's own
// mbarrier: the pair has two blocks, so whatever s is, block 0 is the one
// sender and block 1 the one reader of every use, and the release of use i
// + 2 comes from the block that waited on use i (the C-block cluster, whose
// senders change with q, releases on an mbarrier of each use).
template <int PER, int KT>
__device__ __forceinline__ void pair_shift_big(const float (&v)[PER], float (&out)[PER], int s,
                                               float fill, float* buf, int t, int bar, Pair& pr,
                                               int i, int n) {
  constexpr int SP = stride<PER>();
  constexpr int N = KT * PER;  // a block's states
  const int q = i & 1;
  const int first = N - min(s, N);  // block 0's first state block 1 takes
  if (pr.rank == 0) {
    if (i >= 2) {
      if (t == 0) mbar_expect(pr.fbar + 8 * q, 4);
      mbar_wait(pr.fbar + 8 * q, (pr.rphase >> q) & 1u);
      pr.rphase ^= 1u << q;
    }
    const unsigned row = pr.peer_rows + 4 * q * row_floats<PER, KT>();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = t * PER + k;
      if (j >= first) st_async(row + 4 * sidx<PER>(j), v[k], pr.peer_rbar + 8 * q);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  if (pr.rank == 1) {
    if (t == 0) mbar_expect(pr.rbar + 8 * q, 4 * (N - first));
    mbar_wait(pr.rbar + 8 * q, (pr.rphase >> q) & 1u);
    pr.rphase ^= 1u << q;
  }
  const float* row = pr.rows + q * row_floats<PER, KT>();
  const int base = t * PER - s;  // this block's index of state j - s
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = base + k;
    if (j >= 0) {
      out[k] = buf[sidx<PER>(j)];
    } else if (pr.rank == 1 && j + N >= 0) {
      out[k] = row[sidx<PER>(j + N)];
    } else {
      out[k] = fill;
    }
  }
  if (pr.rank == 1 && i + 2 < n) {
    // the group has read the row: block 0 may store its use i + 2
    group_sync<KT>(bar);
    if (t == 0) st_async(pr.peer_fslot + 4 * q, 0.0f, pr.peer_fbar + 8 * q);
  }
}

// The pair's shift by s, `fill` where j < s (`id`: the shift's halo; a
// larger shift is the step's i-th of n). The shifts by 1, 2, 4, 8 and 16
// below PER move registers, as shift's do.
template <int PER, int KT>
__device__ __forceinline__ void pair_shift(const float (&v)[PER], float (&out)[PER], int s,
                                           float fill, float* buf, int t, int bar, Pair& pr,
                                           int id, int i, int n) {
  if constexpr (PER > 1) {
    if (s == 1) return pair_shift_small<PER, KT, 1>(v, out, fill, buf, t, bar, pr, id);
  }
  if constexpr (PER > 2) {
    if (s == 2) return pair_shift_small<PER, KT, 2>(v, out, fill, buf, t, bar, pr, id);
  }
  if constexpr (PER > 4) {
    if (s == 4) return pair_shift_small<PER, KT, 4>(v, out, fill, buf, t, bar, pr, id);
  }
  if constexpr (PER > 8) {
    if (s == 8) return pair_shift_small<PER, KT, 8>(v, out, fill, buf, t, bar, pr, id);
  }
  if constexpr (PER > 16) {
    if (s == 16) return pair_shift_small<PER, KT, 16>(v, out, fill, buf, t, bar, pr, id);
  }
  pair_shift_big<PER, KT>(v, out, s, fill, buf, t, bar, pr, i, n);
}

// An exchange: each warp's value `v` (the same in every lane) into slot
// rank * KT / 32 + warp of both blocks' exchange slots of this exchange;
// returns the exchange (0 or 1) for pair_collect.
template <int KT>
__device__ __forceinline__ int pair_send(float v, int t, Pair& pr) {
  constexpr int X = 2 * warps<KT>();
  const int q = pr.xn++ & 1;
  if ((t & 31) == 0) {
    const unsigned off = 4 * (q * X + pr.rank * warps<KT>() + (t >> 5));
    st_async(pr.self_x + off, v, pr.self_xbar + 8 * q);
    st_async(pr.peer_x + off, v, pr.peer_xbar + 8 * q);
  }
  if (t == 0) mbar_expect(pr.xbar + 8 * q, 4 * X);
  return q;
}

// The 2 * KT / 32 values of exchange q, once both blocks' have arrived.
template <int KT>
__device__ __forceinline__ const float* pair_collect(int q, Pair& pr) {
  mbar_wait(pr.xbar + 8 * q, (pr.xphase >> q) & 1u);
  pr.xphase ^= 1u << q;
  return pr.xslots + q * 2 * warps<KT>();
}

// The pair's max or sum of one value a thread: a warp butterfly, every
// warp's value into both blocks, then the 2 * KT / 32 values combined in a
// fixed order, block 0's warps then block 1's.
template <bool SUM, int KT>
__device__ __forceinline__ float pair_reduce(float v, int t, Pair& pr) {
  static_assert(KT == 128, "a pair is two groups of 4 warps");
  const int q = pair_send<KT>(warp_reduce<SUM>(v), t, pr);
  return combine_warps<SUM, 2 * KT>(pair_collect<KT>(q, pr));
}

// OR of `v` over the pair; every thread of both blocks gets it.
template <int KT>
__device__ __forceinline__ bool pair_any(bool v, int t, Pair& pr) {
  const int q = pair_send<KT>(__any_sync(kFullMask, v) ? 1.0f : 0.0f, t, pr);
  return combine_warps<false, 2 * KT>(pair_collect<KT>(q, pr)) > 0.0f;
}

// The mirror of pair_shift_small, toward lower j (pair_setup_up's pair):
// out[k] = state j + S of the pair's row (j = col0 + t * PER + k), for S <
// PER: slots k < PER - S are register moves; the last S come from thread
// t + 1 through `buf`, in block 0's last thread from block 1's thread 0
// through halo `id`, in block 1's last thread `fill`.
template <int PER, int KT, int S>
__device__ __forceinline__ void pair_shift_up_small(const float (&v)[PER], float (&out)[PER],
                                                    float fill, float* buf, int t, int bar,
                                                    Pair& pr, int id) {
  static_assert(S <= kHaloSlots, "a small shift's halo");
  constexpr int SP = stride<PER>();
  if (pr.rank == 1 && t == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      st_async(pr.peer_halo + 4 * (id * kHaloSlots + k), v[k], pr.peer_hbar + 8 * id);
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  if (t + 1 < KT) {
    const int next = (t + 1) * SP;
#pragma unroll
    for (int k = 0; k < S; ++k) out[PER - S + k] = buf[next + k];
  } else if (pr.rank == 0) {
    mbar_expect(pr.hbar + 8 * id, 4 * S);
    mbar_wait(pr.hbar + 8 * id, (pr.hphase >> id) & 1u);
    pr.hphase ^= 1u << id;
#pragma unroll
    for (int k = 0; k < S; ++k) out[PER - S + k] = pr.halo[id * kHaloSlots + k];
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k) out[PER - S + k] = fill;
  }
#pragma unroll
  for (int k = 0; k < PER - S; ++k) out[k] = v[k + S];
}

// The mirror of pair_shift_big: the whole row goes through `buf` on the
// group's barrier; block 0's states from KT * PER - s on take block 1's
// first min(s, KT * PER) states from row i & 1 of block 0's two rows (at
// their own index), which block 1 stores there once block 0 has released
// the row's use i - 2 (on the row's mbarrier, as pair_shift_big: the two
// blocks never change roles).
template <int PER, int KT>
__device__ __forceinline__ void pair_shift_up_big(const float (&v)[PER], float (&out)[PER], int s,
                                                  float fill, float* buf, int t, int bar,
                                                  Pair& pr, int i, int n) {
  constexpr int SP = stride<PER>();
  constexpr int N = KT * PER;  // a block's states
  const int q = i & 1;
  const int count = min(s, N);  // block 1's states block 0 takes
  if (pr.rank == 1) {
    if (i >= 2) {
      if (t == 0) mbar_expect(pr.fbar + 8 * q, 4);
      mbar_wait(pr.fbar + 8 * q, (pr.rphase >> q) & 1u);
      pr.rphase ^= 1u << q;
    }
    const unsigned row = pr.peer_rows + 4 * q * row_floats<PER, KT>();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = t * PER + k;
      if (j < count) st_async(row + 4 * sidx<PER>(j), v[k], pr.peer_rbar + 8 * q);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  if (pr.rank == 0) {
    if (t == 0) mbar_expect(pr.rbar + 8 * q, 4 * count);
    mbar_wait(pr.rbar + 8 * q, (pr.rphase >> q) & 1u);
    pr.rphase ^= 1u << q;
  }
  const float* row = pr.rows + q * row_floats<PER, KT>();
  const int base = t * PER + s;  // this block's index of state j + s
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = base + k;
    if (j < N) {
      out[k] = buf[sidx<PER>(j)];
    } else if (pr.rank == 0 && j - N < N) {
      out[k] = row[sidx<PER>(j - N)];
    } else {
      out[k] = fill;
    }
  }
  if (pr.rank == 0 && i + 2 < n) {
    // the group has read the row: block 1 may store its use i + 2
    group_sync<KT>(bar);
    if (t == 0) st_async(pr.peer_fslot + 4 * q, 0.0f, pr.peer_fbar + 8 * q);
  }
}

// The pair's shift by s toward lower j, `fill` past the pair's states
// (`id`: the shift's halo; a larger shift is the step's i-th of n).
template <int PER, int KT>
__device__ __forceinline__ void pair_shift_up(const float (&v)[PER], float (&out)[PER], int s,
                                              float fill, float* buf, int t, int bar, Pair& pr,
                                              int id, int i, int n) {
  if constexpr (PER > 1) {
    if (s == 1) return pair_shift_up_small<PER, KT, 1>(v, out, fill, buf, t, bar, pr, id);
  }
  if constexpr (PER > 2) {
    if (s == 2) return pair_shift_up_small<PER, KT, 2>(v, out, fill, buf, t, bar, pr, id);
  }
  if constexpr (PER > 4) {
    if (s == 4) return pair_shift_up_small<PER, KT, 4>(v, out, fill, buf, t, bar, pr, id);
  }
  if constexpr (PER > 8) {
    if (s == 8) return pair_shift_up_small<PER, KT, 8>(v, out, fill, buf, t, bar, pr, id);
  }
  if constexpr (PER > 16) {
    if (s == 16) return pair_shift_up_small<PER, KT, 16>(v, out, fill, buf, t, bar, pr, id);
  }
  pair_shift_up_big<PER, KT>(v, out, s, fill, buf, t, bar, pr, i, n);
}

// The pair's sums (SUM) or maxes of two values a thread in one exchange
// (the backward pass's; its area holds two values a slot, pair_setup<PER,
// KT, 2>): each warp's a and b into both blocks' slots, a's then b's, each
// combined as pair_reduce combines one, block 0's warps then block 1's.
template <bool SUM, int KT>
__device__ __forceinline__ void pair_reduce2(float& a, float& b, int t, Pair& pr) {
  constexpr int X = 2 * warps<KT>();
  a = warp_reduce<SUM>(a);
  b = warp_reduce<SUM>(b);
  const int q = pr.xn++ & 1;
  if ((t & 31) == 0) {
    const unsigned off = 4 * (2 * q * X + pr.rank * warps<KT>() + (t >> 5));
    st_async(pr.self_x + off, a, pr.self_xbar + 8 * q);
    st_async(pr.peer_x + off, a, pr.peer_xbar + 8 * q);
    st_async(pr.self_x + off + 4 * X, b, pr.self_xbar + 8 * q);
    st_async(pr.peer_x + off + 4 * X, b, pr.peer_xbar + 8 * q);
  }
  if (t == 0) mbar_expect(pr.xbar + 8 * q, 8 * X);
  mbar_wait(pr.xbar + 8 * q, (pr.xphase >> q) & 1u);
  pr.xphase ^= 1u << q;
  const float* x = pr.xslots + 2 * q * X;
  a = combine_warps<SUM, 2 * KT>(x);
  b = combine_warps<SUM, 2 * KT>(x + X);
}

// -- the C-block cluster ------------------------------------------------------
//
// Past 2 * 2432 = 4864 states (up to kMaxCluster * 2432 = 38,912) the
// Viterbi template's lazy and filter cases, the Forward template's cases
// and the backward pass run one sequence on C groups of KT = 128 threads, one in each
// block of a C-block thread-block cluster (C = ceil(M_pad / 2432), 3..16,
// read from %cluster_nctarank, so one compiled case of PER serves every
// C). Block r owns the states r * KT * PER + t * PER + k, the normal-width
// layout of its slice, and stages its slice of every row the normal-width
// plan stages. Each phase that crosses threads crosses the cluster, as the
// pair's do, with the same slots and mbarriers in every block (cluster_floats):
//  * a shift by S below PER and at most 16: block r - 1's last thread stores
//    its last S states into block r's halo of that shift by st.async; block
//    r's thread 0 arrives expecting 4 * S bytes and waits (block 0 fills);
//  * a larger shift by s, with q = s div (KT * PER) and s' = s mod (KT *
//    PER): state l of block r is state l - s' of block r - q when l >= s',
//    else state l - s' + KT * PER of block r - q - 1. So block b stores its
//    states below KT * PER - s' into block b + q's row at l + s' (q >= 1;
//    for q = 0 they are its own, read from its shift buffer) and the others
//    into block b + q + 1's row at l + s' - KT * PER, where those blocks
//    exist; a receiving block expects the bytes of the blocks that exist
//    below it. The rows alternate by larger shift within a step; before a
//    block stores into a row again (use i + 1 of the step, for i >= 1),
//    each block that reads that row has released it to the blocks that will
//    store there at use i + 1, once use i's barrier has passed (every thread
//    of the block has read use i - 1's row by then): a 4-byte st.async into
//    the sender's halo slot of use i + 1's id (2 + p of its pass p, past
//    every small shift's halo; slot 0 for the b + q receiver, 1 for the b +
//    q + 1 one), completing the sender's halo mbarrier of that id, on which
//    it waits at use i + 1. A block that receives nothing still releases.
//    Each use's releases complete an mbarrier of their own, not one of the
//    row's two: the blocks that store into a row change with q, so with C
//    >= 4 a release for use i + 2 may come from a block that never waited
//    on the sender's use i, and on the row's mbarrier it would land in use
//    i's phase (a hang, or a row overwritten while it is read). The cluster
//    pair needs no such care: its two blocks never change roles;
//  * a reduction: lane p of each warp stores the warp's value into block p's
//    exchange slot rank * KT / 32 + warp; every block waits for the C * KT /
//    32 values on its exchange mbarrier and combines them in one fixed order,
//    block 0's warps first (each block's KT / 32 as the group combines them,
//    then the blocks in rank order), so every block gets the same value bit
//    for bit.
// No slot or row is written again before its readers are done: every step
// ends in an exchange (E) that needs every block's value, sent after that
// block's last read of the step, so no block starts step n + 1's stores
// before every block is done with step n's halos and the rows' last two
// uses, and no release for step n + 1's use i is sent before its sender
// has waited on step n's; within a step the releases order the rows' reuse,
// and exchange n + 2 reuses the slots of exchange n only after every block
// has sent n + 1, which each sends after its reads of n. Every wait is an
// mbarrier's, acquire at cluster scope: no release fence and no cluster
// barrier in a step.
//
// The mirror (the backward pass's shifts toward lower j, cluster_shift_up)
// sends from block r + 1 to block r on the same slots and mbarriers, the
// last block filling: a shift by S below PER goes from block r + 1's thread
// 0 into block r's halo; a larger shift by s, with q and s' as above, gives
// state l of block r state l + s' of block r + q when l + s' < KT * PER,
// else state l + s' - KT * PER of block r + q + 1, so block b stores its
// states from s' on into block b - q's row at l - s' (q >= 1; for q = 0
// they are its own) and the others into block b - q - 1's row at l + KT *
// PER - s'; a reader releases a row to the blocks that store into it at its
// next use (rank + q and rank + q + 1 of that use), even when it received
// nothing, as the forward direction does: after the barrier of the use
// before, on the sender's halo mbarrier of the next use's id. Its
// reductions (cluster_reduce2) carry two values a warp in one exchange, in
// the same fixed order. Its slot reuse rests on the backward step's order:
// every step begins with an exchange that needs every block's value (the
// coverage and B sums), which each block sends only after its last halo and
// row read and its last release wait of the step before, so block C - 1,
// which waits on nobody's halo or row, runs at most one step ahead, and no
// block stores step n + 1's halos or rows, or releases their uses, before
// their readers and senders are done with step n's.
constexpr int kMaxCluster = 16;

// A block's area: two rows that other blocks' states land in, two
// exchanges' slots (kMaxCluster blocks' warps, XV values each), the halos
// (a larger shift's: its releases), 4 slots and then the mbarriers, laid
// out as the pair's (whose release slots and mbarriers a C-block cluster
// leaves unused).
template <int PER, int KT, int XV = 1>
__host__ __device__ constexpr int cluster_floats() {
  return 2 * row_floats<PER, KT>() + XV * 2 * kMaxCluster * warps<KT>() +
         kHaloIds * kHaloSlots + 4 + 2 * kPairBars;
}

template <int PER, int KT, bool BF16>
__host__ __device__ constexpr size_t cluster_smem_floats(int n_rows, bool save = false) {
  return smem_floats<PER, KT, BF16>(n_rows, 1, save) + cluster_floats<PER, KT>();
}

// A block's place in its C-block cluster and its exchange state.
struct Cluster {
  int rank;
  int nblk;    // C
  int col0;    // the block's first state
  int m_real;  // the block's real states
  float* rows;    // [2][row_floats]: the states other blocks store for a larger shift
  float* xslots;  // [2][XV * kMaxCluster * KT / 32] exchange slots
  float* halo;    // [kHaloIds][kHaloSlots]
  unsigned long long* bars;  // halo 0.., exchange, row mbarriers
  unsigned hbar, xbar, rbar;  // shared addresses of each kind's mbarrier 0
  unsigned next_halo, next_hbar;    // block rank + 1's halos and their mbarriers
  unsigned prev_halo, prev_hbar;    // block rank - 1's (the mirror's)
  unsigned x_dst, xbar_dst;         // lane p < C: block p's exchange slots and mbarriers
  unsigned hphase, xphase, rphase;  // each kind's phases, by bit (halo ids: a larger
                                    // shift's releases)
  int xn;  // exchanges sent
};

// The cluster's area at `area` (cluster_floats<PER, KT, XV>() floats,
// 16-byte aligned); thread 0 initialises the mbarriers (the caller fences
// and synchronises the cluster before anyone arrives on them). `c.rank` and
// `c.nblk` are set.
template <int PER, int KT, int XV = 1>
__device__ __forceinline__ void cluster_setup(Cluster& c, float* area, int t) {
  c.rows = area;
  c.xslots = area + 2 * row_floats<PER, KT>();
  c.halo = c.xslots + XV * 2 * kMaxCluster * warps<KT>();
  c.bars = reinterpret_cast<unsigned long long*>(c.halo + kHaloIds * kHaloSlots + 4);
  c.hbar = smem_addr(c.bars);
  c.xbar = smem_addr(c.bars + kHaloIds);
  c.rbar = smem_addr(c.bars + kHaloIds + 2);
  if (t == 0) {
    for (int i = 0; i < kPairBars; ++i) mbar_init(c.bars + i);
  }
  const unsigned next = min(c.rank + 1, c.nblk - 1);
  c.next_halo = peer_addr(c.halo, next);
  c.next_hbar = peer_addr(c.bars, next);
  const unsigned prev = max(c.rank - 1, 0);
  c.prev_halo = peer_addr(c.halo, prev);
  c.prev_hbar = peer_addr(c.bars, prev);
  const unsigned dst = min(t & 31, c.nblk - 1);
  c.x_dst = peer_addr(c.xslots, dst);
  c.xbar_dst = peer_addr(c.bars + kHaloIds, dst);
  c.hphase = c.xphase = c.rphase = 0;
  c.xn = 0;
}

// out[k] = state j - S of the cluster's row (j = col0 + t * PER + k), for
// S < PER: slots k >= S are register moves; the first S come from thread t -
// 1 through `buf`, in thread 0 of block r > 0 from block r - 1's last thread
// through halo `id`, in block 0's thread 0 `fill`.
template <int PER, int KT, int S>
__device__ __forceinline__ void cluster_shift_small(const float (&v)[PER], float (&out)[PER],
                                                    float fill, float* buf, int t, int bar,
                                                    Cluster& c, int id) {
  static_assert(S <= kHaloSlots, "a small shift's halo");
  constexpr int SP = stride<PER>();
  if (c.rank + 1 < c.nblk && t == KT - 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      st_async(c.next_halo + 4 * (id * kHaloSlots + k), v[PER - S + k], c.next_hbar + 8 * id);
    }
  }
#pragma unroll
  for (int k = PER - S; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  if (t > 0) {
    const int prev = (t - 1) * SP + PER - S;
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = buf[prev + k];
  } else if (c.rank > 0) {
    mbar_expect(c.hbar + 8 * id, 4 * S);
    mbar_wait(c.hbar + 8 * id, (c.hphase >> id) & 1u);
    c.hphase ^= 1u << id;
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = c.halo[id * kHaloSlots + k];
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = fill;
  }
#pragma unroll
  for (int k = S; k < PER; ++k) out[k] = v[k - S];
}

// The releases a block sends for a row's use with shift s (the step's
// larger shift of halo id `id`): to the blocks that will store into it
// there (thread 0: rank - q, thread 1: rank - q - 1), into their halo slots
// of `id`, completing their halo mbarrier `id`, which no small shift of the
// case uses (a larger shift's pass is past PER).
template <int PER, int KT>
__device__ __forceinline__ void cluster_release(int s, int id, int t, Cluster& c) {
  constexpr int N = KT * PER;
  const int q = s / N;
  const int rest = s - q * N;
  const int to = t == 0 ? (q >= 1 ? c.rank - q : -1) : (rest > 0 ? c.rank - q - 1 : -1);
  if (t < 2 && to >= 0) {
    st_async(peer_addr(c.halo + id * kHaloSlots + t, to), 0.0f, peer_addr(c.bars + id, to));
  }
}

// The sender's wait, before its larger shift i >= 2 (halo id `id`), for the
// releases of that use from the `count` blocks it stores into.
__device__ __forceinline__ void cluster_release_wait(int count, int id, int t, Cluster& c) {
  const unsigned fbar = c.hbar + 8 * id;
  if (t == 0) mbar_expect(fbar, 4 * count);
  mbar_wait(fbar, (c.hphase >> id) & 1u);
  c.hphase ^= 1u << id;
}

// The same for any s: block r's state l takes state l - s' of block r - q
// (its own shift buffer for q = 0) when l >= s', else state l - s' + KT *
// PER of block r - q - 1 (the header says how they get here), `fill` where
// that block does not exist. `i` is the larger shift's index in this step's
// n larger shifts, `id` its halo id (2 + p of its pass p). A row's release
// for its use i + 2 goes out after the barrier of use i + 1 (every thread of
// the block has read the row by then), not after a barrier of its own: one
// barrier a larger shift, as the cluster of wide blocks' (p7_viterbi.cuh::
// wide_cluster_big).
template <int PER, int KT>
__device__ __forceinline__ void cluster_shift_big(const float (&v)[PER], float (&out)[PER], int s,
                                                  float fill, float* buf, int t, int bar,
                                                  Cluster& c, int i, int n, int id) {
  constexpr int SP = stride<PER>();
  constexpr int N = KT * PER;  // a block's states
  const int qq = i & 1;
  const int q = s / N;
  const int rest = s - q * N;
  // stores to block rank + q (its states below N - rest) and rank + q + 1
  // (the others)
  const bool to_a = q >= 1 && c.rank + q < c.nblk;
  const bool to_b = rest > 0 && c.rank + q + 1 < c.nblk;
  if (to_a || to_b) {
    if (i >= 2) cluster_release_wait(int(to_a) + int(to_b), id, t, c);
    const int dst_a = min(c.rank + q, c.nblk - 1);
    const int dst_b = min(c.rank + q + 1, c.nblk - 1);
    const unsigned row_a = peer_addr(c.rows + qq * row_floats<PER, KT>(), dst_a);
    const unsigned bar_a = peer_addr(c.bars + kHaloIds + 2 + qq, dst_a);
    const unsigned row_b = peer_addr(c.rows + qq * row_floats<PER, KT>(), dst_b);
    const unsigned bar_b = peer_addr(c.bars + kHaloIds + 2 + qq, dst_b);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = t * PER + k;
      if (j < N - rest) {
        if (to_a) st_async(row_a + 4 * sidx<PER>(j + rest), v[k], bar_a);
      } else if (to_b) {
        st_async(row_b + 4 * sidx<PER>(j + rest - N), v[k], bar_b);
      }
    }
  }
  if (q == 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) buf[t * SP + k] = v[k];
  }
  group_sync<KT>(bar);
  // the group has read use i - 1's row: its use i + 1 (a shift by 2s) may
  // be stored
  if (i >= 1 && i + 1 < n) cluster_release<PER, KT>(s << 1, id + 1, t, c);
  // what lands here: from block rank - q (q >= 1) and rank - q - 1
  const bool from_a = q >= 1 && c.rank - q >= 0;
  const bool from_b = rest > 0 && c.rank - q - 1 >= 0;
  if (from_a || from_b) {
    if (t == 0) mbar_expect(c.rbar + 8 * qq, 4 * ((from_a ? N - rest : 0) + (from_b ? rest : 0)));
    mbar_wait(c.rbar + 8 * qq, (c.rphase >> qq) & 1u);
    c.rphase ^= 1u << qq;
  }
  const float* row = c.rows + qq * row_floats<PER, KT>();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int l = t * PER + k;
    if (l >= rest) {
      out[k] = q == 0 ? buf[sidx<PER>(l - rest)] : from_a ? row[sidx<PER>(l)] : fill;
    } else {
      out[k] = from_b ? row[sidx<PER>(l)] : fill;
    }
  }
}

// The cluster's shift by s, `fill` where j < s (`id`: the shift's halo; a
// larger shift is the step's i-th of n).
template <int PER, int KT>
__device__ __forceinline__ void cluster_shift(const float (&v)[PER], float (&out)[PER], int s,
                                              float fill, float* buf, int t, int bar, Cluster& c,
                                              int id, int i, int n) {
  if constexpr (PER > 1) {
    if (s == 1) return cluster_shift_small<PER, KT, 1>(v, out, fill, buf, t, bar, c, id);
  }
  if constexpr (PER > 2) {
    if (s == 2) return cluster_shift_small<PER, KT, 2>(v, out, fill, buf, t, bar, c, id);
  }
  if constexpr (PER > 4) {
    if (s == 4) return cluster_shift_small<PER, KT, 4>(v, out, fill, buf, t, bar, c, id);
  }
  if constexpr (PER > 8) {
    if (s == 8) return cluster_shift_small<PER, KT, 8>(v, out, fill, buf, t, bar, c, id);
  }
  if constexpr (PER > 16) {
    if (s == 16) return cluster_shift_small<PER, KT, 16>(v, out, fill, buf, t, bar, c, id);
  }
  cluster_shift_big<PER, KT>(v, out, s, fill, buf, t, bar, c, i, n, id);
}

// An exchange: each warp's value `v` (the same in every lane) into slot
// rank * KT / 32 + warp of every block's slots of this exchange, lane p
// storing into block p's; returns the exchange (0 or 1) for cluster_collect.
template <int KT>
__device__ __forceinline__ int cluster_send(float v, int t, Cluster& c) {
  constexpr int X = kMaxCluster * warps<KT>();
  const int q = c.xn++ & 1;
  if ((t & 31) < c.nblk) {
    const unsigned off = 4 * (q * X + c.rank * warps<KT>() + (t >> 5));
    st_async(c.x_dst + off, v, c.xbar_dst + 8 * q);
  }
  if (t == 0) mbar_expect(c.xbar + 8 * q, 4 * c.nblk * warps<KT>());
  return q;
}

// The max or sum of exchange q's C * KT / 32 values, once every block's
// have arrived: each block's warps as a group combines them, then the
// blocks in rank order.
template <bool SUM, int KT>
__device__ __forceinline__ float cluster_collect(int q, Cluster& c) {
  mbar_wait(c.xbar + 8 * q, (c.xphase >> q) & 1u);
  c.xphase ^= 1u << q;
  const float* x = c.xslots + q * kMaxCluster * warps<KT>();
  float acc = combine_warps<SUM, KT>(x);
  for (int b = 1; b < c.nblk; ++b) {
    const float v = combine_warps<SUM, KT>(x + b * warps<KT>());
    acc = SUM ? acc + v : fmaxf(acc, v);
  }
  return acc;
}

// The cluster's max or sum of one value a thread.
template <bool SUM, int KT>
__device__ __forceinline__ float cluster_reduce(float v, int t, Cluster& c) {
  return cluster_collect<SUM, KT>(cluster_send<KT>(warp_reduce<SUM>(v), t, c), c);
}

// A cluster of wide blocks' area (cluster_setup's layout) addressed from its
// first landing row alone, so that one pointer of the block's state lives
// across a step rather than one a part and a cluster address a peer: at 64
// registers a thread each register the step holds is one it spills.
constexpr int kMaxBlockCluster = 8;

template <int PER, int KT>
struct WideArea {
  static constexpr int ROW = row_floats<PER, KT>();
  static constexpr int X = kMaxCluster * warps<KT>();  // an exchange's slots

  __device__ static float* row(const Cluster& c, int qq) { return c.rows + qq * ROW; }
  __device__ static float* xslots(const Cluster& c, int q) { return c.rows + 2 * ROW + q * X; }
  __device__ static float* halo(const Cluster& c, int id) {
    return c.rows + 2 * ROW + 2 * X + id * kHaloSlots;
  }
  // mbarrier i (halo ids, then the two exchanges, then the two rows)
  __device__ static unsigned long long* bar(const Cluster& c, int i) {
    return reinterpret_cast<unsigned long long*>(c.rows + 2 * ROW + 2 * X + kHaloIds * kHaloSlots +
                                                 4) + i;
  }
};

// An exchange of the cluster of wide blocks: cluster_send's, with the
// addresses taken from WideArea.
template <int PER, int KT>
__device__ __forceinline__ int wide_cluster_send(float v, int t, Cluster& c) {
  using A = WideArea<PER, KT>;
  const int q = c.xn++ & 1;
  if ((t & 31) < c.nblk) {
    const unsigned dst = t & 31;
    const unsigned off = 4 * (c.rank * warps<KT>() + (t >> 5));
    st_async(peer_addr(A::xslots(c, q), dst) + off, v, peer_addr(A::bar(c, kHaloIds + q), dst));
  }
  if (t == 0) mbar_expect(smem_addr(A::bar(c, kHaloIds + q)), 4 * c.nblk * warps<KT>());
  return q;
}

// The max or sum of exchange q of a cluster of wide blocks (KT / 32 = 32
// warps a block, at most kMaxBlockCluster blocks): lane l of every warp
// takes warp l's value of each block and a butterfly over the lanes
// combines each block's 32 in a fixed order, then the blocks combine in rank
// order. Every thread gets the same value bit for bit (as block_reduce's: a
// butterfly's partners compute each combine with its operands swapped).
template <bool SUM, int PER, int KT>
__device__ __forceinline__ float wide_cluster_collect(int q, Cluster& c, int t) {
  using A = WideArea<PER, KT>;
  constexpr int W = warps<KT>();
  static_assert(W == 32, "a wide block of 32 warps");
  mbar_wait(smem_addr(A::bar(c, kHaloIds + q)), (c.xphase >> q) & 1u);
  c.xphase ^= 1u << q;
  const float* x = A::xslots(c, q) + (t & 31);
  float acc = 0.0f;
#pragma unroll 1
  for (int b = 0; b < c.nblk; ++b) {
    float v = x[b * W];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(kFullMask, v, off);
      v = SUM ? v + o : fmaxf(v, o);
    }
    acc = b == 0 ? v : SUM ? acc + v : fmaxf(acc, v);
  }
  return acc;
}

template <bool SUM, int PER, int KT>
__device__ __forceinline__ float wide_cluster_reduce(float v, int t, Cluster& c) {
  return wide_cluster_collect<SUM, PER, KT>(wide_cluster_send<PER, KT>(warp_reduce<SUM>(v), t, c),
                                            c, t);
}

// OR of `v` over the cluster; every thread of every block gets it.
template <int KT>
__device__ __forceinline__ bool cluster_any(bool v, int t, Cluster& c) {
  return cluster_collect<false, KT>(
             cluster_send<KT>(__any_sync(kFullMask, v) ? 1.0f : 0.0f, t, c), c) > 0.0f;
}

// The mirror of cluster_shift_small, toward lower j: out[k] = state j + S
// of the cluster's row, for S < PER: slots k < PER - S are register moves;
// the last S come from thread t + 1 through `buf`, in the last thread of
// block r < C - 1 from block r + 1's thread 0 through halo `id`, in block C
// - 1's last thread `fill`.
template <int PER, int KT, int S>
__device__ __forceinline__ void cluster_shift_up_small(const float (&v)[PER], float (&out)[PER],
                                                       float fill, float* buf, int t, int bar,
                                                       Cluster& c, int id) {
  static_assert(S <= kHaloSlots, "a small shift's halo");
  constexpr int SP = stride<PER>();
  if (c.rank > 0 && t == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      st_async(c.prev_halo + 4 * (id * kHaloSlots + k), v[k], c.prev_hbar + 8 * id);
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
  if (t + 1 < KT) {
    const int next = (t + 1) * SP;
#pragma unroll
    for (int k = 0; k < S; ++k) out[PER - S + k] = buf[next + k];
  } else if (c.rank + 1 < c.nblk) {
    mbar_expect(c.hbar + 8 * id, 4 * S);
    mbar_wait(c.hbar + 8 * id, (c.hphase >> id) & 1u);
    c.hphase ^= 1u << id;
#pragma unroll
    for (int k = 0; k < S; ++k) out[PER - S + k] = c.halo[id * kHaloSlots + k];
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k) out[PER - S + k] = fill;
  }
#pragma unroll
  for (int k = 0; k < PER - S; ++k) out[k] = v[k + S];
}

// The mirror's releases for a row's use with shift s (halo id `id`): to the
// blocks that will store into it there (thread 0: rank + q, thread 1: rank
// + q + 1), on their halo mbarrier `id`, as cluster_release sends them.
template <int PER, int KT>
__device__ __forceinline__ void cluster_release_up(int s, int id, int t, Cluster& c) {
  constexpr int N = KT * PER;
  const int q = s / N;
  const int rest = s - q * N;
  const int to = t == 0 ? (q >= 1 ? c.rank + q : c.nblk) : (rest > 0 ? c.rank + q + 1 : c.nblk);
  if (t < 2 && to < c.nblk) {
    st_async(peer_addr(c.halo + id * kHaloSlots + t, to), 0.0f, peer_addr(c.bars + id, to));
  }
}

// The mirror of cluster_shift_big: block r's state l takes state l + s' of
// block r + q (its own shift buffer for q = 0) when l + s' < KT * PER, else
// state l + s' - KT * PER of block r + q + 1 (the header says how they get
// here), `fill` where that block does not exist. `i` is the larger shift's
// index in this step's n larger shifts, `id` its halo id; its releases go
// out as cluster_shift_big's.
template <int PER, int KT>
__device__ __forceinline__ void cluster_shift_up_big(const float (&v)[PER], float (&out)[PER],
                                                     int s, float fill, float* buf, int t,
                                                     int bar, Cluster& c, int i, int n, int id) {
  constexpr int SP = stride<PER>();
  constexpr int N = KT * PER;  // a block's states
  const int qq = i & 1;
  const int q = s / N;
  const int rest = s - q * N;
  // stores to block rank - q (its states from rest on) and rank - q - 1
  // (the others)
  const bool to_a = q >= 1 && c.rank - q >= 0;
  const bool to_b = rest > 0 && c.rank - q - 1 >= 0;
  if (to_a || to_b) {
    if (i >= 2) cluster_release_wait(int(to_a) + int(to_b), id, t, c);
    const int dst_a = max(c.rank - q, 0);
    const int dst_b = max(c.rank - q - 1, 0);
    const unsigned row_a = peer_addr(c.rows + qq * row_floats<PER, KT>(), dst_a);
    const unsigned bar_a = peer_addr(c.bars + kHaloIds + 2 + qq, dst_a);
    const unsigned row_b = peer_addr(c.rows + qq * row_floats<PER, KT>(), dst_b);
    const unsigned bar_b = peer_addr(c.bars + kHaloIds + 2 + qq, dst_b);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = t * PER + k;
      if (j >= rest) {
        if (to_a) st_async(row_a + 4 * sidx<PER>(j - rest), v[k], bar_a);
      } else if (to_b) {
        st_async(row_b + 4 * sidx<PER>(j + N - rest), v[k], bar_b);
      }
    }
  }
  if (q == 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) buf[t * SP + k] = v[k];
  }
  group_sync<KT>(bar);
  // the group has read use i - 1's row: its use i + 1 may be stored
  if (i >= 1 && i + 1 < n) cluster_release_up<PER, KT>(s << 1, id + 1, t, c);
  // what lands here: from block rank + q (q >= 1) and rank + q + 1
  const bool from_a = q >= 1 && c.rank + q < c.nblk;
  const bool from_b = rest > 0 && c.rank + q + 1 < c.nblk;
  if (from_a || from_b) {
    if (t == 0) mbar_expect(c.rbar + 8 * qq, 4 * ((from_a ? N - rest : 0) + (from_b ? rest : 0)));
    mbar_wait(c.rbar + 8 * qq, (c.rphase >> qq) & 1u);
    c.rphase ^= 1u << qq;
  }
  const float* row = c.rows + qq * row_floats<PER, KT>();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int l = t * PER + k;
    if (l + rest < N) {
      out[k] = q == 0 ? buf[sidx<PER>(l + rest)] : from_a ? row[sidx<PER>(l)] : fill;
    } else {
      out[k] = from_b ? row[sidx<PER>(l)] : fill;
    }
  }
}

// The cluster's shift by s toward lower j, `fill` past the cluster's
// states (`id`: the shift's halo; a larger shift is the step's i-th of n).
template <int PER, int KT>
__device__ __forceinline__ void cluster_shift_up(const float (&v)[PER], float (&out)[PER], int s,
                                                 float fill, float* buf, int t, int bar,
                                                 Cluster& c, int id, int i, int n) {
  if constexpr (PER > 1) {
    if (s == 1) return cluster_shift_up_small<PER, KT, 1>(v, out, fill, buf, t, bar, c, id);
  }
  if constexpr (PER > 2) {
    if (s == 2) return cluster_shift_up_small<PER, KT, 2>(v, out, fill, buf, t, bar, c, id);
  }
  if constexpr (PER > 4) {
    if (s == 4) return cluster_shift_up_small<PER, KT, 4>(v, out, fill, buf, t, bar, c, id);
  }
  if constexpr (PER > 8) {
    if (s == 8) return cluster_shift_up_small<PER, KT, 8>(v, out, fill, buf, t, bar, c, id);
  }
  if constexpr (PER > 16) {
    if (s == 16) return cluster_shift_up_small<PER, KT, 16>(v, out, fill, buf, t, bar, c, id);
  }
  cluster_shift_up_big<PER, KT>(v, out, s, fill, buf, t, bar, c, i, n, id);
}

// The cluster's sums (SUM) or maxes of two values a thread in one exchange
// (the backward pass's; its area holds two values a slot, cluster_setup<PER,
// KT, 2>): lane p of each warp stores the warp's a and b into block p's
// slots, a's then b's; each combined as cluster_collect combines one, block
// 0's warps first.
template <bool SUM, int KT>
__device__ __forceinline__ void cluster_reduce2(float& a, float& b, int t, Cluster& c) {
  constexpr int X = kMaxCluster * warps<KT>();
  a = warp_reduce<SUM>(a);
  b = warp_reduce<SUM>(b);
  const int q = c.xn++ & 1;
  if ((t & 31) < c.nblk) {
    const unsigned off = 4 * (2 * q * X + c.rank * warps<KT>() + (t >> 5));
    st_async(c.x_dst + off, a, c.xbar_dst + 8 * q);
    st_async(c.x_dst + off + 4 * X, b, c.xbar_dst + 8 * q);
  }
  if (t == 0) mbar_expect(c.xbar + 8 * q, 8 * c.nblk * warps<KT>());
  mbar_wait(c.xbar + 8 * q, (c.xphase >> q) & 1u);
  c.xphase ^= 1u << q;
  const float* x = c.xslots + 2 * q * X;
  a = combine_warps<SUM, KT>(x);
  b = combine_warps<SUM, KT>(x + X);
  for (int r = 1; r < c.nblk; ++r) {
    const float va = combine_warps<SUM, KT>(x + r * warps<KT>());
    const float vb = combine_warps<SUM, KT>(x + X + r * warps<KT>());
    a = SUM ? a + va : fmaxf(a, va);
    b = SUM ? b + vb : fmaxf(b, vb);
  }
}

// How far a group's phases reach: its own block, the cluster pair or a
// C-block cluster; the block's place there.
enum class Span { kGroup, kPair, kCluster };
template <Span S>
using Link = std::conditional_t<S == Span::kCluster, Cluster, Pair>;

// A group's shift and its reductions, alone (on its named barrier), in the
// cluster pair or in a C-block cluster (`id` the shift's halo: the two
// shifts by one at 0 and 1, pass id - 2 of a chain of `passes`), as the step
// of either template takes them.
template <int PER, int KT, Span S>
__device__ __forceinline__ void step_shift(const float (&v)[PER], float (&out)[PER], int s,
                                           float fill, float* buf, int t, int bar, Link<S>& pr,
                                           int id, int passes) {
  constexpr int kSmall = small_passes<PER>();
  if constexpr (S == Span::kPair) {
    pair_shift<PER, KT>(v, out, s, fill, buf, t, bar, pr, id, id - 2 - kSmall, passes - kSmall);
  } else if constexpr (S == Span::kCluster) {
    cluster_shift<PER, KT>(v, out, s, fill, buf, t, bar, pr, id, id - 2 - kSmall,
                           passes - kSmall);
  } else {
    shift<PER, KT>(v, out, s, fill, buf, t, bar);
  }
}

template <bool SUM, int KT, Span S>
__device__ __forceinline__ float step_reduce(float v, float* red, int t, int bar, Link<S>& pr) {
  if constexpr (S == Span::kPair) {
    return pair_reduce<SUM, KT>(v, t, pr);
  } else if constexpr (S == Span::kCluster) {
    return cluster_reduce<SUM, KT>(v, t, pr);
  } else {
    return group_reduce<SUM, KT>(v, red, t, bar);
  }
}

// The backward pass's shift toward lower j (shift_up and its mirrors; `id`
// as step_shift's) and its reductions: the two sums of a step in one
// exchange (group_sum2 alone, `red` its 2 * KT / 32 floats), and the
// rescale max (group_reduce alone; in a cluster the two-value exchange,
// whose slots the backward pass's area lays out).
template <int PER, int KT, Span S>
__device__ __forceinline__ void step_shift_up(const float (&v)[PER], float (&out)[PER], int s,
                                              float fill, float* buf, int t, int bar,
                                              Link<S>& pr, int id, int passes) {
  constexpr int kSmall = small_passes<PER>();
  if constexpr (S == Span::kPair) {
    pair_shift_up<PER, KT>(v, out, s, fill, buf, t, bar, pr, id, id - 2 - kSmall,
                           passes - kSmall);
  } else if constexpr (S == Span::kCluster) {
    cluster_shift_up<PER, KT>(v, out, s, fill, buf, t, bar, pr, id, id - 2 - kSmall,
                              passes - kSmall);
  } else {
    shift_up<PER, KT>(v, out, s, fill, buf, t, bar);
  }
}

template <int KT, Span S>
__device__ __forceinline__ void step_sum2(float& a, float& b, float* red, int t, int bar,
                                          Link<S>& pr) {
  if constexpr (S == Span::kPair) {
    pair_reduce2<true, KT>(a, b, t, pr);
  } else if constexpr (S == Span::kCluster) {
    cluster_reduce2<true, KT>(a, b, t, pr);
  } else {
    group_sum2<KT>(a, b, red, t, bar);
  }
}

template <int KT, Span S>
__device__ __forceinline__ float step_max2(float v, float* red, int t, int bar, Link<S>& pr) {
  if constexpr (S == Span::kGroup) {
    return group_reduce<false, KT>(v, red, t, bar);
  } else {
    float w = v;
    if constexpr (S == Span::kPair) {
      pair_reduce2<false, KT>(v, w, t, pr);
    } else {
      cluster_reduce2<false, KT>(v, w, t, pr);
    }
    return v;
  }
}

// A cluster block's copy of its slice of emission rows `aa` of the [20,
// m_pad] tables (f32, or the filter's bf16 bits): states col0 .. col0 +
// m_real - 1, as prefetch_emissions and prefetch_emissions_bf16 copy a whole
// row (the slice starts on a 16-byte boundary: col0 = r * KT * PER and
// m_pad are multiples of 8). `h` is the block's Pair or Cluster. The caller
// commits.
template <int PER, int KT, typename E, typename H>
__device__ __forceinline__ void prefetch_half(E* dm, E* di, const E* msc, const E* isc, int aa,
                                              int m_pad, const H& h, int t) {
  const E* gm = msc + static_cast<size_t>(aa) * m_pad + h.col0;
  const E* gi = isc + static_cast<size_t>(aa) * m_pad + h.col0;
  constexpr bool kF32 = sizeof(E) == 4;
  constexpr int kVec = 16 / sizeof(E);  // entries a 16-byte copy
  if constexpr (kF32 ? (PER & 1) != 0 : hstride<PER>() == PER) {
    for (int c = t; c < h.m_real / kVec; c += KT) {
      cp_async16(dm + kVec * c, gm + kVec * c);
      cp_async16(di + kVec * c, gi + kVec * c);
    }
  } else if constexpr (kF32) {
    for (int j = t; j < h.m_real; j += KT) {
      cp_async4(dm + sidx<PER>(j), gm + j);
      cp_async4(di + sidx<PER>(j), gi + j);
    }
  } else {
    for (int j = 2 * t; j < h.m_real; j += 2 * KT) {
      cp_async4(dm + hidx<PER>(j), gm + j);
      cp_async4(di + hidx<PER>(j), gi + j);
    }
  }
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
// from the block's staged rows (q < n_trans, which the plan makes all six
// at KT = 128) or, in a block of the cluster of 256-thread blocks, from the
// block's slice of their thread-major copy in global memory ([kTransRows +
// window][PER][KT], entry (q, k, t) row q at the block's state t * PER + k:
// a warp's read of one slot is 32 contiguous floats), at this thread's t.
template <int PER, int KT>
struct TransRows {
  const float* staged;  // the block's staged rows, at this thread's offset
  const float* tm;      // the thread-major copy, at this thread (KT != 128)
  int n_trans;

  __device__ __forceinline__ float operator()(int q, int k) const {
    if (KT == 128 || q < n_trans) return staged[q * row_floats<PER, KT>() + k];
    return __ldg(tm + (q * PER + k) * KT);
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

// The launch of a cluster kernel (the pair, c = 2, or a C-block cluster):
// `grid` blocks of `threads` (128, or a cluster of wide blocks'
// kBlockThreads) in clusters of c along x (cudaLaunchKernelEx), after
// setting the kernel's shared-memory limit and its leave to take a
// non-portable cluster size (past 8 blocks) once per device; a refused
// launch returns its error.
inline cudaLaunchConfig_t cluster_config(int grid, int c, int smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr, int threads = 128) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
cudaError_t allow_cluster(Kernel kernel, int device, unsigned& done) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if ((done >> device) & 1u) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) done |= 1u << device;
  return err;
}

template <typename Args>
cudaError_t launch_cluster(void (*kernel)(Args), const Args& a, int device, unsigned& done, int c,
                           int grid, int smem, cudaStream_t stream, int threads = 128) {
  cudaError_t err = allow_cluster(kernel, device, done);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, c, smem, stream, &attr, threads);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The most clusters of c blocks of a cluster kernel the card `device` runs
// at once with `smem` bytes of dynamic shared memory a block
// (cudaOccupancyMaxActiveClusters, for the launch plan's persistent grid;
// 0 when it holds none).
template <typename Args>
cudaError_t cluster_max_clusters(void (*kernel)(Args), int device, unsigned& done, int c,
                                 int smem, int* out, int threads = 128) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = allow_cluster(kernel, device, done);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(c, c, smem, nullptr, &attr, threads);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
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

// Calls fn(Case<per, 128>{}) for the kernel cases a source instantiates:
// 128 threads a group with 1..19 states a thread (every wider case runs on
// the cluster pair or a C-block cluster).
#define P7_CASE(P, T) \
  case P:             \
    return fn(Case<P, T>{});

template <template <int, int> class Case, typename Fn>
cudaError_t with_group_case(int per, Fn fn) {
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
#undef P7_CASE

// Calls fn(Case<per>{}) for the cluster pair's cases (p7_viterbi.cuh,
// p7_forward_kernel.cu, p7_backward_kernel.cu): 128 threads a block, 10..19
// states a thread, 2 * 128 * per states a pair.
#define P7_PAIR_CASE(P) \
  case P:               \
    return fn(Case<P>{});

template <template <int> class Case, typename Fn>
cudaError_t with_pair_case(int per, Fn fn) {
  switch (per) {
    P7_PAIR_CASE(10)
    P7_PAIR_CASE(11)
    P7_PAIR_CASE(12)
    P7_PAIR_CASE(13)
    P7_PAIR_CASE(14)
    P7_PAIR_CASE(15)
    P7_PAIR_CASE(16)
    P7_PAIR_CASE(17)
    P7_PAIR_CASE(18)
    P7_PAIR_CASE(19)
    default:
      return cudaErrorInvalidValue;
  }
}
#undef P7_PAIR_CASE
constexpr int kPairSlots = 10;  // per-case tables of the pair: [per - 10]

// Calls fn(Case<per>{}) for the C-block cluster's cases (p7_viterbi.cuh,
// p7_forward_kernel.cu, p7_backward_kernel.cu): 128 threads a block, 13..19
// states a thread (C >= 3 blocks of 128 * per states cover M_pad > 4864
// only from per 13 on).
#define P7_CLUSTER_CASE(P) \
  case P:                  \
    return fn(Case<P>{});

template <template <int> class Case, typename Fn>
cudaError_t with_cluster_case(int per, Fn fn) {
  switch (per) {
    P7_CLUSTER_CASE(13)
    P7_CLUSTER_CASE(14)
    P7_CLUSTER_CASE(15)
    P7_CLUSTER_CASE(16)
    P7_CLUSTER_CASE(17)
    P7_CLUSTER_CASE(18)
    P7_CLUSTER_CASE(19)
    default:
      return cudaErrorInvalidValue;
  }
}
#undef P7_CLUSTER_CASE
constexpr int kClusterSlots = 7;  // per-case tables of the C-block cluster: [per - 13]

// -- the C-block cluster of 256-thread blocks ------------------------------------
//
// Past kMaxCluster * 2432 = 38,912 states (up to the chain's 65536) the
// Forward template's cases (the plain Forward and the row-saving one), the
// backward pass and the Viterbi filter
// (p7_forward_kernel.cu::forward_wide_cluster_kernel,
// p7_backward_kernel.cu::backward_wide_cluster_kernel,
// p7_viterbi.cuh::viterbi_wide_cluster_kernel) run one sequence on
// C groups of KT = kWideClusterThreads threads, one in each block of a
// C-block cluster: the C-block cluster's step and primitives above at KT =
// 256 (every one of them is templated on KT), block r owning the states r *
// KT * PER + t * PER + k. The launch plan takes C = ceil(M_pad / (KT *
// kWideClusterPerMax)), 9..14, and per the smallest that covers M_pad,
// kWideClusterPerMin..kWideClusterPerMax. A reduction combines each block's
// eight warps as a group of 256 does (combine_warps), then the blocks in
// rank order. A row of 256 * stride(PER) floats is twice a 128-thread
// group's, so beside the group and the cluster's area a block stages what
// fits of the transition rows (then chain rows); the kernels read the rest
// from the block's slice of their thread-major copy, which the launcher
// passes (ops/p7_cuda.py::block_rows at 256 threads, fill 0 for the
// probability-space kinds, -inf for the filter: TransRows, the chain's
// fallback). The C entries name
// the case by `threads` kWideClusterThreads and `cluster` C.
constexpr int kWideClusterThreads = 256;
constexpr int kWideClusterPerMin = 17;  // ceil(38,920 / (9 * kWideClusterThreads))
constexpr int kWideClusterPerMax = 19;

#define P7_WIDE_CLUSTER_CASE(P) \
  case P:                       \
    return fn(Case<P>{});

template <template <int> class Case, typename Fn>
cudaError_t with_wide_cluster_case(int per, Fn fn) {
  switch (per) {
    P7_WIDE_CLUSTER_CASE(17)
    P7_WIDE_CLUSTER_CASE(18)
    P7_WIDE_CLUSTER_CASE(19)
    default:
      return cudaErrorInvalidValue;
  }
}
#undef P7_WIDE_CLUSTER_CASE
// per-case tables of the cluster of 256-thread blocks: [per - kWideClusterPerMin]
constexpr int kWideClusterSlots = kWideClusterPerMax - kWideClusterPerMin + 1;

// The launch shape of a block of such a cluster: c of 2..kMaxCluster blocks
// of c * KT * PER >= m_pad states, one group a block, a grid of whole
// clusters, at most the six transition rows staged (the rest read from
// global memory).
inline bool wide_cluster_ok(int m_pad, int per, int c, int groups, int grid, int n_trans) {
  return c >= 2 && c <= kMaxCluster && m_pad <= c * kWideClusterThreads * per && groups == 1 &&
         grid >= c && grid % c == 0 && n_trans >= 0 && n_trans <= kTransRows;
}

// Index of a group case in per-case tables.
__host__ inline int case_slot(int per) { return per - 1; }
constexpr int kCaseSlots = 19;

// -- the wide block -------------------------------------------------------------
//
// Past 2 * 2432 = 4864 states, up to kBlockThreads * kBlockPerMax, the eager
// and log-space cases (p7_viterbi.cuh::viterbi_block_kernel) run one group
// of KT = kBlockThreads threads a block, one sequence a block, in the
// normal-width layout: thread t holds states t * PER + k in registers, a
// shift below PER moves registers and a halo and a larger one reads the
// whole row from shared memory after the block's barrier, as a group of 128
// does. Its dynamic shared memory, in floats: n_rows staged rows (the
// transitions first, then chain rows, as many as fit), then the group: two
// shift rows, the current step's (match, insert) emission rows (one step,
// not two: the next step's are copied in once the second shift has passed
// the last reader), the reduction scratch and the token chunk. The rows left
// unstaged are read from their thread-major copy in global memory. The C
// entries name the case by `cluster` 0 (the rows-in-memory case has
// kMemThreads = 1024 threads too). kBlockPerMax is the widest case whose
// rows the block's registers hold: at 64 registers a thread every case
// from 6 states a thread spills a little, about 100 bytes a thread at most
// up to 9 and twice that from 10 on (-Xptxas -v, PERF.md).
constexpr int kBlockThreads = 1024;
constexpr int kBlockPerMin = 5;  // ceil(4865 / kBlockThreads)
constexpr int kBlockPerMax = 9;

template <int PER, int KT>
__host__ __device__ constexpr size_t block_smem_floats(int n_rows) {
  return static_cast<size_t>(n_rows + 4) * row_floats<PER, KT>() + red_floats<KT>() +
         kChunk / 4;
}

// Calls fn(Case<per>{}) for the wide block's cases (p7_viterbi_kernel.cu,
// p7_forward_log_kernel.cu): kBlockPerMin..kBlockPerMax states a thread.
#define P7_BLOCK_CASE(P) \
  case P:                \
    return fn(Case<P>{});

template <template <int> class Case, typename Fn>
cudaError_t with_block_case(int per, Fn fn) {
  switch (per) {
    P7_BLOCK_CASE(5)
    P7_BLOCK_CASE(6)
    P7_BLOCK_CASE(7)
    P7_BLOCK_CASE(8)
    P7_BLOCK_CASE(9)
    default:
      return cudaErrorInvalidValue;
  }
}
#undef P7_BLOCK_CASE
// per-case tables of the wide block: [per - kBlockPerMin]
constexpr int kBlockSlots = kBlockPerMax - kBlockPerMin + 1;

// -- the cluster of wide blocks ------------------------------------------------
//
// Past kBlockThreads * kBlockPerMax = 9216 states (up to the chain's 65536)
// the eager and log-space cases, and past 32,768 the lazy one with its
// whole-chain step (p7_viterbi.cuh::viterbi_block_cluster_kernel) run one
// sequence on C wide blocks of kBlockThreads threads, one in each block
// of a C-block cluster (C of 2..kMaxBlockCluster, read from
// %cluster_nctarank), block r owning the states r * kBlockThreads * PER +
// t * PER + k, the wide block's layout of its slice, PER of
// kBlockClusterPerMin..kBlockClusterPerMax (the launch plan takes the
// smallest C whose PER is at most 8, so 8 * 1024 * 8 = 65536 states fit). Its
// shifts and E cross the cluster as the C-block clusters' do (halos below
// PER, the larger shifts' rows and releases, the exchanges; the header of
// the C-block cluster), each taken in place as the wide block takes it, a
// row's release sent after the next larger shift's barrier rather than
// after one of its own, on an mbarrier of its use rather than of its row
// (p7_viterbi.cuh::wide_cluster_big). The C entries
// name the case by `threads` kBlockThreads and `cluster` C >= 2. Its
// dynamic shared memory is the wide block's (block_smem_floats) and then the
// cluster's area (cluster_floats at kBlockThreads: two landing rows, the
// exchange slots of 32 warps a block, the halos and the mbarriers): at 8
// states a thread six rows of 36,864 bytes and no staged row; the rows
// left unstaged are read from the block's slice of the thread-major copy.
constexpr int kBlockClusterPerMin = 5;  // ceil(9217 / (2 * kBlockThreads))
constexpr int kBlockClusterPerMax = 8;

template <int PER, int KT>
__host__ __device__ constexpr size_t block_cluster_smem_floats(int n_rows) {
  return block_smem_floats<PER, KT>(n_rows) + cluster_floats<PER, KT>();
}

// Calls fn(Case<per>{}) for the cluster of wide blocks' cases
// (p7_viterbi_kernel.cu, p7_forward_log_kernel.cu):
// kBlockClusterPerMin..kBlockClusterPerMax states a thread.
#define P7_BLOCK_CLUSTER_CASE(P) \
  case P:                        \
    return fn(Case<P>{});

template <template <int> class Case, typename Fn>
cudaError_t with_block_cluster_case(int per, Fn fn) {
  switch (per) {
    P7_BLOCK_CLUSTER_CASE(5)
    P7_BLOCK_CLUSTER_CASE(6)
    P7_BLOCK_CLUSTER_CASE(7)
    P7_BLOCK_CLUSTER_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
}
#undef P7_BLOCK_CLUSTER_CASE
// per-case tables of the cluster of wide blocks: [per - kBlockClusterPerMin]
constexpr int kBlockClusterSlots = kBlockClusterPerMax - kBlockClusterPerMin + 1;

// -- the rows-in-memory case --------------------------------------------------
//
// Past 38,912 states for the Viterbi filter (up to 65536, the 16-row
// chain), and for every other kind on a card that holds no cluster of its
// wide or 256-thread blocks, no launch plan here holds the DP rows in
// registers. One block of
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
