// The full-profile Viterbi step and its log-space Forward semiring twin,
// written by hand for Hopper (sm_90a): the kernel template shared by
// p7_viterbi_kernel.cu (the eager and lazy Viterbi cases) and
// p7_forward_log_kernel.cu (the log-space Forward case). Each source
// instantiates its own cases, so the two compile side by side.
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_p7.py::_p7_kernel in Viterbi
// mode (the eager kernel) and in Forward mode (forward=True, the log-space
// semiring), and ::_p7_lazy_kernel (the lazy one), all launched by
// p7_pallas_call. For every residue t < length of a sequence, with M, I, D
// rows over the Mr match states and (+) the semiring's combine (max for
// Viterbi, logaddexp for Forward):
//     M_j = msc[tok][j] + ((pre_diag_{j-1}) (+) (B + tr_B_Mk))
//           pre_diag = ((M + tmm) (+) (I + tim)) (+) (D + tdm)
//     I_j = isc[tok][j] + ((M_j + tmi) (+) (I_j + tii))     (old M, I)
//     D_j = (M_{j-1} + tmd_{j-1}) (+) (D_{j-1} + tdd_{j-1}) (new M)
//     E   = reduce_j (M_j (+) D_j);  J = (J + tr_loop) (+) (E + tr_E_J),
//     C likewise with tr_E_C, N = N + tr_loop, B = (N + tr_move) (+)
//     (J + tr_move); score C + tr_move.
// The delete chain runs as the TPU kernel runs it: ceil(log2 M_pad)
// Hillis-Steele passes a <- a (+) (a[j - 2^k] + chain[k][j]) with the host's
// constants. In Viterbi mode every float32 operation is a max or one add with
// the JAX kernel's operands, so the scores equal its scores and the plain
// PyTorch version's (ops/p7_cuda.py) bit for bit. The lazy kernel runs
// lazy_k passes, checks the per-row certificate ((E + tmd_max) + Cmax_j) +
// tdm_j > pre_diag_j on every step, ORs it over a 128-residue chunk and,
// when it fired, replays the chunk from its entry state with the full chain;
// its D slot carries pre_diag. It needs tmd, tdd <= 0 (e_skip_d_ok), where
// E = max_j M_j exactly.
//
// In Forward mode the combine is JAX's _lse2: mx + log1p(exp(min - mx)),
// with (-inf, -inf) giving -inf and never NaN, and E is _lse_reduce0 over
// x_j = M_j (+) D_j: a group max mx, then a group sum of exp(x_j - mx) in a
// fixed order (x_j == mx contributes exp(0), so an all -inf row stays -inf),
// E = mx + log(sum). The sum runs over each thread's contiguous states in
// order, then a warp butterfly, then the four warps: another fixed order
// than the plain version's and the TPU's, so the kernel differs from them
// by the rounding of that sum and of the accurate expf, log1pf and logf
// (no --use_fast_math, no __expf).
//
// What bounds it on the H100: one sequence's step cannot start before the
// last one is complete (the j-1 diagonal), and the delete chain is a prefix
// scan along the states, so each step is a chain of phases that cross
// threads: lazy 8 barriers (2 shifts by one, 5 passes, E), eager 14, the
// log-space case 15. Per cell the lazy step does about 27 FP32 operations
// and reads 12 step-invariant constants (6 transitions, 5 chain rows,
// Cmax) and 2 emissions; the eager step 36 operations and 19 constants.
// With the constants in L1/L2 (360 KB at M_pad = 1408, more than an SM's
// 256 KB of L1 and shared memory) a 128-thread block per sequence spent
// about 17,900 cycles a residue step per wave: the constants' traffic to
// L2, not FP32 throughput. Held in shared memory, the constants' reads are
// bounded by its 128 bytes a cycle per SM instead (about 84 bytes a cell
// in the lazy case, constants, emissions and shifts together), and the
// step's latency is hidden by as many sequences as share an SM: measured
// at 4096 x 3500 x 1400, lazy 105, 108, 84 and 71 ms with 1 to 4 groups a
// block. The log-space case is bound by its 16 accurate logaddexps a cell
// (expf and log1pf) instead.
//
// What the design does about it (p7_blocked.cuh has the layout):
//  * The block stages the rows the case reads every step into shared
//    memory once: tmm tmi tmd tim tii tdm, the first n_chain chain rows
//    (all the passes the case runs, unless that would not fit: the
//    launcher's plan says how many) and, for the lazy certificate, Cmax;
//    the remaining passes (the lazy replay's, or a wide eager profile's
//    last) read the chain from global memory. Every staged read is an
//    unpredicated, conflict-free shared load; states past M_pad read the
//    fill -inf and stay -inf.
//  * G groups of 128 threads share the staged rows, one sequence each, and
//    synchronise on their own named barriers; the grid is persistent (the
//    launcher's plan) and walks the batch with a stride. G = 1 for a batch
//    no larger than the SMs, so a survivor batch pays one step's latency;
//    a full batch takes as many groups as registers and shared memory
//    allow (4 at 1400.hmm: 128 registers a thread, 199-232 KB a block).
//  * Thread t owns the contiguous states t * PER + k. A shift by s < PER
//    moves registers and passes only the last s slots through shared
//    memory; a larger shift reads the whole row at j - s. One barrier a
//    shift, two alternating buffers.
//  * The emission rows of step t + 1 are copied into the group's shared
//    memory with cp.async while step t runs; the first barrier of step t+1
//    publishes them. (Read with __ldg in the blocked layout instead, each
//    warp load spans 11 lines: 8-13% slower at 4096 rows, measured.)
//  * E is a warp butterfly and a 4-entry shared reduction a group (two of
//    them, the max and the sum, in Forward mode).
//  * The carries cross global memory as [B, M_pad] rows, coalesced through
//    a shift buffer: at the start and end of a sequence, and, for the lazy
//    kernel, at each chunk entry (saved in the output carries) and on a
//    fire (loaded back). The fire is a group-scoped bar.red.or; fires are
//    counted per sequence. The specials stay in registers.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise. The C entry points return cudaGetLastError().

#pragma once

#include "p7_blocked.cuh"

namespace {

struct ViterbiArgs {
  const float* msc;    // [20, m_pad]
  const float* isc;    // [20, m_pad]
  const float* trans;  // [8, m_pad]: tmm tmi tmd tim tii tdm tdd_s pad
  const float* chain;  // [16, m_pad]: pass constants; row 15 = Cmax (lazy)
  int m_pad;
  int n_passes;
  int k_run;    // passes of the certified schedule (lazy)
  int n_chain;  // chain rows staged in shared memory
  const int8_t* tokens;  // [b_pad, l_pad]
  int l_pad;
  const int* lengths;    // [b_pad]
  const float* tr_rows;  // [2, b_pad]: tr_loop, tr_move
  const float* consts;   // [3] or [5]: tr_B_Mk, tr_E_C, tr_E_J, aux, tmd_max
  const float* m_in;     // [b_pad, m_pad]
  const float* i_in;
  const float* d_in;
  const float* s_in;     // [4, b_pad]: J, C, N, B
  float* scores;         // [b_pad]
  float* m_out;
  float* i_out;
  float* d_out;
  float* s_out;
  int* replays;          // [b_pad] (lazy)
  int b_pad;
};

// The semiring's combine: max (Viterbi) or JAX's _lse2 (log-space Forward).
template <bool LSE>
__device__ __forceinline__ float combine(float x, float y) {
  if (!LSE) return fmaxf(x, y);
  const float mx = fmaxf(x, y);
  const float d = fminf(x, y) - mx;
  return isnan(d) ? mx : mx + log1pf(expf(d));  // NaN only at (-inf, -inf)
}

// A group's shared memory: buffers addressed by parity, never through an
// array indexed at run time (which would live in local memory).
template <int PER>
struct GroupSmem {
  float* base;  // two shift buffers, then (match, insert) emissions of even and odd steps
  float* red;   // 2 * kWarps
  int8_t* toks;  // kChunk

  __device__ __forceinline__ float* xbuf(int par) const { return base + par * row_floats<PER>(); }
  __device__ __forceinline__ float* em(int q) const {
    return base + (2 + 2 * q) * row_floats<PER>();
  }
  __device__ __forceinline__ float* ei(int q) const {
    return base + (3 + 2 * q) * row_floats<PER>();
  }
};

template <int PER>
__device__ __forceinline__ GroupSmem<PER> group_smem(float* base) {
  constexpr int ROW = row_floats<PER>();
  GroupSmem<PER> s;
  s.base = base;
  s.red = base + 6 * ROW;
  s.toks = reinterpret_cast<int8_t*>(base + 6 * ROW + kRed);
  return s;
}

// The group's state: rows in registers, specials replicated in every thread.
template <int PER>
struct Rows {
  float m[PER];
  float i[PER];
  float d[PER];  // D (eager, Forward) or pre_diag (lazy)
  float sj, sc, sn, sb;
};

// Steps [0, count) of the chunk whose tokens are in gs.toks. Returns whether
// the certificate fired (CERT only). `cs` is the block's staged rows.
template <int PER, bool LAZY, bool LSE, bool CERT>
__device__ __forceinline__ bool run_chunk(const ViterbiArgs& a, const float* cs,
                                          const GroupSmem<PER>& gs, Rows<PER>& r, int count,
                                          int passes, int& par, float tr_loop, float tr_move,
                                          int t, int bar) {
  static_assert(!(LAZY && LSE), "the lazy schedule is Viterbi only");
  constexpr int ROW = row_floats<PER>();
  const int m_pad = a.m_pad;
  const float ninf = neg_inf();
  const float tr_b_mk = a.consts[0];
  const float tr_e_c = a.consts[1];
  const float tr_e_j = a.consts[2];
  const float tmd_max = LAZY ? a.consts[4] : 0.0f;
  const int off = t * stride<PER>();
  const float* tmm = cs + off;
  const float* tmi = cs + ROW + off;
  const float* tmd = cs + 2 * ROW + off;
  const float* tim = cs + 3 * ROW + off;
  const float* tii = cs + 4 * ROW + off;
  const float* tdm = cs + 5 * ROW + off;
  const float* chain_s = cs + 6 * ROW + off;
  const float* cmax = cs + (6 + a.n_chain) * ROW + off;
  bool viol = false;

  prefetch_emissions<PER>(gs.em(0), gs.ei(0), a.msc, a.isc, token(gs.toks, 0), m_pad, t);
  cp_async_commit();
  for (int step = 0; step < count; ++step) {
    const int q = step & 1;
    if (step + 1 < count) {
      prefetch_emissions<PER>(gs.em(q ^ 1), gs.ei(q ^ 1), a.msc, a.isc,
                              token(gs.toks, step + 1), m_pad, t);
    }
    cp_async_commit();

    // the j-1 diagonal: pre_diag of the previous step, shifted by one
    float pd[PER];
    if (LAZY) {
#pragma unroll
      for (int k = 0; k < PER; ++k) pd[k] = r.d[k];
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        pd[k] = combine<LSE>(combine<LSE>(r.m[k] + tmm[k], r.i[k] + tim[k]), r.d[k] + tdm[k]);
      }
    }
    cp_async_wait_prev();  // this step's emission rows (the barrier publishes them)
    float diag[PER];
    shift<PER>(pd, diag, 1, ninf, gs.xbuf(par), t, bar);
    par ^= 1;

    const float* ms = gs.em(q) + off;
    const float* is = gs.ei(q) + off;
    const float bt = r.sb + tr_b_mk;
    float nm[PER], ni[PER], ac[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      nm[k] = ms[k] + combine<LSE>(diag[k], bt);
      ni[k] = is[k] + combine<LSE>(r.m[k] + tmi[k], r.i[k] + tii[k]);
      pd[k] = nm[k] + tmd[k];
    }
    shift<PER>(pd, ac, 1, ninf, gs.xbuf(par), t, bar);
    par ^= 1;
    for (int p = 0; p < passes; ++p) {
      float sh[PER];
      shift<PER>(ac, sh, 1 << p, ninf, gs.xbuf(par), t, bar);
      par ^= 1;
      if (p < a.n_chain) {
        const float* c = chain_s + p * ROW;
#pragma unroll
        for (int k = 0; k < PER; ++k) ac[k] = combine<LSE>(ac[k], sh[k] + c[k]);
      } else {
        const float* c = a.chain + static_cast<size_t>(p) * m_pad;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int j = t * PER + k;
          ac[k] = combine<LSE>(ac[k], sh[k] + (j < m_pad ? __ldg(c + j) : ninf));
        }
      }
    }

    float e = ninf;
    if (LSE) {
      float x[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        x[k] = combine<true>(nm[k], ac[k]);
        e = fmaxf(e, x[k]);
      }
      const float mx = group_reduce<false>(e, gs.red, t, bar);
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < PER; ++k) sum += expf(x[k] == mx ? 0.0f : x[k] - mx);
      e = mx + logf(group_reduce<true>(sum, gs.red + kWarps, t, bar));
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) e = fmaxf(e, LAZY ? nm[k] : fmaxf(nm[k], ac[k]));
      e = group_reduce<false>(e, gs.red, t, bar);
    }

#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (LAZY) {
        const float stay = fmaxf(nm[k] + tmm[k], ni[k] + tim[k]);
        const float npd = fmaxf(stay, ac[k] + tdm[k]);
        if (CERT) {
          // the bound's own rounding path, in this order
          const float t_row = ((e + tmd_max) + cmax[k]) + tdm[k];
          viol |= t_row > npd;
        }
        r.d[k] = npd;
      } else {
        r.d[k] = ac[k];
      }
      r.m[k] = nm[k];
      r.i[k] = ni[k];
    }
    r.sj = combine<LSE>(r.sj + tr_loop, e + tr_e_j);
    r.sc = combine<LSE>(r.sc + tr_loop, e + tr_e_c);
    r.sn = r.sn + tr_loop;
    r.sb = combine<LSE>(r.sn + tr_move, r.sj + tr_move);
  }
  return viol;
}

template <int PER>
__device__ __forceinline__ void store_carries(const Rows<PER>& r, float* m, float* i, float* d,
                                              int m_pad, float* buf, int t, int bar) {
  store_row<PER>(r.m, m, m_pad, buf, t, bar);
  store_row<PER>(r.i, i, m_pad, buf, t, bar);
  store_row<PER>(r.d, d, m_pad, buf, t, bar);
}

template <int PER>
__device__ __forceinline__ void load_carries(Rows<PER>& r, const float* m, const float* i,
                                             const float* d, int m_pad, float* buf, int t,
                                             int bar) {
  const float ninf = neg_inf();
  load_row<PER>(r.m, m, m_pad, ninf, buf, t, bar);
  load_row<PER>(r.i, i, m_pad, ninf, buf, t, bar);
  load_row<PER>(r.d, d, m_pad, ninf, buf, t, bar);
}

// Rows of shared memory the block stages: 6 transitions, n_chain chain
// rows and, when the lazy kernel certifies, Cmax.
__host__ __device__ inline int viterbi_rows(bool lazy, int k_run, int n_passes, int n_chain) {
  return 6 + n_chain + ((lazy && k_run < n_passes) ? 1 : 0);
}

template <int PER, bool LAZY, bool LSE>
__global__ void viterbi_kernel(const ViterbiArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ROW = row_floats<PER>();
  const int m_pad = a.m_pad;
  const float ninf = neg_inf();
  const bool certify = LAZY && a.k_run < a.n_passes;
  const int n_rows = viterbi_rows(LAZY, a.k_run, a.n_passes, a.n_chain);

  for (int q = 0; q < 6; ++q) stage_row<PER>(smem + q * ROW, a.trans + q * m_pad, m_pad, ninf);
  for (int p = 0; p < a.n_chain; ++p) {
    stage_row<PER>(smem + (6 + p) * ROW, a.chain + p * m_pad, m_pad, ninf);
  }
  if (certify) stage_row<PER>(smem + (6 + a.n_chain) * ROW, a.chain + 15 * m_pad, m_pad, ninf);

  const int groups = blockDim.x / kThreads;
  const int g = threadIdx.x / kThreads;
  const int t = threadIdx.x % kThreads;
  const int bar = 1 + g;
  const GroupSmem<PER> gs =
      group_smem<PER>(smem + n_rows * ROW + g * (6 * ROW + kRed + kChunk / 4));
  for (int q = 0; q < 2; ++q) {
    fill_tail<PER>(gs.em(q), m_pad, ninf, t);
    fill_tail<PER>(gs.ei(q), m_pad, ninf, t);
  }
  __syncthreads();  // the staged rows; from here on each group keeps to itself

  const int b_pad = a.b_pad;
  for (int seq = blockIdx.x * groups + g; seq < b_pad; seq += gridDim.x * groups) {
    const size_t row = static_cast<size_t>(seq) * m_pad;
    Rows<PER> r;
    load_carries<PER>(r, a.m_in + row, a.i_in + row, a.d_in + row, m_pad, gs.xbuf(0), t, bar);
    r.sj = a.s_in[seq];
    r.sc = a.s_in[b_pad + seq];
    r.sn = a.s_in[2 * b_pad + seq];
    r.sb = a.s_in[3 * b_pad + seq];
    const float tr_loop = a.tr_rows[seq];
    const float tr_move = a.tr_rows[b_pad + seq];
    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
    int par = 0;
    int replays = 0;

    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int count = min(kChunk, n - c0);
      if (t < count) gs.toks[t] = tok_row[c0 + t];  // the last chunk's readers passed barriers
      group_sync(bar);
      if (certify) {
        store_carries<PER>(r, a.m_out + row, a.i_out + row, a.d_out + row, m_pad, gs.xbuf(0), t,
                           bar);  // the chunk's entry
        const float ej = r.sj, ec = r.sc, en = r.sn, eb = r.sb;
        const bool viol = run_chunk<PER, LAZY, LSE, true>(a, smem, gs, r, count, a.k_run, par,
                                                          tr_loop, tr_move, t, bar);
        if (group_any(bar, viol)) {
          load_carries<PER>(r, a.m_out + row, a.i_out + row, a.d_out + row, m_pad, gs.xbuf(0),
                            t, bar);
          r.sj = ej;
          r.sc = ec;
          r.sn = en;
          r.sb = eb;
          run_chunk<PER, LAZY, LSE, false>(a, smem, gs, r, count, a.n_passes, par, tr_loop,
                                           tr_move, t, bar);
          ++replays;
        }
      } else {
        run_chunk<PER, LAZY, LSE, false>(a, smem, gs, r, count, a.n_passes, par, tr_loop,
                                         tr_move, t, bar);
      }
      group_sync(bar);  // every step's reads of the shift buffers and toks are done
    }

    store_carries<PER>(r, a.m_out + row, a.i_out + row, a.d_out + row, m_pad, gs.xbuf(0), t,
                       bar);
    if (t == 0) {
      a.s_out[seq] = r.sj;
      a.s_out[b_pad + seq] = r.sc;
      a.s_out[2 * b_pad + seq] = r.sn;
      a.s_out[3 * b_pad + seq] = r.sb;
      a.scores[seq] = r.sc + tr_move;
      if (LAZY) a.replays[seq] = replays;
    }
  }
}

// The pointer arguments of both C entry points, in their order.
inline ViterbiArgs make_args(const void* msc, const void* isc, const void* trans,
                             const void* chain, int m_pad, int n_passes, int k_run, int n_chain,
                             const void* tokens, int l_pad, const void* lengths,
                             const void* tr_rows, const void* consts, const void* m_in,
                             const void* i_in, const void* d_in, const void* s_in,
                             void* scores, void* m_out, void* i_out, void* d_out, void* s_out,
                             void* replays, int b_pad) {
  ViterbiArgs a;
  a.msc = static_cast<const float*>(msc);
  a.isc = static_cast<const float*>(isc);
  a.trans = static_cast<const float*>(trans);
  a.chain = static_cast<const float*>(chain);
  a.m_pad = m_pad;
  a.n_passes = n_passes;
  a.k_run = k_run;
  a.n_chain = n_chain;
  a.tokens = static_cast<const int8_t*>(tokens);
  a.l_pad = l_pad;
  a.lengths = static_cast<const int*>(lengths);
  a.tr_rows = static_cast<const float*>(tr_rows);
  a.consts = static_cast<const float*>(consts);
  a.m_in = static_cast<const float*>(m_in);
  a.i_in = static_cast<const float*>(i_in);
  a.d_in = static_cast<const float*>(d_in);
  a.s_in = static_cast<const float*>(s_in);
  a.scores = static_cast<float*>(scores);
  a.m_out = static_cast<float*>(m_out);
  a.i_out = static_cast<float*>(i_out);
  a.d_out = static_cast<float*>(d_out);
  a.s_out = static_cast<float*>(s_out);
  a.replays = static_cast<int*>(replays);
  a.b_pad = b_pad;
  return a;
}

// Checks both entry points share: the operands' limits and the plan.
template <int PER>
bool viterbi_plan_ok(const ViterbiArgs& a, bool lazy, int groups, int grid, int smem_bytes) {
  const int passes_run = lazy ? a.k_run : a.n_passes;
  return a.m_pad >= 1 && a.m_pad <= kThreads * PER && a.m_pad % 4 == 0 && a.n_passes >= 1 &&
         a.k_run >= 1 && a.k_run <= a.n_passes && a.n_chain >= 0 && a.n_chain <= passes_run &&
         a.b_pad >= 1 &&
         plan_ok<PER>(groups, grid, smem_bytes,
                      viterbi_rows(lazy, a.k_run, a.n_passes, a.n_chain), false);
}

}  // namespace
