// The full-profile Viterbi step, its log-space Forward semiring twin and
// its upper-bound filter, written by hand for Hopper (sm_90a): the kernel
// template shared by p7_viterbi_kernel.cu (the eager and lazy Viterbi
// cases), p7_forward_log_kernel.cu (the log-space Forward case) and
// p7_viterbi_filter_kernel.cu (the Viterbi filter case). Each source
// instantiates its own cases, so the three compile side by side.
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_p7.py::_p7_kernel in Viterbi
// mode (the eager kernel) and in Forward mode (forward=True, the log-space
// semiring), and ::_p7_lazy_kernel (the lazy one), all launched by
// p7_pallas_call, and ::_p7_filter_kernel (the filter), launched by
// _p7_filter_padded. For every residue t < length of a sequence, with M, I, D
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
// The filter (HMMER ViterbiFilter's role in the --fast cascade) is the eager
// Viterbi step with three changes, each of which keeps every value >= its
// exact counterpart, so its score bounds the exact Viterbi score from above:
//  * msc/isc are the host's bf16 round-up of the emission tables; a bf16
//    entry widens to f32 exactly (the TPU's one-hot select of one bf16 term
//    is exact too);
//  * the delete chain runs `window` passes (k_run), with the host's
//    rounded-up window sums, instead of ceil(log2 M_pad) (n_passes);
//  * when window < n_passes, D-runs longer than the window are bounded by one
//    tail term on every row j < M_pad: D_j = max(D_j, max_i(a0_i) + aux)
//    (aux = 2^window * max(tdd), consts[3]), where a0 = shift(M + tmd, 1) is
//    the row entering the chain; its max is taken over M + tmd before the
//    shift (the value the shift drops, row M_pad - 1, is -inf, as its tmd
//    is), and each warp's share is published before the shift's barrier.
// Its E is max_j M_j with e_skip_d, else max_j max(M_j, D_j). The tail lands
// on row 0 and on the JAX pack's pad rows Mr..M_pad-1 too, as on the TPU;
// the kernel's own slots past M_pad stay -inf. Every float32 operation is a
// max or one add with _p7_filter_kernel's operands, so its scores equal the
// JAX kernel's and the plain version's bit for bit.
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
//    memory once: tmm tmi tmd tim tii tdm (at 256 threads a group, the
//    first n_trans of them), the first n_chain chain rows (all the passes
//    the case runs, unless that would not fit: the launcher's plan says how
//    many) and, for the lazy certificate, Cmax; the remaining rows (the
//    lazy replay's passes, a wide profile's last chain rows and, at 256
//    threads, the last transitions) are read from global memory. Every
//    staged read is an unpredicated, conflict-free shared load; states past
//    M_pad read the fill -inf and stay -inf.
//  * G groups of KT = 128 threads (256 past M_pad 2432) share the staged
//    rows, one sequence each, and synchronise on their own named barriers;
//    the grid is persistent (the launcher's plan) and walks the batch with
//    a stride. G = 1 for a batch no larger than the SMs, so a survivor batch
//    pays one step's latency; a full batch takes as many groups as
//    registers and shared memory allow (4 at 1400.hmm: 128 registers a
//    thread, 199-232 KB a block).
//  * Thread t owns the contiguous states t * PER + k. A shift by s < PER
//    moves registers and passes only the last s slots through shared
//    memory; a larger shift reads the whole row at j - s. One barrier a
//    shift, two alternating buffers.
//  * The emission rows of step t + 1 are copied into the group's shared
//    memory with cp.async while step t runs; the first barrier of step t+1
//    publishes them. (Read with __ldg in the blocked layout instead, each
//    warp load spans 11 lines: 8-13% slower at 4096 rows, measured.) The
//    filter's rows stay bf16 there: half the bytes, one integer widening an
//    entry (p7_blocked.cuh::load_bf16).
//  * E is a warp butterfly and a KT / 32-entry shared reduction a group (two
//    of them, the max and the sum, in Forward mode; E and max(a0) in the
//    filter).
//  * The carries cross global memory as [B, M_pad] rows, coalesced through
//    a shift buffer: at the start and end of a sequence, and, for the lazy
//    kernel, at each chunk entry (saved in the output carries) and on a
//    fire (loaded back). The fire is a group-scoped bar.red.or; fires are
//    counted per sequence. The specials stay in registers.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise. The C entry points return cudaGetLastError().
//  * Past 256 * 19 = 4864 states (up to the chain's 65536) the
//    rows-in-memory case (viterbi_mem_kernel, p7_blocked.cuh) runs the same
//    step with every row in global memory, one 1024-thread block a
//    sequence.

#pragma once

#include "p7_blocked.cuh"

namespace {

struct ViterbiArgs {
  const void* msc;     // [20, m_pad]: f32, or bf16 bits (filter)
  const void* isc;     // [20, m_pad]
  const float* trans;  // [8, m_pad]: tmm tmi tmd tim tii tdm tdd_s pad
  const float* chain;  // [16, m_pad]: pass constants; row 15 = Cmax (lazy)
  int m_pad;
  int n_passes;  // ceil(log2 m_pad): the full chain
  int k_run;     // passes of the certified schedule (lazy) or the window (filter)
  int n_chain;   // chain rows staged in shared memory
  int n_trans;   // transition rows staged in shared memory (6 at 128 threads)
  int e_skip_d;  // filter: E = max_j M_j
  const int8_t* tokens;  // [b_pad, l_pad]
  int l_pad;
  const int* lengths;    // [b_pad]
  const float* tr_rows;  // [2, b_pad]: tr_loop, tr_move
  const float* consts;   // [3], [4] or [5]: tr_B_Mk, tr_E_C, tr_E_J, aux, tmd_max
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
// array indexed at run time (which would live in local memory). The
// emission rows are bf16 in the filter (FILT).
template <int PER, int KT, bool FILT>
struct GroupSmem {
  float* base;  // two shift buffers, then (match, insert) emissions of even and odd steps
  float* red;   // red_floats<KT>()
  int8_t* toks;  // kChunk

  static constexpr int ROW = row_floats<PER, KT>();
  static constexpr int EROW = erow_floats<PER, KT, FILT>();
  __device__ __forceinline__ float* xbuf(int par) const { return base + par * ROW; }
  __device__ __forceinline__ float* em(int q) const { return base + 2 * ROW + 2 * q * EROW; }
  __device__ __forceinline__ float* ei(int q) const {
    return base + 2 * ROW + (2 * q + 1) * EROW;
  }
};

template <int PER, int KT, bool FILT>
__device__ __forceinline__ GroupSmem<PER, KT, FILT> group_smem(float* base) {
  using G = GroupSmem<PER, KT, FILT>;
  G s;
  s.base = base;
  s.red = base + 2 * G::ROW + 4 * G::EROW;
  s.toks = reinterpret_cast<int8_t*>(s.red + red_floats<KT>());
  return s;
}

// The group's state: rows in registers, specials replicated in every thread.
template <int PER>
struct Rows {
  float m[PER];
  float i[PER];
  float d[PER];  // D (eager, Forward, filter) or pre_diag (lazy)
  float sj, sc, sn, sb;
};

// Copy step `step`'s emission rows into the group's buffers of parity q.
template <int PER, int KT, bool FILT>
__device__ __forceinline__ void prefetch_step(const ViterbiArgs& a,
                                              const GroupSmem<PER, KT, FILT>& gs, int q, int aa,
                                              int t) {
  if constexpr (FILT) {
    prefetch_emissions_bf16<PER, KT>(reinterpret_cast<uint16_t*>(gs.em(q)),
                                     reinterpret_cast<uint16_t*>(gs.ei(q)),
                                     static_cast<const uint16_t*>(a.msc),
                                     static_cast<const uint16_t*>(a.isc), aa, a.m_pad, t);
  } else {
    prefetch_emissions<PER, KT>(gs.em(q), gs.ei(q), static_cast<const float*>(a.msc),
                                static_cast<const float*>(a.isc), aa, a.m_pad, t);
  }
}

// Steps [0, count) of the chunk whose tokens are in gs.toks. Returns whether
// the certificate fired (CERT only). `cs` is the block's staged rows.
template <int PER, int KT, bool LAZY, bool LSE, bool CERT, bool FILT>
__device__ __forceinline__ bool run_chunk(const ViterbiArgs& a, const float* cs,
                                          const GroupSmem<PER, KT, FILT>& gs, Rows<PER>& r,
                                          int count, int passes, int& par, float tr_loop,
                                          float tr_move, int t, int bar) {
  static_assert(!(LAZY && LSE) && !(FILT && (LAZY || LSE)), "one case at a time");
  constexpr int ROW = row_floats<PER, KT>();
  constexpr int W = warps<KT>();
  const int m_pad = a.m_pad;
  const float ninf = neg_inf();
  const float tr_b_mk = a.consts[0];
  const float tr_e_c = a.consts[1];
  const float tr_e_j = a.consts[2];
  const float aux = FILT ? a.consts[3] : 0.0f;
  const float tmd_max = LAZY ? a.consts[4] : 0.0f;
  const bool truncated = FILT && passes < a.n_passes;
  const int off = t * stride<PER>();
  const int n_trans = KT == 128 ? kTransRows : a.n_trans;
  const TransRows<PER, KT> tr{cs + off, a.trans, n_trans, m_pad, t * PER, ninf};
  const float* chain_s = cs + n_trans * ROW + off;
  const float* cmax = cs + (n_trans + a.n_chain) * ROW + off;
  bool viol = false;

  prefetch_step<PER, KT, FILT>(a, gs, 0, token(gs.toks, 0), t);
  cp_async_commit();
  for (int step = 0; step < count; ++step) {
    const int q = step & 1;
    if (step + 1 < count) prefetch_step<PER, KT, FILT>(a, gs, q ^ 1, token(gs.toks, step + 1), t);
    cp_async_commit();

    // the j-1 diagonal: pre_diag of the previous step, shifted by one
    float pd[PER];
    if (LAZY) {
#pragma unroll
      for (int k = 0; k < PER; ++k) pd[k] = r.d[k];
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        pd[k] = combine<LSE>(combine<LSE>(r.m[k] + tr(0, k), r.i[k] + tr(3, k)),
                             r.d[k] + tr(5, k));
      }
    }
    cp_async_wait_prev();  // this step's emission rows (the barrier publishes them)
    float diag[PER];
    shift<PER, KT>(pd, diag, 1, ninf, gs.xbuf(par), t, bar);
    par ^= 1;

    const float bt = r.sb + tr_b_mk;
    float nm[PER], ni[PER], ac[PER];
    if constexpr (FILT) {
      float me[PER], ie[PER];
      load_bf16<PER>(reinterpret_cast<const uint16_t*>(gs.em(q)), me, t);
      load_bf16<PER>(reinterpret_cast<const uint16_t*>(gs.ei(q)), ie, t);
      float a_max = ninf;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        nm[k] = me[k] + fmaxf(diag[k], bt);
        ni[k] = ie[k] + fmaxf(r.m[k] + tr(1, k), r.i[k] + tr(4, k));
        pd[k] = nm[k] + tr(2, k);
        a_max = fmaxf(a_max, pd[k]);
      }
      // the warp's share of max(a0) goes out before the shift's barrier,
      // which then orders it for every reader
      a_max = warp_reduce<false>(a_max);
      if (truncated && (t & 31) == 0) gs.red[W + (t >> 5)] = a_max;
    } else {
      const float* ms = gs.em(q) + off;
      const float* is = gs.ei(q) + off;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        nm[k] = ms[k] + combine<LSE>(diag[k], bt);
        ni[k] = is[k] + combine<LSE>(r.m[k] + tr(1, k), r.i[k] + tr(4, k));
        pd[k] = nm[k] + tr(2, k);
      }
    }
    shift<PER, KT>(pd, ac, 1, ninf, gs.xbuf(par), t, bar);
    par ^= 1;
    for (int p = 0; p < passes; ++p) {
      float sh[PER];
      shift<PER, KT>(ac, sh, 1 << p, ninf, gs.xbuf(par), t, bar);
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
    if (truncated) {
      const float tail = combine_warps<false, KT>(gs.red + W) + aux;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        if (t * PER + k < m_pad) ac[k] = fmaxf(ac[k], tail);
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
      const float mx = group_reduce<false, KT>(e, gs.red, t, bar);
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < PER; ++k) sum += expf(x[k] == mx ? 0.0f : x[k] - mx);
      e = mx + logf(group_reduce<true, KT>(sum, gs.red + W, t, bar));
    } else if (FILT) {
      const bool skip_d = a.e_skip_d != 0;
#pragma unroll
      for (int k = 0; k < PER; ++k) e = fmaxf(e, skip_d ? nm[k] : fmaxf(nm[k], ac[k]));
      e = group_reduce<false, KT>(e, gs.red, t, bar);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) e = fmaxf(e, LAZY ? nm[k] : fmaxf(nm[k], ac[k]));
      e = group_reduce<false, KT>(e, gs.red, t, bar);
    }

#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (LAZY) {
        const float stay = fmaxf(nm[k] + tr(0, k), ni[k] + tr(3, k));
        const float npd = fmaxf(stay, ac[k] + tr(5, k));
        if (CERT) {
          // the bound's own rounding path, in this order
          const float t_row = ((e + tmd_max) + cmax[k]) + tr(5, k);
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

template <int PER, int KT>
__device__ __forceinline__ void store_carries(const Rows<PER>& r, float* m, float* i, float* d,
                                              int m_pad, float* buf, int t, int bar) {
  store_row<PER, KT>(r.m, m, m_pad, buf, t, bar);
  store_row<PER, KT>(r.i, i, m_pad, buf, t, bar);
  store_row<PER, KT>(r.d, d, m_pad, buf, t, bar);
}

template <int PER, int KT>
__device__ __forceinline__ void load_carries(Rows<PER>& r, const float* m, const float* i,
                                             const float* d, int m_pad, float* buf, int t,
                                             int bar) {
  const float ninf = neg_inf();
  load_row<PER, KT>(r.m, m, m_pad, ninf, buf, t, bar);
  load_row<PER, KT>(r.i, i, m_pad, ninf, buf, t, bar);
  load_row<PER, KT>(r.d, d, m_pad, ninf, buf, t, bar);
}

// Rows of shared memory the block stages: n_trans transitions, n_chain
// chain rows and, when the lazy kernel certifies, Cmax.
__host__ __device__ inline int viterbi_rows(bool lazy, int k_run, int n_passes, int n_chain,
                                            int n_trans) {
  return n_trans + n_chain + ((lazy && k_run < n_passes) ? 1 : 0);
}

template <int PER, int KT, bool LAZY, bool LSE, bool FILT>
__global__ void viterbi_kernel(const ViterbiArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ROW = row_floats<PER, KT>();
  const int m_pad = a.m_pad;
  const float ninf = neg_inf();
  const bool certify = LAZY && a.k_run < a.n_passes;
  const int n_trans = KT == 128 ? kTransRows : a.n_trans;
  const int n_rows = viterbi_rows(LAZY, a.k_run, a.n_passes, a.n_chain, n_trans);

  for (int q = 0; q < n_trans; ++q) {
    stage_row<PER, KT>(smem + q * ROW, a.trans + q * m_pad, m_pad, ninf);
  }
  for (int p = 0; p < a.n_chain; ++p) {
    stage_row<PER, KT>(smem + (n_trans + p) * ROW, a.chain + p * m_pad, m_pad, ninf);
  }
  if (certify) {
    stage_row<PER, KT>(smem + (n_trans + a.n_chain) * ROW, a.chain + 15 * m_pad, m_pad, ninf);
  }

  const int groups = blockDim.x / KT;
  const int g = threadIdx.x / KT;
  const int t = threadIdx.x % KT;
  const int bar = 1 + g;
  const GroupSmem<PER, KT, FILT> gs = group_smem<PER, KT, FILT>(
      smem + n_rows * ROW + g * group_floats<PER, KT, FILT>(false));
  for (int q = 0; q < 2; ++q) {
    if constexpr (FILT) {
      fill_tail_bf16<PER, KT>(reinterpret_cast<uint16_t*>(gs.em(q)), m_pad, 0xff80u, t);
      fill_tail_bf16<PER, KT>(reinterpret_cast<uint16_t*>(gs.ei(q)), m_pad, 0xff80u, t);
    } else {
      fill_tail<PER, KT>(gs.em(q), m_pad, ninf, t);
      fill_tail<PER, KT>(gs.ei(q), m_pad, ninf, t);
    }
  }
  __syncthreads();  // the staged rows; from here on each group keeps to itself

  // the passes a step runs: the whole chain, the lazy window or the
  // filter's window
  const int passes = (LAZY || FILT) ? a.k_run : a.n_passes;
  const int b_pad = a.b_pad;
  for (int seq = blockIdx.x * groups + g; seq < b_pad; seq += gridDim.x * groups) {
    const size_t row = static_cast<size_t>(seq) * m_pad;
    Rows<PER> r;
    load_carries<PER, KT>(r, a.m_in + row, a.i_in + row, a.d_in + row, m_pad, gs.xbuf(0), t,
                          bar);
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
      group_sync<KT>(bar);
      if (certify) {
        store_carries<PER, KT>(r, a.m_out + row, a.i_out + row, a.d_out + row, m_pad,
                               gs.xbuf(0), t, bar);  // the chunk's entry
        const float ej = r.sj, ec = r.sc, en = r.sn, eb = r.sb;
        const bool viol = run_chunk<PER, KT, LAZY, LSE, true, FILT>(
            a, smem, gs, r, count, a.k_run, par, tr_loop, tr_move, t, bar);
        if (group_any<KT>(bar, viol)) {
          load_carries<PER, KT>(r, a.m_out + row, a.i_out + row, a.d_out + row, m_pad,
                                gs.xbuf(0), t, bar);
          r.sj = ej;
          r.sc = ec;
          r.sn = en;
          r.sb = eb;
          run_chunk<PER, KT, LAZY, LSE, false, FILT>(a, smem, gs, r, count, a.n_passes, par,
                                                     tr_loop, tr_move, t, bar);
          ++replays;
        }
      } else {
        run_chunk<PER, KT, LAZY, LSE, false, FILT>(a, smem, gs, r, count, passes, par, tr_loop,
                                                   tr_move, t, bar);
      }
      group_sync<KT>(bar);  // every step's reads of the shift buffers and toks are done
    }

    store_carries<PER, KT>(r, a.m_out + row, a.i_out + row, a.d_out + row, m_pad, gs.xbuf(0),
                           t, bar);
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

// The rows-in-memory case (p7_blocked.cuh, past 4864 states): one block of
// kMemThreads threads a sequence, run_chunk's step over the block's scratch
// rows (`scratch`, [grid, kMemRows, m_pad]) with the same float32
// operations on the same operands. Rows by parity p: M at 0 + p, I at 2 + p, D (or the lazy pre_diag) at 4 + p, the
// chain's two rows at 6 and 7. The shift by one that enters the chain is
// taken by its first pass, which reads a0 at j - 1 and j - 2 of the M + tmd
// row. E is a block reduction (max; in Forward mode a max, then a sum in
// another fixed order than the register cases'); the lazy certificate's
// fire is a block OR at the chunk's end.
template <bool LAZY, bool LSE, bool FILT>
__global__ void __launch_bounds__(kMemThreads)
    viterbi_mem_kernel(const ViterbiArgs a, float* scratch) {
  __shared__ float red_buf[2 * kMemWarps];
  BlockReduce red{red_buf, 0};
  const int m_pad = a.m_pad;
  const int t = threadIdx.x;
  const float ninf = neg_inf();
  const bool certify = LAZY && a.k_run < a.n_passes;
  const int passes = (LAZY || FILT) ? a.k_run : a.n_passes;
  const bool truncated = FILT && passes < a.n_passes;
  const bool e_of_m = LAZY || (FILT && a.e_skip_d != 0);  // E = max_j M_j
  const float tr_b_mk = a.consts[0];
  const float tr_e_c = a.consts[1];
  const float tr_e_j = a.consts[2];
  const float aux = FILT ? a.consts[3] : 0.0f;
  const float tmd_max = LAZY ? a.consts[4] : 0.0f;
  const float* tmm = a.trans;
  const float* tmi = a.trans + m_pad;
  const float* tmd = a.trans + 2 * m_pad;
  const float* tim = a.trans + 3 * m_pad;
  const float* tii = a.trans + 4 * m_pad;
  const float* tdm = a.trans + 5 * m_pad;
  auto row = [&](int r) { return mem_row(scratch, r, m_pad); };
  // entry j of emission row aa: f32, or bf16 widened exactly (FILT)
  auto emit = [&](const void* tab, int aa, int j) -> float {
    const size_t at = static_cast<size_t>(aa) * m_pad + j;
    if constexpr (FILT) {
      return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(tab)[at]) << 16);
    } else {
      return static_cast<const float*>(tab)[at];
    }
  };

  for (int seq = blockIdx.x; seq < a.b_pad; seq += gridDim.x) {
    const size_t base = static_cast<size_t>(seq) * m_pad;
    for (int j = t; j < m_pad; j += kMemThreads) {
      row(0)[j] = a.m_in[base + j];
      row(2)[j] = a.i_in[base + j];
      row(4)[j] = a.d_in[base + j];
    }
    float sj = a.s_in[seq];
    float sc = a.s_in[a.b_pad + seq];
    float sn = a.s_in[2 * a.b_pad + seq];
    float sb = a.s_in[3 * a.b_pad + seq];
    const float tr_loop = a.tr_rows[seq];
    const float tr_move = a.tr_rows[a.b_pad + seq];
    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
    int par = 0;
    int replays = 0;
    __syncthreads();

    // steps [c0, c0 + count) with `run` chain passes; returns whether the
    // certificate fired in this thread's states (cert only)
    auto steps = [&](int c0, int count, int run, bool cert) {
      bool viol = false;
      for (int pos = c0; pos < c0 + count; ++pos) {
        const int aa = min(max(static_cast<int>(tok_row[pos]), 0), 19);
        const float* mo = row(par);
        const float* io = row(2 + par);
        const float* dp = row(4 + par);
        float* mn = row(par ^ 1);
        float* in = row(2 + (par ^ 1));
        float* dn = row(4 + (par ^ 1));
        const float bt = sb + tr_b_mk;
        float e_m = ninf, a_max = ninf;
        for (int j = t; j < m_pad; j += kMemThreads) {
          float diag = ninf;  // the j-1 diagonal: pre_diag of the last step, shifted by one
          if (j > 0) {
            const int i = j - 1;
            diag = LAZY ? dp[i]
                        : combine<LSE>(combine<LSE>(mo[i] + tmm[i], io[i] + tim[i]), dp[i] + tdm[i]);
          }
          const float nm = emit(a.msc, aa, j) + combine<LSE>(diag, bt);
          in[j] = emit(a.isc, aa, j) + combine<LSE>(mo[j] + tmi[j], io[j] + tii[j]);
          mn[j] = nm;
          const float pd = nm + tmd[j];
          row(6)[j] = pd;
          e_m = fmaxf(e_m, nm);
          a_max = fmaxf(a_max, pd);
        }
        float e_nm = 0.0f, tail = 0.0f;
        if (e_of_m) e_nm = red.run<false>(e_m);
        if (truncated) tail = red.run<false>(a_max) + aux;
        if (!e_of_m && !truncated) __syncthreads();

        const float* src = row(6);
        float* dst = row(7);
        for (int p = 0; p < run; ++p) {
          const int s = 1 << p;
          const float* c = a.chain + static_cast<size_t>(p) * m_pad;
          for (int j = t; j < m_pad; j += kMemThreads) {
            // pass 0 reads a0 = the M + tmd row shifted by one
            const float cur = p == 0 ? (j >= 1 ? src[j - 1] : ninf) : src[j];
            const int from = p == 0 ? j - 2 : j - s;
            const float sh = from >= 0 ? src[from] : ninf;
            dst[j] = combine<LSE>(cur, sh + c[j]);
          }
          __syncthreads();
          const float* done = dst;
          dst = const_cast<float*>(src);
          src = done;
        }

        float e_f = ninf;
        for (int j = t; j < m_pad; j += kMemThreads) {
          float ac = src[j];
          if (truncated) ac = fmaxf(ac, tail);
          const float nm = mn[j];
          if (LAZY) {
            const float stay = fmaxf(nm + tmm[j], in[j] + tim[j]);
            const float npd = fmaxf(stay, ac + tdm[j]);
            if (cert) {
              // the bound's own rounding path, in this order
              const float t_row = ((e_nm + tmd_max) + a.chain[15 * static_cast<size_t>(m_pad) + j]) +
                                  tdm[j];
              viol |= t_row > npd;
            }
            dn[j] = npd;
          } else {
            dn[j] = ac;
            e_f = fmaxf(e_f, LSE ? combine<true>(nm, ac) : (e_of_m ? nm : fmaxf(nm, ac)));
          }
        }
        float e;
        if (e_of_m) {
          e = e_nm;
          __syncthreads();
        } else if (LSE) {
          const float mx = red.run<false>(e_f);
          float sum = 0.0f;
          for (int j = t; j < m_pad; j += kMemThreads) {
            const float x = combine<true>(mn[j], dn[j]);
            sum += expf(x == mx ? 0.0f : x - mx);
          }
          e = mx + logf(red.run<true>(sum));
        } else {
          e = red.run<false>(e_f);
        }
        sj = combine<LSE>(sj + tr_loop, e + tr_e_j);
        sc = combine<LSE>(sc + tr_loop, e + tr_e_c);
        sn = sn + tr_loop;
        sb = combine<LSE>(sn + tr_move, sj + tr_move);
        par ^= 1;
      }
      return viol;
    };

    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int count = min(kChunk, n - c0);
      if (certify) {
        // the chunk's entry, in the output carries
        for (int j = t; j < m_pad; j += kMemThreads) {
          a.m_out[base + j] = row(par)[j];
          a.i_out[base + j] = row(2 + par)[j];
          a.d_out[base + j] = row(4 + par)[j];
        }
        const float ej = sj, ec = sc, en = sn, eb = sb;
        if (__syncthreads_or(steps(c0, count, a.k_run, true))) {
          for (int j = t; j < m_pad; j += kMemThreads) {
            row(par)[j] = a.m_out[base + j];
            row(2 + par)[j] = a.i_out[base + j];
            row(4 + par)[j] = a.d_out[base + j];
          }
          sj = ej;
          sc = ec;
          sn = en;
          sb = eb;
          __syncthreads();
          steps(c0, count, a.n_passes, false);
          ++replays;
        }
      } else {
        steps(c0, count, passes, false);
      }
    }

    for (int j = t; j < m_pad; j += kMemThreads) {
      a.m_out[base + j] = row(par)[j];
      a.i_out[base + j] = row(2 + par)[j];
      a.d_out[base + j] = row(4 + par)[j];
    }
    if (t == 0) {
      a.s_out[seq] = sj;
      a.s_out[a.b_pad + seq] = sc;
      a.s_out[2 * a.b_pad + seq] = sn;
      a.s_out[3 * a.b_pad + seq] = sb;
      a.scores[seq] = sc + tr_move;
      if (LAZY) a.replays[seq] = replays;
    }
    __syncthreads();  // the next sequence's carries go into these rows
  }
}

// The pointer arguments of the C entry points, in their order.
inline ViterbiArgs make_args(const void* msc, const void* isc, const void* trans,
                             const void* chain, int m_pad, int n_passes, int k_run, int n_chain,
                             int n_trans, const void* tokens, int l_pad, const void* lengths,
                             const void* tr_rows, const void* consts, const void* m_in,
                             const void* i_in, const void* d_in, const void* s_in,
                             void* scores, void* m_out, void* i_out, void* d_out, void* s_out,
                             void* replays, int b_pad) {
  ViterbiArgs a;
  a.msc = msc;
  a.isc = isc;
  a.trans = static_cast<const float*>(trans);
  a.chain = static_cast<const float*>(chain);
  a.m_pad = m_pad;
  a.n_passes = n_passes;
  a.k_run = k_run;
  a.n_chain = n_chain;
  a.n_trans = n_trans;
  a.e_skip_d = 0;
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

// Checks every entry point shares: the operands' limits and the plan.
// `windowed`: the lazy and filter cases, which run k_run passes a step.
template <int PER, int KT, bool FILT>
bool viterbi_plan_ok(const ViterbiArgs& a, bool lazy, bool windowed, int groups, int grid,
                     int smem_bytes) {
  const int passes_run = windowed ? a.k_run : a.n_passes;
  return a.m_pad >= 1 && a.m_pad <= KT * PER && a.m_pad % 8 == 0 && a.n_passes >= 1 &&
         a.k_run >= 1 && a.k_run <= a.n_passes && a.n_chain >= 0 && a.n_chain <= passes_run &&
         a.b_pad >= 1 &&
         plan_ok<PER, KT, FILT>(groups, grid, smem_bytes,
                                viterbi_rows(lazy, a.k_run, a.n_passes, a.n_chain, a.n_trans),
                                a.n_trans, false);
}

// Runs a kernel case on the plan after setting its shared-memory limit once
// per device; `done` is that case's flag word.
template <typename Kernel>
cudaError_t launch_planned(Kernel kernel, const ViterbiArgs& a, int device, unsigned& done,
                           int groups, int kt, int grid, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(kernel, device, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, groups * kt, smem, stream>>>(a);
  return cudaGetLastError();
}

// Checks the rows-in-memory case's operands as viterbi_plan_ok checks a
// register case's (the lazy kernel certifies only below 16 passes: row 15
// of its chain holds Cmax), and launches it.
template <bool LAZY, bool LSE, bool FILT>
cudaError_t launch_mem(const ViterbiArgs& a, void* scratch, bool windowed, int per, int groups,
                       int grid, int smem, cudaStream_t stream) {
  const bool ok = a.m_pad % 8 == 0 && a.n_passes >= 1 && a.n_passes <= 16 && a.k_run >= 1 &&
                  a.k_run <= a.n_passes && (windowed || a.k_run == a.n_passes) &&
                  (!LAZY || a.k_run == a.n_passes || a.n_passes <= 15) && a.b_pad >= 1 &&
                  mem_plan_ok(a.m_pad, per, groups, grid, smem, scratch);
  if (!ok) return cudaErrorInvalidValue;
  viterbi_mem_kernel<LAZY, LSE, FILT>
      <<<grid, kMemThreads, 0, stream>>>(a, static_cast<float*>(scratch));
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t kernel_regs(Kernel kernel, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  *out = attr.numRegs;
  return err;
}

}  // namespace
