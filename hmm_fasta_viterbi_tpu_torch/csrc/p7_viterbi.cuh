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
//    memory once: tmm tmi tmd tim tii tdm, the first n_chain chain rows
//    (all the passes the case runs, unless that would not fit: the
//    launcher's plan says how many) and, for the lazy certificate, Cmax;
//    the remaining rows (the lazy replay's passes, a wide profile's last
//    chain rows) are read from global memory. Every staged read is an
//    unpredicated, conflict-free shared load; states past M_pad read the
//    fill -inf and stay -inf.
//  * G groups of KT = 128 threads share the staged
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
//  * Past 128 * 19 = 2432 states (up to 4864) the four cases run on the
//    cluster pair (p7_blocked.cuh; viterbi_pair_kernel, launched as 2-block
//    clusters): block r of a cluster holds states r * 128 * PER .. of one
//    sequence in the normal-width layout, a group of 128 threads a block,
//    and stages its half of every row the normal-width plan stages (every
//    transition row, as many chain rows as fit: all but 4 of the eager 13
//    at 19 states a thread); the pair walks the batch with a stride of the
//    grid's clusters. Each phase that crosses threads crosses the pair
//    (p7_blocked.cuh says how): the two shifts by one and every pass
//    a[j - 2^k] (block 1's first 2^k states come from block 0, which stores
//    them into block 1: below 17 as a halo, else into one of two rows), E's
//    reductions (each warp's value into
//    both blocks, combined in one order, block 0's warps then block 1's),
//    the filter's tail max, and the lazy certificate's OR, so both halves
//    replay the same chunks. A block's own phases keep its named barrier.
//  * Past 256 * 19 = 4864 states (up to 16 * 2432 = 38,912; the lazy case
//    up to 32,768) the lazy and filter cases run on C-block clusters
//    (p7_blocked.cuh;
//    viterbi_cluster_kernel, C = ceil(M_pad / 2432), 3..16, read from
//    %cluster_nctarank): block r holds states r * 128 * PER .. in the
//    normal-width layout, stages its slice of every row the normal-width
//    plan stages, and every cross-thread phase crosses the cluster as it
//    crosses the pair; a shift by 2^k of a whole block or more (the lazy
//    replay's full chain, a filter window that reaches it) takes a block's
//    states from the two blocks it falls between. The lazy certificate's
//    fire is an exchange (an OR over the cluster), so every block replays
//    the same chunks. The eager and log-space cases take no 128-thread
//    cluster there: their steps run the whole chain every residue, whose
//    larger shifts take about 1.7 us each across 128-thread blocks (on the
//    pair a step takes 17.4 us eager, 65.6 us log-space).
//  * Past 4864 states, up to kBlockThreads * kBlockPerMax (9216), the
//    eager and log-space cases run the wide block (block_chunk,
//    viterbi_block_kernel): one group of kBlockThreads = 1024 threads a
//    block and a sequence in the normal-width layout, every shift one
//    barrier of the block (no cluster), the rows in registers (64 a thread:
//    each shift taken in place), one step's emission rows and as many
//    constant rows as fit in shared memory, the rest read thread-major from
//    L2 (BlockRows).
//  * Past 9216 states (up to the chain's 65536) the eager and log-space
//    cases run clusters of wide blocks (viterbi_block_cluster_kernel): C of
//    2..kMaxBlockCluster wide blocks a sequence, one in each block of a
//    C-block cluster, block r holding states r * kBlockThreads * PER .. in
//    the wide block's layout, PER of 5..8. block_chunk's step, operation for
//    operation, with its shifts across the cluster (the C-block clusters'
//    halos, rows and releases, each taken in place: wide_cluster_small,
//    wide_cluster_big) and E an exchange of each block's 32 warp values (the
//    block's by a butterfly over the lanes, then the blocks in rank order:
//    wide_cluster_collect). Each block reads its slice of the thread-major
//    rows.
//  * Past 32,768 states (up to the chain's 65536) the lazy case runs the
//    eager case's clusters of wide blocks: there the chain has 16 passes,
//    which leave no row of the chain array for the certificate's Cmax, so
//    the lazy kernel runs the whole chain every step and certifies nothing;
//    its step is then the eager step with pre_diag carried in the D row
//    (block_chunk's CARRY), its scores the eager kernel's bit for bit. Up to
//    38,912 that is twice as fast as the whole chain on its 128-thread
//    C-block clusters, whose larger shifts cross blocks.
//  * Past 38,912 states (up to 65536) the filter case runs C-block clusters
//    of kWideClusterThreads = 256-thread blocks (viterbi_wide_cluster_kernel,
//    C = ceil(M_pad / 4864), 9..14, PER 17..19, as Forward's and the
//    posterior pair's there): run_chunk's step at KT = 256, operation for
//    operation, each cross-thread phase across the cluster as at 128 threads
//    (the window's shifts by 32 and 64 are its larger shifts, E and max(a0)
//    two exchanges a step). Its block stages two steps' bf16 emission rows,
//    then the transitions and chain rows that fit beside its group and the
//    cluster's area (5 of the 6 transitions at PER 19), and reads the rest
//    from its slice of their thread-major copy (ops/p7_cuda.py::block_rows
//    at 256 threads, fill -inf: TransRows, the chain's fallback).
//  * The eager, log-space and lazy cases on a card that holds no cluster of
//    their wide blocks, and the filter on one that holds no cluster of
//    256-thread blocks, run the rows-in-memory case (viterbi_mem_kernel,
//    p7_blocked.cuh): the same step with every row in global memory, one
//    1024-thread block a sequence; the launch plan takes it for a width whose
//    cluster the card cannot hold.

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
  const float* tm;       // the wide block's thread-major rows (BlockRows), else null
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
  // emission rows: two steps' (match, insert) rows, the wide block's one step's
  static constexpr int NEM = KT == kBlockThreads ? 2 : 4;
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
  s.red = base + 2 * G::ROW + G::NEM * G::EROW;
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

// Copy step `step`'s emission rows into the group's buffers of parity q
// (a cluster's block: its slice of them).
template <int PER, int KT, bool FILT, Span SPAN>
__device__ __forceinline__ void prefetch_step(const ViterbiArgs& a,
                                              const GroupSmem<PER, KT, FILT>& gs, int q, int aa,
                                              int t, const Link<SPAN>& h) {
  if constexpr (SPAN != Span::kGroup) {
    if constexpr (FILT) {
      prefetch_half<PER, KT, uint16_t>(reinterpret_cast<uint16_t*>(gs.em(q)),
                                       reinterpret_cast<uint16_t*>(gs.ei(q)),
                                       static_cast<const uint16_t*>(a.msc),
                                       static_cast<const uint16_t*>(a.isc), aa, a.m_pad, h, t);
    } else {
      prefetch_half<PER, KT, float>(gs.em(q), gs.ei(q), static_cast<const float*>(a.msc),
                                    static_cast<const float*>(a.isc), aa, a.m_pad, h, t);
    }
  } else if constexpr (FILT) {
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
// the certificate fired (CERT only; in this block's states, for a cluster).
// `cs` is the block's staged rows; `h` the block's place in the pair or the
// cluster (SPAN). Groups of 128 threads, and the filter's block of a C-block
// cluster of kWideClusterThreads-thread blocks, which stages the rows the
// plan names (n_trans transitions, then n_chain chain rows) and reads the
// others from its slice of their thread-major copy (ViterbiArgs::tm,
// [C * (kTransRows + k_run)][PER][KT]: TransRows, the chain's fallback).
template <int PER, int KT, bool LAZY, bool LSE, bool CERT, bool FILT, Span SPAN>
__device__ __forceinline__ bool run_chunk(const ViterbiArgs& a, const float* cs,
                                          const GroupSmem<PER, KT, FILT>& gs, Rows<PER>& r,
                                          int count, int passes, int& par, float tr_loop,
                                          float tr_move, int t, int bar, Link<SPAN>& h) {
  static_assert(!(LAZY && LSE) && !(FILT && (LAZY || LSE)), "one case at a time");
  static_assert(KT == 128 || (FILT && SPAN == Span::kCluster && KT == kWideClusterThreads),
                "groups of 128, or the filter's 256-thread cluster blocks (the wide block "
                "runs block_chunk)");
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
  const int j0 = h.col0 + t * PER;  // this thread's first state
  const int n_trans = KT == 128 ? kTransRows : a.n_trans;
  // a 256-thread block's slice of the thread-major rows, at this thread
  const float* tm = nullptr;
  if constexpr (KT != 128) {
    tm = a.tm + static_cast<size_t>(h.rank) * (kTransRows + a.k_run) * PER * KT + t;
  }
  const TransRows<PER, KT> tr{cs + off, tm, n_trans};
  const float* chain_s = cs + n_trans * ROW + off;
  const float* cmax = cs + (n_trans + a.n_chain) * ROW + off;
  bool viol = false;
  [[maybe_unused]] int tail_x = 0;  // the cluster's exchange of the filter's max(a0)

  prefetch_step<PER, KT, FILT, SPAN>(a, gs, 0, token(gs.toks, 0), t, h);
  cp_async_commit();
  for (int step = 0; step < count; ++step) {
    const int q = step & 1;
    if (step + 1 < count) {
      prefetch_step<PER, KT, FILT, SPAN>(a, gs, q ^ 1, token(gs.toks, step + 1), t, h);
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
        pd[k] = combine<LSE>(combine<LSE>(r.m[k] + tr(0, k), r.i[k] + tr(3, k)),
                             r.d[k] + tr(5, k));
      }
    }
    cp_async_wait_prev();  // this step's emission rows (the barrier publishes them)
    float diag[PER];
    step_shift<PER, KT, SPAN>(pd, diag, 1, ninf, gs.xbuf(par), t, bar, h, 0, passes);
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
      if constexpr (SPAN == Span::kPair) {
        if (truncated) tail_x = pair_send<KT>(a_max, t, h);
      } else if constexpr (SPAN == Span::kCluster) {
        if (truncated) tail_x = cluster_send<KT>(a_max, t, h);
      } else {
        if (truncated && (t & 31) == 0) gs.red[W + (t >> 5)] = a_max;
      }
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
    step_shift<PER, KT, SPAN>(pd, ac, 1, ninf, gs.xbuf(par), t, bar, h, 1, passes);
    par ^= 1;
    for (int p = 0; p < passes; ++p) {
      float sh[PER];
      step_shift<PER, KT, SPAN>(ac, sh, 1 << p, ninf, gs.xbuf(par), t, bar, h, 2 + p, passes);
      par ^= 1;
      if (p < a.n_chain) {
        const float* c = chain_s + p * ROW;
#pragma unroll
        for (int k = 0; k < PER; ++k) ac[k] = combine<LSE>(ac[k], sh[k] + c[k]);
      } else if constexpr (KT != 128) {
        const float* c = tm + (kTransRows + p) * PER * KT;
#pragma unroll
        for (int k = 0; k < PER; ++k) ac[k] = combine<LSE>(ac[k], sh[k] + __ldg(c + k * KT));
      } else {
        const float* c = a.chain + static_cast<size_t>(p) * m_pad;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int j = j0 + k;
          ac[k] = combine<LSE>(ac[k], sh[k] + (j < m_pad ? __ldg(c + j) : ninf));
        }
      }
    }
    if (truncated) {
      float tail;
      if constexpr (SPAN == Span::kPair) {
        tail = combine_warps<false, 2 * KT>(pair_collect<KT>(tail_x, h)) + aux;
      } else if constexpr (SPAN == Span::kCluster) {
        tail = cluster_collect<false, KT>(tail_x, h) + aux;
      } else {
        tail = combine_warps<false, KT>(gs.red + W) + aux;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        if (j0 + k < m_pad) ac[k] = fmaxf(ac[k], tail);
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
      const float mx = step_reduce<false, KT, SPAN>(e, gs.red, t, bar, h);
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < PER; ++k) sum += expf(x[k] == mx ? 0.0f : x[k] - mx);
      e = mx + logf(step_reduce<true, KT, SPAN>(sum, gs.red + W, t, bar, h));
    } else if (FILT) {
      const bool skip_d = a.e_skip_d != 0;
#pragma unroll
      for (int k = 0; k < PER; ++k) e = fmaxf(e, skip_d ? nm[k] : fmaxf(nm[k], ac[k]));
      e = step_reduce<false, KT, SPAN>(e, gs.red, t, bar, h);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) e = fmaxf(e, LAZY ? nm[k] : fmaxf(nm[k], ac[k]));
      e = step_reduce<false, KT, SPAN>(e, gs.red, t, bar, h);
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

// -- the wide block --------------------------------------------------------------
//
// Past 4864 states, up to kBlockThreads * kBlockPerMax, the eager and
// log-space cases run one group of KT = kBlockThreads threads a block and a
// sequence (p7_blocked.cuh), the rows M, I, D in registers in the
// normal-width layout. block_chunk is run_chunk's step operation for
// operation (the same combines on the same operands in the same order, the
// same chain passes), with three changes that spare registers (64 a thread
// at 1024 threads): every shift is taken in place (one row of registers,
// not two; a pass's shifted value is combined as it arrives), the
// log-space E's terms wait in the thread's own slots of the idle shift
// buffer between its max and its sum, and the step-invariant rows that
// shared memory does not hold are read from their thread-major copy
// (BlockRows). One step's
// emission rows sit in shared memory: the next step's are copied in once
// the second shift's barrier has passed their last reader. E is
// block_reduce (the max is the same in any order; the log-space sum takes
// another fixed order than a group's).

// The wide block's step-invariant rows as a thread reads them: row q (the six
// transitions, then chain pass p at kTransRows + p), slot k, from the
// block's staged rows (the first n_staged: the plan stages the transitions
// first) or from their thread-major copy in global memory,
// [kTransRows + n_passes][PER][KT] (ViterbiArgs::tm: entry (q, k, t) is row q
// at state t * PER + k, -inf past m_pad), where a warp's read of a slot is 32
// contiguous floats.
template <int PER, int KT>
struct BlockRows {
  const float* staged;  // the block's staged rows, at this thread's offset
  const float* global;  // the thread-major rows, at this thread's column
  int n_staged;

  __device__ __forceinline__ float operator()(int q, int k) const {
    return q < n_staged ? staged[q * row_floats<PER, KT>() + k]
                        : __ldg(global + (q * PER + k) * KT);
  }
};

// v <- v shifted by S < PER toward higher j in place (shift_small's values:
// slots k >= S from slot k - S, the first S from thread t - 1's last S,
// `fill` in thread 0), one barrier.
template <int PER, int KT, int S>
__device__ __forceinline__ void block_shift_small(float (&v)[PER], float fill, float* buf, int t,
                                                  int bar) {
  constexpr int SP = stride<PER>();
#pragma unroll
  for (int k = PER - S; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
#pragma unroll
  for (int k = PER - 1; k >= S; --k) v[k] = v[k - S];
  const int prev = (t > 0 ? t - 1 : 0) * SP + PER - S;
#pragma unroll
  for (int k = 0; k < S; ++k) v[k] = t > 0 ? buf[prev + k] : fill;
}

// One pass of the delete chain in place: a[k] <- a[k] (+) (a at state j - s
// + c(k)), a[j - s] as shift() gives it (-inf below 0), on the same operands
// in the same order as run_chunk's pass. Below PER (s = S of 1, 2, 4, 8, 16)
// the slots go from the last down, so each reads a[k - S] before it
// changes; a larger shift reads the row it wrote to `buf` after the barrier.
template <int PER, int KT, bool LSE, int S, typename C>
__device__ __forceinline__ void block_pass_small(float (&a)[PER], float* buf, int t, int bar,
                                                 const C& c) {
  constexpr int SP = stride<PER>();
  const float ninf = neg_inf();
#pragma unroll
  for (int k = PER - S; k < PER; ++k) buf[t * SP + k] = a[k];
  group_sync<KT>(bar);
#pragma unroll
  for (int k = PER - 1; k >= S; --k) a[k] = combine<LSE>(a[k], a[k - S] + c(k));
  const int prev = (t > 0 ? t - 1 : 0) * SP + PER - S;
#pragma unroll
  for (int k = 0; k < S; ++k) a[k] = combine<LSE>(a[k], (t > 0 ? buf[prev + k] : ninf) + c(k));
}

template <int PER, int KT, bool LSE, typename C>
__device__ __forceinline__ void block_pass(float (&a)[PER], int s, float* buf, int t, int bar,
                                           const C& c) {
  if constexpr (PER > 1) {
    if (s == 1) return block_pass_small<PER, KT, LSE, 1>(a, buf, t, bar, c);
  }
  if constexpr (PER > 2) {
    if (s == 2) return block_pass_small<PER, KT, LSE, 2>(a, buf, t, bar, c);
  }
  if constexpr (PER > 4) {
    if (s == 4) return block_pass_small<PER, KT, LSE, 4>(a, buf, t, bar, c);
  }
  if constexpr (PER > 8) {
    if (s == 8) return block_pass_small<PER, KT, LSE, 8>(a, buf, t, bar, c);
  }
  if constexpr (PER > 16) {
    if (s == 16) return block_pass_small<PER, KT, LSE, 16>(a, buf, t, bar, c);
  }
  constexpr int SP = stride<PER>();
  const float ninf = neg_inf();
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[t * SP + k] = a[k];
  group_sync<KT>(bar);
  const int base = t * PER - s;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = base + k;
    a[k] = combine<LSE>(a[k], (j >= 0 ? buf[sidx<PER>(j >= 0 ? j : 0)] : ninf) + c(k));
  }
}

// The cluster of wide blocks' phases that cross threads, in place as the
// wide block's: op(v[k], the state S below, k) for every slot, the last
// slots first (so each reads v[k - S] before it changes), S < PER; thread 0
// of block r > 0 takes block r - 1's last thread's last S states through
// halo `id` (cluster_shift_small's), block 0's thread 0 `fill`.
template <int PER, int KT, int S, typename Op>
__device__ __forceinline__ void wide_cluster_small(float (&v)[PER], float fill, float* buf, int t,
                                                   int bar, Cluster& c, int id, const Op& op) {
  static_assert(S <= kHaloSlots, "a small shift's halo");
  using A = WideArea<PER, KT>;
  constexpr int SP = stride<PER>();
  if (c.rank + 1 < c.nblk && t == KT - 1) {
    const unsigned halo = peer_addr(A::halo(c, id), c.rank + 1);
    const unsigned hbar = peer_addr(A::bar(c, id), c.rank + 1);
#pragma unroll
    for (int k = 0; k < S; ++k) st_async(halo + 4 * k, v[PER - S + k], hbar);
  }
#pragma unroll
  for (int k = PER - S; k < PER; ++k) buf[t * SP + k] = v[k];
  group_sync<KT>(bar);
#pragma unroll
  for (int k = PER - 1; k >= S; --k) op(v[k], v[k - S], k);
  if (t > 0) {
    const int prev = (t - 1) * SP + PER - S;
#pragma unroll
    for (int k = 0; k < S; ++k) op(v[k], buf[prev + k], k);
  } else if (c.rank > 0) {
    const unsigned hbar = smem_addr(A::bar(c, id));
    mbar_expect(hbar, 4 * S);
    mbar_wait(hbar, (c.hphase >> id) & 1u);
    c.hphase ^= 1u << id;
    const float* halo = A::halo(c, id);
#pragma unroll
    for (int k = 0; k < S; ++k) op(v[k], halo[k], k);
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k) op(v[k], fill, k);
  }
}

// The releases a block sends for a row's use with shift s (the step's
// larger shift of halo id `id`): to the blocks that will store into it
// there (thread 0: rank - q, thread 1: rank - q - 1), into their halo slots
// of `id`, completing their halo mbarrier `id`, which no small shift of the
// case uses (a larger shift's pass is past PER).
template <int PER, int KT>
__device__ __forceinline__ void wide_cluster_release(int s, int id, int t, Cluster& c) {
  constexpr int N = KT * PER;
  const int q = s / N;
  const int rest = s - q * N;
  const int to = t == 0 ? (q >= 1 ? c.rank - q : -1) : (rest > 0 ? c.rank - q - 1 : -1);
  if (t < 2 && to >= 0) {
    using A = WideArea<PER, KT>;
    st_async(peer_addr(A::halo(c, id) + t, to), 0.0f, peer_addr(A::bar(c, id), to));
  }
}

// The same for a larger shift by s (cluster_shift_big's stores and waits;
// `i` the larger shift's index in this step's n, `id` its halo id): each
// slot's state j - s comes from this block's shift buffer, the row other
// blocks stored, or `fill`, and every read is of shared memory, so the slots
// change in place. A row's release for its use i + 2 goes out after the
// barrier of use i + 1 (every thread of the block has read the row by
// then), not after a barrier of its own: one barrier a larger shift, as the
// wide block's. Each use's releases complete an mbarrier of their own (the
// sender's halo mbarrier of that use's id), not one of the row's two: a
// release for use i + 2 may come from a block that does not wait for this
// one's use i (q grows with s, so the blocks that store into a row change),
// and would otherwise land in the phase of use i.
template <int PER, int KT, typename Op>
__device__ __forceinline__ void wide_cluster_big(float (&v)[PER], int s, float fill, float* buf,
                                                 int t, int bar, Cluster& c, int i, int n, int id,
                                                 const Op& op) {
  using A = WideArea<PER, KT>;
  constexpr int SP = stride<PER>();
  constexpr int N = KT * PER;  // a block's states
  const int qq = i & 1;
  const int q = s / N;
  const int rest = s - q * N;
  const bool to_a = q >= 1 && c.rank + q < c.nblk;
  const bool to_b = rest > 0 && c.rank + q + 1 < c.nblk;
  if (to_a || to_b) {
    if (i >= 2) {
      const unsigned fbar = smem_addr(A::bar(c, id));
      if (t == 0) mbar_expect(fbar, 4 * (int(to_a) + int(to_b)));
      mbar_wait(fbar, (c.hphase >> id) & 1u);
      c.hphase ^= 1u << id;
    }
    const int dst_a = min(c.rank + q, c.nblk - 1);
    const int dst_b = min(c.rank + q + 1, c.nblk - 1);
    const unsigned row_a = peer_addr(A::row(c, qq), dst_a);
    const unsigned bar_a = peer_addr(A::bar(c, kHaloIds + 2 + qq), dst_a);
    const unsigned row_b = peer_addr(A::row(c, qq), dst_b);
    const unsigned bar_b = peer_addr(A::bar(c, kHaloIds + 2 + qq), dst_b);
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
  // the block has read use i - 1's row: its use i + 1 (a shift by 2s) may
  // be stored
  if (i >= 1 && i + 1 < n) wide_cluster_release<PER, KT>(s << 1, id + 1, t, c);
  const bool from_a = q >= 1 && c.rank - q >= 0;
  const bool from_b = rest > 0 && c.rank - q - 1 >= 0;
  const float* row = A::row(c, qq);
  if (from_a || from_b) {
    const unsigned rbar = smem_addr(A::bar(c, kHaloIds + 2 + qq));
    if (t == 0) mbar_expect(rbar, 4 * ((from_a ? N - rest : 0) + (from_b ? rest : 0)));
    mbar_wait(rbar, (c.rphase >> qq) & 1u);
    c.rphase ^= 1u << qq;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int l = t * PER + k;
    float x;
    if (l >= rest) {
      x = q == 0 ? buf[sidx<PER>(l - rest)] : from_a ? row[sidx<PER>(l)] : fill;
    } else {
      x = from_b ? row[sidx<PER>(l)] : fill;
    }
    op(v[k], x, k);
  }
}

// A cluster of wide blocks' shift by one in place (`id` its halo).
template <int PER, int KT>
__device__ __forceinline__ void wide_cluster_shift1(float (&v)[PER], float* buf, int t, int bar,
                                                    Cluster& c, int id) {
  wide_cluster_small<PER, KT, 1>(v, neg_inf(), buf, t, bar, c, id,
                                 [](float& x, float y, int) { x = y; });
}

// A cluster of wide blocks' chain pass p in place: a[k] <- a[k] (+) (a at
// state j - 2^p + c(k)), on block_pass's operands in its order; passes below
// PER are small (halo `2 + p`), the later ones the step's larger shifts.
template <int PER, int KT, bool LSE, typename C>
__device__ __forceinline__ void wide_cluster_pass(float (&a)[PER], int p, int n_passes,
                                                  float* buf, int t, int bar, Cluster& cl,
                                                  const C& c) {
  const auto op = [&](float& x, float y, int k) { x = combine<LSE>(x, y + c(k)); };
  const int s = 1 << p;
  const float ninf = neg_inf();
  constexpr int kSmall = small_passes<PER>();
  if constexpr (PER > 1) {
    if (s == 1) return wide_cluster_small<PER, KT, 1>(a, ninf, buf, t, bar, cl, 2 + p, op);
  }
  if constexpr (PER > 2) {
    if (s == 2) return wide_cluster_small<PER, KT, 2>(a, ninf, buf, t, bar, cl, 2 + p, op);
  }
  if constexpr (PER > 4) {
    if (s == 4) return wide_cluster_small<PER, KT, 4>(a, ninf, buf, t, bar, cl, 2 + p, op);
  }
  if constexpr (PER > 8) {
    if (s == 8) return wide_cluster_small<PER, KT, 8>(a, ninf, buf, t, bar, cl, 2 + p, op);
  }
  if constexpr (PER > 16) {
    if (s == 16) return wide_cluster_small<PER, KT, 16>(a, ninf, buf, t, bar, cl, 2 + p, op);
  }
  wide_cluster_big<PER, KT>(a, s, ninf, buf, t, bar, cl, p - kSmall, n_passes - kSmall, 2 + p,
                            op);
}

// Steps [0, count) of the chunk whose tokens are in gs.toks, for the wide
// block's eager (LSE false) and log-space cases: run_chunk's step. A block
// of a cluster of wide blocks (SPAN kCluster, `h` its place) takes its
// slice of the emission and thread-major rows, its shifts across the
// cluster (wide_cluster_shift1, wide_cluster_pass) and E over the cluster
// (wide_cluster_reduce). CARRY is the lazy kernel's step on the whole chain
// (its case past 32,768 states, where the chain has 16 passes and no window
// is certified): the D row carries pre_diag, which the step reads as the
// diagonal where the eager step combines it from M, I and D, and computes
// for the new rows at its end, as run_chunk's lazy step does (max(max(M +
// tmm, I + tim), D + tdm), D the chain's result); E is max_j M_j.
template <int PER, int KT, bool LSE, Span SPAN = Span::kGroup, bool CARRY = false>
__device__ __forceinline__ void block_chunk(const ViterbiArgs& a, const float* cs,
                                            const GroupSmem<PER, KT, false>& gs, Rows<PER>& r,
                                            int count, int& par, float tr_loop, float tr_move,
                                            int t, int bar, Link<SPAN>* h = nullptr) {
  static_assert(!(CARRY && LSE), "the lazy step is Viterbi's");
  constexpr int SP = stride<PER>();
  constexpr bool kLinked = SPAN == Span::kCluster;
  const int m_pad = a.m_pad;
  const float ninf = neg_inf();
  const float tr_b_mk = a.consts[0];
  const float tr_e_c = a.consts[1];
  const float tr_e_j = a.consts[2];
  const int n_staged = a.n_trans + a.n_chain;
  // a cluster's block reads its slice of the thread-major rows (the wide
  // block alone keeps the parent code's expressions, and so its registers)
  [[maybe_unused]] size_t slice = 0;
  if constexpr (kLinked) slice = static_cast<size_t>(h->rank) * (kTransRows + a.n_passes) * PER * KT;
  const BlockRows<PER, KT> tr{cs + t * SP, kLinked ? a.tm + slice + t : a.tm + t, n_staged};
  const float* msc = static_cast<const float*>(a.msc);
  const float* isc = static_cast<const float*>(a.isc);

  if constexpr (kLinked) {
    prefetch_half<PER, KT, float>(gs.em(0), gs.ei(0), msc, isc, token(gs.toks, 0), m_pad, *h, t);
  } else {
    prefetch_emissions<PER, KT>(gs.em(0), gs.ei(0), msc, isc, token(gs.toks, 0), m_pad, t);
  }
  cp_async_commit();
  for (int step = 0; step < count; ++step) {
    // the j-1 diagonal: pre_diag of the previous step, shifted by one
    float v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      v[k] = CARRY ? r.d[k]
                   : combine<LSE>(combine<LSE>(r.m[k] + tr(0, k), r.i[k] + tr(3, k)),
                                  r.d[k] + tr(5, k));
    }
    cp_async_wait_all();  // this step's emission rows (the barrier publishes them)
    if constexpr (kLinked) {
      wide_cluster_shift1<PER, KT>(v, gs.xbuf(par), t, bar, *h, 0);
    } else {
      block_shift_small<PER, KT, 1>(v, ninf, gs.xbuf(par), t, bar);
    }
    par ^= 1;

    const float bt = r.sb + tr_b_mk;
    const float* ms = gs.em(0) + t * SP;
    const float* is = gs.ei(0) + t * SP;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const float nm = ms[k] + combine<LSE>(v[k], bt);
      r.i[k] = is[k] + combine<LSE>(r.m[k] + tr(1, k), r.i[k] + tr(4, k));
      r.m[k] = nm;
      v[k] = nm + tr(2, k);
    }
    if constexpr (kLinked) {
      wide_cluster_shift1<PER, KT>(v, gs.xbuf(par), t, bar, *h, 1);
    } else {
      block_shift_small<PER, KT, 1>(v, ninf, gs.xbuf(par), t, bar);
    }
    par ^= 1;
    // every thread has read this step's emission rows: the next step's go
    // into the same buffers while the chain runs
    if (step + 1 < count) {
      if constexpr (kLinked) {
        prefetch_half<PER, KT, float>(gs.em(0), gs.ei(0), msc, isc, token(gs.toks, step + 1),
                                      m_pad, *h, t);
      } else {
        prefetch_emissions<PER, KT>(gs.em(0), gs.ei(0), msc, isc, token(gs.toks, step + 1), m_pad,
                                    t);
      }
    }
    cp_async_commit();
    for (int p = 0; p < a.n_passes; ++p) {
      const int q = kTransRows + p;
      if constexpr (kLinked) {
        float* buf = gs.xbuf(par);
        if (q < n_staged) {
          const float* c = cs + q * row_floats<PER, KT>() + t * SP;
          wide_cluster_pass<PER, KT, LSE>(v, p, a.n_passes, buf, t, bar, *h,
                                          [&](int k) { return c[k]; });
        } else {
          const float* c = a.tm + slice + t + static_cast<size_t>(q) * PER * KT;
          wide_cluster_pass<PER, KT, LSE>(v, p, a.n_passes, buf, t, bar, *h,
                                          [&](int k) { return __ldg(c + k * KT); });
        }
      } else if (q < n_staged) {
        const float* c = cs + q * row_floats<PER, KT>() + t * SP;
        block_pass<PER, KT, LSE>(v, 1 << p, gs.xbuf(par), t, bar, [&](int k) { return c[k]; });
      } else {
        // the thread-major copy: a warp reads 32 contiguous floats a slot
        const float* c = a.tm + t + static_cast<size_t>(q) * PER * KT;
        block_pass<PER, KT, LSE>(v, 1 << p, gs.xbuf(par), t, bar,
                                 [&](int k) { return __ldg(c + k * KT); });
      }
      par ^= 1;
    }

    float e = ninf;
    if constexpr (LSE) {
      // the terms x_k wait in this thread's slots of the shift buffer the
      // last pass left idle (its readers passed that pass's barrier)
      float* x = gs.xbuf(par) + t * SP;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        x[k] = combine<true>(r.m[k], v[k]);
        e = fmaxf(e, x[k]);
      }
      if constexpr (kLinked) {
        const float mx = wide_cluster_reduce<false, PER, KT>(e, t, *h);
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < PER; ++k) sum += expf(x[k] == mx ? 0.0f : x[k] - mx);
        e = mx + logf(wide_cluster_reduce<true, PER, KT>(sum, t, *h));
      } else {
        const float mx = block_reduce<false, KT>(e, gs.red, t, bar);
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < PER; ++k) sum += expf(x[k] == mx ? 0.0f : x[k] - mx);
        e = mx + logf(block_reduce<true, KT>(sum, gs.red + warps<KT>(), t, bar));
      }
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) e = fmaxf(e, CARRY ? r.m[k] : fmaxf(r.m[k], v[k]));
      if constexpr (kLinked) {
        e = wide_cluster_reduce<false, PER, KT>(e, t, *h);
      } else {
        e = block_reduce<false, KT>(e, gs.red, t, bar);
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      // the lazy carry: the new rows' pre_diag, in run_chunk's order
      r.d[k] = CARRY ? fmaxf(fmaxf(r.m[k] + tr(0, k), r.i[k] + tr(3, k)), v[k] + tr(5, k)) : v[k];
    }
    r.sj = combine<LSE>(r.sj + tr_loop, e + tr_e_j);
    r.sc = combine<LSE>(r.sc + tr_loop, e + tr_e_c);
    r.sn = r.sn + tr_loop;
    r.sb = combine<LSE>(r.sn + tr_move, r.sj + tr_move);
  }
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

// The kernel's body, for a block of G groups (viterbi_kernel), for a block
// of the cluster pair (viterbi_pair_kernel) or for one of a C-block cluster
// (viterbi_cluster_kernel; both one group a block, KT = 128), or for the
// wide block's one group of KT = kBlockThreads, alone (viterbi_block_kernel)
// or in a cluster of wide blocks (viterbi_block_cluster_kernel), whose
// chunks run block_chunk.
template <int PER, int KT, bool LAZY, bool LSE, bool FILT, Span SPAN>
__device__ __forceinline__ void viterbi_body(const ViterbiArgs& a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ROW = row_floats<PER, KT>();
  const int m_pad = a.m_pad;
  const float ninf = neg_inf();
  const bool certify = LAZY && a.k_run < a.n_passes;
  const int n_trans = KT == 128 ? kTransRows : a.n_trans;
  const int n_rows = viterbi_rows(LAZY, a.k_run, a.n_passes, a.n_chain, n_trans);
  // a cluster's block follows states col0 .. col0 + KT * PER - 1
  constexpr bool kLinked = SPAN != Span::kGroup;
  Link<SPAN> h;
  h.rank = 0;
  h.col0 = 0;
  h.m_real = m_pad;
  if constexpr (kLinked) {
    h.rank = static_cast<int>(cluster_rank());
    h.col0 = h.rank * KT * PER;
    h.m_real = min(max(m_pad - h.col0, 0), KT * PER);
  }
  if constexpr (SPAN == Span::kCluster) h.nblk = static_cast<int>(cluster_size());

  for (int q = 0; q < n_trans; ++q) {
    stage_row<PER, KT>(smem + q * ROW, a.trans + q * m_pad + h.col0, h.m_real, ninf);
  }
  for (int p = 0; p < a.n_chain; ++p) {
    stage_row<PER, KT>(smem + (n_trans + p) * ROW, a.chain + p * m_pad + h.col0, h.m_real, ninf);
  }
  if (certify) {
    stage_row<PER, KT>(smem + (n_trans + a.n_chain) * ROW, a.chain + 15 * m_pad + h.col0,
                       h.m_real, ninf);
  }

  const int groups = blockDim.x / KT;
  const int g = threadIdx.x / KT;
  const int t = threadIdx.x % KT;
  const int bar = 1 + g;
  const GroupSmem<PER, KT, FILT> gs =
      group_smem<PER, KT, FILT>(smem + n_rows * ROW + g * group_floats<PER, KT, FILT>(false));
  if constexpr (kLinked) {
    // the cluster's exchange area follows the block's one group (a wide
    // block's: block_smem_floats)
    float* area;
    if constexpr (KT != kBlockThreads) {
      area = smem + n_rows * ROW + group_floats<PER, KT, FILT>(false);
    } else {
      area = smem + block_smem_floats<PER, KT>(n_rows);
    }
    if constexpr (SPAN == Span::kPair) {
      pair_setup<PER, KT>(h, area, t);
    } else {
      cluster_setup<PER, KT>(h, area, t);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int q = 0; q < (KT == kBlockThreads ? 1 : 2); ++q) {
    if constexpr (FILT) {
      fill_tail_bf16<PER, KT>(reinterpret_cast<uint16_t*>(gs.em(q)), h.m_real, 0xff80u, t);
      fill_tail_bf16<PER, KT>(reinterpret_cast<uint16_t*>(gs.ei(q)), h.m_real, 0xff80u, t);
    } else {
      fill_tail<PER, KT>(gs.em(q), h.m_real, ninf, t);
      fill_tail<PER, KT>(gs.ei(q), h.m_real, ninf, t);
    }
  }
  __syncthreads();  // the staged rows; from here on each group keeps to itself
  // a cluster: its blocks run, and their mbarriers exist, before any
  // reaches another's memory
  if constexpr (kLinked) cluster_sync();

  // the passes a step runs: the whole chain, the lazy window or the
  // filter's window
  const int passes = (LAZY || FILT) ? a.k_run : a.n_passes;
  const int b_pad = a.b_pad;
  // the sequences of this group: a cluster's blocks follow the same ones
  for (int seq = kLinked ? cluster_id() : blockIdx.x * groups + g; seq < b_pad;
       seq += kLinked ? cluster_count() : gridDim.x * groups) {
    const size_t row = static_cast<size_t>(seq) * m_pad + h.col0;
    Rows<PER> r;
    load_carries<PER, KT>(r, a.m_in + row, a.i_in + row, a.d_in + row, h.m_real, gs.xbuf(0), t,
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
      if constexpr (KT == kBlockThreads && kLinked) {
        block_chunk<PER, KT, LSE, SPAN, LAZY>(a, smem, gs, r, count, par, tr_loop, tr_move, t, bar,
                                              &h);
      } else if constexpr (KT == kBlockThreads) {
        block_chunk<PER, KT, LSE>(a, smem, gs, r, count, par, tr_loop, tr_move, t, bar);
      } else if (certify) {
        store_carries<PER, KT>(r, a.m_out + row, a.i_out + row, a.d_out + row, h.m_real,
                               gs.xbuf(0), t, bar);  // the chunk's entry
        const float ej = r.sj, ec = r.sc, en = r.sn, eb = r.sb;
        const bool viol = run_chunk<PER, KT, LAZY, LSE, true, FILT, SPAN>(
            a, smem, gs, r, count, a.k_run, par, tr_loop, tr_move, t, bar, h);
        bool fired;
        // a cluster's blocks replay the same chunks
        if constexpr (SPAN == Span::kPair) {
          fired = pair_any<KT>(viol, t, h);
        } else if constexpr (SPAN == Span::kCluster) {
          fired = cluster_any<KT>(viol, t, h);
        } else {
          fired = group_any<KT>(bar, viol);
        }
        if (fired) {
          load_carries<PER, KT>(r, a.m_out + row, a.i_out + row, a.d_out + row, h.m_real,
                                gs.xbuf(0), t, bar);
          r.sj = ej;
          r.sc = ec;
          r.sn = en;
          r.sb = eb;
          run_chunk<PER, KT, LAZY, LSE, false, FILT, SPAN>(a, smem, gs, r, count, a.n_passes,
                                                           par, tr_loop, tr_move, t, bar, h);
          ++replays;
        }
      } else {
        run_chunk<PER, KT, LAZY, LSE, false, FILT, SPAN>(a, smem, gs, r, count, passes, par,
                                                         tr_loop, tr_move, t, bar, h);
      }
      group_sync<KT>(bar);  // every step's reads of the shift buffers and toks are done
    }

    store_carries<PER, KT>(r, a.m_out + row, a.i_out + row, a.d_out + row, h.m_real, gs.xbuf(0),
                           t, bar);
    if (t == 0 && h.rank == 0) {
      a.s_out[seq] = r.sj;
      a.s_out[b_pad + seq] = r.sc;
      a.s_out[2 * b_pad + seq] = r.sn;
      a.s_out[3 * b_pad + seq] = r.sb;
      a.scores[seq] = r.sc + tr_move;
      if (LAZY) a.replays[seq] = replays;
    }
  }
  // no block leaves while another of its cluster may still reach its
  // shared memory
  if constexpr (kLinked) cluster_sync();
}

template <int PER, int KT, bool LAZY, bool LSE, bool FILT>
__global__ void viterbi_kernel(const ViterbiArgs a) {
  viterbi_body<PER, KT, LAZY, LSE, FILT, Span::kGroup>(a);
}

// The wide case: a block of the cluster pair (launched as 2-block clusters).
template <int PER, bool LAZY, bool LSE, bool FILT>
__global__ void __launch_bounds__(128) viterbi_pair_kernel(const ViterbiArgs a) {
  viterbi_body<PER, 128, LAZY, LSE, FILT, Span::kPair>(a);
}

// Past 4864 states, the lazy and filter cases: a block of a C-block cluster
// (launched as C-block clusters, C read from %cluster_nctarank).
template <int PER, bool LAZY, bool LSE, bool FILT>
__global__ void __launch_bounds__(128) viterbi_cluster_kernel(const ViterbiArgs a) {
  viterbi_body<PER, 128, LAZY, LSE, FILT, Span::kCluster>(a);
}

// Past 38,912 states, the filter case: a block of a C-block cluster of
// kWideClusterThreads-thread blocks (launched as C-block clusters, C read
// from %cluster_nctarank; run_chunk's step at KT = 256, the rows it does not
// stage read from its slice of the thread-major copy).
template <int PER>
__global__ void __launch_bounds__(kWideClusterThreads, 1)
    viterbi_wide_cluster_kernel(const ViterbiArgs a) {
  viterbi_body<PER, kWideClusterThreads, false, false, true, Span::kCluster>(a);
}

// The wide block's case (block_chunk's step), one sequence a block: no row
// crosses global memory but the carries at a sequence's start and end.
template <int PER, int KT, bool LSE>
__global__ void __launch_bounds__(KT, 1) viterbi_block_kernel(const ViterbiArgs a) {
  viterbi_body<PER, KT, false, LSE, false, Span::kGroup>(a);
}

// Past kBlockThreads * kBlockPerMax states, the eager and log-space cases,
// and past 32,768 the lazy one (LAZY: its whole-chain step, block_chunk's
// CARRY): a wide block of a cluster of C of them (launched as C-block
// clusters of kBlockThreads threads a block, C read from %cluster_nctarank;
// block_chunk's step across the cluster).
template <int PER, int KT, bool LSE, bool LAZY = false>
__global__ void __launch_bounds__(KT, 1) viterbi_block_cluster_kernel(const ViterbiArgs a) {
  viterbi_body<PER, KT, LAZY, LSE, false, Span::kCluster>(a);
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
  a.tm = nullptr;
  return a;
}

// Checks every entry point shares: the operands' limits and the plan.
// `windowed`: the lazy and filter cases, which run k_run passes a step.
// The cluster pair (PAIR) takes twice the states, one group a block, an
// even grid and pair_smem_floats.
template <int PER, int KT, bool FILT, bool PAIR = false>
bool viterbi_plan_ok(const ViterbiArgs& a, bool lazy, bool windowed, int groups, int grid,
                     int smem_bytes) {
  const int passes_run = windowed ? a.k_run : a.n_passes;
  const int n_rows = viterbi_rows(lazy, a.k_run, a.n_passes, a.n_chain, a.n_trans);
  const bool shape_ok =
      PAIR ? KT == 128 && groups == 1 && grid >= 2 && grid % 2 == 0 &&
                 a.n_trans == kTransRows &&
                 static_cast<size_t>(smem_bytes) == 4 * pair_smem_floats<PER, KT, FILT>(n_rows) &&
                 smem_bytes <= kMaxSmem
           : plan_ok<PER, KT, FILT>(groups, grid, smem_bytes, n_rows, a.n_trans, false);
  return a.m_pad >= 1 && a.m_pad <= (PAIR ? 2 : 1) * KT * PER && a.m_pad % 8 == 0 &&
         a.n_passes >= 1 && a.k_run >= 1 && a.k_run <= a.n_passes && a.n_chain >= 0 &&
         a.n_chain <= passes_run && a.b_pad >= 1 && shape_ok;
}

// The same for the C-block cluster's case (`c` blocks a cluster, 3..16):
// c * KT * PER states, one group a block, a grid of whole clusters and
// cluster_smem_floats; up to 16 chain passes, where the lazy kernel runs the
// whole chain (row 15 of its chain is then chain data, not Cmax).
template <int PER, bool FILT>
bool viterbi_cluster_plan_ok(const ViterbiArgs& a, bool lazy, int c, int groups, int grid,
                             int smem_bytes) {
  const int n_rows = viterbi_rows(lazy, a.k_run, a.n_passes, a.n_chain, a.n_trans);
  return c >= 3 && c <= kMaxCluster && groups == 1 && grid >= c && grid % c == 0 &&
         a.n_trans == kTransRows &&
         static_cast<size_t>(smem_bytes) == 4 * cluster_smem_floats<PER, 128, FILT>(n_rows) &&
         smem_bytes <= kMaxSmem && a.m_pad >= 1 && a.m_pad <= c * 128 * PER &&
         a.m_pad % 8 == 0 && a.n_passes >= 1 && a.n_passes <= 16 && a.k_run >= 1 &&
         a.k_run <= a.n_passes && (!lazy || a.k_run == a.n_passes || a.n_passes <= 15) &&
         a.n_chain >= 0 && a.n_chain <= a.k_run && a.b_pad >= 1;
}

// The same for the filter's C-block cluster of kWideClusterThreads-thread
// blocks (`c` of 2..16): c * 256 * PER states, one group a block, a grid of
// whole clusters, the transitions staged first (then chain rows) as the plan
// names them, cluster_smem_floats at 256 threads with bf16 emission rows, and
// the thread-major rows.
template <int PER>
bool viterbi_wide_cluster_plan_ok(const ViterbiArgs& a, int c, int groups, int grid,
                                  int smem_bytes) {
  const int n_rows = a.n_trans + a.n_chain;
  return a.tm != nullptr && wide_cluster_ok(a.m_pad, PER, c, groups, grid, a.n_trans) &&
         (a.n_chain == 0 || a.n_trans == kTransRows) &&
         static_cast<size_t>(smem_bytes) ==
             4 * cluster_smem_floats<PER, kWideClusterThreads, true>(n_rows) &&
         smem_bytes <= kMaxSmem && a.m_pad % 8 == 0 && a.n_passes >= 1 && a.n_passes <= 16 &&
         a.k_run >= 1 && a.k_run <= a.n_passes && a.n_chain >= 0 && a.n_chain <= a.k_run &&
         a.b_pad >= 1;
}

// The same for the wide block (eager and log-space, the full chain): KT *
// PER states, one group a block, n_trans transition rows staged and chain
// rows only after all six, block_smem_floats, and the thread-major rows;
// with `c` of 2..kMaxBlockCluster, a cluster of c wide blocks (the lazy
// kernel's too, which runs the full chain there: k_run == n_passes): c * KT
// * PER states, a grid of whole clusters and block_cluster_smem_floats.
template <int PER, int KT>
bool viterbi_block_plan_ok(const ViterbiArgs& a, int groups, int grid, int smem_bytes,
                           int c = 1) {
  const size_t bytes = c == 1 ? 4 * block_smem_floats<PER, KT>(a.n_trans + a.n_chain)
                              : 4 * block_cluster_smem_floats<PER, KT>(a.n_trans + a.n_chain);
  return c >= 1 && c <= kMaxBlockCluster && a.m_pad >= 1 && a.m_pad <= c * KT * PER &&
         a.m_pad % 8 == 0 && a.n_passes >= 1 && a.n_passes <= 16 && a.k_run == a.n_passes &&
         a.n_trans >= 0 && a.n_trans <= kTransRows && a.n_chain >= 0 &&
         a.n_chain <= a.n_passes && (a.n_chain == 0 || a.n_trans == kTransRows) &&
         a.tm != nullptr && a.b_pad >= 1 && groups == 1 && grid >= c && grid % c == 0 &&
         static_cast<size_t>(smem_bytes) == bytes && smem_bytes <= kMaxSmem;
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
