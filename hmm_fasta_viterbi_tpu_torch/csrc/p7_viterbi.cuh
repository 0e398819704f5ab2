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
// x_j = M_j (+) D_j: a block max mx, then a block sum of exp(x_j - mx) in a
// fixed order (x_j == mx contributes exp(0), so an all -inf row stays -inf),
// E = mx + log(sum). Only the accurate expf, log1pf and logf are used (no
// --use_fast_math, no __expf): the kernel differs from the plain version and
// the TPU kernel by the rounding of those functions and of the E sum's order.
//
// What bounds it on the H100: the per-step chain of dependent phases, not
// memory. Each residue needs the whole previous row (the j-1 diagonal) and
// a prefix scan along the states, so one sequence's step cannot start
// before the last one is complete, and every shift by 2^k crosses threads.
// Per cell the lazy step costs about 25 FP32 instructions at lazy_k = 5
// (the eager one about 2 * ceil(log2 M) more; the Forward mode adds an
// expf and a log1pf to every combine, some 40 instructions each) and a
// handful of shared-memory accesses for the shifts. The constants are read
// from global memory each step: a few hundred KB per profile, shared by all
// blocks, so they come from L1 and L2.
//
// What the design does about it:
//  * One block of 128 threads follows one sequence, and its residue loop
//    stops at that sequence's length: no masked pad steps, and a pad token
//    never indexes the tables. State j lives in thread j % 128, register
//    slot j / 128 (PER = ceil(M_pad / 128) slots, a template parameter, so
//    the M, I and D rows stay in registers: 3 * 19 at M = 2432).
//  * With the striped layout a shift by s is one store of the row to shared
//    memory, a barrier and one load at j - s, all conflict-free (neighbouring
//    threads, neighbouring words); two buffers alternate, so one barrier a
//    shift is enough. Global reads of the [*, M_pad] constants coalesce.
//  * E is a warp butterfly and a 4-entry shared reduction (two of them, the
//    max and the sum, in Forward mode).
//  * The lazy kernel saves a chunk's entry rows in the output carries
//    (each thread reloads only what it wrote) and its specials in
//    registers, so a replay needs no scratch. The fire is a block-wide
//    __syncthreads_or; fires are counted per sequence.
//  * States past M_pad (the last thread's pad slots) read -inf constants
//    and stay -inf; the chain only moves values to higher j, so they never
//    reach a real state, and they add exp(-inf) = 0 to Forward's E sum.
//    No --use_fast_math, no reassociation.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise. The C entry points return cudaGetLastError().

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // residues per token load and per certificate

struct ViterbiArgs {
  const float* msc;    // [20, m_pad]
  const float* isc;    // [20, m_pad]
  const float* trans;  // [8, m_pad]: tmm tmi tmd tim tii tdm tdd_s pad
  const float* chain;  // [16, m_pad]: pass constants; row 15 = Cmax (lazy)
  int m_pad;
  int n_passes;
  int k_run;  // passes of the certified schedule (lazy)
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

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// The semiring's combine: max (Viterbi) or JAX's _lse2 (log-space Forward).
template <bool LSE>
__device__ __forceinline__ float combine(float x, float y) {
  if (!LSE) return fmaxf(x, y);
  const float mx = fmaxf(x, y);
  const float d = fminf(x, y) - mx;
  return isnan(d) ? mx : mx + log1pf(expf(d));  // NaN only at (-inf, -inf)
}

// out[k] = value of state j - s (j = k * kThreads + t), `fill` where j < s.
template <int PER>
__device__ __forceinline__ void shift_states(const float (&v)[PER], float (&out)[PER],
                                             int s, float fill, float* buf) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[k * kThreads + t] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + t;
    out[k] = j >= s ? buf[j - s] : fill;
  }
}

__device__ __forceinline__ float ld(const float* p, int j, int m_pad, float fill) {
  return j < m_pad ? __ldg(p + j) : fill;
}

// Block-wide max or sum of one value a thread, the four warp results
// combined in a fixed order through `red` (4 floats).
template <bool SUM>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, v, off);
    v = SUM ? v + o : fmaxf(v, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return SUM ? (red[0] + red[1]) + (red[2] + red[3])
             : fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

// The block's state: rows in registers, specials replicated in every thread.
template <int PER>
struct Rows {
  float m[PER];
  float i[PER];
  float d[PER];  // D (eager, Forward) or pre_diag (lazy)
  float sj, sc, sn, sb;
};

// Steps [0, count) of the chunk whose tokens are in `toks`. Returns whether
// the certificate fired (CERT only). `red` holds 2 * kWarps floats.
template <int PER, bool LAZY, bool LSE, bool CERT>
__device__ __forceinline__ bool run_chunk(const ViterbiArgs& a, Rows<PER>& r,
                                          const int* toks, int count, int passes,
                                          float (*xbuf)[kThreads * PER], int& par,
                                          float* red, float tr_loop, float tr_move) {
  static_assert(!(LAZY && LSE), "the lazy schedule is Viterbi only");
  const int t = threadIdx.x;
  const int m_pad = a.m_pad;
  const float ninf = neg_inf();
  const float tr_b_mk = a.consts[0];
  const float tr_e_c = a.consts[1];
  const float tr_e_j = a.consts[2];
  const float tmd_max = LAZY ? a.consts[4] : 0.0f;
  const float* tmm = a.trans;
  const float* tmi = a.trans + m_pad;
  const float* tmd = a.trans + 2 * m_pad;
  const float* tim = a.trans + 3 * m_pad;
  const float* tii = a.trans + 4 * m_pad;
  const float* tdm = a.trans + 5 * m_pad;
  const float* cmax = a.chain + 15 * m_pad;
  bool viol = false;

  for (int step = 0; step < count; ++step) {
    const int aa = min(max(toks[step], 0), 19);
    const float* ms = a.msc + aa * m_pad;
    const float* is = a.isc + aa * m_pad;

    // the j-1 diagonal: pre_diag of the previous step, shifted by one
    float pd[PER];
    if (LAZY) {
#pragma unroll
      for (int k = 0; k < PER; ++k) pd[k] = r.d[k];
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = k * kThreads + t;
        pd[k] = combine<LSE>(combine<LSE>(r.m[k] + ld(tmm, j, m_pad, ninf),
                                          r.i[k] + ld(tim, j, m_pad, ninf)),
                             r.d[k] + ld(tdm, j, m_pad, ninf));
      }
    }
    float diag[PER];
    shift_states<PER>(pd, diag, 1, ninf, xbuf[par]);
    par ^= 1;

    const float bt = r.sb + tr_b_mk;
    float nm[PER], ni[PER], ac[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = k * kThreads + t;
      nm[k] = ld(ms, j, m_pad, ninf) + combine<LSE>(diag[k], bt);
      ni[k] = ld(is, j, m_pad, ninf) + combine<LSE>(r.m[k] + ld(tmi, j, m_pad, ninf),
                                                    r.i[k] + ld(tii, j, m_pad, ninf));
      pd[k] = nm[k] + ld(tmd, j, m_pad, ninf);
    }
    shift_states<PER>(pd, ac, 1, ninf, xbuf[par]);
    par ^= 1;
    for (int p = 0; p < passes; ++p) {
      const int s = 1 << p;
      const float* c = a.chain + p * m_pad;
      float sh[PER];
      shift_states<PER>(ac, sh, s, ninf, xbuf[par]);
      par ^= 1;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        ac[k] = combine<LSE>(ac[k], sh[k] + ld(c, k * kThreads + t, m_pad, ninf));
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
      const float mx = block_reduce<false>(e, red);
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < PER; ++k) sum += expf(x[k] == mx ? 0.0f : x[k] - mx);
      e = mx + logf(block_reduce<true>(sum, red + kWarps));
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) e = fmaxf(e, LAZY ? nm[k] : fmaxf(nm[k], ac[k]));
      e = block_reduce<false>(e, red);
    }

#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = k * kThreads + t;
      if (LAZY) {
        const float tdm_j = ld(tdm, j, m_pad, ninf);
        const float stay = fmaxf(nm[k] + ld(tmm, j, m_pad, ninf), ni[k] + ld(tim, j, m_pad, ninf));
        const float npd = fmaxf(stay, ac[k] + tdm_j);
        if (CERT) {
          // the bound's own rounding path, in this order
          const float t_row = ((e + tmd_max) + ld(cmax, j, m_pad, ninf)) + tdm_j;
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
__device__ __forceinline__ void store_rows(const Rows<PER>& r, float* m, float* i, float* d,
                                           size_t row, int m_pad) {
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (j < m_pad) {
      m[row + j] = r.m[k];
      i[row + j] = r.i[k];
      d[row + j] = r.d[k];
    }
  }
}

template <int PER>
__device__ __forceinline__ void load_rows(Rows<PER>& r, const float* m, const float* i,
                                          const float* d, size_t row, int m_pad) {
  const float ninf = neg_inf();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + threadIdx.x;
    const bool in = j < m_pad;
    r.m[k] = in ? m[row + j] : ninf;
    r.i[k] = in ? i[row + j] : ninf;
    r.d[k] = in ? d[row + j] : ninf;
  }
}

template <int PER, bool LAZY, bool LSE>
__global__ void __launch_bounds__(kThreads) viterbi_kernel(const ViterbiArgs a) {
  __shared__ float xbuf[2][kThreads * PER];
  __shared__ float red[2 * kWarps];
  __shared__ int toks[kChunk];

  const int seq = blockIdx.x;
  const int t = threadIdx.x;
  const int m_pad = a.m_pad;
  const size_t row = static_cast<size_t>(seq) * m_pad;
  const int b_pad = a.b_pad;

  Rows<PER> r;
  load_rows<PER>(r, a.m_in, a.i_in, a.d_in, row, m_pad);
  r.sj = a.s_in[seq];
  r.sc = a.s_in[b_pad + seq];
  r.sn = a.s_in[2 * b_pad + seq];
  r.sb = a.s_in[3 * b_pad + seq];
  const float tr_loop = a.tr_rows[seq];
  const float tr_move = a.tr_rows[b_pad + seq];
  const int n = min(max(a.lengths[seq], 0), a.l_pad);
  const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
  const bool certify = LAZY && a.k_run < a.n_passes;
  int par = 0;
  int replays = 0;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int count = min(kChunk, n - c0);
    __syncthreads();  // the previous chunk's readers of toks are done
    if (t < count) toks[t] = tok_row[c0 + t];
    __syncthreads();
    if (certify) {
      store_rows<PER>(r, a.m_out, a.i_out, a.d_out, row, m_pad);  // chunk entry
      const float ej = r.sj, ec = r.sc, en = r.sn, eb = r.sb;
      const bool viol = run_chunk<PER, LAZY, LSE, true>(a, r, toks, count, a.k_run, xbuf,
                                                        par, red, tr_loop, tr_move);
      if (__syncthreads_or(viol)) {
        load_rows<PER>(r, a.m_out, a.i_out, a.d_out, row, m_pad);
        r.sj = ej;
        r.sc = ec;
        r.sn = en;
        r.sb = eb;
        run_chunk<PER, LAZY, LSE, false>(a, r, toks, count, a.n_passes, xbuf, par, red,
                                         tr_loop, tr_move);
        ++replays;
      }
    } else {
      run_chunk<PER, LAZY, LSE, false>(a, r, toks, count, a.n_passes, xbuf, par, red,
                                       tr_loop, tr_move);
    }
  }

  store_rows<PER>(r, a.m_out, a.i_out, a.d_out, row, m_pad);
  if (t == 0) {
    a.s_out[seq] = r.sj;
    a.s_out[b_pad + seq] = r.sc;
    a.s_out[2 * b_pad + seq] = r.sn;
    a.s_out[3 * b_pad + seq] = r.sb;
    a.scores[seq] = r.sc + tr_move;
    if (LAZY) a.replays[seq] = replays;
  }
}

// The pointer arguments of both C entry points, in their order.
inline ViterbiArgs make_args(const void* msc, const void* isc, const void* trans,
                             const void* chain, int m_pad, int n_passes, int k_run,
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

}  // namespace
