// Scaled-probability backward pass emitting posterior coverage, written by
// hand for Hopper (sm_90a): a case of the blocked p7 layout (p7_blocked.cuh).
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_posterior.py::_bwd_cov_kernel,
// as launched by _posterior_padded: the second pass of the posterior
// --domains decode. The first pass is the SAVE case of p7_forward_kernel.cu,
// which leaves each step's scaled match row fm[t] (bf16) and its log scale
// ls[t], and the total log P (the Forward score, with the final C -> T
// move). This pass runs over t = length-1 ... 0 of each sequence, with
// beta rows over the match and insert states in probability space:
//   start (the L boundary, the multihit local model's emission-free exits):
//     bc = p_move, be = p_E_C * bc, bd = suffix chain of be on every row,
//     bm_j = tmd_j * bd_{j+1} + be, bi = bj = bn = 0, lsb = 0;
//   at each t:
//     cov[t] = (sum_j fm[t, j] * bm_j) * exp(ls[t] + lsb - total)
//   then, with the token of position t (the betas before it):
//     memit = modds[tok] * bm, iemit = iodds[tok] * bi, m_next_j = memit_{j+1}
//     bspec = p_B_Mk * sum_j memit_j
//     J = p_loop * J + p_move * bspec,  N = p_loop * N + p_move * bspec,
//     C = p_loop * C,  E = p_E_C * C + p_E_J * J
//     I = tim * m_next + tii * iemit
//     D = the suffix delete chain of tdm * m_next + E (window products of
//         tdd toward lower j: a_j += a_{j + 2^k} * schain[k][j])
//     M = tmm * m_next + tmi * iemit + tmd * D_{j+1} + E
//   and after every `group` steps of the sequence every beta and special is
//   divided by s = max(max_j bm_j, C, max(N, 1e-30)), log s added to lsb
//   with Kahan compensation, as the Forward kernel rescales. The coverage
//   is the summed match posterior of position t; the posterior matrix
//   itself is never stored. cov is 0 at and past each length.
//
// What bounds it on the H100: as for the Forward kernel, the chain of
// dependent phases of one step, each ended by a barrier (the two-value sum,
// the shift of memit, W suffix-chain passes, the shift of D: 3 + W, one more
// a rescale group), and the step-invariant constants each cell reads (6
// transitions and W chain rows, plus 2 odds and 1 saved row), not memory:
// the pass reads each fm row once (2 bytes a cell, 2.95 GB at 1024 x 1024 x
// 1408, under 1 ms at 3.35 TB/s). The striped layout it replaces (state j in
// thread j % KT, one block a sequence, constants through L1/L2) spent 16.3
// ms at that shape against 6.5 ms for the row-saving Forward in this layout.
//
// What the design does about it (p7_blocked.cuh has the layout; the same as
// the Forward kernel's):
//  * the block stages the first n_trans transition rows and the first
//    n_chain suffix-chain rows in shared memory once (all of them unless
//    that would not fit: the launcher's plan says), fill 0 past M_pad; G
//    groups of KT threads share them, one sequence each, on their own named
//    barriers, in a persistent grid that walks the batch with a stride (G = 1
//    for a batch no larger than the SMs); each group walks its sequence from
//    its own last residue down to 0 (no masked steps; a pad token never
//    reaches the tables);
//  * thread t owns the contiguous states t * PER + k in registers; a shift
//    toward lower j by s < PER moves registers and passes s slots through
//    shared memory (shift_up), a larger one reads the row at j + s; one
//    barrier a shift;
//  * the odds rows of position t - 1 and its saved bf16 row (hstride layout,
//    widened exactly) arrive by cp.async while the step of t runs; the last
//    shift's barrier publishes them;
//  * the tokens and log scales of a 128-residue chunk are loaded together,
//    and its coverage is stored together, coalesced, at the chunk's end;
//  * the coverage and B sums are one two-value group reduction, in the
//    header's fixed order; the rescale max has a scratch of its own;
//  * at 9 to 12 slots and 128 threads the kernel is held to 128 registers
//    (__launch_bounds__(512)), so that 4 groups fit an SM's registers where
//    its free choice of 136-142 fit 3 (at 1400.hmm: 7.06 against 9.14 ms,
//    measured); below 9 slots it needs no more than 128, and a bound of 512
//    threads would cap the groups a block the registers allow;
//  * no --use_fast_math: expf and logf are the accurate ones, 1 / s a
//    correctly rounded division. It launches on the caller's stream,
//    allocates nothing and does not synchronise; the C entry point returns
//    cudaGetLastError().
// Past 4864 states the rows-in-memory case (backward_mem_kernel) runs the
// same step over the block's scratch rows.

#include "p7_blocked.cuh"

namespace {

struct BackwardArgs {
  const float* modds;   // [20, m_pad]
  const float* iodds;   // [20, m_pad]
  const float* trans;   // [8, m_pad]: tmm tmi tmd tim tii tdm (probabilities)
  const float* schain;  // [window, m_pad]: suffix tdd window products
  int m_pad;
  int window;
  int n_chain;  // suffix-chain rows staged in shared memory
  int n_trans;  // transition rows staged in shared memory (6 at 128 threads)
  int group;
  const int8_t* tokens;  // [b_pad, l_pad]
  int l_pad;
  const int* lengths;      // [b_pad]
  const float* tr_probs;   // [2, b_pad]: p_loop, p_move
  const float* consts;     // [3]: p_B_Mk, p_E_C, p_E_J
  const float* total;      // [b_pad]: log P (the Forward score)
  const uint16_t* fm;      // [b_pad, l_pad, m_pad] bf16 bits
  const float* ls;         // [b_pad, l_pad]
  float* cov;              // [b_pad, l_pad]
  float* scratch;          // [grid, kMemRows, m_pad]: the rows-in-memory case's rows
  int b_pad;
};

template <int PER, int KT>
__device__ __forceinline__ void backward_body(const BackwardArgs& a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ROW = row_floats<PER, KT>();
  constexpr int HROW = erow_floats<PER, KT, true>();
  constexpr int SP = stride<PER>();
  constexpr int W = warps<KT>();
  const int m_pad = a.m_pad;
  const int n_trans = KT == 128 ? kTransRows : a.n_trans;
  const int n_rows = n_trans + a.n_chain;

  for (int q = 0; q < n_trans; ++q) {
    stage_row<PER, KT>(smem + q * ROW, a.trans + q * m_pad, m_pad, 0.0f);
  }
  for (int p = 0; p < a.n_chain; ++p) {
    stage_row<PER, KT>(smem + (n_trans + p) * ROW, a.schain + p * m_pad, m_pad, 0.0f);
  }

  const int groups = blockDim.x / KT;
  const int g = threadIdx.x / KT;
  const int t = threadIdx.x % KT;
  const int bar = 1 + g;
  float* base = smem + n_rows * ROW + g * backward_group_floats<PER, KT>();
  // buffers by parity (no array indexed at run time: it would live in local memory)
  auto xbuf = [=](int par) { return base + par * ROW; };
  auto em = [=](int q) { return base + (2 + 2 * q) * ROW; };
  auto ei = [=](int q) { return base + (3 + 2 * q) * ROW; };
  auto frow = [=](int q) { return reinterpret_cast<uint16_t*>(base + 6 * ROW + q * HROW); };
  float* red = base + 6 * ROW + 2 * HROW;  // [2 W] the coverage and B sums, [W] the rescale max
  int8_t* toks = reinterpret_cast<int8_t*>(red + 3 * W);
  float* ls_c = red + 3 * W + kChunk / 4;  // the chunk's log scales
  float* cov_c = ls_c + kChunk;            // and its coverage
  for (int q = 0; q < 2; ++q) {
    fill_tail<PER, KT>(em(q), m_pad, 0.0f, t);
    fill_tail<PER, KT>(ei(q), m_pad, 0.0f, t);
    fill_tail_bf16<PER, KT>(frow(q), m_pad, 0, t);
  }
  __syncthreads();  // the staged rows; from here on each group keeps to itself

  const int off = t * SP;
  const TransRows<PER, KT> tr{smem + off, a.trans, n_trans, m_pad, t * PER, 0.0f};
  const float* chain_s = smem + n_trans * ROW + off;
  const float p_b_mk = a.consts[0];
  const float p_e_c = a.consts[1];
  const float p_e_j = a.consts[2];
  const int b_pad = a.b_pad;

  for (int seq = blockIdx.x * groups + g; seq < b_pad; seq += gridDim.x * groups) {
    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    float* cov_row = a.cov + static_cast<size_t>(seq) * a.l_pad;
    for (int pos = n + t; pos < a.l_pad; pos += KT) cov_row[pos] = 0.0f;
    if (n == 0) continue;  // the whole group: n is the group's

    const float p_loop = a.tr_probs[seq];
    const float p_move = a.tr_probs[b_pad + seq];
    const float total = a.total[seq];
    const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
    const uint16_t* fm_seq = a.fm + static_cast<size_t>(seq) * a.l_pad * m_pad;
    const float* ls_row = a.ls + static_cast<size_t>(seq) * a.l_pad;
    int par = 0;

    // the suffix delete chain in place: `window` passes a_j += a_{j+2^p} * c_p[j]
    auto suffix_chain = [&](float (&ac)[PER]) {
      for (int p = 0; p < a.window; ++p) {
        float sh[PER];
        shift_up<PER, KT>(ac, sh, 1 << p, 0.0f, xbuf(par), t, bar);
        par ^= 1;
        if (p < a.n_chain) {
          const float* c = chain_s + p * ROW;
#pragma unroll
          for (int k = 0; k < PER; ++k) ac[k] = ac[k] + sh[k] * c[k];
        } else {
          const float* c = a.schain + static_cast<size_t>(p) * m_pad;
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int j = t * PER + k;
            ac[k] = ac[k] + sh[k] * (j < m_pad ? __ldg(c + j) : 0.0f);
          }
        }
      }
    };

    // the L boundary
    float bm[PER], bi[PER];
    float bc = p_move, bj = 0.0f, bn = 0.0f, lsb = 0.0f, comp = 0.0f;
    {
      const float be = p_e_c * bc;
      float bd[PER], up[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) bd[k] = t * PER + k < m_pad ? be : 0.0f;
      suffix_chain(bd);
      shift_up<PER, KT>(bd, up, 1, 0.0f, xbuf(par), t, bar);
      par ^= 1;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        bm[k] = t * PER + k < m_pad ? tr(2, k) * up[k] + be : 0.0f;
        bi[k] = 0.0f;
      }
    }

    int steps = 0;
    for (int hi = n; hi > 0; hi -= kChunk) {
      const int lo = max(hi - kChunk, 0);
      const int count = hi - lo;
      // the last chunk's readers of toks, ls_c and cov_c passed its end barrier
      if (t < count) {
        toks[t] = tok_row[lo + t];
        ls_c[t] = ls_row[lo + t];
      }
      group_sync<KT>(bar);
      prefetch_emissions<PER, KT>(em((hi - 1) & 1), ei((hi - 1) & 1), a.modds, a.iodds,
                                  token(toks, count - 1), m_pad, t);
      prefetch_row_bf16<PER, KT>(frow((hi - 1) & 1), fm_seq + static_cast<size_t>(hi - 1) * m_pad,
                                 m_pad, t);
      cp_async_commit();
      cp_async_wait_all();
      group_sync<KT>(bar);  // publishes the rows of the chunk's first step

      for (int pos = hi - 1; pos >= lo; --pos) {
        const int q = pos & 1;
        if (pos > lo) {  // the next step's rows, while this one runs
          prefetch_emissions<PER, KT>(em(q ^ 1), ei(q ^ 1), a.modds, a.iodds,
                                      token(toks, pos - 1 - lo), m_pad, t);
          prefetch_row_bf16<PER, KT>(frow(q ^ 1), fm_seq + static_cast<size_t>(pos - 1) * m_pad,
                                     m_pad, t);
        }
        cp_async_commit();

        // coverage of position pos and the B sum, one two-value reduction
        float f[PER];
        load_bf16<PER>(frow(q), f, t);
        const float* mo = em(q) + off;
        const float* io = ei(q) + off;
        float cv = 0.0f, bs = 0.0f, memit[PER], iemit[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          cv += f[k] * bm[k];
          memit[k] = mo[k] * bm[k];
          iemit[k] = io[k] * bi[k];
          bs += memit[k];
        }
        group_sum2<KT>(cv, bs, red, t, bar);
        if (t == 0) cov_c[pos - lo] = cv * expf(ls_c[pos - lo] + lsb - total);
        if (pos == 0) break;  // the betas before the first residue are not needed

        float m_next[PER];
        shift_up<PER, KT>(memit, m_next, 1, 0.0f, xbuf(par), t, bar);
        par ^= 1;
        const float bspec = p_b_mk * bs;
        bj = p_loop * bj + p_move * bspec;
        bn = p_loop * bn + p_move * bspec;
        bc = p_loop * bc;
        const float e = p_e_c * bc + p_e_j * bj;
        float ac[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          bi[k] = tr(3, k) * m_next[k] + tr(4, k) * iemit[k];
          ac[k] = t * PER + k < m_pad ? tr(5, k) * m_next[k] + e : 0.0f;
        }
        suffix_chain(ac);
        cp_async_wait_all();  // the next step's rows: the shift's barrier publishes them
        float up[PER];
        shift_up<PER, KT>(ac, up, 1, 0.0f, xbuf(par), t, bar);
        par ^= 1;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          bm[k] = t * PER + k < m_pad
                      ? tr(0, k) * m_next[k] + tr(1, k) * iemit[k] + tr(2, k) * up[k] + e
                      : 0.0f;
        }

        if (++steps % a.group == 0) {
          float mx = 0.0f;
#pragma unroll
          for (int k = 0; k < PER; ++k) mx = fmaxf(mx, bm[k]);
          mx = group_reduce<false, KT>(mx, red + 2 * W, t, bar);
          const float s = fmaxf(fmaxf(mx, bc), fmaxf(bn, 1e-30f));
          const float inv = 1.0f / s;
          const float y = logf(s) - comp;
          const float t_sum = lsb + y;
          comp = (t_sum - lsb) - y;
          lsb = t_sum;
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            bm[k] *= inv;
            bi[k] *= inv;
          }
          bj *= inv;
          bc *= inv;
          bn *= inv;
        }
      }
      group_sync<KT>(bar);  // the chunk's coverage is complete
      if (t < count) cov_row[lo + t] = cov_c[t];
    }
  }
}

template <int PER, int KT>
__global__ void backward_kernel(const BackwardArgs a) {
  backward_body<PER, KT>(a);
}

// At 9 to 12 slots and 128 threads the case is held to 128 registers, so
// that four groups of 128 threads fit an SM's registers.
template <int PER, int KT>
__global__ void __launch_bounds__(512) backward_bounded_kernel(const BackwardArgs a) {
  backward_body<PER, KT>(a);
}

// The case's kernel; only that one is instantiated.
template <int PER, int KT>
constexpr auto backward_case() {
  if constexpr (KT == 128 && PER >= 9 && PER <= 12) {
    return backward_bounded_kernel<PER, KT>;
  } else {
    return backward_kernel<PER, KT>;
  }
}

// The rows-in-memory case (p7_blocked.cuh, past 4864 states): one block of
// kMemThreads threads a sequence, backward_kernel's step over the block's
// scratch rows with the same float32 operations on the same operands. Rows
// by parity p: bm at 0 + p, bi at 2 + p, the suffix chain's two rows at 6
// and 7. m_next_j = memit_{j+1} is formed from the last step's bm at j + 1,
// so it needs no barrier; the sums are block reductions in another fixed
// order than the register cases'.
__global__ void __launch_bounds__(kMemThreads) backward_mem_kernel(const BackwardArgs a) {
  __shared__ float red_buf[2 * kMemWarps];
  BlockReduce red{red_buf, 0};
  const int m_pad = a.m_pad;
  const int t = threadIdx.x;
  const int b_pad = a.b_pad;
  const float p_b_mk = a.consts[0];
  const float p_e_c = a.consts[1];
  const float p_e_j = a.consts[2];
  const float* tmm = a.trans;
  const float* tmi = a.trans + m_pad;
  const float* tmd = a.trans + 2 * m_pad;
  const float* tim = a.trans + 3 * m_pad;
  const float* tii = a.trans + 4 * m_pad;
  const float* tdm = a.trans + 5 * m_pad;
  auto row = [&](int r) { return mem_row(a.scratch, r, m_pad); };

  // the suffix chain of row 6 (a_j += a_{j+2^p} * c_p[j]); returns the row
  // holding the result
  auto suffix_chain = [&]() {
    const float* src = row(6);
    float* dst = row(7);
    for (int p = 0; p < a.window; ++p) {
      const int s = 1 << p;
      const float* c = a.schain + static_cast<size_t>(p) * m_pad;
      for (int j = t; j < m_pad; j += kMemThreads) {
        dst[j] = src[j] + (j + s < m_pad ? src[j + s] : 0.0f) * c[j];
      }
      __syncthreads();
      const float* done = dst;
      dst = const_cast<float*>(src);
      src = done;
    }
    return src;
  };

  for (int seq = blockIdx.x; seq < b_pad; seq += gridDim.x) {
    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    float* cov_row = a.cov + static_cast<size_t>(seq) * a.l_pad;
    for (int pos = n + t; pos < a.l_pad; pos += kMemThreads) cov_row[pos] = 0.0f;
    if (n == 0) continue;  // the whole block

    const float p_loop = a.tr_probs[seq];
    const float p_move = a.tr_probs[b_pad + seq];
    const float total = a.total[seq];
    const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
    const uint16_t* fm_seq = a.fm + static_cast<size_t>(seq) * a.l_pad * m_pad;
    const float* ls_row = a.ls + static_cast<size_t>(seq) * a.l_pad;
    int par = 0;

    // the L boundary
    float bc = p_move, bj = 0.0f, bn = 0.0f, lsb = 0.0f, comp = 0.0f;
    {
      const float be = p_e_c * bc;
      for (int j = t; j < m_pad; j += kMemThreads) row(6)[j] = be;
      __syncthreads();
      const float* bd = suffix_chain();
      for (int j = t; j < m_pad; j += kMemThreads) {
        row(0)[j] = tmd[j] * (j + 1 < m_pad ? bd[j + 1] : 0.0f) + be;
        row(2)[j] = 0.0f;
      }
      __syncthreads();
    }

    int steps = 0;
    for (int pos = n - 1; pos >= 0; --pos) {
      const int aa = min(max(static_cast<int>(tok_row[pos]), 0), 19);
      const float* mo = a.modds + static_cast<size_t>(aa) * m_pad;
      const float* io = a.iodds + static_cast<size_t>(aa) * m_pad;
      const uint16_t* fr = fm_seq + static_cast<size_t>(pos) * m_pad;
      const float* bmo = row(par);
      const float* bio = row(2 + par);
      float* bmn = row(par ^ 1);
      float* bin = row(2 + (par ^ 1));

      float cv = 0.0f, bs = 0.0f;
      for (int j = t; j < m_pad; j += kMemThreads) {
        cv += __uint_as_float(static_cast<uint32_t>(fr[j]) << 16) * bmo[j];
        bs += mo[j] * bmo[j];
      }
      cv = red.run<true>(cv);
      bs = red.run<true>(bs);
      if (t == 0) cov_row[pos] = cv * expf(ls_row[pos] + lsb - total);
      if (pos == 0) break;

      const float bspec = p_b_mk * bs;
      bj = p_loop * bj + p_move * bspec;
      bn = p_loop * bn + p_move * bspec;
      bc = p_loop * bc;
      const float e = p_e_c * bc + p_e_j * bj;
      for (int j = t; j < m_pad; j += kMemThreads) {
        const float m_next = j + 1 < m_pad ? mo[j + 1] * bmo[j + 1] : 0.0f;
        bin[j] = tim[j] * m_next + tii[j] * (io[j] * bio[j]);
        row(6)[j] = tdm[j] * m_next + e;
      }
      __syncthreads();
      const float* d = suffix_chain();
      float mx = 0.0f;
      for (int j = t; j < m_pad; j += kMemThreads) {
        const float m_next = j + 1 < m_pad ? mo[j + 1] * bmo[j + 1] : 0.0f;
        const float up = j + 1 < m_pad ? d[j + 1] : 0.0f;
        const float nm = tmm[j] * m_next + tmi[j] * (io[j] * bio[j]) + tmd[j] * up + e;
        bmn[j] = nm;
        mx = fmaxf(mx, nm);
      }
      if (++steps % a.group == 0) {
        mx = red.run<false>(mx);
        const float s = fmaxf(fmaxf(mx, bc), fmaxf(bn, 1e-30f));
        const float inv = 1.0f / s;
        const float y = logf(s) - comp;
        const float t_sum = lsb + y;
        comp = (t_sum - lsb) - y;
        lsb = t_sum;
        for (int j = t; j < m_pad; j += kMemThreads) {
          bmn[j] *= inv;
          bin[j] *= inv;
        }
        bj *= inv;
        bc *= inv;
        bn *= inv;
      }
      __syncthreads();  // the new rows, before the next step reads j + 1
      par ^= 1;
    }
    __syncthreads();  // the next sequence's rows go into these
  }
}

unsigned smem_set[kCaseSlots];  // devices whose kernel case allows kMaxSmem

template <int PER, int KT>
struct Case {
  static cudaError_t launch(const BackwardArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    const bool ok = a.m_pad <= KT * PER && groups >= 1 && groups * KT <= kMaxThreads &&
                    grid >= 1 && a.n_trans >= 0 && a.n_trans <= kTransRows &&
                    (KT != 128 || a.n_trans == kTransRows) &&
                    static_cast<size_t>(smem) ==
                        4 * (static_cast<size_t>(a.n_trans + a.n_chain) * row_floats<PER, KT>() +
                             static_cast<size_t>(groups) * backward_group_floats<PER, KT>()) &&
                    smem <= kMaxSmem;
    if (!ok) return cudaErrorInvalidValue;
    const auto kernel = backward_case<PER, KT>();
    const cudaError_t err = allow_smem(kernel, device, smem_set[case_slot(KT, PER)]);
    if (err != cudaSuccess) return err;
    kernel<<<grid, groups * KT, smem, stream>>>(a);
    return cudaGetLastError();
  }

  static cudaError_t regs(int* out) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, backward_case<PER, KT>());
    *out = attr.numRegs;
    return err;
  }
};

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128 or 256, or
// kMemThreads for the rows-in-memory case) and `per` name the kernel case,
// with threads * per >= m_pad (a multiple of 8); `window` is the suffix
// chain's row count, the first `n_chain` staged in shared memory with the
// first `n_trans` transition rows; the pass rescales after every `group`
// steps of a sequence. `groups`, `grid` and `smem` are the launch plan of
// ops/p7_cuda.py::plan_launch (checked); `scratch` the rows-in-memory
// case's rows (null otherwise). Returns a cudaError_t.
extern "C" int p7_backward_launch(int device, int threads, int per, const void* modds,
                                  const void* iodds, const void* trans, const void* schain,
                                  int m_pad, int window, int n_chain, int n_trans, int group,
                                  const void* tokens, int l_pad, const void* lengths,
                                  const void* tr_probs, const void* consts, const void* total,
                                  const void* fm, const void* ls, void* cov, void* scratch,
                                  int b_pad, int groups, int grid, int smem, void* stream) {
  if (m_pad < 1 || m_pad % 8 != 0 || window < 1 || window > 16 || n_chain < 0 ||
      n_chain > window || group < 1 || b_pad < 1 || l_pad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  BackwardArgs a;
  a.modds = static_cast<const float*>(modds);
  a.iodds = static_cast<const float*>(iodds);
  a.trans = static_cast<const float*>(trans);
  a.schain = static_cast<const float*>(schain);
  a.m_pad = m_pad;
  a.window = window;
  a.n_chain = n_chain;
  a.n_trans = n_trans;
  a.group = group;
  a.tokens = static_cast<const int8_t*>(tokens);
  a.l_pad = l_pad;
  a.lengths = static_cast<const int*>(lengths);
  a.tr_probs = static_cast<const float*>(tr_probs);
  a.consts = static_cast<const float*>(consts);
  a.total = static_cast<const float*>(total);
  a.fm = static_cast<const uint16_t*>(fm);
  a.ls = static_cast<const float*>(ls);
  a.cov = static_cast<float*>(cov);
  a.scratch = static_cast<float*>(scratch);
  a.b_pad = b_pad;
  auto* st = static_cast<cudaStream_t>(stream);
  if (threads == kMemThreads) {
    if (!mem_plan_ok(m_pad, per, groups, grid, smem, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    backward_mem_kernel<<<grid, kMemThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(with_case<Case>(threads, per, [&](auto c) {
    return decltype(c)::launch(a, device, groups, grid, smem, st);
  }));
}

// Registers a thread of the case uses, for the launch plan. Returns a
// cudaError_t.
extern "C" int p7_backward_regs(int threads, int per, int* regs) {
  if (threads == kMemThreads) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, backward_mem_kernel);
    *regs = attr.numRegs;
    return static_cast<int>(err);
  }
  return static_cast<int>(
      with_case<Case>(threads, per, [&](auto c) { return decltype(c)::regs(regs); }));
}
