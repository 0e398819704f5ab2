// Forward scan in scaled probability space, written by hand for Hopper
// (sm_90a), with or without saving its rows for the posterior decode.
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_p7.py::_fwd_prob_kernel, as
// launched by fwd_prob_pallas_call (the SAVE = false cases), and
// hmm_fasta_viterbi_tpu/ops/pallas_posterior.py::_fwd_save_kernel, as
// launched by _posterior_padded (the SAVE = true cases: the same math, and
// each step's scaled M row stored as bf16, round to nearest, into
// fm [b_pad, l_pad, m_pad] with the log scale in effect for that row in
// ls [b_pad, l_pad]; rows at and past the length are stored as 0). Both
// cases are one template, so the saved pass scores each sequence bit for bit
// as the plain Forward kernel does. For every residue t < length of a
// sequence, over odds ratios and transition probabilities:
//     M_j = modds[tok][j] * (diag_{j-1} + B * p_B_Mk)
//           diag = M * tmm + I * tim + D * tdm            (old rows)
//     I_j = iodds[tok][j] * (M_j * tmi + I_j * tii)       (old rows)
//     D   = the delete chain: a = shift1(M * tmd), then W window passes
//           a <- a + a[j - 2^k] * chain[k][j] (the host's tdd products)
//     E   = sum_j (M_j + D_j)
//     J = J p_loop + E p_E_J,  C = C p_loop + E p_E_C,  N = N p_loop,
//     B = N p_move + J p_move
// with the host-exact p_loop/p_move of length_transition_probs (no exp in
// the kernel: its bias would compound once per residue). After every
// `group` residues of the call, all rows and specials are divided by
// s = max(max_j M_j, C, max(N, 1e-30)) and log s is added to the log scale
// with Kahan compensation; the score is log C + log_scale + tr_move. The
// only transcendental is logf of the rescale factor, as in the JAX kernel.
// E sums each thread's contiguous states in order, then a warp butterfly,
// then the four warps: a fixed order (a run is deterministic, and a carry
// chain split at a multiple of `group` equals one call bit for bit), but
// another one than the plain version's.
//
// What bounds it on the H100: as the Viterbi kernel (p7_viterbi.cuh), the
// serial chain of one step (the j-1 diagonal, the W-pass prefix scan along
// the states, the E sum: 2 + W + 1 barriers, one more a rescale group)
// and the step-invariant constants each cell reads: 6 transitions and W
// chain rows, plus 2 emissions. Read from L1/L2 (a 128-thread block a
// sequence), their traffic held the kernel near 17,900 cycles a residue step
// per wave. From shared memory they are bounded by its 128 bytes a cycle
// per SM, and the step's latency by the sequences sharing an SM (4096 x
// 3500 x 1400: 116, 120, 95 and 77 ms with 1 to 4 groups a block). The
// SAVE cases add one 2-byte store a cell: at 1024 x 1024 x 1408 that is
// 2.95 GB, under 1 ms of the card's 3.35 TB/s.
//
// What the design does about it (p7_blocked.cuh has the layout; the same
// as the Viterbi template's):
//  * the block stages the 6 transition rows and the first n_chain of the W
//    chain rows in shared memory once (all W unless that would not fit: the
//    launcher's plan says), fill 0 past M_pad; G groups of 128 threads share
//    them, one sequence each, on their own named barriers, in a persistent
//    grid that walks the batch with a stride; each group's residue loop
//    stops at its sequence's length, so finished sequences neither step nor
//    rescale (a pad token never reaches the tables, and a frozen C cannot be
//    rescaled against a growing neighbour until it underflows);
//  * thread t owns the contiguous states t * PER + k in registers; a shift
//    by s < PER moves registers and passes s slots through shared memory, a
//    larger one reads the row at j - s; one barrier a shift;
//  * the next step's emission rows arrive by cp.async while a step runs;
//  * E and the rescale max are warp butterflies plus a 4-entry shared
//    reduction summed in a fixed order;
//  * SAVE: each thread writes its PER bf16 values into a shared row (two
//    alternate), and after the E barrier the group stores the row with
//    16-byte stores: one coalesced store of the row a step;
//  * the carries cross global memory as [B, M_pad] rows, coalesced through
//    a shift buffer, at the start and end of a sequence;
//  * no --use_fast_math: 1 / s is a correctly rounded division and logf is
//    the accurate one. Products and sums may contract to FMA, so the kernel
//    differs from the plain PyTorch version by rounding only.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise. The C entry point returns cudaGetLastError().
//  * Past 256 * 19 = 4864 states the rows-in-memory case
//    (forward_mem_kernel, p7_blocked.cuh) runs the same step with every row
//    in global memory, one 1024-thread block a sequence.

#include <cuda_bf16.h>

#include "p7_blocked.cuh"

namespace {

struct ForwardArgs {
  const float* modds;  // [20, m_pad]
  const float* iodds;  // [20, m_pad]
  const float* trans;  // [8, m_pad]: tmm tmi tmd tim tii tdm (probabilities)
  const float* chain;  // [window, m_pad]: tdd window products
  int m_pad;
  int window;
  int n_chain;  // chain rows staged in shared memory
  int n_trans;  // transition rows staged in shared memory (6 at 128 threads)
  int group;
  const int8_t* tokens;  // [b_pad, l_pad]
  int l_pad;
  const int* lengths;     // [b_pad]
  const float* tr_rows;   // [2, b_pad]: log tr_loop, log tr_move
  const float* tr_probs;  // [2, b_pad]: p_loop, p_move
  const float* consts;    // [3]: p_B_Mk, p_E_C, p_E_J
  const float* m_in;      // [b_pad, m_pad]
  const float* i_in;
  const float* d_in;
  const float* s_in;      // [8, b_pad]: J C N B log_scale comp 0 0
  float* scores;
  float* m_out;
  float* i_out;
  float* d_out;
  float* s_out;
  __nv_bfloat16* fm;  // [b_pad, l_pad, m_pad] (SAVE)
  float* ls;          // [b_pad, l_pad] (SAVE)
  int b_pad;
};

template <int PER, int KT, bool SAVE>
__global__ void forward_kernel(const ForwardArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ROW = row_floats<PER, KT>();
  constexpr int SP = stride<PER>();
  constexpr int W = warps<KT>();
  const int m_pad = a.m_pad;
  const int n_trans = KT == 128 ? kTransRows : a.n_trans;
  const int n_rows = n_trans + a.n_chain;

  for (int q = 0; q < n_trans; ++q) {
    stage_row<PER, KT>(smem + q * ROW, a.trans + q * m_pad, m_pad, 0.0f);
  }
  for (int p = 0; p < a.n_chain; ++p) {
    stage_row<PER, KT>(smem + (n_trans + p) * ROW, a.chain + p * m_pad, m_pad, 0.0f);
  }

  const int groups = blockDim.x / KT;
  const int g = threadIdx.x / KT;
  const int t = threadIdx.x % KT;
  const int bar = 1 + g;
  float* base = smem + n_rows * ROW + g * group_floats<PER, KT, false>(SAVE);
  // buffers by parity (no array indexed at run time: it would live in local memory)
  auto xbuf = [=](int par) { return base + par * ROW; };
  auto em = [=](int q) { return base + (2 + 2 * q) * ROW; };
  auto ei = [=](int q) { return base + (3 + 2 * q) * ROW; };
  float* red_e = base + 6 * ROW;
  float* red_s = red_e + W;
  int8_t* toks = reinterpret_cast<int8_t*>(base + 6 * ROW + red_floats<KT>());
  // two bf16 rows of KT * SP values (SAVE)
  __nv_bfloat16* srow =
      reinterpret_cast<__nv_bfloat16*>(base + 6 * ROW + red_floats<KT>() + kChunk / 4);
  for (int q = 0; q < 2; ++q) {
    fill_tail<PER, KT>(em(q), m_pad, 0.0f, t);
    fill_tail<PER, KT>(ei(q), m_pad, 0.0f, t);
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
    const size_t row = static_cast<size_t>(seq) * m_pad;
    float m[PER], iv[PER], d[PER];
    load_row<PER, KT>(m, a.m_in + row, m_pad, 0.0f, xbuf(0), t, bar);
    load_row<PER, KT>(iv, a.i_in + row, m_pad, 0.0f, xbuf(0), t, bar);
    load_row<PER, KT>(d, a.d_in + row, m_pad, 0.0f, xbuf(0), t, bar);
    float sj = a.s_in[seq];
    float sc = a.s_in[b_pad + seq];
    float sn = a.s_in[2 * b_pad + seq];
    float sb = a.s_in[3 * b_pad + seq];
    float log_scale = a.s_in[4 * b_pad + seq];
    float comp = a.s_in[5 * b_pad + seq];
    const float p_loop = a.tr_probs[seq];
    const float p_move = a.tr_probs[b_pad + seq];
    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
    int par = 0;

    for (int c0 = 0; c0 < n; c0 += kChunk) {
      const int count = min(kChunk, n - c0);
      if (t < count) toks[t] = tok_row[c0 + t];
      group_sync<KT>(bar);
      prefetch_emissions<PER, KT>(em(0), ei(0), a.modds, a.iodds, token(toks, 0), m_pad, t);
      cp_async_commit();
      for (int step = 0; step < count; ++step) {
        const int q = step & 1;
        if (step + 1 < count) {
          prefetch_emissions<PER, KT>(em(q ^ 1), ei(q ^ 1), a.modds, a.iodds,
                                      token(toks, step + 1), m_pad, t);
        }
        cp_async_commit();

        float x[PER], diag[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) x[k] = m[k] * tr(0, k) + iv[k] * tr(3, k) + d[k] * tr(5, k);
        cp_async_wait_prev();  // this step's emission rows (the barrier publishes them)
        shift<PER, KT>(x, diag, 1, 0.0f, xbuf(par), t, bar);
        par ^= 1;

        const float* mo = em(q) + off;
        const float* io = ei(q) + off;
        const float bp = sb * p_b_mk;
        float nm[PER], ac[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          nm[k] = mo[k] * (diag[k] + bp);
          iv[k] = io[k] * (m[k] * tr(1, k) + iv[k] * tr(4, k));
          x[k] = nm[k] * tr(2, k);
        }
        shift<PER, KT>(x, ac, 1, 0.0f, xbuf(par), t, bar);
        par ^= 1;
        for (int p = 0; p < a.window; ++p) {
          float sh[PER];
          shift<PER, KT>(ac, sh, 1 << p, 0.0f, xbuf(par), t, bar);
          par ^= 1;
          if (p < a.n_chain) {
            const float* c = chain_s + p * ROW;
#pragma unroll
            for (int k = 0; k < PER; ++k) ac[k] = ac[k] + sh[k] * c[k];
          } else {
            const float* c = a.chain + static_cast<size_t>(p) * m_pad;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
              const int j = t * PER + k;
              ac[k] = ac[k] + sh[k] * (j < m_pad ? __ldg(c + j) : 0.0f);
            }
          }
        }

        const int pos = c0 + step;
        __nv_bfloat16* sr = srow + q * (KT * SP);
        if (SAVE) {
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            if (t * PER + k < m_pad) sr[t * PER + k] = __float2bfloat16_rn(nm[k]);
          }
        }
        float e = 0.0f;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          e += nm[k] + ac[k];
          m[k] = nm[k];
          d[k] = ac[k];
        }
        e = group_reduce<true, KT>(e, red_e, t, bar);
        if (SAVE) {
          // the row is complete after the reduction's barrier; it is
          // rewritten two steps on, after this step's and the next's barriers
          const size_t frow = (static_cast<size_t>(seq) * a.l_pad + pos) * m_pad;
          uint4* dst = reinterpret_cast<uint4*>(a.fm + frow);
          const uint4* src = reinterpret_cast<const uint4*>(sr);
          for (int c = t; c < m_pad / 8; c += KT) dst[c] = src[c];
          if (t == 0) a.ls[static_cast<size_t>(seq) * a.l_pad + pos] = log_scale;
        }
        sj = sj * p_loop + e * p_e_j;
        sc = sc * p_loop + e * p_e_c;
        sn = sn * p_loop;
        sb = sn * p_move + sj * p_move;

        if ((pos + 1) % a.group == 0) {
          float mx = 0.0f;
#pragma unroll
          for (int k = 0; k < PER; ++k) mx = fmaxf(mx, m[k]);
          mx = group_reduce<false, KT>(mx, red_s, t, bar);
          const float s = fmaxf(fmaxf(mx, sc), fmaxf(sn, 1e-30f));
          const float inv = 1.0f / s;
          const float y = logf(s) - comp;
          const float t_sum = log_scale + y;
          comp = (t_sum - log_scale) - y;
          log_scale = t_sum;
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            m[k] *= inv;
            iv[k] *= inv;
            d[k] *= inv;
          }
          sj *= inv;
          sc *= inv;
          sn *= inv;
          sb *= inv;
        }
      }
      group_sync<KT>(bar);  // every step's reads of the shift buffers and toks are done
    }

    if (SAVE) {
      // rows n .. l_pad - 1 are 0: one contiguous run of 16-byte stores
      const size_t first = (static_cast<size_t>(seq) * a.l_pad + n) * m_pad / 8;
      const size_t last = static_cast<size_t>(seq + 1) * a.l_pad * m_pad / 8;
      uint4* fm16 = reinterpret_cast<uint4*>(a.fm);
      for (size_t c = first + t; c < last; c += KT) fm16[c] = make_uint4(0, 0, 0, 0);
      for (int pos = n + t; pos < a.l_pad; pos += KT) {
        a.ls[static_cast<size_t>(seq) * a.l_pad + pos] = 0.0f;
      }
    }
    store_row<PER, KT>(m, a.m_out + row, m_pad, xbuf(0), t, bar);
    store_row<PER, KT>(iv, a.i_out + row, m_pad, xbuf(0), t, bar);
    store_row<PER, KT>(d, a.d_out + row, m_pad, xbuf(0), t, bar);
    if (t == 0) {
      a.s_out[seq] = sj;
      a.s_out[b_pad + seq] = sc;
      a.s_out[2 * b_pad + seq] = sn;
      a.s_out[3 * b_pad + seq] = sb;
      a.s_out[4 * b_pad + seq] = log_scale;
      a.s_out[5 * b_pad + seq] = comp;
      a.s_out[6 * b_pad + seq] = a.s_in[6 * b_pad + seq];
      a.s_out[7 * b_pad + seq] = a.s_in[7 * b_pad + seq];
      a.scores[seq] = (logf(sc) + log_scale) + a.tr_rows[b_pad + seq];
    }
  }
}

// SAVE: rows n .. l_pad - 1 of sequence `seq` are 0, as forward_kernel
// stores them: one contiguous run of 16-byte stores.
__device__ __forceinline__ void zero_saved_tail(const ForwardArgs& a, int seq, int n, int t,
                                                int threads) {
  const size_t first = (static_cast<size_t>(seq) * a.l_pad + n) * a.m_pad / 8;
  const size_t last = static_cast<size_t>(seq + 1) * a.l_pad * a.m_pad / 8;
  uint4* fm16 = reinterpret_cast<uint4*>(a.fm);
  for (size_t c = first + t; c < last; c += threads) fm16[c] = make_uint4(0, 0, 0, 0);
  for (int pos = n + t; pos < a.l_pad; pos += threads) {
    a.ls[static_cast<size_t>(seq) * a.l_pad + pos] = 0.0f;
  }
}

// The rows-in-memory case (p7_blocked.cuh, past 4864 states): one block of
// kMemThreads threads a sequence, forward_kernel's step over the block's
// scratch rows (`scratch`, [grid, kMemRows, m_pad]) with the same float32
// operations on the same operands. Rows by parity p: M at 0 + p, I at 2 + p,
// D at 4 + p, the chain's two rows at 6 and 7; the chain's first pass takes
// the shift by one (it reads M * tmd at j - 1 and j - 2). E and the rescale
// max are block reductions (the sum in another fixed order than the register
// cases'). SAVE stores each thread's states of the bf16 row (coalesced
// 2-byte stores).
template <bool SAVE>
__global__ void __launch_bounds__(kMemThreads)
    forward_mem_kernel(const ForwardArgs a, float* scratch) {
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
  auto row = [&](int r) { return mem_row(scratch, r, m_pad); };

  for (int seq = blockIdx.x; seq < b_pad; seq += gridDim.x) {
    const size_t base = static_cast<size_t>(seq) * m_pad;
    for (int j = t; j < m_pad; j += kMemThreads) {
      row(0)[j] = a.m_in[base + j];
      row(2)[j] = a.i_in[base + j];
      row(4)[j] = a.d_in[base + j];
    }
    float sj = a.s_in[seq];
    float sc = a.s_in[b_pad + seq];
    float sn = a.s_in[2 * b_pad + seq];
    float sb = a.s_in[3 * b_pad + seq];
    float log_scale = a.s_in[4 * b_pad + seq];
    float comp = a.s_in[5 * b_pad + seq];
    const float p_loop = a.tr_probs[seq];
    const float p_move = a.tr_probs[b_pad + seq];
    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
    int par = 0;
    __syncthreads();

    for (int pos = 0; pos < n; ++pos) {
      const int aa = min(max(static_cast<int>(tok_row[pos]), 0), 19);
      const float* mo = a.modds + static_cast<size_t>(aa) * m_pad;
      const float* io = a.iodds + static_cast<size_t>(aa) * m_pad;
      const float* mp = row(par);
      const float* ip = row(2 + par);
      const float* dp = row(4 + par);
      float* mn = row(par ^ 1);
      float* in = row(2 + (par ^ 1));
      float* dn = row(4 + (par ^ 1));
      const float bp = sb * p_b_mk;
      __nv_bfloat16* frow =
          SAVE ? a.fm + (static_cast<size_t>(seq) * a.l_pad + pos) * m_pad : nullptr;
      for (int j = t; j < m_pad; j += kMemThreads) {
        float diag = 0.0f;  // the j-1 diagonal, shifted in with 0
        if (j > 0) {
          const int i = j - 1;
          diag = mp[i] * tmm[i] + ip[i] * tim[i] + dp[i] * tdm[i];
        }
        const float nm = mo[j] * (diag + bp);
        in[j] = io[j] * (mp[j] * tmi[j] + ip[j] * tii[j]);
        mn[j] = nm;
        row(6)[j] = nm * tmd[j];
        if (SAVE) frow[j] = __float2bfloat16_rn(nm);
      }
      if (SAVE && t == 0) a.ls[static_cast<size_t>(seq) * a.l_pad + pos] = log_scale;
      __syncthreads();

      const float* src = row(6);
      float* dst = row(7);
      for (int p = 0; p < a.window; ++p) {
        const int s = 1 << p;
        const float* c = a.chain + static_cast<size_t>(p) * m_pad;
        for (int j = t; j < m_pad; j += kMemThreads) {
          // pass 0 reads a = the M * tmd row shifted by one
          const float cur = p == 0 ? (j >= 1 ? src[j - 1] : 0.0f) : src[j];
          const int from = p == 0 ? j - 2 : j - s;
          dst[j] = cur + (from >= 0 ? src[from] : 0.0f) * c[j];
        }
        __syncthreads();
        const float* done = dst;
        dst = const_cast<float*>(src);
        src = done;
      }

      float e = 0.0f, mx = 0.0f;
      for (int j = t; j < m_pad; j += kMemThreads) {
        const float ac = src[j];
        const float nm = mn[j];
        dn[j] = ac;
        e += nm + ac;
        mx = fmaxf(mx, nm);
      }
      e = red.run<true>(e);
      sj = sj * p_loop + e * p_e_j;
      sc = sc * p_loop + e * p_e_c;
      sn = sn * p_loop;
      sb = sn * p_move + sj * p_move;
      if ((pos + 1) % a.group == 0) {
        mx = red.run<false>(mx);
        const float s = fmaxf(fmaxf(mx, sc), fmaxf(sn, 1e-30f));
        const float inv = 1.0f / s;
        const float y = logf(s) - comp;
        const float t_sum = log_scale + y;
        comp = (t_sum - log_scale) - y;
        log_scale = t_sum;
        for (int j = t; j < m_pad; j += kMemThreads) {
          mn[j] *= inv;
          in[j] *= inv;
          dn[j] *= inv;
        }
        sj *= inv;
        sc *= inv;
        sn *= inv;
        sb *= inv;
        __syncthreads();
      }
      par ^= 1;
    }

    if (SAVE) zero_saved_tail(a, seq, n, t, kMemThreads);
    for (int j = t; j < m_pad; j += kMemThreads) {
      a.m_out[base + j] = row(par)[j];
      a.i_out[base + j] = row(2 + par)[j];
      a.d_out[base + j] = row(4 + par)[j];
    }
    if (t == 0) {
      a.s_out[seq] = sj;
      a.s_out[b_pad + seq] = sc;
      a.s_out[2 * b_pad + seq] = sn;
      a.s_out[3 * b_pad + seq] = sb;
      a.s_out[4 * b_pad + seq] = log_scale;
      a.s_out[5 * b_pad + seq] = comp;
      a.s_out[6 * b_pad + seq] = a.s_in[6 * b_pad + seq];
      a.s_out[7 * b_pad + seq] = a.s_in[7 * b_pad + seq];
      a.scores[seq] = (logf(sc) + log_scale) + a.tr_rows[b_pad + seq];
    }
    __syncthreads();  // the next sequence's carries go into these rows
  }
}

unsigned smem_set[2][kCaseSlots];  // devices whose kernel case allows kMaxSmem

template <int PER, int KT>
struct Case {
  static cudaError_t launch(const ForwardArgs& a, int device, int groups, int grid, int smem,
                            cudaStream_t stream) {
    const bool save = a.fm != nullptr;
    const int n_trans = a.n_trans;
    if (a.m_pad > KT * PER ||
        !plan_ok<PER, KT, false>(groups, grid, smem, n_trans + a.n_chain, n_trans, save)) {
      return cudaErrorInvalidValue;
    }
    unsigned& done = smem_set[save][case_slot(KT, PER)];
    const cudaError_t err = save ? allow_smem(forward_kernel<PER, KT, true>, device, done)
                                 : allow_smem(forward_kernel<PER, KT, false>, device, done);
    if (err != cudaSuccess) return err;
    if (save) {
      forward_kernel<PER, KT, true><<<grid, groups * KT, smem, stream>>>(a);
    } else {
      forward_kernel<PER, KT, false><<<grid, groups * KT, smem, stream>>>(a);
    }
    return cudaGetLastError();
  }

  static cudaError_t regs(bool save, int* out) {
    cudaFuncAttributes attr;
    const cudaError_t err = save ? cudaFuncGetAttributes(&attr, forward_kernel<PER, KT, true>)
                                 : cudaFuncGetAttributes(&attr, forward_kernel<PER, KT, false>);
    *out = attr.numRegs;
    return err;
  }
};

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128 or 256, or
// kMemThreads for the rows-in-memory case) and `per` name the kernel case,
// with threads * per >= m_pad (a multiple of 8); `window` is the chain's row
// count, the first `n_chain` staged in shared memory with the first
// `n_trans` transition rows; the kernel rescales after every `group`
// residues. `fm` and `ls` null run the plain Forward, both set the saving
// pass. `groups`, `grid` and `smem` are the launch plan of
// ops/p7_cuda.py::plan_launch (checked); `scratch` the rows-in-memory
// case's rows (null otherwise). Returns a cudaError_t.
extern "C" int p7_forward_launch(int device, int threads, int per, const void* modds,
                                 const void* iodds, const void* trans, const void* chain,
                                 int m_pad, int window, int n_chain, int n_trans, int group,
                                 const void* tokens, int l_pad,
                                 const void* lengths, const void* tr_rows,
                                 const void* tr_probs, const void* consts, const void* m_in,
                                 const void* i_in, const void* d_in, const void* s_in,
                                 void* scores, void* m_out, void* i_out, void* d_out,
                                 void* s_out, void* fm, void* ls, void* scratch, int b_pad,
                                 int groups, int grid, int smem, void* stream) {
  if (m_pad < 1 || m_pad % 8 != 0 || window < 1 || window > 16 || n_chain < 0 ||
      n_chain > window || group < 1 || b_pad < 1 || (fm == nullptr) != (ls == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ForwardArgs a;
  a.modds = static_cast<const float*>(modds);
  a.iodds = static_cast<const float*>(iodds);
  a.trans = static_cast<const float*>(trans);
  a.chain = static_cast<const float*>(chain);
  a.m_pad = m_pad;
  a.window = window;
  a.n_chain = n_chain;
  a.n_trans = n_trans;
  a.group = group;
  a.tokens = static_cast<const int8_t*>(tokens);
  a.l_pad = l_pad;
  a.lengths = static_cast<const int*>(lengths);
  a.tr_rows = static_cast<const float*>(tr_rows);
  a.tr_probs = static_cast<const float*>(tr_probs);
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
  a.fm = static_cast<__nv_bfloat16*>(fm);
  a.ls = static_cast<float*>(ls);
  a.b_pad = b_pad;
  auto* st = static_cast<cudaStream_t>(stream);
  if (threads == kMemThreads) {
    if (!mem_plan_ok(m_pad, per, groups, grid, smem, scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* rows = static_cast<float*>(scratch);
    if (fm != nullptr) {
      forward_mem_kernel<true><<<grid, kMemThreads, 0, st>>>(a, rows);
    } else {
      forward_mem_kernel<false><<<grid, kMemThreads, 0, st>>>(a, rows);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(with_case<Case>(threads, per, [&](auto c) {
    return decltype(c)::launch(a, device, groups, grid, smem, st);
  }));
}

// Registers a thread of the case uses (`save`: the row-saving case), for
// the launch plan. Returns a cudaError_t.
extern "C" int p7_forward_regs(int threads, int per, int save, int* regs) {
  if (threads == kMemThreads) {
    cudaFuncAttributes attr;
    const cudaError_t err = save ? cudaFuncGetAttributes(&attr, forward_mem_kernel<true>)
                                 : cudaFuncGetAttributes(&attr, forward_mem_kernel<false>);
    *regs = attr.numRegs;
    return static_cast<int>(err);
  }
  return static_cast<int>(with_case<Case>(
      threads, per, [&](auto c) { return decltype(c)::regs(save != 0, regs); }));
}
