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
//
// What bounds it on the H100: as the Viterbi kernel, the serial chain of
// one step (the j-1 diagonal, the W-pass prefix scan along the states, the
// E sum) rather than memory; per cell about 2 * W + 12 FP32 instructions
// and W + 2 shared-memory shifts. The SAVE cases add one 2-byte store a
// cell: at 1024 x 1024 x 1408 that is 2.95 GB, under 1 ms of the card's
// 3.35 TB/s, against tens of ms of latency-bound steps; a warp's store of
// one register slot covers 64 contiguous bytes of the row.
//
// What the design does about it (the layout of p7_viterbi_kernel.cu):
//  * one block of 128 threads per sequence, its residue loop stopping at
//    the sequence's length, so finished sequences neither step nor rescale
//    (a pad token never reaches the tables, and a frozen C cannot be
//    rescaled against a growing neighbour until it underflows);
//  * state j in thread j % 128, slot j / 128; M, I, D in registers;
//  * each shift one conflict-free store / barrier / load through two
//    alternating shared-memory rows;
//  * E and the rescale max are warp butterflies plus a 4-entry shared
//    reduction summed in a fixed order, so a run is deterministic and a
//    carry chain split at a multiple of `group` equals one call bit for bit;
//  * pad states past M_pad read 0 constants and stay 0;
//  * no --use_fast_math: 1 / s is a correctly rounded division and logf is
//    the accurate one. Products and sums may contract to FMA, so the kernel
//    differs from the plain PyTorch version by rounding only.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise. The C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // residues per token load

struct ForwardArgs {
  const float* modds;  // [20, m_pad]
  const float* iodds;  // [20, m_pad]
  const float* trans;  // [8, m_pad]: tmm tmi tmd tim tii tdm (probabilities)
  const float* chain;  // [window, m_pad]: tdd window products
  int m_pad;
  int window;
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

template <int PER>
__device__ __forceinline__ void shift_states(const float (&v)[PER], float (&out)[PER], int s,
                                             float* buf) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[k * kThreads + t] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + t;
    out[k] = j >= s ? buf[j - s] : 0.0f;
  }
}

__device__ __forceinline__ float ld(const float* p, int j, int m_pad) {
  return j < m_pad ? __ldg(p + j) : 0.0f;
}

// Block-wide reduction of one value a thread: sum (SUM) or max, the four
// warp results combined in a fixed order.
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

// Store row `pos` of fm (bf16 round to nearest of v, 0 past m_pad) and ls.
template <int PER>
__device__ __forceinline__ void save_row(const ForwardArgs& a, int seq, int pos,
                                         const float (&v)[PER], float log_scale) {
  __nv_bfloat16* row = a.fm + (static_cast<size_t>(seq) * a.l_pad + pos) * a.m_pad;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + threadIdx.x;
    if (j < a.m_pad) row[j] = __float2bfloat16_rn(v[k]);
  }
  if (threadIdx.x == 0) a.ls[static_cast<size_t>(seq) * a.l_pad + pos] = log_scale;
}

template <int PER, bool SAVE>
__global__ void __launch_bounds__(kThreads) forward_kernel(const ForwardArgs a) {
  __shared__ float xbuf[2][kThreads * PER];
  __shared__ float red_e[kWarps];
  __shared__ float red_s[kWarps];
  __shared__ int toks[kChunk];

  const int seq = blockIdx.x;
  const int t = threadIdx.x;
  const int m_pad = a.m_pad;
  const int b_pad = a.b_pad;
  const size_t row = static_cast<size_t>(seq) * m_pad;

  float m[PER], iv[PER], d[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + t;
    const bool in = j < m_pad;
    m[k] = in ? a.m_in[row + j] : 0.0f;
    iv[k] = in ? a.i_in[row + j] : 0.0f;
    d[k] = in ? a.d_in[row + j] : 0.0f;
  }
  float sj = a.s_in[seq];
  float sc = a.s_in[b_pad + seq];
  float sn = a.s_in[2 * b_pad + seq];
  float sb = a.s_in[3 * b_pad + seq];
  float log_scale = a.s_in[4 * b_pad + seq];
  float comp = a.s_in[5 * b_pad + seq];
  const float p_loop = a.tr_probs[seq];
  const float p_move = a.tr_probs[b_pad + seq];
  const float p_b_mk = a.consts[0];
  const float p_e_c = a.consts[1];
  const float p_e_j = a.consts[2];
  const float* tmm = a.trans;
  const float* tmi = a.trans + m_pad;
  const float* tmd = a.trans + 2 * m_pad;
  const float* tim = a.trans + 3 * m_pad;
  const float* tii = a.trans + 4 * m_pad;
  const float* tdm = a.trans + 5 * m_pad;

  const int n = min(max(a.lengths[seq], 0), a.l_pad);
  const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
  int par = 0;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int count = min(kChunk, n - c0);
    __syncthreads();
    if (t < count) toks[t] = tok_row[c0 + t];
    __syncthreads();
    for (int step = 0; step < count; ++step) {
      const int aa = min(max(toks[step], 0), 19);
      const float* mo = a.modds + aa * m_pad;
      const float* io = a.iodds + aa * m_pad;

      float x[PER], diag[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = k * kThreads + t;
        x[k] = m[k] * ld(tmm, j, m_pad) + iv[k] * ld(tim, j, m_pad) + d[k] * ld(tdm, j, m_pad);
      }
      shift_states<PER>(x, diag, 1, xbuf[par]);
      par ^= 1;

      const float bp = sb * p_b_mk;
      float nm[PER], ac[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = k * kThreads + t;
        nm[k] = ld(mo, j, m_pad) * (diag[k] + bp);
        iv[k] = ld(io, j, m_pad) * (m[k] * ld(tmi, j, m_pad) + iv[k] * ld(tii, j, m_pad));
        x[k] = nm[k] * ld(tmd, j, m_pad);
      }
      shift_states<PER>(x, ac, 1, xbuf[par]);
      par ^= 1;
      for (int p = 0; p < a.window; ++p) {
        const float* c = a.chain + p * m_pad;
        float sh[PER];
        shift_states<PER>(ac, sh, 1 << p, xbuf[par]);
        par ^= 1;
#pragma unroll
        for (int k = 0; k < PER; ++k) ac[k] = ac[k] + sh[k] * ld(c, k * kThreads + t, m_pad);
      }

      if (SAVE) save_row<PER>(a, seq, c0 + step, nm, log_scale);
      float e = 0.0f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        e += nm[k] + ac[k];
        m[k] = nm[k];
        d[k] = ac[k];
      }
      e = block_reduce<true>(e, red_e);
      sj = sj * p_loop + e * p_e_j;
      sc = sc * p_loop + e * p_e_c;
      sn = sn * p_loop;
      sb = sn * p_move + sj * p_move;

      if ((c0 + step + 1) % a.group == 0) {
        float mx = 0.0f;
#pragma unroll
        for (int k = 0; k < PER; ++k) mx = fmaxf(mx, m[k]);
        mx = block_reduce<false>(mx, red_s);
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
  }

  if (SAVE) {
    float zero[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) zero[k] = 0.0f;
    for (int pos = n; pos < a.l_pad; ++pos) save_row<PER>(a, seq, pos, zero, 0.0f);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + t;
    if (j < m_pad) {
      a.m_out[row + j] = m[k];
      a.i_out[row + j] = iv[k];
      a.d_out[row + j] = d[k];
    }
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
}

template <int PER>
cudaError_t launch(const ForwardArgs& a, cudaStream_t stream) {
  if (a.fm != nullptr) {
    forward_kernel<PER, true><<<a.b_pad, kThreads, 0, stream>>>(a);
  } else {
    forward_kernel<PER, false><<<a.b_pad, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. `per` is the number of states a
// thread holds, one of the cases below, with 128 * per >= m_pad; `window`
// is the chain's row count; the kernel rescales after every `group`
// residues. `fm` and `ls` null run the plain Forward, both set the saving
// pass. Returns a cudaError_t.
extern "C" int p7_forward_launch(int device, int per, const void* modds, const void* iodds,
                                 const void* trans, const void* chain, int m_pad, int window,
                                 int group, const void* tokens, int l_pad,
                                 const void* lengths, const void* tr_rows,
                                 const void* tr_probs, const void* consts, const void* m_in,
                                 const void* i_in, const void* d_in, const void* s_in,
                                 void* scores, void* m_out, void* i_out, void* d_out,
                                 void* s_out, void* fm, void* ls, int b_pad,
                                 void* stream) {
  if (m_pad < 1 || m_pad > kThreads * per || window < 1 || window > 16 || group < 1 ||
      b_pad < 1 || (fm == nullptr) != (ls == nullptr)) {
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
#define FWD_CASE(P) \
  case P:           \
    return static_cast<int>(launch<P>(a, st));
  switch (per) {
    FWD_CASE(1)
    FWD_CASE(2)
    FWD_CASE(3)
    FWD_CASE(4)
    FWD_CASE(5)
    FWD_CASE(6)
    FWD_CASE(7)
    FWD_CASE(8)
    FWD_CASE(9)
    FWD_CASE(10)
    FWD_CASE(11)
    FWD_CASE(12)
    FWD_CASE(13)
    FWD_CASE(14)
    FWD_CASE(15)
    FWD_CASE(16)
    FWD_CASE(17)
    FWD_CASE(18)
    FWD_CASE(19)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FWD_CASE
}
