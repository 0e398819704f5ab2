// Scaled-probability backward pass emitting posterior coverage, written by
// hand for Hopper (sm_90a).
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
// dependent phases of one step, each ended by a block barrier (the shift of
// memit, W suffix-chain passes, the shift of D, the two-value block sum),
// not memory: the pass reads each fm row once (2 bytes a cell, 2.95 GB at
// 1024 x 1024 x 1408, under 1 ms at 3.35 TB/s).
//
// What the design does about it: the p7 kernels' layout. One block of KT
// threads (128, or 256 past M_pad 128 * 19 = 2432, up to 256 * 19 = 4864)
// follows one sequence from its own last residue down to 0 (no masked
// steps, no pad token reaches the tables); state j lives in thread j % KT,
// register slot j / KT, beta rows in registers; each shift toward lower j is
// one store, one barrier and one load at j + s through two alternating
// shared-memory rows; the coverage sum and the B sum are one warp butterfly
// of two values and a KT / 32-entry shared reduction, summed in a fixed
// order. Slots at and past M_pad hold 0 and read 0 constants. The fm
// row's bf16 widens to f32 exactly. Accurate expf and logf only (no
// --use_fast_math). It launches on the caller's stream, allocates nothing
// and does not synchronise; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 128;  // residues per token load

struct BackwardArgs {
  const float* modds;   // [20, m_pad]
  const float* iodds;   // [20, m_pad]
  const float* trans;   // [8, m_pad]: tmm tmi tmd tim tii tdm (probabilities)
  const float* schain;  // [window, m_pad]: suffix tdd window products
  int m_pad;
  int window;
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
  int b_pad;
};

// out[k] = value of state j + s (j = k * KT + t), 0 past the row.
template <int PER, int KT>
__device__ __forceinline__ void shift_up(const float (&v)[PER], float (&out)[PER], int s,
                                         float* buf) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < PER; ++k) buf[k * KT + t] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * KT + t + s;
    out[k] = j < KT * PER ? buf[j] : 0.0f;
  }
}

// The block's sum or max of its warps' values, in a fixed order: pairs of
// neighbours, then pairs of pairs.
template <bool SUM, int KT>
__device__ __forceinline__ float combine_warps(const float* r) {
  if constexpr (KT == 128) {
    return SUM ? (r[0] + r[1]) + (r[2] + r[3]) : fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3]));
  } else {
    return SUM ? ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
               : fmaxf(fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3])),
                       fmaxf(fmaxf(r[4], r[5]), fmaxf(r[6], r[7])));
  }
}

__device__ __forceinline__ float ld(const float* p, int j, int m_pad) {
  return j < m_pad ? __ldg(p + j) : 0.0f;
}

// The suffix delete chain in place: `window` passes a_j += a_{j+2^k} * c_k[j].
template <int PER, int KT>
__device__ __forceinline__ void suffix_chain(float (&ac)[PER], const BackwardArgs& a,
                                             float (*xbuf)[KT * PER], int& par) {
  for (int p = 0; p < a.window; ++p) {
    const float* c = a.schain + p * a.m_pad;
    float sh[PER];
    shift_up<PER, KT>(ac, sh, 1 << p, xbuf[par]);
    par ^= 1;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      ac[k] = ac[k] + sh[k] * ld(c, k * KT + threadIdx.x, a.m_pad);
    }
  }
}

template <int PER, int KT>
__global__ void __launch_bounds__(KT) backward_kernel(const BackwardArgs a) {
  constexpr int kThreads = KT;
  constexpr int kWarps = KT / 32;
  __shared__ float xbuf[2][kThreads * PER];
  __shared__ float red2[2][kWarps];
  __shared__ float red_s[kWarps];
  __shared__ int toks[kChunk];

  const int seq = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int m_pad = a.m_pad;
  const int b_pad = a.b_pad;
  const int n = min(max(a.lengths[seq], 0), a.l_pad);
  float* cov_row = a.cov + static_cast<size_t>(seq) * a.l_pad;
  for (int pos = n + t; pos < a.l_pad; pos += kThreads) cov_row[pos] = 0.0f;
  if (n == 0) return;  // the whole block: n is the block's

  const float p_loop = a.tr_probs[seq];
  const float p_move = a.tr_probs[b_pad + seq];
  const float p_b_mk = a.consts[0];
  const float p_e_c = a.consts[1];
  const float p_e_j = a.consts[2];
  const float total = a.total[seq];
  const float* tmm = a.trans;
  const float* tmi = a.trans + m_pad;
  const float* tmd = a.trans + 2 * m_pad;
  const float* tim = a.trans + 3 * m_pad;
  const float* tii = a.trans + 4 * m_pad;
  const float* tdm = a.trans + 5 * m_pad;
  const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
  const uint16_t* fm_seq = a.fm + static_cast<size_t>(seq) * a.l_pad * m_pad;
  const float* ls_row = a.ls + static_cast<size_t>(seq) * a.l_pad;
  int par = 0;

  // the L boundary
  float bm[PER], bi[PER];
  float bc = p_move, bj = 0.0f, bn = 0.0f, lsb = 0.0f, comp = 0.0f;
  {
    const float be = p_e_c * bc;
    float bd[PER], up[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) bd[k] = k * kThreads + t < m_pad ? be : 0.0f;
    suffix_chain<PER, KT>(bd, a, xbuf, par);
    shift_up<PER, KT>(bd, up, 1, xbuf[par]);
    par ^= 1;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = k * kThreads + t;
      bm[k] = j < m_pad ? ld(tmd, j, m_pad) * up[k] + be : 0.0f;
      bi[k] = 0.0f;
    }
  }

  int steps = 0;
  for (int hi = n; hi > 0; hi -= kChunk) {
    const int lo = max(hi - kChunk, 0);
    __syncthreads();  // the previous chunk's readers of toks are done
    if (t < hi - lo) toks[t] = tok_row[lo + t];
    __syncthreads();
    for (int pos = hi - 1; pos >= lo; --pos) {
      const int aa = min(max(toks[pos - lo], 0), 19);
      const float* mo = a.modds + aa * m_pad;
      const float* io = a.iodds + aa * m_pad;
      const uint16_t* frow = fm_seq + static_cast<size_t>(pos) * m_pad;

      // coverage of position pos and the B sum, one two-value reduction
      float cv = 0.0f, bs = 0.0f, memit[PER], iemit[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = k * kThreads + t;
        const float f = j < m_pad ? __uint_as_float(static_cast<uint32_t>(frow[j]) << 16) : 0.0f;
        cv += f * bm[k];
        memit[k] = ld(mo, j, m_pad) * bm[k];
        iemit[k] = ld(io, j, m_pad) * bi[k];
        bs += memit[k];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cv += __shfl_xor_sync(kFullMask, cv, off);
        bs += __shfl_xor_sync(kFullMask, bs, off);
      }
      if (lane == 0) {
        red2[0][warp] = cv;
        red2[1][warp] = bs;
      }
      __syncthreads();
      cv = combine_warps<true, KT>(red2[0]);
      bs = combine_warps<true, KT>(red2[1]);
      if (t == 0) cov_row[pos] = cv * expf(ls_row[pos] + lsb - total);
      if (pos == 0) break;  // the betas before the first residue are not needed

      float m_next[PER];
      shift_up<PER, KT>(memit, m_next, 1, xbuf[par]);
      par ^= 1;
      const float bspec = p_b_mk * bs;
      bj = p_loop * bj + p_move * bspec;
      bn = p_loop * bn + p_move * bspec;
      bc = p_loop * bc;
      const float e = p_e_c * bc + p_e_j * bj;
      float ac[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = k * kThreads + t;
        bi[k] = ld(tim, j, m_pad) * m_next[k] + ld(tii, j, m_pad) * iemit[k];
        ac[k] = j < m_pad ? ld(tdm, j, m_pad) * m_next[k] + e : 0.0f;
      }
      suffix_chain<PER, KT>(ac, a, xbuf, par);
      float up[PER];
      shift_up<PER, KT>(ac, up, 1, xbuf[par]);
      par ^= 1;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = k * kThreads + t;
        bm[k] = j < m_pad ? ld(tmm, j, m_pad) * m_next[k] + ld(tmi, j, m_pad) * iemit[k] +
                                ld(tmd, j, m_pad) * up[k] + e
                          : 0.0f;
      }

      if (++steps % a.group == 0) {
        float mx = 0.0f;
#pragma unroll
        for (int k = 0; k < PER; ++k) mx = fmaxf(mx, bm[k]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
        if (lane == 0) red_s[warp] = mx;
        __syncthreads();
        mx = combine_warps<false, KT>(red_s);
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
  }
}

template <int PER, int KT>
cudaError_t launch(const BackwardArgs& a, cudaStream_t stream) {
  backward_kernel<PER, KT><<<a.b_pad, KT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. `threads` (128 or 256) and `per`
// name the kernel case (per 1..19 at 128 threads, 10..19 at 256), with
// threads * per >= m_pad; `window`
// is the suffix chain's row count; the pass rescales after every `group`
// steps of a sequence. Returns a cudaError_t.
extern "C" int posterior_backward_launch(int device, int threads, int per, const void* modds,
                                         const void* iodds, const void* trans,
                                         const void* schain, int m_pad, int window, int group,
                                         const void* tokens, int l_pad, const void* lengths,
                                         const void* tr_probs, const void* consts,
                                         const void* total, const void* fm, const void* ls,
                                         void* cov, int b_pad, void* stream) {
  if (m_pad < 1 || m_pad > threads * per || window < 1 || window > 16 || group < 1 ||
      b_pad < 1 || l_pad < 1) {
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
  a.b_pad = b_pad;
  auto* st = static_cast<cudaStream_t>(stream);
#define POST_CASE(P, T) \
  case P:               \
    return static_cast<int>(launch<P, T>(a, st));
  if (threads == 128) {
    switch (per) {
      POST_CASE(1, 128)
      POST_CASE(2, 128)
      POST_CASE(3, 128)
      POST_CASE(4, 128)
      POST_CASE(5, 128)
      POST_CASE(6, 128)
      POST_CASE(7, 128)
      POST_CASE(8, 128)
      POST_CASE(9, 128)
      POST_CASE(10, 128)
      POST_CASE(11, 128)
      POST_CASE(12, 128)
      POST_CASE(13, 128)
      POST_CASE(14, 128)
      POST_CASE(15, 128)
      POST_CASE(16, 128)
      POST_CASE(17, 128)
      POST_CASE(18, 128)
      POST_CASE(19, 128)
      default:
        break;
    }
  } else if (threads == 256) {
    switch (per) {
      POST_CASE(10, 256)
      POST_CASE(11, 256)
      POST_CASE(12, 256)
      POST_CASE(13, 256)
      POST_CASE(14, 256)
      POST_CASE(15, 256)
      POST_CASE(16, 256)
      POST_CASE(17, 256)
      POST_CASE(18, 256)
      POST_CASE(19, 256)
      default:
        break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
#undef POST_CASE
}
