// Upper-bound Viterbi filter scan, written by hand for Hopper (sm_90a).
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_p7.py::_p7_filter_kernel, as
// launched by _p7_filter_padded (HMMER ViterbiFilter's role in the --fast
// cascade). It is the eager Viterbi step of p7_viterbi_kernel.cu with three
// changes, each of which keeps every value >= its exact counterpart, so the
// score bounds the exact Viterbi score from above:
//  * msc/isc are the host's bf16 round-up of the emission tables; a bf16
//    entry widens to f32 exactly (the TPU's one-hot select of one bf16 term
//    is exact too);
//  * the delete chain runs `window` Hillis-Steele passes, with the host's
//    rounded-up window sums, instead of ceil(log2 M_pad);
//  * when window < full_passes, D-runs longer than the window are bounded by
//    one tail term on every row j < M_pad:
//        D_j = max(D_j, max_i(a0_i) + aux)      (aux = 2^window * max(tdd))
//    where a0 = shift(M + tmd, 1) is the row entering the chain.
// For every residue t < length of a sequence:
//     pre_diag = max(max(M + tmm, I + tim), D + tdm)      (old rows)
//     M_j = msc[tok][j] + max(pre_diag_{j-1}, B + tr_B_Mk)
//     I_j = isc[tok][j] + max(M_j + tmi, I_j + tii)        (old M, I)
//     D   = chain(a0) [+ tail]
//     E   = max_j M_j (e_skip_d) or max_j max(M_j, D_j); J/C/N/B as in MSV.
// Every float32 operation is a max or one add with the JAX kernel's
// operands, so the scores equal _p7_filter_kernel's and the plain PyTorch
// version's (ops/p7_cuda.py::viterbi_filter_scan_plain) bit for bit.
//
// Rows the way the TPU kernel has them: the tail lands on row 0 too, where
// a0_0 = -inf but the tail is finite, and that D_0 enters M_1 on the next
// step through tdm_0, as on the TPU. It lands on the JAX pack's pad rows
// Mr..M_pad-1 as well (their tdm is -inf, so they reach only E). The
// kernel's own slots j >= M_pad (the last thread's spare registers) are
// left at -inf: every constant there reads -inf, so they feed no state,
// and E without them is JAX's E, since the tail value they would hold is
// already on row 0. max(a0) is taken over M + tmd before the shift: the
// TPU's roll only permutes the rows, and the value the shift drops (row
// M_pad-1) is -inf, as its tmd is (the profile's last tmd is -inf, pad
// rows are -inf).
//
// What bounds it on the H100: as for the eager kernel, the per-step chain of
// dependent phases, each ended by a block barrier: the j-1 shift of
// pre_diag, the shift of M + tmd, `window` chain passes and the E reduction
// (at M = 1400 and the auto window 4: 7 barriers a step against the eager
// kernel's 14). The max of a0 costs no barrier of its own: each warp's
// share goes to shared memory before the a0 shift's barrier.
//
// What the design does about it: one block of 128 threads a sequence,
// state j in thread j % 128, register slot j / 128; shifts through two
// alternating shared buffers; the residue loop stops at the sequence's
// length (no masked steps, no pad token indexes a table). The carries
// M, I, D and J/C/N/B go in and out as the eager kernel's do, so a two-call
// chain equals one call. No --use_fast_math. It launches on the caller's
// stream, allocates nothing and does not synchronise; the C entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // residues per token load

struct FilterArgs {
  const uint16_t* msc;  // [20, m_pad] bf16 bits
  const uint16_t* isc;  // [20, m_pad] bf16 bits
  const float* trans;   // [8, m_pad]: tmm tmi tmd tim tii tdm tdd_s pad
  const float* chain;   // [16, m_pad]: pass constants (rows < window live)
  int m_pad;
  int full_passes;
  int window;  // passes run
  int e_skip_d;
  const int8_t* tokens;  // [b_pad, l_pad]
  int l_pad;
  const int* lengths;    // [b_pad]
  const float* tr_rows;  // [2, b_pad]: tr_loop, tr_move
  const float* consts;   // [4]: tr_B_Mk, tr_E_C, tr_E_J, aux
  const float* m_in;     // [b_pad, m_pad]
  const float* i_in;
  const float* d_in;
  const float* s_in;     // [4, b_pad]: J, C, N, B
  float* scores;         // [b_pad]
  float* m_out;
  float* i_out;
  float* d_out;
  float* s_out;
  int b_pad;
};

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

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

// a bf16 entry widened to f32 (exact); -inf past m_pad
__device__ __forceinline__ float ld_bf16(const uint16_t* p, int j, int m_pad) {
  return j < m_pad ? __uint_as_float(static_cast<unsigned>(__ldg(p + j)) << 16) : neg_inf();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float block_max(const float* red) {
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

template <int PER>
__global__ void __launch_bounds__(kThreads) filter_kernel(const FilterArgs a) {
  __shared__ float xbuf[2][kThreads * PER];
  __shared__ float red_a[kWarps];  // max(a0), per warp
  __shared__ float red_e[kWarps];  // E, per warp
  __shared__ int toks[kChunk];

  const int seq = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int m_pad = a.m_pad;
  const size_t row = static_cast<size_t>(seq) * m_pad;
  const int b_pad = a.b_pad;
  const float ninf = neg_inf();

  float m[PER], ii[PER], d[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + t;
    const bool in = j < m_pad;
    m[k] = in ? a.m_in[row + j] : ninf;
    ii[k] = in ? a.i_in[row + j] : ninf;
    d[k] = in ? a.d_in[row + j] : ninf;
  }
  float sj = a.s_in[seq];
  float sc = a.s_in[b_pad + seq];
  float sn = a.s_in[2 * b_pad + seq];
  float sb = a.s_in[3 * b_pad + seq];
  const float tr_loop = a.tr_rows[seq];
  const float tr_move = a.tr_rows[b_pad + seq];
  const float tr_b_mk = a.consts[0];
  const float tr_e_c = a.consts[1];
  const float tr_e_j = a.consts[2];
  const float aux = a.consts[3];
  const bool truncated = a.window < a.full_passes;
  const bool e_skip_d = a.e_skip_d != 0;
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
    __syncthreads();  // the previous chunk's readers of toks are done
    if (t < count) toks[t] = tok_row[c0 + t];
    __syncthreads();
    for (int step = 0; step < count; ++step) {
      const int aa = min(max(toks[step], 0), 19);
      const uint16_t* ms = a.msc + aa * m_pad;
      const uint16_t* is = a.isc + aa * m_pad;

      float pd[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = k * kThreads + t;
        pd[k] = fmaxf(fmaxf(m[k] + ld(tmm, j, m_pad, ninf), ii[k] + ld(tim, j, m_pad, ninf)),
                      d[k] + ld(tdm, j, m_pad, ninf));
      }
      float diag[PER];
      shift_states<PER>(pd, diag, 1, ninf, xbuf[par]);
      par ^= 1;

      const float bt = sb + tr_b_mk;
      float nm[PER], ac[PER];
      float a_max = ninf;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = k * kThreads + t;
        nm[k] = ld_bf16(ms, j, m_pad) + fmaxf(diag[k], bt);
        ii[k] = ld_bf16(is, j, m_pad) +
                fmaxf(m[k] + ld(tmi, j, m_pad, ninf), ii[k] + ld(tii, j, m_pad, ninf));
        pd[k] = nm[k] + ld(tmd, j, m_pad, ninf);
        a_max = fmaxf(a_max, pd[k]);
      }
      // the warp's share of max(a0) is published before the shift's
      // barrier, which then orders it for every reader
      a_max = warp_max(a_max);
      if (truncated && lane == 0) red_a[warp] = a_max;
      shift_states<PER>(pd, ac, 1, ninf, xbuf[par]);
      par ^= 1;
      for (int p = 0; p < a.window; ++p) {
        const int s = 1 << p;
        const float* c = a.chain + p * m_pad;
        float sh[PER];
        shift_states<PER>(ac, sh, s, ninf, xbuf[par]);
        par ^= 1;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          ac[k] = fmaxf(ac[k], sh[k] + ld(c, k * kThreads + t, m_pad, ninf));
        }
      }
      if (truncated) {
        const float tail = block_max(red_a) + aux;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          if (k * kThreads + t < m_pad) ac[k] = fmaxf(ac[k], tail);
        }
      }

      float e = ninf;
#pragma unroll
      for (int k = 0; k < PER; ++k) e = fmaxf(e, e_skip_d ? nm[k] : fmaxf(nm[k], ac[k]));
      e = warp_max(e);
      if (lane == 0) red_e[warp] = e;
      __syncthreads();
      e = block_max(red_e);

#pragma unroll
      for (int k = 0; k < PER; ++k) {
        m[k] = nm[k];
        d[k] = ac[k];
      }
      sj = fmaxf(sj + tr_loop, e + tr_e_j);
      sc = fmaxf(sc + tr_loop, e + tr_e_c);
      sn = sn + tr_loop;
      sb = fmaxf(sn + tr_move, sj + tr_move);
    }
  }

#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = k * kThreads + t;
    if (j < m_pad) {
      a.m_out[row + j] = m[k];
      a.i_out[row + j] = ii[k];
      a.d_out[row + j] = d[k];
    }
  }
  if (t == 0) {
    a.s_out[seq] = sj;
    a.s_out[b_pad + seq] = sc;
    a.s_out[2 * b_pad + seq] = sn;
    a.s_out[3 * b_pad + seq] = sb;
    a.scores[seq] = sc + tr_move;
  }
}

template <int PER>
cudaError_t launch(const FilterArgs& a, cudaStream_t stream) {
  filter_kernel<PER><<<a.b_pad, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. `per` is the number of states a
// thread holds, one of the cases below, with 128 * per >= m_pad;
// `full_passes` = ceil(log2 m_pad) and 1 <= window <= full_passes; a tail
// term is applied when window < full_passes. Returns a cudaError_t.
extern "C" int p7_filter_launch(int device, int per, const void* msc, const void* isc,
                                const void* trans, const void* chain, int m_pad,
                                int full_passes, int window, int e_skip_d,
                                const void* tokens, int l_pad, const void* lengths,
                                const void* tr_rows, const void* consts, const void* m_in,
                                const void* i_in, const void* d_in, const void* s_in,
                                void* scores, void* m_out, void* i_out, void* d_out,
                                void* s_out, int b_pad, void* stream) {
  if (m_pad < 1 || m_pad > kThreads * per || full_passes < 1 || full_passes > 16 ||
      window < 1 || window > full_passes || b_pad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  FilterArgs a;
  a.msc = static_cast<const uint16_t*>(msc);
  a.isc = static_cast<const uint16_t*>(isc);
  a.trans = static_cast<const float*>(trans);
  a.chain = static_cast<const float*>(chain);
  a.m_pad = m_pad;
  a.full_passes = full_passes;
  a.window = window;
  a.e_skip_d = e_skip_d;
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
  a.b_pad = b_pad;
  auto* st = static_cast<cudaStream_t>(stream);
#define FILTER_CASE(P) \
  case P:              \
    return static_cast<int>(launch<P>(a, st));
  switch (per) {
    FILTER_CASE(1)
    FILTER_CASE(2)
    FILTER_CASE(3)
    FILTER_CASE(4)
    FILTER_CASE(5)
    FILTER_CASE(6)
    FILTER_CASE(7)
    FILTER_CASE(8)
    FILTER_CASE(9)
    FILTER_CASE(10)
    FILTER_CASE(11)
    FILTER_CASE(12)
    FILTER_CASE(13)
    FILTER_CASE(14)
    FILTER_CASE(15)
    FILTER_CASE(16)
    FILTER_CASE(17)
    FILTER_CASE(18)
    FILTER_CASE(19)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FILTER_CASE
}
