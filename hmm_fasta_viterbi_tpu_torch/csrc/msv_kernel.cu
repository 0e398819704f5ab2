// MSV max-plus DP scan, written by hand for Hopper (sm_90a).
//
// Replaces: hmm_fasta_viterbi_tpu/ops/pallas_msv.py::_msv_kernel, as launched
// by msv_pallas_call, in its three modes:
//  * exact mode with one profile (P = 1): an f32 emission table;
//  * filter mode (exact=False, skip_row0_guard=True): the host's bf16
//    round-up of the table, whose scores bound the exact ones from above;
//  * the profile stack (grid dimension P > 1): one launch scores P profiles
//    of one padded width against one staged database, in either mode.
// For every residue t < length of a sequence,
//     M_j = emit[tok][j] + max(M_{j-1}, B + tr_B_Mk)      (M_{-1} = -inf)
//     E   = max_j M_j
//     J   = max(J + tr_loop, E + tr_E_J)
//     C   = max(C + tr_loop, E + tr_E_C)
//     N   = N + tr_loop
//     B   = max(N + tr_move, J + tr_move)
// and the score is C + tr_move. The M row and J/C/N/B come in and go out
// so that a long sequence can be scanned in blocks (carry chaining); a null
// m_in starts from the row-0 carry (M = J = C = -inf, N = 0, B = tr_move)
// and a null m_out skips the carry store, as the stacked launch does.
//
// What bounds it on the H100: not device memory. A scan reads each token
// byte once and the emission table once per block, so at M = 1400 the whole
// 80 G-cell scan moves well under a gigabyte. The bound is the SM's issue
// rate and the serial chain of one step: every cell costs one emission read
// plus three FP32 operations (max, add, max into E), and each step ends in a
// 32-lane max-reduce and the J/C/N/B chain before the next step may start.
//
// What the design does about it:
//  * One warp per sequence. The row M_0..M_{32*PER-1} lives in registers,
//    PER consecutive states per lane, so a step is a map over j with no
//    memory traffic for the DP state. The j-1 shift stays in registers except
//    at a lane boundary, which is one __shfl_up_sync. E is a 5-shuffle
//    butterfly. The whole warp follows one sequence, so its residue loop
//    simply stops at that sequence's length: there are no masked pad steps,
//    and a pad token (PAD_TOKEN = 127) is never used to index the table.
//  * The emission table of one profile sits in shared memory as [20][32*PER]
//    entries, padded with -inf beyond M_pad (a -inf state never wins a max,
//    so pad states stay -inf and never reach E or a real state). Shared
//    memory was chosen over the read-only cache because the table (up to
//    194.5 KB of f32 at M = 2405) is read at every step by every warp of the
//    SM: in shared memory those reads have a fixed latency and cannot be
//    evicted by the token stream. A block loads the table once for all its
//    warps. PER is 8q + 4, and a lane reads its PER entries four at a time:
//    - f32 entries as float4s: the 16-byte reads of the 8 lanes of a
//      quarter-warp start 12 banks apart and never share a bank;
//    - bf16 entries (filter mode) as 8-byte uint2s, half the table and half
//      the shared-memory traffic of f32: lane l starts at word l * (4q + 2),
//      and as 4q + 2 = 2 * odd the 16 lanes of a half-warp start on 16
//      distinct even banks, each read covering two, so a warp's read is the
//      minimum of two conflict-free wavefronts. A bf16 entry widens to f32
//      exactly (a 16-bit shift), and the one-hot select of the TPU kernel
//      also adds a single bf16 term exactly, so the filter equals the exact
//      recurrence run on float(bf16 table) bit for bit.
//  * Tokens are int8 [B, L]; each lane loads one of 32 consecutive tokens and
//    the warp broadcasts them one per step with __shfl_sync.
//  * The profile of a block is blockIdx.y: it loads its own table and
//    constants and writes row y of scores [P, B]. P = 1 is the single scan.
//  * Float32 operations run in the order of ops/recurrence.py::msv_step
//    (B + tr_B_Mk formed once per step, then the max, then the add of the
//    emission), and the build does not use --use_fast_math, so the kernel
//    equals the plain PyTorch version and the NumPy oracle bit for bit.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise. The C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float f32_neg_inf() { return -__int_as_float(0x7f800000); }

// Entries of one table type: the -inf fill and the read of four
// consecutive entries (4g .. 4g + 3 of a lane's row) as floats.
template <typename T>
struct Entries;

template <>
struct Entries<float> {
  static __device__ __forceinline__ float neg_inf() { return f32_neg_inf(); }
  static __device__ __forceinline__ float4 load4(const float* row, int g) {
    return reinterpret_cast<const float4*>(row)[g];
  }
};

// bf16 held as its 16 bits; widening is exact: the bits become the high half
template <>
struct Entries<uint16_t> {
  static __device__ __forceinline__ uint16_t neg_inf() { return 0xff80u; }
  static __device__ __forceinline__ float4 load4(const uint16_t* row, int g) {
    const uint2 raw = reinterpret_cast<const uint2*>(row)[g];
    return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  }
};

template <int PER, typename T>
__global__ void __launch_bounds__(kMaxThreads)
msv_kernel(const T* __restrict__ emit,          // [P, 20, m_pad]
           int m_pad,
           const int8_t* __restrict__ tokens,   // [b_pad, l_pad]
           int l_pad,
           const int* __restrict__ lengths,     // [b_pad]
           const float* __restrict__ tr_rows,   // [2, b_pad]: tr_loop, tr_move
           const float* __restrict__ tr_consts, // [P, 3]: tr_B_Mk, tr_E_C, tr_E_J
           const float* __restrict__ m_in,      // [b_pad, m_pad] or null
           const float* __restrict__ s_in,      // [4, b_pad]: J, C, N, B
           float* __restrict__ scores,          // [P, b_pad]
           float* __restrict__ m_out,           // [b_pad, m_pad] or null
           float* __restrict__ s_out,           // [4, b_pad]
           int b_pad) {
  static_assert(PER % 8 == 4, "PER = 8q + 4 keeps the table reads conflict-free");
  constexpr int kRow = 32 * PER;
  const float neg_inf = f32_neg_inf();
  const int prof = blockIdx.y;

  extern __shared__ float4 table4[];
  T* table = reinterpret_cast<T*>(table4);
  const T* my_emit = emit + static_cast<size_t>(prof) * 20 * m_pad;
  for (int i = threadIdx.x; i < 20 * kRow; i += blockDim.x) {
    const int r = i / kRow;
    const int c = i - r * kRow;
    table[i] = c < m_pad ? my_emit[static_cast<size_t>(r) * m_pad + c] : Entries<T>::neg_inf();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int seq = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (seq >= b_pad) return;  // whole warp: no later barrier

  const int j0 = lane * PER;
  const float tr_loop = tr_rows[seq];
  const float tr_move = tr_rows[b_pad + seq];
  float m[PER];
  float st_j, st_c, st_n, st_b;
  if (m_in != nullptr) {
    const float* m_row_in = m_in + static_cast<size_t>(seq) * m_pad;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      m[k] = j0 + k < m_pad ? m_row_in[j0 + k] : neg_inf;
    }
    st_j = s_in[seq];
    st_c = s_in[b_pad + seq];
    st_n = s_in[2 * b_pad + seq];
    st_b = s_in[3 * b_pad + seq];
  } else {  // the row-0 carry (MSV_HMM.cpp:96-97)
#pragma unroll
    for (int k = 0; k < PER; ++k) m[k] = neg_inf;
    st_j = neg_inf;
    st_c = neg_inf;
    st_n = 0.0f;
    st_b = tr_move;
  }
  const float tr_b_mk = tr_consts[3 * prof];
  const float tr_e_c = tr_consts[3 * prof + 1];
  const float tr_e_j = tr_consts[3 * prof + 2];

  const int n = min(max(lengths[seq], 0), l_pad);
  const int8_t* tok_row = tokens + static_cast<size_t>(seq) * l_pad;
  const T* my_cols = table + j0;

  for (int t0 = 0; t0 < n; t0 += 32) {
    const int mine = t0 + lane < n ? static_cast<int>(tok_row[t0 + lane]) : 0;
    const int count = min(32, n - t0);
    for (int i = 0; i < count; ++i) {
      // a token outside 0..19 is clamped like an XLA gather; encoded
      // residues are always inside
      const int aa = min(max(__shfl_sync(kFullMask, mine, i), 0), 19);
      const T* row = my_cols + aa * kRow;
      const float bt = st_b + tr_b_mk;
      float prev = __shfl_up_sync(kFullMask, m[PER - 1], 1);
      if (lane == 0) prev = neg_inf;

      // in place, highest j first, so m[k - 1] still holds the old row
      float e0 = neg_inf, e1 = neg_inf, e2 = neg_inf, e3 = neg_inf;
#pragma unroll
      for (int g = PER / 4 - 1; g >= 0; --g) {
        const float4 e = Entries<T>::load4(row, g);
        m[4 * g + 3] = e.w + fmaxf(m[4 * g + 2], bt);
        m[4 * g + 2] = e.z + fmaxf(m[4 * g + 1], bt);
        m[4 * g + 1] = e.y + fmaxf(m[4 * g], bt);
        // (index kept in range for g == 0, where prev is taken instead)
        m[4 * g] = e.x + fmaxf(g > 0 ? m[(4 * g + PER - 1) % PER] : prev, bt);
        e3 = fmaxf(e3, m[4 * g + 3]);
        e2 = fmaxf(e2, m[4 * g + 2]);
        e1 = fmaxf(e1, m[4 * g + 1]);
        e0 = fmaxf(e0, m[4 * g]);
      }
      float e_st = fmaxf(fmaxf(e0, e1), fmaxf(e2, e3));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        e_st = fmaxf(e_st, __shfl_xor_sync(kFullMask, e_st, off));
      }
      st_j = fmaxf(st_j + tr_loop, e_st + tr_e_j);
      st_c = fmaxf(st_c + tr_loop, e_st + tr_e_c);
      st_n = st_n + tr_loop;
      st_b = fmaxf(st_n + tr_move, st_j + tr_move);
    }
  }

  if (m_out != nullptr) {
    float* m_row_out = m_out + static_cast<size_t>(seq) * m_pad;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (j0 + k < m_pad) m_row_out[j0 + k] = m[k];
    }
  }
  if (lane == 0) {
    if (s_out != nullptr) {
      s_out[seq] = st_j;
      s_out[b_pad + seq] = st_c;
      s_out[2 * b_pad + seq] = st_n;
      s_out[3 * b_pad + seq] = st_b;
    }
    scores[static_cast<size_t>(prof) * b_pad + seq] = st_c + tr_move;
  }
}

template <int PER, typename T>
cudaError_t launch(int warps, int num_p, const void* emit, int m_pad,
                   const int8_t* tokens, int l_pad, const int* lengths,
                   const float* tr_rows, const float* tr_consts,
                   const float* m_in, const float* s_in, float* scores,
                   float* m_out, float* s_out, int b_pad,
                   cudaStream_t stream) {
  const size_t smem = sizeof(T) * 20 * 32 * PER;
  cudaError_t err = cudaFuncSetAttribute(
      msv_kernel<PER, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((b_pad + warps - 1) / warps, num_p);
  msv_kernel<PER, T><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(emit), m_pad, tokens, l_pad, lengths, tr_rows,
      tr_consts, m_in, s_in, scores, m_out, s_out, b_pad);
  return cudaGetLastError();
}

template <int PER>
cudaError_t launch_mode(int bf16, int warps, int num_p, const void* emit, int m_pad,
                        const int8_t* tokens, int l_pad, const int* lengths,
                        const float* tr_rows, const float* tr_consts,
                        const float* m_in, const float* s_in, float* scores,
                        float* m_out, float* s_out, int b_pad, cudaStream_t stream) {
  if (bf16) {
    return launch<PER, uint16_t>(warps, num_p, emit, m_pad, tokens, l_pad, lengths,
                                 tr_rows, tr_consts, m_in, s_in, scores, m_out, s_out,
                                 b_pad, stream);
  }
  return launch<PER, float>(warps, num_p, emit, m_pad, tokens, l_pad, lengths, tr_rows,
                            tr_consts, m_in, s_in, scores, m_out, s_out, b_pad, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. `per` is the number of M states
// each lane holds; it must be one of the cases below (the Python wrapper's
// KERNEL_PER), and 32 * per >= m_pad. `warps` is the number of sequences
// per block, at most kMaxThreads / 32. `bf16` selects the filter's bf16
// table (16-bit entries) over f32; `num_p` profiles are stacked in emit
// [num_p, 20, m_pad] and tr_consts [num_p, 3], and scores is [num_p, b_pad].
// A null m_in starts from the row-0 carry (s_in is then not read); a null
// m_out or s_out skips that carry's store. Returns a cudaError_t.
extern "C" int msv_scan_launch(int device, int per, int warps, int bf16, int num_p,
                               const void* emit, int m_pad,
                               const void* tokens, int l_pad,
                               const void* lengths, const void* tr_rows,
                               const void* tr_consts, const void* m_in,
                               const void* s_in, void* scores, void* m_out,
                               void* s_out, int b_pad, void* stream) {
  if (warps < 1 || warps * 32 > kMaxThreads || m_pad > 32 * per || num_p < 1 ||
      num_p > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* tk = static_cast<const int8_t*>(tokens);
  const auto* ln = static_cast<const int*>(lengths);
  const auto* tr = static_cast<const float*>(tr_rows);
  const auto* tc = static_cast<const float*>(tr_consts);
  const auto* mi = static_cast<const float*>(m_in);
  const auto* si = static_cast<const float*>(s_in);
  auto* sc = static_cast<float*>(scores);
  auto* mo = static_cast<float*>(m_out);
  auto* so = static_cast<float*>(s_out);
  auto* st = static_cast<cudaStream_t>(stream);
#define MSV_CASE(P)                                                              \
  case P:                                                                        \
    return static_cast<int>(launch_mode<P>(bf16, warps, num_p, emit, m_pad, tk,  \
                                           l_pad, ln, tr, tc, mi, si, sc, mo, so, \
                                           b_pad, st));
  switch (per) {
    MSV_CASE(4)
    MSV_CASE(12)
    MSV_CASE(20)
    MSV_CASE(28)
    MSV_CASE(36)
    MSV_CASE(44)
    MSV_CASE(52)
    MSV_CASE(60)
    MSV_CASE(68)
    MSV_CASE(76)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MSV_CASE
}

extern "C" const char* msv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
