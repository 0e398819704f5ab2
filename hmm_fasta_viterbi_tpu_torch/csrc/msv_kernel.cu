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
// 80 G-cell scan moves well under a gigabyte. Every cell costs one emission
// read (a quarter of a 16-byte shared-memory load) plus three FP32
// instructions (max, add, max into E); the SM's shared-memory pipe (128 B a
// cycle, 32 f32 cells a cycle) and its issue rate (4 warp-instructions a
// cycle, about 33 cells a cycle with the step's own work) bound it at about
// 9.6 ms at 16384 x 3500 x 1400. Each step also carries a serial tail: the
// warp's max-reduce of E and the J/C/N/B chain, before the next step's
// first cell may start (it needs B). With a 5-shuffle E butterfly and a
// token shuffled and clamped every step, about 28 instructions a lane a step
// went to that tail, the token broadcast and the loop: 0.6 extra
// instructions a cell at 44 states a lane, 7 at 4; and the butterfly put
// about 150 cycles of latency on every step.
//
// What the design does about it:
//  * One warp per sequence up to 32 * 76 = 2432 states (LANES = 32). The
//    row M_0..M_{32*PER-1} lives in registers, PER consecutive states per
//    lane, so a step is a map over j with no memory traffic for the DP
//    state. The j-1 shift stays in registers except at a lane boundary,
//    which is one __shfl_up_sync. The whole warp follows one sequence, so
//    its residue loop stops at that sequence's length: there are no masked
//    pad steps, and a pad token (PAD_TOKEN = 127) never indexes the table.
//  * E is one __reduce_max_sync (redux.sync) over an order-preserving int
//    image of the float (the sign bit flips the magnitude bits: integer
//    order is float order, -0 below +0), one instruction instead of a
//    5-shuffle butterfly. E enters only E + tr_E_J and E + tr_E_C, whose
//    constants are never 0, so the sign of a zero E cannot show.
//  * Tokens: each lane loads one of 32 consecutive residues, clamps it to
//    0..19 once and stores it pre-multiplied by the row length; a step's
//    row offset is then one __shfl_sync, taken one step ahead (before the
//    tail of the step before). (Loading the next row's first four entries
//    there too, measured: the 68 and 76 cases spill under the 128-register
//    cap, and the narrow cases lose 2-7%; not kept.)
//  * The emission table of one profile sits in shared memory as [20][32*PER]
//    entries, padded with -inf beyond M_pad (a -inf state never wins a max,
//    so pad states stay -inf and never reach E or a real state). A block
//    loads the table once for all its warps. PER is 8q + 4, and a lane reads
//    its PER entries four at a time:
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
//  * Past 2432 states (up to 64 * 76 = 4864, LANES = 64) two warps follow
//    one sequence, 32 * PER states each. The f32 table there (389 KB at
//    4864 states) is larger than an SM's shared memory, so the wide case
//    keeps no table: each lane copies its own PER entries of the next
//    step's row from global memory (L2) into a private double buffer with
//    cp.async while the step runs, and waits only on its own copies (no
//    barrier publishes them). The bf16 table would fit; one layout serves
//    both. (A 2-block cluster holding half the f32 table each would keep
//    the table on the chip, at the price of a cluster launch and a
//    distributed-shared-memory exchange every step; the wide case aims at
//    being right, not fast.) The j-1 shift between the warps and E cross
//    through shared memory: at the end of each step warp 0's last state
//    and each warp's E go into a parity buffer, one named barrier (bar.sync
//    1 + pair, 64 threads) orders them, and both warps read both.
//  * Past 4864 states (the rows-in-memory case, LANES = 1024, no width cap)
//    one block of 1024 threads follows one sequence and keeps the M rows of
//    the last step and of this one in two scratch rows of global memory a
//    block, which the wrapper allocates (they stay in L2 while they fit),
//    with a persistent grid over the batch; thread t handles the states t,
//    t + 1024, ... (coalesced). M_j reads only M_{j-1} of the last step, so
//    one barrier a step orders everything: E's block max, whose warp values
//    go through a parity buffer. The table rows are read from L2. It aims at
//    being right, not fast: the same float32 operations.
//  * The profile of a block is blockIdx.y: it reads its own table and
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
constexpr int kMemLanes = 1024;  // the rows-in-memory case: one block a sequence

__device__ __forceinline__ float f32_neg_inf() { return -__int_as_float(0x7f800000); }

// Entries of one table type: the -inf fill, the read of four consecutive
// entries (4g .. 4g + 3 of a lane's row) as floats, and the 4-entry copy
// from global memory into shared memory (cp.async, 16 or 8 bytes).
template <typename T>
struct Entries;

template <>
struct Entries<float> {
  static __device__ __forceinline__ float neg_inf() { return f32_neg_inf(); }
  static __device__ __forceinline__ float at(const float* row, int j) { return row[j]; }
  static __device__ __forceinline__ float4 load4(const float* row, int g) {
    return reinterpret_cast<const float4*>(row)[g];
  }
  static __device__ __forceinline__ void copy4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
  }
};

// bf16 held as its 16 bits; widening is exact: the bits become the high half
template <>
struct Entries<uint16_t> {
  static __device__ __forceinline__ uint16_t neg_inf() { return 0xff80u; }
  static __device__ __forceinline__ float at(const uint16_t* row, int j) {
    return __uint_as_float(static_cast<uint32_t>(row[j]) << 16);
  }
  static __device__ __forceinline__ float4 load4(const uint16_t* row, int g) {
    const uint2 raw = reinterpret_cast<const uint2*>(row)[g];
    return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  }
  static __device__ __forceinline__ void copy4(uint16_t* dst, const uint16_t* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src) : "memory");
  }
};

// An order-preserving int image of a float (an involution): integer order
// is float order for every non-NaN value, -0 just below +0.
__device__ __forceinline__ int order_key(int bits) { return bits ^ ((bits >> 31) & 0x7fffffff); }

// The warp's max of one float a lane, in every lane: one redux.sync.
__device__ __forceinline__ int warp_max_key(float v) {
  return __reduce_max_sync(kFullMask, order_key(__float_as_int(v)));
}

__device__ __forceinline__ float key_float(int key) { return __int_as_float(order_key(key)); }

struct MsvArgs {
  const void* emit;         // [P, 20, m_pad]: f32, or bf16 bits
  int m_pad;
  const int8_t* tokens;     // [b_pad, l_pad]
  int l_pad;
  const int* lengths;       // [b_pad]
  const float* tr_rows;     // [2, b_pad]: tr_loop, tr_move
  const float* tr_consts;   // [P, 3]: tr_B_Mk, tr_E_C, tr_E_J
  const float* m_in;        // [b_pad, m_pad] or null
  const float* s_in;        // [4, b_pad]: J, C, N, B
  float* scores;            // [P, b_pad]
  float* m_out;             // [b_pad, m_pad] or null
  float* s_out;             // [4, b_pad] or null
  int b_pad;
};

// Dynamic shared memory of a block of `warps` warps, in bytes: the table
// (LANES = 32), or each warp's two row buffers and each pair's exchange
// slots (LANES = 64).
template <int PER, int LANES, typename T>
__host__ __device__ constexpr size_t msv_smem_bytes(int warps) {
  return LANES == 32 ? sizeof(T) * 20 * 32 * PER
                     : static_cast<size_t>(warps) * 2 * 32 * PER * sizeof(T) +
                           static_cast<size_t>(warps / 2) * 2 * 4 * sizeof(float);
}

template <int PER, int LANES, typename T>
__global__ void __launch_bounds__(kMaxThreads) msv_kernel(const MsvArgs a) {
  static_assert(PER % 8 == 4, "PER = 8q + 4 keeps the table reads conflict-free");
  static_assert(LANES == 32 || LANES == 64, "one or two warps a sequence");
  constexpr bool kWide = LANES == 64;
  constexpr int kRow = 32 * PER;  // a warp's states: the shared row length
  constexpr int kGroups = PER / 4;
  const float neg_inf = f32_neg_inf();
  const int prof = blockIdx.y;
  const int m_pad = a.m_pad;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = kWide ? (warp & 1) : 0;  // which warp of the sequence
  const int j0 = (half * 32 + lane) * PER;
  const T* my_emit = static_cast<const T*>(a.emit) + static_cast<size_t>(prof) * 20 * m_pad;

  extern __shared__ float4 smem4[];
  T* table = reinterpret_cast<T*>(smem4);
  // the wide case: this warp's two row buffers, then the pairs' exchange slots
  T* rowbuf = table + static_cast<size_t>(warp) * 2 * kRow;
  float* xchg = reinterpret_cast<float*>(table + static_cast<size_t>(blockDim.x >> 5) * 2 * kRow) +
                (warp >> 1) * 8;
  if constexpr (!kWide) {
    for (int i = threadIdx.x; i < 20 * kRow; i += blockDim.x) {
      const int r = i / kRow;
      const int c = i - r * kRow;
      table[i] = c < m_pad ? my_emit[static_cast<size_t>(r) * m_pad + c] : Entries<T>::neg_inf();
    }
    __syncthreads();
  } else {
    // the slots past m_pad are -inf in both buffers; no copy writes them
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (j0 + k >= m_pad) {
        rowbuf[lane * PER + k] = Entries<T>::neg_inf();
        rowbuf[kRow + lane * PER + k] = Entries<T>::neg_inf();
      }
    }
  }

  const int seq = blockIdx.x * (blockDim.x / LANES) + threadIdx.x / LANES;
  if (seq >= a.b_pad) return;  // the whole sequence's warps: no later block barrier
  const int b_pad = a.b_pad;
  const float tr_loop = a.tr_rows[seq];
  const float tr_move = a.tr_rows[b_pad + seq];
  float m[PER];
  float st_j, st_c, st_n, st_b;
  if (a.m_in != nullptr) {
    const float* m_row_in = a.m_in + static_cast<size_t>(seq) * m_pad;
#pragma unroll
    for (int k = 0; k < PER; ++k) m[k] = j0 + k < m_pad ? m_row_in[j0 + k] : neg_inf;
    st_j = a.s_in[seq];
    st_c = a.s_in[b_pad + seq];
    st_n = a.s_in[2 * b_pad + seq];
    st_b = a.s_in[3 * b_pad + seq];
  } else {  // the row-0 carry (MSV_HMM.cpp:96-97)
#pragma unroll
    for (int k = 0; k < PER; ++k) m[k] = neg_inf;
    st_j = neg_inf;
    st_c = neg_inf;
    st_n = 0.0f;
    st_b = tr_move;
  }
  const float tr_b_mk = a.tr_consts[3 * prof];
  const float tr_e_c = a.tr_consts[3 * prof + 1];
  const float tr_e_j = a.tr_consts[3 * prof + 2];

  // the wide case: the second warp's first state takes the first warp's
  // last one through the exchange slots, which start with the carry's
  const int bar = 1 + (warp >> 1);
  float bnd = neg_inf;
  if constexpr (kWide) {
    if (half == 0 && lane == 31) xchg[4] = m[PER - 1];
    asm volatile("bar.sync %0, 64;" ::"r"(bar) : "memory");
    bnd = xchg[4];
  }
  int par = 0;

  const int n = min(max(a.lengths[seq], 0), a.l_pad);
  const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
  // a row offset in table entries: the shared table's, or the global one's
  const int row_len = kWide ? m_pad : kRow;
  const T* my_cols = kWide ? rowbuf + lane * PER : table + j0;

  // copies of row `off` (in my_emit) into the row buffer of parity q (wide)
  auto fetch = [&](int off, int q) {
    if constexpr (kWide) {
      T* dst = rowbuf + q * kRow + lane * PER;
      const T* src = my_emit + off + j0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (j0 + 4 * g < m_pad) Entries<T>::copy4(dst + 4 * g, src + 4 * g);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
  };

  for (int t0 = 0; t0 < n; t0 += 32) {
    // clamped once, as a row offset: a token outside 0..19 is clamped like
    // an XLA gather; encoded residues are always inside
    const int mine = t0 + lane < n
                         ? min(max(static_cast<int>(tok_row[t0 + lane]), 0), 19) * row_len
                         : 0;
    const int count = min(32, n - t0);
    int off = __shfl_sync(kFullMask, mine, 0);
    fetch(off, par);
    const T* row = my_cols + (kWide ? par * kRow : off);
    if constexpr (kWide) asm volatile("cp.async.wait_group 0;" ::: "memory");
    for (int i = 0; i < count; ++i) {
      const float bt = st_b + tr_b_mk;
      // the next step's row: its offset now, and for the wide case its copy
      const int next = __shfl_sync(kFullMask, mine, i + 1 < 32 ? i + 1 : 0);
      const bool more = i + 1 < count;
      if constexpr (kWide) {
        if (more) fetch(next, par ^ 1);
      }
      float prev = __shfl_up_sync(kFullMask, m[PER - 1], 1);
      if (lane == 0) prev = half == 0 ? neg_inf : bnd;

      // in place, highest j first, so m[k - 1] still holds the old row
      float e0 = neg_inf, e1 = neg_inf, e2 = neg_inf, e3 = neg_inf;
#pragma unroll
      for (int g = kGroups - 1; g >= 0; --g) {
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
      int key = warp_max_key(fmaxf(fmaxf(e0, e1), fmaxf(e2, e3)));
      if constexpr (kWide) {
        // both warps' E and the first warp's last state, one barrier
        float* x = xchg + 4 * par;
        if (lane == 0) reinterpret_cast<int*>(x)[1 + half] = key;
        if (half == 0 && lane == 31) x[0] = m[PER - 1];
        asm volatile("bar.sync %0, 64;" ::"r"(bar) : "memory");
        key = max(reinterpret_cast<const int*>(x)[1], reinterpret_cast<const int*>(x)[2]);
        bnd = x[0];
        par ^= 1;
        row = my_cols + par * kRow;
        if (more) asm volatile("cp.async.wait_group 0;" ::: "memory");
      } else {
        row = my_cols + next;
      }
      const float e_st = key_float(key);
      st_j = fmaxf(st_j + tr_loop, e_st + tr_e_j);
      st_c = fmaxf(st_c + tr_loop, e_st + tr_e_c);
      st_n = st_n + tr_loop;
      st_b = fmaxf(st_n + tr_move, st_j + tr_move);
    }
  }

  if (a.m_out != nullptr) {
    float* m_row_out = a.m_out + static_cast<size_t>(seq) * m_pad;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (j0 + k < m_pad) m_row_out[j0 + k] = m[k];
    }
  }
  if (half == 0 && lane == 0) {
    if (a.s_out != nullptr) {
      a.s_out[seq] = st_j;
      a.s_out[b_pad + seq] = st_c;
      a.s_out[2 * b_pad + seq] = st_n;
      a.s_out[3 * b_pad + seq] = st_b;
    }
    a.scores[static_cast<size_t>(prof) * b_pad + seq] = st_c + tr_move;
  }
}

// The rows-in-memory case: msv_kernel's step over two scratch rows a block,
// [P, gridDim.x, 2, m_pad] in `scratch`, in the same float32 operations.
template <typename T>
__global__ void __launch_bounds__(kMemLanes) msv_mem_kernel(const MsvArgs a, float* scratch) {
  __shared__ int red[2][kMemLanes / 32];
  const float neg_inf = f32_neg_inf();
  const int prof = blockIdx.y;
  const int m_pad = a.m_pad;
  const int t = threadIdx.x;
  const int b_pad = a.b_pad;
  const T* my_emit = static_cast<const T*>(a.emit) + static_cast<size_t>(prof) * 20 * m_pad;
  float* rows = scratch + (static_cast<size_t>(prof) * gridDim.x + blockIdx.x) * 2 * m_pad;
  const float tr_b_mk = a.tr_consts[3 * prof];
  const float tr_e_c = a.tr_consts[3 * prof + 1];
  const float tr_e_j = a.tr_consts[3 * prof + 2];

  for (int seq = blockIdx.x; seq < b_pad; seq += gridDim.x) {
    const float tr_loop = a.tr_rows[seq];
    const float tr_move = a.tr_rows[b_pad + seq];
    const size_t at = static_cast<size_t>(seq) * m_pad;
    for (int j = t; j < m_pad; j += kMemLanes) rows[j] = a.m_in != nullptr ? a.m_in[at + j] : neg_inf;
    float st_j = neg_inf, st_c = neg_inf, st_n = 0.0f, st_b = tr_move;  // the row-0 carry
    if (a.m_in != nullptr) {
      st_j = a.s_in[seq];
      st_c = a.s_in[b_pad + seq];
      st_n = a.s_in[2 * b_pad + seq];
      st_b = a.s_in[3 * b_pad + seq];
    }
    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;
    int par = 0;
    __syncthreads();
    for (int pos = 0; pos < n; ++pos) {
      const T* er = my_emit + min(max(static_cast<int>(tok_row[pos]), 0), 19) * m_pad;
      const float* mo = rows + par * m_pad;
      float* mn = rows + (par ^ 1) * m_pad;
      const float bt = st_b + tr_b_mk;
      float e = neg_inf;
      for (int j = t; j < m_pad; j += kMemLanes) {
        const float nm = Entries<T>::at(er, j) + fmaxf(j > 0 ? mo[j - 1] : neg_inf, bt);
        mn[j] = nm;
        e = fmaxf(e, nm);
      }
      const int key = warp_max_key(e);
      if ((t & 31) == 0) red[par][t >> 5] = key;
      __syncthreads();  // E's warp values, and the new row for the next step
      int best = red[par][0];
#pragma unroll
      for (int w = 1; w < kMemLanes / 32; ++w) best = max(best, red[par][w]);
      const float e_st = key_float(best);
      st_j = fmaxf(st_j + tr_loop, e_st + tr_e_j);
      st_c = fmaxf(st_c + tr_loop, e_st + tr_e_c);
      st_n = st_n + tr_loop;
      st_b = fmaxf(st_n + tr_move, st_j + tr_move);
      par ^= 1;
    }
    if (a.m_out != nullptr) {
      float* m_row_out = a.m_out + static_cast<size_t>(seq) * m_pad;
      for (int j = t; j < m_pad; j += kMemLanes) m_row_out[j] = rows[par * m_pad + j];
    }
    if (t == 0) {
      if (a.s_out != nullptr) {
        a.s_out[seq] = st_j;
        a.s_out[b_pad + seq] = st_c;
        a.s_out[2 * b_pad + seq] = st_n;
        a.s_out[3 * b_pad + seq] = st_b;
      }
      a.scores[static_cast<size_t>(prof) * b_pad + seq] = st_c + tr_move;
    }
    __syncthreads();  // the next sequence's row goes into these
  }
}

template <int PER, int LANES, typename T>
cudaError_t launch(int warps, int num_p, const MsvArgs& a, cudaStream_t stream) {
  const size_t smem = msv_smem_bytes<PER, LANES, T>(warps);
  cudaError_t err = cudaFuncSetAttribute(
      msv_kernel<PER, LANES, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int seqs = warps * 32 / LANES;
  const dim3 grid((a.b_pad + seqs - 1) / seqs, num_p);
  msv_kernel<PER, LANES, T><<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int PER, int LANES>
cudaError_t launch_mode(int bf16, int warps, int num_p, const MsvArgs& a, cudaStream_t stream) {
  return bf16 ? launch<PER, LANES, uint16_t>(warps, num_p, a, stream)
              : launch<PER, LANES, float>(warps, num_p, a, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. `lanes` (32: one warp a sequence;
// 64: two; kMemLanes: the rows-in-memory case) and `per`, the number of M
// states each lane holds (tiles of kMemLanes states in the last case), name
// the kernel case: per 4, 12, ..., 76 at 32 lanes and 44, ..., 76 at 64 (the
// Python wrapper's KERNEL_PER, WIDE_PER), any at kMemLanes, with lanes * per
// >= m_pad (a multiple of 8 at 64 lanes: the row copies are 16 or 8 bytes).
// `warps` is the number of warps a block, at most kMaxThreads / 32 (even at
// 64 lanes; ignored at kMemLanes, whose block is kMemLanes threads and whose
// persistent grid is `grid` blocks a profile, with `scratch` [num_p, grid,
// 2, m_pad] floats). `bf16` selects the filter's bf16
// table (16-bit entries) over f32; `num_p` profiles are stacked in emit
// [num_p, 20, m_pad] and tr_consts [num_p, 3], and scores is [num_p, b_pad].
// A null m_in starts from the row-0 carry (s_in is then not read); a null
// m_out or s_out skips that carry's store. Returns a cudaError_t.
extern "C" int msv_scan_launch(int device, int lanes, int per, int warps, int bf16, int num_p,
                               const void* emit, int m_pad,
                               const void* tokens, int l_pad,
                               const void* lengths, const void* tr_rows,
                               const void* tr_consts, const void* m_in,
                               const void* s_in, void* scores, void* m_out,
                               void* s_out, int b_pad, int grid, void* scratch, void* stream) {
  const bool mem = lanes == kMemLanes;
  if ((!mem && (warps < 1 || warps * 32 > kMaxThreads || (warps * 32) % lanes != 0)) ||
      (mem && (grid < 1 || scratch == nullptr)) || m_pad < 1 ||
      static_cast<long>(lanes) * per < m_pad || (lanes == 64 && m_pad % 8 != 0) || num_p < 1 ||
      num_p > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MsvArgs a;
  a.emit = emit;
  a.m_pad = m_pad;
  a.tokens = static_cast<const int8_t*>(tokens);
  a.l_pad = l_pad;
  a.lengths = static_cast<const int*>(lengths);
  a.tr_rows = static_cast<const float*>(tr_rows);
  a.tr_consts = static_cast<const float*>(tr_consts);
  a.m_in = static_cast<const float*>(m_in);
  a.s_in = static_cast<const float*>(s_in);
  a.scores = static_cast<float*>(scores);
  a.m_out = static_cast<float*>(m_out);
  a.s_out = static_cast<float*>(s_out);
  a.b_pad = b_pad;
  auto* st = static_cast<cudaStream_t>(stream);
  if (mem) {
    auto* rows = static_cast<float*>(scratch);
    if (bf16) {
      msv_mem_kernel<uint16_t><<<dim3(grid, num_p), kMemLanes, 0, st>>>(a, rows);
    } else {
      msv_mem_kernel<float><<<dim3(grid, num_p), kMemLanes, 0, st>>>(a, rows);
    }
    return static_cast<int>(cudaGetLastError());
  }
#define MSV_CASE(P, L) \
  case P:              \
    return static_cast<int>(launch_mode<P, L>(bf16, warps, num_p, a, st));
  if (lanes == 32) {
    switch (per) {
      MSV_CASE(4, 32)
      MSV_CASE(12, 32)
      MSV_CASE(20, 32)
      MSV_CASE(28, 32)
      MSV_CASE(36, 32)
      MSV_CASE(44, 32)
      MSV_CASE(52, 32)
      MSV_CASE(60, 32)
      MSV_CASE(68, 32)
      MSV_CASE(76, 32)
      default:
        break;
    }
  } else if (lanes == 64) {
    switch (per) {
      MSV_CASE(44, 64)
      MSV_CASE(52, 64)
      MSV_CASE(60, 64)
      MSV_CASE(68, 64)
      MSV_CASE(76, 64)
      default:
        break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
#undef MSV_CASE
}

extern "C" const char* msv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
