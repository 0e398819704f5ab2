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
// instructions (max, add, max into E). The two maxes bind it: FMNMX issues
// at half rate, 2 warp-instructions a cycle an SM against FADD's 4
// (measured on an H100, tools/torch_msv_timing.py --probe). At 44 states a
// lane a step runs 92 FMNMX and 6 integer instructions taken to share that
// pipe (LOP3, SHF, FSEL, ISETP), 49 cycles an SM a warp-step: 10.8 ms at
// 16384 x 3500 x 1400 and 1.98 GHz, where the shared-memory pipe (11
// LDS.128 a warp-step at 128 B a cycle) allows 9.65 ms and issue (174
// instructions a warp-step, 4 a cycle) 9.5 ms. The scan runs at about 85%
// of that ceiling; more warps an SM do not bring it closer (PERF.md). Each
// step also carries a serial tail: the warp's max-reduce of E and the
// J/C/N/B chain, before the next step's first cell may start (it needs
// B). With a 5-shuffle E butterfly and a token shuffled and clamped every
// step, about 28 instructions a lane a step went to that tail, the token
// broadcast and the loop: 0.6 extra instructions a cell at 44 states a
// lane, 7 at 4; and the butterfly put about 150 cycles of latency on every
// step.
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
//    constants are never 0, so the sign of a zero E cannot show. A lane's
//    own max runs in two chains over its states, joined by one more max
//    (four chains cost two more ALU instructions a step, 4.6% at PER 44;
//    one chain's latency 7.5%).
//  * Tokens: each lane loads one of 32 consecutive residues, clamps it to
//    0..19 once and stores it pre-multiplied by the row length; a step's
//    row offset is then one __shfl_sync, taken one step ahead (before the
//    tail of the step before), from lane i + 1, which the shuffle wraps to
//    lane 0 after lane 31 (no select in the step). (Loading the next row's first four entries
//    there too, measured: the 68 and 76 cases spill under the 128-register
//    cap, and the narrow cases lose 2-7%; not kept.)
//  * The emission table of one profile sits in shared memory as [20][32*PER]
//    f32 entries in both modes, padded with -inf beyond M_pad (a -inf state
//    never wins a max, so pad states stay -inf and never reach E or a real
//    state). PER is 8q + 4, and a lane reads its PER entries as float4s: the
//    16-byte reads of the 8 lanes of a quarter-warp start 12 banks apart and
//    never share a bank. The filter's table comes from global memory as bf16
//    bits and is widened while it is staged, once a block: a bf16 entry
//    widens to f32 exactly (a 16-bit shift), and the one-hot select of the
//    TPU kernel also adds a single bf16 term exactly, so the filter equals
//    the exact recurrence run on float(bf16 table) bit for bit. Its step is
//    then the exact scan's, instruction for instruction. (A bf16 table in
//    shared memory, half the bytes, widened entry by entry in the step,
//    cost one more integer instruction a cell and ran 36% slower than the
//    exact scan.)
//  * Launch plan (ops/msv_cuda.py::launch_plan): WARPS warps a block, each
//    case compiled under __launch_bounds__(32 * WARPS, 1), so that ptxas
//    holds the registers to what WARPS warps a block need, on a persistent
//    grid of one block an SM and profile: a block stages its table once and
//    its warps walk the batch with a stride of gridDim.x * WARPS sequences
//    (a warp that finishes a short sequence takes the next one).
//  * Past 2432 states (up to 64 * 76 = 4864, LANES = 64) two warps follow
//    one sequence, 32 * PER states each. The f32 table there (389 KB at
//    4864 states) is larger than an SM's shared memory, so the wide case
//    keeps no table: each lane copies its own PER entries of the next
//    step's row from global memory (L2) into a private double buffer with
//    cp.async while the step runs, and waits only on its own copies (no
//    barrier publishes them). The filter's rows stay bf16 there (8-byte
//    copies, half the L2 traffic; lane l's reads start at word l * (4q + 2),
//    16 distinct even banks a half-warp), widened in the step. (A 2-block
//    cluster holding half the f32 table each would keep the table on the
//    chip, at the price of a cluster launch and a
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
#include <type_traits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWideWarps = 16;   // the wide case's largest block (512 threads)
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

// Dynamic shared memory of a block of `warps` warps, in bytes: the f32
// table (LANES = 32), or each warp's two row buffers of `entry`-byte
// entries and each pair's exchange slots (LANES = 64).
size_t msv_smem_bytes(int lanes, int per, int warps, int entry) {
  return lanes == 32 ? sizeof(float) * 20 * 32 * per
                     : static_cast<size_t>(warps) * 2 * 32 * per * entry +
                           static_cast<size_t>(warps / 2) * 2 * 4 * sizeof(float);
}

template <int PER, int LANES, typename T, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 1) msv_kernel(const MsvArgs a) {
  static_assert(PER % 8 == 4, "PER = 8q + 4 keeps the table reads conflict-free");
  static_assert(LANES == 32 || LANES == 64, "one or two warps a sequence");
  constexpr bool kWide = LANES == 64;
  // shared entries: the register cases' table is f32 in both modes, the
  // wide case's row buffers hold the global entries
  using S = typename std::conditional<kWide, T, float>::type;
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
  S* table = reinterpret_cast<S*>(smem4);
  // the wide case: this warp's two row buffers, then the pairs' exchange slots
  S* rowbuf = table + static_cast<size_t>(warp) * 2 * kRow;
  float* xchg = reinterpret_cast<float*>(table + static_cast<size_t>(blockDim.x >> 5) * 2 * kRow) +
                (warp >> 1) * 8;
  if constexpr (!kWide) {
    // widened to f32 here, once a block (exact for bf16: the bits become the
    // high half), so that the step reads f32 in both modes
    for (int i = threadIdx.x; i < 20 * kRow; i += blockDim.x) {
      const int r = i / kRow;
      const int c = i - r * kRow;
      table[i] = c < m_pad ? Entries<T>::at(my_emit + static_cast<size_t>(r) * m_pad, c) : neg_inf;
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
  const float tr_b_mk = a.tr_consts[3 * prof];
  const float tr_e_c = a.tr_consts[3 * prof + 1];
  const float tr_e_j = a.tr_consts[3 * prof + 2];
  const int b_pad = a.b_pad;
  [[maybe_unused]] const int bar = 1 + (warp >> 1);  // the wide case's pair barrier
  // a row offset in table entries: the shared table's, or the global one's
  const int row_len = kWide ? m_pad : kRow;
  const S* my_cols = kWide ? rowbuf + lane * PER : table + j0;

  // the block's sequences at a time walk the batch: once for a grid that
  // covers it, a stride at a time for a persistent one (the whole
  // sequence's warps leave together: no later block barrier)
  const int seqs = blockDim.x / LANES;
  for (int seq = blockIdx.x * seqs + threadIdx.x / LANES; seq < b_pad; seq += gridDim.x * seqs) {
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

    // the wide case: the second warp's first state takes the first warp's
    // last one through the exchange slots, which start with the carry's
    float bnd = neg_inf;
    if constexpr (kWide) {
      if (half == 0 && lane == 31) xchg[4] = m[PER - 1];
      asm volatile("bar.sync %0, 64;" ::"r"(bar) : "memory");
      bnd = xchg[4];
    }
    int par = 0;

    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    const int8_t* tok_row = a.tokens + static_cast<size_t>(seq) * a.l_pad;

    // copies of row `off` (in my_emit) into the row buffer of parity q (wide)
    auto fetch = [&](int off, int q) {
      if constexpr (kWide) {
        S* dst = rowbuf + q * kRow + lane * PER;
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
      const S* row = my_cols + (kWide ? par * kRow : off);
      if constexpr (kWide) asm volatile("cp.async.wait_group 0;" ::: "memory");
      for (int i = 0; i < count; ++i) {
        const float bt = st_b + tr_b_mk;
        // the next step's row: its offset now, and for the wide case its copy
        const int next = __shfl_sync(kFullMask, mine, i + 1);  // lane 32 is lane 0
        const bool more = i + 1 < count;
        if constexpr (kWide) {
          if (more) fetch(next, par ^ 1);
        }
        float prev = __shfl_up_sync(kFullMask, m[PER - 1], 1);
        if (lane == 0) prev = half == 0 ? neg_inf : bnd;

        // in place, highest j first, so m[k - 1] still holds the old row
        // E in two chains: one max a cell, one to join them
        float e0 = neg_inf, e1 = neg_inf;
#pragma unroll
        for (int g = kGroups - 1; g >= 0; --g) {
          const float4 e = Entries<S>::load4(row, g);
          m[4 * g + 3] = e.w + fmaxf(m[4 * g + 2], bt);
          m[4 * g + 2] = e.z + fmaxf(m[4 * g + 1], bt);
          m[4 * g + 1] = e.y + fmaxf(m[4 * g], bt);
          // (index kept in range for g == 0, where prev is taken instead)
          m[4 * g] = e.x + fmaxf(g > 0 ? m[(4 * g + PER - 1) % PER] : prev, bt);
          e1 = fmaxf(e1, m[4 * g + 3]);
          e0 = fmaxf(e0, m[4 * g + 2]);
          e1 = fmaxf(e1, m[4 * g + 1]);
          e0 = fmaxf(e0, m[4 * g]);
        }
        int key = warp_max_key(fmaxf(e0, e1));
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
    // the wide case: both warps are done with the pair's exchange slots
    // before its next sequence writes them
    if constexpr (kWide) asm volatile("bar.sync %0, 64;" ::"r"(bar) : "memory");
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

using KernelFn = void (*)(MsvArgs);

// The register cases' blocks: each is a kernel of its own, compiled under
// __launch_bounds__(32 * warps, 1) (ops/msv_cuda.py::WARP_CHOICES).
template <int PER, int LANES, typename T>
KernelFn kernel_of(int warps) {
  if constexpr (LANES == 64) {
    if (warps < 2 || warps % 2 != 0 || warps > kWideWarps) return nullptr;
    return msv_kernel<PER, 64, T, kWideWarps>;
  } else {
    switch (warps) {
      case 8: return msv_kernel<PER, 32, T, 8>;
      case 12: return msv_kernel<PER, 32, T, 12>;
      case 16: return msv_kernel<PER, 32, T, 16>;
      case 20: return msv_kernel<PER, 32, T, 20>;
      case 24: return msv_kernel<PER, 32, T, 24>;
      case 28: return msv_kernel<PER, 32, T, 28>;
      case 32: return msv_kernel<PER, 32, T, 32>;
      default: return nullptr;
    }
  }
}

// The kernel of a register case (32 or 64 lanes), or null for none.
KernelFn find_kernel(int lanes, int per, int warps, int bf16) {
#define MSV_CASE(P, L) \
  case P:              \
    return bf16 ? kernel_of<P, L, uint16_t>(warps) : kernel_of<P, L, float>(warps);
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
  return nullptr;
#undef MSV_CASE
}

}  // namespace

// Plain C entry point, bound with ctypes. `lanes` (32: one warp a sequence;
// 64: two; kMemLanes: the rows-in-memory case) and `per`, the number of M
// states each lane holds (tiles of kMemLanes states in the last case), name
// the kernel case: per 4, 12, ..., 76 at 32 lanes and 44, ..., 76 at 64 (the
// Python wrapper's KERNEL_PER, WIDE_PER), any at kMemLanes, with lanes * per
// >= m_pad (a multiple of 8 at 64 lanes: the row copies are 16 or 8 bytes).
// `warps` warps a block and `grid` blocks a profile are the launch plan of
// ops/msv_cuda.py::launch_plan: at 32 lanes one of 8, 12, ..., 32 (each its
// own compiled kernel), at 64 an even number up to kWideWarps; a grid
// smaller than the batch needs makes the warps walk it with a stride. At
// kMemLanes the block is kMemLanes threads (`warps` is not read) and
// `scratch` holds [num_p, grid, 2, m_pad] floats. `bf16` selects the
// filter's bf16 table (16-bit entries) over f32; `num_p` profiles are
// stacked in emit [num_p, 20, m_pad] and tr_consts [num_p, 3], and scores is
// [num_p, b_pad]. A null m_in starts from the row-0 carry (s_in is then not
// read); a null m_out or s_out skips that carry's store. Returns a
// cudaError_t.
extern "C" int msv_scan_launch(int device, int lanes, int per, int warps, int bf16, int num_p,
                               const void* emit, int m_pad,
                               const void* tokens, int l_pad,
                               const void* lengths, const void* tr_rows,
                               const void* tr_consts, const void* m_in,
                               const void* s_in, void* scores, void* m_out,
                               void* s_out, int b_pad, int grid, void* scratch, void* stream) {
  const bool mem = lanes == kMemLanes;
  const KernelFn fn = mem ? nullptr : find_kernel(lanes, per, warps, bf16);
  if ((!mem && fn == nullptr) || (mem && scratch == nullptr) || grid < 1 || m_pad < 1 ||
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
  const size_t smem = msv_smem_bytes(lanes, per, warps, bf16 ? 2 : 4);
  const void* kernel = reinterpret_cast<const void*>(fn);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchKernel(kernel, dim3(grid, num_p), dim3(warps * 32), args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local-memory (spill) bytes a thread of a register
// case's kernel (`lanes` 32 or 64, `per`, `warps`, `bf16` as for
// msv_scan_launch), as compiled, for the launch plan and its report.
// Returns a cudaError_t.
extern "C" int msv_kernel_attrs(int lanes, int per, int warps, int bf16, int* regs,
                                int* local_bytes) {
  const KernelFn fn = find_kernel(lanes, per, warps, bf16);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(fn));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

extern "C" const char* msv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
