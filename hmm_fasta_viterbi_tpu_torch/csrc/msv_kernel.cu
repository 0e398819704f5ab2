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
//  * Past 2432 states (up to 16 * 2432 = 38,912) one sequence is followed
//    by C warps, one in each block of a C-block thread-block cluster (a
//    cluster launch, cudaLaunchKernelEx; 2 <= C <= 16, LANES = 32 * C, C =
//    ceil(M_pad / 2432), the kernel reads it from %cluster_nctarank, so one
//    compiled case of PER serves every C). The f32 table of C * 2432 states
//    is larger than an SM's shared memory, but a C-th of it is not: block r
//    of the cluster stages slice r, 20 x 32 * PER entries (194,560 bytes at
//    PER = 76, the normal-width case's table), once a block, and its warp w
//    follows states 32 * PER * r .. 32 * PER * (r + 1) - 1 of its sequence
//    with the normal-width step; the C blocks' warps w walk the batch
//    together with a persistent stride (a grid of as many clusters as the
//    card holds at once, cudaOccupancyMaxActiveClusters). Two things cross
//    the cluster every step, through distributed shared memory: block r's
//    last state, which block r + 1's first state takes at the next step (the
//    j-1 shift), and every block's E. Lane 31 of a warp, which holds that
//    last state, stores (E key, last state) into the warp w of rank r + 1,
//    and lane p < C of it stores the E key into rank p's (p other than r and
//    r + 1), each with one asynchronous store (st.async at the address mapa
//    gives) that completes its bytes of the transaction of the receiver's
//    mbarrier; lane 0 then arrives on its own barrier expecting the C - 1
//    messages (4 bytes a key, 4 more for the halo when r > 0), the warp waits
//    on it (acquire at cluster scope) and takes the max of its own key and
//    the C - 1 it received (one redux.sync: an integer max, the same in
//    every block whatever the order). (A store and
//    mbarrier.arrive.release.cluster instead, measured on an H100 at C = 2:
//    9.8 ms against 6.8 at 2048 x 3500 x 4770, the release fencing the
//    lane's memory operations every step.) Slots and barriers go by step
//    parity, a slot a sending rank: a warp is at most one message ahead of
//    any other of its cluster, since each needs every other's message of the
//    step before. No block barrier couples the warps of a block, so they
//    still walk sequences of different lengths apart.
//  * Past 38,912 states, up to 16 * 32 * 128 = 65,536, one sequence is
//    followed by the 16 warps of a 16-block cluster again, one a block, each
//    holding its slice of 32 * PER states in registers, PER of 80, 88, ...,
//    128 (msv_wide_cluster_kernel; LANES = 32 * 16 with PER past 76 names
//    the case): the cluster case's step and exchange, operation for
//    operation. A block is 8 warps (__launch_bounds__(256, 1): up to 255
//    registers a thread for 128 states a lane, without spilling). C is 16
//    whatever the width: 16 blocks of 128 states a lane are the widest row
//    the registers hold, and the H100 holds as many 16-block clusters as
//    13-block ones (7), on more of its SMs. A C-th of the f32 table no
//    longer fits a block (80 bytes a state: 327,680 at 4096 states), so a
//    block stages each lane's last STAGED = 84 states (76 at PER 80; 8q + 4,
//    conflict-free as above; 217,088 bytes with the links) and reads the
//    lane's first PER - STAGED from a lane-major f32 copy in global memory
//    ([P][20][C][(PER - STAGED) / 4][32] float4s, ops/msv_cuda.py::
//    lane_rows: a warp's read of a float4 index is 512 contiguous bytes; 1.8
//    MB at PER 128, held in L2). Those states come last in the step, and
//    their next step's entries are loaded once this step's last cell is done,
//    while the exchange completes. The filter's copy is its bf16 table
//    widened (exact), so both modes run the same step.
//  * Past 65,536 states (the rows-in-memory case, LANES = 1024, no width
//    cap) one block of 1024 threads follows one sequence and keeps the M rows of
//    the last step and of this one in two scratch rows of global memory a
//    block, which the wrapper allocates (they stay in L2 while they fit),
//    with a persistent grid over the batch; thread t handles the states t,
//    t + 1024, ... (coalesced). M_j reads only M_{j-1} of the last step, so
//    one barrier a step orders everything: E's block max, whose warp values
//    go through a parity buffer. The table rows are read from L2. It aims at
//    being right, not fast: the same float32 operations. The launch plan
//    also takes it for a width whose cluster the card cannot hold
//    (ops/msv_cuda.py::device_plan).
//  * The profile of a block is blockIdx.y: it reads its own table and
//    constants and writes row y of scores [P, B]. P = 1 is the single scan.
//  * A row table (ops/msv_cuda.py::RowTable, row_at non-null) lets one launch
//    score every row of a length-bucketed staging: row r's tokens start
//    row_at[r] bytes into one token buffer, its length and transitions are
//    entry r of lengths and tr_rows, and its score goes to column dest[r].
//    The table lists the rows longest first, and the rows go to the warps in
//    that order: warp w of unit u (a block, or a cluster) first takes row
//    w * units + u, so the units' warps 0 take the longest rows, one a unit
//    and so one an SM. Then a warp of a register case takes the next row no
//    warp has claimed (an atomic counter a profile, which the wrapper zeroes:
//    a warp on a long row takes no other row meanwhile), and a cluster's
//    warps every units * WARPS-th row, an order all its blocks agree on; the
//    rows-in-memory case's blocks take every gridDim.x-th row. Each row runs
//    from the row-0 carry with the same step: the kernel stops a row at its
//    own length, so rows of many lengths in one launch cost no pad steps,
//    and the long rows' latencies overlap instead of adding up bucket after
//    bucket.
//  * Float32 operations run in the order of ops/recurrence.py::msv_step
//    (B + tr_B_Mk formed once per step, then the max, then the add of the
//    emission), and the build does not use --use_fast_math, so the kernel
//    equals the plain PyTorch version and the NumPy oracle bit for bit.
//  * It launches on the caller's stream, allocates nothing and does not
//    synchronise. The C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cluster.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kClusterWarps = 16;  // the cluster case's block (512 threads), a warp a slice of a sequence
constexpr int kMaxCluster = 16;    // blocks a cluster (past 8 a non-portable size)
constexpr int kWideWarps = 8;      // the case past 38,912 (256 threads): a warp a slice of a sequence
constexpr int kWidePerMin = 80;    // its PER: 80, 88, ..., 128 (C = 16)
constexpr int kWidePerMax = 128;
constexpr int kWideStagedMax = 84;  // the most states a lane stages there (8q + 4)
constexpr int kMemLanes = 1024;    // the rows-in-memory case: one block a sequence

// The states a lane of the case past 38,912 stages: the largest 8q + 4 up to
// min(PER, kWideStagedMax).
__host__ __device__ constexpr int wide_staged(int per) {
  return per >= kWideStagedMax ? kWideStagedMax : (per - 4) / 8 * 8 + 4;
}

// Whether a (lanes, per) names the case past 38,912 states: 16 blocks, PER
// past the cluster case's 76.
__host__ __device__ constexpr bool wide_case(int lanes, int per) {
  return lanes == 32 * kMaxCluster && per >= kWidePerMin && per <= kWidePerMax;
}

__device__ __forceinline__ float f32_neg_inf() { return -__int_as_float(0x7f800000); }

// Entries of one table type: one entry as a float (widening bf16 is exact:
// the bits become the high half), and four consecutive f32 entries (4g ..
// 4g + 3 of a lane's row).
template <typename T>
struct Entries;

template <>
struct Entries<float> {
  static __device__ __forceinline__ float at(const float* row, int j) { return row[j]; }
  static __device__ __forceinline__ float4 load4(const float* row, int g) {
    return reinterpret_cast<const float4*>(row)[g];
  }
};

template <>
struct Entries<uint16_t> {
  static __device__ __forceinline__ float at(const uint16_t* row, int j) {
    return __uint_as_float(static_cast<uint32_t>(row[j]) << 16);
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

// -- the C-block cluster (LANES = 32 * C) ------------------------------------------

// Bytes of what a warp exchanges with the warps of the same index in the
// cluster's other C - 1 blocks every step: two mbarriers (by step parity)
// that the others' stores complete, then by step parity C - 1 slots of an
// (E key, last state) pair, one a sending rank p in rank order (slot p - 1
// for p above the receiver's rank). Every block lays these out alike, so a
// warp's own link mapped to another rank is that rank's.
__host__ __device__ constexpr int link_bytes(int c) { return 16 + 16 * (c - 1); }

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
  // the case past 38,912 states: each lane's unstaged states, [P][20][C][(PER
  // - STAGED) / 4][32] float4 (ops/msv_cuda.py::lane_rows); else null
  const float4* low;
  // a row table launch: [b_pad] byte offsets of the rows in tokens, longest
  // first, and each row's column of scores; else null
  const long long* row_at;
  const int* dest;
  int* next_row;  // [P] the register cases' next unclaimed row of the table, or null
};

// Where a row's tokens start, and the column of scores its score goes to.
__device__ __forceinline__ const int8_t* row_tokens(const MsvArgs& a, int seq) {
  return a.tokens + (a.row_at != nullptr ? a.row_at[seq] : static_cast<long long>(seq) * a.l_pad);
}

__device__ __forceinline__ int row_dest(const MsvArgs& a, int seq) {
  return a.row_at != nullptr ? a.dest[seq] : seq;
}

// Dynamic shared memory of a block of `warps` warps, in bytes: the f32
// table of 32 * PER states a lane row (LANES = 32: the whole table; 32 * C:
// the block's slice; the case past 38,912: 32 * wide_staged(PER) states),
// and in a cluster each warp's link.
size_t msv_smem_bytes(int lanes, int per, int warps) {
  const int staged = wide_case(lanes, per) ? wide_staged(per) : per;
  return lanes == 32 ? sizeof(float) * 20 * 32 * per
                     : sizeof(float) * 20 * 32 * staged +
                           static_cast<size_t>(warps) * link_bytes(lanes / 32);
}

// The kernel's body: a lane's states j0 .. j0 + PER - 1, the last STAGED of
// them read from the block's shared table (STAGED = PER but past 38,912
// states), the first PER - STAGED from the lane-major copy (a.low).
template <int PER, bool CLUSTER, typename T, int WARPS, int STAGED>
__device__ __forceinline__ void msv_body(const MsvArgs& a) {
  static_assert(STAGED % 8 == 4, "STAGED = 8q + 4 keeps the table reads conflict-free");
  static_assert(STAGED <= PER && (PER - STAGED) % 4 == 0, "whole float4s from global memory");
  constexpr int kRow = 32 * STAGED;  // the shared row length
  constexpr int kGroups = PER / 4;
  constexpr int kLow = (PER - STAGED) / 4;  // a lane's first groups, from global memory
  const float neg_inf = f32_neg_inf();
  const int prof = blockIdx.y;
  const int m_pad = a.m_pad;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the cluster: the slice of the states (and of the table) this block
  // follows, and the cluster's blocks
  const int rank = CLUSTER ? static_cast<int>(cluster_rank()) : 0;
  const int nblk = CLUSTER ? static_cast<int>(cluster_size()) : 1;
  const int j0 = (rank * 32 + lane) * PER;
  const T* my_emit = static_cast<const T*>(a.emit) + static_cast<size_t>(prof) * 20 * m_pad;

  extern __shared__ float4 smem4[];
  float* table = reinterpret_cast<float*>(smem4);
  // widened to f32 here, once a block (exact for bf16: the bits become the
  // high half), so that the step reads f32 in both modes; a cluster's block
  // stages its slice of the columns (past 38,912 states each lane's last
  // STAGED)
  for (int i = threadIdx.x; i < 20 * kRow; i += blockDim.x) {
    const int r = i / kRow;
    int c = rank * kRow + i - r * kRow;
    if constexpr (kLow > 0) {
      const int l = (i - r * kRow) / STAGED;
      c = (rank * 32 + l) * PER + 4 * kLow + (i - r * kRow - l * STAGED);
    }
    table[i] = c < m_pad ? Entries<T>::at(my_emit + static_cast<size_t>(r) * m_pad, c) : neg_inf;
  }
  // this lane's first groups in the lane-major copy: group g of token aa at
  // my_low[aa * low_stride + 32 * g]
  [[maybe_unused]] const float4* my_low = nullptr;
  [[maybe_unused]] int low_stride = 0;
  if constexpr (kLow > 0) {
    low_stride = nblk * kLow * 32;
    my_low = a.low + (static_cast<size_t>(prof) * 20 * nblk + rank) * kLow * 32 + lane;
  }
  // the warp's link (link_bytes): its barriers, then its slots by parity
  [[maybe_unused]] unsigned char* link =
      reinterpret_cast<unsigned char*>(table + 20 * kRow) + warp * link_bytes(nblk);
  [[maybe_unused]] unsigned long long* bars = reinterpret_cast<unsigned long long*>(link);
  [[maybe_unused]] const int2* slots = reinterpret_cast<const int2*>(link + 16);
  // this lane's message a step: 2, (E key, last state) from lane 31 to rank
  // + 1; 1, the E key from lane p to rank p (p < C, not rank or rank + 1);
  // 0, none; into this block's slot of the receiver's link
  [[maybe_unused]] int msg = 0;
  [[maybe_unused]] unsigned dst_slot = 0, dst_bar = 0;
  if constexpr (CLUSTER) {
    if (lane == 0) {
      mbar_init(&bars[0]);
      mbar_init(&bars[1]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int dest = lane == 31 ? rank + 1 : lane;
    msg = lane == 31 ? (dest < nblk ? 2 : 0) : (dest < nblk && dest != rank && dest != rank + 1);
    if (msg != 0) {
      dst_slot = peer_addr(slots + (rank > dest ? rank - 1 : rank), dest);
      dst_bar = peer_addr(bars, dest);
    }
  }
  __syncthreads();
  // every block's barriers exist before anyone arrives on them
  if constexpr (CLUSTER) cluster_sync();
  const float tr_b_mk = a.tr_consts[3 * prof];
  const float tr_e_c = a.tr_consts[3 * prof + 1];
  const float tr_e_j = a.tr_consts[3 * prof + 2];
  const int b_pad = a.b_pad;
  const float* my_cols = table + lane * STAGED;
  // the step parity and each barrier's phase: both run on over every
  // sequence the warp follows
  [[maybe_unused]] int par = 0;
  [[maybe_unused]] unsigned phases = 0;

  // the units' warps at a time walk the batch: once for a grid that
  // covers it, a stride at a time for a persistent one; a cluster's blocks
  // (gridDim.x / C clusters a profile) follow the same sequences. Warp w of
  // unit u starts at sequence w * units + u, so the units' warps 0 take the
  // first sequences, one a unit (a row table's longest rows; see above)
  const int seqs = CLUSTER ? WARPS : blockDim.x / 32;
  const int first = CLUSTER ? static_cast<int>(cluster_id()) : static_cast<int>(blockIdx.x);
  const int units = CLUSTER ? static_cast<int>(cluster_count()) : static_cast<int>(gridDim.x);
  int seq = warp * units + first;
  while (seq < b_pad) {
    const float tr_loop = a.tr_rows[seq];
    const float tr_move = a.tr_rows[b_pad + seq];
    float m[PER];
    float st_j, st_c, st_n, st_b;
    // a cluster: block r's first state takes block r - 1's last one, which
    // the carry holds at first
    float bnd = neg_inf;
    if (a.m_in != nullptr) {
      const float* m_row_in = a.m_in + static_cast<size_t>(seq) * m_pad;
#pragma unroll
      for (int k = 0; k < PER; ++k) m[k] = j0 + k < m_pad ? m_row_in[j0 + k] : neg_inf;
      if constexpr (CLUSTER) {
        if (j0 > 0 && j0 - 1 < m_pad) bnd = m_row_in[j0 - 1];
      }
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

    const int n = min(max(a.lengths[seq], 0), a.l_pad);
    const int8_t* tok_row = row_tokens(a, seq);

    for (int t0 = 0; t0 < n; t0 += 32) {
      // clamped once, as a row offset: a token outside 0..19 is clamped like
      // an XLA gather; encoded residues are always inside
      const int mine = t0 + lane < n ? min(max(static_cast<int>(tok_row[t0 + lane]), 0), 19) * kRow
                                     : 0;
      const int count = min(32, n - t0);
      const int first_row = __shfl_sync(kFullMask, mine, 0);
      const float* row = my_cols + first_row;
      // the unstaged entries of the step under way (kLow > 0)
      [[maybe_unused]] float4 low[kLow > 0 ? kLow : 1];
      if constexpr (kLow > 0) {
        const float4* g = my_low + (first_row / kRow) * low_stride;
#pragma unroll
        for (int q = 0; q < kLow; ++q) low[q] = __ldg(g + 32 * q);
      }
      for (int i = 0; i < count; ++i) {
        const float bt = st_b + tr_b_mk;
        // the next step's row offset, now
        const int next = __shfl_sync(kFullMask, mine, i + 1);  // lane 32 is lane 0
        float prev = __shfl_up_sync(kFullMask, m[PER - 1], 1);
        if (lane == 0) prev = rank == 0 ? neg_inf : bnd;

        // in place, highest j first, so m[k - 1] still holds the old row
        // E in two chains: one max a cell, one to join them
        float e0 = neg_inf, e1 = neg_inf;
#pragma unroll
        for (int g = kGroups - 1; g >= 0; --g) {
          const float4 e =
              g >= kLow ? Entries<float>::load4(row, g - kLow) : low[g < kLow ? g : 0];
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
        if constexpr (kLow > 0) {
          // the next step's unstaged entries, in flight while the exchange
          // completes
          if (i + 1 < count) {
            const float4* g = my_low + (next / kRow) * low_stride;
#pragma unroll
            for (int q = 0; q < kLow; ++q) low[q] = __ldg(g + 32 * q);
          }
        }
        if constexpr (CLUSTER) {
          // this block's E (and its last state, to rank + 1) to the others,
          // theirs back
          const unsigned off = 8u * (nblk - 1) * par;
          if (msg == 2) {
            st_async2(dst_slot + off, key, __float_as_int(m[PER - 1]), dst_bar + 8u * par);
          } else if (msg == 1) {
            st_async(dst_slot + off, __int_as_float(key), dst_bar + 8u * par);
          }
          const unsigned bar = smem_addr(&bars[par]);
          if (lane == 0) mbar_expect(bar, 4 * (nblk - 1) + (rank > 0 ? 4 : 0));
          mbar_wait(bar, (phases >> par) & 1u);
          // after the acquire (a memory clobber)
          const int2* in = slots + (nblk - 1) * par;
          const int got = lane < nblk - 1 ? in[lane].x : INT_MIN;
          if (lane == 0 && rank > 0) bnd = __int_as_float(in[rank - 1].y);
          key = max(key, __reduce_max_sync(kFullMask, got));
          phases ^= 1u << par;
          par ^= 1;
        }
        row = my_cols + next;
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
    if (rank == 0 && lane == 0) {
      if (a.s_out != nullptr) {
        a.s_out[seq] = st_j;
        a.s_out[b_pad + seq] = st_c;
        a.s_out[2 * b_pad + seq] = st_n;
        a.s_out[3 * b_pad + seq] = st_b;
      }
      a.scores[static_cast<size_t>(prof) * b_pad + row_dest(a, seq)] = st_c + tr_move;
    }
    if constexpr (!CLUSTER) {
      if (a.next_row != nullptr) {
        int claimed = 0;
        if (lane == 0) claimed = atomicAdd(a.next_row + prof, 1);
        seq = units * seqs + __shfl_sync(kFullMask, claimed, 0);
        continue;
      }
    }
    seq += units * seqs;
  }
  // no block leaves while another of its cluster may still reach its shared
  // memory
  if constexpr (CLUSTER) cluster_sync();
}

template <int PER, bool CLUSTER, typename T, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 1) msv_kernel(const MsvArgs a) {
  msv_body<PER, CLUSTER, T, WARPS, PER>(a);
}

// Past 38,912 states: a block of kWideWarps warps of a 16-block cluster, each
// lane's first PER - wide_staged(PER) states read from global memory.
template <int PER, typename T>
__global__ void __launch_bounds__(32 * kWideWarps, 1) msv_wide_cluster_kernel(const MsvArgs a) {
  msv_body<PER, true, T, kWideWarps, wide_staged(PER)>(a);
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
    const int8_t* tok_row = row_tokens(a, seq);
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
      a.scores[static_cast<size_t>(prof) * b_pad + row_dest(a, seq)] = st_c + tr_move;
    }
    __syncthreads();  // the next sequence's row goes into these
  }
}

using KernelFn = void (*)(MsvArgs);

// The register cases' blocks: each is a kernel of its own, compiled under
// __launch_bounds__(32 * warps, 1) (ops/msv_cuda.py::WARP_CHOICES; the
// cluster case's block, kClusterWarps, is CLUSTER_WARPS).
template <int PER, bool CLUSTER, typename T>
KernelFn kernel_of(int warps) {
  if constexpr (CLUSTER) {
    return warps == kClusterWarps ? msv_kernel<PER, true, T, kClusterWarps> : nullptr;
  } else {
    switch (warps) {
      case 8: return msv_kernel<PER, false, T, 8>;
      case 12: return msv_kernel<PER, false, T, 12>;
      case 16: return msv_kernel<PER, false, T, 16>;
      case 20: return msv_kernel<PER, false, T, 20>;
      case 24: return msv_kernel<PER, false, T, 24>;
      case 28: return msv_kernel<PER, false, T, 28>;
      case 32: return msv_kernel<PER, false, T, 32>;
      default: return nullptr;
    }
  }
}

// The blocks of a cluster of the register case of `lanes` lanes (32 * C;
// the case past 38,912 states too, 32 * 16), or 0 for a lane count that
// names none (32: no cluster).
int cluster_of(int lanes) {
  return lanes % 32 == 0 && lanes >= 64 && lanes <= 32 * kMaxCluster ? lanes / 32 : 0;
}

// The kernel of a register case (32 lanes, or 32 * C in a cluster), or null
// for none.
KernelFn find_kernel(int lanes, int per, int warps, int bf16) {
#define MSV_CASE(P, C) \
  case P:              \
    return bf16 ? kernel_of<P, C, uint16_t>(warps) : kernel_of<P, C, float>(warps);
  if (lanes == 32) {
    switch (per) {
      MSV_CASE(4, false)
      MSV_CASE(12, false)
      MSV_CASE(20, false)
      MSV_CASE(28, false)
      MSV_CASE(36, false)
      MSV_CASE(44, false)
      MSV_CASE(52, false)
      MSV_CASE(60, false)
      MSV_CASE(68, false)
      MSV_CASE(76, false)
      default:
        break;
    }
  } else if (wide_case(lanes, per)) {
    if (warps != kWideWarps) return nullptr;
#define MSV_WIDE_CASE(P) \
  case P:                \
    return bf16 ? msv_wide_cluster_kernel<P, uint16_t> : msv_wide_cluster_kernel<P, float>;
    switch (per) {
      MSV_WIDE_CASE(80)
      MSV_WIDE_CASE(88)
      MSV_WIDE_CASE(96)
      MSV_WIDE_CASE(104)
      MSV_WIDE_CASE(112)
      MSV_WIDE_CASE(120)
      MSV_WIDE_CASE(128)
      default:
        break;
    }
#undef MSV_WIDE_CASE
  } else if (cluster_of(lanes) != 0) {
    switch (per) {
      MSV_CASE(44, true)
      MSV_CASE(52, true)
      MSV_CASE(60, true)
      MSV_CASE(68, true)
      MSV_CASE(76, true)
      default:
        break;
    }
  }
  return nullptr;
#undef MSV_CASE
}

// The launch of a cluster case's kernel: `grid` blocks a profile (a
// multiple of c), c a cluster along x.
cudaLaunchConfig_t cluster_config(int grid, int num_p, int c, int warps, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, num_p);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's shared-memory limit and, for a cluster past 8 blocks, its
// leave to take a non-portable cluster size.
cudaError_t prepare(KernelFn fn, size_t smem, int c) {
  const void* kernel = reinterpret_cast<const void*>(fn);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && c > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

}  // namespace

// Plain C entry point, bound with ctypes. `lanes` (32: one warp a sequence;
// 32 * C, 2 <= C <= 16: a warp in each block of a C-block cluster;
// kMemLanes: the rows-in-memory case) and `per`, the number of M states each
// lane holds (tiles of kMemLanes states in the last case), name the kernel
// case: per 4, 12, ..., 76 at 32 lanes and 44, ..., 76 in a cluster (the
// Python wrapper's KERNEL_PER, WIDE_PER), 80, 88, ..., 128 at 32 * 16 lanes
// (the case past 38,912 states, WIDE_CLUSTER_PER), any at kMemLanes, with
// lanes * per >= m_pad (a multiple of 8 in a cluster, the packers'
// convention). `warps` warps a block and `grid` blocks a profile are the
// launch plan of ops/msv_cuda.py::launch_plan: at 32 lanes one of 8, 12,
// ..., 32 (each its own compiled kernel), in a cluster kClusterWarps (past
// 38,912 states kWideWarps) and a grid that is a multiple of C, launched as
// clusters of C blocks along x (cudaLaunchKernelEx); a refused cluster
// launch returns its error. A grid smaller than the batch needs makes the
// warps walk it with a stride. At kMemLanes the block is kMemLanes threads
// (`warps` is not read) and `scratch` holds [num_p, grid, 2, m_pad] floats;
// past 38,912 states `scratch` is the lane-major copy of each lane's
// unstaged states (ops/msv_cuda.py::lane_rows). `bf16` selects the
// filter's bf16 table (16-bit entries) over f32; `num_p` profiles are
// stacked in emit [num_p, 20, m_pad] and tr_consts [num_p, 3], and scores is
// [num_p, b_pad]. A null m_in starts from the row-0 carry (s_in is then not
// read); a null m_out or s_out skips that carry's store. A non-null row_at
// makes it a row table launch (see the head of this file): `tokens` is the
// buffer the b_pad offsets of row_at point into, lengths and tr_rows are in
// the table's order, each row's score goes to column dest[r], `l_pad` is at
// least every length, and no carry goes in or out; `next_row` ([num_p]
// zeroed ints) is the register cases' counter of claimed rows, null
// otherwise. Returns a cudaError_t.
extern "C" int msv_scan_launch(int device, int lanes, int per, int warps, int bf16, int num_p,
                               const void* emit, int m_pad,
                               const void* tokens, int l_pad,
                               const void* lengths, const void* tr_rows,
                               const void* tr_consts, const void* m_in,
                               const void* s_in, void* scores, void* m_out,
                               void* s_out, int b_pad, int grid, void* scratch,
                               const void* row_at, const void* dest, void* next_row,
                               void* stream) {
  const bool mem = lanes == kMemLanes;
  const bool wide = wide_case(lanes, per);
  const int c = cluster_of(lanes);
  const KernelFn fn = mem ? nullptr : find_kernel(lanes, per, warps, bf16);
  const bool table = row_at != nullptr;
  if ((!mem && fn == nullptr) || ((mem || wide) && scratch == nullptr) || grid < 1 || m_pad < 1 ||
      static_cast<long>(lanes) * per < m_pad || (c != 0 && (m_pad % 8 != 0 || grid % c != 0)) ||
      num_p < 1 || num_p > 65535 ||
      (table && (dest == nullptr || m_in != nullptr || m_out != nullptr || s_out != nullptr)) ||
      (next_row != nullptr && (!table || lanes != 32))) {
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
  a.low = wide ? static_cast<const float4*>(scratch) : nullptr;
  a.row_at = static_cast<const long long*>(row_at);
  a.dest = static_cast<const int*>(dest);
  a.next_row = static_cast<int*>(next_row);
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
  const size_t smem = msv_smem_bytes(lanes, per, warps);
  err = prepare(fn, smem, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c != 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(grid, num_p, c, warps, smem, st, &attr);
    err = cudaLaunchKernelEx(&cfg, fn, a);
  } else {
    void* args[] = {&a};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(grid, num_p), dim3(warps * 32),
                           args, smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and local-memory (spill) bytes a thread of a register
// case's kernel (`lanes` 32 or 32 * C, `per`, `warps`, `bf16` as for
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

// The most C-block clusters of the cluster case `lanes` = 32 * C (`per`,
// `warps`, `bf16` as for msv_scan_launch) the card `device` runs at once
// (cudaOccupancyMaxActiveClusters; 0 when it cannot hold one), for the
// launch plan's persistent grid. Returns a cudaError_t.
extern "C" int msv_max_clusters(int device, int lanes, int per, int warps, int bf16,
                                int* clusters) {
  const int c = cluster_of(lanes);
  const KernelFn fn = c != 0 ? find_kernel(lanes, per, warps, bf16) : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = msv_smem_bytes(lanes, per, warps);
  err = prepare(fn, smem, c);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(c, 1, c, warps, smem, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, fn, &cfg));
}

extern "C" const char* msv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
