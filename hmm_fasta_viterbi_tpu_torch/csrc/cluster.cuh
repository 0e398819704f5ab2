// Thread-block cluster primitives (sm_90) shared by the C-block clusters of
// the MSV kernel (msv_kernel.cu) and the cluster pairs of the blocked p7
// kernels (p7_blocked.cuh): the block's place in its cluster, the cluster's barrier,
// addresses in another block's shared memory (distributed shared memory,
// mapa), and mbarriers whose phases complete when asynchronous stores from
// another block (st.async) have landed. A st.async signals only its own
// bytes; a release at cluster scope fences all of the thread's memory
// operations, and on the H100 that cost about as much as a DP step of the
// kernels (PERF.md), so the pairs exchange their data by st.async.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// This block's rank in its cluster.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The blocks of this block's cluster.
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// The cluster's index in the grid (x) and the grid's clusters (x).
__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// Every thread of the cluster, with release / acquire at cluster scope.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`, whose shared memory is laid out alike.
__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// An mbarrier of this block whose phases complete on one arrival.
__device__ __forceinline__ void mbar_init(const void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// The arrival on this block's mbarrier `addr`, expecting `bytes` of stores.
__device__ __forceinline__ void mbar_expect(unsigned addr, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(addr), "r"(bytes)
               : "memory");
}

// Wait until this block's mbarrier `addr` completes the phase of `parity`
// (acquire at cluster scope: the stores it counted are visible).
__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 4 bytes into [addr] of a block of the cluster, completing 4 bytes of the
// transaction of that block's mbarrier `bar`.
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr),
               "r"(__float_as_int(v)), "r"(bar)
               : "memory");
}

// The same for 8 bytes (8-byte aligned).
__device__ __forceinline__ void st_async2(unsigned addr, int a, int b, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];" ::"r"(
          addr),
      "r"(a), "r"(b), "r"(bar)
      : "memory");
}

}  // namespace
