// Asynchronous copies into shared memory, shared by the LSTM kernels
// (through lstm_common.cuh), the CRF scans (crf_ring.cuh) and the
// traceback K2c (crf_decode.cu): cp.async of 8 or 16 bytes a thread,
// waited by commit groups; mbarriers (also those of another CTA of a
// cluster); the bulk copy (TMA without a tensor map) that completes on
// one; and the stores into another CTA of a cluster (st.async) that
// complete on the mbarrier there.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace xna {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global (through L2 only) into shared memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}
// The same, reading `bytes` (0 or 16) and filling the rest with zeros.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}
// 8 bytes from global into shared memory, through L1; both addresses
// 8-byte aligned.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}

// mbarriers in shared memory and the bulk copy (TMA without a tensor map)
// that completes on one: a ring stage is "full" when its bytes have landed
// and "empty" when its consumers have arrived.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// The same with acquire order at the cluster's scope: what another CTA of
// the cluster did before its release arrive (or its st_async16) on `bar`.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// Arrive, with release order at the cluster's scope, on the mbarrier at
// `bar`, an address in another CTA of the cluster (cluster_addr).
__device__ __forceinline__ void mbar_arrive_remote(unsigned bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
      :: "r"(bar) : "memory");
}
// 16 bytes into another CTA of the cluster's shared memory at `dst`,
// completing 16 bytes of the transaction of its mbarrier at `bar` (both
// addresses in that CTA: cluster_addr).
__device__ __forceinline__ void st_async16(unsigned dst, float4 v,
                                           unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :: "r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
// Arrive on `bar`, announcing `bytes` more bytes for its current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// `bytes` (a multiple of 16) from global `src` into shared `dst`, both
// 16-byte aligned, completing on `bar` (armed by mbar_expect_tx), for data
// that earlier kernels wrote.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// bulk_load of data that other CTAs of this kernel wrote: the
// generic-proxy stores that the caller acquired (through a ready flag) are
// ordered before this async-proxy read by the proxy fence.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.global;" ::: "memory");
  bulk_load(dst, src, bytes, bar);
}

}  // namespace xna
