// Device helpers shared by the LSTM kernels (lstm_recurrence.cu,
// lstm_backward.cu): the gate nonlinearity, cp.async staging, ldmatrix and
// mma.sync m16n8k16 (bf16 in, f32 accumulation), the grid barrier of a
// persistent cooperative launch, and its co-residency check.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace xna {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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

// A operand of mma m16n8k16: the 16 x 16 tile at `a` (row-major, ld
// elements), one row address per lane.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* a,
                                       int ld) {
  const int lane = threadIdx.x % 32;
  const unsigned p = smem_addr(a + (lane % 16) * ld + (lane / 16) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(p));
}

// B operands of two m16n8k16 products: the 16 (k) x 16 (n) tile at `b`,
// stored k-major (row-major [k][n], ld elements), transposed on the way:
// r[0..1] for columns 0-7, r[2..3] for columns 8-15.
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* b,
                                       int ld) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  const unsigned p = smem_addr(b + ((m % 2) * 8 + lane % 8) * ld + (m / 2) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(p));
}

// The same operands from a tile stored n-major (row-major [n][k], ld
// elements), which is already the layout mma wants: no transpose.
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* b,
                                          int ld) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  const unsigned p = smem_addr(b + ((m / 2) * 8 + lane % 8) * ld + (m % 2) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(p));
}

// d += a @ b on one 16 x 8 tile, bf16 operands, f32 accumulation.  The
// accumulator holds rows lane/4 (d[0], d[1]) and lane/4 + 8 (d[2], d[3]),
// columns 2 (lane % 4) and the next.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Monotonic grid barrier: every block adds one, then waits until the
// counter reaches `target` (= steps done * gridDim.x).  Valid only when all
// blocks are co-resident, which the cooperative launch guarantees.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// 0 when `blocks` blocks of `fn` (`threads` threads, `smem` bytes) can all
// be resident; -3 when the shared-memory request is refused, -1 when they
// cannot; otherwise a cudaError_t.
inline int co_resident(const void* fn, size_t smem, int blocks, int threads) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear the refusal
    return -3;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess) return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, threads, smem)) != cudaSuccess) return e;
  return per_sm * sms < blocks ? -1 : 0;
}

}  // namespace xna
