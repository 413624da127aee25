// Device helpers shared by the LSTM kernels (lstm_recurrence.cu,
// lstm_backward.cu, lstm_int8.cu): the gate nonlinearity, ldmatrix and
// mma.sync m16n8k16 (bf16 in, f32 accumulation), the grid barrier of a
// persistent cooperative launch and its co-residency check; the per-CTA
// ready flags, the cluster barrier and distributed shared memory loads of
// the clustered launches, and their launch; the quad and pair exchanges of
// gates and cells, and wgmma's fences and operand descriptors.  The
// cp.async staging, the mbarriers and the bulk copies (TMA) are in
// async_copy.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace xna {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
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

// Per-CTA ready flags, in place of a grid barrier.  Each warp of a CTA of a
// recursion adds one to the CTA's flag when its stores of a step are done,
// so the flag counts steps x warps; a consumer waits only for the producers
// of the slice it reads.
__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The warp's stores of the step, then one release add: __syncwarp orders
// every lane's stores before lane 0's release, which makes them visible at
// the GPU scope before the count.  No block-wide barrier and no separate
// fence.
__device__ __forceinline__ void publish(unsigned int* flag) {
  __syncwarp();
  if (threadIdx.x % 32 == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(flag) : "memory");
}

// Wait until the flags [0, n) all count `steps` steps of every warp; the
// warp's lanes poll them in parallel (one L2 round trip per poll, not one
// per flag).  The caller's cp.async.cg loads that follow read through L2,
// where the producers' released stores are.
__device__ __forceinline__ void wait_flags(const unsigned int* flags, int n,
                                           unsigned int steps) {
  const int lane = threadIdx.x % 32;
  const unsigned int target = steps * (blockDim.x / 32);
  bool ready;
  do {
    ready = true;
    for (int i = lane; i < n; i += 32)
      ready = ready && ld_acquire(flags + i) >= target;
  } while (!__all_sync(0xffffffffu, ready));
}

// The step's stores of the `threads` threads of named barrier 1, then one
// release add by thread 0: the barrier orders every thread's stores before
// it, the release makes them visible at the GPU scope before the count.
__device__ __forceinline__ void publish_cta(unsigned int* flag, int threads) {
  asm volatile("bar.sync 1, %0;" :: "r"(threads) : "memory");
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(flag) : "memory");
}

// One poll of the flags [0, n) (n <= 64), the warp's lanes in parallel:
// bit c of the result is set when the `per` flags [c per, (c + 1) per)
// (the writers of chunk c; fewer at the end) all count `target`.  The
// loads are relaxed (no cache invalidation each); when a chunk is ready,
// one acquire fence orders the reads that follow after its writers.
__device__ __forceinline__ unsigned long long ready_chunks(
    const unsigned int* flags, int n, int per, unsigned int target) {
  const int lane = threadIdx.x % 32;
  unsigned long long done = 0;
  for (int g = 0; g < n; g += 32) {
    const int i = g + lane;
    unsigned int v = target;
    if (i < n)
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(flags + i) : "memory");
    done |= (unsigned long long)__ballot_sync(0xffffffffu, v >= target) << g;
  }
  unsigned long long chunks = 0;
  const unsigned long long one = (1ull << per) - 1;
  for (int c = 0; c * per < n; ++c)
    if (((done >> (c * per)) & one) == one) chunks |= 1ull << c;
  if (chunks) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  __syncwarp();   // every lane's fence now orders every lane's reads
  return chunks;
}

// Lanes q and q ^ 1 of a quad hold the values of units 2 j + (q & 1), j =
// 0..3, of one row: returns in out[0..3] those of units 4 (q & 1) + 0..3,
// so that each lane stores 4 consecutive units.
__device__ __forceinline__ void pair_units(const float (&v)[4],
                                           float (&out)[4]) {
  const int e = threadIdx.x & 1;
  const float r0 = __shfl_xor_sync(0xffffffffu, e ? v[0] : v[2], 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, e ? v[1] : v[3], 1);
  out[0] = e ? r0 : v[0];
  out[1] = e ? v[2] : r0;
  out[2] = e ? r1 : v[1];
  out[3] = e ? v[3] : r1;
}

// The accumulator of an m16n8 product whose 8 columns are 2 units x 4 gates
// (column 2 gate + e, unit e): lane q of a quad holds gate q of the four
// cells (e, row half) = d 0..3 (rows lane/4 and lane/4 + 8).  Returns in
// g[0..3] the four gates of cell d = q, by three rotations in the quad.
__device__ __forceinline__ void quad_transpose(const float (&v)[4],
                                               float (&g)[4]) {
  const int q = threadIdx.x % 4;
  float got[4];
  got[0] = q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    // lane q reads v[q] of lane (q + r) % 4, which sends v[(own - r) % 4]
    const int i = (q - r) & 3;
    const float send = i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
    got[r] = __shfl_sync(0xffffffffu, send, (threadIdx.x & ~3) | ((q + r) & 3));
  }
  // gate k came in round (k - q) % 4
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = (k - q) & 3;
    g[k] = r == 0 ? got[0] : r == 1 ? got[1] : r == 2 ? got[2] : got[3];
  }
}

// wgmma (warpgroup products on shared-memory operands): its fences, and
// the descriptor of an operand tile.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(kPending) : "memory");
}
// Keeps the compiler from moving accesses of the accumulator across the
// asynchronous products.
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// Descriptor of a K-major operand in shared memory with the 128-byte
// swizzle (rows of 64 bf16, groups of 8 rows 1024 bytes apart; the group
// 1024-byte aligned), starting at `p`: the k offset is added to the start
// address, the swizzle is applied by the hardware.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Thread block clusters: the CTA's rank, a barrier over the cluster (with
// release/acquire order on shared memory), and loads from a neighbour's
// shared memory (distributed shared memory).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address of `p` (this CTA's shared memory) in CTA `rank`'s copy.
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
// The float2 at `p` (this CTA's shared memory) in CTA `rank`'s copy.
__device__ __forceinline__ float2 ld_cluster_f2(const float* p, unsigned rank) {
  const unsigned a = cluster_addr(p, rank);
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}

// The float at `p` (this CTA's shared memory) in CTA `rank`'s copy.
__device__ __forceinline__ float ld_cluster_f32(const float* p,
                                               unsigned rank) {
  const unsigned a = cluster_addr(p, rank);
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(a) : "memory");
  return v;
}

// Launch `ctas` CTAs of `fn` in clusters of `cluster`, all of which must be
// resident at once (they wait on each other's flags): checked first with
// cudaOccupancyMaxActiveClusters; with `args` null, only checked.  0, -3
// (shared-memory request refused), -1 (the grid cannot be co-resident),
// or a cudaError_t.
inline int launch_clusters(const void* fn, int ctas, int cluster, int threads,
                           size_t smem, void** args, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear the refusal
    return -3;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&active, fn, &cfg)) != cudaSuccess)
    return e;
  if (active * cluster < ctas) return -1;
  if (!args) return 0;
  cfg.numAttrs = 2;     // and cooperative: the grid is resident as a whole
  if ((e = cudaLaunchKernelExC(&cfg, fn, args)) != cudaSuccess) return e;
  return cudaGetLastError();
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
