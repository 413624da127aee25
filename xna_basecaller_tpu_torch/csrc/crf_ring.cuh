// The row ring of the CRF's log-semiring scans: the backward scan K2a/K5a
// and the forward-Viterbi pass K2b (crf_backward_kernel,
// crf_fwd_viterbi_kernel, crf_decode.cu), the forward scan K4
// (crf_forward_kernel, crf_loss.cu) and the stay/move lattice's scans K6a
// and K6b (lattice_forward_kernel, lattice_backward_kernel, crf_loss.cu).
//
// A scan runs one block per sequence, and each of its T dependent steps
// reads one span of rows from device memory and nothing else: a score row
// scores[t, n, :] for K2a and K4 (C = n_state * (n_base + 1) f32: 6048 B
// for the flagship); for K2b the score row and, on the bulk route where
// n_state is a multiple of 4, the row beta_{t+1} after it (6912 B); for
// the lattice, the step's stay and move rows, packed side by side (2 *
// npad f32, npad = n rounded up to 4: 3584 B at n=448), and for K6b the
// alphas row after them (3 * npad f32: 5376 B).  The ring
// keeps the spans of the next D - 1 steps in flight into D stages of shared
// memory, so that once it is full a step waits for no device-memory
// latency, and the step reads its span straight from its stage (no staging
// through registers).  The stage of step s is refilled at the top of step
// s + 1 with the span of step s + D: the __syncthreads that ends step s has
// shown that every thread is done with it.
//
// The route a span takes into its stage (ring_route, by its alignment):
//   kBulk  the block's last thread issues one bulk copy (TMA) for each row
//          of the span, all completing on the stage's one mbarrier, which
//          expects their summed bytes; the step waits for that barrier's
//          phase.  Rows 16-byte aligned and multiples of 16 bytes.  The
//          scans launch that thread where it has no state of its own to
//          update (216 states of 256 threads; the lattice adds a warp to
//          its n <= 480 positions), so the copies stay off the step's chain.
//   8      every thread issues cp.async of 8 bytes for its part of the row
//          (one row a span) and commits one group a step (an empty one past
//          the end); before the barrier that ends step s, each thread waits
//          for its own copies of step s + 1's row, and the barrier shows
//          them to the others.  A 5-letter model's score rows (125 states x
//          6 = 750 f32 = 3000 B) take it.
// A score row is n_state * (n_base + 1) floats, an even number for every
// alphabet, so rows are 8-byte aligned wherever the scores start 8-byte
// aligned; the wrappers copy scores that do not (ops/crf_cuda.py).  The
// lattice's rows are packed by its wrappers to take the bulk route.
// cp.async of 16 bytes a thread was slower than the bulk copy, or within
// 1.3 % of it, and depths 4 and 16 within 2.2 % of 8 (PERF.md §6).
// The depth D is 8 (kRingStages), except where 8 stages and the scan's two
// rows of state do not fit in a block's 227 KB of shared memory: the
// lattice's span grows with n, so K6a takes 8 stages up to n = 3224, 4 up
// to 5808 and 2 up to its limit of 6144, K6b 8 up to 2232, 4 up to 4148,
// then 2 (lattice_depth, crf_loss.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "crf_common.cuh"

namespace {

constexpr int kBulk = 0;        // the route of one bulk copy a row
constexpr int kRingStages = 8;  // D

// Floats a stage takes: the row, rounded up to 16 bytes.
__host__ __device__ inline int ring_stride(int C) { return (C + 3) & ~3; }

__host__ __device__ inline int ring_bar_bytes(int D) {
  return (D * 8 + 15) / 16 * 16;
}

// Dynamic shared memory of a ring of D stages of C floats.
inline size_t ring_bytes(int C, int D = kRingStages) {
  return ring_bar_bytes(D) + (size_t)D * ring_stride(C) * 4;
}

// The widest route the rows of `scores` (C floats each) can take, or -1
// where they are not 8-byte aligned.
inline int ring_route(const void* scores, int C) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(scores);
  if (p % 16 == 0 && C % 4 == 0) return kBulk;
  if (p % 8 == 0 && C % 2 == 0) return 8;
  return -1;
}

// One row of a span: `floats` f32 at `src` in device memory.
struct Row {
  const float* src;
  int floats;
};

template <int R, int D = kRingStages>
struct RowRing {
  static_assert(R == kBulk || R == 8, "a route of ring_route");
  static_assert(D >= 2 && (D & (D - 1)) == 0, "D: a power of two");
  uint64_t* full;   // [D] mbarriers (bulk route)
  float* stage;     // [D][stride]
  int C, stride;    // floats of a span, and of a stage

  __device__ RowRing(unsigned char* smem, int C_)
      : full(reinterpret_cast<uint64_t*>(smem)),
        stage(reinterpret_cast<float*>(smem + ring_bar_bytes(D))),
        C(C_), stride(ring_stride(C_)) {}

  // The shared memory after the ring, 16-byte aligned.
  __device__ float* end() const { return stage + D * stride; }

  // Before the block's first barrier.
  __device__ void init() {
    if constexpr (R == kBulk) {
      if (threadIdx.x == 0) {
        for (int i = 0; i < D; ++i) xna::mbar_init(full + i, 1);
        xna::mbar_init_fence();
      }
    }
  }

  // Start copying the span of step s, its rows one after another (their
  // floats summing to C), into its stage.  The cp.async route takes one
  // row a span.
  template <class... Rows>
  __device__ void fetch(int s, Rows... rows) {
    float* dst = stage + (s % D) * stride;
    if constexpr (R == kBulk) {
      if (threadIdx.x == blockDim.x - 1) {
        uint64_t* bar = full + s % D;
        xna::mbar_expect_tx(bar, C * 4);
        ((xna::bulk_load(dst, rows.src, rows.floats * 4, bar),
          dst += rows.floats), ...);
      }
    } else {
      static_assert(sizeof...(Rows) == 1, "cp.async: one row a span");
      const Row row{rows...};
      char* d = reinterpret_cast<char*>(dst);
      const char* g = reinterpret_cast<const char*>(row.src);
      for (int i = threadIdx.x; i < row.floats / 2; i += blockDim.x)
        xna::cp_async8(d + i * 8, g + i * 8);
      xna::cp_async_commit();
    }
  }

  // No row for step s (past the end): an empty group keeps the count.
  __device__ void skip() {
    if constexpr (R != kBulk) xna::cp_async_commit();
  }

  // Before the barrier that ends a step (or precedes step 0): this
  // thread's copies of the next step's row have landed.  D - 1 groups are
  // committed ahead of step 0 and one a step.
  __device__ void land_next() {
    if constexpr (R != kBulk) xna::cp_async_wait<D - 2>();
  }

  // The row of step s, once it has landed.
  __device__ const float* row(int s) {
    if constexpr (R == kBulk) xna::mbar_wait(full + s % D, (s / D) & 1);
    return stage + (s % D) * stride;
  }
};

// lse(x, n) of crf_common.cuh for n <= K, bit for bit, with the n exp()s
// independent of each other: the terms past n repeat x[0], which moves
// neither the max (taken as a tree: fmaxf is exact) nor the sum, to which
// they add 0.  (Guarding each term by k < n made the compiler branch
// around each expf, so that they ran one after another.)
template <int K>
__device__ __forceinline__ float lse_n(const float (&x)[K], int n) {
  float y[K];
#pragma unroll
  for (int k = 0; k < K; ++k) y[k] = k < n ? x[k] : x[0];
  float t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = y[k];
#pragma unroll
  for (int w = 1; w < K; w *= 2)
#pragma unroll
    for (int k = 0; k + w < K; k += 2 * w) t[k] = fmaxf(t[k], t[k + w]);
  const float m = t[0];
  float e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = expf(y[k] - m);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) s += k < n ? e[k] : 0.0f;
  return m + logf(s);
}

template <int V>
using IntC = std::integral_constant<int, V>;

// Call f(IntC<NB>) with NB = n_base as a compile-time constant for the
// alphabets of the repo's models (4, 5 or 6 bases: NACGT, NACGTX,
// NACGTXY), so that the scans' loops over the columns unroll exactly, with
// no guard per column; NB = 0 for any other, which the kernels read at run
// time.
template <class F>
int nb_dispatch(int nb, F&& f) {
  switch (nb) {
    case 4: return f(IntC<4>{});
    case 5: return f(IntC<5>{});
    case 6: return f(IntC<6>{});
  }
  return f(IntC<0>{});
}

// Call f(IntC<route>, IntC<NB>) for a route of ring_route.
template <class F>
int ring_dispatch(int route, int nb, F&& f) {
  return nb_dispatch(nb, [&](auto b) {
    if (route == kBulk) return f(IntC<kBulk>{}, b);
    return f(IntC<8>{}, b);
  });
}

// One block of `threads` per sequence; the ring may take more than 48 KB.
template <class... Params, class... Args>
int ring_launch(void (*kernel)(Params...), int N, int threads, size_t smem,
                void* stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace
