// Device helpers shared by the CRF kernels of crf_decode.cu (K2a/b/c) and
// crf_loss.cu (K4, K5b): the shapes they take (one block per sequence, one
// thread per state), lse, and K2b's staging of a score row through
// registers into shared memory (K2a and K4 read theirs from the ring of
// crf_ring.cuh).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // >= n_state
constexpr int kMaxCols = 8;     // n_base + 1
constexpr int kPerThread = 8;   // score row length <= kThreads * kPerThread

__device__ __forceinline__ void prefetch_row(const float* row, int C,
                                             float* regs) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    regs[r] = idx < C ? row[idx] : 0.0f;
  }
}

__device__ __forceinline__ void commit_row(float* row_s, int C,
                                           const float* regs) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int idx = threadIdx.x + r * kThreads;
    if (idx < C) row_s[idx] = regs[r];
  }
}

// log(sum(exp(x))) as max + log(sum(exp(x - max))), summed in order
__device__ __forceinline__ float lse(const float* x, int n) {
  float m = x[0];
  for (int k = 1; k < n; ++k) m = fmaxf(m, x[k]);
  float s = 0.0f;
  for (int k = 0; k < n; ++k) s += expf(x[k] - m);
  return m + logf(s);
}

// The shapes the score-row kernels take: n_state a multiple of n_base,
// one thread per state, the row in kThreads * kPerThread registers.
bool supported(int T, int N, int nb, int ns) {
  return T >= 1 && N >= 1 && nb >= 1 && nb + 1 <= kMaxCols && ns >= nb &&
         ns <= kThreads && ns % nb == 0 &&
         ns * (nb + 1) <= kThreads * kPerThread;
}

}  // namespace
