// Device helpers shared by the CRF kernels of crf_decode.cu (K2a/b/c) and
// crf_loss.cu (K4, K5b): the shapes they take (one block per sequence, one
// thread per state) and lse.  The scans read their score rows from the
// ring of crf_ring.cuh.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // >= n_state
constexpr int kMaxCols = 8;     // n_base + 1
constexpr int kMaxRow = 2048;   // floats of a score row, n_state * (n_base + 1)

// log(sum(exp(x))) as max + log(sum(exp(x - max))), summed in order
__device__ __forceinline__ float lse(const float* x, int n) {
  float m = x[0];
  for (int k = 1; k < n; ++k) m = fmaxf(m, x[k]);
  float s = 0.0f;
  for (int k = 0; k < n; ++k) s += expf(x[k] - m);
  return m + logf(s);
}

// The shapes the score-row kernels take: n_state a multiple of n_base,
// one thread per state, at most kMaxCols columns and kMaxRow floats a row.
bool supported(int T, int N, int nb, int ns) {
  return T >= 1 && N >= 1 && nb >= 1 && nb + 1 <= kMaxCols && ns >= nb &&
         ns <= kThreads && ns % nb == 0 && ns * (nb + 1) <= kMaxRow;
}

}  // namespace
