// K2a, K2b, K2c: the CRF decode chain (Viterbi over log edge posteriors),
// for Hopper.
//
// Replace the three kernels of
// xna_basecaller_tpu/ops/crf_pallas.py::_decode_paths_impl:
//   K2a crf_backward_kernel    <- _bwd_kernel_unrolled (backward log scan)
//   K2b crf_fwd_viterbi_kernel <- _fwd_viterbi_kernel  (alpha + Viterbi)
//   K2c crf_traceback_kernel   <- _traceback_kernel    (reverse traceback)
// with the per-step op order of ops/crf.py::decode_paths (crf.py:331-341):
// edge = alpha[pred] + score + beta_{t+1} - logZ, then log(exp(edge) + 1e-8)
// in f32 (expf/logf, no fast math), then a max-plus step whose argmax takes
// the first maximum (stay column, lowest state), as jnp.argmax does.
//
// Scores are read in their natural layout [T, N, n_state, n_base + 1]
// (the JAX side transposes them only for a Mosaic layout limit).  States:
// n_state = n_base ** state_len, nsd = n_state / n_base; the predecessor of
// state j through dropped base i is i * nsd + j / n_base.
//
// Bound on the card (flagship: T=720, N=256, 216 states x 7 columns, f32):
// K2a and K2b each must read the 1.11 GB score tensor once, 0.33 ms at
// 3.35 TB/s; K2a writes the betas (159 MB) that K2b reads again; the
// arithmetic is ~100 flops per state and step (under 0.1 ms at 67 TFLOP/s
// f32).  Both are bound by bytes, and by the 720 dependent steps of each
// sequence.  K2c moves only the bytes its paths touch.
//
// Design: one block per sequence (N blocks), one thread per state.  The
// recurrent vectors (beta; alpha and the Viterbi scores) live in shared
// memory, double buffered so one __syncthreads separates the steps.  K2a
// reads each step's 6 KB score row straight from a ring of D stages in
// shared memory that bulk copies (or cp.async, for rows that are not
// 16-byte multiples) keep D - 1 rows ahead (crf_ring.cuh), so that a step
// waits for no device-memory latency; K2b reads its row coalesced into
// shared memory, prefetching the next one into registers while the
// current step computes.
// Backpointers (0..n_base) are stored as uint8 [T, N, n_state]: 40 MB
// instead of the 159 MB of int32.  K2c walks one sequence per thread.

#include <cuda_runtime.h>

#include <cstdint>

#include "crf_common.cuh"
#include "crf_ring.cuh"

namespace {

// K2a: betas [T+1, N, ns] with betas[t] = beta_t and betas[T] = 0.
//   beta_t[k] = lse(stay: Ms[t,k,0] + beta_{t+1}[k],
//                   move: lse_b(Ms[t, m*nb+b, 1+i] + beta_{t+1}[m*nb+b]))
// with k = i*nsd + m (crf.py::_bwd_step).  Step s reads the row of t =
// T-1-s from the ring (crf_ring.cuh) of D stages, by route R; n_base is NB,
// or nb_arg when NB is 0.
template <int R, int NB>
__global__ void __launch_bounds__(kThreads)
crf_backward_kernel(const float* __restrict__ scores,
                    float* __restrict__ betas, int T, int N, int nb_arg,
                    int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = NB ? NB : nb_arg;
  const int nb1 = nb + 1, C = ns * nb1, nsd = ns / nb;
  RowRing<R> ring(smem, C);
  constexpr int D = kRingStages;
  float* beta_s = ring.end();    // [2][ns]
  const int n = blockIdx.x, j = threadIdx.x;
  const int i = j / nsd, m = j % nsd;   // outside the loop, or it is redone
  const size_t row_stride = (size_t)N * C;
  const float* last = scores + ((size_t)(T - 1) * N + n) * C;

  ring.init();
  if (j < ns) {
    beta_s[j] = 0.0f;
    betas[((size_t)T * N + n) * ns + j] = 0.0f;
  }
  __syncthreads();
  for (int s = 0; s < D - 1; ++s) {
    if (s < T)
      ring.fetch(s, Row{last - s * row_stride, C});
    else
      ring.skip();
  }
  ring.land_next();
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s, cur = s & 1;
    if (s + D - 1 < T)
      ring.fetch(s + D - 1, Row{last - (s + D - 1) * row_stride, C});
    else
      ring.skip();
    const float* ms = ring.row(s);
    if (j < ns) {
      const float* beta = beta_s + cur * ns;
      float vals[kMaxCols];
#pragma unroll
      for (int b = 0; b < kMaxCols; ++b)
        if (b < nb)
          vals[b] = ms[(m * nb + b) * nb1 + 1 + i] + beta[m * nb + b];
      float pair[2];
      pair[0] = ms[j * nb1] + beta[j];
      pair[1] = lse_n(vals, nb);
      const float out = lse_n(pair, 2);
      beta_s[(cur ^ 1) * ns + j] = out;
      betas[((size_t)t * N + n) * ns + j] = out;
    }
    ring.land_next();
    __syncthreads();
  }
}

// K2b: the forward scan fused with Viterbi over the log edge posteriors.
// bp [T, N, ns] uint8 (the argmax column k), v_final [N, ns].
__global__ void __launch_bounds__(kThreads)
crf_fwd_viterbi_kernel(const float* __restrict__ scores,
                       const float* __restrict__ betas,
                       const float* __restrict__ logz,
                       uint8_t* __restrict__ bp, float* __restrict__ v_final,
                       int T, int N, int nb, int ns) {
  extern __shared__ float sm[];
  const int nb1 = nb + 1, C = ns * nb1, nsd = ns / nb;
  float* ms_s = sm;                  // [2][C]
  float* alpha_s = sm + 2 * C;       // [2][ns]
  float* v_s = alpha_s + 2 * ns;     // [2][ns]
  const int n = blockIdx.x, j = threadIdx.x;
  const size_t row_stride = (size_t)N * C;
  const float* base = scores + (size_t)n * C;
  const float lz = logz[n];
  float regs[kPerThread];

  if (j < ns) {
    alpha_s[j] = 0.0f;
    v_s[j] = 0.0f;
  }
  prefetch_row(base, C, regs);
  commit_row(ms_s, C, regs);
  float beta_next = j < ns ? betas[((size_t)1 * N + n) * ns + j] : 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t + 1 < T) prefetch_row(base + (size_t)(t + 1) * row_stride, C, regs);
    const float beta_after =
        (t + 2 <= T && j < ns) ? betas[((size_t)(t + 2) * N + n) * ns + j]
                               : 0.0f;
    if (j < ns) {
      const float* ms = ms_s + cur * C + j * nb1;
      const float* alpha = alpha_s + cur * ns;
      const float* v = v_s + cur * ns;
      const int q = j / nb;
      float avals[kMaxCols];
      avals[0] = alpha[j] + ms[0];
      float edge = (avals[0] + beta_next) - lz;
      float best = v[j] + logf(expf(edge) + 1e-8f);
      int best_k = 0;
      for (int i = 0; i < nb; ++i) {
        const int p = i * nsd + q;
        avals[1 + i] = alpha[p] + ms[1 + i];
        edge = (avals[1 + i] + beta_next) - lz;
        const float cand = v[p] + logf(expf(edge) + 1e-8f);
        if (cand > best) {
          best = cand;
          best_k = 1 + i;
        }
      }
      alpha_s[(cur ^ 1) * ns + j] = lse(avals, nb1);
      v_s[(cur ^ 1) * ns + j] = best;
      bp[((size_t)t * N + n) * ns + j] = (uint8_t)best_k;
    }
    if (t + 1 < T) commit_row(ms_s + (cur ^ 1) * C, C, regs);
    beta_next = beta_after;
    __syncthreads();
  }
  if (j < ns) v_final[(size_t)n * ns + j] = v_s[(T & 1) * ns + j];
}

// K2c: per sequence, start from argmax(v_final) (first maximum) and walk
// the backpointers from T-1 down to 0; labels [N, T] int8 in 0..nb.
__global__ void crf_traceback_kernel(const uint8_t* __restrict__ bp,
                                     const float* __restrict__ v_final,
                                     int8_t* __restrict__ labels, int T,
                                     int N, int nb, int ns) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int nsd = ns / nb;
  const float* v = v_final + (size_t)n * ns;
  int j = 0;
  float best = v[0];
  for (int k = 1; k < ns; ++k) {
    if (v[k] > best) {
      best = v[k];
      j = k;
    }
  }
  for (int t = T - 1; t >= 0; --t) {
    const int k = bp[((size_t)t * N + n) * ns + j];
    labels[(size_t)n * T + t] = (int8_t)k;
    if (k > 0) j = (k - 1) * nsd + j / nb;
  }
}

}  // namespace

extern "C" {

// Each entry point returns 0, a cudaError_t, -2 (unsupported shape), or,
// for the ring's scans, -3 (scores not 8-byte aligned).
// All tensors are contiguous; scores are f32 [T, N, ns * (nb + 1)].

int xna_crf_backward(const void* scores, void* betas, int T, int N, int nb,
                     int ns, void* stream) {
  if (!supported(T, N, nb, ns)) return -2;
  const int C = ns * (nb + 1);
  const size_t smem = ring_bytes(C) + 2 * (size_t)ns * 4;
  const int route = ring_route(scores, C);
  if (route < 0) return -3;
  return ring_dispatch(route, nb, [&](auto r, auto b) {
    return ring_launch(
        crf_backward_kernel<decltype(r)::value, decltype(b)::value>, N,
        kThreads, smem, stream, static_cast<const float*>(scores),
        static_cast<float*>(betas), T, N, nb, ns);
  });
}

int xna_crf_fwd_viterbi(const void* scores, const void* betas,
                        const void* logz, void* bp, void* v_final, int T,
                        int N, int nb, int ns, void* stream) {
  if (!supported(T, N, nb, ns)) return -2;
  const size_t smem = (2 * (size_t)ns * (nb + 1) + 4 * (size_t)ns) * 4;
  crf_fwd_viterbi_kernel<<<N, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(betas),
      static_cast<const float*>(logz), static_cast<uint8_t*>(bp),
      static_cast<float*>(v_final), T, N, nb, ns);
  return cudaGetLastError();
}

int xna_crf_traceback(const void* bp, const void* v_final, void* labels,
                      int T, int N, int nb, int ns, void* stream) {
  if (!supported(T, N, nb, ns)) return -2;
  constexpr int kBlock = 32;
  crf_traceback_kernel<<<(N + kBlock - 1) / kBlock, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const float*>(v_final),
      static_cast<int8_t*>(labels), T, N, nb, ns);
  return cudaGetLastError();
}

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
