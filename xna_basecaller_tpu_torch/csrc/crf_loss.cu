// K4, K5b, K6a, K6b: the CTC-CRF training loss's scans and edge posteriors,
// for Hopper.
//
// Replace the Pallas kernels of xna_basecaller_tpu/ops/crf_pallas.py that
// the JAX package's default training loss runs (XNACALL_PALLAS_LOSS):
//   K4  crf_forward_kernel      <- _fwd_kernel      (forward log scan, logZ)
//   K5b crf_posterior_kernel    <- _post_kernel     (edge posteriors)
//   K6a lattice_forward_kernel  <- _lat_fwd_kernel  (stay/move lattice, logZ)
//   K6b lattice_backward_kernel <- _lat_bwd_kernel + the XLA combine of
//                                  ctc_lattice_grads_pallas
// K5a (_bwd_kernel, the backward scan) is K2a's crf_backward_kernel in
// crf_decode.cu.  Each step keeps the op order of the plain versions in
// ops/crf.py (forward_scores, edge_posteriors, lattice_forward,
// lattice_backward), in f32 with expf/logf/log1pf and no fast math.  The
// finite -1e38 stands for log(0) as there: at most two of them are summed,
// which stays finite, so no inf - inf turns into NaN.
//
// Scores are read in their natural layout [T, N, n_state, n_base + 1]; the
// lattice's stay [T, N, n] and move [T, N, n-1] as the gather gives them.
//
// Bound on the card (flagship training: T=720, N=64, 216 states x 7
// columns, n=448 lattice positions, f32): every kernel moves each byte
// once, and the arithmetic is a few tens of operations per element (under
// 0.01 ms at 67 TFLOP/s), so bytes bound them: K4 reads the 279 MB score
// tensor and writes 40 MB of alphas (0.095 ms at 3.35 TB/s); K5b reads the
// scores, alphas and betas and writes the 279 MB of posteriors (0.19 ms);
// K6a reads 165 MB and writes 83 MB (0.074 ms); K6b reads 248 MB and writes
// 165 MB (0.12 ms).  The scans (K4, K6a, K6b) are held in practice by
// their 720 dependent steps.
//
// Design: the scans run one block per sequence, with the recurrent vector
// double-buffered in shared memory so that one __syncthreads separates the
// steps.  K4 is K2b's alpha update alone, one thread per state, reading
// each step's 6 KB score row straight from the ring of crf_ring.cuh (rows
// D - 1 steps ahead in shared memory, by bulk copy or cp.async).  The
// lattice kernels stride their threads over the n positions (any n up to
// kLatMaxN), read each step's stay and move rows coalesced, prefetching
// the next step's into registers while the current one computes, and K6b
// writes d_stay and d_move as it walks back, so the lattice betas are
// never stored.  K5b is one parallel pass, a block per (t, sequence) row.

#include <cuda_runtime.h>

#include "crf_common.cuh"
#include "crf_ring.cuh"

namespace {

constexpr float kNeg = -1e38f;    // log(0), finite
constexpr int kLatThreads = 512;  // 128 registers a thread, no spills
constexpr int kLatPer = 12;       // positions per thread held in registers
constexpr int kLatMaxN = 6144;    // 2 x n floats of shared memory in 48 KB,
                                  // = kLatThreads * kLatPer

// K4: alphas [T+1, N, ns] with alphas[0] = 0, and logZ [N] = lse(alpha_T).
//   alpha_{t+1}[j] = lse(alpha_t[j] + Ms[t,j,0],
//                        alpha_t[i*nsd + j/nb] + Ms[t,j,1+i] for each i)
// Step t reads its row from the ring (crf_ring.cuh) of D stages, by route
// R; n_base is NB, or nb_arg when NB is 0.
template <int R, int NB>
__global__ void __launch_bounds__(kThreads)
crf_forward_kernel(const float* __restrict__ scores,
                   float* __restrict__ alphas, float* __restrict__ logz, int T,
                   int N, int nb_arg, int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = NB ? NB : nb_arg;
  const int nb1 = nb + 1, C = ns * nb1, nsd = ns / nb;
  RowRing<R> ring(smem, C);
  constexpr int D = kRingStages;
  float* alpha_s = ring.end();   // [2][ns]
  const int n = blockIdx.x, j = threadIdx.x;
  const int q = j / nb;   // outside the loop, or it is redone
  const size_t row_stride = (size_t)N * C;
  const float* base = scores + (size_t)n * C;

  ring.init();
  if (j < ns) {
    alpha_s[j] = 0.0f;
    alphas[(size_t)n * ns + j] = 0.0f;
  }
  __syncthreads();
  for (int t = 0; t < D - 1; ++t) {
    if (t < T)
      ring.fetch(base + t * row_stride, t);
    else
      ring.skip();
  }
  ring.land_next();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t + D - 1 < T)
      ring.fetch(base + (t + D - 1) * row_stride, t + D - 1);
    else
      ring.skip();
    const float* ms = ring.row(t);
    if (j < ns) {
      const float* msj = ms + j * nb1;
      const float* alpha = alpha_s + cur * ns;
      float avals[kMaxCols];
      avals[0] = alpha[j] + msj[0];
#pragma unroll
      for (int i = 0; i < kMaxCols - 1; ++i)
        if (i < nb) avals[1 + i] = alpha[i * nsd + q] + msj[1 + i];
      const float out = lse_n(avals, nb1);
      alpha_s[(cur ^ 1) * ns + j] = out;
      alphas[((size_t)(t + 1) * N + n) * ns + j] = out;
    }
    ring.land_next();
    __syncthreads();
  }
  if (j == 0) logz[n] = lse(alpha_s + (T & 1) * ns, ns);
}

// K5b: post[t,n,j,k] = exp(((a_k + Ms[t,n,j,k]) + beta_{t+1}[j]) - logZ[n])
// (times ct[n] when ct is given), a_0 = alpha_t[j], a_{1+i} =
// alpha_t[i*nsd + j/nb].  One block per (t, n) row.
__global__ void __launch_bounds__(kThreads)
crf_posterior_kernel(const float* __restrict__ scores,
                     const float* __restrict__ alphas,
                     const float* __restrict__ betas,
                     const float* __restrict__ logz,
                     const float* __restrict__ ct, float* __restrict__ post,
                     int N, int nb, int ns) {
  __shared__ float a_s[kThreads], b_s[kThreads];
  const int nb1 = nb + 1, C = ns * nb1, nsd = ns / nb;
  const int row = blockIdx.x, n = row % N;   // row = t * N + n
  if (threadIdx.x < ns) {
    a_s[threadIdx.x] = alphas[(size_t)row * ns + threadIdx.x];
    b_s[threadIdx.x] = betas[((size_t)row + N) * ns + threadIdx.x];
  }
  __syncthreads();
  const float lz = logz[n];
  const float* ms = scores + (size_t)row * C;
  float* out = post + (size_t)row * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int j = c / nb1, k = c % nb1;
    const float a = k == 0 ? a_s[j] : a_s[(k - 1) * nsd + j / nb];
    float p = expf(((a + ms[c]) + b_s[j]) - lz);
    if (ct != nullptr) p *= ct[n];
    out[c] = p;
  }
}

// K6a: the stay/move lattice forward.  alphas [T, N, n] holds alpha_t
// before step t; alpha_0 = 0 at position 0 and log(0) elsewhere; then
//   alpha'[0] = alpha[0] + stay[0],
//   alpha'[j] = lse(alpha[j] + stay[j], alpha[j-1] + move[j-1]),
// and logZ [N] = alpha_T[clamp(len-1, 0, n-1)].  Position j of a block's
// walk is thread j % blockDim, register slot j / blockDim.
__global__ void __launch_bounds__(kLatThreads)
lattice_forward_kernel(const float* __restrict__ stay,
                       const float* __restrict__ move,
                       const int* __restrict__ lengths,
                       float* __restrict__ alphas, float* __restrict__ logz,
                       int T, int N, int n) {
  extern __shared__ float sm[];   // [2][n]
  const int b = blockIdx.x, nt = blockDim.x;
  const size_t s_step = (size_t)N * n, m_step = (size_t)N * (n - 1);
  const float* st = stay + (size_t)b * n;
  const float* mv = move + (size_t)b * (n - 1);
  float* al = alphas + (size_t)b * n;
  float s_reg[kLatPer], m_reg[kLatPer];

#pragma unroll
  for (int p = 0; p < kLatPer; ++p) {
    const int j = threadIdx.x + p * nt;
    if (j < n) {
      sm[j] = j == 0 ? 0.0f : kNeg;
      s_reg[p] = st[j];
      m_reg[p] = j > 0 ? mv[j - 1] : 0.0f;
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* a = sm + (t & 1) * n;
    float* a_next = sm + ((t & 1) ^ 1) * n;
    float s_next[kLatPer] = {}, m_next[kLatPer] = {};
#pragma unroll
    for (int p = 0; p < kLatPer; ++p) {
      const int j = threadIdx.x + p * nt;
      if (t + 1 < T && j < n) {
        s_next[p] = st[(t + 1) * s_step + j];
        m_next[p] = j > 0 ? mv[(t + 1) * m_step + j - 1] : 0.0f;
      }
    }
#pragma unroll
    for (int p = 0; p < kLatPer; ++p) {
      const int j = threadIdx.x + p * nt;
      if (j < n) {
        const float aj = a[j];
        al[t * s_step + j] = aj;
        const float stayed = aj + s_reg[p];
        float out = stayed;
        if (j > 0) {
          const float moved = a[j - 1] + m_reg[p];
          const float m = fmaxf(stayed, moved);
          out = m + logf(expf(stayed - m) + expf(moved - m));
        }
        a_next[j] = out;
        s_reg[p] = s_next[p];
        m_reg[p] = m_next[p];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int idx = min(max(lengths[b] - 1, 0), n - 1);
    logz[b] = sm[(T & 1) * n + idx];
  }
}

// K6b: the lattice backward with the combine fused in.  beta_T = 0 at
// position len-1 and log(0) elsewhere; walking t = T-1 .. 0 with
// beta = beta_{t+1}:
//   d_stay[t,j] = exp(((alphas[t,j] + stay[t,j]) + beta[j]) - logZ) * ct
//   d_move[t,j] = exp(((alphas[t,j] + move[t,j]) + beta[j+1]) - logZ) * ct
//   beta_t[j]   = logaddexp(stay[t,j] + beta[j], move[t,j] + beta[j+1]),
//   beta_t[n-1] = stay[t,n-1] + beta[n-1],
// with logaddexp(x, y) = max + log1p(exp(-|x - y|)), as torch computes it.
__global__ void __launch_bounds__(kLatThreads)
lattice_backward_kernel(const float* __restrict__ stay,
                        const float* __restrict__ move,
                        const int* __restrict__ lengths,
                        const float* __restrict__ alphas,
                        const float* __restrict__ logz,
                        const float* __restrict__ ct,
                        float* __restrict__ d_stay,
                        float* __restrict__ d_move, int T, int N, int n) {
  extern __shared__ float sm[];   // [2][n]
  const int b = blockIdx.x, nt = blockDim.x;
  const size_t s_step = (size_t)N * n, m_step = (size_t)N * (n - 1);
  const float* st = stay + (size_t)b * n;
  const float* mv = move + (size_t)b * (n - 1);
  const float* al = alphas + (size_t)b * n;
  float* ds = d_stay + (size_t)b * n;
  float* dm = d_move + (size_t)b * (n - 1);
  const float lz = logz[b], c = ct[b];
  const int last = lengths[b] - 1;
  float s_reg[kLatPer], m_reg[kLatPer], a_reg[kLatPer];

#pragma unroll
  for (int p = 0; p < kLatPer; ++p) {
    const int j = threadIdx.x + p * nt;
    if (j < n) {
      sm[j] = j == last ? 0.0f : kNeg;
      s_reg[p] = st[(T - 1) * s_step + j];
      m_reg[p] = j < n - 1 ? mv[(T - 1) * m_step + j] : 0.0f;
      a_reg[p] = al[(T - 1) * s_step + j];
    }
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    const float* beta = sm + (s & 1) * n;
    float* beta_next = sm + ((s & 1) ^ 1) * n;
    float s_next[kLatPer] = {}, m_next[kLatPer] = {}, a_next[kLatPer] = {};
#pragma unroll
    for (int p = 0; p < kLatPer; ++p) {
      const int j = threadIdx.x + p * nt;
      if (t > 0 && j < n) {
        s_next[p] = st[(t - 1) * s_step + j];
        m_next[p] = j < n - 1 ? mv[(t - 1) * m_step + j] : 0.0f;
        a_next[p] = al[(t - 1) * s_step + j];
      }
    }
#pragma unroll
    for (int p = 0; p < kLatPer; ++p) {
      const int j = threadIdx.x + p * nt;
      if (j < n) {
        const float bj = beta[j];
        ds[t * s_step + j] = expf(((a_reg[p] + s_reg[p]) + bj) - lz) * c;
        const float stay_term = s_reg[p] + bj;
        float out = stay_term;
        if (j < n - 1) {
          const float bj1 = beta[j + 1];
          dm[t * m_step + j] = expf(((a_reg[p] + m_reg[p]) + bj1) - lz) * c;
          const float move_term = m_reg[p] + bj1;
          out = fmaxf(stay_term, move_term) +
                log1pf(expf(-fabsf(stay_term - move_term)));
        }
        beta_next[j] = out;
        s_reg[p] = s_next[p];
        m_reg[p] = m_next[p];
        a_reg[p] = a_next[p];
      }
    }
    __syncthreads();
  }
}

bool lattice_supported(int T, int N, int n) {
  return T >= 1 && N >= 1 && n >= 1 && n <= kLatMaxN;
}

// threads for a lattice of n positions: a warp multiple, at most
// kLatThreads, so that each thread holds at most kLatPer positions
int lattice_threads(int n) {
  return n >= kLatThreads ? kLatThreads : (n + 31) / 32 * 32;
}

}  // namespace

extern "C" {

// Each entry point returns 0, a cudaError_t, -2 (unsupported shape), or,
// for the ring's scans, -3 (scores not 8-byte aligned).
// All tensors are contiguous f32 (lengths int32); scores are
// [T, N, ns * (nb + 1)].

int xna_crf_forward(const void* scores, void* alphas, void* logz, int T, int N,
                    int nb, int ns, void* stream) {
  if (!supported(T, N, nb, ns)) return -2;
  const int C = ns * (nb + 1);
  const size_t smem = ring_bytes(C) + 2 * (size_t)ns * 4;
  const int route = ring_route(scores, C);
  if (route < 0) return -3;
  return ring_dispatch(route, nb, [&](auto r, auto b) {
    return ring_launch(
        crf_forward_kernel<decltype(r)::value, decltype(b)::value>, N, smem,
        stream, static_cast<const float*>(scores),
        static_cast<float*>(alphas), static_cast<float*>(logz), T, N, nb,
        ns);
  });
}

// alphas and betas [T+1, N, ns]; ct [N] or null
int xna_crf_posteriors(const void* scores, const void* alphas,
                       const void* betas, const void* logz, const void* ct,
                       void* post, int T, int N, int nb, int ns,
                       void* stream) {
  if (!supported(T, N, nb, ns) || (long long)T * N > 0x7fffffffLL) return -2;
  crf_posterior_kernel<<<T * N, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const float*>(alphas),
      static_cast<const float*>(betas), static_cast<const float*>(logz),
      static_cast<const float*>(ct), static_cast<float*>(post), N, nb, ns);
  return cudaGetLastError();
}

// stay [T, N, n], move [T, N, n-1], lengths [N] -> alphas [T, N, n], logz [N]
int xna_lattice_forward(const void* stay, const void* move,
                        const void* lengths, void* alphas, void* logz, int T,
                        int N, int n, void* stream) {
  if (!lattice_supported(T, N, n)) return -2;
  lattice_forward_kernel<<<N, lattice_threads(n), 2 * (size_t)n * 4,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stay), static_cast<const float*>(move),
      static_cast<const int*>(lengths), static_cast<float*>(alphas),
      static_cast<float*>(logz), T, N, n);
  return cudaGetLastError();
}

// ... alphas [T, N, n], logz [N], ct [N] -> d_stay [T, N, n], d_move
// [T, N, n-1]
int xna_lattice_backward(const void* stay, const void* move,
                         const void* lengths, const void* alphas,
                         const void* logz, const void* ct, void* d_stay,
                         void* d_move, int T, int N, int n, void* stream) {
  if (!lattice_supported(T, N, n)) return -2;
  lattice_backward_kernel<<<N, lattice_threads(n), 2 * (size_t)n * 4,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stay), static_cast<const float*>(move),
      static_cast<const int*>(lengths), static_cast<const float*>(alphas),
      static_cast<const float*>(logz), static_cast<const float*>(ct),
      static_cast<float*>(d_stay), static_cast<float*>(d_move), T, N, n);
  return cudaGetLastError();
}

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
