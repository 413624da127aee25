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
// Scores are read in their natural layout [T, N, n_state, n_base + 1].
// The lattice's stay [T, N, n] and move [T, N, n-1] are packed by the
// wrappers (ops/crf_cuda.py::lattice_pack) as the JAX package's _lat_pack
// packs them: lat [T, N, 2, npad], npad = n rounded up to 4, slot j of
// row 0 the stay at j, slot j of row 1 the move into j (slot 0 and the
// pads -1e38), so that a step's rows of one sequence are one 16-byte
// aligned span.  K6a writes its alphas at row stride npad, for K6b.
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
// steps, and read each step's span of rows straight from the ring of
// crf_ring.cuh (spans D - 1 steps ahead in shared memory, by bulk copy or
// cp.async), so that a step waits for no device-memory latency.  K4 is
// K2b's alpha update alone, one thread per state, its span the 6 KB score
// row.  The lattice kernels stride their threads over the n positions
// (any n up to kLatMaxN) with one warp more than the positions need up to
// 480 of them, whose last thread issues the bulk copies; K6a's span is the
// step's packed stay and move (3.5 KB at n=448), K6b's those and the
// alphas row (5.25 KB), in 8 stages, or 4 or 2 where a wide lattice's 8
// do not fit (lattice_depth).  K6b writes d_stay and d_move as it
// walks back, so the lattice betas are never stored.  K5b is one parallel
// pass, a block per (t, sequence) row.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "crf_common.cuh"
#include "crf_ring.cuh"

namespace {

constexpr float kNeg = -1e38f;    // log(0), finite
constexpr int kLatThreads = 512;  // threads of a lattice block, at most
constexpr int kLatMaxN = 6144;    // positions: K6b's ring of 2 stages and
                                  // its two beta rows in 192 KB
constexpr size_t kMaxSmem = 232448;   // a block's shared memory (227 KB)

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
      ring.fetch(t, Row{base + t * row_stride, C});
    else
      ring.skip();
  }
  ring.land_next();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t + D - 1 < T)
      ring.fetch(t + D - 1, Row{base + (t + D - 1) * row_stride, C});
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

// Padded positions of a lattice of n: a packed row is 16-byte aligned.
__host__ __device__ inline int lat_pad(int n) { return (n + 3) & ~3; }

// K6a: the stay/move lattice forward.  alphas [T, N, npad] holds alpha_t
// before step t at positions 0..n-1; alpha_0 = 0 at position 0 and log(0)
// elsewhere; then
//   alpha'[0] = alpha[0] + stay[0],
//   alpha'[j] = lse(alpha[j] + stay[j], alpha[j-1] + move into j),
// and logZ [N] = alpha_T[clamp(len-1, 0, n-1)].  Step t reads its span
// lat[t, b] (stay, then move) from a ring of D stages; thread j of the
// block walks positions j, j + blockDim, ...
template <int D>
__global__ void __launch_bounds__(kLatThreads)
lattice_forward_kernel(const float* __restrict__ lat,
                       const int* __restrict__ lengths,
                       float* __restrict__ alphas, float* __restrict__ logz,
                       int T, int N, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npad = lat_pad(n), b = blockIdx.x, nt = blockDim.x;
  RowRing<kBulk, D> ring(smem, 2 * npad);
  float* sm = ring.end();   // [2][n]
  const size_t step = (size_t)N * npad;   // alphas' step; lat's is twice
  const float* span = lat + (size_t)b * 2 * npad;
  float* al = alphas + (size_t)b * npad;

  ring.init();
  for (int j = threadIdx.x; j < n; j += nt) sm[j] = j == 0 ? 0.0f : kNeg;
  __syncthreads();
  for (int t = 0; t < D - 1 && t < T; ++t)
    ring.fetch(t, Row{span + t * 2 * step, 2 * npad});
  const float* next = span + (D - 1) * 2 * step;   // the span of t + D - 1

  for (int t = 0; t < T; ++t, next += 2 * step, al += step) {
    if (t + D - 1 < T) ring.fetch(t + D - 1, Row{next, 2 * npad});
    const float* st = ring.row(t);
    const float* mv = st + npad;
    const float* a = sm + (t & 1) * n;
    float* a_next = sm + ((t & 1) ^ 1) * n;
    for (int j = threadIdx.x; j < n; j += nt) {
      const float aj = a[j];
      al[j] = aj;
      const float stayed = aj + st[j];
      float out = stayed;
      if (j > 0) {
        const float moved = a[j - 1] + mv[j];
        const float m = fmaxf(stayed, moved);
        out = m + logf(expf(stayed - m) + expf(moved - m));
      }
      a_next[j] = out;
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
// beta = beta_{t+1} and move[t,j] the move from j into j+1:
//   d_stay[t,j] = exp(((alphas[t,j] + stay[t,j]) + beta[j]) - logZ) * ct
//   d_move[t,j] = exp(((alphas[t,j] + move[t,j]) + beta[j+1]) - logZ) * ct
//   beta_t[j]   = logaddexp(stay[t,j] + beta[j], move[t,j] + beta[j+1]),
//   beta_t[n-1] = stay[t,n-1] + beta[n-1],
// with logaddexp(x, y) = max + log1p(exp(-|x - y|)), as torch computes it.
// Step s reads the span of t = T-1-s: lat[t, b], then alphas[t, b].
template <int D>
__global__ void __launch_bounds__(kLatThreads)
lattice_backward_kernel(const float* __restrict__ lat,
                        const int* __restrict__ lengths,
                        const float* __restrict__ alphas,
                        const float* __restrict__ logz,
                        const float* __restrict__ ct,
                        float* __restrict__ d_stay,
                        float* __restrict__ d_move, int T, int N, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npad = lat_pad(n), b = blockIdx.x, nt = blockDim.x;
  RowRing<kBulk, D> ring(smem, 3 * npad);
  float* sm = ring.end();   // [2][n]
  const size_t step = (size_t)N * npad;
  const size_t s_step = (size_t)N * n, m_step = (size_t)N * (n - 1);
  const float* span = lat + ((size_t)(T - 1) * N + b) * 2 * npad;
  const float* al = alphas + ((size_t)(T - 1) * N + b) * npad;
  float* ds = d_stay + ((size_t)(T - 1) * N + b) * n;
  float* dm = d_move + ((size_t)(T - 1) * N + b) * (n - 1);
  const float lz = logz[b], c = ct[b];
  const int last = lengths[b] - 1;

  ring.init();
  for (int j = threadIdx.x; j < n; j += nt) sm[j] = j == last ? 0.0f : kNeg;
  __syncthreads();
  for (int s = 0; s < D - 1 && s < T; ++s)
    ring.fetch(s, Row{span - s * 2 * step, 2 * npad},
               Row{al - s * step, npad});
  span -= (D - 1) * 2 * step;   // the spans of step s + D - 1
  al -= (D - 1) * step;

  for (int s = 0; s < T; ++s, span -= 2 * step, al -= step, ds -= s_step,
           dm -= m_step) {
    if (s + D - 1 < T)
      ring.fetch(s + D - 1, Row{span, 2 * npad}, Row{al, npad});
    const float* st = ring.row(s);
    const float* mv = st + npad + 1;   // mv[j]: the move from j into j+1
    const float* av = st + 2 * npad;
    const float* beta = sm + (s & 1) * n;
    float* beta_next = sm + ((s & 1) ^ 1) * n;
    for (int j = threadIdx.x; j < n; j += nt) {
      const float bj = beta[j];
      ds[j] = expf(((av[j] + st[j]) + bj) - lz) * c;
      const float stay_term = st[j] + bj;
      float out = stay_term;
      if (j < n - 1) {
        const float bj1 = beta[j + 1];
        dm[j] = expf(((av[j] + mv[j]) + bj1) - lz) * c;
        const float move_term = mv[j] + bj1;
        out = fmaxf(stay_term, move_term) +
              log1pf(expf(-fabsf(stay_term - move_term)));
      }
      beta_next[j] = out;
    }
    __syncthreads();
  }
}

bool lattice_supported(int T, int N, int n) {
  return T >= 1 && N >= 1 && n >= 1 && n <= kLatMaxN;
}

// Threads for a lattice of n positions: a warp more than the positions
// need, whose last thread issues the ring's copies, up to kLatThreads;
// above 480 positions the last thread walks positions too.
int lattice_threads(int n) {
  return std::min((n + 31) / 32 * 32 + 32, kLatThreads);
}

// Shared memory of a lattice scan whose span is `rows` packed rows (K6a 2,
// K6b 3) in a ring of D stages, with its two rows of alpha or beta.
size_t lattice_smem(int n, int rows, int D) {
  return ring_bytes(rows * lat_pad(n), D) + 2 * (size_t)n * 4;
}

// The ring's depth for a lattice of n positions: 8 stages where they fit
// in a block's shared memory (K6a up to n = 3224, K6b up to 2232), else 4
// (K6a up to 5808, K6b up to 4148), else 2 (any n up to kLatMaxN).
int lattice_depth(int n, int rows) {
  for (int D = kRingStages; D > 2; D /= 2)
    if (lattice_smem(n, rows, D) <= kMaxSmem) return D;
  return 2;
}

// Launch `kernel<D>` at the lattice's depth.
template <class Launch>
int lattice_launch(int n, int rows, Launch&& launch) {
  switch (lattice_depth(n, rows)) {
    case 8: return launch(IntC<8>{});
    case 4: return launch(IntC<4>{});
  }
  return launch(IntC<2>{});
}

}  // namespace

extern "C" {

// Each entry point returns 0, a cudaError_t, -2 (unsupported shape), or,
// for the ring's scans, -3 (scores not 8-byte aligned; the lattice's
// packed rows or alphas not 16-byte aligned).
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
        crf_forward_kernel<decltype(r)::value, decltype(b)::value>, N,
        kThreads, smem, stream, static_cast<const float*>(scores),
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

// lat [T, N, 2, npad] (lattice_pack), lengths [N] -> alphas [T, N, npad],
// logz [N]; -3 where lat or alphas is not 16-byte aligned
int xna_lattice_forward(const void* lat, const void* lengths, void* alphas,
                        void* logz, int T, int N, int n, void* stream) {
  if (!lattice_supported(T, N, n)) return -2;
  if (reinterpret_cast<uintptr_t>(lat) % 16 ||
      reinterpret_cast<uintptr_t>(alphas) % 16)
    return -3;
  return lattice_launch(n, 2, [&](auto d) {
    return ring_launch(lattice_forward_kernel<decltype(d)::value>, N,
                       lattice_threads(n), lattice_smem(n, 2, d), stream,
                       static_cast<const float*>(lat),
                       static_cast<const int*>(lengths),
                       static_cast<float*>(alphas), static_cast<float*>(logz),
                       T, N, n);
  });
}

// ... alphas [T, N, npad], logz [N], ct [N] -> d_stay [T, N, n], d_move
// [T, N, n-1]
int xna_lattice_backward(const void* lat, const void* lengths,
                         const void* alphas, const void* logz, const void* ct,
                         void* d_stay, void* d_move, int T, int N, int n,
                         void* stream) {
  if (!lattice_supported(T, N, n)) return -2;
  if (reinterpret_cast<uintptr_t>(lat) % 16 ||
      reinterpret_cast<uintptr_t>(alphas) % 16)
    return -3;
  return lattice_launch(n, 3, [&](auto d) {
    return ring_launch(lattice_backward_kernel<decltype(d)::value>, N,
                       lattice_threads(n), lattice_smem(n, 3, d), stream,
                       static_cast<const float*>(lat),
                       static_cast<const int*>(lengths),
                       static_cast<const float*>(alphas),
                       static_cast<const float*>(logz),
                       static_cast<const float*>(ct),
                       static_cast<float*>(d_stay),
                       static_cast<float*>(d_move), T, N, n);
  });
}

// The ring's depth of K6a (backward 0) or K6b (backward 1) at n positions.
int xna_lattice_depth(int n, int backward) {
  return lattice_depth(n, backward ? 3 : 2);
}

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
