// K2a, K2b, K2c: the CRF decode chain (Viterbi over log edge posteriors),
// for Hopper, with the q-score variants of K2b and K2c.
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
// sequence.  K2c moves only the bytes its paths touch, and is held by its
// walk: 720 dependent loads a sequence.
//
// Design: one block per sequence (N blocks).  K2a and K2b run one thread
// per state; their recurrent vectors (beta; alpha beside the Viterbi
// scores, as float2) live in shared memory, double buffered so one
// __syncthreads separates the steps.  Each step reads its span straight
// from a ring of D stages in shared memory that bulk copies (or cp.async
// of 8 bytes, for rows that are not 16-byte multiples) keep D - 1 steps
// ahead (crf_ring.cuh), so that a step waits for no device-memory latency:
// K2a's span is the score row, K2b's the score row and, where both take
// the bulk copy (n_state a multiple of 4, as the flagship's 216), the row
// beta_{t+1} after it; elsewhere K2b reads beta_{t+1} from device memory a
// step ahead.  n_base is a compile-time constant for 4, 5 and 6 bases, so
// the columns unroll and their expf and logf run side by side.
// Backpointers (0..n_base) are stored as uint8 [T, N, n_state]: 40 MB
// instead of the 159 MB of int32.  K2c runs a block per sequence too: its
// warps 1-3 copy the sequence's backpointer rows into shared memory in
// chunks of Tc steps from the end, double buffered (cp.async of 8 bytes,
// or plain loads for rows of other sizes), while thread 0 walks
// the chunk before, reading shared memory only, and the labels go out as
// coalesced rows a chunk behind the walk.
//
// The q-score variants (template flag QUAL; JAX's decode_paths_with_qual,
// ops/crf.py:806-857, which XLA runs on the TPU): K2b also writes the raw
// edge of the column it chose, edge_sel[t, n, j] = (a[best_k] + beta) -
// logZ in f32 ([T, N, n_state], as large as the betas: 159 MB at the
// flagship batch, one coalesced row a step); K2c's walker also records the
// state it visits at each step of a chunk in shared memory, and the copy
// warps, when they write that chunk's labels, gather edge_sel at those
// states (96 independent loads at a time, off the walk's chain) and write
// probs[n, t] = expf(edge) in f32.  Without QUAL both kernels compile as
// before, their outputs bit for bit the same.
//
// The wide path (past supported()'s 256 states: up to 1024 states and 5120
// scores a frame, NACGT at state_len 5): K2a and K2b as the same kernels
// on another block shape (ScanShape: WideShape, several states a thread on
// a shallower ring); K2c as crf_traceback_kernel, whose chunks of bp rows
// are sized by n_state.  At T=2000, N=256 (the R10.4.1 sup model's batch)
// the scores are 10.5 GB: K2a and K2b each must read them once, 3.1 ms at
// 3.35 TB/s.  The q-score variants keep supported()'s shapes.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "async_copy.cuh"
#include "crf_common.cuh"
#include "crf_ring.cuh"

namespace {

constexpr int kTbThreads = 128;              // K2c: a walker warp, 3 copiers
constexpr int kTbChunkBytes = 48 * 1024;     // K2c: a chunk of bp rows

// The shape of a block of K2a and K2b: Threads threads a sequence, each
// of Spt states (j = threadIdx.x + k Threads), on a ring of Stages stages,
// with Blocks blocks an SM in the launch bounds.  supported()'s shapes
// take FirstShape, a thread a state on kRingStages stages; the wide path
// takes WideShape (below).
template <int Threads, int Spt, int Stages, int Blocks>
struct ScanShape {
  static constexpr int threads = Threads, spt = Spt, stages = Stages,
                       blocks = Blocks;
};
using FirstShape = ScanShape<kThreads, 1, kRingStages, 1>;

// K2a: betas [T+1, N, ns] with betas[t] = beta_t and betas[T] = 0.
//   beta_t[k] = lse(stay: Ms[t,k,0] + beta_{t+1}[k],
//                   move: lse_b(Ms[t, m*nb+b, 1+i] + beta_{t+1}[m*nb+b]))
// with k = i*nsd + m (crf.py::_bwd_step), for each of a thread's states.
// Step s reads the row of t = T-1-s from the ring (crf_ring.cuh) of D
// stages, by route R; n_base is NB, or nb_arg when NB is 0.
template <class S, int R, int NB>
__global__ void __launch_bounds__(S::threads, S::blocks)
crf_backward_kernel(const float* __restrict__ scores,
                    float* __restrict__ betas, int T, int N, int nb_arg,
                    int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = NB ? NB : nb_arg;
  const int nb1 = nb + 1, C = ns * nb1, nsd = ns / nb;
  RowRing<R, S::stages> ring(smem, C);
  constexpr int D = S::stages;
  float* beta_s = ring.end();    // [2][ns]
  const int n = blockIdx.x;
  int js[S::spt], is[S::spt], ms_[S::spt];   // outside the loop, or redone
#pragma unroll
  for (int k = 0; k < S::spt; ++k) {
    js[k] = threadIdx.x + k * S::threads;
    is[k] = js[k] / nsd;
    ms_[k] = js[k] % nsd;
  }
  const size_t row_stride = (size_t)N * C;
  const float* last = scores + ((size_t)(T - 1) * N + n) * C;

  ring.init();
#pragma unroll
  for (int k = 0; k < S::spt; ++k)
    if (js[k] < ns) {
      beta_s[js[k]] = 0.0f;
      betas[((size_t)T * N + n) * ns + js[k]] = 0.0f;
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
    const float* beta = beta_s + cur * ns;
#pragma unroll
    for (int k = 0; k < S::spt; ++k) {
      const int j = js[k], i = is[k], m = ms_[k];
      if (j < ns) {
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
    }
    ring.land_next();
    __syncthreads();
  }
}

// K2b: the forward scan fused with Viterbi over the log edge posteriors,
// bp [T, N, ns] uint8 (the argmax column k) and v_final [N, ns]:
//   a_0 = alpha_t[j] + Ms[t,j,0], a_{1+i} = alpha_t[p_i] + Ms[t,j,1+i],
//   with p_0 = j and p_{1+i} = i*nsd + j/nb;
//   c_k = v_t[p_k] + log(exp((a_k + beta_{t+1}[j]) - logZ) + 1e-8);
//   v_{t+1}[j] = max_k c_k, bp[t,n,j] = the first k at it (k = 0 first);
//   alpha_{t+1}[j] = lse(a_0 .. a_nb), in order;
// for each of a thread's states.  Step t reads its span from the ring
// (crf_ring.cuh) of D stages, by route R: the score row of t and, where
// BS, the row beta_{t+1} after it; without BS each thread loads its
// beta_{t+2} during step t.  n_base is NB, or nb_arg when NB is 0.  With
// QUAL, edge_sel[t, n, j] is the edge (a_k + beta_{t+1}[j]) - logZ of the
// chosen k.
template <class S, int R, int NB, bool BS, bool QUAL = false>
__global__ void __launch_bounds__(S::threads, S::blocks)
crf_fwd_viterbi_kernel(const float* __restrict__ scores,
                       const float* __restrict__ betas,
                       const float* __restrict__ logz,
                       uint8_t* __restrict__ bp, float* __restrict__ v_final,
                       float* __restrict__ edge_sel, int T, int N,
                       int nb_arg, int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = NB ? NB : nb_arg;
  const int nb1 = nb + 1, C = ns * nb1, nsd = ns / nb;
  RowRing<R, S::stages> ring(smem, BS ? C + ns : C);
  constexpr int D = S::stages;
  float2* av_s = reinterpret_cast<float2*>(ring.end());   // [2][ns]
  const int n = blockIdx.x;
  int js[S::spt], qs[S::spt];   // outside the loop, or redone
#pragma unroll
  for (int k = 0; k < S::spt; ++k) {
    js[k] = threadIdx.x + k * S::threads;
    qs[k] = js[k] / nb;
  }
  const size_t row_stride = (size_t)N * C, beta_stride = (size_t)N * ns;
  const float* base = scores + (size_t)n * C;
  const float* beta1 = betas + beta_stride + (size_t)n * ns;   // beta_1
  uint8_t* bpn = bp + (size_t)n * ns;
  const float lz = logz[n];
  const auto fetch = [&](int t) {
    if constexpr (BS)
      ring.fetch(t, Row{base + t * row_stride, C},
                 Row{beta1 + t * beta_stride, ns});
    else
      ring.fetch(t, Row{base + t * row_stride, C});
  };

  ring.init();
#pragma unroll
  for (int k = 0; k < S::spt; ++k)
    if (js[k] < ns) av_s[js[k]] = make_float2(0.0f, 0.0f);
  __syncthreads();
  for (int t = 0; t < D - 1; ++t) {
    if (t < T)
      fetch(t);
    else
      ring.skip();
  }
  float beta_next[S::spt];   // without BS
#pragma unroll
  for (int k = 0; k < S::spt; ++k)
    beta_next[k] = !BS && js[k] < ns ? beta1[js[k]] : 0.0f;
  ring.land_next();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t + D - 1 < T)
      fetch(t + D - 1);
    else
      ring.skip();
    float beta_after[S::spt];
#pragma unroll
    for (int k = 0; k < S::spt; ++k)
      beta_after[k] = !BS && t + 1 < T && js[k] < ns
                          ? beta1[(t + 1) * beta_stride + js[k]]
                          : 0.0f;
    const float* ms = ring.row(t);
    const float2* av = av_s + cur * ns;
#pragma unroll
    for (int k = 0; k < S::spt; ++k) {
      const int j = js[k], q = qs[k];
      if (j < ns) {
        const float bn = BS ? ms[C + j] : beta_next[k];
        const float* msj = ms + j * nb1;
        float a[kMaxCols], v[kMaxCols];
        float2 p = av[j];
        a[0] = p.x + msj[0];
        v[0] = p.y;
#pragma unroll
        for (int i = 0; i < kMaxCols - 1; ++i)
          if (i < nb) {
            p = av[i * nsd + q];
            a[1 + i] = p.x + msj[1 + i];
            v[1 + i] = p.y;
          }
        const float e0 = (a[0] + bn) - lz;
        float best = v[0] + logf(expf(e0) + 1e-8f);
        float best_e = e0;   // QUAL only
        int best_k = 0;
#pragma unroll
        for (int c = 1; c < kMaxCols; ++c)
          if (c <= nb) {
            const float e = (a[c] + bn) - lz;
            const float cand = v[c] + logf(expf(e) + 1e-8f);
            if (cand > best) {
              best = cand;
              best_k = c;
              if constexpr (QUAL) best_e = e;
            }
          }
        av_s[(cur ^ 1) * ns + j] = make_float2(lse_n(a, nb1), best);
        bpn[t * beta_stride + j] = (uint8_t)best_k;
        if constexpr (QUAL)
          edge_sel[(t * (size_t)N + n) * ns + j] = best_e;
      }
    }
#pragma unroll
    for (int k = 0; k < S::spt; ++k) beta_next[k] = beta_after[k];
    ring.land_next();
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < S::spt; ++k)
    if (js[k] < ns)
      v_final[(size_t)n * ns + js[k]] = av_s[(T & 1) * ns + js[k]].y;
}

// K2c's layout in shared memory: rows of a chunk at a stride of ns rounded
// up to 16 bytes, Tc steps a chunk (all T where they fit in
// kTbChunkBytes), two chunks, then two chunks' labels, and with QUAL, from
// the next 16 bytes, two chunks' states of the walk (int).
__host__ __device__ inline int tb_stride(int ns) { return (ns + 15) & ~15; }

__host__ __device__ inline int tb_states_at(int Tc, int ns) {
  return (2 * Tc * tb_stride(ns) + 2 * Tc + 15) & ~15;
}

int tb_chunk(int T, int ns) {
  return std::min(T, kTbChunkBytes / tb_stride(ns));
}

size_t tb_smem(int Tc, int ns, bool qual) {
  return qual ? tb_states_at(Tc, ns) + 2 * (size_t)Tc * 4
              : 2 * (size_t)Tc * tb_stride(ns) + 2 * (size_t)Tc;
}

// The bytes a copy of K2c moves: 8 where bp's rows are 8-byte aligned
// (n_state a multiple of 8, as the flagship's 216), else 1 (plain loads).
// (cp.async of 4 bytes was slower on the flagship's rows, PERF.md §6.)
int tb_width(const void* bp, int ns) {
  return reinterpret_cast<uintptr_t>(bp) % 8 == 0 && ns % 8 == 0 ? 8 : 1;
}

// K2c: per sequence, start from the first maximum of v_final[n] and walk
// the backpointers from T-1 down to 0: labels [N, T] int8 in 0..nb.  Chunk
// c holds steps [lo, hi), hi = T - c Tc, lo = max(hi - Tc, 0); warps 1..
// copy it by cp.async of W bytes (W = 1: plain loads) during the walk of
// chunk c - 1, and write chunk c - 2's labels (with QUAL, and its probs
// from edge_sel at the walk's states).  n_base is NB, or nb_arg when NB is
// 0.
template <int NB, int W, bool QUAL = false>
__global__ void __launch_bounds__(kTbThreads)
crf_traceback_kernel(const uint8_t* __restrict__ bp,
                     const float* __restrict__ v_final,
                     const float* __restrict__ edge_sel,
                     int8_t* __restrict__ labels, float* __restrict__ probs,
                     int T, int N, int nb_arg, int ns, int Tc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_v[kTbThreads / 32];
  __shared__ int warp_j[kTbThreads / 32];
  const int nb = NB ? NB : nb_arg, nsd = ns / nb, rs = tb_stride(ns);
  int8_t* lab_s = reinterpret_cast<int8_t*>(smem + 2 * Tc * rs);  // [2][Tc]
  int* j_s = reinterpret_cast<int*>(smem + tb_states_at(Tc, ns));  // QUAL
  const int n = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n_chunks = (T + Tc - 1) / Tc;
  const size_t stride = (size_t)N * ns;
  const uint8_t* seq = bp + (size_t)n * ns;
  int8_t* out = labels + (size_t)n * T;
  const auto span = [&](int c, int& lo) {
    const int hi = T - c * Tc;
    lo = max(hi - Tc, 0);
    return hi - lo;
  };
  const auto copy = [&](int c) {   // by warps 1..
    int lo;
    const int rows = span(c, lo), per = ns / W;
    unsigned char* dst = smem + (c & 1) * Tc * rs;
    for (int u = tid - 32; u < rows * per; u += kTbThreads - 32) {
      const int r = u / per, o = (u - r * per) * W;
      const uint8_t* src = seq + (lo + r) * stride + o;
      if constexpr (W == 8)
        xna::cp_async8(dst + r * rs + o, src);
      else
        dst[r * rs + o] = *src;
    }
    if constexpr (W > 1) xna::cp_async_commit();
  };
  const auto write = [&](int c) {   // by warps 1..
    int lo;
    const int rows = span(c, lo);
    const int8_t* src = lab_s + (c & 1) * Tc;
    for (int r = tid - 32; r < rows; r += kTbThreads - 32) out[lo + r] = src[r];
    if constexpr (QUAL) {
      const int* js = j_s + (c & 1) * Tc;
      for (int r = tid - 32; r < rows; r += kTbThreads - 32)
        probs[(size_t)n * T + lo + r] =
            expf(edge_sel[((size_t)(lo + r) * N + n) * ns + js[r]]);
    }
  };

  if (tid >= 32) copy(0);
  // the first maximum of v_final[n]: each thread's in order, then the
  // lowest state among equal maxima
  const float* v = v_final + (size_t)n * ns;
  float best = v[0];
  int best_j = 0;
  for (int k = tid; k < ns; k += kTbThreads)
    if (v[k] > best) {
      best = v[k];
      best_j = k;
    }
#pragma unroll
  for (int w = 16; w > 0; w /= 2) {
    const float o = __shfl_down_sync(0xffffffffu, best, w);
    const int oj = __shfl_down_sync(0xffffffffu, best_j, w);
    if (o > best || (o == best && oj < best_j)) {
      best = o;
      best_j = oj;
    }
  }
  if (lane == 0) {
    warp_v[tid / 32] = best;
    warp_j[tid / 32] = best_j;
  }
  if (W > 1 && tid >= 32) xna::cp_async_wait<0>();
  __syncthreads();
  int j = 0;   // the walker's state
  if (tid == 0) {
    best = warp_v[0];
    j = warp_j[0];
    for (int w = 1; w < kTbThreads / 32; ++w)
      if (warp_v[w] > best || (warp_v[w] == best && warp_j[w] < j)) {
        best = warp_v[w];
        j = warp_j[w];
      }
  }

  for (int c = 0; c < n_chunks; ++c) {
    if (tid >= 32) {
      if (c > 0) write(c - 1);
      if (c + 1 < n_chunks) copy(c + 1);
      if (W > 1) xna::cp_async_wait<0>();
    } else if (tid == 0) {
      int lo;
      const unsigned char* rows = smem + (c & 1) * Tc * rs;
      int8_t* lab = lab_s + (c & 1) * Tc;
      int* js = j_s + (c & 1) * Tc;
      for (int r = span(c, lo) - 1; r >= 0; --r) {
        const int k = rows[r * rs + j];
        lab[r] = (int8_t)k;
        if constexpr (QUAL) js[r] = j;
        j = k ? (k - 1) * nsd + j / nb : j;
      }
    }
    __syncthreads();
  }
  if (tid >= 32) write(n_chunks - 1);
}

// The wide path of K2a and K2b: n_state past supported()'s 256, up to
// kWideStates, with rows of up to kWideMaxRow floats (NACGT at state_len 5:
// 1024 states x 5 columns, a 20 KB score row).  The same kernels as the
// first path on WideShape: 512 threads of 2 states a sequence on a ring of
// 4 stages, so that 2 blocks share an SM and a batch of 256 sequences is
// one wave on the card's 132 SMs (8 stages of K2b's 24 KB span, 192 KB,
// would leave one block an SM and two waves).  Bound on the card at
// T=2000, N=256 (bytes, read once): K2a 3.76 ms, K2b 3.91 ms.  The shape
// was chosen by timing the alternatives in turns (tools/k2_turns.py, H100,
// N=256): 512 threads of 2 states K2a 4.62, K2b 6.17 ms; 1024 of 1 (32
// registers, K2b spilling) 4.64, 6.34; 256 of 4 4.75, 6.21; 1024 of 1 on 8
// stages, one block an SM (two waves) 4.59, 6.49.  K2c takes these shapes
// with its own kernel: its chunks of bp rows are sized by n_state.
using WideShape = ScanShape<512, 2, 4, 2>;
constexpr int kWideStates = 1024;    // most states
constexpr int kWideMaxRow = 5120;    // floats of a score row
static_assert(WideShape::threads * WideShape::spt >= kWideStates,
              "a state for every thread's slot");

// The shapes of the wide path: those supported() refuses, n_state a
// multiple of n_base, at most kWideStates states and kWideMaxRow floats a
// row.
bool supported_wide(int T, int N, int nb, int ns) {
  return !supported(T, N, nb, ns) && T >= 1 && N >= 1 && nb >= 1 &&
         nb + 1 <= kMaxCols && ns >= nb && ns <= kWideStates &&
         ns % nb == 0 && ns * (nb + 1) <= kWideMaxRow;
}

// K2b, and with edge_sel (non-null) its q-score variant.
int fwd_viterbi(const void* scores, const void* betas, const void* logz,
                void* bp, void* v_final, void* edge_sel, int T, int N, int nb,
                int ns, void* stream, int* wide) {
  if (wide) *wide = 0;
  const bool on_wide = !edge_sel && supported_wide(T, N, nb, ns);
  if (!supported(T, N, nb, ns) && !on_wide) return -2;
  const int C = ns * (nb + 1);
  const int route = ring_route(scores, C);
  if (route < 0) return -3;
  // beta_{t+1} joins the span where its rows take the bulk copy too
  const bool span = route == kBulk && ns % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(betas) % 16 == 0;
  if (wide) *wide = on_wide;
  const auto run = [&](auto shape) {
    using S = decltype(shape);
    const size_t smem = ring_bytes(span ? C + ns : C, S::stages) +
                        2 * (size_t)ns * sizeof(float2);
    return ring_dispatch(route, nb, [&](auto r, auto b) {
      constexpr int R = decltype(r)::value, NB = decltype(b)::value;
      const auto launch = [&](auto kernel) {
        return ring_launch(kernel, N, S::threads, smem, stream,
                           static_cast<const float*>(scores),
                           static_cast<const float*>(betas),
                           static_cast<const float*>(logz),
                           static_cast<uint8_t*>(bp),
                           static_cast<float*>(v_final),
                           static_cast<float*>(edge_sel), T, N, nb, ns);
      };
      if constexpr (std::is_same_v<S, FirstShape>)
        if (edge_sel) {
          if constexpr (R == kBulk)
            if (span)
              return launch(crf_fwd_viterbi_kernel<S, R, NB, true, true>);
          return launch(crf_fwd_viterbi_kernel<S, R, NB, false, true>);
        }
      if constexpr (R == kBulk)
        if (span) return launch(crf_fwd_viterbi_kernel<S, R, NB, true>);
      return launch(crf_fwd_viterbi_kernel<S, R, NB, false>);
    });
  };
  return on_wide ? run(WideShape{}) : run(FirstShape{});
}

// K2c, and with edge_sel and probs (non-null) its q-score variant.
int traceback(const void* bp, const void* v_final, const void* edge_sel,
              void* labels, void* probs, int T, int N, int nb, int ns,
              void* stream, int* wide) {
  const bool qual = edge_sel != nullptr;
  const bool on_wide = !qual && supported_wide(T, N, nb, ns);
  if (wide) *wide = on_wide;
  if (!supported(T, N, nb, ns) && !on_wide) return -2;
  const int Tc = tb_chunk(T, ns), width = tb_width(bp, ns);
  return nb_dispatch(nb, [&](auto b) {
    constexpr int NB = decltype(b)::value;
    const auto launch = [&](auto kernel) {
      return ring_launch(kernel, N, kTbThreads, tb_smem(Tc, ns, qual), stream,
                         static_cast<const uint8_t*>(bp),
                         static_cast<const float*>(v_final),
                         static_cast<const float*>(edge_sel),
                         static_cast<int8_t*>(labels),
                         static_cast<float*>(probs), T, N, nb, ns, Tc);
    };
    if (qual) {
      if (width == 8) return launch(crf_traceback_kernel<NB, 8, true>);
      return launch(crf_traceback_kernel<NB, 1, true>);
    }
    if (width == 8) return launch(crf_traceback_kernel<NB, 8>);
    return launch(crf_traceback_kernel<NB, 1>);
  });
}

}  // namespace

extern "C" {

// Each entry point returns 0, a cudaError_t, -2 (unsupported shape), or,
// for the ring's scans, -3 (scores not 8-byte aligned).
// All tensors are contiguous; scores are f32 [T, N, ns * (nb + 1)].
// wide: null, or receives 1 where the launch took the wide path (K2a, K2b
// and K2c past supported()'s shapes, supported_wide), else 0; the q-score
// variants keep supported()'s shapes.

int xna_crf_backward(const void* scores, void* betas, int T, int N, int nb,
                     int ns, void* stream, int* wide) {
  if (wide) *wide = 0;
  const bool on_wide = supported_wide(T, N, nb, ns);
  if (!supported(T, N, nb, ns) && !on_wide) return -2;
  const int C = ns * (nb + 1);
  const int route = ring_route(scores, C);
  if (route < 0) return -3;
  if (wide) *wide = on_wide;
  const auto run = [&](auto shape) {
    using S = decltype(shape);
    const size_t smem = ring_bytes(C, S::stages) + 2 * (size_t)ns * 4;
    return ring_dispatch(route, nb, [&](auto r, auto b) {
      return ring_launch(
          crf_backward_kernel<S, decltype(r)::value, decltype(b)::value>, N,
          S::threads, smem, stream, static_cast<const float*>(scores),
          static_cast<float*>(betas), T, N, nb, ns);
    });
  };
  return on_wide ? run(WideShape{}) : run(FirstShape{});
}

int xna_crf_fwd_viterbi(const void* scores, const void* betas,
                        const void* logz, void* bp, void* v_final, int T,
                        int N, int nb, int ns, void* stream, int* wide) {
  return fwd_viterbi(scores, betas, logz, bp, v_final, nullptr, T, N, nb, ns,
                     stream, wide);
}

// edge_sel f32 [T, N, ns]
int xna_crf_fwd_viterbi_qual(const void* scores, const void* betas,
                             const void* logz, void* bp, void* v_final,
                             void* edge_sel, int T, int N, int nb, int ns,
                             void* stream) {
  return fwd_viterbi(scores, betas, logz, bp, v_final, edge_sel, T, N, nb, ns,
                     stream, nullptr);
}

int xna_crf_traceback(const void* bp, const void* v_final, void* labels,
                      int T, int N, int nb, int ns, void* stream, int* wide) {
  return traceback(bp, v_final, nullptr, labels, nullptr, T, N, nb, ns,
                   stream, wide);
}

// edge_sel f32 [T, N, ns] of the qual K2b; probs f32 [N, T]
int xna_crf_traceback_qual(const void* bp, const void* v_final,
                           const void* edge_sel, void* labels, void* probs,
                           int T, int N, int nb, int ns, void* stream) {
  return traceback(bp, v_final, edge_sel, labels, probs, T, N, nb, ns,
                   stream, nullptr);
}

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
