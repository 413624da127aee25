// The path-collapsing beam search over the CRF's edge log-posteriors, for
// Hopper.
//
// No Pallas kernel replaced: the JAX package runs this decode as XLA
// (xna_basecaller_tpu/ops/crf.py::decode_beam, :629-741; its merge
// _beam_merge_topk, :606-626).  Its 720 dependent steps each do a top-k, a
// pairwise merge and a gather for every sequence, some 50 launches a step
// as eager torch, so the step loop is one kernel here; the scans before it
// are K4 (alphas, logZ from them, as JAX takes it) and K2a (betas).
//
// Per sequence, with B beams of identity (state, h1, h2), where h1 and h2
// are the two uint32 rolling hashes of the emitted labels:
//   edge(t, j, k) = ((alpha_t[pred(j, k)] + Ms[t, j, k]) + beta_{t+1}[j])
//                   - logZ,   pred(j, 0) = j, pred(j, 1+i) = i*nsd + j/nb;
//   t = 0: the top B of the ns*(nb+1) edges (padded with -1e38 where fewer
//     than B, the index clamped to the last edge): state = idx / (nb+1),
//     label = h1 = h2 = idx % (nb+1);
//   t >= 1: beam b (state s, score x) gives nb+1 candidates, in order: the
//     stay (s, label 0, same hashes, x + edge(t, s, 0)) and the moves into
//     j = (s % nsd) * nb + b2 for b2 = 0..nb-1 (label d+1 with d = s/nsd,
//     h <- h * P + label, x + edge(t, j, 1 + d)); the predecessor of every
//     candidate of beam b is s, so one alpha is read a beam.  Candidates
//     of one identity collapse into the first of them with the log-sum-exp
//     of their scores (max, then expf of each in index order, + logf); the
//     others score -1e38; the top B by score, the lower index first among
//     equal ones (jax.lax.top_k), are the next beams, each remembering its
//     parent beam and label;
//   the end: each beam's score merged (log-sum-exp) over the beams of its
//     sequence (h1, h2), the first maximum wins (jnp.argmax); the walk back
//     over the parents writes the labels [N, T] int8 (0 = stay, a label at
//     its move frame) and best_score [N] f32.
// -1e38 stands for log(0), finite, as in the JAX package: dead beams (from
// the padding at t = 0, or merged away) keep a live identity and are
// selected by the same rules.  f32 with expf/logf and no fast math.
//
// Bound on the card (flagship: T=720, N=256, 216 states x 7 columns): what
// a step must read is the B * (nb+1) candidates' scores and betas and one
// alpha a beam; at B=8, 256 x 720 x (56 x 8 + 8 x 4) bytes = 88 MB, 0.03 ms
// at 3.35 TB/s, and the arithmetic is far less.  The kernel is held by its
// 720 dependent steps, each a chain of three phases (candidates, merge,
// selection) with a __syncthreads between them, and by the merge and the
// selection, which compare every pair of candidates: B (nb+1) squared, 3136
// pairs a step at B=8, 800 k at B=128.
//
// Design: one block of kBeamThreads per sequence; the beams, the candidates
// (one 16-byte record each: state, h1, h2, score) and their merged scores
// live in shared memory; a thread takes candidates tid, tid + kBeamThreads,
// ...  The merge and the selection compare each candidate with every
// other: uniform loops of branch-free compares (a candidate finds its
// class's max and its first member in one pass; the sum of exps runs only
// for the rare class of two or more), unrolled by 8 so that the loads of a
// lane overlap.  The first version's merge, loops with a per-lane start and
// an early exit on a data-dependent branch, made the kernel ~20x slower at
// B=8 (PERF.md section 6).  The ranks of the
// selection are computed by counting (each candidate counts the candidates
// ahead of it, stopping, every 8, once B are ahead), which places every
// kept candidate at its slot with no sort.  Where the rows are
// 16-byte aligned multiples of 16 bytes (the flagship's), each step's span
// (the score row t, the alpha row t and the beta row t+1) comes through the
// row ring of crf_ring.cuh, D - 1 steps ahead, so that a step reads shared
// memory only; elsewhere the candidates read device memory directly.  The
// parents and labels of every step go to a scratch [N, T, B] of uint16
// (parent << 3 | label) in device memory, which thread 0 walks back at the
// end.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "async_copy.cuh"
#include "crf_common.cuh"
#include "crf_ring.cuh"

namespace {

constexpr int kBeamThreads = 256;
constexpr int kMaxBeam = 256;     // B: the parent fits the scratch's 13 bits
constexpr int kDirect = 1;        // the route without the ring
constexpr float kNeg = -1e38f;    // log(0), finite
constexpr uint32_t kP1 = 1000003u, kP2 = 2654435761u;

// Where a step's candidates read their rows.
struct Span {
  const float* ms;      // Ms[t]: ns * (nb + 1)
  const float* alpha;   // alpha_t: ns
  const float* beta;    // beta_{t+1}: ns
};

// A candidate's identity and score, read by the merge as one 16-byte load.
struct __align__(16) Cand {
  int state;
  uint32_t h1, h2;
  float score;
};

// The shared memory of a block past the ring: the candidates, their merged
// scores, the beams, then the candidates' tags.
__host__ __device__ inline size_t beam_cand_bytes(int Mmax, int B) {
  return (size_t)Mmax * (sizeof(Cand) + 4 + 2) + (size_t)B * 16 + 16;
}

// The rank of value v at index i among the m values of `vals`: the values
// ahead of it (larger, or equal at a lower index), counted until B are.
__device__ __forceinline__ int rank_of(const float* vals, int m, float v,
                                       int i, int B) {
  int r = 0, q = 0;
  for (; q + 8 <= m && r < B; q += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float w = vals[q + u];
      r += (w > v) | ((w == v) & (q + u < i));
    }
  }
  for (; q < m && r < B; ++q) {
    const float w = vals[q];
    r += (w > v) | ((w == v) & (q < i));
  }
  return r;
}

__host__ __device__ inline size_t beam_ring_bytes(int span) {
  return ring_bar_bytes(kRingStages) +
         (size_t)kRingStages * ring_stride(span) * 4;
}

template <int R, int NB>
__global__ void __launch_bounds__(kBeamThreads)
crf_beam_kernel(const float* __restrict__ scores,
                const float* __restrict__ alphas,
                const float* __restrict__ betas,
                const float* __restrict__ logz, uint16_t* __restrict__ hist,
                int8_t* __restrict__ labels, float* __restrict__ best_score,
                int T, int N, int nb_arg, int ns, int B, int Mmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = NB ? NB : nb_arg;
  const int nb1 = nb + 1, C = ns * nb1, nsd = ns / nb, span = C + 2 * ns;
  constexpr int D = kRingStages;
  RowRing<kBulk> ring(smem, span);   // used on the bulk route only
  unsigned char* rest = smem + (R == kBulk ? beam_ring_bytes(span) : 0);
  Cand* cand = reinterpret_cast<Cand*>(rest);                // [Mmax]
  float* merged = reinterpret_cast<float*>(cand + Mmax);     // [Mmax]
  float* b_score = merged + Mmax;                            // [B]
  int* b_state = reinterpret_cast<int*>(b_score + B);
  uint32_t* b_h1 = reinterpret_cast<uint32_t*>(b_state + B);
  uint32_t* b_h2 = b_h1 + B;
  uint16_t* c_tag = reinterpret_cast<uint16_t*>(b_h2 + B);  // [Mmax]

  const int n = blockIdx.x, tid = threadIdx.x;
  const float lz = logz[n];
  const size_t score_stride = (size_t)N * C, part_stride = (size_t)N * ns;
  const float* ms0 = scores + (size_t)n * C;
  const float* a0 = alphas + (size_t)n * ns;
  const float* b1 = betas + part_stride + (size_t)n * ns;   // beta_1
  uint16_t* h = hist + (size_t)n * T * B;
  const auto fetch = [&](int t) {
    ring.fetch(t, Row{ms0 + t * score_stride, C},
               Row{a0 + t * part_stride, ns}, Row{b1 + t * part_stride, ns});
  };
  const auto span_of = [&](int t) {
    if constexpr (R == kBulk) {
      const float* st = ring.row(t);
      return Span{st, st + C, st + C + ns};
    } else {
      return Span{ms0 + t * score_stride, a0 + t * part_stride,
                  b1 + t * part_stride};
    }
  };

  if constexpr (R == kBulk) ring.init();
  __syncthreads();
  if constexpr (R == kBulk)
    for (int t = 0; t < D - 1 && t < T; ++t) fetch(t);

  // t = 0: the top B of every (state, column) edge
  {
    if constexpr (R == kBulk)
      if (D - 1 < T) fetch(D - 1);
    const Span sp = span_of(0);
    const int m0 = max(C, B);
    for (int i = tid; i < m0; i += kBeamThreads) {
      float e = kNeg;
      if (i < C) {
        const int j = i / nb1, k = i - j * nb1;
        const int p = k == 0 ? j : (k - 1) * nsd + j / nb;
        e = ((sp.alpha[p] + sp.ms[i]) + sp.beta[j]) - lz;
      }
      merged[i] = e;
    }
    __syncthreads();
    for (int i = tid; i < m0; i += kBeamThreads) {
      const float v = merged[i];
      const int r = rank_of(merged, m0, v, i, B);
      if (r < B) {
        const int idx = min(i, C - 1), lab = idx % nb1;
        b_score[r] = v;
        b_state[r] = idx / nb1;
        b_h1[r] = b_h2[r] = (uint32_t)lab;
        h[r] = (uint16_t)lab;
      }
    }
    __syncthreads();
  }

  const int M = B * nb1;
  for (int t = 1; t < T; ++t) {
    if constexpr (R == kBulk)
      if (t + D - 1 < T) fetch(t + D - 1);
    const Span sp = span_of(t);
    // the candidates, beam by beam: the stay, then the moves
    for (int c = tid; c < M; c += kBeamThreads) {
      const int b = c / nb1, k = c - b * nb1;
      const int s = b_state[b];
      uint32_t h1 = b_h1[b], h2 = b_h2[b];
      int j = s, col = 0, lab = 0;
      if (k > 0) {
        const int d = s / nsd;
        j = (s - d * nsd) * nb + (k - 1);
        col = 1 + d;
        lab = d + 1;
        h1 = h1 * kP1 + (uint32_t)lab;
        h2 = h2 * kP2 + (uint32_t)lab;
      }
      const float e = ((sp.alpha[s] + sp.ms[j * nb1 + col]) + sp.beta[j]) - lz;
      cand[c] = Cand{j, h1, h2, b_score[b] + e};
      c_tag[c] = (uint16_t)((b << 3) | lab);
    }
    __syncthreads();
    // the merge: the first of each identity takes its class's log-sum-exp
    for (int i = tid; i < M; i += kBeamThreads) {
      const Cand ci = cand[i];
      bool before = false;   // a member of the class ahead of i
      float m = ci.score;
      int members = 0;
#pragma unroll 8
      for (int q = 0; q < M; ++q) {
        const Cand cq = cand[q];
        const bool same =
            (cq.state == ci.state) & (cq.h1 == ci.h1) & (cq.h2 == ci.h2);
        before |= same & (q < i);
        m = same ? fmaxf(m, cq.score) : m;
        members += same;
      }
      float out = kNeg;
      if (!before) {
        // in index order from i; one member: expf(0) = 1
        float sum = 1.0f;
        if (members > 1) {
          sum = 0.0f;
          for (int q = i; q < M; ++q) {
            const Cand cq = cand[q];
            if ((cq.state == ci.state) & (cq.h1 == ci.h1) & (cq.h2 == ci.h2))
              sum += expf(cq.score - m);
          }
        }
        out = m + logf(sum);
      }
      merged[i] = out;
    }
    __syncthreads();
    // the selection: the top B take the beams' slots in rank order
    for (int i = tid; i < M; i += kBeamThreads) {
      const float v = merged[i];
      const int r = rank_of(merged, M, v, i, B);
      if (r < B) {
        const Cand ci = cand[i];
        b_score[r] = v;
        b_state[r] = ci.state;
        b_h1[r] = ci.h1;
        b_h2[r] = ci.h2;
        h[(size_t)t * B + r] = c_tag[i];
      }
    }
    __syncthreads();
  }

  // the end: each beam merged over the beams of its sequence
  for (int b = tid; b < B; b += kBeamThreads) {
    const uint32_t h1 = b_h1[b], h2 = b_h2[b];
    float m = kNeg;
    for (int q = 0; q < B; ++q)
      if (b_h1[q] == h1 && b_h2[q] == h2) m = fmaxf(m, b_score[q]);
    float sum = 0.0f;
    for (int q = 0; q < B; ++q)
      if (b_h1[q] == h1 && b_h2[q] == h2) sum += expf(b_score[q] - m);
    merged[b] = m + logf(sum);
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int b = 1; b < B; ++b)
      if (merged[b] > merged[best]) best = b;
    best_score[n] = merged[best];
    int8_t* out = labels + (size_t)n * T;
    int cur = best;
    for (int t = T - 1; t >= 1; --t) {
      const int v = h[(size_t)t * B + cur];
      out[t] = (int8_t)(v & 7);
      cur = v >> 3;
    }
    out[0] = (int8_t)(h[cur] & 7);
  }
}

}  // namespace

extern "C" {

// scores f32 [T, N, ns * (nb + 1)]; alphas and betas f32 [T+1, N, ns];
// logz f32 [N]; hist a scratch of N * T * B uint16; labels int8 [N, T];
// best f32 [N].  Returns 0, a cudaError_t, -2 (unsupported shape) or -4 (a
// beam width outside 1..xna_beam_max_width()).
int xna_crf_beam(const void* scores, const void* alphas, const void* betas,
                 const void* logz, void* hist, void* labels, void* best, int T,
                 int N, int nb, int ns, int B, void* stream) {
  if (!supported(T, N, nb, ns)) return -2;
  if (B < 1 || B > kMaxBeam) return -4;
  const int C = ns * (nb + 1);
  const int Mmax = std::max(B * (nb + 1), std::max(C, B));
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool bulk = a16(scores) && a16(alphas) && a16(betas) && C % 4 == 0 &&
                    ns % 4 == 0;
  const size_t smem = (bulk ? beam_ring_bytes(C + 2 * ns) : 0) +
                      beam_cand_bytes(Mmax, B);
  return nb_dispatch(nb, [&](auto b) {
    constexpr int NB = decltype(b)::value;
    const auto launch = [&](auto kernel) {
      return ring_launch(kernel, N, kBeamThreads, smem, stream,
                         static_cast<const float*>(scores),
                         static_cast<const float*>(alphas),
                         static_cast<const float*>(betas),
                         static_cast<const float*>(logz),
                         static_cast<uint16_t*>(hist),
                         static_cast<int8_t*>(labels),
                         static_cast<float*>(best), T, N, nb, ns, B, Mmax);
    };
    if (bulk) return launch(crf_beam_kernel<kBulk, NB>);
    return launch(crf_beam_kernel<kDirect, NB>);
  });
}

int xna_beam_max_width() { return kMaxBeam; }

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
