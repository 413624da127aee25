// The CRF head's f32 epilogue, for Hopper: from the head's product p [R, C]
// (bf16, f16 or f32) and its bias b [C] (same dtype), the scores
//   s = tanhf((float)p[r, c] + (float)b[c]) * scale
// in f32, each group of n_base products led by the fixed blank score:
//   out[r, g * (nb + 1)] = blank,  out[r, g * (nb + 1) + 1 + k] = s[g * nb + k]
// (without a blank score, out[r, c] = s).  Its rows are the head's T x N
// frames.
//
// Replaces no Pallas kernel: in the JAX package XLA fuses this chain after
// the head's product (xna_basecaller_tpu/models/crf_model.py).  The port ran
// it as six PyTorch passes over the scores (the cast, the bias add, tanh, the
// scale, the blank column and the cat; ops/crf_head.py::crf_head_chain, its
// plain version), which at ONT's R10.4.1 sup shape (T=2000, N=256, C=4096,
// 5120 score columns) move ~82 GB a batch.  The operations are those of the
// chain in the same order in f32, tanhf without fast math: the scores are
// bit-equal to the chain's.
//
// Bound on the card: bytes.  The kernel reads the product once and writes
// the scores once: at R10's shape 4.19 GB in and 10.49 GB out, 4.38 ms at
// 3.35 TB/s; at the XNA model's (T=720, N=384, C=1296 at n_base 6) 0.72 GB
// and 1.67 GB, 0.71 ms.
//
// Design (the tiled path, where a row is a whole number of units): a
// thread's unit is 4 groups (4 nb products, 4 (nb + 1) scores: 16 -> 20 at
// nb 4, 24 -> 28 at nb 6), so that both ends are whole 16-byte vectors and
// every index inside the unit is a constant of the template.  A thread
// loads its unit's product as 16-byte vectors and its bias from L1; each
// warp's 32 units of scores go out through its own slice of shared memory
// as 16-byte stores of neighbouring addresses, so that the stores, 5/2 of
// the bytes at bf16, move whole sectors (written straight from each
// thread's unit they stride 80 or 112 bytes a lane, and the kernel takes
// 1.5 to 2.2 times as long).  Other shapes (no blank score, n_base other
// than 4 or 6, rows that are no whole number of units, unaligned tensors;
// no cell runs one) take a plain grid-stride loop over the scores.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;      // a block: 8 warps
constexpr int kGroups = 4;         // groups of n_base products a unit

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Element i (a constant once unrolled) of T values packed in uint4s, as
// f32: exact, as to_f32.
template <typename T>
__device__ __forceinline__ float element(const uint4* v, int i) {
  constexpr int per_word = 4 / sizeof(T);
  const uint4 q = v[i / (4 * per_word)];
  const int k = (i / per_word) % 4;
  const unsigned w = k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
  if constexpr (std::is_same_v<T, float>) {
    return __uint_as_float(w);
  } else {
    const unsigned short h =
        static_cast<unsigned short>(i % 2 ? w >> 16 : w & 0xffffu);
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      return __uint_as_float(static_cast<unsigned>(h) << 16);
    else
      return __half2float(__ushort_as_half(h));
  }
}

// A unit's shape at n_base NB and product type T.
template <int NB, typename T>
struct Unit {
  static constexpr int kIn = kGroups * NB;                   // products
  static constexpr int kOut = kGroups * (NB + 1);            // scores
  static constexpr int kInVec = kIn * (int)sizeof(T) / 16;   // uint4s
  static constexpr int kOutVec = kOut / 4;                   // float4s
};

// The tiled path: a thread a unit, `units` of them in all, `upr` a row.
template <int NB, typename T>
__global__ void __launch_bounds__(kThreads)
crf_head_tiled_kernel(const T* __restrict__ p, const T* __restrict__ b,
                      float* __restrict__ out, long long units, int upr,
                      float blank, float scale) {
  using U = Unit<NB, T>;
  __shared__ float4 stage[kThreads / 32][32 * U::kOutVec];
  const int lane = threadIdx.x & 31;
  float4* buf = stage[threadIdx.x >> 5];
  const long long unit = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long first = unit - lane;      // the warp's first unit
  if (unit < units) {
    uint4 in[U::kInVec];
    const uint4* src = reinterpret_cast<const uint4*>(p) + unit * U::kInVec;
#pragma unroll
    for (int q = 0; q < U::kInVec; ++q) in[q] = src[q];
    const T* bias = b + (int)(unit % upr) * U::kIn;
    float s[U::kOut];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      s[g * (NB + 1)] = blank;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int i = g * NB + k;
        s[g * (NB + 1) + 1 + k] =
            tanhf(element<T>(in, i) + to_f32(bias[i])) * scale;
      }
    }
#pragma unroll
    for (int q = 0; q < U::kOutVec; ++q)
      buf[lane * U::kOutVec + q] =
          make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  }
  __syncwarp();
  const long long left = units - first;
  const int valid = left >= 32 ? 32 : (int)left;
  float4* dst = reinterpret_cast<float4*>(out) + first * U::kOutVec;
#pragma unroll
  for (int q = 0; q < U::kOutVec; ++q) {
    const int k = lane + 32 * q;
    if (k < valid * U::kOutVec) dst[k] = buf[k];
  }
}

// Any other shape: a thread a score, grid-stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
crf_head_any_kernel(const T* __restrict__ p, const T* __restrict__ b,
                    float* __restrict__ out, long long n_out, int C, int cout,
                    int nb, int has_blank, float blank, float scale) {
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < n_out; j += (long long)gridDim.x * kThreads) {
    const long long r = j / cout;
    int c = (int)(j - r * cout);
    if (has_blank) {
      const int g = c / (nb + 1), m = c - g * (nb + 1);
      if (m == 0) {
        out[j] = blank;
        continue;
      }
      c = g * nb + m - 1;
    }
    out[j] = tanhf(to_f32(p[r * C + c]) + to_f32(b[c])) * scale;
  }
}

template <int NB, typename T>
int launch_tiled(const void* p, const void* b, void* out, long long R, int C,
                 float blank, float scale, cudaStream_t stream) {
  const int upr = C / Unit<NB, T>::kIn;
  const long long units = R * upr;
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return -2;
  crf_head_tiled_kernel<NB, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(b),
      static_cast<float*>(out), units, upr, blank, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* p, const void* b, void* out, long long R, int C,
           int nb, int has_blank, float blank, float scale,
           cudaStream_t stream, int* tiled) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (aligned && has_blank && (nb == 4 || nb == 6) &&
      C % (kGroups * nb) == 0) {
    if (tiled) *tiled = 1;
    return nb == 4 ? launch_tiled<4, T>(p, b, out, R, C, blank, scale, stream)
                   : launch_tiled<6, T>(p, b, out, R, C, blank, scale, stream);
  }
  const int cout = has_blank ? C / nb * (nb + 1) : C;
  const long long n_out = R * cout;
  const long long blocks =
      std::min<long long>((n_out + kThreads - 1) / kThreads, 4096);
  crf_head_any_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(b),
      static_cast<float*>(out), n_out, C, cout, nb, has_blank, blank, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p [R, C] and b [C] contiguous, of one dtype: 0 f32, 1 bf16, 2 f16; out
// [R, C / nb * (nb + 1)] (has_blank) or [R, C] f32, contiguous.  *tiled
// (null allowed) is set to 1 where the launch took the tiled path, else 0.
// Returns 0, a cudaError_t, or -2 (R < 1, C < 1, nb < 1, C not a multiple
// of nb with a blank score, or more than 2^31 - 1 blocks).
int xna_crf_head_epilogue(const void* p, const void* b, void* out, long long R,
                          int C, int nb, int has_blank, float blank,
                          float scale, int dtype, void* stream, int* tiled) {
  if (tiled) *tiled = 0;
  if (R < 1 || C < 1 || nb < 1 || (has_blank && C % nb)) return -2;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, b, out, R, C, nb, has_blank, blank,
                                 scale, s, tiled);
  if (dtype == 2)
    return launch<__half>(p, b, out, R, C, nb, has_blank, blank, scale, s,
                          tiled);
  return launch<float>(p, b, out, R, C, nb, has_blank, blank, scale, s,
                       tiled);
}

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
