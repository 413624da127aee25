// K7: the int8 LSTM recurrence of `--quantize`, for Hopper.
//
// Replaces xna_basecaller_tpu/ops/lstm_pallas.py::lstm_recurrence_pallas_int8
// (kernel body _make_int8_kernel).  Per step s of the walk (t = s, or T-1-s
// with reverse != 0, so no flipped copies of xp or ys are made):
//   h_q   = clip(round(h * 127), -127, 127)              (int8)
//   gates = xp[t] + float(h_q @ W_q) * deq,  deq = scale * f32(1/127)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//   c = f * c + i * g,  h = o * tanh(c)                  (f32)
//   ys[t] = h                                            (xp's dtype)
// with h_q @ W_q accumulated exactly in int32.  The TPU kernel keeps h
// between its two-step grid iterations in a scratch of xp's dtype, so in
// bf16 the h that step s requantizes was rounded to bf16 first when s is
// even, and is the f32 h when s is odd.  This kernel does the same: the
// block that computes h at step s - 1 rounds it before quantizing it when s
// is even.  In f32 nothing is rounded.
//
// Bound on the card (flagship, per layer: T=720, N=256, H=768): 2*T*N*H*4H
// = 0.87 T int8 operations over 1979 TOP/s is 0.44 ms; xp + ys in bf16 =
// 1.42 GB over 3.35 TB/s is 0.42 ms.  As for K1 (lstm_recurrence.cu), the
// chain of 720 dependent steps dominates in practice: each step's small
// [N,H]x[H,4H] product waits for the previous step's h everywhere.
//
// Design: K1's.  One persistent cooperative launch per group of at most
// kGroupRows batch rows.  Each block owns 16 hidden units for one tile of
// 128 rows (48 x 2 = 96 blocks at flagship shapes) and keeps their 64 gate
// columns of W_q in shared memory for the whole scan: 48 KB in int8, half of
// K1's slice, stored [column][k] so that a plain ldmatrix yields the
// column-major B fragment (sm_90 has no 8-bit ldmatrix.trans).  h is
// exchanged as int8 in a double buffer in global memory: the writer
// quantizes it, so each step the readers stage half K1's bytes from L2,
// through a ring of cp.async stages.  Each warp computes a 32 x 32 tile of
// the block's [128, 64] product with mma.sync m16n8k32 s8 x s8 -> s32.  The
// dequantization and the gate adds use __fmul_rn / __fadd_rn, so nothing
// is contracted into an FMA, and the cell states stay in registers.  A grid
// barrier separates the steps; the entry point checks co-residency first.
// xp and ys are bf16 or f32 (a template); the product is int8 in both.
// 7.4-7.9 ms a layer (H100 80GB HBM3, 700 W).  The designs tried for K1 at
// N > 64 (lstm_recurrence.cu), carried over to int8 h (128-byte chunks,
// s8 products) and timed in turns with this kernel at N=256, were all
// slower and stayed bit-equal to the plain version: ready flags and a
// bulk-copy ring 10.4-11.0 ms; with multicast clusters 12.8-13.1; with
// vectorized xp and stores 9.0-9.2; with the product on s8 wgmma
// (m64n64k32) 8.3-8.8.

#include "lstm_common.cuh"

namespace {

using namespace xna;

constexpr int kThreads = 256;
constexpr int kGroupRows = 256;     // batch rows per launch
constexpr int kUnits = 16;          // hidden units owned by one block
constexpr int kCols = 4 * kUnits;   // their gate columns, gate-major
constexpr int kRows = 128;          // batch rows of one block
constexpr int kWarpRows = 32;       // each warp: a 32 x 32 tile of the
constexpr int kWarpCols = 32;       // block's [kRows, kCols] product
constexpr int kChunk = 128;         // h columns (bytes) per pipeline stage
constexpr int kStages = 4;
constexpr int kLdH = kChunk + 16;   // padded row strides (bytes / ints):
constexpr int kLdG = kCols + 4;     // ldmatrix rows fall in distinct banks
constexpr int kCells = kRows * kUnits / kThreads;   // per thread
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename IO> __device__ IO from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// One cell: the four gate pre-activations and the cell state c (updated in
// place) -> h in f32; no contraction into an FMA, as in the plain version.
__device__ __forceinline__ float cell(float gi, float gf, float gg, float go,
                                      float& c) {
  c = __fadd_rn(__fmul_rn(sigmoid(gf), c), __fmul_rn(sigmoid(gi), tanhf(gg)));
  return __fmul_rn(sigmoid(go), tanhf(c));
}

// A operand of mma m16n8k32 (s8): the 16 x 32 tile at `a`, row-major with a
// row stride of `ld` bytes.  Its register layout is that of m16n8k16's bf16
// A fragment, byte for byte, so ldmatrix loads it as 16 x 16 b16.
__device__ __forceinline__ void load_a8(uint32_t (&r)[4], const int8_t* a,
                                        int ld) {
  const int lane = threadIdx.x % 32;
  const unsigned p = smem_addr(a + (lane % 16) * ld + (lane / 16) * 16);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(p));
}

// B operands of two m16n8k32 products: 16 columns x 32 k at `b`, stored
// [column][k] with a row stride of `ld` bytes, which is the column-major
// layout mma wants: r[0..1] for columns 0-7 (k 0-15, 16-31), r[2..3] for
// columns 8-15.
__device__ __forceinline__ void load_b8(uint32_t (&r)[4], const int8_t* b,
                                        int ld) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  const unsigned p = smem_addr(b + ((m / 2) * 8 + lane % 8) * ld + (m % 2) * 16);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(p));
}

// d += a @ b on one 16 x 8 tile, s8 operands, s32 accumulation (exact: no
// sum here comes near 2^31).  The accumulator holds rows lane/4 (d[0],
// d[1]) and lane/4 + 8 (d[2], d[3]), columns 2 (lane % 4) and the next.
__device__ __forceinline__ void mma_16832(int (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Columns [k0, k0 + kc) of h_q rows [r0, r0 + mrows) into dst [mrows][kLdH].
// Rows past the block's `rows` valid ones (up to the 16-row tile) repeat
// the last valid row: their products are computed and never used.
__device__ void stage_h(const int8_t* h, int8_t* dst, int r0, int rows,
                        int mrows, int H, int k0, int kc) {
  const int pieces = kc / 16;
  for (int idx = threadIdx.x; idx < mrows * pieces; idx += kThreads) {
    const int r = idx / pieces, p = idx % pieces;
    const int src = r0 + min(r, rows - 1);
    cp_async16(dst + (size_t)r * kLdH + p * 16,
               h + (size_t)src * H + k0 + p * 16);
  }
}

template <typename IO>
__global__ void __launch_bounds__(kThreads, 1)
lstm_int8_kernel(const IO* __restrict__ xp, const int8_t* __restrict__ w_q,
                 const float* __restrict__ scale, IO* __restrict__ ys,
                 int8_t* hbuf, unsigned int* counter, int T, int N, int ld_n,
                 int H, int reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldw = H + 16;
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);            // [kCols][ldw]
  int8_t* ring = w_s + (size_t)kCols * ldw;        // [kStages][kRows][kLdH]
  int* g_s = reinterpret_cast<int*>(ring);         // [kRows][kLdG], reuses
                                                   // the ring after the product
  IO* x_s = reinterpret_cast<IO*>(ring + (size_t)kStages * kRows * kLdH);
  float* deq_s = reinterpret_cast<float*>(x_s + (size_t)kRows * kCols);

  const int tid = threadIdx.x, warp = tid / 32;
  const int n_slices = H / kUnits;
  const int u0 = (blockIdx.x % n_slices) * kUnits;
  const int r0 = (blockIdx.x / n_slices) * kRows;
  const int rows = min(kRows, N - r0);
  const int mrows = (rows + 15) / 16 * 16;
  const int wr = warp % (kRows / kWarpRows) * kWarpRows;   // warp tile
  const int wc = warp / (kRows / kWarpRows) * kWarpCols;
  const bool has_tile = wr < rows;
  const size_t H4 = 4 * (size_t)H;
  const int n_chunks = (H + kChunk - 1) / kChunk;
  constexpr int kPer = 16 / sizeof(IO);               // elements per piece
  constexpr int kPieces = kUnits / kPer;  // 16-byte pieces per (row, gate)

  // the block's gate columns of W_q, [column][k]; their dequant factors
  for (int idx = tid; idx < H * kCols; idx += kThreads) {
    const int k = idx / kCols, col = idx % kCols;
    const int gate = col / kUnits, u = col % kUnits;
    w_s[(size_t)col * ldw + k] =
        w_q[(size_t)k * H4 + (size_t)gate * H + u0 + u];
  }
  if (tid < kCols)
    deq_s[tid] = __fmul_rn(scale[(tid / kUnits) * H + u0 + tid % kUnits],
                           kInv127);
  float c_reg[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) c_reg[i] = 0.0f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int8_t* h_cur = hbuf + (size_t)(s & 1) * N * H;
    int8_t* h_next = hbuf + (size_t)((s + 1) & 1) * N * H;

    // this step's input projections of the block's cells: [row][gate][unit]
    const IO* x_t = xp + ((size_t)t * ld_n + r0) * H4 + u0;
    for (int idx = tid; idx < rows * 4 * kPieces; idx += kThreads) {
      const int n = idx / (4 * kPieces), g = idx / kPieces % 4,
                p = idx % kPieces;
      cp_async16(x_s + n * kCols + g * kUnits + p * kPer,
                 x_t + (size_t)n * H4 + (size_t)g * H + p * kPer);
    }
    cp_async_commit();
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_chunks)
        stage_h(h_cur, ring + (size_t)st * kRows * kLdH, r0, rows, mrows, H,
                st * kChunk, min(kChunk, H - st * kChunk));
      cp_async_commit();
    }

    // acc[i][j]: rows wr + 16 i, columns wc + 8 j of the product
    int acc[kWarpRows / 16][kWarpCols / 8][4] = {};
    for (int c = 0; c < n_chunks; ++c) {
      // chunk c has landed once at most kStages - 2 newer groups are pending
      cp_async_wait<kStages - 2>();
      __syncthreads();
      // refill the buffer that every warp finished with in step c - 1
      const int nc = c + kStages - 1;
      if (nc < n_chunks)
        stage_h(h_cur, ring + (size_t)(nc % kStages) * kRows * kLdH, r0, rows,
                mrows, H, nc * kChunk, min(kChunk, H - nc * kChunk));
      cp_async_commit();
      if (!has_tile) continue;
      const int8_t* a_tile =
          ring + (size_t)(c % kStages) * kRows * kLdH + wr * kLdH;
      const int8_t* b_tile = w_s + (size_t)wc * ldw + c * kChunk;
      const int kc = min(kChunk, H - c * kChunk);
#pragma unroll 4
      for (int kk = 0; kk < kc; kk += 32) {
        uint32_t a[kWarpRows / 16][4], b[kWarpCols / 16][4];
#pragma unroll
        for (int i = 0; i < kWarpRows / 16; ++i)
          load_a8(a[i], a_tile + i * 16 * kLdH + kk, kLdH);
#pragma unroll
        for (int j = 0; j < kWarpCols / 16; ++j)
          load_b8(b[j], b_tile + (size_t)j * 16 * ldw + kk, ldw);
#pragma unroll
        for (int i = 0; i < kWarpRows / 16; ++i)
#pragma unroll
          for (int j = 0; j < kWarpCols / 8; ++j)
            mma_16832(acc[i][j], a[i], b[j / 2][(j % 2) * 2],
                      b[j / 2][(j % 2) * 2 + 1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring: it becomes g_s
    if (has_tile) {
      const int lane = tid % 32;
#pragma unroll
      for (int i = 0; i < kWarpRows / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpCols / 8; ++j) {
          int* g = g_s + (wr + i * 16 + lane / 4) * kLdG + wc + j * 8 +
                   2 * (lane % 4);
          *reinterpret_cast<int2*>(g) = make_int2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<int2*>(g + 8 * kLdG) =
              make_int2(acc[i][j][2], acc[i][j][3]);
        }
    }
    __syncthreads();

    // step s + 1 requantizes h rounded to xp's dtype when s + 1 is even
    const bool round_h = (s & 1) != 0;
    IO* y_t = ys + ((size_t)t * ld_n + r0) * H + u0;
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int idx = tid + i * kThreads;
      const int n = idx / kUnits, u = idx % kUnits;
      if (n >= rows) continue;
      const IO* x = x_s + n * kCols + u;
      const int* g = g_s + n * kLdG + u;
      float gate[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gate[q] = __fadd_rn(to_f32(x[q * kUnits]),
                            __fmul_rn(__int2float_rn(g[q * kUnits]),
                                      deq_s[q * kUnits + u]));
      const float h = cell(gate[0], gate[1], gate[2], gate[3], c_reg[i]);
      const IO hv = from_f32<IO>(h);
      y_t[(size_t)n * H + u] = hv;
      const float hr = round_h ? to_f32(hv) : h;
      const int hq = max(-127, min(127, __float2int_rn(__fmul_rn(hr, 127.0f))));
      h_next[(size_t)(r0 + n) * H + u0 + u] = static_cast<int8_t>(hq);
    }
    grid_barrier(counter, (unsigned int)(s + 1) * gridDim.x);
  }
}

template <typename IO>
int launch(const void* xp, const void* w_q, const void* scale, void* ys,
           void* hbuf, unsigned int* ctr, int T, int N, int ld_n, int H,
           int reverse, cudaStream_t st) {
  const int blocks = H / kUnits * ((N + kRows - 1) / kRows);
  const size_t smem = (size_t)kCols * (H + 16) +
                      (size_t)kStages * kRows * kLdH +
                      (size_t)kRows * kCols * sizeof(IO) + kCols * 4;
  const void* fn = reinterpret_cast<const void*>(&lstm_int8_kernel<IO>);
  int rc = co_resident(fn, smem, blocks, kThreads);
  if (rc != 0) return rc;
  const IO* a0 = static_cast<const IO*>(xp);
  const int8_t* a1 = static_cast<const int8_t*>(w_q);
  const float* a2 = static_cast<const float*>(scale);
  IO* a3 = static_cast<IO*>(ys);
  int8_t* a4 = static_cast<int8_t*>(hbuf);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &ctr, &T, &N, &ld_n, &H, &reverse};
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                     smem, st);
}

}  // namespace

extern "C" {

// xp [T, ld_n, 4H] and ys [T, ld_n, H] point at the first of this launch's
// N <= kGroupRows batch rows, both bf16 (is_bf16) or both f32, contiguous;
// w_q int8 [H, 4H]; scale f32 [4H].  hbuf: int8 [2, N, H] whose first half is
// zero (h_0).  counter: one zeroed uint32.  Returns 0, a cudaError_t, or -1
// (grid cannot be co-resident), -2 (unsupported shape: H must be a multiple
// of 32), -3 (shared-memory request refused: H too large).
int xna_lstm_int8(const void* xp, const void* w_q, const void* scale,
                  void* ys, void* hbuf, void* counter, int T, int N, int ld_n,
                  int H, int reverse, int is_bf16, void* stream) {
  if (T < 1 || N < 1 || N > kGroupRows || ld_n < N || H < 32 || H % 32 != 0)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* ctr = static_cast<unsigned int*>(counter);
  const int rc = is_bf16
      ? launch<bf16>(xp, w_q, scale, ys, hbuf, ctr, T, N, ld_n, H, reverse, st)
      : launch<float>(xp, w_q, scale, ys, hbuf, ctr, T, N, ld_n, H, reverse,
                      st);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

// Batch rows one launch takes; the wrapper splits larger batches.
int xna_lstm_int8_group_rows() { return kGroupRows; }

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
