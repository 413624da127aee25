// K3b: the analytic LSTM backward recursion, for Hopper.
//
// Replaces xna_basecaller_tpu/ops/lstm_pallas.py::_pallas_bwd_dxp (kernel
// body _make_bwd_kernel), the backward of lstm_recurrence_trainable.  It
// walks the steps of the forward (lstm_recurrence.cu, K3a) in reverse;
// with s the forward's step index, t its time index and p the step before
// it (h_p = c_p = 0 at the first step):
//   gates = xp[t] + h_p @ W_hh      (recomputed; i, f, g, o)
//   dh = dy[t] + dh_c,  tc = tanh(c[t]),  do = dh * tc
//   dc = dh * o * (1 - tc^2) + dc_c
//   dgates = [dc*g * i(1-i), dc*c_p * f(1-f), dc*i * (1-g^2), do * o(1-o)]
//   dxp[t] = dgates;  dh_c = dgates @ W_hh^T;  dc_c = dc * f
// (lstm_pallas.py:435-458).  All the arithmetic is in f32; dgates and the
// operands of the two products are in the compute dtype (bf16 in training;
// f32 is the parity mode).  dW = sum_t h_p^T dgates is one matrix product
// outside this file (ops/lstm_cuda.py), as it is outside the Pallas kernel.
//
// Bound on the card (training shapes, per layer: T=720, N=64, H=768, bf16):
// the recompute and the carry are 2 x 2*T*N*H*4H = 0.43 TFLOP, 0.44 ms at
// 989 TFLOP/s; the bytes are dy, h, c (3 x [T,N,H]), xp and dxp
// (2 x [T,N,4H]), 0.78 GB, 0.23 ms at 3.35 TB/s.  As in the forward, the
// 720 dependent steps dominate: the carry dh_c of a step needs all 4H
// columns of the step's dgates, from every block, before the next step.
//
// Design: two kernels per launch.
// 1. The gate recompute does not depend on the carry, so it runs first as
//    one parallel product over all T*N rows ([T*N, H] x [H, 4H], mma.sync
//    on bf16, f32 accumulation), adds xp and applies the nonlinearities,
//    and stores the activated gates in f32 (the plain version's precision).
//    This takes the recompute off the serial chain and leaves each block
//    of the serial kernel one slice of W_hh instead of two.
// 2. The serial recursion: one persistent cooperative launch, like K1.  A
//    block owns 16 hidden units for 64 batch rows (48 blocks at N=64) and
//    keeps W_hh[its 16 rows, :] (96 KB in bf16) in shared memory.  Each
//    step it forms its 64 dgates columns from the carry and the step's
//    inputs (loaded into registers before the carry's product, which hides
//    their latency), writes them to dxp and to a double-buffered dgates
//    row buffer, and passes a grid barrier; then it reads the full dgates
//    rows of its batch rows from L2 (64 columns per cp.async stage, four
//    stages in flight) and forms its 16 units of dh_c with mma.sync: the
//    eight warps split the 64 rows in four tiles and each chunk's depth in
//    two halves, and the two partial sums are added in the cell update.
//    dc_c stays in registers.
// f32 (the parity mode): the recompute is a tiled FMA product, and a
// serial block owns 8 units for all rows (up to 256), FMA on the CUDA
// cores, dgates staged through shared memory 64 columns at a time.
//
// A launch takes at most 128 (bf16) or 256 (f32) batch rows; the wrapper
// launches once per group of rows, with every tensor strided by the full
// batch.

#include "lstm_common.cuh"

namespace {

using namespace xna;

constexpr int kThreads = 256;

// gate recompute, bf16: a block computes [128 rows, 64 columns], each warp a
// 32 x 32 tile, through a ring of 3 chunks of 64 of the depth H
constexpr int kGRows = 128;
constexpr int kGCols = 64;
constexpr int kGChunk = 64;
constexpr int kGStages = 3;
constexpr int kGLdA = kGChunk + 8;   // 144 B rows: ldmatrix without bank
constexpr int kGLdB = kGCols + 8;    // conflicts

// serial recursion, bf16
constexpr int kUnits = 16;           // hidden units owned by one block
constexpr int kRows = 64;            // batch rows of one block
constexpr int kGroupRows = 128;      // batch rows of one launch
constexpr int kChunk = 64;           // dgates columns per pipeline stage
constexpr int kStages = 4;
constexpr int kLd = kChunk + 8;
constexpr int kCells = kRows * kUnits / kThreads;   // per thread

// f32 path
constexpr int kUnitsF = 8;
constexpr int kGroupRowsF = 256;
constexpr int kChunkF = 64;
constexpr int kCellsF = kGroupRowsF * kUnitsF / kThreads;

__device__ __forceinline__ float activate(float v, int col, int H) {
  return col / H == 2 ? tanhf(v) : sigmoid(v);
}

// The step before time t in the forward's walk, or -1 at its first step.
__device__ __forceinline__ int prev_time(int t, int T, int reverse) {
  return reverse ? (t == T - 1 ? -1 : t + 1) : t - 1;
}

__global__ void __launch_bounds__(kThreads)
gates_bf16_kernel(const bf16* __restrict__ xp, const bf16* __restrict__ ys,
                  const bf16* __restrict__ w_hh, float* __restrict__ act,
                  int T, int N, int ld_n, int H, int reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);       // [kGStages][kGRows][kGLdA]
  bf16* b_s = a_s + (size_t)kGStages * kGRows * kGLdA;  // [.][kGChunk][kGLdB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * kGCols;
  const long m0 = (long)blockIdx.y * kGRows;
  const long M = (long)T * N;
  const size_t H4 = 4 * (size_t)H;
  const int wr = warp % 4 * 32, wc = warp / 4 * 32;
  const int n_chunks = (H + kGChunk - 1) / kGChunk;

  // chunk c of the depth: h_p rows (zero at the first step and past M) and
  // the matching rows of W_hh's 64 columns
  auto stage = [&](int c) {
    const int k0 = c * kGChunk, kc = min(kGChunk, H - k0), pieces = kc / 8;
    bf16* a_dst = a_s + (size_t)(c % kGStages) * kGRows * kGLdA;
    for (int idx = tid; idx < kGRows * pieces; idx += kThreads) {
      const int r = idx / pieces, p = idx % pieces;
      const long m = m0 + r;
      const bf16* src = ys;
      int bytes = 0;
      if (m < M) {
        const int tp = prev_time((int)(m / N), T, reverse);
        if (tp >= 0) {
          src = ys + ((size_t)tp * ld_n + m % N) * H + k0 + p * 8;
          bytes = 16;
        }
      }
      cp_async16_zfill(a_dst + (size_t)r * kGLdA + p * 8, src, bytes);
    }
    bf16* b_dst = b_s + (size_t)(c % kGStages) * kGChunk * kGLdB;
    for (int idx = tid; idx < kc * (kGCols / 8); idx += kThreads) {
      const int k = idx / (kGCols / 8), p = idx % (kGCols / 8);
      cp_async16(b_dst + (size_t)k * kGLdB + p * 8,
                 w_hh + (size_t)(k0 + k) * H4 + c0 + p * 8);
    }
  };

  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < n_chunks) stage(st);
    cp_async_commit();
  }
  float acc[2][4][4] = {};
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    if (c + kGStages - 1 < n_chunks) stage(c + kGStages - 1);
    cp_async_commit();
    const bf16* a_tile = a_s + (size_t)(c % kGStages) * kGRows * kGLdA +
                         wr * kGLdA;
    const bf16* b_tile = b_s + (size_t)(c % kGStages) * kGChunk * kGLdB + wc;
    const int kc = min(kGChunk, H - c * kGChunk);
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a(a[i], a_tile + i * 16 * kGLdA + kk, kGLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) load_b(b[j], b_tile + (size_t)kk * kGLdB + j * 16, kGLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_16816(acc[i][j], a[i], b[j / 2][(j % 2) * 2],
                    b[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long m = m0 + wr + i * 16 + lane / 4 + half * 8;
      if (m >= M) continue;
      const size_t row = (size_t)(m / N) * ld_n + m % N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + wc + j * 8 + 2 * (lane % 4) + e;
          const size_t off = row * H4 + col;
          act[off] = activate(acc[i][j][half * 2 + e] + __bfloat162float(xp[off]),
                              col, H);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
gates_f32_kernel(const float* __restrict__ xp, const float* __restrict__ ys,
                 const float* __restrict__ w_hh, float* __restrict__ act,
                 int T, int N, int ld_n, int H, int reverse) {
  __shared__ float a_s[64][17];
  __shared__ float b_s[16][64];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c0 = blockIdx.x * 64;
  const long m0 = (long)blockIdx.y * 64;
  const long M = (long)T * N;
  const size_t H4 = 4 * (size_t)H;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < H; k0 += 16) {
    for (int idx = tid; idx < 64 * 16; idx += kThreads) {
      const int r = idx / 16, kk = idx % 16;
      const long m = m0 + r;
      float v = 0.0f;
      if (m < M) {
        const int tp = prev_time((int)(m / N), T, reverse);
        if (tp >= 0) v = ys[((size_t)tp * ld_n + m % N) * H + k0 + kk];
      }
      a_s[r][kk] = v;
    }
    for (int idx = tid; idx < 16 * 64; idx += kThreads) {
      const int kk = idx / 64, c = idx % 64;
      b_s[kk][c] = w_hh[(size_t)(k0 + kk) * H4 + c0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = a_s[ty * 4 + i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(a, b_s[kk][tx * 4 + j], acc[i][j]);
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const size_t row = (size_t)(m / N) * ld_n + m % N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      act[row * H4 + col] = activate(acc[i][j] + xp[row * H4 + col], col, H);
    }
  }
}

// One cell of the reverse step, in the op order of the plain version (no
// contraction into FMAs).  a: activated i, f, g, o; dh_c, dc_c: the carries
// (dc_c is updated); writes the four dgates to d.
__device__ __forceinline__ void cell_backward(const float (&a)[4], float dy,
                                              float c_t, float c_p, float dh_c,
                                              float& dc_c, float (&d)[4]) {
  const float i = a[0], f = a[1], g = a[2], o = a[3];
  const float tc = tanhf(c_t);
  const float dh = __fadd_rn(dy, dh_c);
  const float d_o = __fmul_rn(dh, tc);
  const float dc = __fadd_rn(
      __fmul_rn(__fmul_rn(dh, o), __fsub_rn(1.0f, __fmul_rn(tc, tc))), dc_c);
  d[0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, g), i), __fsub_rn(1.0f, i));
  d[1] = __fmul_rn(__fmul_rn(__fmul_rn(dc, c_p), f), __fsub_rn(1.0f, f));
  d[2] = __fmul_rn(__fmul_rn(dc, i), __fsub_rn(1.0f, __fmul_rn(g, g)));
  d[3] = __fmul_rn(__fmul_rn(d_o, o), __fsub_rn(1.0f, o));
  dc_c = __fmul_rn(dc, f);
}

// kChunk columns from k0 of rows [r0, r0 + mrows) of src (row stride ld)
// into dst [mrows][kLd]; rows past the valid `rows` repeat the last one.
__device__ void stage_rows(const bf16* src, bf16* dst, int r0, int rows,
                           int mrows, size_t ld, int k0) {
  constexpr int kPieces = kChunk / 8;
  for (int idx = threadIdx.x; idx < mrows * kPieces; idx += kThreads) {
    const int r = idx / kPieces, p = idx % kPieces;
    cp_async16(dst + (size_t)r * kLd + p * 8,
               src + (size_t)(r0 + min(r, rows - 1)) * ld + k0 + p * 8);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_bf16_kernel(const float* __restrict__ act,
                     const bf16* __restrict__ dys, const bf16* __restrict__ cs,
                     const bf16* __restrict__ w_hh, bf16* __restrict__ dxp,
                     bf16* dgbuf, unsigned int* counter, int T, int N,
                     int ld_n, int H, int reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H4 = 4 * H, ldw = H4 + 8;
  bf16* wt_s = reinterpret_cast<bf16*>(smem);          // [kUnits][ldw]
  bf16* ring = wt_s + (size_t)kUnits * ldw;            // [kStages][kRows][kLd]
  float* red_s = reinterpret_cast<float*>(
      ring + (size_t)kStages * kRows * kLd);           // [2][kRows][kUnits]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_slices = H / kUnits;
  const int u0 = (blockIdx.x % n_slices) * kUnits;
  const int r0 = (blockIdx.x / n_slices) * kRows;
  const int rows = min(kRows, N - r0);
  const int mrows = (rows + 15) / 16 * 16;
  const int rt = warp % 4, kp = warp / 4;   // row tile, half of each chunk
  const bool has_tile = rt * 16 < rows;
  const int n_chunks = H4 / kChunk;

  // W_hh rows u0.. (contiguous) are the n-major B operand of dgates @ W^T
  for (int idx = tid; idx < kUnits * H4; idx += kThreads) {
    const int u = idx / H4, k = idx % H4;
    wt_s[(size_t)u * ldw + k] = w_hh[(size_t)(u0 + u) * H4 + k];
  }
  float dc_c[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) dc_c[i] = 0.0f;
  __syncthreads();

  for (int s = T - 1; s >= 0; --s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = prev_time(t, T, reverse);
    // the step's inputs of the thread's cells, loaded before the carry's
    // product so that their latency hides behind it
    float a[kCells][4], dy[kCells], c_t[kCells], c_p[kCells];
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int idx = tid + i * kThreads, n = min(idx / kUnits, rows - 1),
                u = idx % kUnits;
      const size_t row = (size_t)t * ld_n + r0 + n;
#pragma unroll
      for (int g = 0; g < 4; ++g) a[i][g] = act[row * H4 + g * H + u0 + u];
      dy[i] = __bfloat162float(dys[row * H + u0 + u]);
      c_t[i] = __bfloat162float(cs[row * H + u0 + u]);
      c_p[i] = tp >= 0 ? __bfloat162float(
                             cs[((size_t)tp * ld_n + r0 + n) * H + u0 + u])
                       : 0.0f;
    }

    if (s < T - 1) {   // dh_c = dgates of the step after @ W^T, 16 units
      const bf16* dg = dgbuf + (size_t)((s + 1) & 1) * N * H4;
      for (int st = 0; st < kStages - 1; ++st) {
        if (st < n_chunks)
          stage_rows(dg, ring + (size_t)st * kRows * kLd, r0, rows, mrows, H4,
                     st * kChunk);
        cp_async_commit();
      }
      float acc[2][4] = {};
      for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const int nc = c + kStages - 1;
        if (nc < n_chunks)
          stage_rows(dg, ring + (size_t)(nc % kStages) * kRows * kLd, r0, rows,
                     mrows, H4, nc * kChunk);
        cp_async_commit();
        if (!has_tile) continue;
        const bf16* a_tile = ring + (size_t)(c % kStages) * kRows * kLd +
                             rt * 16 * kLd;
#pragma unroll
        for (int kk = kp * 32; kk < kp * 32 + 32; kk += 16) {
          uint32_t fa[4], fb[4];
          load_a(fa, a_tile + kk, kLd);
          load_b_nk(fb, wt_s + c * kChunk + kk, ldw);
          mma_16816(acc[0], fa, fb[0], fb[1]);
          mma_16816(acc[1], fa, fb[2], fb[3]);
        }
      }
      cp_async_wait<0>();
      if (has_tile) {
        float* red = red_s + kp * kRows * kUnits;
        const int r = rt * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = j * 8 + 2 * (lane % 4);
          red[r * kUnits + col] = acc[j][0];
          red[r * kUnits + col + 1] = acc[j][1];
          red[(r + 8) * kUnits + col] = acc[j][2];
          red[(r + 8) * kUnits + col + 1] = acc[j][3];
        }
      }
      __syncthreads();
    }

    bf16* dg_out = dgbuf + (size_t)(s & 1) * N * H4;
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int idx = tid + i * kThreads, n = idx / kUnits, u = idx % kUnits;
      if (n >= rows) continue;
      const float dh_c = s < T - 1 ? red_s[n * kUnits + u] +
                                         red_s[(kRows + n) * kUnits + u]
                                   : 0.0f;
      float d[4];
      cell_backward(a[i], dy[i], c_t[i], c_p[i], dh_c, dc_c[i], d);
      bf16* dx = dxp + ((size_t)t * ld_n + r0 + n) * H4 + u0 + u;
      bf16* dgo = dg_out + (size_t)(r0 + n) * H4 + u0 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const bf16 v = __float2bfloat16_rn(d[g]);
        dx[g * H] = v;
        dgo[g * H] = v;
      }
    }
    grid_barrier(counter, (unsigned int)(T - s) * gridDim.x);
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_bwd_f32_kernel(const float* __restrict__ act,
                    const float* __restrict__ dys, const float* __restrict__ cs,
                    const float* __restrict__ w_hh, float* __restrict__ dxp,
                    float* dgbuf, unsigned int* counter, int T, int N, int ld_n,
                    int H, int reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H4 = 4 * H;
  float* wt_s = reinterpret_cast<float*>(smem);        // [H4][kUnitsF]
  float* dg_s = wt_s + (size_t)H4 * kUnitsF;           // [N][kChunkF + 1]
  const int tid = threadIdx.x, u0 = blockIdx.x * kUnitsF;

  for (int idx = tid; idx < H4 * kUnitsF; idx += kThreads) {
    const int k = idx / kUnitsF, u = idx % kUnitsF;
    wt_s[idx] = w_hh[(size_t)(u0 + u) * H4 + k];
  }
  float dc_c[kCellsF];
#pragma unroll
  for (int j = 0; j < kCellsF; ++j) dc_c[j] = 0.0f;
  __syncthreads();

  for (int s = T - 1; s >= 0; --s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = prev_time(t, T, reverse);
    // the thread's cells are (n, u) = divmod(tid + j * kThreads, kUnitsF)
    float dh_c[kCellsF] = {};
    if (s < T - 1) {
      const float* dg = dgbuf + (size_t)((s + 1) & 1) * N * H4;
      for (int k0 = 0; k0 < H4; k0 += kChunkF) {
        for (int idx = tid; idx < N * kChunkF; idx += kThreads) {
          const int n = idx / kChunkF, kk = idx % kChunkF;
          dg_s[n * (kChunkF + 1) + kk] = __ldcg(dg + (size_t)n * H4 + k0 + kk);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kCellsF; ++j) {
          const int idx = tid + j * kThreads;
          if (idx >= N * kUnitsF) continue;
          const float* row = dg_s + (idx / kUnitsF) * (kChunkF + 1);
          const float* w = wt_s + (size_t)k0 * kUnitsF + idx % kUnitsF;
          float acc = dh_c[j];
          for (int kk = 0; kk < kChunkF; ++kk)
            acc = fmaf(row[kk], w[kk * kUnitsF], acc);
          dh_c[j] = acc;
        }
        __syncthreads();
      }
    }
    float* dg_out = dgbuf + (size_t)(s & 1) * N * H4;
#pragma unroll
    for (int j = 0; j < kCellsF; ++j) {
      const int idx = tid + j * kThreads;
      if (idx >= N * kUnitsF) continue;
      const int n = idx / kUnitsF, u = idx % kUnitsF;
      const size_t row = (size_t)t * ld_n + n;
      float a[4], d[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) a[g] = act[row * H4 + g * H + u0 + u];
      const float c_p =
          tp >= 0 ? cs[((size_t)tp * ld_n + n) * H + u0 + u] : 0.0f;
      cell_backward(a, dys[row * H + u0 + u], cs[row * H + u0 + u], c_p,
                    dh_c[j], dc_c[j], d);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dxp[row * H4 + g * H + u0 + u] = d[g];
        dg_out[(size_t)n * H4 + g * H + u0 + u] = d[g];
      }
    }
    grid_barrier(counter, (unsigned int)(T - s) * gridDim.x);
  }
}

}  // namespace

extern "C" {

// xp [T, ld_n, 4H], ys, cs, dys [T, ld_n, H] point at the first of this
// launch's N batch rows (N <= xna_lstm_backward_group_rows); w_hh [H, 4H];
// all of one dtype (bf16 when is_bf16, else f32), contiguous.  ys and cs
// are the forward's outputs (K3a), dys the gradient of ys.  Scratch: act
// [T, ld_n, 4H] f32 like xp (the activated gates), dgbuf [2, N, 4H] of the
// dtype, counter one zeroed uint32.  Writes dxp [T, ld_n, 4H] of the dtype.
// Returns 0, a cudaError_t, or -1 (grid cannot be co-resident), -2
// (unsupported shape), -3 (shared-memory request refused: H too large).
int xna_lstm_backward(const void* xp, const void* ys, const void* cs,
                      const void* dys, const void* w_hh, void* act, void* dxp,
                      void* dgbuf, void* counter, int T, int N, int ld_n,
                      int H, int reverse, int is_bf16, void* stream) {
  const int group = is_bf16 ? kGroupRows : kGroupRowsF;
  const long M = (long)T * N;
  if (T < 1 || N < 1 || N > group || ld_n < N || H < 16 || H % 16 != 0 ||
      (M + 63) / 64 > 65535)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* ctr = static_cast<unsigned int*>(counter);
  float* a_act = static_cast<float*>(act);
  int rc;
  if (is_bf16) {
    const bf16* a_xp = static_cast<const bf16*>(xp);
    const bf16* a_ys = static_cast<const bf16*>(ys);
    const bf16* a_cs = static_cast<const bf16*>(cs);
    const bf16* a_dys = static_cast<const bf16*>(dys);
    const bf16* a_w = static_cast<const bf16*>(w_hh);
    bf16* a_dxp = static_cast<bf16*>(dxp);
    bf16* a_dg = static_cast<bf16*>(dgbuf);
    const size_t smem_g = (size_t)kGStages * (kGRows * kGLdA + kGChunk * kGLdB) * 2;
    if (cudaFuncSetAttribute(gates_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_g) != cudaSuccess) {
      cudaGetLastError();
      return -3;
    }
    gates_bf16_kernel<<<dim3(H / 16, (unsigned)((M + kGRows - 1) / kGRows)),
                        kThreads, smem_g, st>>>(a_xp, a_ys, a_w, a_act, T, N,
                                                ld_n, H, reverse);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    const int blocks = H / kUnits * ((N + kRows - 1) / kRows);
    const size_t smem = (size_t)kUnits * (4 * H + 8) * 2 +
                        (size_t)kStages * kRows * kLd * 2 +
                        (size_t)2 * kRows * kUnits * 4;
    const void* fn = reinterpret_cast<const void*>(&lstm_bwd_bf16_kernel);
    if ((rc = co_resident(fn, smem, blocks, kThreads)) != 0) return rc;
    void* args[] = {&a_act, &a_dys, &a_cs, &a_w, &a_dxp, &a_dg, &ctr,
                    &T, &N, &ld_n, &H, &reverse};
    rc = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                     smem, st);
  } else {
    const float* a_xp = static_cast<const float*>(xp);
    const float* a_ys = static_cast<const float*>(ys);
    const float* a_cs = static_cast<const float*>(cs);
    const float* a_dys = static_cast<const float*>(dys);
    const float* a_w = static_cast<const float*>(w_hh);
    float* a_dxp = static_cast<float*>(dxp);
    float* a_dg = static_cast<float*>(dgbuf);
    gates_f32_kernel<<<dim3(H / 16, (unsigned)((M + 63) / 64)), kThreads, 0,
                       st>>>(a_xp, a_ys, a_w, a_act, T, N, ld_n, H, reverse);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    const int blocks = H / kUnitsF;
    const size_t smem = (size_t)4 * H * kUnitsF * 4 +
                        (size_t)N * (kChunkF + 1) * 4;
    const void* fn = reinterpret_cast<const void*>(&lstm_bwd_f32_kernel);
    if ((rc = co_resident(fn, smem, blocks, kThreads)) != 0) return rc;
    void* args[] = {&a_act, &a_dys, &a_cs, &a_w, &a_dxp, &a_dg, &ctr,
                    &T, &N, &ld_n, &H, &reverse};
    rc = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                     smem, st);
  }
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

// Batch rows one launch takes; the wrapper splits larger batches.
int xna_lstm_backward_group_rows(int is_bf16) {
  return is_bf16 ? kGroupRows : kGroupRowsF;
}

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
