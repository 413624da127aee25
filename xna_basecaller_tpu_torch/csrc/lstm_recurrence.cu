// K1 and K3a: the LSTM recurrence over precomputed input projections, for
// Hopper.
//
// K1 replaces xna_basecaller_tpu/ops/lstm_pallas.py::lstm_recurrence_pallas
// (kernel body _make_scan_kernel); K3a replaces its trainable forward
// _pallas_fwd_with_cells (kernel body _make_fwd_cells_kernel), which is the
// same recurrence that also writes the cell states cs[t] = c, in xp's dtype,
// as the residuals of the backward (lstm_backward.cu).  One template flag
// (kWriteCells) turns K1 into K3a, so the inference path writes no cells.
// Per step t:
//   gates = xp[t] + h @ W_hh      (f32 accumulation, f32 add)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//   c = f * c + i * g             (c in f32)
//   h = o * tanh(c)               (h kept in xp's dtype: bf16 or f32)
// and ys[t] = h.  With reverse != 0, t runs from T-1 down to 0 inside the
// kernel, so no flipped copies of xp or ys are made.
//
// Bound on the card (flagship, per layer: T=720, N=256, H=768, bf16):
// 2*T*N*H*4H = 0.87 TFLOP over 989 TFLOP/s is 0.88 ms; xp + ys = 1.42 GB
// over 3.35 TB/s is 0.42 ms (K3a: + cs, 0.28 GB more at N=256; at the
// training batch N=64 the product is 0.22 TFLOP, 0.22 ms).  In practice the chain of 720 dependent
// steps dominates: each step is a small [N,H]x[H,4H] product that cannot
// start before the previous step's h is complete everywhere, and every
// block must read all of h_{t-1} for its batch rows from L2.
//
// Design: one persistent cooperative launch per layer.  W_hh (4.5 MB in
// bf16) does not fit one SM, so each block owns a slice of the hidden
// units and keeps their four gate columns of W_hh in shared memory for the
// whole scan.  Each step every block reads h_{t-1} for its batch rows from
// L2, computes its gate columns, updates its cells (f32) and writes its
// slice of h.  h is double buffered in global memory and a grid-wide
// barrier separates the steps; the cooperative launch guarantees that all
// blocks are resident, and the entry point checks occupancy first and
// refuses a grid that cannot be.  Only xp and ys stream through HBM.
//
// bf16 (the main path): a block owns 16 units (64 gate columns, 110 KB of
// W_hh with padding) for one tile of 128 batch rows: 48 x 2 = 96 blocks at
// flagship shapes.  A step reads H x 16 units' worth of h per batch row in
// all, half the L2 traffic of 8-unit slices over the whole batch.  h is
// staged into shared memory 64 columns at a time with cp.async (L2 only)
// through a ring of kStages buffers, so three chunks are in flight while
// the tensor cores work on the oldest.  Each warp owns a 32 x 32 tile of
// the block's [128, 64] gate product and runs mma.sync m16n8k16 (f32
// accumulation) on operands loaded with ldmatrix: WMMA's fragment loads
// compile to 32-bit shared loads, four times the instructions for the
// same bytes.  The cell states stay in registers for the whole scan.
// f32 (the parity mode): a block owns 8 units for all rows (up to 256),
// FMA on the CUDA cores.
//
// A launch takes at most kGroupRows batch rows; the wrapper launches once
// per group of rows (rows are independent), with xp and ys strided by the
// full batch.

#include "lstm_common.cuh"

namespace {

using namespace xna;

constexpr int kThreads = 256;
constexpr int kGroupRows = 256;     // batch rows per launch

// bf16 path
constexpr int kUnits = 16;          // hidden units owned by one block
constexpr int kCols = 4 * kUnits;   // their gate columns, gate-major
constexpr int kRows = 128;          // batch rows of one block
constexpr int kWarpRows = 32;       // each warp: a 32 x 32 tile of the
constexpr int kWarpCols = 32;       // block's [kRows, kCols] product
constexpr int kChunk = 64;          // h columns per pipeline stage
constexpr int kStages = 4;
constexpr int kLdW = kCols + 8;     // padded shared-memory row strides:
constexpr int kLdH = kChunk + 8;    // 144 B rows keep ldmatrix free of
constexpr int kLdG = kCols + 4;     // bank conflicts
constexpr int kCells = kRows * kUnits / kThreads;   // per thread

// f32 path
constexpr int kUnitsF = 8;
constexpr int kColsF = 4 * kUnitsF;
constexpr int kChunkF = 32;         // h columns staged per pass

// One cell: the four gate pre-activations (xp + h @ W, added in f32) and
// the cell state c (updated in place) -> h in f32.
__device__ __forceinline__ float lstm_cell(float gi, float gf, float gg,
                                           float go, float& c) {
  // no contraction into an FMA: the same roundings as the plain version
  c = __fadd_rn(__fmul_rn(sigmoid(gf), c), __fmul_rn(sigmoid(gi), tanhf(gg)));
  return __fmul_rn(sigmoid(go), tanhf(c));
}

// Gate columns of `units` hidden units from u0 into w_s [H][ld]: column
// gate * units + u of row k is w_hh[k, gate * H + u0 + u].
template <typename T>
__device__ void load_w_slice(const T* w_hh, T* w_s, int H, int u0, int units,
                             int ld) {
  const int cols = 4 * units;
  for (int idx = threadIdx.x; idx < H * cols; idx += kThreads) {
    const int k = idx / cols, col = idx % cols;
    const int gate = col / units, u = col % units;
    w_s[(size_t)k * ld + col] = w_hh[(size_t)k * 4 * H + (size_t)gate * H + u0 + u];
  }
}

// Columns [k0, k0 + kc) of h rows [r0, r0 + mrows) into dst [mrows][kLdH].
// Rows past the block's `rows` valid ones (up to the 16-row tile) repeat
// the last valid row: their products are computed and never used.
__device__ void stage_h(const bf16* h, bf16* dst, int r0, int rows,
                        int mrows, int H, int k0, int kc) {
  const int pieces = kc / 8;
  for (int idx = threadIdx.x; idx < mrows * pieces; idx += kThreads) {
    const int r = idx / pieces, p = idx % pieces;
    const int src = r0 + min(r, rows - 1);
    cp_async16(dst + (size_t)r * kLdH + p * 8, h + (size_t)src * H + k0 + p * 8);
  }
}

template <bool kWriteCells>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bf16_kernel(const bf16* __restrict__ xp, const bf16* __restrict__ w_hh,
                 bf16* __restrict__ ys, bf16* __restrict__ cs, bf16* hbuf,
                 unsigned int* counter, int T, int N, int ld_n, int H,
                 int reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);                  // [H][kLdW]
  bf16* ring = w_s + (size_t)H * kLdW;             // [kStages][kRows][kLdH]
  float* g_s = reinterpret_cast<float*>(ring);     // [kRows][kLdG], reuses
                                                   // the ring after the product
  bf16* x_s = ring + (size_t)kStages * kRows * kLdH;         // [kRows][kCols]

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
  constexpr int kPieces = kUnits / 8;     // 16-byte pieces per (row, gate)

  load_w_slice(w_hh, w_s, H, u0, kUnits, kLdW);
  float c_reg[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) c_reg[i] = 0.0f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const bf16* h_cur = hbuf + (size_t)(s & 1) * N * H;
    bf16* h_next = hbuf + (size_t)((s + 1) & 1) * N * H;

    // this step's input projections of the block's cells: [row][gate][unit]
    const bf16* x_t = xp + ((size_t)t * ld_n + r0) * H4 + u0;
    for (int idx = tid; idx < rows * 4 * kPieces; idx += kThreads) {
      const int n = idx / (4 * kPieces), g = idx / kPieces % 4,
                p = idx % kPieces;
      cp_async16(x_s + n * kCols + g * kUnits + p * 8,
                 x_t + (size_t)n * H4 + (size_t)g * H + p * 8);
    }
    cp_async_commit();
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_chunks)
        stage_h(h_cur, ring + (size_t)st * kRows * kLdH, r0, rows, mrows, H,
                st * kChunk, min(kChunk, H - st * kChunk));
      cp_async_commit();
    }

    // acc[i][j]: rows wr + 16 i, columns wc + 8 j of the product
    float acc[kWarpRows / 16][kWarpCols / 8][4] = {};
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
      const bf16* a_tile =
          ring + (size_t)(c % kStages) * kRows * kLdH + wr * kLdH;
      const bf16* b_tile = w_s + (size_t)c * kChunk * kLdW + wc;
      const int kc = min(kChunk, H - c * kChunk);
#pragma unroll 4
      for (int kk = 0; kk < kc; kk += 16) {
        uint32_t a[kWarpRows / 16][4], b[kWarpCols / 16][4];
#pragma unroll
        for (int i = 0; i < kWarpRows / 16; ++i)
          load_a(a[i], a_tile + i * 16 * kLdH + kk, kLdH);
#pragma unroll
        for (int j = 0; j < kWarpCols / 16; ++j)
          load_b(b[j], b_tile + (size_t)kk * kLdW + j * 16, kLdW);
#pragma unroll
        for (int i = 0; i < kWarpRows / 16; ++i)
#pragma unroll
          for (int j = 0; j < kWarpCols / 8; ++j)
            mma_16816(acc[i][j], a[i], b[j / 2][(j % 2) * 2],
                      b[j / 2][(j % 2) * 2 + 1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring: it becomes g_s
    if (has_tile) {
      // accumulator layout of m16n8: rows lane/4 and lane/4 + 8, columns
      // 2 (lane % 4) and the next
      const int lane = tid % 32;
#pragma unroll
      for (int i = 0; i < kWarpRows / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpCols / 8; ++j) {
          float* g = g_s + (wr + i * 16 + lane / 4) * kLdG + wc + j * 8 +
                     2 * (lane % 4);
          *reinterpret_cast<float2*>(g) = make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(g + 8 * kLdG) =
              make_float2(acc[i][j][2], acc[i][j][3]);
        }
    }
    __syncthreads();

    bf16* y_t = ys + ((size_t)t * ld_n + r0) * H + u0;
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      const int idx = tid + i * kThreads;
      const int n = idx / kUnits, u = idx % kUnits;
      if (n >= rows) continue;
      const bf16* x = x_s + n * kCols + u;
      const float* g = g_s + n * kLdG + u;
      const bf16 hv = __float2bfloat16_rn(lstm_cell(
          __bfloat162float(x[0]) + g[0],
          __bfloat162float(x[kUnits]) + g[kUnits],
          __bfloat162float(x[2 * kUnits]) + g[2 * kUnits],
          __bfloat162float(x[3 * kUnits]) + g[3 * kUnits], c_reg[i]));
      h_next[(size_t)(r0 + n) * H + u0 + u] = hv;
      y_t[(size_t)n * H + u] = hv;
      if (kWriteCells)
        cs[((size_t)t * ld_n + r0 + n) * H + u0 + u] =
            __float2bfloat16_rn(c_reg[i]);
    }
    grid_barrier(counter, (unsigned int)(s + 1) * gridDim.x);
  }
}

template <bool kWriteCells>
__global__ void __launch_bounds__(kThreads)
lstm_f32_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                float* __restrict__ ys, float* __restrict__ cs, float* hbuf,
                unsigned int* counter, int T, int N, int ld_n, int H,
                int reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);        // [H][kColsF]
  float* g_s = w_s + (size_t)H * kColsF;              // [N][kColsF]
  float* c_s = g_s + (size_t)N * kColsF;              // [N][kUnitsF]
  float* h_s = c_s + (size_t)N * kUnitsF;             // [kThreads][chunk+1]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kUnitsF;
  const size_t H4 = 4 * (size_t)H;

  load_w_slice(w_hh, w_s, H, u0, kUnitsF, kColsF);
  for (int idx = tid; idx < N * kUnitsF; idx += kThreads) c_s[idx] = 0.0f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* h_cur = hbuf + (size_t)(s & 1) * N * H;
    float* h_next = hbuf + (size_t)((s + 1) & 1) * N * H;

    // each thread owns one batch row and all kColsF columns
    for (int r0 = 0; r0 < N; r0 += kThreads) {
      float acc[kColsF];
#pragma unroll
      for (int c = 0; c < kColsF; ++c) acc[c] = 0.0f;
      for (int k0 = 0; k0 < H; k0 += kChunkF) {
        __syncthreads();
        for (int idx = tid; idx < kThreads * kChunkF; idx += kThreads) {
          const int rr = idx / kChunkF, kk = idx % kChunkF;
          const int n = r0 + rr, k = k0 + kk;
          h_s[rr * (kChunkF + 1) + kk] =
              (n < N && k < H) ? __ldcg(h_cur + (size_t)n * H + k) : 0.0f;
        }
        __syncthreads();
        const int kmax = min(kChunkF, H - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          const float hv = h_s[tid * (kChunkF + 1) + kk];
          const float* w = w_s + (size_t)(k0 + kk) * kColsF;
#pragma unroll
          for (int c = 0; c < kColsF; ++c) acc[c] = fmaf(hv, w[c], acc[c]);
        }
      }
      if (r0 + tid < N) {
#pragma unroll
        for (int c = 0; c < kColsF; ++c)
          g_s[(size_t)(r0 + tid) * kColsF + c] = acc[c];
      }
    }
    __syncthreads();

    const float* x_t = xp + (size_t)t * ld_n * H4 + u0;
    float* y_t = ys + (size_t)t * ld_n * H + u0;
    for (int idx = tid; idx < N * kUnitsF; idx += kThreads) {
      const int n = idx / kUnitsF, u = idx % kUnitsF;
      const float* x = x_t + (size_t)n * H4 + u;
      const float* g = g_s + (size_t)n * kColsF + u;
      const float hv = lstm_cell(
          x[0] + g[0], x[H] + g[kUnitsF], x[2 * H] + g[2 * kUnitsF],
          x[3 * H] + g[3 * kUnitsF], c_s[idx]);
      h_next[(size_t)n * H + u0 + u] = hv;
      y_t[(size_t)n * H + u] = hv;
      if (kWriteCells) cs[((size_t)t * ld_n + n) * H + u0 + u] = c_s[idx];
    }
    grid_barrier(counter, (unsigned int)(s + 1) * gridDim.x);
  }
}

}  // namespace

extern "C" {

// xp [T, ld_n, 4H] and ys [T, ld_n, H] point at the first of this launch's
// N <= kGroupRows batch rows; w_hh [H, 4H]; all of one dtype (bf16 when
// is_bf16, else f32), contiguous.  cs: null for K1; for K3a, [T, ld_n, H]
// of that dtype like ys, which receives the cell states.  hbuf: [2, N, H]
// of that dtype whose first half is zero (h_0).  counter: one zeroed
// uint32.  Returns 0, a cudaError_t, or -1 (grid cannot be co-resident),
// -2 (unsupported shape), -3 (shared-memory request refused: H too large).
int xna_lstm_recurrence(const void* xp, const void* w_hh, void* ys, void* cs,
                        void* hbuf, void* counter, int T, int N, int ld_n,
                        int H, int reverse, int is_bf16, void* stream) {
  if (T < 1 || N < 1 || N > kGroupRows || ld_n < N || H < 16 || H % 16 != 0)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* ctr = static_cast<unsigned int*>(counter);
  int rc;
  if (is_bf16) {
    const int blocks = H / kUnits * ((N + kRows - 1) / kRows);
    const size_t smem = (size_t)H * kLdW * 2 +
                        (size_t)kStages * kRows * kLdH * 2 +
                        (size_t)kRows * kCols * 2;
    const void* fn = cs ? reinterpret_cast<const void*>(&lstm_bf16_kernel<true>)
                        : reinterpret_cast<const void*>(&lstm_bf16_kernel<false>);
    if ((rc = co_resident(fn, smem, blocks, kThreads)) != 0) return rc;
    const bf16* a0 = static_cast<const bf16*>(xp);
    const bf16* a1 = static_cast<const bf16*>(w_hh);
    bf16* a2 = static_cast<bf16*>(ys);
    bf16* a3 = static_cast<bf16*>(cs);
    bf16* a4 = static_cast<bf16*>(hbuf);
    void* args[] = {&a0, &a1, &a2, &a3, &a4, &ctr, &T, &N, &ld_n, &H,
                    &reverse};
    rc = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                     smem, st);
  } else {
    const int blocks = H / kUnitsF;
    const size_t smem = (size_t)H * kColsF * 4 + (size_t)N * kColsF * 4 +
                        (size_t)N * kUnitsF * 4 +
                        (size_t)kThreads * (kChunkF + 1) * 4;
    const void* fn = cs ? reinterpret_cast<const void*>(&lstm_f32_kernel<true>)
                        : reinterpret_cast<const void*>(&lstm_f32_kernel<false>);
    if ((rc = co_resident(fn, smem, blocks, kThreads)) != 0) return rc;
    const float* a0 = static_cast<const float*>(xp);
    const float* a1 = static_cast<const float*>(w_hh);
    float* a2 = static_cast<float*>(ys);
    float* a3 = static_cast<float*>(cs);
    float* a4 = static_cast<float*>(hbuf);
    void* args[] = {&a0, &a1, &a2, &a3, &a4, &ctr, &T, &N, &ld_n, &H,
                    &reverse};
    rc = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                     smem, st);
  }
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

// Batch rows one launch takes; the wrapper splits larger batches.
int xna_lstm_group_rows() { return kGroupRows; }

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
