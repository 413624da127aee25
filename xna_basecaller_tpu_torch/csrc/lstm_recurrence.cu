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
// over 3.35 TB/s is 0.42 ms (K3a at the training batch N=64: 0.22 ms).
// What bounds it is the chain of 720 dependent steps: each step is a small
// [N,H]x[H,4H] product that cannot start before the previous step's h is
// complete, and W_hh (4.5 MB in bf16) fits no SM, so every step crosses
// SMs: h goes out to L2 and comes back.  The time per step is a sum of
// latencies (a flag or barrier round trip, L2 to shared memory, the
// product, the cell update and its stores), not of bandwidth.
//
// One persistent launch per layer (per group of batch rows); each CTA owns
// a slice of the hidden units, keeps their four gate columns of W_hh in
// shared memory for the whole scan and their cells in registers; h is
// double buffered in global memory; only xp, ys (and cs) stream through
// HBM.  The entry point checks that the whole grid can be resident and
// refuses one that cannot.  Two bf16 designs, chosen from the shape:
//
// N <= 64 and H % 32 == 0 (K3a at the training batch, K1 on the validation
// batch): lstm_bf16_cluster_kernel.  The first design (the tiled one below
// at every N) spent 12.2 us a step at N=64 (H100, T=720, H=768): a fit of
// 8.2 us fixed + 61 ns a row, of which a grid barrier alone is 1.3 us; 48
// blocks on 132 SMs and 4 of 8 warps idle at 64 rows.  Here the CTAs come
// in clusters of 2 that share 16 units: each holds the W_hh rows of half
// the depth H (48 KB) and stages only that half of h, and the two partial
// [64, 64] gate tiles are added through distributed shared memory (each
// CTA then updates 8 units' cells): 96 CTAs, every warp busy at 64 rows.
// In place of the grid barrier each warp adds one to its CTA's ready flag
// after its h stores (a release), and a CTA waits only for the 48
// producers of the half of h it reads; xp is loaded a step ahead.  7.8 us
// a step at N=64; switching off each part in turn saves: the flag wait
// 1.9 us, the staging 1.3, the product 2.0, the cluster exchange 1.4
// (they overlap, so they do not add up).
//
// N > 64 (K1 at the basecall batch, 128-row tiles): lstm_bf16_kernel, the
// first design, kept because four clustered launches of 64 rows take
// twice its time at N=256.  A block owns 16 units (110 KB of W_hh with
// padding) for one tile of 128 batch rows: 96 blocks at N=256; h is staged
// 64 columns at a time through a cp.async ring; each warp owns a 32 x 32
// tile of the [128, 64] gate product; a grid barrier separates the steps.
//
// Both run mma.sync m16n8k16 (f32 accumulation) on operands loaded with
// ldmatrix.  For the clustered product wgmma, clusters of 4, four staging
// chunks and W_hh held in registers were tried and were slower at these
// shapes (one [64, 64] tile a CTA a step).  f32 (the parity mode): a
// block owns 8 units for all rows (up to 256), FMA on the CUDA cores, a
// grid barrier.
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

// bf16 path at N <= kCRows: clusters of two CTAs
constexpr int kCUnits = 16;         // hidden units of one cluster
constexpr int kCCluster = 2;        // CTAs of a cluster, one depth slice each
constexpr int kCOwn = kCUnits / kCCluster;   // units whose cells a CTA updates
constexpr int kCRows = 64;          // batch rows
constexpr int kCCols = 4 * kCUnits; // the cluster's gate columns, gate-major
constexpr int kCLdW = kCCols + 8;
constexpr int kCLdP = kCCols + 4;   // row stride of the partial gate tiles

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

// The bf16 path for N <= kCRows rows (the training batch, the validation
// batch): CTA b owns the cells of units [8b, 8b + 8); the 2 CTAs of
// cluster q hold the 64 gate columns of units [16q, 16q + 16) between
// them, CTA `rank` the W_hh rows of depth slice `rank` (h columns
// [rank H/2, (rank + 1) H/2), the output of the F = H/16 CTAs that own
// those units).  Step s of CTA b:
//   1. take its cells' xp[t] (loaded a step ahead) and load xp[t + 1];
//   2. (s > 0) wait until the flags of its slice's producers count s steps,
//      stage h_s [rows, H/2] of the slice with cp.async, form the partial
//      gates [rows, 64] with mma.sync (every warp a 16 x 32 tile); after a
//      cluster barrier add the two partials of its cells' gate columns
//      from the cluster's shared memory, in rank order;
//   3. the cell update; h to hbuf[(s + 1) & 1]; publish; ys and cs.
// The double buffers (hbuf, the partials) are safe for the reason given in
// lstm_backward.cu: a CTA passes the cluster barrier of step s only after
// every CTA has published step s - 1, hence finished reading step s - 2.
template <bool kWriteCells>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bf16_cluster_kernel(const bf16* __restrict__ xp,
                         const bf16* __restrict__ w_hh, bf16* __restrict__ ys,
                         bf16* __restrict__ cs, bf16* hbuf,
                         unsigned int* flags, int T, int N, int ld_n, int H,
                         int reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = H / kCCluster, ldh = K + 8;
  bf16* w_s = reinterpret_cast<bf16*>(smem);               // [K][kCLdW]
  bf16* h_s = w_s + (size_t)K * kCLdW;                     // [kCRows][ldh]
  float* p_s = reinterpret_cast<float*>(
      h_s + (size_t)kCRows * ldh);                         // [2][kCRows][kCLdP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned rank = cluster_rank();
  const int q = blockIdx.x / kCCluster;
  const int F = K / kCOwn;               // producers of one depth slice
  const int k0 = rank * K;               // the slice's first h column
  const size_t H4 = 4 * (size_t)H;
  const int mrows = (N + 15) / 16 * 16;
  const int rt = warp % 4, ch = warp / 4;   // 16-row tile, 32-column half
  const bool has_tile = rt * 16 < N;
  // the thread's two cells: row n, units u and u + 1
  const int n = tid / 4, uu = 2 * (tid % 4), u = blockIdx.x * kCOwn + uu;
  const int nn = min(n, N - 1);

  // the slice's rows of the cluster's gate columns: column gate * 16 + unit
  for (int idx = tid; idx < K * kCCols; idx += kThreads) {
    const int k = idx / kCCols, col = idx % kCCols;
    w_s[(size_t)k * kCLdW + col] =
        w_hh[(size_t)(k0 + k) * H4 + (size_t)(col / kCUnits) * H +
             q * kCUnits + col % kCUnits];
  }
  // the cells' xp of step s2 (raw bf16 pairs), loaded a step ahead: their
  // latency from HBM then hides behind the step before
  auto load_x = [&](int s2, uint32_t (&x)[4]) {
    const int t2 = reverse ? T - 1 - s2 : s2;
    const bf16* x_t = xp + ((size_t)t2 * ld_n + nn) * H4 + u;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      x[g] = *reinterpret_cast<const uint32_t*>(x_t + g * H);
  };
  float c_reg[2] = {0.0f, 0.0f};
  uint32_t x_raw[4];
  load_x(0, x_raw);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    float2 x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      x[g] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x_raw[g]));
    load_x(min(s + 1, T - 1), x_raw);

    float2 gs[4] = {};
    if (s > 0) {
      const bf16* h_cur = hbuf + (size_t)(s & 1) * N * H;
      wait_flags(flags + rank * F, F, s);
      // a warp per row, its lanes on contiguous 16-byte pieces
      for (int r = warp; r < mrows; r += kThreads / 32) {
        const bf16* src = h_cur + (size_t)min(r, N - 1) * H + k0;
        for (int c = lane; c < F; c += 32)
          cp_async16(h_s + (size_t)r * ldh + c * 8, src + c * 8);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float* part = p_s + (size_t)(s & 1) * kCRows * kCLdP;
      if (has_tile) {
        // the fragments of four k-steps are loaded before their products,
        // so the ldmatrix latency is paid once per four; two accumulator
        // sets (even and odd k-steps) halve the mma dependency chains
        float acc[2][4][4] = {};
        const bf16* a_t = h_s + (size_t)rt * 16 * ldh;
        const bf16* b_t = w_s + ch * 32;
        int k = 0;
        for (; k + 64 <= K; k += 64) {
          uint32_t fa[4][4], fb[4][2][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            load_a(fa[i], a_t + k + i * 16, ldh);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              load_b(fb[i][j], b_t + (size_t)(k + i * 16) * kCLdW + j * 16,
                     kCLdW);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_16816(acc[i % 2][j], fa[i], fb[i][j / 2][(j % 2) * 2],
                        fb[i][j / 2][(j % 2) * 2 + 1]);
        }
        for (; k < K; k += 16) {
          uint32_t fa[4], fb[2][4];
          load_a(fa, a_t + k, ldh);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            load_b(fb[j], b_t + (size_t)k * kCLdW + j * 16, kCLdW);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_16816(acc[0][j], fa, fb[j / 2][(j % 2) * 2],
                      fb[j / 2][(j % 2) * 2 + 1]);
        }
        const int r = rt * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* o = part + (size_t)r * kCLdP + ch * 32 + j * 8 + 2 * (lane % 4);
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[0][j][0] + acc[1][j][0],
                          acc[0][j][1] + acc[1][j][1]);
          *reinterpret_cast<float2*>(o + 8 * kCLdP) =
              make_float2(acc[0][j][2] + acc[1][j][2],
                          acc[0][j][3] + acc[1][j][3]);
        }
      }
      cluster_sync();
      const float* mine = part + (size_t)nn * kCLdP + rank * kCOwn + uu;
#pragma unroll
      for (int r = 0; r < kCCluster; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 v = ld_cluster_f2(mine + g * kCUnits, r);
          gs[g].x += v.x;
          gs[g].y += v.y;
        }
    }

    __nv_bfloat162 hv;
    if (n < N) {
      const float h0 = lstm_cell(x[0].x + gs[0].x, x[1].x + gs[1].x,
                                 x[2].x + gs[2].x, x[3].x + gs[3].x, c_reg[0]);
      const float h1 = lstm_cell(x[0].y + gs[0].y, x[1].y + gs[1].y,
                                 x[2].y + gs[2].y, x[3].y + gs[3].y, c_reg[1]);
      hv = __floats2bfloat162_rn(h0, h1);
      bf16* h_next = hbuf + (size_t)((s + 1) & 1) * N * H;
      *reinterpret_cast<__nv_bfloat162*>(h_next + (size_t)n * H + u) = hv;
    }
    // h is published before ys and cs are stored: the release then waits
    // for the stores the consumers read, not for the outputs
    publish(flags + blockIdx.x);
    if (n < N) {
      const size_t o = ((size_t)t * ld_n + n) * H + u;
      *reinterpret_cast<__nv_bfloat162*>(ys + o) = hv;
      if (kWriteCells)
        *reinterpret_cast<__nv_bfloat162*>(cs + o) =
            __floats2bfloat162_rn(c_reg[0], c_reg[1]);
    }
  }
  cluster_sync();   // no CTA leaves while its partials may still be read
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
// of that dtype whose first half is zero (h_0).  flags: H zeroed uint32
// (the ready flags of the cluster path, one per CTA; the grid barrier's
// counter, the first, on the other paths).  Returns 0, a cudaError_t, or -1 (grid cannot be co-resident),
// -2 (unsupported shape), -3 (shared-memory request refused: H too large).
int xna_lstm_recurrence(const void* xp, const void* w_hh, void* ys, void* cs,
                        void* hbuf, void* flags, int T, int N, int ld_n,
                        int H, int reverse, int is_bf16, void* stream) {
  if (T < 1 || N < 1 || N > kGroupRows || ld_n < N || H < 16 || H % 16 != 0)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* ctr = static_cast<unsigned int*>(flags);
  int rc;
  if (is_bf16 && N <= kCRows && H % (2 * kCUnits) == 0) {
    const size_t smem = (size_t)H / kCCluster * kCLdW * 2 +
                        (size_t)kCRows * (H / kCCluster + 8) * 2 +
                        (size_t)2 * kCRows * kCLdP * 4;
    const void* fn =
        cs ? reinterpret_cast<const void*>(&lstm_bf16_cluster_kernel<true>)
           : reinterpret_cast<const void*>(&lstm_bf16_cluster_kernel<false>);
    const bf16* a0 = static_cast<const bf16*>(xp);
    const bf16* a1 = static_cast<const bf16*>(w_hh);
    bf16* a2 = static_cast<bf16*>(ys);
    bf16* a3 = static_cast<bf16*>(cs);
    bf16* a4 = static_cast<bf16*>(hbuf);
    void* args[] = {&a0, &a1, &a2, &a3, &a4, &ctr, &T, &N, &ld_n, &H,
                    &reverse};
    return launch_clusters(fn, H / kCOwn, kCCluster, kThreads, smem, args, st);
  }
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
