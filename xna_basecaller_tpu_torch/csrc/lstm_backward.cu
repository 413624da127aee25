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
// (2 x [T,N,4H]), 0.78 GB, 0.23 ms at 3.35 TB/s.  What bounds it is the
// chain of 720 dependent steps: the carry dh_c of a step needs all 4H
// columns of the step's dgates, from every CTA, before the next step, so
// the time per step is a sum of latencies (flag round trip, L2 to shared
// memory, the product, the cell update), not of bandwidth.
//
// Two kernels per launch.
// 1. The gate recompute does not depend on the carry, so it runs first as
//    one parallel product over all T*N rows ([T*N, H] x [H, 4H], mma.sync
//    on bf16, f32 accumulation, 128 x 128 tiles), adds xp, applies the
//    nonlinearities and stores the activated gates in f32 (the plain
//    version's precision).  Each thread finds its staged rows' sources once
//    (the first design divided 64-bit row indices for every 16-byte piece
//    and took 3.05 ms here; this one 1.42 ms, H100).
// 2. The serial recursion, a persistent launch of clusters.  The first
//    design (a block of 16 units x 64 rows holding W_hh[its 16 rows, :], 48
//    blocks, a grid barrier a step, then all 64 x 4H dgates of its rows
//    staged from L2 in 48 rounds of 64 columns) spent 21.8 us a step at
//    N=64 (H100, T=720, H=768): a fit of 13.9 us fixed + 100 ns a row,
//    mostly the rounds' wait and sync (a grid barrier alone is 1.3 us).
//    Here a cluster of 4 CTAs shares 32 units: each CTA holds their W_hh
//    rows over a quarter of the depth 4H (48 KB), stages only that quarter
//    of the dgates, all of it in one round, and the four partial dh_c tiles
//    are added through distributed shared memory; each CTA then updates 8
//    units' cells: 96 CTAs at H=768.  In place of the grid barrier each
//    warp adds one to its CTA's ready flag after its dgates stores (a
//    release), and a CTA waits only for the 24 producers of its quarter;
//    its inputs are loaded a step ahead.  About 8 us a step at N=64;
//    switching off each part in turn saves: the flag wait 1.6 us, the
//    staging 2.1, the product 2.6, the cluster exchange 1.5 (they
//    overlap).  Tried and slower or no better: clusters of 8 (an eighth
//    of the depth each), staging in four chunks to overlap the product,
//    wgmma for the product, and W_hh held in registers with the depth
//    split over four warps.  dc_c stays in registers.
// f32 (the parity mode): the recompute is a tiled FMA product, and a
// serial block owns 8 units for all rows (up to 256), FMA on the CUDA
// cores, dgates staged through shared memory 64 columns at a time, a grid
// barrier a step.
//
// A launch takes at most 64 (bf16) or 256 (f32) batch rows; the wrapper
// launches once per group of rows, with every tensor strided by the full
// batch.

#include "lstm_common.cuh"

namespace {

using namespace xna;

constexpr int kThreads = 256;

// gate recompute, bf16: a block computes [128 rows, 128 columns], each warp
// a 64 x 32 tile, through a ring of 3 chunks of 64 of the depth H
constexpr int kGRows = 128;
constexpr int kGCols = 128;
constexpr int kGChunk = 64;
constexpr int kGStages = 3;
constexpr int kGLdA = kGChunk + 8;   // 144 B rows: ldmatrix without bank
constexpr int kGLdB = kGCols + 8;    // conflicts

// serial recursion, bf16
constexpr int kUnits = 32;           // hidden units of one cluster
constexpr int kCluster = 4;          // CTAs of a cluster, one depth slice each
constexpr int kOwn = kUnits / kCluster;   // units whose cells a CTA updates
constexpr int kRows = 64;            // batch rows of one launch
constexpr int kLdP = kUnits + 4;     // row stride of the partial dh tiles

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

// two blocks an SM (at most 128 registers a thread) hide more latency
__global__ void __launch_bounds__(kThreads, 2)
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
  const int wr = warp % 2 * 64, wc = warp / 2 * 32;   // a 64 x 32 warp tile
  const int n_chunks = (H + kGChunk - 1) / kGChunk;

  // The thread stages piece tid % 8 of rows tid / 8 + 32 i: their h_p rows
  // (null at the first step and past M), found once, not once per chunk
  const bf16* a_src[kGRows / 32];
#pragma unroll
  for (int i = 0; i < kGRows / 32; ++i) {
    const long m = m0 + tid / 8 + 32 * i;
    a_src[i] = nullptr;
    if (m < M) {
      const int tp = prev_time((int)(m / N), T, reverse);
      if (tp >= 0) a_src[i] = ys + ((size_t)tp * ld_n + m % N) * H;
    }
  }

  // chunk c of the depth: h_p rows (zeros where there is none) and the
  // matching rows of W_hh's kGCols columns
  auto stage = [&](int c) {
    const int k0 = c * kGChunk, kc = min(kGChunk, H - k0), p = tid % 8;
    bf16* a_dst = a_s + (size_t)(c % kGStages) * kGRows * kGLdA;
    if (p * 8 < kc) {
#pragma unroll
      for (int i = 0; i < kGRows / 32; ++i)
        cp_async16_zfill(a_dst + (size_t)(tid / 8 + 32 * i) * kGLdA + p * 8,
                         a_src[i] ? a_src[i] + k0 + p * 8 : ys,
                         a_src[i] ? 16 : 0);
    }
    bf16* b_dst = b_s + (size_t)(c % kGStages) * kGChunk * kGLdB;
    for (int idx = tid; idx < kc * (kGCols / 8); idx += kThreads) {
      const int k = idx / (kGCols / 8), q = idx % (kGCols / 8);
      cp_async16(b_dst + (size_t)k * kGLdB + q * 8,
                 w_hh + (size_t)(k0 + k) * H4 + c0 + q * 8);
    }
  };

  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < n_chunks) stage(st);
    cp_async_commit();
  }
  float acc[4][4][4] = {};
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    if (c + kGStages - 1 < n_chunks) stage(c + kGStages - 1);
    cp_async_commit();
    const bf16* a_tile = a_s + (size_t)(c % kGStages) * kGRows * kGLdA +
                         wr * kGLdA;
    const bf16* b_tile = b_s + (size_t)(c % kGStages) * kGChunk * kGLdB + wc;
    const int steps = min(kGChunk, H - c * kGChunk) / 16;
    // fragments of k-step s + 1 are loaded before the products of s
    uint32_t a[2][4][4], b[2][2][4];
    auto load = [&](int s, int buf) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_a(a[buf][i], a_tile + i * 16 * kGLdA + s * 16, kGLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        load_b(b[buf][j], b_tile + (size_t)s * 16 * kGLdB + j * 16, kGLdB);
    };
    load(0, 0);
#pragma unroll
    for (int s = 0; s < kGChunk / 16; ++s) {
      if (s >= steps) break;
      if (s + 1 < steps) load(s + 1, (s + 1) % 2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_16816(acc[i][j], a[s % 2][i], b[s % 2][j / 2][(j % 2) * 2],
                    b[s % 2][j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long m = m0 + wr + i * 16 + lane / 4 + half * 8;
      if (m >= M) continue;
      const size_t row = ((size_t)(m / N) * ld_n + m % N) * H4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + wc + j * 8 + 2 * (lane % 4);
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xp + row + col));
        *reinterpret_cast<float2*>(act + row + col) = make_float2(
            activate(acc[i][j][half * 2] + x.x, col, H),
            activate(acc[i][j][half * 2 + 1] + x.y, col + 1, H));
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

// The serial recursion, bf16.  CTA b owns the cells of units [8b, 8b + 8)
// for the launch's N <= kRows batch rows; the 4 CTAs of cluster q hold
// W_hh[32q .. 32q + 32, :] between them, CTA `rank` the dgates columns of
// depth slice `rank`.  dgbuf keeps the dgates unit-major ([2][N][H][4],
// column 4 u + gate), so a depth slice is the contiguous output of the
// F = H / 32 CTAs that own its units, and each CTA's output is one 64-byte
// piece per row.  Walk k (forward step s = T - 1 - k) of CTA b:
//   1. take its cells' inputs of the step (activated gates, dy, c, c_p),
//      loaded a walk ahead, and load those of walk k + 1;
//   2. (k > 0) wait until the flags of its slice's F producers count k,
//      stage the slice's dgates of walk k - 1 (all rows, H columns) with
//      cp.async, and form the partial dh_c [rows, 32 units] of its slice
//      with mma.sync; after a cluster barrier, add the 4 partials of its 8
//      units from the cluster's shared memory, in rank order;
//   3. the cell backward; dgates to dgbuf[k & 1]; publish; dgates to dxp.
// The double buffers (dgbuf, the partials) are safe because a CTA passes
// the cluster barrier of walk k only after its cluster has read the whole
// depth of walk k - 1, which every CTA published only after it had read
// walk k - 2.
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_bf16_kernel(const float* __restrict__ act,
                     const bf16* __restrict__ dys, const bf16* __restrict__ cs,
                     const bf16* __restrict__ w_hh, bf16* __restrict__ dxp,
                     bf16* dgbuf, unsigned int* flags, int T, int N,
                     int ld_n, int H, int reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H4 = 4 * H, ldk = H + 8;
  bf16* wt_s = reinterpret_cast<bf16*>(smem);          // [kUnits][ldk]
  bf16* dg_s = wt_s + (size_t)kUnits * ldk;            // [kRows][ldk]
  float* p_s = reinterpret_cast<float*>(
      dg_s + (size_t)kRows * ldk);                     // [2][kRows][kLdP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned rank = cluster_rank();
  const int q = blockIdx.x / kCluster;
  const int F = H / kUnits;            // producers of one depth slice
  const int col0 = rank * H;           // the slice's first dgbuf column
  const int mrows = (N + 15) / 16 * 16;
  const int rt = warp % 4, uh = warp / 4;   // 16-row tile, 16-unit half
  const bool has_tile = rt * 16 < N;
  // the thread's two cells: row n, units u and u + 1
  const int n = tid / 4, uu = 2 * (tid % 4), u = blockIdx.x * kOwn + uu;
  const int nn = min(n, N - 1);

  // W_hh rows of the cluster's units, the slice's columns in unit-major
  // order: the n-major B operand of dgates @ W^T
  for (int idx = tid; idx < kUnits * H; idx += kThreads) {
    const int r = idx / H, k = idx % H, col = col0 + k;
    wt_s[(size_t)r * ldk + k] =
        w_hh[(size_t)(q * kUnits + r) * H4 + (col % 4) * H + col / 4];
  }
  // the cells' inputs of walk k2 (activated gates, and raw bf16 pairs of
  // dy, c and c_p), loaded a walk ahead: their latency from HBM then hides
  // behind the walk before
  struct Inputs {
    float2 a[4];
    uint32_t dy, c_t, c_p;
  };
  auto load_inputs = [&](int k2, Inputs& in) {
    const int t2 = reverse ? k2 : T - 1 - k2;
    const int tp2 = prev_time(t2, T, reverse);
    const size_t row = (size_t)t2 * ld_n + nn;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      in.a[g] = *reinterpret_cast<const float2*>(act + row * H4 + g * H + u);
    in.dy = *reinterpret_cast<const uint32_t*>(dys + row * H + u);
    in.c_t = *reinterpret_cast<const uint32_t*>(cs + row * H + u);
    in.c_p = tp2 >= 0 ? *reinterpret_cast<const uint32_t*>(
                            cs + ((size_t)tp2 * ld_n + nn) * H + u)
                      : 0u;
  };
  auto f2 = [](uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  };
  float dc_c[2] = {0.0f, 0.0f};
  Inputs next;
  load_inputs(0, next);
  __syncthreads();

  for (int k = 0; k < T; ++k) {
    const int t = reverse ? k : T - 1 - k;   // the forward's time index
    const Inputs in = next;
    load_inputs(min(k + 1, T - 1), next);

    float dh[2] = {0.0f, 0.0f};
    if (k > 0) {
      const bf16* dg = dgbuf + (size_t)((k - 1) & 1) * N * H4;
      wait_flags(flags + rank * F, F, k);
      // a warp per row, its lanes on contiguous 16-byte pieces
      for (int r = warp; r < mrows; r += kThreads / 32) {
        const bf16* src = dg + (size_t)min(r, N - 1) * H4 + col0;
        for (int c = lane; c < 4 * F; c += 32)
          cp_async16(dg_s + (size_t)r * ldk + c * 8, src + c * 8);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float* part = p_s + (size_t)(k & 1) * kRows * kLdP;
      if (has_tile) {
        // the fragments of four k-steps are loaded before their products,
        // so the ldmatrix latency is paid once per four; each k-step of
        // the four has its own accumulators, added in order at the end
        float acc[4][2][4] = {};
        const bf16* a_t = dg_s + (size_t)rt * 16 * ldk;
        const bf16* b_t = wt_s + (size_t)uh * 16 * ldk;
        int k0 = 0;
        for (; k0 + 64 <= H; k0 += 64) {
          uint32_t fa[4][4], fb[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            load_a(fa[i], a_t + k0 + i * 16, ldk);
            load_b_nk(fb[i], b_t + k0 + i * 16, ldk);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma_16816(acc[i][0], fa[i], fb[i][0], fb[i][1]);
            mma_16816(acc[i][1], fa[i], fb[i][2], fb[i][3]);
          }
        }
        for (; k0 < H; k0 += 16) {
          uint32_t fa[4], fb[4];
          load_a(fa, a_t + k0, ldk);
          load_b_nk(fb, b_t + k0, ldk);
          mma_16816(acc[0][0], fa, fb[0], fb[1]);
          mma_16816(acc[0][1], fa, fb[2], fb[3]);
        }
        const int r = rt * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = acc[0][j][e] + acc[1][j][e] + acc[2][j][e] + acc[3][j][e];
          float* o = part + (size_t)r * kLdP + uh * 16 + j * 8 + 2 * (lane % 4);
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(o + 8 * kLdP) = make_float2(v[2], v[3]);
        }
      }
      cluster_sync();
      const float* mine = part + (size_t)nn * kLdP + rank * kOwn + uu;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const float2 v = ld_cluster_f2(mine, r);
        dh[0] += v.x;
        dh[1] += v.y;
      }
    }

    float d[2][4];
    if (n < N) {
      const float2 dy = f2(in.dy), c_t = f2(in.c_t), c_p = f2(in.c_p);
      const float a0[4] = {in.a[0].x, in.a[1].x, in.a[2].x, in.a[3].x};
      const float a1[4] = {in.a[0].y, in.a[1].y, in.a[2].y, in.a[3].y};
      cell_backward(a0, dy.x, c_t.x, c_p.x, dh[0], dc_c[0], d[0]);
      cell_backward(a1, dy.y, c_t.y, c_p.y, dh[1], dc_c[1], d[1]);
      __nv_bfloat162 o[4];
#pragma unroll
      for (int g = 0; g < 4; g += 2) {
        o[g / 2] = __floats2bfloat162_rn(d[0][g], d[0][g + 1]);
        o[2 + g / 2] = __floats2bfloat162_rn(d[1][g], d[1][g + 1]);
      }
      *reinterpret_cast<uint4*>(dgbuf + (size_t)(k & 1) * N * H4 +
                                (size_t)n * H4 + 4 * u) =
          *reinterpret_cast<const uint4*>(o);
    }
    // dgates are published before dxp is stored: the release then waits
    // for the stores the consumers read, not for the output
    publish(flags + blockIdx.x);
    if (n < N) {
      bf16* dx = dxp + ((size_t)t * ld_n + n) * H4 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        *reinterpret_cast<__nv_bfloat162*>(dx + g * H) =
            __floats2bfloat162_rn(d[0][g], d[1][g]);
    }
  }
  cluster_sync();   // no CTA leaves while its partials may still be read
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
// dtype, flags H zeroed uint32 (bf16: one ready flag per CTA; f32: the
// first is the grid barrier's counter).  Writes dxp [T, ld_n, 4H] of the
// dtype.  Returns 0, a cudaError_t, or -1 (grid cannot be co-resident), -2
// (unsupported shape: H a multiple of 16, of 32 in bf16), -3 (shared-memory
// request refused: H too large).
int xna_lstm_backward(const void* xp, const void* ys, const void* cs,
                      const void* dys, const void* w_hh, void* act, void* dxp,
                      void* dgbuf, void* flags, int T, int N, int ld_n,
                      int H, int reverse, int is_bf16, void* stream) {
  const int group = is_bf16 ? kRows : kGroupRowsF;
  const long M = (long)T * N;
  if (T < 1 || N < 1 || N > group || ld_n < N || H < 16 || H % 16 != 0 ||
      (is_bf16 && H % kUnits != 0) || (M + 63) / 64 > 65535)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* ctr = static_cast<unsigned int*>(flags);
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
    gates_bf16_kernel<<<dim3(4 * H / kGCols, (unsigned)((M + kGRows - 1) / kGRows)),
                        kThreads, smem_g, st>>>(a_xp, a_ys, a_w, a_act, T, N,
                                                ld_n, H, reverse);
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
    const size_t smem = (size_t)(kUnits + kRows) * (H + 8) * 2 +
                        (size_t)2 * kRows * kLdP * 4;
    void* args[] = {&a_act, &a_dys, &a_cs, &a_w, &a_dxp, &a_dg, &ctr,
                    &T, &N, &ld_n, &H, &reverse};
    return launch_clusters(reinterpret_cast<const void*>(&lstm_bwd_bf16_kernel),
                           H / kOwn, kCluster, kThreads, smem, args, st);
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
  return is_bf16 ? kRows : kGroupRowsF;
}

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
