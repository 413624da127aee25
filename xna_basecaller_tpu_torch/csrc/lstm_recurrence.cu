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
// latencies (a flag round trip, L2 to shared memory, the product, the cell
// update and its stores), not of bandwidth.
//
// One persistent launch per layer (per group of batch rows); each CTA owns
// a slice of the hidden units, keeps their four gate columns of W_hh in
// shared memory for the whole scan and their cells in registers; h is
// double buffered in global memory; only xp, ys (and cs) stream through
// HBM.  In place of a grid barrier, a CTA adds one to its ready flag when
// its h of a step is stored (a release), and its consumers wait only for
// the flags of the h they read.  The entry point checks that the whole
// grid can be resident and refuses one that cannot.  Two bf16 designs,
// chosen from the shape:
//
// N <= 64 and H % 32 == 0 (K3a at the training batch, K1 on the validation
// batch): lstm_bf16_cluster_kernel.  The first design (a tiled kernel with
// a grid barrier at every N) spent 12.2 us a step at N=64 (H100, T=720,
// H=768): a fit of 8.2 us fixed + 61 ns a row, of which a grid barrier
// alone is 1.3 us; 48 blocks on 132 SMs and 4 of 8 warps idle at 64 rows.
// Here the CTAs come in clusters of 2 that share 16 units: each holds the
// W_hh rows of half the depth H (48 KB) and stages only that half of h,
// and the two partial [64, 64] gate tiles are added through distributed
// shared memory (each CTA then updates 8 units' cells): 96 CTAs, every warp
// busy at 64 rows.  Each warp publishes its own flag count after its h
// stores, and a CTA waits only for the 48 producers of the half of h it
// reads; xp is loaded a step ahead.  7.8 us a step at N=64; switching off
// each part in turn saves: the flag wait 1.9 us, the staging 1.3, the
// product 2.0, the cluster exchange 1.4 (they overlap, so they do not add
// up).  For this product wgmma, clusters of 4, four staging chunks and
// W_hh held in registers were tried and were slower (one [64, 64] tile a
// CTA a step).
//
// N > 64 (K1 at the basecall batch, K3a's launches past 64 rows):
// lstm_bf16_wg_kernel, one launch of up to 384 rows, in the geometry
// Narrow wherever its grid fits the card, else Wide (below).  In Narrow,
// CTA b owns 16 units (their 64 gate columns of W_hh, 96 KB) for one tile
// of 128 batch rows: 96 CTAs at N=256, the two tiles independent of each
// other.
//   - h is exchanged in global memory in chunks of 256 columns (3 at
//     H=768; 128 or 64 where two stages of 256 do not fit beside W), each
//     made of 64-column sub-chunks whose rows are contiguous (128 B a
//     row), the 16-byte pieces swizzled by the row (piece p of row n at
//     p ^ (n % 8)): the 128-byte swizzle of wgmma's operands.  A producer
//     warp polls the flags of its row tile (all of them at once, relaxed
//     loads and one acquire fence) and brings each chunk whose writers are
//     done by one bulk copy (TMA, no tensor map; 64 KB) into the ring
//     stage of its index (2 stages at H=768), completing on an mbarrier.
//     The consumers take the chunks in index order, so the f32 sums of the
//     gates take one order at every call and the kernel is
//     bit-repeatable; with more stages the producer brings the chunks of
//     its window in the order they finish.
//   - Two consumer warpgroups each multiply their 64 rows of a stage by
//     W's slice (stored [k-tile][64 n][64 k], the same swizzle) with
//     wgmma m64n64k16, both operands read from shared memory, and release
//     the stage through a second mbarrier once the product is done.
//   - W's columns are unit-major (within each 8-column block, column
//     2 gate + e of unit e), so a thread's accumulators hold one gate of
//     four cells and a rotation in its quad of lanes gives it the four
//     gates of one cell: the cell update runs from registers and no gate
//     goes through shared memory; an exchange with the neighbouring lane
//     turns h into 8-byte stores.  xp is loaded a step ahead with 16-byte
//     loads; the CTA publishes one flag count a step after a named barrier.
// 10.61-10.62 ms a layer at N=256 (xp [720, 256, 3072], both directions)
// against 10.17-10.25 for the previous design of this kernel, which took
// 128-column chunks in the order they finished and so added the gates'
// partial products in another order at each call (4 % of ys differed
// between two calls); medians of 21 in turns, H100 80GB HBM3, 700 W,
// tools/k1_turns.py.  In the same turns, each bit-repeatable: 128-column
// chunks on 4 stages, fetched as they finish within a window of 3,
// 10.97-11.09; 64-column chunks on 8 stages (window 7), 12.61-12.77;
// 128-column chunks fetched in index order, 12.57; the previous design
// with each chunk's product in a fresh tile summed in 64-bit fixed point
// (exact, so order-free; 168 registers and spills), 13.46.
// Earlier, timed in turns with the tiled kernel with a grid
// barrier (11.2-11.3 ms) that this kernel replaced: a clock64 profile of
// the design with 64-column chunks (16.8 us a step, instrumented) put 2.2
// us in the wait for the first chunk, 6.0 in the other 11 with their
// products, 5.6 in the epilogue (2.2 of it the cell math) and 0.6 in the
// release; the product on mma.sync 32 x 32 warp tiles, 12.0-14.8 ms;
// clusters of 2 or 4 CTAs receiving each chunk by multicast, 18.1-18.7.
//
// The wide geometry (the XNA model's batch of 384 at H=768).  Narrow needs
// H / 16 CTAs a 128-row tile, 144 for three tiles at H=768, and one CTA
// fits an SM (132): until it, 384 rows ran as two launches, 256 rows on 96
// SMs and then 128 on 48, and since a launch's time is its chain of 720
// steps, not its work, the second cost as much as the first (20.95-21.12
// ms a layer for both, forward and reverse).  Wide keeps 16 units a CTA
// and takes 192-row tiles: three consumer warpgroups and the producer
// warp (416 threads: 13 warps, 4 on one scheduler, so 128 registers a
// thread; 8 bytes spill), 128-column chunks of 192 rows (48 KB) on 2
// stages beside W's 96 KB: 96 CTAs at N=384 (two tiles), 128 at H=1024.
// 13.57, 13.50 ms a layer at N=384 (forward, reverse) against its bound
// of 1.32 ms and the two launches' 21.12, 20.97, 1.27x Narrow's time at
// N=256 (10.72, 10.61; before it 10.69, 10.66) for 1.5x the rows;
// bit-equal to the two launches it replaces (the same k16 products of
// each row, added in the same order); 64-column chunks on 5 stages,
// fetched as they finish within a window of 4, 14.48, 14.36
// (12.79, 12.67 at N=256 on 8 stages).  In an earlier run of the same
// turns (Wide 13.41, 13.42; the two launches 20.95, 20.96): 24 units a CTA
// in 128-row tiles (wgmma m64n96k16, 12 cells a thread, 168 registers, W's
// slice 144 KB, 128-column chunks on 2 stages, 32 flags a tile), 15.54,
// 15.38, and removed.  The producer's poll is on the critical path six
// times a step: with each chunk's writers found as ranges of flags (which
// 24 units a CTA needs) in place of `per` flags a chunk, Wide took 14.17,
// 14.25.  Medians of 21 in turns, H100 80GB HBM3, 700 W,
// tools/k1_turns.py.  N <= 256 keeps Narrow, its launch and its code.
//
// f32 (K1 in f32 is what duplex's transition posteriors run, at N = a
// read's chunks: 8 for 22.5 k samples, ~30 for 10 kb; K3a in f32 the f32
// training step): lstm_f32_kernel.  Bound on the card at T=720, H=768: 2 T
// N H 4H FMA operations over 67 TFLOP/s of f32 outside the tensor cores,
// 0.406 ms at N=8 and 12.98 ms at N=256 (bytes, xp + W_hh + ys over 3.35
// TB/s: 0.029 ms at N=8).  The kernel it replaced gave each thread a batch
// row and ran the 768-deep chain of 32 gate columns for it (248 of 256
// threads idle at N=8), staged h in 24 passes and ended each step on a
// grid barrier: 82.2 ms at N=8 rising to 114.7 at N=256.  Here each CTA's
// W_hh columns stay in registers, split by depth over every lane, so the
// work of a step scales with N; clusters of 2 CTAs split the depth (each
// reads half of h; their partial tiles are added through distributed
// shared memory in rank order); ready flags replace the grid barrier;
// each warp stages its slice of h by cp.async as soon as that slice's
// producers are done (an item ahead where the rows come in blocks), xp an
// item ahead.  Medians of 21 in turns with the kernel it replaced, H100
// 80GB HBM3, 700 W, tools/k1_turns.py --dtype f32 (ms, forward; reverse
// within 1 %):
//   N         8      16     32     64     128     256
//   this    3.779  5.482  7.112  13.09  23.44   48.27
//   before  82.17  83.10  84.70  89.07  98.04   114.67
//   cuDNN   10.41  15.49  25.70  25.97  34.91   53.54   (f32 nn.LSTM,
//                                        TF32 off, projection included)
// 5.2 us a step at N=8; the step grows ~0.25 us a row.  Each part
// switched off in turn (same turns) saves, at N=8 / N=256: the product
// 0.78 / 26.1 ms, the staging of h 0.46 / 4.3, the flag wait 0.72 / 0,
// the cell update 0.44 / 1.1 (they overlap).  In the product's SASS one
// issue slot in four goes to other work than FMA (per row pair and lane:
// 12 LDS.128 for h, 144 FFMA, 6 SHFL); it runs at ~0.14 us a row-step at
// N=256 (1980 MHz), about 70 % of the rate its instructions allow.  What holds the kernel at
// N=256 to 3.7x its bound is that, and the ~4.4 us a row block of the
// rest (7 blocks of 37 rows a step).  In an earlier run of the same
// turns, without clusters: 0.5-2.5 % faster at N <= 16, 4-15 % slower at
// N >= 32; clusters of 4 do not fit the card (it grants fewer than 32 of
// them at ~220 KB a CTA); 1 or 2 batch rows a lane at once in place of
// 4: 2-11 % slower.
//
// A launch takes at most kGroupRowsBf16 (384) batch rows in bf16 and
// kGroupRowsF32 (256) in f32; the wrapper launches once per group of rows
// (rows are independent), with xp and ys strided by the full batch.

#include <type_traits>

#include "lstm_common.cuh"

namespace {

using namespace xna;

constexpr int kThreads = 256;
constexpr int kGroupRowsBf16 = 384; // batch rows per launch, bf16
constexpr int kGroupRowsF32 = 256;  // and f32

// bf16 path at kCRows < N <= kGroupRowsBf16: the wgmma kernel, in one of
// two geometries (WgGeo)
constexpr int kUnits = 16;          // hidden units of one CTA
constexpr int kCols = 4 * kUnits;   // their gate columns, unit-major
constexpr int kHChunk = 64;         // h columns per sub-chunk (128 B)
constexpr int kMaxSubs = 4;         // sub-chunks per exchanged chunk, most
constexpr int kMaxStages = 8;       // ring stages of h chunks

// The geometry of lstm_bf16_wg_kernel: kWG consumer warpgroups of 64 batch
// rows each (a row tile of 64 kWG rows) and a producer warp.
template <int kWG>
struct WgGeo {
  static constexpr int kRows = 64 * kWG;   // batch rows of one CTA
  static constexpr int kCWarps = 4 * kWG;  // consumer warps
  static constexpr int kThreads = 32 * (kCWarps + 1);
};
using Narrow = WgGeo<2>;   // wherever its grid is co-resident
using Wide = WgGeo<3>;     // where Narrow's is not (257-384 rows, H=768)

// bf16 path at N <= kCRows: clusters of two CTAs
constexpr int kCUnits = 16;         // hidden units of one cluster
constexpr int kCCluster = 2;        // CTAs of a cluster, one depth slice each
constexpr int kCOwn = kCUnits / kCCluster;   // units whose cells a CTA updates
constexpr int kCRows = 64;          // batch rows
constexpr int kCCols = 4 * kCUnits; // the cluster's gate columns, gate-major
constexpr int kCLdW = kCCols + 8;
constexpr int kCLdP = kCCols + 4;   // row stride of the partial gate tiles

// f32 path
constexpr int kFWarps = 8;          // warps of a CTA: one depth slice each
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFMaxDepth = 32;      // rows of W_hh a lane holds, most
constexpr int kFCluster = 2;        // CTAs of a cluster, splitting the depth
constexpr int kFRows = 4;           // batch rows of a lane's product at once

// One cell: the four gate pre-activations (xp + h @ W, added in f32) and
// the cell state c (updated in place) -> h in f32.
__device__ __forceinline__ float lstm_cell(float gi, float gf, float gg,
                                           float go, float& c) {
  // no contraction into an FMA: the same roundings as the plain version
  c = __fadd_rn(__fmul_rn(sigmoid(gf), c), __fmul_rn(sigmoid(gi), tanhf(gg)));
  return __fmul_rn(sigmoid(go), tanhf(c));
}

// Four floats as four bf16 (8 bytes).
__device__ __forceinline__ uint2 pack_bf16x4(const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                    *reinterpret_cast<const uint32_t*>(&b));
}

// wgmma m64n64k16 of one warpgroup, bf16 in, f32 accumulation: d += A B
// with A [64 x 16] and B [16 x 64] read from shared memory through their
// descriptors.  The accumulator of warp w of the group holds, for each
// 8-column block j, d[4 j .. 4 j + 3] in mma.sync m16n8's layout at rows
// 16 w + lane / 4 (+ 8).
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Position of h[n, k] in one buffer of the bf16 h exchange at N > 64, in
// row tiles of kRows rows: [row tile n / kRows][sub-chunk k / 64 of
// n_sub][row n % kRows][64 columns], 16-byte piece p of row n stored at
// p ^ (n % 8), so that the sub-chunks of one exchanged chunk are
// contiguous for a row tile.
template <int kRows>
__device__ __forceinline__ size_t hpos(int n, int k, int n_sub) {
  const int kk = k % kHChunk;
  return ((size_t)((n / kRows) * n_sub + k / kHChunk) * kRows + n % kRows) *
             kHChunk +
         ((((kk / 8) ^ (n % 8)) * 8) | (kk % 8));
}

// The bf16 path for kCRows < N <= kGroupRowsBf16 rows (the basecall batch;
// K3a past 64 rows), in geometry G (kR = G::kRows rows a tile): CTA b owns
// units [16 (b % S), + 16) of row tile b / S (S = H / 16 slices).
// Warpgroup g (warps 4 g .. 4 g + 3) computes rows [64 g, 64 g + 64) of
// the CTA's [kR, 64] gate tile; the warp after the consumers produces.
// Step s:
//   producer (s > 0): poll the tile's flags for step s; each chunk c of
//     h_s whose writers are done, among the first stages - 1 chunks not
//     brought yet: one bulk copy of the tile's kR rows of it into stage
//     (s - 1) n_chunks + c of the ring (mod stages);
//   consumers: take the cells' xp[t] (loaded a step ahead), load xp[t + 1];
//     (s > 0) for each chunk in index order (the stages in ring order),
//     wait for it, add its product (wgmma), release the stage of the one
//     before once its product is done; add xp, rotate the gates within
//     each quad, update 8 cells; h to hbuf[(s + 1) & 1]; publish (one count
//     a CTA); ys (and cs).
// The gate sums are f32 sums of the chunks' products in index order, the
// same order at every call: the result does not depend on which chunk's
// writers finish first, and two calls give the same bits.  Nor does it
// depend on the geometry: a row's gates are the same k16 products added
// in the same order whatever its tile and warpgroup.
// The double buffer of h is safe without a barrier: a CTA writes h_{s+1}
// only after it has read all of h_s, that is after every CTA of its tile
// has published step s - 1, hence finished reading h_{s-1}.
template <class G, bool kWriteCells>
__global__ void __launch_bounds__(G::kThreads, 1)
lstm_bf16_wg_kernel(const bf16* __restrict__ xp,
                    const bf16* __restrict__ w_hh, bf16* __restrict__ ys,
                    bf16* __restrict__ cs, bf16* hbuf, unsigned int* flags,
                    int T, int N, int ld_n, int H, int reverse, int subs,
                    int stages) {
  constexpr int kR = G::kRows, kCWarps = G::kCWarps;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int n_sub = (H + kHChunk - 1) / kHChunk;
  const int n_chunks = (n_sub + subs - 1) / subs;
  bf16* ring = reinterpret_cast<bf16*>(smem);   // [stages][subs][kR][kHChunk]
  bf16* w_s = ring + (size_t)stages * subs * kR * kHChunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      w_s + (size_t)n_sub * kCols * kHChunk);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_slices = H / kUnits;
  const int slice = blockIdx.x % n_slices, tile = blockIdx.x / n_slices;
  const int u0 = slice * kUnits, r0 = tile * kR;
  const int rows = min(kR, N - r0);
  const int Np = (N + kR - 1) / kR * kR;
  const size_t H4 = 4 * (size_t)H, hb = (size_t)n_sub * Np * kHChunk;
  unsigned int* tile_flags = flags + tile * n_slices;

  // W's slice as the B operand: column n is gate (n % 8) / 2 of unit
  // 2 (n / 8) + n % 2
  for (int idx = tid; idx < H * kCols; idx += G::kThreads) {
    const int k = idx / kCols, n = idx % kCols, kk = k % kHChunk;
    const int unit = n / 8 * 2 + n % 2, gate = n % 8 / 2;
    w_s[((size_t)(k / kHChunk) * kCols + n) * kHChunk +
        (((kk / 8) ^ (n % 8)) * 8) + kk % 8] =
        w_hh[(size_t)k * H4 + (size_t)gate * H + u0 + unit];
  }
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kCWarps);
    }
    mbar_init_fence();
  }
  // W's generic stores, then wgmma's async-proxy reads of them
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (warp == kCWarps) {   // the producer
    const unsigned sub_bytes = kR * kHChunk * 2;
    for (int s = 1; s < T; ++s) {
      const bf16* h_cur = hbuf + (size_t)(s & 1) * hb;
      const unsigned base = (unsigned)(s - 1) * n_chunks;   // chunk 0's use
      unsigned long long left = (1ull << n_chunks) - 1;     // to bring
      while (left) {
        // of the chunks not brought yet, the first stages - 1: the stage
        // of chunk c was last held by chunk c - stages, which the
        // consumers release once they take chunk c - stages + 1 (brought:
        // it comes before the first chunk not brought yet); chunk
        // lo + stages - 1 would wait for the release that only chunk lo
        // brings
        const int lo = __ffsll(left) - 1;
        const unsigned long long window =
            left & (((1ull << (stages - 1)) - 1) << lo);
        unsigned long long ready =
            ready_chunks(tile_flags, n_slices, subs * kHChunk / kUnits, s) &
            window;
        left &= ~ready;
        while (ready) {
          const int c = __ffsll(ready) - 1;
          const unsigned it = base + c, st = it % stages;
          ready &= ready - 1;
          // every use of the stage before the last is confirmed released:
          // its chunk came before the window
          if (it >= (unsigned)stages)
            mbar_wait(empty + st, (it / stages - 1) & 1);
          if (lane == 0) {
            const unsigned bytes = min(subs, n_sub - subs * c) * sub_bytes;
            mbar_expect_tx(full + st, bytes);
            bulk_copy(ring + (size_t)st * subs * kR * kHChunk,
                      h_cur + (size_t)(tile * n_sub + subs * c) * kR *
                                  kHChunk,
                      bytes, full + st);
          }
          __syncwarp();
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const bool has_tile = 64 * wg < rows;
  const int q = lane % 4;
  const int row0 = 64 * wg + 16 * (warp % 4) + lane / 4;   // and row0 + 8
  // the xp of gate q, units u0 + [8 hf, 8 hf + 8), row row0 + 8 e of step
  // s2: this step's and the next's
  uint4 x_raw[2][2], x_next[2][2];
  auto load_x = [&](int s2) {
    const int t2 = reverse ? T - 1 - s2 : s2;
    const bf16* x_t = xp + ((size_t)t2 * ld_n + r0) * H4 + (size_t)q * H + u0;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        x_next[e][hf] = __ldg(reinterpret_cast<const uint4*>(
            x_t + (size_t)min(row0 + 8 * e, rows - 1) * H4 + 8 * hf));
  };
  // units u0 + 2 j and the next, row row0 + 8 e
  auto x_of = [&](int j, int e) {
    const uint4& r = x_raw[e][j / 4];
    const int c = j % 4;
    const uint32_t w = c == 0 ? r.x : c == 1 ? r.y : c == 2 ? r.z : r.w;
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  };
  float c_reg[2][4] = {};
  load_x(0);
  unsigned it = 0;
  const bf16* a_base = ring + (size_t)64 * wg * kHChunk;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) x_raw[e][hf] = x_next[e][hf];
    load_x(min(s + 1, T - 1));

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    if (s > 0) {
      if (has_tile) wgmma_fence();
      int prev = -1;
      for (int c = 0; c < n_chunks; ++c, ++it) {
        const int st = it % stages;
        mbar_wait(full + st, (it / stages) & 1);
        if (has_tile) {
          for (int j = 0; j < subs && subs * c + j < n_sub; ++j) {
            const int sub = subs * c + j;
            const bf16* a_st = a_base + ((size_t)st * subs + j) * kR * kHChunk;
            const bf16* b_t = w_s + (size_t)sub * kCols * kHChunk;
            const int kc = min(kHChunk, H - sub * kHChunk);
            for (int kk = 0; kk < kc; kk += 16)
              wgmma_64x64(acc, sw128_desc(a_st + kk), sw128_desc(b_t + kk));
          }
          wgmma_commit();
          wgmma_wait<1>();   // the previous chunk's products are done
        }
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = st;
      }
      if (has_tile) wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + prev);
    }

    // lane q holds gate q of the cells (unit 2 j + d % 2, row row0 +
    // 8 (d / 2)); after the rotation, the four gates of the cell of unit
    // 2 j + q % 2, row row_q; after pair_units, the h (and c) of units
    // 8 hf + 4 (q % 2) + 0..3 of that row
    bf16* h_next = hbuf + (size_t)((s + 1) & 1) * hb;
    const int row_q = row0 + 8 * (q / 2);
    float h[2][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 x0 = x_of(j, 0), x1 = x_of(j, 1);
      const float v[4] = {acc[4 * j] + x0.x, acc[4 * j + 1] + x0.y,
                          acc[4 * j + 2] + x1.x, acc[4 * j + 3] + x1.y};
      float g[4];
      quad_transpose(v, g);
      h[j / 4][j % 4] = lstm_cell(g[0], g[1], g[2], g[3], c_reg[j / 4][j % 4]);
    }
    uint2 hv[2], cv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float hp[4];
      pair_units(h[hf], hp);
      hv[hf] = pack_bf16x4(hp);
      if (kWriteCells) {
        float cp[4];
        pair_units(c_reg[hf], cp);
        cv[hf] = pack_bf16x4(cp);
      }
      if (row_q < rows)
        *reinterpret_cast<uint2*>(
            h_next + hpos<kR>(r0 + row_q, u0 + 8 * hf + 4 * (q % 2), n_sub)) =
            hv[hf];
    }
    // h is published before ys and cs are stored
    publish_cta(tile_flags + slice, kCWarps * 32);
    if (row_q < rows) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const size_t o = ((size_t)t * ld_n + r0 + row_q) * H + u0 + 8 * hf +
                         4 * (q % 2);
        *reinterpret_cast<uint2*>(ys + o) = hv[hf];
        if (kWriteCells) *reinterpret_cast<uint2*>(cs + o) = cv[hf];
      }
    }
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

// p[0] + p[stride] + ... + p[(n - 1) stride], n <= kFWarps, added in that
// order; the loads issued together.
__device__ __forceinline__ float warp_sum(const float* p, size_t stride,
                                          int n) {
  float v[kFWarps];
#pragma unroll
  for (int w = 0; w < kFWarps; ++w) v[w] = w < n ? p[w * stride] : 0.0f;
  float acc = v[0];
#pragma unroll
  for (int w = 1; w < kFWarps; ++w)
    if (w < n) acc += v[w];
  return acc;
}

// The f32 path (K1 and K3a in f32; duplex's transition posteriors run
// it).  CTA b updates the cells of U = 2 kG units [U b, U b + U) (U = 6
// where H allows 128 CTAs or fewer, else 8) for all N rows.  The CTAs come
// in clusters of kFCluster = 2 that share the 2 U units of the cluster, C
// = 8 U gate columns: CTA `rank` keeps their W_hh rows of the depth slice
// [rank D, rank D + D) (D = H / 2) in registers, split over every lane:
// warp w holds KW = 2 kDepth rows of the slice from w KW, lane l the
// kDepth rows from (l / 16) kDepth of the warp's and the kG columns
// (l % 16) kG (column gate 2 U + unit of the cluster), kDepth = H / 32
// rounded up to 8, 16, 24 or 32.  So every lane multiplies at every N, the
// work of a step scales with N, and each CTA reads half of h.  The rows
// come in blocks of rb (all N in one block where it fits, else as many as
// fit with two staging buffers); item i = s nb + j is block j of step s.
// Item (s, j) of warp w:
//   (s > 0) wait for the ready flags of the CTAs that write its rows of
//     h_s (their count of item (s - 1, j)), bring the block's rows of them
//     into the warp's staging buffer by cp.async (an item ahead, double
//     buffered, where there is more than one block);
//     each lane's kG sums over its kDepth rows for kFRows batch rows at a
//     time (f32 FMA, k ascending), added over the warp's two depth groups
//     by a shuffle, written by the lanes of group 0 as the warp's partial
//     tile [rb][C];
//   barrier; the CTA's tile [rb][C] = the 8 warps' added in warp order;
//   cluster barrier; thread r U + u updates cell (row j rb + r, unit u):
//     xp (loaded an item ahead) + the two CTAs' tiles of its gate columns
//     added in rank order (distributed shared memory); c in shared memory;
//     h to hbuf[(s + 1) & 1]; each warp publishes its count of the item
//     (the CTA's flag counts items x 8); ys (and cs).
// Every sum takes one order at every call: bit-repeatable.
// The warps' tiles are read before the cluster barrier of their item and
// written again after it.  The CTAs' tiles are double buffered by item:
// they are written for item i only after the cluster barrier of item
// i - 1, which every reader passes after reading item i - 2's.
// hbuf[(s + 1) & 1] (h_{s-1}) is overwritten in block j only after the
// flags of block j of step s were seen for every depth slice, that is
// after every CTA finished reading h_{s-1} there.  The prefetch of item
// i + 1 waits for item i + 1 - nb <= i - 1 of the producers (nb >= 2): it
// never waits for an item not begun.
template <int kDepth, int kG, bool kWriteCells>
__global__ void __launch_bounds__(kFThreads, 1)
lstm_f32_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                float* __restrict__ ys, float* __restrict__ cs, float* hbuf,
                unsigned int* flags, int T, int N, int ld_n, int H,
                int reverse, int rb, int stages) {
  constexpr int U = 2 * kG, KU = kFCluster * U, C = 4 * KU;
  constexpr int KG = 4 / kFCluster;  // depth groups of a warp
  constexpr int CG = 32 / KG;        // column groups of a warp
  constexpr int KW = KG * kDepth;    // h columns of a warp
  constexpr int KP = kDepth + 4;     // staged stride of a depth group
  constexpr int RS = KG * KP;        // staged stride of a row
  extern __shared__ __align__(16) float smem_f[];
  // [stages][8 warps][rb][RS], [8 warps][rb][C], [2][rb][C], [N][U]
  float* stage_s = smem_f;
  float* part = stage_s + (size_t)stages * kFWarps * rb * RS;
  float* sum_s = part + (size_t)kFWarps * rb * C;
  float* c_s = sum_s + (size_t)2 * rb * C;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cg = lane % CG, kq = lane / CG;
  const unsigned rank = cluster_rank();
  const int D = H / kFCluster, kend = (int)(rank + 1) * D;
  const int u0 = blockIdx.x * U, uc0 = blockIdx.x / kFCluster * KU;
  const size_t H4 = 4 * (size_t)H;
  const int k0w = (int)rank * D + warp * KW;
  const bool active = k0w < kend;
  const int n_active = min(kFWarps, (D + KW - 1) / KW);
  const int p_lo = min(k0w / U, (int)gridDim.x);
  const int p_hi = min((min(k0w + KW, kend) + U - 1) / U, (int)gridDim.x);
  const int nb = (N + rb - 1) / rb, items = T * nb;

  float w[kDepth][kG];
#pragma unroll
  for (int i = 0; i < kDepth; ++i)
#pragma unroll
    for (int c = 0; c < kG; ++c) {
      const int k = k0w + kq * kDepth + i, col = cg * kG + c;
      w[i][c] = k < kend ? w_hh[(size_t)k * H4 + (size_t)(col / KU) * H +
                                uc0 + col % KU]
                         : 0.0f;
    }
  for (int idx = tid; idx < N * U; idx += kFThreads) c_s[idx] = 0.0f;

  // the cell this thread updates in each block: row j rb + cr, unit cu
  const int cr = tid / U, cu = tid % U;
  float x_next[4] = {};
  auto load_x = [&](int it) {
    const int s2 = it / nb, n = (it % nb) * rb + cr;
    if (cr < rb && n < N) {
      const int t2 = reverse ? T - 1 - s2 : s2;
      const float* x = xp + ((size_t)t2 * ld_n + n) * H4 + u0 + cu;
#pragma unroll
      for (int g = 0; g < 4; ++g) x_next[g] = __ldg(x + (size_t)g * H);
    }
  };
  // the smallest count of the warp's producers seen so far
  unsigned int seen = 0;
  // item `it` (step >= 1) of the warp's rows of h into staging buffer buf
  auto stage = [&](int it, int buf) {
    const int s2 = it / nb, j2 = it % nb;
    const unsigned int target = (unsigned)(it - nb + 1) * kFWarps;
    while (seen < target) {
      unsigned int m = 0xffffffffu;
      for (int b = p_lo + lane; b < p_hi; b += 32)
        m = min(m, ld_acquire(flags + b));
      seen = __reduce_min_sync(0xffffffffu, m);
    }
    __syncwarp();
    const float* h_cur = hbuf + (size_t)(s2 & 1) * N * H;
    const int r0 = j2 * rb, rows = min(rb, N - r0);
    float* dst = stage_s + ((size_t)buf * kFWarps + warp) * rb * RS;
    for (int idx = lane; idx < rows * KW / 4; idx += 32) {
      // row r of the block, column p of the warp's
      const int r = idx / (KW / 4), p = 4 * (idx % (KW / 4));
      const int k = k0w + p;
      cp_async16_zfill(dst + r * RS + (p / kDepth) * KP + p % kDepth,
                       h_cur + (size_t)(r0 + r) * H + min(k, kend - 4),
                       k < kend ? 16 : 0);
    }
    cp_async_commit();
  };
  __syncthreads();
  load_x(0);

  for (int it = 0; it < items; ++it) {
    const int s = it / nb, j = it % nb;
    const int t = reverse ? T - 1 - s : s;
    const int r0 = j * rb, rows = min(rb, N - r0);
    float x[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) x[g] = x_next[g];
    if (it + 1 < items) load_x(it + 1);
    float* sum = sum_s + (size_t)(it & 1) * rb * C;

    if (s > 0 && active) {
      int buf = 0;
      if (stages == 1) {
        stage(it, 0);
        cp_async_wait<0>();
      } else {
        buf = it & 1;
        if (it == nb) stage(it, buf);
        if (it + 1 < items) {
          __syncwarp();   // every lane is done with the buffer it reuses
          stage(it + 1, buf ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      }
      __syncwarp();
      const float* hs = stage_s + ((size_t)buf * kFWarps + warp) * rb * RS +
                        kq * KP;
      float* pw = part + (size_t)warp * rb * C + cg * kG;
      for (int r = 0; r < rows; r += kFRows) {
        int rr[kFRows];
        float a[kFRows][kG];
#pragma unroll
        for (int e = 0; e < kFRows; ++e) {
          rr[e] = min(r + e, rows - 1);   // past the block: a row again
#pragma unroll
          for (int c = 0; c < kG; ++c) a[e][c] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kDepth; i += 4) {
          float4 h[kFRows];
#pragma unroll
          for (int e = 0; e < kFRows; ++e)
            h[e] = *reinterpret_cast<const float4*>(hs + rr[e] * RS + i);
#pragma unroll
          for (int c = 0; c < kG; ++c)
#pragma unroll
            for (int e = 0; e < kFRows; ++e) {
              a[e][c] = fmaf(h[e].x, w[i][c], a[e][c]);
              a[e][c] = fmaf(h[e].y, w[i + 1][c], a[e][c]);
              a[e][c] = fmaf(h[e].z, w[i + 2][c], a[e][c]);
              a[e][c] = fmaf(h[e].w, w[i + 3][c], a[e][c]);
            }
        }
#pragma unroll
        for (int off = CG; off < 32; off *= 2)
#pragma unroll
          for (int c = 0; c < kG; ++c)
#pragma unroll
            for (int e = 0; e < kFRows; ++e)
              a[e][c] += __shfl_xor_sync(0xffffffffu, a[e][c], off);
        if (kq == 0) {
#pragma unroll
          for (int e = 0; e < kFRows; ++e)
#pragma unroll
            for (int c = 0; c < kG; ++c) pw[rr[e] * C + c] = a[e][c];
        }
      }
    }
    // every item, step 0's too: a warp's count of an item then means that
    // every warp of the CTA published the item before
    __syncthreads();
    if (s > 0)
      for (int idx = tid; idx < rows * C; idx += kFThreads)
        sum[idx] = warp_sum(part + idx, (size_t)rb * C, n_active);
    cluster_sync();

    float* h_next = hbuf + (size_t)((s + 1) & 1) * N * H;
    const int n = r0 + cr;
    const bool mine = cr < rows;
    float hv = 0.0f, cv = 0.0f;
    if (mine) {
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float acc = 0.0f;
        if (s > 0) {
          const float* pq = sum + (size_t)cr * C + q * KU + rank * U + cu;
#pragma unroll
          for (int r2 = 0; r2 < kFCluster; ++r2) {
            const float v =
                r2 == (int)rank ? *pq : ld_cluster_f32(pq, (unsigned)r2);
            acc = r2 == 0 ? v : acc + v;
          }
        }
        g[q] = x[q] + acc;
      }
      cv = c_s[n * U + cu];
      hv = lstm_cell(g[0], g[1], g[2], g[3], cv);
      c_s[n * U + cu] = cv;
      h_next[(size_t)n * H + u0 + cu] = hv;
    }
    // h is published before ys and cs are stored
    publish(flags + blockIdx.x);
    if (mine) {
      const size_t o = ((size_t)t * ld_n + n) * H + u0 + cu;
      ys[o] = hv;
      if (kWriteCells) cs[o] = cv;
    }
  }
  cluster_sync();   // no CTA leaves while its tiles may be read
}

// The f32 kernel of depth slice kDepth and units 2 kG, with or without the
// cells.
template <int kDepth, int kG>
const void* f32_instance(bool cells) {
  return cells
      ? reinterpret_cast<const void*>(&lstm_f32_kernel<kDepth, kG, true>)
      : reinterpret_cast<const void*>(&lstm_f32_kernel<kDepth, kG, false>);
}
template <int kG>
const void* f32_kernel(int depth, bool cells) {
  switch (depth) {
    case 8: return f32_instance<8, kG>(cells);
    case 16: return f32_instance<16, kG>(cells);
    case 24: return f32_instance<24, kG>(cells);
    default: return f32_instance<32, kG>(cells);
  }
}

// The geometry of lstm_f32_kernel for N rows of width H: 6 units a CTA
// where H / 6 CTAs fit the card's SMs (128 at H=768), else 8; the depth
// slice of a lane rounded up to 8, 16, 24 or 32 rows (H <= 1024); all N
// rows in one block (one staging buffer) where that fits, else blocks of
// rb rows, as many as fit with two staging buffers, evened out over the N
// rows; rb U <= 256 (a thread a cell).
struct F32Plan {
  int units, depth, rb, stages;
  size_t smem;
};
int f32_plan(int N, int H, F32Plan* p) {
  if (H > 32 * kFMaxDepth) return -2;
  int rc, dev = 0, sms = 0, max_smem = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev)) != cudaSuccess)
    return rc;
  if ((rc = cudaDeviceGetAttribute(
           &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return rc;
  p->units = H % 6 == 0 && H / 6 <= sms ? 6 : 8;
  p->depth = ((H + 31) / 32 + 7) / 8 * 8;
  // floats a row: a staging buffer, the warps' tiles and the CTA's two
  const size_t buf = (size_t)kFWarps * (4 / kFCluster) * (p->depth + 4);
  const size_t tiles = (size_t)(kFWarps + 2) * 4 * kFCluster * p->units;
  const size_t fixed = (size_t)N * p->units * 4;
  const int cells_max = kFThreads / p->units;
  if (N <= cells_max && fixed + N * (buf + tiles) * 4 <= (size_t)max_smem) {
    p->rb = N;
    p->stages = 1;
  } else {
    const size_t row = (2 * buf + tiles) * 4;
    if (fixed + 2 * row > (size_t)max_smem) return -3;
    const int most = min(cells_max, (int)(((size_t)max_smem - fixed) / row));
    const int nb = (N + most - 1) / most;
    p->rb = (N + nb - 1) / nb;
    p->stages = 2;
  }
  p->smem = fixed + (p->stages * buf + tiles) * p->rb * 4;
  return 0;
}

int lstm_f32_launch(const void* xp, const void* w_hh, void* ys, void* cs,
                    void* hbuf, unsigned int* flags, int T, int N, int ld_n,
                    int H, int reverse, cudaStream_t st) {
  F32Plan p;
  int rc;
  if ((rc = f32_plan(N, H, &p)) != 0) return rc;
  const void* fn = p.units == 6 ? f32_kernel<3>(p.depth, cs != nullptr)
                                : f32_kernel<4>(p.depth, cs != nullptr);
  const float* a0 = static_cast<const float*>(xp);
  const float* a1 = static_cast<const float*>(w_hh);
  float* a2 = static_cast<float*>(ys);
  float* a3 = static_cast<float*>(cs);
  float* a4 = static_cast<float*>(hbuf);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &flags, &T, &N, &ld_n, &H,
                  &reverse, &p.rb, &p.stages};
  return launch_clusters(fn, H / p.units, kFCluster, kFThreads, p.smem, args,
                         st);
}

// A launch of lstm_bf16_wg_kernel in geometry G for N rows of width H on
// the current card: 1 KB to align the swizzled tiles, W's slice and the
// barriers; the rest for as many ring stages as fit, of the widest chunks
// of which two stages fit (Narrow at H=768: 256 columns, 3 chunks on 2
// stages; Wide: 128 columns, 6 chunks on 2 stages).  0, or -2 (the
// producer polls at most 64 flags), -3, -1 (the grid cannot be
// co-resident) or a cudaError_t.
struct WgPlan {
  const void* fn;
  int wide, threads, rows, blocks, subs, stages;
  size_t smem;
};
template <class G>
int wg_plan(int N, int H, bool cells, WgPlan* p) {
  if (H / kUnits > 64) return -2;   // the producer polls <= 64 flags
  int rc, dev = 0, max_smem = 0;
  if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(
           &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return rc;
  const size_t fixed = 1024 +
                       (size_t)(H + kHChunk - 1) / kHChunk * kCols *
                           kHChunk * 2 +
                       16 * kMaxStages;
  size_t stage = 0;
  p->stages = 0;
  for (p->subs = kMaxSubs; p->subs >= 1; p->subs /= 2) {
    stage = (size_t)p->subs * G::kRows * kHChunk * 2;
    p->stages = (max_smem - (int)fixed) / (int)stage;
    if (p->stages >= 2) break;
  }
  if (p->stages > kMaxStages) p->stages = kMaxStages;
  if (p->stages < 2) return -3;
  p->smem = fixed + p->stages * stage;
  p->fn = cells ? reinterpret_cast<const void*>(&lstm_bf16_wg_kernel<G, true>)
                : reinterpret_cast<const void*>(&lstm_bf16_wg_kernel<G, false>);
  p->wide = std::is_same<G, Wide>::value;
  p->threads = G::kThreads;
  p->rows = G::kRows;
  p->blocks = H / kUnits * ((N + G::kRows - 1) / G::kRows);
  return co_resident(p->fn, p->smem, p->blocks, p->threads);
}

// The geometry of a bf16 launch of kCRows < N <= kGroupRowsBf16 rows:
// Narrow wherever its grid is co-resident, else Wide.
int wg_choose(int N, int H, bool cells, WgPlan* p) {
  const int rc = wg_plan<Narrow>(N, H, cells, p);
  return rc == -1 ? wg_plan<Wide>(N, H, cells, p) : rc;
}

}  // namespace

extern "C" {

// xp [T, ld_n, 4H] and ys [T, ld_n, H] point at the first of this launch's
// N <= xna_lstm_group_rows(is_bf16) batch rows; w_hh [H, 4H]; all of one
// dtype (bf16 when is_bf16, else f32), contiguous.  cs: null for K1; for
// K3a, [T, ld_n, H] of that dtype like ys, which receives the cell states.
// hbuf: zeros of that dtype, xna_lstm_hbuf_elems(N, H) elements (h_0 and
// the exchange of h).  flags: H zeroed uint32 (the ready flags, one per
// CTA).  wide: null, or receives 1 where the launch took the wide
// geometry, else 0.  Returns 0, a cudaError_t, or -1 (grid cannot be
// co-resident), -2 (unsupported shape: H past 1024 in f32), -3
// (shared-memory request refused: H too large).
int xna_lstm_recurrence(const void* xp, const void* w_hh, void* ys, void* cs,
                        void* hbuf, void* flags, int T, int N, int ld_n,
                        int H, int reverse, int is_bf16, void* stream,
                        int* wide) {
  if (T < 1 || N < 1 || N > (is_bf16 ? kGroupRowsBf16 : kGroupRowsF32) ||
      ld_n < N || H < 16 || H % 16 != 0)
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int* ctr = static_cast<unsigned int*>(flags);
  int rc;
  if (wide) *wide = 0;
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
    WgPlan p;
    if ((rc = wg_choose(N, H, cs != nullptr, &p)) != 0) return rc;
    if (wide) *wide = p.wide;
    const bf16* a0 = static_cast<const bf16*>(xp);
    const bf16* a1 = static_cast<const bf16*>(w_hh);
    bf16* a2 = static_cast<bf16*>(ys);
    bf16* a3 = static_cast<bf16*>(cs);
    bf16* a4 = static_cast<bf16*>(hbuf);
    void* args[] = {&a0, &a1, &a2, &a3, &a4, &ctr, &T, &N, &ld_n, &H,
                    &reverse, &p.subs, &p.stages};
    // cooperative: the whole grid is resident (the CTAs wait on each
    // other's flags)
    rc = cudaLaunchCooperativeKernel(p.fn, dim3(p.blocks), dim3(p.threads),
                                     args, p.smem, st);
  } else {
    if ((rc = lstm_f32_launch(xp, w_hh, ys, cs, hbuf, ctr, T, N, ld_n, H,
                              reverse, st)) != 0)
      return rc;
  }
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

// The f32 route's geometry for a launch of N rows of width H on the
// current card: out[0..3] = units a CTA, depth rows a lane, rows a block,
// staging buffers.  0 or an error code as above.
int xna_lstm_f32_geometry(int N, int H, int* out) {
  if (N < 1 || N > kGroupRowsF32 || H < 16 || H % 16 != 0) return -2;
  F32Plan p;
  const int rc = f32_plan(N, H, &p);
  if (rc != 0) return rc;
  out[0] = p.units;
  out[1] = p.depth;
  out[2] = p.rb;
  out[3] = p.stages;
  return 0;
}

// The bf16 route's geometry for a launch of kCRows < N <=
// kGroupRowsBf16 rows of width H on the current card (K1; K3a's is the
// same): out[0..4] = 1 for the wide geometry (else 0), rows a tile, CTAs,
// columns a chunk of h, ring stages.  0 or an error code as above.
int xna_lstm_bf16_geometry(int N, int H, int* out) {
  if (N <= kCRows || N > kGroupRowsBf16 || H < 16 || H % 16 != 0) return -2;
  WgPlan p;
  const int rc = wg_choose(N, H, false, &p);
  if (rc != 0) return rc;
  out[0] = p.wide;
  out[1] = p.rows;
  out[2] = p.blocks;
  out[3] = p.subs * kHChunk;
  out[4] = p.stages;
  return 0;
}

// Batch rows one launch takes (bf16 when is_bf16, else f32); the wrapper
// splits larger batches.
int xna_lstm_group_rows(int is_bf16) {
  return is_bf16 ? kGroupRowsBf16 : kGroupRowsF32;
}

// Elements of the h exchange buffer of a launch of N rows: two buffers of
// the N > 64 path's padded layout (Np = N rounded up to the rows of a tile
// of either geometry, H rounded up to kHChunk columns), which hold the
// other paths' [2, N, H].
int xna_lstm_hbuf_elems(int N, int H) {
  const int np = max((N + Narrow::kRows - 1) / Narrow::kRows * Narrow::kRows,
                     (N + Wide::kRows - 1) / Wide::kRows * Wide::kRows);
  return 2 * np * ((H + kHChunk - 1) / kHChunk * kHChunk);
}

const char* xna_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
