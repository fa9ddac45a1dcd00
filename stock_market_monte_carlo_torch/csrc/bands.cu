// Band kernels: the month loop with a reduction of every month's values;
// at the end of the file, the counts below one tile's thresholds.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_bands.py
// - _build_bands_kernel (built by _build_bands_call, pl.pallas_call at
//   :249; run by pallas_chunk_month_hist): per-month histograms of the
//   running values, cell clip(floor(log(max(V, 1e-37)) * A_t + B_t) + 1,
//   0, n_bins + 1) -- hist_kernel below;
// - _build_cdf_kernel (built by _build_cdf_call, pl.pallas_call at :494;
//   run by pallas_chunk_month_cdf): per-month counts of values below K
//   thresholds exp(A_t + kk_k * B_t), kk_k = k but for the guard rows 0
//   and K-1 at kappa_lo and kappa_hi -- cdf_kernel below.
// Plain versions: ops/bands.py month_hist_chunk_plain and
// month_cdf_chunk_plain.
//
// The month step is the one of month_loop.cu (one word of the arithmetic
// counter stream per path and month, the kHistorical or kGaussian draw),
// with a percent strategy's keep factor folded into the growth first,
// V *= g * keep, as the JAX band kernels do: a seed, offset and months
// give the sample of the stats kernels. Both kernels emit months 1..T;
// the caller adds month 0.
//
// What bounds them on an H100: arithmetic, as for the month loop: the draw
// (two hashes and ~35 float ops for the Gaussian draw, up to four hashes,
// two index maps and a gather for the historical one), plus per path and
// month the reduction: the cell (for the histogram a log, the affine bin
// and its clamps; for the counts, a compare with two thresholds) and a
// shared-memory atomic. Device memory carries only the (T, cells) output.
//
// What the designs do about it:
// - hist_kernel. The TPU kernel keeps the whole (T, n_bins+2) table
//   resident in VMEM. Here it does not fit (360 x 1026 int32 = 1.48 MB
//   against 227 KB of shared memory a block), but a window of W months
//   does (8.2 KB a month at 1026 cells with their edges). So the months
//   run in windows:
//   * A persistent grid of 1024-thread blocks (the blocks that fit at
//     once, one a SM at 1026 cells), each warp walking a contiguous range
//     of the chunk's 256-path warp items, as cdf_kernel below; lane l
//     holds the 8 paths pos0 + 32 i of its item in registers.
//   * For each window of months, a warp runs each of its items through
//     the window's months, binning into the block's shared (W, cells)
//     counts with shared-memory atomics. An item's 8 running values come
//     from a device scratch (v0 in the first window) and go back to it
//     (not after the last window): 2^24 x 8 bytes a chunk and window,
//     coalesced, each warp reading back only what it wrote itself. Then
//     one barrier and one flush of the window's non-zero cells into the
//     chunk's (T, cells) int32 output with global atomics: ~132 blocks x
//     T x cells cell visits a chunk in place of one flush and one barrier
//     a block-month (2048 x T x cells). W is the most months whose counts
//     and edges fit beside the table, evened out over the windows (26 at
//     360 x 1026 beside the 1127-row table, 14 windows).
//   * The cell without a log. The cell of V, clip(floor(log(max(V,
//     1e-37)) * A_t + B_t) + 1), does not decrease as V grows (A_t > 0,
//     which the wrapper checks on a host copy, and a log that does not
//     decrease, which the card's tests check of torch.log over every
//     float), so it is the number of the month's cell edges -- the least
//     float of each cell, bisected by the wrapper over the float bit
//     patterns with the plain version's torch.log (ops/bands.py
//     hist_edges) -- that max(V, 1e-37) is not below. As cdf_kernel does
//     for its thresholds, it is guessed as floor((log2 V - a_t) * c_t)
//     with the fast log2 (one MUFU.LG2; c_t = A_t ln 2, a_t = -(B_t + 1) /
//     c_t, the wrapper's), checked against the edge pair about it in
//     shared memory and walked only where the check fails: exactly the
//     plain version's cell, NaN and values under 1e-37 in the cell of
//     1e-37, +inf in the last.
//   * Paths at or past `valid` are simulated and not counted.
// - cdf_kernel (counts below thresholds). Its table is small: T x (K+1)
//   int32, 47.5 KB at 360 x 33, so each block keeps all of it in shared
//   memory and flushes it once, at its end; no barrier between months.
//   * The cell by arithmetic. A month's thresholds increase along k (B_t >
//     0, ordered kk; the wrapper checks on the host), so a path below
//     threshold k is below every later one, and the kernel counts per path
//     the number j of thresholds it is not below; the wrapper's cumulative
//     sum over j <= k gives the counts below k. The interior thresholds lie
//     on an affine log grid, log thr[t, k] ~ A_t + k * B_t, so j is guessed
//     as floor((log2 V - a_t) * c_t) with the fast log2 (one MUFU.LG2) and
//     the wrapper's a_t = (A_t - B_t) log2 e, c_t = ln 2 / B_t (that is,
//     floor((ln V - A_t) / B_t) + 1), clamped in float to [1, K-1] before
//     the int conversion, and checked against the pair
//     (thr[t, j-1], thr[t, j]) in one 8-byte shared-memory load; only a
//     guess the check rejects (a value within the log's error of a
//     threshold, past a guard, tied thresholds) walks: down while v <
//     thr[t, j-1], up while !(v < thr[t, j]). The result is exactly #{k :
//     !(v < thr[t, k])}, whatever the log rounds to: NaN climbs to K, +inf
//     lands in K, 0 and denormals where the strict < puts them. The (T, K)
//     thresholds are the plain version's (cdf_thresholds, computed once a
//     launch by the wrapper on the card); each warp stages its month's row
//     and its pairs in shared memory (one 128-byte line a month).
//   * Running values in registers: a thread owns kCdfPaths paths of one
//     256-path warp item (lane + 32 i, unrolled). The guesses and checks
//     of its paths run first, without a branch, so they interleave; the
//     rare walks and the atomics follow. No value goes through shared
//     memory.
//   * Fewer same-address atomics: the 32 lanes of a warp add into few
//     cells (a month's paths spread over ~10 of the 33), and a shared
//     atomic serialises the lanes that hit one address. Lane l adds into
//     copy l % copies of the count table (interleaved, so the copies of a
//     cell sit in neighbouring banks); the flush sums the copies. 4 copies
//     (190 KB at 360 x 33, blocks of 1024 threads, one a SM) where they fit
//     in shared memory, else 2 or 1 (blocks of 256 threads a copy).
//   * A grid that fills the card: the blocks that fit at once (occupancy
//     API), each warp walking a contiguous range of the chunk's 256-path
//     warp items (65536 in a 2^24-path chunk; ranges differ by at most
//     one item). The counter stream is a pure function of (tile seed,
//     month key, position), so any split of a tile gives the same sample;
//     a warp hashes its item's tile seed and each tile-month key itself.
//   * Paths at or past `valid` are simulated and not counted.
// - Both kernels draw a warp item's month with item_growth. A warp item is
//   two whole 128-path rows of its tile, and a row's lane-0 word (the
//   rotation of the historical draw) is lane 0's own word of path i = 0
//   (i = 4): one shuffle a row-month in place of a hash a path-month. The
//   source lane's word stays a recomputed hash. The Gaussian draw takes
//   normal_z_warp: the item and month loops are the same for every lane of
//   a warp, and every lane runs every path (paths at or past `valid` too),
//   so the warp is whole at its vote, and the erfinv's tail polynomial runs
//   only where one of the warp's 32 lanes needs it (w >= 5; about one warp
//   draw in ten), not on every path. The same operations on every value,
//   so the same bits.
// - The draw key of a tile-month is hashed once per thread and month, not
//   once per path.
// - Built with -fmad=false: the draw rounds as the torch versions do.
//   Integer atomics keep the counts independent of the order.
#include <algorithm>

#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Draw { kHistorical = 0, kGaussian = 1 };
enum Reduce { kHist = 0, kCdf = 1 };

// both kernels: paths a thread, warp items; counts below thresholds:
// copies of the count table (at most), threads a block a copy
constexpr int kCdfPaths = 8;
constexpr int kItemPaths = 32 * kCdfPaths;
constexpr int kItemsPerTile = kTilePaths / kItemPaths;
constexpr int kCdfCopies = 4;
constexpr int kCdfCopyThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

// band histogram: threads a block
constexpr int kHistThreads = 1024;

struct Args {
  const float* table;  // (k_chunks*128,) growth table; historical only
  int k_chunks;
  uint32_t n_table, tail_n;
  float a, b;           // growth a + b*z; Gaussian only
  const float* keep;    // (n_periods,) keep factors, or null
  // (n_periods,) A_t, B_t: read by no kernel (the histogram's cells come
  // from its edges); kept so that cdf_kernel's parameters keep their place
  const float* coef_a;
  const float* coef_b;
  const float* thr;     // (n_periods, n_cells) thresholds; kCdf only
  const float2* guess;  // (n_periods,) a_t, c_t of the guess
  int n_periods;
  uint32_t seed_base, tile0;
  int valid;
  float v0;
  int n_cells;          // kHist: n_bins + 2 cells; kCdf: K thresholds
  int* out;             // (n_periods, n_cells + mode), zeroed
  const float* edges;   // (n_periods, n_cells - 1) cell edges; kHist only
  float* vals;          // (warp items x 256,) running values; kHist only
};

// The guess, in [1, k-1], of the number of a month's k thresholds (the
// cell edges, for the histogram) on a log grid that v is not below: gc =
// (a, c) of the month.
__device__ __forceinline__ int cdf_guess(float v, float2 gc, int k) {
  const float x = floorf((__log2f(fmaxf(v, F(1e-37))) - gc.x) * gc.y);
  return (int)fminf(fmaxf(x, 1.0f), (float)(k - 1));
}

// A guess j of the number of a month's k ascending thresholds `thr` that v
// is not below, walked to exactly #{k : !(v < thr[k])}.
__device__ __forceinline__ int cdf_walk(float v, const float* thr, int j,
                                        int k) {
  while (j > 0 && v < thr[j - 1]) --j;
  while (j < k && !(v < thr[j])) ++j;
  return j;
}

// The growth of the 8 paths pos0 + 32 i of a warp item (pos0 = the item's
// first path + lane), keyed by h: the two rows' lane-0 words are shuffled
// from lane 0's paths 0 and 4 (historical draw), the erfinv's tail taken
// by a warp vote (Gaussian draw). Every lane of the warp takes part.
template <int DRAW>
__device__ __forceinline__ void item_growth(const Args& g,
                                            const float* s_table, uint32_t h,
                                            uint32_t pos0, uint32_t lane,
                                            float (&gfac)[kCdfPaths]) {
  uint32_t w[kCdfPaths];
#pragma unroll
  for (int i = 0; i < kCdfPaths; ++i) w[i] = arith_word(h, pos0 + 32u * i);
  if constexpr (DRAW == kHistorical) {
    const uint32_t row0 = pos0 - lane;
    const uint32_t w0[2] = {__shfl_sync(0xffffffffu, w[0], 0),
                            __shfl_sync(0xffffffffu, w[4], 0)};
#pragma unroll
    for (int i = 0; i < kCdfPaths; ++i)
      gfac[i] = bootstrap_growth_w0(
          s_table, g.n_table, g.tail_n, (uint32_t)g.k_chunks, h, w[i],
          w0[i / 4], lane + 32u * (i % 4), row0 + 128u * (i / 4));
  } else {
#pragma unroll
    for (int i = 0; i < kCdfPaths; ++i)
      gfac[i] = g.a + g.b * normal_z_warp(w[i]);
  }
}

// The cell edges of months t0 .. t1-1 into shared memory.
__device__ __forceinline__ void stage_edges(const Args& g, float* s_edge,
                                            int t0, int t1) {
  const int k = g.n_cells - 1;
  const float* src = g.edges + (size_t)t0 * k;
  for (int i = threadIdx.x; i < (t1 - t0) * k; i += blockDim.x)
    s_edge[i] = src[i];
}

template <int DRAW, bool KEEP>
__global__ void __launch_bounds__(kHistThreads, 1)
    hist_kernel(const Args g, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tab = DRAW == kHistorical ? g.k_chunks * 128 : 0;
  const int cells = g.n_cells;
  const int k = cells - 1;  // edges a month
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const uint32_t lane = threadIdx.x & 31;
  // the table, the window's (window, cells) counts and (window, k) edges
  float* s_table = reinterpret_cast<float*>(smem);
  int* s_cnt = reinterpret_cast<int*>(s_table + n_tab);
  float* s_edge = reinterpret_cast<float*>(s_cnt + window * cells);

  if (DRAW == kHistorical)
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x)
      s_table[i] = g.table[i];
  for (int i = threadIdx.x; i < window * cells; i += blockDim.x) s_cnt[i] = 0;
  stage_edges(g, s_edge, 0, min(window, g.n_periods));
  __syncthreads();

  // this warp's contiguous range of the chunk's warp items
  const long long n_warps = (long long)gridDim.x * warps;
  const long long gw = (long long)blockIdx.x * warps + warp;
  const long long n_items = (g.valid + kItemPaths - 1) / kItemPaths;
  const int first = (int)(gw * n_items / n_warps);
  const int last = (int)((gw + 1) * n_items / n_warps);

  for (int t0 = 0; t0 < g.n_periods; t0 += window) {
    const int t1 = min(t0 + window, g.n_periods);
    for (int item = first; item < last; ++item) {
      const int tile = item / kItemsPerTile;
      // paths pos0 + 32 i of the tile; path i counts while 32 i < live
      const uint32_t pos0 = (uint32_t)(item % kItemsPerTile) * kItemPaths +
                            lane;
      const int live = g.valid - tile * kTilePaths - (int)pos0;
      const uint32_t seed = tile_seed(g.seed_base, g.tile0 + (uint32_t)tile);
      float* vals = g.vals + (size_t)item * kItemPaths + lane;
      float v[kCdfPaths];
#pragma unroll
      for (int i = 0; i < kCdfPaths; ++i) v[i] = t0 ? vals[32 * i] : g.v0;
      for (int t = t0; t < t1; ++t) {
        const uint32_t h = tile_seed(seed, (uint32_t)t);
        const float keep = KEEP ? g.keep[t] : 1.0f;
        const float2 gc = g.guess[t];
        const float* row = s_edge + (t - t0) * k;
        int* cnt = s_cnt + (t - t0) * cells;
        float gfac[kCdfPaths];
        item_growth<DRAW>(g, s_table, h, pos0, lane, gfac);
        // every guess and check first, without a branch; then the rare
        // walks and the atomics
        int j[kCdfPaths];
        bool ok[kCdfPaths];
#pragma unroll
        for (int i = 0; i < kCdfPaths; ++i) {
          if (KEEP) gfac[i] = gfac[i] * keep;
          v[i] = v[i] * gfac[i];
          const float x = fmaxf(v[i], F(1e-37));
          j[i] = cdf_guess(x, gc, k);
          ok[i] = !(x < row[j[i] - 1]) && x < row[j[i]];
        }
#pragma unroll
        for (int i = 0; i < kCdfPaths; ++i) {
          const int c = ok[i] ? j[i]
                              : cdf_walk(fmaxf(v[i], F(1e-37)), row, j[i], k);
          if (32 * i < live) atomicAdd(&cnt[c], 1);
        }
      }
      if (t1 < g.n_periods) {
#pragma unroll
        for (int i = 0; i < kCdfPaths; ++i) vals[32 * i] = v[i];
      }
    }
    // flush the window's months, and ready the counts and edges for the
    // next window
    __syncthreads();
    int* rows = g.out + (size_t)t0 * cells;
    for (int c = threadIdx.x; c < (t1 - t0) * cells; c += blockDim.x) {
      const int n = s_cnt[c];
      if (n) {
        atomicAdd(&rows[c], n);
        s_cnt[c] = 0;
      }
    }
    if (t1 < g.n_periods)
      stage_edges(g, s_edge, t1, min(t1 + window, g.n_periods));
    __syncthreads();
  }
}

template <int DRAW, bool KEEP>
__global__ void __launch_bounds__(kCdfCopies * kCdfCopyThreads)
    cdf_kernel(const Args g, int copies) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tab = DRAW == kHistorical ? g.k_chunks * 128 : 0;
  const int k = g.n_cells;
  const int cells = k + 1;
  const int n_cnt = g.n_periods * cells;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const uint32_t lane = threadIdx.x & 31;
  // the table, each warp's month pairs (thr[j-1], thr[j]) and row, then
  // the count table: cell c of copy r at c * copies + r
  float* s_table = reinterpret_cast<float*>(smem);
  float2* w_pair = reinterpret_cast<float2*>(s_table + n_tab) + warp * k;
  float* w_row = reinterpret_cast<float*>(
                     reinterpret_cast<float2*>(s_table + n_tab) + warps * k) +
                 warp * k;
  int* s_cnt = reinterpret_cast<int*>(
      reinterpret_cast<float*>(reinterpret_cast<float2*>(s_table + n_tab) +
                               warps * k) +
      warps * k);

  if (DRAW == kHistorical)
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x)
      s_table[i] = g.table[i];
  for (int i = threadIdx.x; i < n_cnt * copies; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();

  // this warp's contiguous range of the chunk's warp items
  const long long n_warps = (long long)gridDim.x * warps;
  const long long gw = (long long)blockIdx.x * warps + warp;
  const long long n_items = (g.valid + kItemPaths - 1) / kItemPaths;
  const int first = (int)(gw * n_items / n_warps);
  const int last = (int)((gw + 1) * n_items / n_warps);
  int* lane_cnt = s_cnt + (lane & (copies - 1));

  for (int item = first; item < last; ++item) {
    const int tile = item / kItemsPerTile;
    // paths pos0 + 32 i of the tile; path i counts while 32 i < live
    const uint32_t pos0 =
        (uint32_t)((item % kItemsPerTile) * kItemPaths + lane);
    const int live = g.valid - tile * kTilePaths - (int)pos0;
    const uint32_t seed = tile_seed(g.seed_base, g.tile0 + (uint32_t)tile);
    float v[kCdfPaths];
#pragma unroll
    for (int i = 0; i < kCdfPaths; ++i) v[i] = g.v0;
    for (int t = 0; t < g.n_periods; ++t) {
      const uint32_t h = tile_seed(seed, (uint32_t)t);
      const float keep = KEEP ? g.keep[t] : 1.0f;
      const float2 gc = g.guess[t];
      // the month's row and pairs, after the warp's last reads of the
      // previous month's
      const float* thr = g.thr + (size_t)t * k;
      __syncwarp();
      for (int c = lane; c < k; c += 32) {
        const float hi = __ldg(thr + c);
        w_row[c] = hi;
        if (c > 0) w_pair[c] = make_float2(__ldg(thr + c - 1), hi);
      }
      __syncwarp();
      float gfac[kCdfPaths];
      item_growth<DRAW>(g, s_table, h, pos0, lane, gfac);
      int j[kCdfPaths];
      bool ok[kCdfPaths];
#pragma unroll
      for (int i = 0; i < kCdfPaths; ++i) {
        if (KEEP) gfac[i] = gfac[i] * keep;
        v[i] = v[i] * gfac[i];
        j[i] = cdf_guess(v[i], gc, k);
        const float2 pair = w_pair[j[i]];
        ok[i] = !(v[i] < pair.x) && v[i] < pair.y;
      }
      int* cnt = lane_cnt + t * cells * copies;
#pragma unroll
      for (int i = 0; i < kCdfPaths; ++i) {
        const int jj = ok[i] ? j[i] : cdf_walk(v[i], w_row, j[i], k);
        if (32 * i < live) atomicAdd(&cnt[jj * copies], 1);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n_cnt; c += blockDim.x) {
    int sum = 0;
    for (int r = 0; r < copies; ++r) sum += s_cnt[c * copies + r];
    if (sum) atomicAdd(&g.out[c], sum);
  }
}

// Dynamic shared memory of one block (bytes); kHist with a window of
// `window` months, kCdf with `copies` copies of the count table in blocks
// of copies * kCdfCopyThreads threads.
size_t smem_bytes(const Args& g, int mode, int draw, int copies,
                  int window) {
  const size_t tab = draw == kHistorical ? (size_t)g.k_chunks * 128 : 0;
  if (mode == kHist)
    return sizeof(float) * (tab + (size_t)window * (2 * g.n_cells - 1));
  const size_t warps = (size_t)copies * kCdfCopyThreads / 32;
  return sizeof(float) * (tab + warps * 3 * g.n_cells +
                          (size_t)copies * g.n_periods * (g.n_cells + 1));
}

using Kernel = void (*)(const Args, int);

template <int DRAW, bool KEEP>
Kernel pick_reduce(int mode) {
  switch (mode) {
    case kHist: return hist_kernel<DRAW, KEEP>;
    case kCdf: return cdf_kernel<DRAW, KEEP>;
    default: return nullptr;
  }
}

Kernel pick(int mode, int draw, bool keep) {
  switch (draw) {
    case kHistorical:
      return keep ? pick_reduce<kHistorical, true>(mode)
                  : pick_reduce<kHistorical, false>(mode);
    case kGaussian:
      return keep ? pick_reduce<kGaussian, true>(mode)
                  : pick_reduce<kGaussian, false>(mode);
    default: return nullptr;
  }
}

// How one chunk launches.
struct Plan {
  Kernel fn;
  int copies;    // copies of the count table (kCdf; 1 for kHist)
  int window;    // months of a window (kHist; n_periods for kCdf)
  int windows;   // windows of the months (kHist; 1 for kCdf)
  int threads;   // a block
  size_t smem;   // dynamic shared memory a block, set as its maximum
  int per_sm;    // resident blocks a SM
  int n_blocks;  // the grid
};

// The kernel of (mode, draw, keep), its copies or window, block and shared
// memory, and its grid. kHist: the fewest windows of months whose counts
// and edges fit in shared memory beside the table, evened out (at least
// one month; the error of a month that does not fit otherwise); kCdf: the
// most copies that fit. The grid: the blocks that fit on the card at once, or fewer
// where the chunk has fewer warp items than their warps.
cudaError_t plan(const Args& g, int mode, int draw, bool keep, Plan* p) {
  p->fn = pick(mode, draw, keep);
  if (!p->fn) return cudaErrorInvalidValue;
  p->copies = 1;
  p->window = g.n_periods;
  p->windows = 1;
  if (mode == kHist) {
    const size_t month = smem_bytes(g, mode, draw, 1, 1) -
                         smem_bytes(g, mode, draw, 1, 0);
    const size_t tab = smem_bytes(g, mode, draw, 1, 0);
    if (g.n_periods < 1 || g.n_cells < 3 || tab + month > kMaxSmem)
      return cudaErrorInvalidValue;
    const int most = (int)std::min<size_t>(g.n_periods,
                                           (kMaxSmem - tab) / month);
    p->windows = (g.n_periods + most - 1) / most;
    p->window = (g.n_periods + p->windows - 1) / p->windows;
  } else {
    for (int c = kCdfCopies; c > 1; c /= 2)
      if (smem_bytes(g, mode, draw, c, 0) <= kMaxSmem) {
        p->copies = c;
        break;
      }
  }
  p->threads = mode == kHist ? kHistThreads : p->copies * kCdfCopyThreads;
  p->smem = smem_bytes(g, mode, draw, p->copies, p->window);
  cudaError_t err = cudaFuncSetAttribute(
      p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &p->per_sm, p->fn, p->threads, p->smem)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int items = (g.valid + kItemPaths - 1) / kItemPaths;
  const int warps = p->threads / 32;
  p->n_blocks = std::max(1, std::min(sms * std::max(1, p->per_sm),
                                     (items + warps - 1) / warps));
  return cudaSuccess;
}

// buf: the thresholds (kCdf), or the cell edges and then the running
// values' scratch (kHist)
Args make_args(int mode, const float* table, int k_chunks, int n_table,
               int tail_n, float a, float b, const float* keep,
               const float* coef_a, const float* coef_b, float* buf,
               const float* guess, int n_periods, unsigned int seed_base,
               unsigned int tile0, int valid, float v0, int n_cells,
               int* out) {
  const bool hist = mode == kHist;
  return Args{table, k_chunks, (uint32_t)n_table, (uint32_t)tail_n, a, b,
              keep, coef_a, coef_b, hist ? nullptr : buf,
              reinterpret_cast<const float2*>(guess), n_periods, seed_base,
              tile0, valid, v0, n_cells, out, hist ? buf : nullptr,
              hist && buf ? buf + (size_t)n_periods * (n_cells - 1)
                          : nullptr};
}

}  // namespace

// One chunk. mode: 0 histogram of n_cells >= 3 cells, 1 counts below the
// n_cells thresholds (T, n_cells) in buf, ascending along each row (out
// then has n_cells + 1 columns: paths not below j thresholds, j = 0..K);
// both on the blocks that fit on the card at once. draw: 0 historical
// (table, k_chunks, n_table, tail_n), 1 Gaussian (a, b; table may be
// null). keep may be null. Both read guess (T, 2), the a_t, c_t of their
// guess of a value's cell (8-byte aligned). Mode 0: buf holds the (T,
// n_cells - 1) cell edges (the cell of V is the number of its month's
// edges that fmax(V, 1e-37) is not below), then a scratch of the running
// values of at least ceil(valid / 256) * 256 floats, which it overwrites;
// coef_a and coef_b are not read. Mode 1: buf holds the thresholds. out
// must be zeroed. Returns the error of a block's shared memory that does not
// fit, else cudaGetLastError() after the launch.
extern "C" int smmc_bands(int mode, int draw, const float* table,
                          int k_chunks, int n_table, int tail_n, float a,
                          float b, const float* keep, const float* coef_a,
                          const float* coef_b, float* buf,
                          const float* guess, int n_periods,
                          unsigned int seed_base, unsigned int tile0,
                          int valid, float v0, int n_cells, int* out,
                          void* stream) {
  const Args g = make_args(mode, table, k_chunks, n_table, tail_n, a, b,
                           keep, coef_a, coef_b, buf, guess, n_periods,
                           seed_base, tile0, valid, v0, n_cells, out);
  Plan p;
  cudaError_t err = plan(g, mode, draw, keep != nullptr, &p);
  if (err != cudaSuccess) return err;
  p.fn<<<p.n_blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      g, mode == kHist ? p.window : p.copies);
  return cudaGetLastError();
}

// What smmc_bands would launch for a chunk of `valid` paths: info[0..8] =
// registers a thread, static shared memory, dynamic shared memory (bytes),
// threads a block, resident blocks a SM, blocks of the grid, copies of the
// count table, months a window, windows. Returns a cudaError_t.
extern "C" int smmc_bands_info(int mode, int draw, int keep, int k_chunks,
                               int n_periods, int valid, int n_cells,
                               int* info) {
  const Args g = make_args(mode, nullptr, k_chunks, 0, 0, 0.0f, 0.0f,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           n_periods, 0u, 0u, valid, 0.0f, n_cells, nullptr);
  Plan p;
  cudaError_t err = plan(g, mode, draw, keep != 0, &p);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, p.fn)) != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = (int)p.smem;
  info[3] = p.threads;
  info[4] = p.per_sm;
  info[5] = p.n_blocks;
  info[6] = p.copies;
  info[7] = p.window;
  info[8] = p.windows;
  return cudaSuccess;
}

// Counts below a tile's thresholds: out[k, c] = #{r < 64 : tl[r, c] <
// thr[k, c]}, strict <.
//
// Replaces: the test-local kernel of tests/test_bands.py:464 (pl.pallas_call
// at :468) around stock_market_monte_carlo_tpu/ops/pallas_bands.py:309
// _counts_below_tile (the roll, rows and bcast3d layouts, which count
// alike). Plain version: ops/bands.py counts_below_tile_plain.
//
// A different function from cdf_cell above: the thresholds here are neither
// sorted along k nor equal across lanes, so there is no cell to find.
//
// What bounds it on an H100: nothing of the card. A launch reads 32 KB of
// values and K x 512 B of thresholds and writes K x 512 B of counts, under
// 0.1 us at 3.35 TB/s; a launch costs its latency.
//
// What the design does about it: one block a threshold row, four threads an
// output (k, c), each counting 16 of the 64 rows of lane c; neighbouring
// threads read neighbouring lanes. A thread's 16 loads are all in flight
// before its first compare, so the launch waits for one round trip to L2;
// the four partial counts meet in shared memory. One thread an output
// looping over 64 rows waited for several: ptxas keeps it at 32 to 48
// registers, so a compare comes after the first 22 to 39 loads.
namespace {

constexpr int kTileRows = 64;
constexpr int kParts = 4;                          // threads an output
constexpr int kPartRows = kTileRows / kParts;
static_assert(kParts == 4, "the kernel adds four parts by name");

__global__ void __launch_bounds__(128 * kParts)
counts_below_tile_kernel(const float* __restrict__ tl,
                         const float* __restrict__ thr,
                         int* __restrict__ out) {
  __shared__ int part[kParts][128];
  const int c = threadIdx.x, q = threadIdx.y;
  const int i = blockIdx.x * 128 + c;
  const float t = thr[i];
  float v[kPartRows];
#pragma unroll
  for (int r = 0; r < kPartRows; ++r)
    v[r] = tl[(q * kPartRows + r) * 128 + c];
  int n = 0;
  // strict <: NaN on either side counts 0
#pragma unroll
  for (int r = 0; r < kPartRows; ++r) n += v[r] < t ? 1 : 0;
  part[q][c] = n;
  __syncthreads();
  if (q == 0) out[i] = part[0][c] + part[1][c] + part[2][c] + part[3][c];
}

}  // namespace

// tl (64, 128), thr (k_rows, 128) float32; out (k_rows, 128) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int smmc_counts_below_tile(const float* tl, const float* thr,
                                      int k_rows, int* out, void* stream) {
  counts_below_tile_kernel<<<k_rows, dim3(128, kParts), 0,
                             static_cast<cudaStream_t>(stream)>>>(tl, thr,
                                                                  out);
  return cudaGetLastError();
}
