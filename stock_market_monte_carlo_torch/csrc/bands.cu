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
// month the reduction: a log, the affine bin and its clamps (for the
// counts, a compare with two thresholds), and a shared-memory atomic.
// Device memory carries only the (T, cells) output.
//
// What the designs do about it:
// - hist_kernel. The TPU kernel keeps the whole (T, n_bins+2) table
//   resident in VMEM. Here it does not fit (360 x 1026 int32 = 1.48 MB
//   against 227 KB of shared memory a block), so the loop turns inside
//   out: one block owns one 8192-path tile, holds its running values in
//   shared memory (32 KB, 32 paths a thread) and loops the months outside.
//   Each month the block bins into a shared-memory cell histogram with
//   atomics, then flushes the non-zero cells into the chunk's (T, cells)
//   int32 output with global atomics. Two month histograms alternate, so a
//   month needs one barrier: buffer t & 1 is flushed and zeroed after month
//   t's barrier and written again only after month t+1's. Dead lanes
//   (paths at or past `valid`) are not simulated.
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
// - The draw key of a tile-month is hashed once per thread and month, not
//   once per path.
// - Built with -fmad=false: logv * A + B and the draw round as the torch
//   versions do. Integer atomics keep the counts independent of the order.
#include <algorithm>

#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Draw { kHistorical = 0, kGaussian = 1 };
enum Reduce { kHist = 0, kCdf = 1 };

// counts below thresholds: paths a thread, warp items, copies of the count
// table (at most), threads a block a copy
constexpr int kCdfPaths = 8;
constexpr int kItemPaths = 32 * kCdfPaths;
constexpr int kItemsPerTile = kTilePaths / kItemPaths;
constexpr int kCdfCopies = 4;
constexpr int kCdfCopyThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;

struct Args {
  const float* table;  // (k_chunks*128,) growth table; historical only
  int k_chunks;
  uint32_t n_table, tail_n;
  float a, b;           // growth a + b*z; Gaussian only
  const float* keep;    // (n_periods,) keep factors, or null
  const float* coef_a;  // (n_periods,) A_t; kHist only
  const float* coef_b;  // (n_periods,) B_t; kHist only
  const float* thr;     // (n_periods, n_cells) thresholds; kCdf only
  const float2* guess;  // (n_periods,) a_t, c_t of the guess; kCdf only
  int n_periods;
  uint32_t seed_base, tile0;
  int valid;
  float v0;
  int n_cells;          // kHist: n_bins + 2 cells; kCdf: K thresholds
  int* out;             // (n_periods, n_cells + mode), zeroed
};

// The growth of path `pos` of the tile-month keyed by h.
template <int DRAW>
__device__ __forceinline__ float growth(const Args& g, const float* s_table,
                                        uint32_t h, uint32_t pos) {
  const uint32_t w = arith_word(h, pos);
  if (DRAW == kHistorical)
    return bootstrap_growth(s_table, g.n_table, g.tail_n,
                            (uint32_t)g.k_chunks, h, w, pos & 127u,
                            pos & ~127u);
  return g.a + g.b * normal_z(w);
}

// The histogram cell of value v under the month's coefficients.
__device__ __forceinline__ int hist_cell(float v, float ca, float cb,
                                         int n_cells) {
  const float logv = logf(fmaxf(v, F(1e-37)));
  float x = floorf(logv * ca + cb);
  x = fminf(fmaxf(x, -1.0f), (float)(n_cells - 2));
  return (int)x + 1;
}

// The guess, in [1, k-1], of the number of a month's k thresholds on the
// log grid A + k * B that v is not below: gc = (a, c) of the month.
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

// (the int is cdf_kernel's copies, unused: both launch through one
// pointer type)
template <int DRAW, bool KEEP>
__global__ void __launch_bounds__(kBlock) hist_kernel(const Args g, int) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tab = DRAW == kHistorical ? g.k_chunks * 128 : 0;
  const int cells = g.n_cells;
  // the table first: its base is then a constant inside the month loop
  float* s_table = reinterpret_cast<float*>(smem);
  float* s_tot = s_table + n_tab;                          // kTilePaths
  int* s_cnt = reinterpret_cast<int*>(s_tot + kTilePaths);  // 2 x cells

  if (DRAW == kHistorical)
    for (int i = threadIdx.x; i < n_tab; i += kBlock) s_table[i] = g.table[i];
  for (int i = threadIdx.x; i < kTilePaths; i += kBlock) s_tot[i] = g.v0;
  for (int i = threadIdx.x; i < 2 * cells; i += kBlock) s_cnt[i] = 0;
  __syncthreads();

  const uint32_t seed = tile_seed(g.seed_base, g.tile0 + blockIdx.x);
  const int live = min(kTilePaths, g.valid - (int)blockIdx.x * kTilePaths);
  // paths pos = i * kBlock + threadIdx.x, i < mine, are this thread's
  const int mine = live > (int)threadIdx.x
                       ? (live - (int)threadIdx.x + kBlock - 1) / kBlock
                       : 0;

  for (int t = 0; t < g.n_periods; ++t) {
    int* cnt = s_cnt + (t & 1) * cells;
    const uint32_t h = tile_seed(seed, (uint32_t)t);
    const float keep = KEEP ? g.keep[t] : 1.0f;
    const float ca = g.coef_a[t];
    const float cb = g.coef_b[t];
    for (int i = 0; i < mine; ++i) {
      const uint32_t pos = (uint32_t)(i * kBlock) + threadIdx.x;
      float gfac = growth<DRAW>(g, s_table, h, pos);
      if (KEEP) gfac = gfac * keep;
      const float total = s_tot[pos] * gfac;
      s_tot[pos] = total;
      atomicAdd(&cnt[hist_cell(total, ca, cb, cells)], 1);
    }
    __syncthreads();
    // flush month t, and ready buffer (t & 1) for month t + 2
    int* row = g.out + (size_t)t * cells;
    for (int c = threadIdx.x; c < cells; c += kBlock) {
      const int v = cnt[c];
      if (v) {
        atomicAdd(&row[c], v);
        cnt[c] = 0;
      }
    }
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
  const int lane = threadIdx.x & 31;
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
      int j[kCdfPaths];
      bool ok[kCdfPaths];
#pragma unroll
      for (int i = 0; i < kCdfPaths; ++i) {
        float gfac = growth<DRAW>(g, s_table, h, pos0 + 32u * i);
        if (KEEP) gfac = gfac * keep;
        v[i] = v[i] * gfac;
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

// Dynamic shared memory of one block (bytes); kCdf with `copies` copies
// of the count table in blocks of copies * kCdfCopyThreads threads.
size_t smem_bytes(const Args& g, int mode, int draw, int copies) {
  const size_t tab = draw == kHistorical ? (size_t)g.k_chunks * 128 : 0;
  if (mode == kHist)
    return sizeof(float) * (tab + kTilePaths + 2 * (size_t)g.n_cells);
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
  int threads;   // a block
  size_t smem;   // dynamic shared memory a block, set as its maximum
  int per_sm;    // resident blocks a SM
  int n_blocks;  // the grid
};

// The kernel of (mode, draw, keep), its copies, block and shared memory,
// and its grid: a block a tile for kHist; for kCdf the most copies that
// fit in shared memory, and the blocks that fit on the card at once, or
// fewer where the chunk has fewer warp items than their warps.
cudaError_t plan(const Args& g, int mode, int draw, bool keep, Plan* p) {
  p->fn = pick(mode, draw, keep);
  if (!p->fn) return cudaErrorInvalidValue;
  p->copies = 1;
  if (mode == kCdf)
    for (int c = kCdfCopies; c > 1; c /= 2)
      if (smem_bytes(g, mode, draw, c) <= kMaxSmem) {
        p->copies = c;
        break;
      }
  p->threads = mode == kHist ? kBlock : p->copies * kCdfCopyThreads;
  p->smem = smem_bytes(g, mode, draw, p->copies);
  cudaError_t err = cudaFuncSetAttribute(
      p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &p->per_sm, p->fn, p->threads, p->smem)) != cudaSuccess)
    return err;
  if (mode == kHist) {
    p->n_blocks = (g.valid + kTilePaths - 1) / kTilePaths;
    return cudaSuccess;
  }
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

Args make_args(const float* table, int k_chunks, int n_table, int tail_n,
               float a, float b, const float* keep, const float* coef_a,
               const float* coef_b, const float* thr, const float* guess,
               int n_periods, unsigned int seed_base, unsigned int tile0,
               int valid, float v0, int n_cells, int* out) {
  return Args{table, k_chunks, (uint32_t)n_table, (uint32_t)tail_n, a, b,
              keep, coef_a, coef_b, thr,
              reinterpret_cast<const float2*>(guess), n_periods, seed_base,
              tile0, valid, v0, n_cells, out};
}

}  // namespace

// One chunk. mode: 0 histogram of n_cells cells (one block per 8192-path
// tile), 1 counts below the n_cells thresholds thr (T, n_cells), ascending
// along each row (out then has n_cells + 1 columns: paths not below j
// thresholds, j = 0..K; the blocks that fit on the card at once). draw: 0
// historical (table, k_chunks, n_table, tail_n), 1 Gaussian (a, b; table
// may be null). keep may be null. Mode 0 reads the bin coefficients coef_a
// and coef_b (T,); mode 1 the thresholds thr and guess (T, 2), the a_t, c_t
// of its guess (8-byte aligned). out must be zeroed. Returns the error of
// a block's shared memory that does not fit, else cudaGetLastError() after
// the launch.
extern "C" int smmc_bands(int mode, int draw, const float* table,
                          int k_chunks, int n_table, int tail_n, float a,
                          float b, const float* keep, const float* coef_a,
                          const float* coef_b, const float* thr,
                          const float* guess, int n_periods,
                          unsigned int seed_base, unsigned int tile0,
                          int valid, float v0, int n_cells, int* out,
                          void* stream) {
  const Args g = make_args(table, k_chunks, n_table, tail_n, a, b, keep,
                           coef_a, coef_b, thr, guess, n_periods, seed_base,
                           tile0, valid, v0, n_cells, out);
  Plan p;
  cudaError_t err = plan(g, mode, draw, keep != nullptr, &p);
  if (err != cudaSuccess) return err;
  p.fn<<<p.n_blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      g, p.copies);
  return cudaGetLastError();
}

// What smmc_bands would launch for a chunk of `valid` paths: info[0..6] =
// registers a thread, static shared memory, dynamic shared memory (bytes),
// threads a block, resident blocks a SM, blocks of the grid, copies of the
// count table. Returns a cudaError_t.
extern "C" int smmc_bands_info(int mode, int draw, int keep, int k_chunks,
                               int n_periods, int valid, int n_cells,
                               int* info) {
  const Args g = make_args(nullptr, k_chunks, 0, 0, 0.0f, 0.0f, nullptr,
                           nullptr, nullptr, nullptr, nullptr, n_periods, 0u,
                           0u, valid, 0.0f, n_cells, nullptr);
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
// What the design does about it: one thread per (k, c) output, looping over
// the 64 rows of its lane; neighbouring threads read neighbouring lanes.
namespace {

constexpr int kTileRows = 64;

__global__ void __launch_bounds__(smmc::kBlock)
counts_below_tile_kernel(const float* __restrict__ tl,
                         const float* __restrict__ thr, int n_out,
                         int* __restrict__ out) {
  const int i = blockIdx.x * smmc::kBlock + threadIdx.x;
  if (i >= n_out) return;
  const int c = i & 127;
  const float t = thr[i];
  int n = 0;
  for (int r = 0; r < kTileRows; ++r) n += tl[r * 128 + c] < t ? 1 : 0;
  out[i] = n;
}

}  // namespace

// tl (64, 128), thr (k_rows, 128) float32; out (k_rows, 128) int32.
// Returns cudaGetLastError() after the launch.
extern "C" int smmc_counts_below_tile(const float* tl, const float* thr,
                                      int k_rows, int* out, void* stream) {
  const int n_out = k_rows * 128;
  counts_below_tile_kernel<<<(n_out + smmc::kBlock - 1) / smmc::kBlock,
                             smmc::kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      tl, thr, n_out, out);
  return cudaGetLastError();
}
