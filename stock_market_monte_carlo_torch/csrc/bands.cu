// Band kernels: the month loop with a reduction of every month's values;
// at the end of the file, the counts below one tile's thresholds.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_bands.py
// - _build_bands_kernel (built by _build_bands_call, pl.pallas_call at
//   :249; run by pallas_chunk_month_hist): per-month histograms of the
//   running values, cell clip(floor(log(max(V, 1e-37)) * A_t + B_t) + 1,
//   0, n_bins + 1);
// - _build_cdf_kernel (built by _build_cdf_call, pl.pallas_call at :494;
//   run by pallas_chunk_month_cdf): per-month counts of values below K
//   thresholds exp(A_t + kk_k * B_t), kk_k = k but for the guard rows 0
//   and K-1 at kappa_lo and kappa_hi.
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
// What bounds it on an H100: arithmetic, as for the month loop: the draw
// (two hashes and ~35 float ops for the Gaussian draw, up to four hashes,
// two index maps and a gather for the historical one), plus per path and
// month the reduction: logf, the affine bin and its clamps for the
// histogram; a binary search over the month's K thresholds for the counts.
// Device memory carries only the (T, cells) output.
//
// What the design does about it:
// - The TPU kernel keeps the whole (T, n_bins+2) table resident in VMEM.
//   Here it does not fit (360 x 1026 int32 = 1.48 MB against 227 KB of
//   shared memory a block), so the loop turns inside out: one block owns
//   one 8192-path tile, holds its running values in shared memory (32 KB,
//   32 paths a thread) and loops the months outside. Each month the block
//   bins into a shared-memory cell histogram with atomics, then flushes the
//   non-zero cells into the chunk's (T, cells) int32 output with global
//   atomics. Two month histograms alternate, so a month needs one barrier:
//   buffer t & 1 is flushed and zeroed after month t's barrier and written
//   again only after month t+1's.
// - The draw key of a tile-month is hashed once per thread and month, not
//   once per path.
// - Counts below thresholds: the thresholds of a month increase along k
//   (B_t > 0, ordered kk; the wrapper checks), so a path below threshold k
//   is below every later one. The kernel counts, per path, the number j of
//   thresholds it is not below (binary search) in a K+1-cell histogram;
//   the wrapper's cumulative sum over j <= k gives the counts below k.
//   Thresholds are computed in the block (expf), two months at a time in
//   the same alternating buffers.
// - Dead lanes (paths at or past `valid`) are not simulated: the TPU kernel
//   simulates them and drops them into a discard cell.
// - Built with -fmad=false: logv * A + B, A + kk * B and the draw round as
//   the torch versions do.
#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Draw { kHistorical = 0, kGaussian = 1 };
enum Reduce { kHist = 0, kCdf = 1 };

struct Args {
  const float* table;  // (k_chunks*128,) growth table; historical only
  int k_chunks;
  uint32_t n_table, tail_n;
  float a, b;           // growth a + b*z; Gaussian only
  const float* keep;    // (n_periods,) keep factors, or null
  const float* coef_a;  // (n_periods,) A_t
  const float* coef_b;  // (n_periods,) B_t
  int n_periods;
  uint32_t seed_base, tile0;
  int valid;
  float v0;
  int n_cells;          // kHist: n_bins + 2 cells; kCdf: K thresholds
  float kappa_lo, kappa_hi;
  int* out;             // (n_periods, n_cells + REDUCE), zeroed
};

// The histogram cell of value v under the month's coefficients.
__device__ __forceinline__ int hist_cell(float v, float ca, float cb,
                                         int n_cells) {
  const float logv = logf(fmaxf(v, F(1e-37)));
  float x = floorf(logv * ca + cb);
  x = fminf(fmaxf(x, -1.0f), (float)(n_cells - 2));
  return (int)x + 1;
}

// The number of a month's thresholds (ascending) that v is not below.
__device__ __forceinline__ int cdf_cell(float v, const float* thr, int k) {
  int lo = 0;
  int n = k;
  while (n > 0) {
    const int half = n >> 1;
    if (!(v < thr[lo + half])) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__device__ __forceinline__ float threshold(const Args& g, int t, int k) {
  const float kk = k == 0 ? g.kappa_lo
                          : k == g.n_cells - 1 ? g.kappa_hi : (float)k;
  return expf(g.coef_a[t] + kk * g.coef_b[t]);
}

template <int DRAW, bool KEEP, int REDUCE>
__global__ void __launch_bounds__(kBlock) bands_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tab = DRAW == kHistorical ? g.k_chunks * 128 : 0;
  const int cells = g.n_cells + REDUCE;
  // the table first: its base is then a constant inside the month loop
  float* s_table = reinterpret_cast<float*>(smem);
  float* s_tot = s_table + n_tab;                          // kTilePaths
  int* s_cnt = reinterpret_cast<int*>(s_tot + kTilePaths);  // 2 x cells
  float* s_thr = reinterpret_cast<float*>(s_cnt + 2 * cells);  // 2 x K

  if (DRAW == kHistorical)
    for (int i = threadIdx.x; i < n_tab; i += kBlock) s_table[i] = g.table[i];
  for (int i = threadIdx.x; i < kTilePaths; i += kBlock) s_tot[i] = g.v0;
  for (int i = threadIdx.x; i < 2 * cells; i += kBlock) s_cnt[i] = 0;
  if (REDUCE == kCdf)
    for (int i = threadIdx.x; i < 2 * g.n_cells; i += kBlock)
      if (i / g.n_cells < g.n_periods)
        s_thr[i] = threshold(g, i / g.n_cells, i % g.n_cells);
  __syncthreads();

  const uint32_t seed = tile_seed(g.seed_base, g.tile0 + blockIdx.x);
  const int live = min(kTilePaths, g.valid - (int)blockIdx.x * kTilePaths);
  // paths pos = i * kBlock + threadIdx.x, i < mine, are this thread's
  const int mine = live > (int)threadIdx.x
                       ? (live - (int)threadIdx.x + kBlock - 1) / kBlock
                       : 0;
  const uint32_t n_table = g.n_table, tail_n = g.tail_n;
  const uint32_t k_full = (uint32_t)g.k_chunks;

  for (int t = 0; t < g.n_periods; ++t) {
    int* cnt = s_cnt + (t & 1) * cells;
    const uint32_t h = tile_seed(seed, (uint32_t)t);
    const float keep = KEEP ? g.keep[t] : 1.0f;
    const float ca = REDUCE == kHist ? g.coef_a[t] : 0.0f;
    const float cb = REDUCE == kHist ? g.coef_b[t] : 0.0f;
    const float* thr = s_thr + (t & 1) * g.n_cells;
    for (int i = 0; i < mine; ++i) {
      const uint32_t pos = (uint32_t)(i * kBlock) + threadIdx.x;
      const uint32_t w = arith_word(h, pos);
      float gfac = DRAW == kHistorical
                       ? bootstrap_growth(s_table, n_table, tail_n, k_full,
                                          h, w, pos & 127u, pos & ~127u)
                       : g.a + g.b * normal_z(w);
      if (KEEP) gfac = gfac * keep;
      const float total = s_tot[pos] * gfac;
      s_tot[pos] = total;
      const int c = REDUCE == kHist ? hist_cell(total, ca, cb, g.n_cells)
                                    : cdf_cell(total, thr, g.n_cells);
      atomicAdd(&cnt[c], 1);
    }
    __syncthreads();
    // flush month t, and ready both buffers of (t & 1) for month t + 2
    int* row = g.out + (size_t)t * cells;
    for (int c = threadIdx.x; c < cells; c += kBlock) {
      const int v = cnt[c];
      if (v) {
        atomicAdd(&row[c], v);
        cnt[c] = 0;
      }
    }
    if (REDUCE == kCdf && t + 2 < g.n_periods)
      for (int k = threadIdx.x; k < g.n_cells; k += kBlock)
        s_thr[(t & 1) * g.n_cells + k] = threshold(g, t + 2, k);
  }
}

template <int DRAW, bool KEEP, int REDUCE>
cudaError_t launch(const Args& g, int n_blocks, cudaStream_t stream) {
  const int cells = g.n_cells + REDUCE;
  const size_t smem =
      sizeof(float) * ((DRAW == kHistorical ? g.k_chunks * 128 : 0) +
                       kTilePaths + 2 * cells +
                       (REDUCE == kCdf ? 2 * g.n_cells : 0));
  cudaError_t err = cudaFuncSetAttribute(
      bands_kernel<DRAW, KEEP, REDUCE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  bands_kernel<DRAW, KEEP, REDUCE><<<n_blocks, kBlock, smem, stream>>>(g);
  return cudaGetLastError();
}

template <int DRAW, bool KEEP>
cudaError_t launch_reduce(const Args& g, int mode, int n_blocks,
                          cudaStream_t stream) {
  switch (mode) {
    case kHist: return launch<DRAW, KEEP, kHist>(g, n_blocks, stream);
    case kCdf: return launch<DRAW, KEEP, kCdf>(g, n_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DRAW>
cudaError_t launch_keep(const Args& g, int mode, int n_blocks,
                        cudaStream_t stream) {
  return g.keep ? launch_reduce<DRAW, true>(g, mode, n_blocks, stream)
                : launch_reduce<DRAW, false>(g, mode, n_blocks, stream);
}

}  // namespace

// One chunk, one block per 8192-path tile (n_blocks = ceil(valid / 8192)).
// mode: 0 histogram of n_cells cells, 1 counts below n_cells thresholds
// (out then has n_cells + 1 columns: paths not below j thresholds, j =
// 0..K). draw: 0 historical (table, k_chunks, n_table, tail_n), 1 Gaussian
// (a, b; table may be null). keep may be null. out must be zeroed.
// Returns cudaGetLastError() after the launch.
extern "C" int smmc_bands(int mode, int draw, const float* table,
                          int k_chunks, int n_table, int tail_n, float a,
                          float b, const float* keep, const float* coef_a,
                          const float* coef_b, int n_periods,
                          unsigned int seed_base, unsigned int tile0,
                          int valid, float v0, int n_cells, float kappa_lo,
                          float kappa_hi, int* out, int n_blocks,
                          void* stream) {
  const Args g{table, k_chunks, (uint32_t)n_table, (uint32_t)tail_n, a, b,
               keep, coef_a, coef_b, n_periods, seed_base, tile0, valid, v0,
               n_cells, kappa_lo, kappa_hi, out};
  auto s = static_cast<cudaStream_t>(stream);
  switch (draw) {
    case kHistorical: return launch_keep<kHistorical>(g, mode, n_blocks, s);
    case kGaussian: return launch_keep<kGaussian>(g, mode, n_blocks, s);
    default: return cudaErrorInvalidValue;
  }
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
// sorted along k nor equal across lanes, so there is no binary search.
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
