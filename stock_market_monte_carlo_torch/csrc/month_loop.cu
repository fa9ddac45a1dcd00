// Month-loop kernel: one chunk of paths compounded month by month, under
// one of two draws; smmc_month_loop routes the other three to
// csrc/run_loop.cu.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_engine.py
//   _build_kernel, built by _build_pallas_call (pl.pallas_call at :1097)
//   and run by pallas_chunk_stats, in its kinds and stream modes:
//   - kHistorical: kind="historical", rng_mode="counter" (sliced-rotation
//     bootstrap of the arithmetic counter stream);
//   - kReference: rng_mode="reference" (:500-525);
//   - kind="gaussian" (the growth(t) branch at :449-461) and
//     kind="sobol_gaussian" / "sobol_historical" (:362-397): the draws 1-3
//     of smmc_month_loop, run by csrc/run_loop.cu.
//   Plain version: ops/cuda_engine.py month_loop_chunk_plain.
//
// What it computes, per path and month: one 32-bit word, a growth factor
// from it, and one compounding step under the strategy; then the chunk's
// stats row and log histogram. The draw is a template parameter:
// - kHistorical: the counter word (key = month), the exact 1/n bootstrap
//   draw by sliced rotation;
// - kReference: state = pcg_hash(gid + 1), one xorshift a month, row
//   floor(n * state / 2^32) of the table.
// gid = tile0 * 8192 + p (uint32) is the global path id. Every stream is a
// pure function of the path's global position, so results do not depend on
// the launch shape.
//
// What bounds it on an H100: operations, with no device-memory traffic
// inside the loop.
// - Historical: per path-month one 32-bit hash (the path's own word; the
//   month's draw key is hashed once a thread-month), two exact index maps,
//   a shared-memory gather from the table, and the row's shared words:
//   lane 0's (a shuffle) and the source lane's (a shared-memory load).
// - Reference: one xorshift (6 operations), the index map (7) and a
//   gather a path-month.
//
// What the design does about it:
// - Historical: a warp owns an item of kItemPaths = 256 consecutive chunk
//   paths, two 128-path rows of an RNG tile; lane l holds the 8 paths
//   item0 + l + 32 i, so l + 32 (i % 4) is path i's lane in row i / 4 (the
//   layout of csrc/bands.cu's warp items). Every lane hashes its own 8
//   words a month; the rows' lane-0 words come from lane 0 by shuffle, and
//   the source lane's word from the item's 256 words, staged each month in
//   a per-warp slice of shared memory (8 stores a lane between two
//   __syncwarp). So each path-month costs one hash, where a path on its
//   own would hash the foreign words of its row again (up to three hashes;
//   the TPU kernel shares the words across its 128 lanes). An item never
//   leaves its 8192-path tile, so the month key is hashed once a
//   thread-month; the warps stride over the chunk's items, and the lanes
//   of a partial item past `valid` still draw (they take part in the
//   shuffles) but count nowhere.
// - Reference: one thread per path, the blocks striding over the chunk.
// - The growth table, then the histogram live in dynamic shared memory
//   (then, historical, the warps' word slices).
// - Partial statistics are float64 per thread, reduced per block into one
//   row; the wrapper sums the rows. The 4096-cell histogram is an int32
//   shared-memory histogram built with atomicAdd and added once per block
//   to the chunk histogram.
// - Built with -fmad=false: grown - grown*keep, total*inv0 - shift and the
//   compounding products round exactly as the torch version does (XLA on
//   the CPU contracts some of them into fmas; ROADMAP queue 3).
#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Draw { kHistorical = 0, kReference = 4 };

struct Args {
  const float* table;     // (k_chunks*128,) growth table
  int k_chunks;
  uint32_t n_table, tail_n;
  const float* keep;      // (n_periods,) keep factors; percent strategies
  float amount;           // fixed-amount withdrawal
  int n_periods;
  uint32_t seed_base, tile0;
  int valid;
  float v0, inv0, target, shift_c, log_lo, inv_w;
  int hb;
  float* finals;          // (valid,) or null
  double* partials;       // (gridDim.x, 8)
  int* hist;              // (hb,) or null
};

// The historical draw's warp items: kLanePaths paths a lane, kItemRows
// 128-path rows an item
constexpr int kLanePaths = 8;
constexpr int kItemPaths = 32 * kLanePaths;
constexpr int kItemRows = kItemPaths / 128;
constexpr int kWarps = kBlock / 32;

// Dynamic shared memory of one block: the table, then the histogram, then
// (historical) each warp's slice of its item's words.
size_t smem_bytes(const Args& g, int draw) {
  return (size_t)g.k_chunks * 128 * sizeof(float) +
         (g.hist ? g.hb * sizeof(int) : 0) +
         (draw == kHistorical ? (size_t)kWarps * kItemPaths * sizeof(uint32_t)
                              : 0);
}

// The historical draw over the chunk's warp items (the design above). A
// warp's items are warp-uniform, so every lane takes part in each shuffle
// and __syncwarp; paths past `valid` add nothing to st or s_hist.
template <int STRATEGY>
__device__ __forceinline__ void historical_items(const Args& g,
                                                 const float* s_table,
                                                 int* s_hist,
                                                 uint32_t* s_words,
                                                 Stats& st) {
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t n_table = g.n_table, tail_n = g.tail_n;
  const uint32_t k_full = (uint32_t)g.k_chunks;
  uint32_t* s_row = s_words + (threadIdx.x >> 5) * kItemPaths;
  const int n_items = (g.valid + kItemPaths - 1) / kItemPaths;
  for (int item = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
       item < n_items; item += gridDim.x * kWarps) {
    const int p0 = item * kItemPaths;  // the item's first chunk path
    const uint32_t tile = g.tile0 + ((uint32_t)p0 >> 13);
    // path i: position pos0 + 32 i of the tile, lane lane + 32 (i % 4) of
    // the row starting at row0 + 128 (i / 4); it counts while 32 i < live
    const uint32_t row0 = (uint32_t)p0 & (kTilePaths - 1);
    const uint32_t pos0 = row0 + lane;
    const int live = g.valid - p0 - (int)lane;
    const uint32_t seed = tile_seed(g.seed_base, tile);
    float total[kLanePaths], wsum[kLanePaths];
#pragma unroll
    for (int i = 0; i < kLanePaths; ++i) {
      total[i] = g.v0;
      wsum[i] = 0.0f;
    }
    for (int t = 0; t < g.n_periods; ++t) {
      const uint32_t h = tile_seed(seed, (uint32_t)t);
      float keep_t = 0.0f;
      if constexpr (STRATEGY == kKeep) keep_t = g.keep[t];
      uint32_t w[kLanePaths], w0[kItemRows];
#pragma unroll
      for (int i = 0; i < kLanePaths; ++i) w[i] = arith_word(h, pos0 + 32u * i);
#pragma unroll
      for (int r = 0; r < kItemRows; ++r)
        w0[r] = __shfl_sync(0xffffffffu, w[4 * r], 0);
      __syncwarp();  // every lane has read the last month's words
#pragma unroll
      for (int i = 0; i < kLanePaths; ++i) s_row[32 * i + lane] = w[i];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kLanePaths; ++i) {
        // the sliced-rotation draw (bootstrap_growth_w0) of lane c of row
        // i / 4, the row's words from the warp: the source lane's is
        // s_row's (its own where w_col == c)
        const uint32_t c = lane + 32u * (i % 4);
        const uint32_t idx_dest = idx_exact(w[i], n_table);
        const uint32_t w_col =
            idx_dest < tail_n ? idx_dest : (c + (w0[i / 4] & 127u)) & 127u;
        const uint32_t ws = s_row[128 * (i / 4) + w_col];
        const uint32_t n_valid = w_col < tail_n ? k_full : k_full - 1u;
        step<STRATEGY>(
            total[i], wsum[i],
            s_table[idx_exact(ws * n_table, n_valid) * 128u + w_col], keep_t,
            g.amount);
      }
    }
#pragma unroll
    for (int i = 0; i < kLanePaths; ++i) {
      if (32 * i >= live) break;
      if (g.finals) g.finals[p0 + (int)lane + 32 * i] = total[i];
      st.add(total[i], wsum[i], g.inv0, g.shift_c, g.target);
      if (s_hist)
        atomicAdd(&s_hist[bin_index(total[i], g.log_lo, g.inv_w, g.hb)], 1);
    }
  }
}

// At least 3 blocks a SM for the historical draw: ptxas takes 79-80
// registers a thread, with no spills; at 4 (64 registers) it spilled up
// to 472 bytes a thread and was 5 % slower, at 2 no faster (PERF.md). At
// least 4 for the reference draw, whose registers (39-43) it holds.
template <int DRAW, int STRATEGY>
__global__ void __launch_bounds__(kBlock, DRAW == kHistorical ? 3 : 4)
    month_loop_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool with_hist = g.hist != nullptr;
  // the table first: its base is then a constant inside the month loop
  float* s_table = reinterpret_cast<float*>(smem);
  int* s_hist = reinterpret_cast<int*>(s_table + g.k_chunks * 128);

  for (int i = threadIdx.x; i < g.k_chunks * 128; i += blockDim.x)
    s_table[i] = g.table[i];
  if (with_hist)
    for (int i = threadIdx.x; i < g.hb; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  Stats st;
  if constexpr (DRAW == kHistorical) {
    historical_items<STRATEGY>(
        g, s_table, with_hist ? s_hist : nullptr,
        reinterpret_cast<uint32_t*>(s_hist + (with_hist ? g.hb : 0)), st);
  } else {
    const uint32_t n_table = g.n_table;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < g.valid;
         p += gridDim.x * blockDim.x) {
      const uint32_t pos = (uint32_t)p & (kTilePaths - 1);
      const uint32_t tile = g.tile0 + ((uint32_t)p >> 13);
      const uint32_t gid = tile * (uint32_t)kTilePaths + pos;
      uint32_t state = pcg_hash(gid + 1u);
      float total = g.v0;
      float wsum = 0.0f;
      for (int t = 0; t < g.n_periods; ++t) {
        state = xorshift(state);
        step<STRATEGY>(total, wsum, s_table[idx_exact(state, n_table)],
                       STRATEGY == kKeep ? g.keep[t] : 0.0f, g.amount);
      }
      if (g.finals) g.finals[p] = total;
      st.add(total, wsum, g.inv0, g.shift_c, g.target);
      if (with_hist)
        atomicAdd(&s_hist[bin_index(total, g.log_lo, g.inv_w, g.hb)], 1);
    }
  }
  st.store_block(g.partials + 8 * blockIdx.x);
  if (with_hist) {
    __syncthreads();
    flush_hist(s_hist, g.hist, g.hb);
  }
}

template <int DRAW, int STRATEGY>
cudaError_t launch(const Args& g, int n_blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, DRAW);
  cudaError_t err = cudaFuncSetAttribute(
      month_loop_kernel<DRAW, STRATEGY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  month_loop_kernel<DRAW, STRATEGY><<<n_blocks, kBlock, smem, stream>>>(g);
  return cudaGetLastError();
}

template <int DRAW>
cudaError_t launch_strategy(const Args& g, int strategy, int n_blocks,
                            cudaStream_t stream) {
  switch (strategy) {
    case kNone: return launch<DRAW, kNone>(g, n_blocks, stream);
    case kKeep: return launch<DRAW, kKeep>(g, n_blocks, stream);
    case kFixedAmount: return launch<DRAW, kFixedAmount>(g, n_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// csrc/run_loop.cu: the draws whose threads hold runs of paths, with this
// entry point's operands
extern "C" int smmc_run_loop(
    int draw, const float* table, int k_chunks, int n_table, int tail_n,
    float a, float b, const unsigned int* dir, const unsigned int* shift,
    int dir_cols, unsigned int off_lo, unsigned int off_hi, const float* keep,
    int strategy, float amount, int n_periods, unsigned int seed_base,
    unsigned int tile0, int valid, float v0, float inv0, float target,
    float shift_c, float log_lo, float inv_w, int hb, float* finals,
    double* partials, int* hist, int n_blocks, void* stream);

// One chunk. draw: 0 historical (table, k_chunks, n_table, tail_n), 1
// Gaussian (a, b), 2 Sobol Gaussian (a, b, dir, shift, dir_cols, off_lo,
// off_hi), 3 Sobol historical (the table and the Sobol operands), 4
// reference (table). Operands a draw does not read may be null or 0.
// strategy: 0 none, 1 keep factors (fixed/variable percent), 2 fixed
// amount. finals and hist may be null. Draws 1-3 run on csrc/run_loop.cu,
// whose blocks take groups of paths (smmc_run_info). Returns
// cudaGetLastError() after the launch.
extern "C" int smmc_month_loop(
    int draw, const float* table, int k_chunks, int n_table, int tail_n,
    float a, float b, const unsigned int* dir, const unsigned int* shift,
    int dir_cols, unsigned int off_lo, unsigned int off_hi, const float* keep,
    int strategy, float amount, int n_periods, unsigned int seed_base,
    unsigned int tile0, int valid, float v0, float inv0, float target,
    float shift_c, float log_lo, float inv_w, int hb, float* finals,
    double* partials, int* hist, int n_blocks, void* stream) {
  const Args g{table, k_chunks, (uint32_t)n_table, (uint32_t)tail_n, keep,
               amount, n_periods, seed_base, tile0, valid, v0, inv0, target,
               shift_c, log_lo, inv_w, hb, finals, partials, hist};
  auto s = static_cast<cudaStream_t>(stream);
  switch (draw) {
    case kHistorical:
      return launch_strategy<kHistorical>(g, strategy, n_blocks, s);
    case kReference:
      return launch_strategy<kReference>(g, strategy, n_blocks, s);
    case 1:
    case 2:
    case 3:
      return smmc_run_loop(draw, table, k_chunks, n_table, tail_n, a, b, dir,
                           shift, dir_cols, off_lo, off_hi, keep, strategy,
                           amount, n_periods, seed_base, tile0, valid, v0,
                           inv0, target, shift_c, log_lo, inv_w, hb, finals,
                           partials, hist, n_blocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
