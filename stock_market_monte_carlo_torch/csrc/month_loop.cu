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
// - Historical: up to four 32-bit hashes a path-month (the month's draw
//   key, the path's own word, the words of lane 0 and of the source lane of
//   its row), two exact index maps and one shared-memory gather.
// - Reference: one xorshift (6 operations), the index map (7) and a
//   gather a path-month.
//
// What the design does about it:
// - One thread per path. The TPU kernel shares the row's words across its
//   128 lanes; here a thread recomputes the two foreign words of the
//   historical draw itself from the hash, so threads never communicate.
// - The growth table, then the histogram live in dynamic shared memory.
// - Partial statistics are float64 per thread, reduced per block into one
//   row; the wrapper sums the rows. The 4096-cell histogram is an int32
//   shared-memory histogram built with atomicAdd and added once per block
//   to the chunk histogram.
// - Blocks stride over the chunk so each block flushes its histogram once.
// - Built with -fmad=false: grown - grown*keep, total*inv0 - shift and the
//   compounding products round exactly as the torch version does (XLA on
//   the CPU contracts some of them into fmas; ROADMAP queue 3).
#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Draw { kHistorical = 0, kReference = 4 };
enum Strategy { kNone = 0, kKeep = 1, kFixedAmount = 2 };

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

// Dynamic shared memory of one block: the table, then the histogram.
size_t smem_bytes(const Args& g) {
  return (size_t)g.k_chunks * 128 * sizeof(float) +
         (g.hist ? g.hb * sizeof(int) : 0);
}

// At least 4 blocks a SM: ptxas may then take up to 64 registers a thread,
// and takes 44 for the historical draw, whose time at the launcher's grid
// (at most 8 blocks a SM) is then within 1 % of the build that still held
// the Sobol draws' branches; left to itself it takes 40 and is 3 % slower
// (PERF.md).
template <int DRAW, int STRATEGY>
__global__ void __launch_bounds__(kBlock, 4)
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

  const uint32_t n_table = g.n_table, tail_n = g.tail_n;
  const uint32_t k_full = (uint32_t)g.k_chunks;
  Stats st;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < g.valid;
       p += gridDim.x * blockDim.x) {
    const uint32_t pos = (uint32_t)p & (kTilePaths - 1);
    const uint32_t lane = pos & 127u;
    const uint32_t row0 = pos - lane;
    const uint32_t tile = g.tile0 + ((uint32_t)p >> 13);
    const uint32_t seed = tile_seed(g.seed_base, tile);
    const uint32_t gid = tile * (uint32_t)kTilePaths + pos;
    uint32_t state = pcg_hash(gid + 1u);
    float total = g.v0;
    float wsum = 0.0f;
    for (int t = 0; t < g.n_periods; ++t) {
      float gfac;
      if constexpr (DRAW == kHistorical) {
        const uint32_t h = tile_seed(seed, (uint32_t)t);
        const uint32_t w = arith_word(h, pos);
        gfac = bootstrap_growth(s_table, n_table, tail_n, k_full, h, w, lane,
                                row0);
      } else {
        state = xorshift(state);
        gfac = s_table[idx_exact(state, n_table)];
      }
      const float grown = total * gfac;
      if constexpr (STRATEGY == kNone) {
        total = grown;
      } else {
        const float nv = STRATEGY == kKeep ? grown * g.keep[t]
                                           : fmaxf(grown - g.amount, 0.0f);
        wsum = wsum + (grown - nv);
        total = nv;
      }
    }
    if (g.finals) g.finals[p] = total;
    st.add(total, wsum, g.inv0, g.shift_c, g.target);
    if (with_hist)
      atomicAdd(&s_hist[bin_index(total, g.log_lo, g.inv_w, g.hb)], 1);
  }
  st.store_block(g.partials + 8 * blockIdx.x);
  if (with_hist) {
    __syncthreads();
    flush_hist(s_hist, g.hist, g.hb);
  }
}

template <int DRAW, int STRATEGY>
cudaError_t launch(const Args& g, int n_blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
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
