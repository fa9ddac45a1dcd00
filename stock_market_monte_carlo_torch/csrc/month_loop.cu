// Month-loop kernel: historical bootstrap or Gaussian ICDF draw.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_engine.py
//   _build_kernel, rng_mode="counter", in its two kinds:
//   kind="historical" (sliced-rotation bootstrap) and kind="gaussian"
//   (exact ICDF, the growth(t) branch at :449-461); both built by
//   _build_pallas_call (pl.pallas_call at :1097) and run by
//   pallas_chunk_stats. Plain version: ops/cuda_engine.py
//   month_loop_chunk_plain.
//
// What it computes, per path and month: one 32-bit word of the arithmetic
// counter stream (key = month), a growth factor from it, and one
// compounding step under the strategy; then the chunk's stats row and log
// histogram. The draw is a template parameter:
// - kHistorical: the exact 1/n bootstrap draw by sliced rotation;
// - kGaussian: u23 uniform, z = sqrt(2) * erfinv(2u - 1), growth a + b*z.
// The stream is a pure function of (tile seed, month, position in the
// 8192-path tile), so results do not depend on the launch shape.
//
// What bounds it on an H100: arithmetic, with no device-memory traffic
// inside the loop.
// - Historical: integer work. A path-month costs up to four 32-bit hashes
//   (the month's draw key, the path's own word, the words of lane 0 and of
//   the source lane of its row) plus two exact index maps and one
//   shared-memory gather (the 4.5 KB table for n=1127 sits in shared
//   memory).
// - Gaussian: two hashes (draw key and word), then float work: log1pf,
//   the 9-term polynomial of the central branch (sqrtf and the tail
//   polynomial where |2u-1| > 0.9966), the affine step and the
//   compounding, about 35 float32 operations.
//
// What the design does about it:
// - One thread per path. The TPU kernel shares the row's words across its
//   128 lanes; here a thread recomputes the two foreign words itself from
//   the hash, so threads never communicate (the simpler of the two
//   designs; a shared-memory row exchange is the alternative to measure).
// - The chain of K chunk-row selects becomes one load
//   table[c' * 128 + w_col] from shared memory. The Gaussian instance
//   loads no table.
// - Partial statistics are float64 per thread, reduced per block into one
//   row; the wrapper sums the rows. The 4096-cell histogram is an int32
//   shared-memory histogram built with atomicAdd and added once per block
//   to the chunk histogram (the TPU kernel's bf16 one-hot MXU product has
//   no counterpart worth having here).
// - Blocks stride over the chunk so each block flushes its histogram once.
// - Built with -fmad=false: a + b*z, grown - grown*keep, total*inv0 -
//   shift and the compounding products round exactly as the torch version
//   does (XLA on the CPU contracts some of them into fmas; ROADMAP queue 3).
#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Draw { kHistorical = 0, kGaussian = 1 };
enum Strategy { kNone = 0, kKeep = 1, kFixedAmount = 2 };

struct Args {
  const float* table;  // (k_chunks*128,) growth table; historical only
  int k_chunks;
  uint32_t n_table, tail_n;
  float a, b;          // growth a + b*z; Gaussian only
  const float* keep;   // (n_periods,) keep factors; percent strategies
  float amount;        // fixed-amount withdrawal
  int n_periods;
  uint32_t seed_base, tile0;
  int valid;
  float v0, inv0, target, shift, log_lo, inv_w;
  int hb;
  float* finals;       // (valid,) or null
  double* partials;    // (gridDim.x, 8)
  int* hist;           // (hb,) or null
};

template <int DRAW, int STRATEGY>
__global__ void __launch_bounds__(kBlock) month_loop_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool with_hist = g.hist != nullptr;
  // the table first: its base is then a constant inside the month loop
  float* s_table = reinterpret_cast<float*>(smem);
  int* s_hist = reinterpret_cast<int*>(
      smem + (DRAW == kHistorical ? g.k_chunks * 128 * sizeof(float) : 0));

  if (DRAW == kHistorical)
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
    const uint32_t seed = tile_seed(g.seed_base, g.tile0 + ((uint32_t)p >> 13));
    float total = g.v0;
    float wsum = 0.0f;
    for (int t = 0; t < g.n_periods; ++t) {
      const uint32_t h = tile_seed(seed, (uint32_t)t);
      const uint32_t w = arith_word(h, pos);
      const float gfac =
          DRAW == kHistorical
              ? bootstrap_growth(s_table, n_table, tail_n, k_full, h, w,
                                 lane, row0)
              : g.a + g.b * normal_z(w);
      const float grown = total * gfac;
      if (STRATEGY == kNone) {
        total = grown;
      } else {
        const float nv = STRATEGY == kKeep ? grown * g.keep[t]
                                           : fmaxf(grown - g.amount, 0.0f);
        wsum = wsum + (grown - nv);
        total = nv;
      }
    }
    if (g.finals) g.finals[p] = total;
    st.add(total, wsum, g.inv0, g.shift, g.target);
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
  const size_t smem = (g.hist ? g.hb * sizeof(int) : 0) +
                      (DRAW == kHistorical ? g.k_chunks * 128 * sizeof(float)
                                           : 0);
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

// One chunk. draw: 0 historical (table, k_chunks, n_table, tail_n), 1
// Gaussian (a, b; table may be null). strategy: 0 none, 1 keep factors
// (fixed/variable percent), 2 fixed amount. finals and hist may be null.
// Returns cudaGetLastError() after the launch.
extern "C" int smmc_month_loop(int draw, const float* table, int k_chunks,
                               int n_table, int tail_n, float a, float b,
                               const float* keep, int strategy, float amount,
                               int n_periods, unsigned int seed_base,
                               unsigned int tile0, int valid, float v0,
                               float inv0, float target, float shift,
                               float log_lo, float inv_w, int hb,
                               float* finals, double* partials, int* hist,
                               int n_blocks, void* stream) {
  const Args g{table, k_chunks, (uint32_t)n_table, (uint32_t)tail_n, a, b,
               keep, amount, n_periods, seed_base, tile0, valid, v0, inv0,
               target, shift, log_lo, inv_w, hb, finals, partials, hist};
  auto s = static_cast<cudaStream_t>(stream);
  switch (draw) {
    case kHistorical:
      return launch_strategy<kHistorical>(g, strategy, n_blocks, s);
    case kGaussian:
      return launch_strategy<kGaussian>(g, strategy, n_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}
