// Threefry month-loop kernel: one chunk of the JAX package's XLA backend,
// compounded month by month without the (paths, months) growth buffer.
//
// Replaces no Pallas kernel. It runs what the JAX package runs as XLA
// off the TPU (EngineOptions(backend="xla")): engine.chunk_stats at
// stock_market_monte_carlo_tpu/engine/engine.py:359, i.e. sample_growth
// (:190) and compound_final (:271) over a (B, T) growth buffer that XLA
// materialises, then the stats row and the histogram. Plain version:
// ops/cuda_engine.py threefry_loop_chunk_plain.
//
// What it computes, per path: the growth of each month from the draw,
// the compounding under the strategy, then the month loop's stats row
// and log histogram (csrc/month_loop.cu's epilogue). The draw is a
// template parameter:
// - kHistorical: jax.random.randint over the table (model
//   HistoricalBootstrap, models/market.py:110): the path's tile key
//   fold_in(key, tile), its split(., 2), and two words a month, each
//   reduced mod the table length and combined as randint combines them;
// - kGaussian: mean + std * jax.random.normal (:59), one word a month
//   under the tile key, growth (100 + r) * 0.01;
// - the Sobol Gaussian draw (SobolGaussianReturns' XLA draw, which is not
//   its Pallas kernel's) runs on csrc/run_loop.cu's run design, draw
//   kXlaSobolGaussian, with this kernel's compounding and epilogue
//   (ops/cuda_engine.py threefry_loop_launcher launches it there).
// Path p of the chunk lies at position pos = p mod 8192 of tile tile0 +
// p / 8192; month m of it is element pos * T + m of the tile's (8192, T)
// draw, the counter of jax.random.bits's partitionable layout (its high
// word is 0: the wrapper refuses T >= 2^32 / 8192).
//
// The compounding is compound_final's, in month order:
// - none and percent strategies: run *= g * keep (keep 1 without a
//   strategy, where g * 1 = g), finals = v0 * run; the withdrawn total
//   adds (v0 * run_before * g) * (1 - keep) a month;
// - fixed amount: apply_month's step, max(V * g - amount, 0), withdrawn
//   grown - new (smmc::step);
// both as smmc::xla_step.
// XLA multiplies the months of jnp.prod and jnp.cumprod in its own order
// and contracts some steps into fmas on the CPU, so the finals agree with
// the JAX package's to a few float32 ulps a month, not bit for bit.
//
// What bounds it on an H100: 32-bit operations. Threefry2x32 is about 80
// (20 rounds of add, funnel shift and xor, 5 key injections); the
// historical draw takes two of them, two remainders by the table length
// and the combine's, about 180 operations a path-month; the Gaussian
// draw one word, the uniform and erfinv, about 110. No device-memory
// traffic inside the loop: the table and the histogram sit in shared
// memory, the keep factors are read through L1 (every thread of a warp
// reads the same word).
//
// What the design does about it: a simple first design, one thread a
// path, the blocks striding over the chunk. The tile key and the split
// keys are made once a thread, so a path-month costs the draw's words
// and nothing else; the remainders are the compiler's for a runtime
// divisor. Partial statistics are float64 a thread, reduced a block into
// a row (Stats); the 4096-cell histogram is a shared-memory histogram
// added once a block to the chunk's. Built with -fmad=false, so every
// product and sum rounds where the plain version's does.
#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Draw { kHistorical = 0, kGaussian = 1 };

struct Args {
  const float* table;             // (n_table,) growth table; historical
  uint32_t n_table, span_mult;    // randint's span and multiplier
  float mean, std_;               // monthly return (percent); Gaussian
  const float* keep;              // (n_periods,) keep factors; percent
  float amount;                   // fixed-amount withdrawal
  int n_periods;
  uint32_t key0, key1;            // the segment's threefry key
  uint32_t tile0;
  int valid;
  float v0, inv0, target, shift_c, log_lo, inv_w;
  int hb;
  float* finals;                  // (valid,) or null
  double* partials;               // (gridDim.x, 8)
  int* hist;                      // (hb,) or null
};

// Dynamic shared memory of one block: the table, then the histogram.
size_t smem_bytes(const Args& g, int draw) {
  return (draw == kHistorical ? (size_t)g.n_table * sizeof(float) : 0) +
         (g.hist ? g.hb * sizeof(int) : 0);
}

template <int DRAW, int STRATEGY>
__global__ void __launch_bounds__(kBlock)
    threefry_loop_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool with_hist = g.hist != nullptr;
  float* s_table = reinterpret_cast<float*>(smem);
  const int n_tab = DRAW == kHistorical ? (int)g.n_table : 0;
  int* s_hist = reinterpret_cast<int*>(s_table + n_tab);
  for (int i = threadIdx.x; i < n_tab; i += blockDim.x)
    s_table[i] = g.table[i];
  if (with_hist)
    for (int i = threadIdx.x; i < g.hb; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  Stats st;
  const uint32_t n_periods = (uint32_t)g.n_periods;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < g.valid;
       p += gridDim.x * blockDim.x) {
    const uint32_t pos = (uint32_t)p & (kTilePaths - 1);
    const uint32_t tile = g.tile0 + ((uint32_t)p >> 13);
    const uint2 tk = threefry_fold_in(make_uint2(g.key0, g.key1), tile);
    uint2 ka = tk, kb = tk;
    if constexpr (DRAW == kHistorical) {
      ka = threefry_fold_in(tk, 0u);
      kb = threefry_fold_in(tk, 1u);
    }
    float x = xla_start<STRATEGY>(g.v0), wsum = 0.0f;
    uint32_t ctr = pos * n_periods;
    for (int t = 0; t < g.n_periods; ++t, ++ctr) {
      float gfac;
      if constexpr (DRAW == kHistorical) {
        gfac = s_table[threefry_randint(threefry_bits(ka, ctr),
                                        threefry_bits(kb, ctr), g.n_table,
                                        g.span_mult)];
      } else {
        gfac = xla_growth(g.mean, g.std_,
                          threefry_normal(threefry_bits(tk, ctr)));
      }
      xla_step<STRATEGY>(x, wsum, gfac,
                         STRATEGY == kKeep ? g.keep[t] : 0.0f, g.v0,
                         g.amount);
    }
    const float total = xla_final<STRATEGY>(x, g.v0);
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
  const size_t smem = smem_bytes(g, DRAW);
  cudaError_t err = cudaFuncSetAttribute(
      threefry_loop_kernel<DRAW, STRATEGY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  threefry_loop_kernel<DRAW, STRATEGY><<<n_blocks, kBlock, smem, stream>>>(
      g);
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

// One chunk. draw: 0 historical (table of n_table growth factors, randint
// multiplier span_mult), 1 Gaussian (mean, std). key0, key1: the segment's
// threefry key. strategy: 0 none, 1 keep factors (fixed and variable
// percent), 2 fixed amount. Operands a draw or a strategy does not read
// may be null or 0; finals and hist may be null. Returns
// cudaGetLastError() after the launch.
extern "C" int smmc_threefry_loop(
    int draw, const float* table, int n_table, unsigned int span_mult,
    float mean, float std, const float* keep, int strategy, float amount,
    int n_periods, unsigned int key0, unsigned int key1, unsigned int tile0,
    int valid, float v0, float inv0, float target, float shift_c,
    float log_lo, float inv_w, int hb, float* finals, double* partials,
    int* hist, int n_blocks, void* stream) {
  if (n_blocks < 1 || n_periods < 1 || partials == nullptr ||
      (uint64_t)n_periods * kTilePaths > 0xFFFFFFFFull ||
      (draw == kHistorical && (table == nullptr || n_table < 1)))
    return cudaErrorInvalidValue;
  const Args g{table, (uint32_t)n_table, span_mult, mean, std, keep, amount,
               n_periods, key0, key1, tile0, valid, v0, inv0, target,
               shift_c, log_lo, inv_w, hb, finals, partials, hist};
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
