// Month-loop kernel: one chunk of paths compounded month by month, under
// one of five draws.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_engine.py
//   _build_kernel, built by _build_pallas_call (pl.pallas_call at :1097)
//   and run by pallas_chunk_stats, in its kinds and stream modes:
//   - kHistorical: kind="historical", rng_mode="counter" (sliced-rotation
//     bootstrap of the arithmetic counter stream);
//   - kGaussian: kind="gaussian" (exact ICDF of the counter stream, the
//     growth(t) branch at :449-461);
//   - kSobolGaussian, kSobolHistorical: kind="sobol_gaussian" /
//     "sobol_historical", with and without sobol_deep (:362-397, :449-461);
//   - kReference: rng_mode="reference" (:500-525).
//   Plain version: ops/cuda_engine.py month_loop_chunk_plain.
//
// What it computes, per path and month: one 32-bit word, a growth factor
// from it, and one compounding step under the strategy; then the chunk's
// stats row and log histogram. The draw is a template parameter:
// - kHistorical: the counter word (key = month), the exact 1/n bootstrap
//   draw by sliced rotation;
// - kGaussian: the counter word, u23 uniform, z = sqrt(2) * erfinv(2u - 1),
//   growth a + b*z;
// - kSobolGaussian: the digital-shifted Sobol word of dimension t at the
//   path's sequence position, then as kGaussian;
// - kSobolHistorical: that Sobol word, row floor(n * word / 2^32) of the
//   table (the exact index map on the word);
// - kReference: state = pcg_hash(gid + 1), one xorshift a month, row
//   floor(n * state / 2^32) of the table.
// gid = tile0 * 8192 + p (uint32) is the global path id; the Sobol
// position is index_offset + gid in 64 bits. Every stream is a pure
// function of the path's global position, so results do not depend on the
// launch shape.
//
// What bounds it on an H100: operations, with no device-memory traffic
// inside the loop.
// - Historical: up to four 32-bit hashes a path-month (the month's draw
//   key, the path's own word, the words of lane 0 and of the source lane of
//   its row), two exact index maps and one shared-memory gather.
// - Gaussian: two hashes, then ~35 float32 operations (log1pf, the erfinv
//   polynomial, the affine step, the compounding).
// - Sobol: the fold, a shared-memory load and a masked XOR for each of
//   the 32 (64 for a deep index) bits of the position's gray code, then
//   the Gaussian's float work or an index map and a gather. The function
//   itself needs one load and one XOR a path-month (the Gray-code
//   recurrence along consecutive positions); the per-bit fold is this
//   design's cost.
// - Reference: one xorshift (6 operations), the index map (7) and a
//   gather a path-month.
//
// What the design does about it:
// - One thread per path. The TPU kernel shares the row's words across its
//   128 lanes; here a thread recomputes the two foreign words of the
//   historical draw itself from the hash, so threads never communicate.
// - The growth table (historical kinds), then the Sobol direction numbers
//   (n_periods x 32 or x 64 words) and shifts, then the histogram live in
//   dynamic shared memory. Where the direction rows and shifts do not fit
//   beside the table and the histogram (past ~800 months at 64-bit
//   positions, ~1600 at 32-bit), the launcher takes the instance that
//   reads them from global memory instead (SMEM_DIR = false): at most
//   1866 x 65 words (485 KB), they stay in L2, and every lane of a warp
//   reads the same word in the same step. The gray code is computed once
//   per path; the fold is the TPU kernel's branch-free 32-step select,
//   unrolled (measured faster on the H100 than a loop over the set bits
//   with __ffsll, PERF.md).
// - Partial statistics are float64 per thread, reduced per block into one
//   row; the wrapper sums the rows. The 4096-cell histogram is an int32
//   shared-memory histogram built with atomicAdd and added once per block
//   to the chunk histogram.
// - Blocks stride over the chunk so each block flushes its histogram once.
// - Built with -fmad=false: a + b*z, grown - grown*keep, total*inv0 -
//   shift and the compounding products round exactly as the torch version
//   does (XLA on the CPU contracts some of them into fmas; ROADMAP queue 3).
#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Draw {
  kHistorical = 0,
  kGaussian = 1,
  kSobolGaussian = 2,
  kSobolHistorical = 3,
  kReference = 4,
};
enum Strategy { kNone = 0, kKeep = 1, kFixedAmount = 2 };

__host__ __device__ constexpr bool has_table(int d) {
  return d == kHistorical || d == kSobolHistorical || d == kReference;
}
__host__ __device__ constexpr bool is_sobol(int d) {
  return d == kSobolGaussian || d == kSobolHistorical;
}

struct Args {
  const float* table;     // (k_chunks*128,) growth table; historical kinds
  int k_chunks;
  uint32_t n_table, tail_n;
  float a, b;             // growth a + b*z; Gaussian kinds
  const uint32_t* dir;    // (n_periods, dir_cols) direction numbers; Sobol
  const uint32_t* shift;  // (n_periods,) digital shifts; Sobol
  int dir_cols;           // 32, or 64 for 64-bit positions
  uint32_t off_lo, off_hi;  // the Sobol index_offset's words
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

// Dynamic shared memory of one block: table, directions and shifts (where
// SMEM_DIR stages them), then the histogram.
template <int DRAW, bool SMEM_DIR>
__host__ __device__ size_t operand_bytes(const Args& g) {
  size_t n = has_table(DRAW) ? (size_t)g.k_chunks * 128 * sizeof(float) : 0;
  if (is_sobol(DRAW) && SMEM_DIR)
    n += (size_t)g.n_periods * (g.dir_cols + 1) * sizeof(uint32_t);
  return n;
}

template <int DRAW, bool SMEM_DIR>
size_t smem_bytes(const Args& g) {
  return operand_bytes<DRAW, SMEM_DIR>(g) + (g.hist ? g.hb * sizeof(int) : 0);
}

template <int DRAW, int STRATEGY, bool SMEM_DIR>
__global__ void __launch_bounds__(kBlock) month_loop_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool with_hist = g.hist != nullptr;
  // the table first: its base is then a constant inside the month loop
  float* s_table = reinterpret_cast<float*>(smem);
  uint32_t* s_dir = reinterpret_cast<uint32_t*>(
      smem + (has_table(DRAW) ? g.k_chunks * 128 * sizeof(float) : 0));
  uint32_t* s_shift = s_dir + g.n_periods * g.dir_cols;
  int* s_hist = reinterpret_cast<int*>(smem +
                                       operand_bytes<DRAW, SMEM_DIR>(g));
  const uint32_t* dir = SMEM_DIR ? s_dir : g.dir;
  const uint32_t* dshift = SMEM_DIR ? s_shift : g.shift;

  if (has_table(DRAW))
    for (int i = threadIdx.x; i < g.k_chunks * 128; i += blockDim.x)
      s_table[i] = g.table[i];
  if (is_sobol(DRAW) && SMEM_DIR) {
    for (int i = threadIdx.x; i < g.n_periods * g.dir_cols; i += blockDim.x)
      s_dir[i] = g.dir[i];
    for (int i = threadIdx.x; i < g.n_periods; i += blockDim.x)
      s_shift[i] = g.shift[i];
  }
  if (with_hist)
    for (int i = threadIdx.x; i < g.hb; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const uint32_t n_table = g.n_table, tail_n = g.tail_n;
  const uint32_t k_full = (uint32_t)g.k_chunks;
  const uint64_t index_offset = ((uint64_t)g.off_hi << 32) | g.off_lo;
  Stats st;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < g.valid;
       p += gridDim.x * blockDim.x) {
    const uint32_t pos = (uint32_t)p & (kTilePaths - 1);
    const uint32_t lane = pos & 127u;
    const uint32_t row0 = pos - lane;
    const uint32_t tile = g.tile0 + ((uint32_t)p >> 13);
    const uint32_t seed = tile_seed(g.seed_base, tile);
    const uint32_t gid = tile * (uint32_t)kTilePaths + pos;
    const uint64_t idx = index_offset + gid;
    const uint64_t gray = idx ^ (idx >> 1);
    const uint32_t glo = (uint32_t)gray, ghi = (uint32_t)(gray >> 32);
    uint32_t state = pcg_hash(gid + 1u);
    float total = g.v0;
    float wsum = 0.0f;
    for (int t = 0; t < g.n_periods; ++t) {
      float gfac;
      if constexpr (DRAW == kHistorical || DRAW == kGaussian) {
        const uint32_t h = tile_seed(seed, (uint32_t)t);
        const uint32_t w = arith_word(h, pos);
        if constexpr (DRAW == kHistorical)
          gfac = bootstrap_growth(s_table, n_table, tail_n, k_full, h, w,
                                  lane, row0);
        else
          gfac = g.a + g.b * normal_z(w);
      } else if constexpr (is_sobol(DRAW)) {
        const uint32_t* row = dir + t * g.dir_cols;
        uint32_t w = sobol_fold32(row, glo, dshift[t]);
        if (g.dir_cols == 64) w = sobol_fold32(row + 32, ghi, w);
        if constexpr (DRAW == kSobolGaussian)
          gfac = g.a + g.b * normal_z(w);
        else
          gfac = s_table[idx_exact(w, n_table)];
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

template <int DRAW, int STRATEGY, bool SMEM_DIR>
cudaError_t launch_route(const Args& g, int n_blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<DRAW, SMEM_DIR>(g);
  cudaError_t err = cudaFuncSetAttribute(
      month_loop_kernel<DRAW, STRATEGY, SMEM_DIR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  month_loop_kernel<DRAW, STRATEGY, SMEM_DIR>
      <<<n_blocks, kBlock, smem, stream>>>(g);
  return cudaGetLastError();
}

// Sobol draws stage their direction rows in shared memory where they fit
// beside the table and the histogram, else read them from global memory.
template <int DRAW, int STRATEGY>
cudaError_t launch(const Args& g, int n_blocks, cudaStream_t stream) {
  if constexpr (is_sobol(DRAW)) {
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem_bytes<DRAW, true>(g) > (size_t)max_smem)
      return launch_route<DRAW, STRATEGY, false>(g, n_blocks, stream);
  }
  return launch_route<DRAW, STRATEGY, true>(g, n_blocks, stream);
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
// Gaussian (a, b), 2 Sobol Gaussian (a, b, dir, shift, dir_cols, off_lo,
// off_hi), 3 Sobol historical (the table and the Sobol operands), 4
// reference (table). Operands a draw does not read may be null or 0.
// strategy: 0 none, 1 keep factors (fixed/variable percent), 2 fixed
// amount. finals and hist may be null. Returns cudaGetLastError() after
// the launch.
extern "C" int smmc_month_loop(
    int draw, const float* table, int k_chunks, int n_table, int tail_n,
    float a, float b, const unsigned int* dir, const unsigned int* shift,
    int dir_cols, unsigned int off_lo, unsigned int off_hi, const float* keep,
    int strategy, float amount, int n_periods, unsigned int seed_base,
    unsigned int tile0, int valid, float v0, float inv0, float target,
    float shift_c, float log_lo, float inv_w, int hb, float* finals,
    double* partials, int* hist, int n_blocks, void* stream) {
  const Args g{table, k_chunks, (uint32_t)n_table, (uint32_t)tail_n, a, b,
               dir, shift, dir_cols, off_lo, off_hi, keep, amount, n_periods,
               seed_base, tile0, valid, v0, inv0, target, shift_c, log_lo,
               inv_w, hb, finals, partials, hist};
  auto s = static_cast<cudaStream_t>(stream);
  switch (draw) {
    case kHistorical:
      return launch_strategy<kHistorical>(g, strategy, n_blocks, s);
    case kGaussian:
      return launch_strategy<kGaussian>(g, strategy, n_blocks, s);
    case kSobolGaussian:
      return launch_strategy<kSobolGaussian>(g, strategy, n_blocks, s);
    case kSobolHistorical:
      return launch_strategy<kSobolHistorical>(g, strategy, n_blocks, s);
    case kReference:
      return launch_strategy<kReference>(g, strategy, n_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}
