// Run month-loop kernel: one chunk of paths compounded month by month,
// each thread holding a run of K consecutive paths, under the counter
// stream's Gaussian ICDF draw or the Sobol Gaussian or Sobol historical
// draw; and the XLA backend's Sobol Gaussian draw.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_engine.py
//   _build_kernel, built by _build_pallas_call (pl.pallas_call at :1097),
//   kind="gaussian" (the growth(t) branch at :449-461) and
//   kind="sobol_gaussian" / "sobol_historical", with and without
//   sobol_deep (:362-397, :449-461). csrc/month_loop.cu's smmc_month_loop
//   routes its draws 1-3 here. Plain version: ops/cuda_engine.py
//   month_loop_chunk_plain (the Sobol word from the byte tables,
//   _sobol_words).
// - kXlaSobolGaussian replaces no Pallas kernel: it is the Sobol Gaussian
//   draw of the JAX package's XLA backend (EngineOptions(backend="xla"),
//   engine.chunk_stats at stock_market_monte_carlo_tpu/engine/engine.py
//   :359), with csrc/threefry_loop.cu's compounding and epilogue;
//   ops/cuda_engine.py threefry_loop_launcher launches it.
//   Plain version: ops/cuda_engine.py threefry_loop_chunk_plain.
//
// What it computes, per path and month: a 32-bit word, then a +
// b*normal_z(word) (kGaussian, kSobolGaussian) or table row
// floor(n * word / 2^32) (kSobolHistorical), one compounding step under
// the strategy; then the chunk's stats row and log histogram, as
// month_loop.cu. The word:
// - kGaussian: the counter word arith_word(h, pos) of the path's position
//   pos in its 8192-path tile, h = tile_seed(tile seed, month);
// - the Sobol draws: the digital-shifted Sobol word of dimension t at the
//   path's sequence position idx = index_offset + gid (gid = tile0 * 8192
//   + p in uint32), word = shift[t] ^ XOR of dir[t][b] over the set bits b
//   of gray(idx) = idx ^ (idx >> 1).
// kXlaSobolGaussian maps the word as the XLA backend does
// (sobol_normal_warp: float32(word) * 2^-32, the clip, sqrt(2) erfinv(2u -
// 1)), grows by (100 + (mean + std z)) * 0.01 (a = mean, b = std) and
// compounds in compound_final's order (xla_step: the run product, v0 *
// run at the end, under none and the keep factors), as
// threefry_loop_kernel does.
//
// What bounds it on an H100: operations. The counter word is a hash (~10
// integer operations) a path-month and its month key one a tile-month;
// the Sobol word needs one direction load and one XOR a path-month
// (neighbouring positions' gray codes differ in one bit, gray(i) ^
// gray(i-1) = 1 << ctz(i), so word(i) = word(i-1) ^ dir[t][ctz(i)]). Then
// the draw: the erfinv's ~35 float operations (Gaussian draws) or an index
// map and a shared-memory gather (historical). A per-path fold of the 32
// (64) bits is one shared-memory load a bit, and shared-memory loads issue
// at one warp instruction a clock per SM: that fold alone took ~23 ms of a
// 2^24-path chunk x 360 months.
//
// What the design does about it:
// - A thread holds K consecutive chunk paths p0 .. p0+K-1 in registers
//   (K = 8 for the Gaussian draws, the XLA one too, 16 for the Sobol
//   historical: the faster of 4, 8 and 16 on the H100, PERF.md), and a
//   warp the 32K consecutive paths of 32 neighbouring runs. The runs
//   never leave an 8192-path tile (32K divides 8192): the counter draw
//   hashes its month key once a thread-month, and the Sobol positions
//   are consecutive (gid wraps at 2^32 only between tiles, and idx is
//   64-bit).
// - The Sobol step columns c_j = ctz(idx0 + j), j = 1..K, do not depend
//   on the month; each thread works them out once per run, before the
//   months (the counter draw does not read them). The XLA draw reads no
//   threefry word, so it needs no tile key: the word is all its stream.
// - Each month the warp folds its first Sobol position once, spread over
//   the lanes: lane b holds dir[t][b] (and dir[t][32+b]) masked by
//   bit b of that gray code, and a 5-step XOR butterfly gives every lane
//   the word. A 5-step XOR scan of the runs' step XORs D (the XOR of
//   dir[t][c_j], j = 1..K) gives each lane the word at its run's first
//   position, exactly, whatever carries the positions cross. Then K-1
//   loads and XORs give the run's other words. Per warp-month: 1-2 loads
//   for the fold, 10 shuffles, K loads a lane, against 32K (64K) loads of
//   the per-path fold (one fold a run instead was 1.2-1.6x slower, PERF.md).
// - The last step of lane 31 (to the next warp's first position) is never
//   used; at 32-bit positions it may be the step to 2^32, whose column 32
//   is past the row, so the columns are clamped into the row.
// - Direction rows and shifts live in shared memory, a window of months
//   at a time: as many as fit in 16 KB (124 months at 32-bit positions, 63
//   at 64-bit), so 4 blocks a SM fit; all months, staged once a block,
//   where they fit. A window is restaged for each block-wide group of runs
//   between two barriers (the loop over groups is block-uniform, and every
//   lane of a warp runs the shuffles: paths past `valid` are computed and
//   not counted). Staging all 360 months of the 64-bit table (2 blocks a
//   SM) was slower, and a window of 32 or 64 months no faster (PERF.md).
// - The Gaussian draws evaluate the erfinv's tail polynomial (w >= 5,
//   about one draw in 300) only where a lane of the warp needs it, behind
//   a warp-uniform branch (normal_z_warp, sobol_normal_warp): the same
//   operations on each value as the branch-free erfinv_poly, which
//   computes both polynomials. Every lane of a warp runs every path, so
//   the warps stay whole.
// - keep[t] is read once a thread-month; the growth table (historical)
//   and the histogram sit in shared memory as in month_loop.cu; partial
//   statistics are float64 per thread, one row a block; finals are
//   written as K consecutive floats, 16 bytes at a time where the run is
//   whole.
// - Built with -fmad=false, as the other kernels: the compounding, the
//   erfinv and the moments round as the plain version does.
#include <algorithm>

#include "smmc_common.cuh"

namespace {

using namespace smmc;

// draws 1-3 are smmc_month_loop's; 5 is the threefry loop's Sobol Gaussian
enum Draw {
  kGaussian = 1,
  kSobolGaussian = 2,
  kSobolHistorical = 3,
  kXlaSobolGaussian = 5
};
// shared memory for a window of direction rows and shifts
constexpr size_t kDirBudget = 16 * 1024;

// K, the consecutive paths a thread holds: the faster of 4, 8 and 16 for
// each draw on the H100 (PERF.md)
__host__ __device__ constexpr int paths_a_thread(int draw) {
  return draw == kSobolHistorical ? 16 : 8;
}

struct Args {
  const float* table;     // (k_chunks*128,) growth table; historical
  int k_chunks;
  uint32_t n_table;
  float a, b;             // growth a + b*z; Gaussian (XLA: mean, std)
  const uint32_t* dir;    // (n_periods, dir_cols) direction numbers
  const uint32_t* shift;  // (n_periods,) digital shifts
  int dir_cols;           // 32, or 64 for 64-bit positions
  uint64_t index_offset;
  const float* keep;      // (n_periods,) keep factors; percent strategies
  float amount;           // fixed-amount withdrawal
  int n_periods;
  uint32_t tile0;
  int valid;
  float v0, inv0, target, shift_c, log_lo, inv_w;
  int hb;
  float* finals;          // (valid,) or null
  double* partials;       // (gridDim.x, 8)
  int* hist;              // (hb,) or null
  int window;             // months of direction rows in shared memory
  uint32_t seed_base;     // the counter stream's base; kGaussian
};

// Dynamic shared memory of one block: the table (historical), the window
// of direction rows and shifts, the histogram.
size_t smem_bytes(const Args& g, int draw) {
  return (draw == kSobolHistorical ? (size_t)g.k_chunks * 128 * sizeof(float)
                                   : 0) +
         (size_t)g.window * (g.dir_cols + 1) * sizeof(uint32_t) +
         (g.hist ? g.hb * sizeof(int) : 0);
}

// Direction rows t0 .. t0+n-1 and their shifts into shared memory.
__device__ __forceinline__ void stage_rows(const Args& g, uint32_t* s_dir,
                                           uint32_t* s_shift, int t0,
                                           int n) {
  const uint32_t* src = g.dir + (size_t)t0 * g.dir_cols;
  for (int i = threadIdx.x; i < n * g.dir_cols; i += blockDim.x)
    s_dir[i] = src[i];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s_shift[i] = g.shift[t0 + i];
}

template <int DRAW, int STRATEGY>
__global__ void __launch_bounds__(kBlock) run_loop_kernel(const Args g) {
  constexpr int K = paths_a_thread(DRAW);
  extern __shared__ __align__(16) unsigned char smem[];
  const bool with_hist = g.hist != nullptr;
  const int cols = g.dir_cols;
  float* s_table = reinterpret_cast<float*>(smem);
  uint32_t* s_dir = reinterpret_cast<uint32_t*>(
      smem + (DRAW == kSobolHistorical ? g.k_chunks * 128 * sizeof(float)
                                       : 0));
  uint32_t* s_shift = s_dir + g.window * cols;
  int* s_hist = reinterpret_cast<int*>(s_shift + g.window);

  if (DRAW == kSobolHistorical)
    for (int i = threadIdx.x; i < g.k_chunks * 128; i += blockDim.x)
      s_table[i] = g.table[i];
  const bool staged_once = g.window >= g.n_periods;
  if (DRAW != kGaussian && staged_once)
    stage_rows(g, s_dir, s_shift, 0, g.n_periods);
  if (with_hist)
    for (int i = threadIdx.x; i < g.hb; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const uint32_t n_table = g.n_table;
  const int lane = threadIdx.x & 31;
  constexpr int kGroup = kBlock * K;   // paths of a block's group of runs
  Stats st;
  // block-uniform: every thread takes every group, so the barriers of the
  // windows and the warps' shuffles see all their threads
  for (int base = blockIdx.x * kGroup; base < g.valid;
       base += gridDim.x * kGroup) {
    const int p0 = base + threadIdx.x * K;
    const uint32_t tile = g.tile0 + ((uint32_t)p0 >> 13);
    const uint32_t gid0 = tile * (uint32_t)kTilePaths +
                          ((uint32_t)p0 & (kTilePaths - 1));
    const uint64_t idx0 = g.index_offset + gid0;
    // col[j-1]: the direction column of the step to position idx0 + j
    // (the Sobol draws; the counter draw reads none of what follows)
    int col[K];
#pragma unroll
    for (int j = 1; j <= K; ++j)
      col[j - 1] = min(__ffsll((long long)(idx0 + j)) - 1, cols - 1);
    // the lane's bit of the warp's first gray code, as a mask
    const uint64_t first = idx0 - (uint64_t)(K * lane);
    const uint64_t gray = first ^ (first >> 1);
    const uint32_t m_lo = 0u - (uint32_t)((gray >> lane) & 1u);
    const uint32_t m_hi = 0u - (uint32_t)((gray >> (32 + lane)) & 1u);
    float total[K], wsum[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // the XLA draw holds the run product (xla_start)
      total[j] = DRAW == kXlaSobolGaussian ? xla_start<STRATEGY>(g.v0)
                                           : g.v0;
      wsum[j] = 0.0f;
    }
    if constexpr (DRAW == kGaussian) {
      // the run's counter words: positions pos0 .. pos0+K-1 of its tile
      const uint32_t seed = tile_seed(g.seed_base, tile);
      const uint32_t pos0 = (uint32_t)p0 & (kTilePaths - 1);
      for (int t = 0; t < g.n_periods; ++t) {
        const uint32_t h = tile_seed(seed, (uint32_t)t);
        float keep_t = 0.0f;
        if constexpr (STRATEGY == kKeep) keep_t = g.keep[t];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float gfac =
              g.a + g.b * normal_z_warp(arith_word(h, pos0 + (uint32_t)j));
          step<STRATEGY>(total[j], wsum[j], gfac, keep_t, g.amount);
        }
      }
    } else {
      for (int t0 = 0; t0 < g.n_periods; t0 += g.window) {
        const int n = min(g.window, g.n_periods - t0);
        if (!staged_once) {
          __syncthreads();
          stage_rows(g, s_dir, s_shift, t0, n);
          __syncthreads();
        }
        const int r0 = staged_once ? t0 : 0;
        for (int r = r0; r < r0 + n; ++r) {
          const uint32_t* row = s_dir + r * cols;
          uint32_t d[K];
#pragma unroll
          for (int j = 0; j < K; ++j) d[j] = row[col[j]];
          uint32_t f = row[lane] & m_lo;
          if (cols == 64) f ^= row[32 + lane] & m_hi;
          uint32_t run = d[0];
#pragma unroll
          for (int j = 1; j < K; ++j) run ^= d[j];
          uint32_t scan = run;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            f ^= __shfl_xor_sync(0xffffffffu, f, o);
            const uint32_t up = __shfl_up_sync(0xffffffffu, scan, o);
            if (lane >= o) scan ^= up;
          }
          // the warp's first word, then the lanes before this one
          uint32_t w = f ^ scan ^ run ^ s_shift[r];
          const int t = t0 + r - r0;
          float keep_t = 0.0f;
          if constexpr (STRATEGY == kKeep) keep_t = g.keep[t];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            float gfac;
            if constexpr (DRAW == kSobolGaussian)
              gfac = g.a + g.b * normal_z_warp(w);
            else if constexpr (DRAW == kXlaSobolGaussian)
              gfac = xla_growth(g.a, g.b, sobol_normal_warp(w));
            else
              gfac = s_table[idx_exact(w, n_table)];
            if constexpr (DRAW == kXlaSobolGaussian)
              xla_step<STRATEGY>(total[j], wsum[j], gfac, keep_t, g.v0,
                                 g.amount);
            else
              step<STRATEGY>(total[j], wsum[j], gfac, keep_t, g.amount);
            w ^= d[j];
          }
        }
      }
    }
    if constexpr (DRAW == kXlaSobolGaussian) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        total[j] = xla_final<STRATEGY>(total[j], g.v0);
    }
    if (g.finals && p0 + K <= g.valid) {
#pragma unroll
      for (int j = 0; j < K; j += 4)
        *reinterpret_cast<float4*>(g.finals + p0 + j) =
            make_float4(total[j], total[j + 1], total[j + 2], total[j + 3]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (p0 + j >= g.valid) break;
      if (g.finals && p0 + K > g.valid) g.finals[p0 + j] = total[j];
      st.add(total[j], wsum[j], g.inv0, g.shift_c, g.target);
      if (with_hist)
        atomicAdd(&s_hist[bin_index(total[j], g.log_lo, g.inv_w, g.hb)], 1);
    }
  }
  st.store_block(g.partials + 8 * blockIdx.x);
  if (with_hist) {
    __syncthreads();
    flush_hist(s_hist, g.hist, g.hb);
  }
}

using KernelFn = void (*)(const Args);

template <int DRAW>
KernelFn kernel_of(int strategy) {
  switch (strategy) {
    case kNone: return run_loop_kernel<DRAW, kNone>;
    case kKeep: return run_loop_kernel<DRAW, kKeep>;
    case kFixedAmount: return run_loop_kernel<DRAW, kFixedAmount>;
    default: return nullptr;
  }
}

// The instance of (draw, strategy), or null where there is none: the
// counter draw takes no direction table, the Sobol draws 32 or 64 columns.
KernelFn kernel_of(int draw, int strategy, int dir_cols) {
  if (draw == kGaussian)
    return dir_cols == 0 ? kernel_of<kGaussian>(strategy) : nullptr;
  if (dir_cols != 32 && dir_cols != 64) return nullptr;
  switch (draw) {
    case kSobolGaussian: return kernel_of<kSobolGaussian>(strategy);
    case kSobolHistorical: return kernel_of<kSobolHistorical>(strategy);
    case kXlaSobolGaussian: return kernel_of<kXlaSobolGaussian>(strategy);
    default: return nullptr;
  }
}

// The window of months of direction rows: none for the counter draw; for
// the Sobol draws every month where the rows fit in kDirBudget, else as
// many months as fit.
int pick_window(int draw, int dir_cols, int n_periods) {
  if (draw == kGaussian) return 0;
  const size_t row_bytes = (size_t)(dir_cols + 1) * sizeof(uint32_t);
  return (int)std::min<size_t>(n_periods, kDirBudget / row_bytes);
}

}  // namespace

// One chunk of draw 1 (counter Gaussian: a, b, seed_base), 2 (Sobol
// Gaussian: a, b and the Sobol operands), 3 (Sobol historical: table,
// k_chunks, n_table and the Sobol operands) or 5 (the XLA Sobol Gaussian:
// mean and std as a and b, and the Sobol operands), the operands as
// smmc_month_loop takes them, which routes draws 1-3 here (draw 5 is
// called by ops/cuda_engine.py threefry_loop_launcher; tail_n is not read;
// dir_cols is 0 for draw 1). The grid's blocks each take groups of kBlock x
// K paths (smmc_run_info). Returns cudaGetLastError() after the launch.
extern "C" int smmc_run_loop(
    int draw, const float* table, int k_chunks, int n_table, int tail_n,
    float a, float b, const unsigned int* dir, const unsigned int* shift,
    int dir_cols, unsigned int off_lo, unsigned int off_hi, const float* keep,
    int strategy, float amount, int n_periods, unsigned int seed_base,
    unsigned int tile0, int valid, float v0, float inv0, float target,
    float shift_c, float log_lo, float inv_w, int hb, float* finals,
    double* partials, int* hist, int n_blocks, void* stream) {
  const KernelFn fn = kernel_of(draw, strategy, dir_cols);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const Args g{table, k_chunks, (uint32_t)n_table, a, b, dir, shift,
               dir_cols, ((uint64_t)off_hi << 32) | off_lo, keep, amount,
               n_periods, tile0, valid, v0, inv0, target, shift_c, log_lo,
               inv_w, hb, finals, partials, hist,
               pick_window(draw, dir_cols, n_periods), seed_base};
  const size_t smem = smem_bytes(g, draw);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fn<<<n_blocks, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return cudaGetLastError();
}

// What one chunk of draw 1, 2, 3 or 5 launches, as smmc_run_loop would with
// these operands (hist: whether the chunk bins in place): info[0] paths a
// thread (K), [1] registers a thread, [2] dynamic shared memory (bytes),
// [3] the window of months, [4] resident blocks a SM on the current device.
extern "C" int smmc_run_info(int draw, int strategy, int k_chunks,
                             int dir_cols, int n_periods, int hb, int hist,
                             int* info) {
  const KernelFn fn = kernel_of(draw, strategy, dir_cols);
  if (fn == nullptr) return cudaErrorInvalidValue;
  Args g{};
  g.k_chunks = k_chunks;
  g.dir_cols = dir_cols;
  g.hb = hb;
  g.hist = hist ? reinterpret_cast<int*>(1) : nullptr;
  g.window = pick_window(draw, dir_cols, n_periods);
  const size_t smem = smem_bytes(g, draw);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock,
                                                        smem);
  if (err != cudaSuccess) return err;
  info[0] = paths_a_thread(draw);
  info[1] = attr.numRegs;
  info[2] = (int)smem;
  info[3] = g.window;
  info[4] = per_sm;
  return cudaSuccess;
}
