// Historical month-loop kernel.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_engine.py
//   _build_kernel (kind="historical", rng_mode="counter"), built by
//   _build_pallas_call (pl.pallas_call at :1097) and run by
//   pallas_chunk_stats. Plain version: ops/cuda_engine.py
//   month_loop_chunk_plain.
//
// What it computes, per path and month: one 32-bit word of the arithmetic
// counter stream, the exact 1/n bootstrap draw by sliced rotation, and one
// compounding step under the strategy; then the chunk's stats row and log
// histogram. The stream is a pure function of (tile seed, month, position
// in the 8192-path tile), so results do not depend on the launch shape.
//
// What bounds it on an H100: integer work. A path-month costs four 32-bit
// hashes (the month's draw key, the path's own word, the words of lane 0
// and of the source lane of its row) plus two exact index maps and one
// shared-memory gather; at 360 months that is ~20k integer ops per path
// and no device-memory traffic inside the loop (the 4.5 KB table for
// n=1127 sits in shared memory).
//
// What the design does about it:
// - One thread per path. The TPU kernel shares the row's words across its
//   128 lanes; here a thread recomputes the two foreign words itself from
//   the hash, so threads never communicate (the simpler of the two
//   designs; a shared-memory row exchange is the alternative to measure).
// - The chain of K chunk-row selects becomes one load
//   table[c' * 128 + w_col] from shared memory.
// - Partial statistics are float64 per thread, reduced per block into one
//   row; the wrapper sums the rows. The 4096-cell histogram is an int32
//   shared-memory histogram built with atomicAdd and added once per block
//   to the chunk histogram (the TPU kernel's bf16 one-hot MXU product has
//   no counterpart worth having here).
// - Blocks stride over the chunk so each block flushes its histogram once.
// - Built with -fmad=false: grown - grown*keep, total*inv0 - shift and the
//   compounding products round exactly as the JAX and torch versions do.
#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Strategy { kNone = 0, kKeep = 1, kFixedAmount = 2 };

template <int STRATEGY>
__global__ void __launch_bounds__(kBlock)
month_loop_kernel(const float* __restrict__ table, int k_chunks,
                  uint32_t n_table, uint32_t tail_n,
                  const float* __restrict__ keep, float amount,
                  int n_periods, uint32_t seed_base, uint32_t tile0,
                  int valid, float v0, float inv0, float target, float shift,
                  float log_lo, float inv_w, int hb,
                  float* __restrict__ finals, double* __restrict__ partials,
                  int* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool with_hist = hist != nullptr;
  int* s_hist = reinterpret_cast<int*>(smem);
  float* s_table =
      reinterpret_cast<float*>(smem + (with_hist ? hb * sizeof(int) : 0));

  for (int i = threadIdx.x; i < k_chunks * 128; i += blockDim.x)
    s_table[i] = table[i];
  if (with_hist)
    for (int i = threadIdx.x; i < hb; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  Stats st;
  const uint32_t k_full = (uint32_t)k_chunks;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < valid;
       p += gridDim.x * blockDim.x) {
    const uint32_t pos = (uint32_t)p & (kTilePaths - 1);
    const uint32_t lane = pos & 127u;
    const uint32_t row0 = pos - lane;
    const uint32_t seed = tile_seed(seed_base, tile0 + ((uint32_t)p >> 13));
    float total = v0;
    float wsum = 0.0f;
    for (int t = 0; t < n_periods; ++t) {
      const uint32_t h = tile_seed(seed, (uint32_t)t);
      const uint32_t w = arith_word(h, pos);
      // dest role: column of this path's draw
      const uint32_t idx_dest = idx_exact(w, n_table);
      uint32_t w_col;
      if (idx_dest < tail_n) {
        w_col = idx_dest;
      } else {
        const uint32_t w0 = lane == 0 ? w : arith_word(h, row0);
        w_col = (lane + (w0 & 127u)) & 127u;
      }
      // source role of lane w_col: its chunk row c'
      const uint32_t ws = w_col == lane ? w : arith_word(h, row0 + w_col);
      const uint32_t n_valid = w_col < tail_n ? k_full : k_full - 1u;
      const uint32_t cprime = idx_exact(ws * n_table, n_valid);
      const float g = s_table[cprime * 128u + w_col];
      const float grown = total * g;
      if (STRATEGY == kNone) {
        total = grown;
      } else {
        const float nv = STRATEGY == kKeep ? grown * keep[t]
                                           : fmaxf(grown - amount, 0.0f);
        wsum = wsum + (grown - nv);
        total = nv;
      }
    }
    if (finals) finals[p] = total;
    st.add(total, wsum, inv0, shift, target);
    if (with_hist) atomicAdd(&s_hist[bin_index(total, log_lo, inv_w, hb)], 1);
  }
  st.store_block(partials + 8 * blockIdx.x);
  if (with_hist) {
    __syncthreads();
    flush_hist(s_hist, hist, hb);
  }
}

template <int STRATEGY>
cudaError_t launch(const float* table, int k_chunks, int n_table, int tail_n,
                   const float* keep, float amount, int n_periods,
                   uint32_t seed_base, uint32_t tile0, int valid, float v0,
                   float inv0, float target, float shift, float log_lo,
                   float inv_w, int hb, float* finals, double* partials,
                   int* hist, int n_blocks, cudaStream_t stream) {
  const size_t smem = (hist ? hb * sizeof(int) : 0) + k_chunks * 128 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      month_loop_kernel<STRATEGY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  month_loop_kernel<STRATEGY><<<n_blocks, kBlock, smem, stream>>>(
      table, k_chunks, (uint32_t)n_table, (uint32_t)tail_n, keep, amount,
      n_periods, seed_base, tile0, valid, v0, inv0, target, shift, log_lo,
      inv_w, hb, finals, partials, hist);
  return cudaGetLastError();
}

}  // namespace

// One chunk. strategy: 0 none, 1 keep factors (fixed/variable percent),
// 2 fixed amount. finals and hist may be null. Returns cudaGetLastError()
// after the launch.
extern "C" int smmc_month_loop(const float* table, int k_chunks, int n_table,
                               int tail_n, const float* keep, int strategy,
                               float amount, int n_periods,
                               unsigned int seed_base, unsigned int tile0,
                               int valid, float v0, float inv0, float target,
                               float shift, float log_lo, float inv_w, int hb,
                               float* finals, double* partials, int* hist,
                               int n_blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (strategy) {
    case kNone:
      return launch<kNone>(table, k_chunks, n_table, tail_n, keep, amount,
                           n_periods, seed_base, tile0, valid, v0, inv0,
                           target, shift, log_lo, inv_w, hb, finals,
                           partials, hist, n_blocks, s);
    case kKeep:
      return launch<kKeep>(table, k_chunks, n_table, tail_n, keep, amount,
                           n_periods, seed_base, tile0, valid, v0, inv0,
                           target, shift, log_lo, inv_w, hb, finals,
                           partials, hist, n_blocks, s);
    case kFixedAmount:
      return launch<kFixedAmount>(table, k_chunks, n_table, tail_n, keep,
                                  amount, n_periods, seed_base, tile0, valid,
                                  v0, inv0, target, shift, log_lo, inv_w, hb,
                                  finals, partials, hist, n_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}
