// Terminal-law kernel, with and without per-path finals, under two
// draws.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_engine.py
//   _build_law_kernel (finals; pl.pallas_call at :1252) and
//   _build_law_stats_kernel (finals-free; pl.pallas_call at :1445), both
//   run by _law_chunk_stats (the counter draw). The threefry draw
//   replaces no Pallas kernel: it runs the JAX package's XLA law,
//   engine._law_finals_xla (stock_market_monte_carlo_tpu/engine/
//   engine.py:328) and chunk_stats' epilogue. Plain version:
//   ops/cuda_engine.py law_chunk_plain.
//
// What it computes, per path: one word of the arithmetic counter stream
// (key 0 of the tile seeded by seed_base ^ 0x1A37), u23 uniform,
// z = sqrt(2) * erfinv(2u - 1), s = z / 6.25, a 48-term Clenshaw recurrence
// over the fitted law operand, V = scale * exp(...); then the same stats
// row and log histogram as the month loop, with the withdrawn row at 0.
// The threefry draw (kThreefry) takes the path's word from the XLA
// backend's stream instead: counter p mod 8192 under the tile key
// fold_in(law key, tile), the law key fold_in(segment key, 0x1A37) made
// by the wrapper, then jax.random.normal's uniform and erfinv (one
// normal a path, clamped to +-LAW_CLAMP before the scale by 1 / 6.25);
// the recurrence and the finish are the same.
//
// What bounds it on an H100: issue slots. About 213 32-bit operations a
// path (bench/roofline.py: the word, the normal draw, 3 x 47 Clenshaw
// steps, exp, the stats and the bin) and one shared-memory atomic; writing
// finals (4 B a path) is the only device-memory traffic.
//
// What the design does about it: it issues what that count holds. The
// operand length is a compile-time constant (kLawD, the engine's LAW_D),
// the Clenshaw recurrence is unrolled, and its 49 floats come by value in
// the kernel's parameters, so each step is an FMUL and two FADDs with the
// coefficient a constant-bank operand: no load, no loop control. A block
// pass takes kUnitPaths consecutive paths of one 8192-path RNG tile (a
// unit), so the tile's key, two hashes of block-uniform values, is made
// once a pass and each path hashes only its own word. The normal draw
// evaluates erfinv's tail polynomial only in the warps that need it
// (normal_z_warp: the lanes past `valid` in the last unit draw and count
// nowhere, so the warp stays whole), and the stats add no withdrawn term.
// One launch a chunk: the last block to take the launch's ticket reduces
// the blocks' stats rows and writes the float32 stats row and histogram,
// which the wrapper would otherwise do with some ten torch launches on a
// path whose host sets the pace. The TPU kernels' grouping of 32 tiles a
// grid step and their int8/bf16 one-hot histogram were devices against
// the TPU's per-grid-step overhead and have no counterpart here; they
// change no sampled value. Built with -fmad=false so the Clenshaw step
// 2s*b1 - b2 + c rounds as in the JAX and torch versions.
#include <cstring>

#include "smmc_common.cuh"

namespace {

using namespace smmc;

constexpr int kLawD = 48;           // Chebyshev terms (ops/terminal_law.py)
constexpr float kLawClamp = 5.99f;  // LAW_CLAMP (ops/terminal_law.py)
enum Draw { kCounter = 0, kThreefry = 1 };
constexpr int kLawPaths = 4;        // paths a thread a pass
constexpr int kUnitPaths = kBlock * kLawPaths;
constexpr int kUnitsPerTile = kTilePaths / kUnitPaths;
constexpr int kMaxCells = 4096;     // cuda_engine.KERNEL_HIST_CELLS
// resident blocks a SM (at most 32 registers a thread): every block of
// the grid the launcher sizes at once, 2048 threads a SM
constexpr int kLawBlocksPerSM = 8;
static_assert(kTilePaths % kUnitPaths == 0, "a unit lies in one RNG tile");

struct Args {
  float law[kLawD + 1];             // [scale, c_0 .. c_47]
  uint32_t seed_base, tile0;
  int valid;
  float inv0, target, shift, inv_zmax, log_lo, inv_w;
  int hb;
  float* finals;                    // valid floats, or null
  double* partials;                 // a row of 8 a block
  int* counts;                      // hb in-place cells (zeroed), or null
  unsigned int* ticket;             // the launch's ticket (zeroed)
  float* stats;                     // the chunk's float32[9] stats row
  float* hist;                      // its float32[hb] histogram, or null
                                    // (16-byte aligned, as counts)
  uint32_t key0, key1;              // the law key of the threefry draw
};

// The chunk's finish, by the last block to finish: the float32 stats row
// from the blocks' float64 rows, and the histogram as float32. Warp k
// reduces column k of the rows: lane l takes blocks l, l + 32, ... in
// order, then lane 0 takes the 32 lanes' results in lane order
// (cuda_engine.law_stats_twin). The loads go out in batches (a lane's
// missing rows read as the identity, which leaves its result's bits as
// they are), the cells four at a time. The cells and the ticket are left
// zero, so the launch can be repeated on the same buffers.
__device__ void finish(const Args& a) {
  static_assert(kBlock == 8 * 32, "a warp a column of the stats rows");
  constexpr int kBatch = 4;
  const int k = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = gridDim.x;
  const bool is_min = k == 4, is_max = k == 5;
  const double ident = is_min ? INFINITY : is_max ? -INFINITY : 0.0;
  double acc = ident;
  for (int r0 = lane; r0 < n; r0 += 32 * kBatch) {
    double v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = r0 + 32 * j;
      v[j] = r < n ? __ldcg(a.partials + 8 * r + k) : ident;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      acc = is_min ? fmin(acc, v[j]) : is_max ? fmax(acc, v[j]) : acc + v[j];
  }
  double tot = __shfl_sync(0xffffffffu, acc, 0);
#pragma unroll
  for (int l = 1; l < 32; ++l) {
    const double v = __shfl_sync(0xffffffffu, acc, l);
    tot = is_min ? fmin(tot, v) : is_max ? fmax(tot, v) : tot + v;
  }
  if (lane == 0) a.stats[1 + k] = (float)tot;
  if (threadIdx.x == 0) {
    a.stats[0] = (float)a.valid;
    *a.ticket = 0u;
  }
  if (a.counts != nullptr) {
    int4* counts = reinterpret_cast<int4*>(a.counts);
    float4* hist = reinterpret_cast<float4*>(a.hist);
#pragma unroll 4
    for (int i = threadIdx.x; i < a.hb / 4; i += kBlock) {
      const int4 c = __ldcg(counts + i);
      counts[i] = make_int4(0, 0, 0, 0);
      hist[i] = make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
    }
  } else if (a.hist != nullptr) {
    for (int i = threadIdx.x; i < a.hb; i += kBlock) a.hist[i] = 0.0f;
  }
}

// V of a scaled normal s: the unrolled Clenshaw recurrence on the
// parameter-bank coefficients, scale * exp.
__device__ __forceinline__ float law_of_s(const Args& a, float s) {
  const float two_s = 2.0f * s;
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int k = kLawD - 1; k > 0; --k) {
    const float b0 = two_s * b1 - b2 + a.law[1 + k];
    b2 = b1;
    b1 = b0;
  }
  return a.law[0] * expf(s * b1 - b2 + a.law[1]);
}

// V of one word of the counter draw. Call from a whole warp.
__device__ __forceinline__ float law_value(const Args& a, uint32_t w) {
  return law_of_s(a, normal_z_warp(w) * a.inv_zmax);
}

// V of one word of the threefry draw: the clamped normal, scaled
__device__ __forceinline__ float law_value_threefry(const Args& a,
                                                    uint32_t w) {
  const float z = threefry_normal(w);
  return law_of_s(a, fminf(fmaxf(z, -kLawClamp), kLawClamp) * a.inv_zmax);
}

template <int DRAW, bool WRITE_FINALS>
__global__ void __launch_bounds__(kBlock, kLawBlocksPerSM)
law_kernel(const __grid_constant__ Args a) {
  extern __shared__ int s_hist[];
  __shared__ bool s_last;
  const bool with_hist = a.counts != nullptr;
  if (with_hist)
    for (int i = threadIdx.x; i < a.hb; i += kBlock) s_hist[i] = 0;
  __syncthreads();

  Stats st;
  const int n_units = (a.valid + kUnitPaths - 1) / kUnitPaths;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    // the unit's tile key, from block-uniform values
    const uint32_t tile = a.tile0 + (uint32_t)(u / kUnitsPerTile);
    uint32_t h = 0u;
    uint2 tk = make_uint2(0u, 0u);
    if constexpr (DRAW == kThreefry)
      tk = threefry_fold_in(make_uint2(a.key0, a.key1), tile);
    else
      h = tile_seed(tile_seed(a.seed_base, tile), 0u);
    const int p0 = u * kUnitPaths + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kLawPaths; ++i) {
      const int p = p0 + i * kBlock;
      const uint32_t pos = (uint32_t)p & (kTilePaths - 1);
      float total;
      if constexpr (DRAW == kThreefry)
        total = law_value_threefry(a, threefry_bits(tk, pos));
      else
        total = law_value(a, arith_word(h, pos));
      if (p < a.valid) {
        if (WRITE_FINALS) a.finals[p] = total;
        st.add_value(total, a.inv0, a.shift, a.target);
        if (with_hist)
          atomicAdd(&s_hist[bin_index(total, a.log_lo, a.inv_w, a.hb)], 1);
      }
    }
  }
  st.store_block(a.partials + 8 * blockIdx.x);
  if (with_hist) {
    __syncthreads();
    flush_hist(s_hist, a.counts, a.hb);
  }
  // one launch a chunk: the block's row and cells, ordered before thread
  // 0's fence by the barrier, are visible device-wide before the block
  // takes its ticket (as a cooperative grid's sync orders them); the last
  // ticket finishes the chunk
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (s_last) finish(a);
}

}  // namespace

// One chunk, one launch. law points to law_d + 1 host floats [scale, c_0
// .. c_{law_d-1}], passed by value; law_d must be kLawD. partials holds
// n_blocks rows of 8 doubles (overwritten); ticket one zeroed word; counts
// (in-place binning) hb zeroed cells, hb a multiple of 4, or null; the
// kernel writes stats (float32[9]) and, where hist is not null, hist
// (float32[hb]: the cells, or zeros without counts); counts and hist are
// 16-byte aligned. finals may be null (null finals selects the
// finals-free kernel). draw: 0 the counter stream (seed_base), 1 the
// threefry stream (key0, key1: the law key). Returns cudaGetLastError()
// after the launch.
extern "C" int smmc_law(const float* law, int law_d, unsigned int seed_base,
                        unsigned int tile0, int valid, float inv0,
                        float target, float shift, float inv_zmax,
                        float log_lo, float inv_w, int hb, float* finals,
                        double* partials, int* counts, unsigned int* ticket,
                        float* stats, float* hist, int draw,
                        unsigned int key0, unsigned int key1, int n_blocks,
                        void* stream) {
  if (law == nullptr || law_d != kLawD || n_blocks < 1 ||
      (draw != kCounter && draw != kThreefry) ||
      partials == nullptr || ticket == nullptr || stats == nullptr ||
      (counts != nullptr &&
       (hist == nullptr || hb < 4 || hb > kMaxCells || hb % 4 != 0 ||
        reinterpret_cast<uintptr_t>(counts) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(hist) % 16 != 0)))
    return cudaErrorInvalidValue;
  Args a;
  std::memcpy(a.law, law, sizeof a.law);
  a.seed_base = seed_base;
  a.tile0 = tile0;
  a.valid = valid;
  a.inv0 = inv0;
  a.target = target;
  a.shift = shift;
  a.inv_zmax = inv_zmax;
  a.log_lo = log_lo;
  a.inv_w = inv_w;
  a.hb = hb;
  a.finals = finals;
  a.partials = partials;
  a.counts = counts;
  a.ticket = ticket;
  a.stats = stats;
  a.hist = hist;
  a.key0 = key0;
  a.key1 = key1;
  const size_t smem = counts ? hb * sizeof(int) : 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (draw == kThreefry) {
    if (finals)
      law_kernel<kThreefry, true><<<n_blocks, kBlock, smem, s>>>(a);
    else
      law_kernel<kThreefry, false><<<n_blocks, kBlock, smem, s>>>(a);
  } else if (finals) {
    law_kernel<kCounter, true><<<n_blocks, kBlock, smem, s>>>(a);
  } else {
    law_kernel<kCounter, false><<<n_blocks, kBlock, smem, s>>>(a);
  }
  return cudaGetLastError();
}
