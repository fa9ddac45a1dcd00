// Histogram kernel, in three binning modes, and the tile flatten copy.
//
// Replaces:
//   - kIndex: experiments/exp_pallas_hist.py hist_kernel (pl.pallas_call at
//     :40; (4096,1) column tiles) and experiments/exp_rowhist.py
//     hist_kernel (:40; (64,128) row tiles, 64 NT gemms a tile). The two
//     TPU layouts were two ways of feeding the MXU a one-hot product; on
//     the card both are one stream of int32 indices, so one kernel ports
//     both.
//   - kClipCast: experiments/exp_flatten_cost.py k_hist (:65): float32
//     values cast to int32, then clipped to [0, hb-1].
//   - kSpec: the XLA epilogue of stock_market_monte_carlo_tpu/ops/
//     pallas_engine.py (:1753-1758), HistogramSpec.bin_index then
//     histogram_counts, which counts the finals when the month loop, the
//     law or the CLT cannot bin in the kernel (hb not a multiple of 64, or
//     above 4096).
//   - flatten_tile_kernel: experiments/exp_flatten_cost.py k_reshape (:29),
//     a (64,128) tile to (8192,1) in row-major order.
//   Plain versions: ops/histogram.py.
//
// What it computes: counts[c] = #{i : bin(x_i) == c} for c in [0, hb);
// a bin outside [0, hb) is dropped, as histogram_counts drops it (kIndex
// takes hb itself as the "discard" index of a masked lane).
//
// What bounds it on an H100: bytes. Each input is read once (4 B) and
// binning takes a few operations (kSpec: a logf and ~10 more), far below
// the ~10 operations a byte the card issues; the counts are the only
// output. 2^24 inputs: 64 MiB, 0.020 ms at 3.35 TB/s.
//
// What the design does about it: one pass over the input, four loads in
// flight per thread before their atomics. Each block keeps a shared-memory
// sub-histogram of the first min(hb, kSmemCells) cells (int32, up to
// 224 KB of the 227 KB a block may opt into); a bin past those goes
// straight to a global atomic, so there is no cell cap. The block adds its
// non-zero shared cells to the output with global atomics once at the end.
// The grid is the blocks that fit on the card at once (at most two per
// SM), so the flush costs a few hundred passes over the shared cells, not
// one per input tile as the TPU's grid of 2048 steps paid it. Integer
// atomics are exact and order-free: the counts do not depend on the
// launch shape. Built with -fmad=false like every kernel here, so kSpec's
// (logv - log_lo) * inv_w rounds as the plain version's.
#include <algorithm>

#include "smmc_common.cuh"

namespace {

using namespace smmc;

enum Mode { kIndex = 0, kClipCast = 1, kSpec = 2 };

constexpr int kThreads = 1024;
constexpr int kSmemCells = 56 * 1024;  // 224 KB of int32
constexpr int kUnroll = 4;

struct Spec {
  float lo, log_lo, inv_w;
  int n_bins;
};

// HistogramSpec.bin_index of one float32 value, as XLA on the CPU runs
// it: log(max(v, 1e-37)) with NaN kept, floor((logv - log_lo) * inv_w),
// the int32 cast (saturating, NaN -> 0), + 1 (wrapping at 2^31, which
// sends +inf to cell 1), clipped to [1, n_bins + 1]; 0 where v < lo.
__device__ __forceinline__ int spec_bin(float v, const Spec& s) {
  const float m = v != v ? v : fmaxf(v, F(1e-37));
  const float x = floorf((logf(m) - s.log_lo) * s.inv_w);
  const int raw = (int)((uint32_t)__float2int_rz(x) + 1u);
  const int idx = min(max(raw, 1), s.n_bins + 1);
  return v < s.lo ? 0 : idx;
}

template <int MODE>
__device__ __forceinline__ int bin_of(const void* in, long long i, int hb,
                                      const Spec& s) {
  if constexpr (MODE == kIndex) {
    return static_cast<const int*>(in)[i];
  } else if constexpr (MODE == kClipCast) {
    const int c = __float2int_rz(static_cast<const float*>(in)[i]);
    return min(max(c, 0), hb - 1);
  } else {
    return spec_bin(static_cast<const float*>(in)[i], s);
  }
}

__device__ __forceinline__ void count(int b, int s_cells, int hb, int* s_hist,
                                      int* hist) {
  if ((uint32_t)b < (uint32_t)s_cells)
    atomicAdd(&s_hist[b], 1);
  else if ((uint32_t)b < (uint32_t)hb)
    atomicAdd(&hist[b], 1);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const void* __restrict__ in, int n, int hb, int s_cells,
                 Spec s, int* __restrict__ hist) {
  extern __shared__ int s_hist[];
  for (int i = threadIdx.x; i < s_cells; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    int b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) b[u] = bin_of<MODE>(in, i + u * stride,
                                                          hb, s);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count(b[u], s_cells, hb, s_hist, hist);
  }
  for (; i < n; i += stride)
    count(bin_of<MODE>(in, i, hb, s), s_cells, hb, s_hist, hist);
  __syncthreads();
  flush_hist(s_hist, hist, s_cells);
}

template <int MODE>
cudaError_t launch(const void* in, int n, int hb, const Spec& s, int* hist,
                   cudaStream_t stream) {
  const int s_cells = std::min(hb, kSmemCells);
  const size_t smem = (size_t)s_cells * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, histogram_kernel<MODE>, kThreads, smem)) != cudaSuccess)
    return err;
  const long long need = ((long long)n + kThreads * kUnroll - 1) /
                         (kThreads * kUnroll);
  const long long fit = (long long)sms * std::max(1, std::min(per_sm, 2));
  const int n_blocks = (int)std::max(1LL, std::min(need, fit));
  histogram_kernel<MODE><<<n_blocks, kThreads, smem, stream>>>(in, n, hb,
                                                               s_cells, s,
                                                               hist);
  return cudaGetLastError();
}

// out[(t * 64 + r) * 128 + c] = x[t][r][c]: row-major (64,128) tiles and
// the (8192,1) column share one linear order, so the flatten is a copy of
// 16-byte words.
__global__ void __launch_bounds__(256)
flatten_tile_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                    long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x)
    out[i] = x[i];
}

}  // namespace

// counts[c] (hb int32 cells, zeroed by the caller) += #{i < n : bin(x_i)
// == c}. mode: 0 kIndex (x int32 indices), 1 kClipCast (x float32), 2 kSpec
// (x float32 finals; lo, log_lo, inv_w and n_bins = hb - 2 of the
// HistogramSpec). Returns cudaGetLastError() after the launch.
extern "C" int smmc_histogram(int mode, const void* x, int n, int hb,
                              float lo, float log_lo, float inv_w, int* hist,
                              void* stream) {
  if (n < 0 || hb < 1 || (mode == kSpec && hb < 3))
    return cudaErrorInvalidValue;
  const Spec s{lo, log_lo, inv_w, hb - 2};
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kIndex: return launch<kIndex>(x, n, hb, s, hist, st);
    case kClipCast: return launch<kClipCast>(x, n, hb, s, hist, st);
    case kSpec: return launch<kSpec>(x, n, hb, s, hist, st);
    default: return cudaErrorInvalidValue;
  }
}

// out (n_tiles * 8192 floats) = x (n_tiles, 64, 128) flattened in
// row-major order; both 16-byte aligned. Returns cudaGetLastError().
extern "C" int smmc_flatten_tile(const float* x, float* out, int n_tiles,
                                 void* stream) {
  if (n_tiles < 0) return cudaErrorInvalidValue;
  const long long n4 = (long long)n_tiles * kTilePaths / 4;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long need = (n4 + 255) / 256;
  const int n_blocks =
      (int)std::max(1LL, std::min(need, (long long)sms * 8));
  flatten_tile_kernel<<<n_blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n4);
  return cudaGetLastError();
}
