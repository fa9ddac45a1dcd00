// Terminal-law kernel, with and without per-path finals.
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_engine.py
//   _build_law_kernel (finals; pl.pallas_call at :1252) and
//   _build_law_stats_kernel (finals-free; pl.pallas_call at :1445), both
//   run by _law_chunk_stats. Plain version: ops/cuda_engine.py
//   law_chunk_plain.
//
// What it computes, per path: one word of the arithmetic counter stream
// (key 0 of the tile seeded by seed_base ^ 0x1A37), u23 uniform,
// z = sqrt(2) * erfinv(2u - 1), s = z / 6.25, a 48-term Clenshaw recurrence
// over the fitted law operand, V = scale * exp(...); then the same stats
// row and log histogram as the month loop, with the withdrawn row at 0.
//
// What bounds it on an H100: ~150 float32 ops per path (erfinv, Clenshaw,
// exp, and the log of the histogram bin) and one shared-memory atomic;
// writing finals (4 B/path) is the only device-memory traffic, and the
// finals-free form has none beyond the per-block rows.
//
// What the design does about it: one thread per path; the 49-float operand
// is broadcast from shared memory; a template flag drops the finals store.
// The TPU kernels' grouping of 32 tiles per grid step and their int8/bf16
// one-hot histogram were devices against the TPU's per-grid-step overhead
// and have no counterpart here; they change no sampled value. Built with
// -fmad=false so the Clenshaw step 2s*b1 - b2 + c rounds as in the JAX and
// torch versions.
#include "smmc_common.cuh"

namespace {

using namespace smmc;

constexpr int kMaxLawOperand = 64;

template <bool WRITE_FINALS>
__global__ void __launch_bounds__(kBlock)
law_kernel(const float* __restrict__ law, int law_d, uint32_t seed_base,
           uint32_t tile0, int valid, float inv0, float target, float shift,
           float inv_zmax, float log_lo, float inv_w, int hb,
           float* __restrict__ finals, double* __restrict__ partials,
           int* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_law[kMaxLawOperand];
  const bool with_hist = hist != nullptr;
  int* s_hist = reinterpret_cast<int*>(smem);

  for (int i = threadIdx.x; i <= law_d; i += blockDim.x) s_law[i] = law[i];
  if (with_hist)
    for (int i = threadIdx.x; i < hb; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  Stats st;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < valid;
       p += gridDim.x * blockDim.x) {
    const uint32_t seed = tile_seed(seed_base, tile0 + ((uint32_t)p >> 13));
    const uint32_t w =
        arith_word(tile_seed(seed, 0u), (uint32_t)p & (kTilePaths - 1));
    const float s = normal_z(w) * inv_zmax;
    const float two_s = 2.0f * s;
    float b1 = 0.0f, b2 = 0.0f;
    for (int k = law_d - 1; k > 0; --k) {
      const float b0 = two_s * b1 - b2 + s_law[1 + k];
      b2 = b1;
      b1 = b0;
    }
    const float total = s_law[0] * expf(s * b1 - b2 + s_law[1]);
    if (WRITE_FINALS) finals[p] = total;
    st.add(total, 0.0f, inv0, shift, target);
    if (with_hist) atomicAdd(&s_hist[bin_index(total, log_lo, inv_w, hb)], 1);
  }
  st.store_block(partials + 8 * blockIdx.x);
  if (with_hist) {
    __syncthreads();
    flush_hist(s_hist, hist, hb);
  }
}

template <bool WRITE_FINALS>
cudaError_t launch(const float* law, int law_d, uint32_t seed_base,
                   uint32_t tile0, int valid, float inv0, float target,
                   float shift, float inv_zmax, float log_lo, float inv_w,
                   int hb, float* finals, double* partials, int* hist,
                   int n_blocks, cudaStream_t stream) {
  const size_t smem = hist ? hb * sizeof(int) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      law_kernel<WRITE_FINALS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  law_kernel<WRITE_FINALS><<<n_blocks, kBlock, smem, stream>>>(
      law, law_d, seed_base, tile0, valid, inv0, target, shift, inv_zmax,
      log_lo, inv_w, hb, finals, partials, hist);
  return cudaGetLastError();
}

}  // namespace

// One chunk. law holds law_d + 1 floats [scale, c_0 .. c_{law_d-1}];
// finals and hist may be null (null finals selects the finals-free
// kernel). Returns cudaGetLastError() after the launch.
extern "C" int smmc_law(const float* law, int law_d, unsigned int seed_base,
                        unsigned int tile0, int valid, float inv0,
                        float target, float shift, float inv_zmax,
                        float log_lo, float inv_w, int hb, float* finals,
                        double* partials, int* hist, int n_blocks,
                        void* stream) {
  if (law_d < 1 || law_d + 1 > kMaxLawOperand) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (finals)
    return launch<true>(law, law_d, seed_base, tile0, valid, inv0, target,
                        shift, inv_zmax, log_lo, inv_w, hb, finals, partials,
                        hist, n_blocks, s);
  return launch<false>(law, law_d, seed_base, tile0, valid, inv0, target,
                       shift, inv_zmax, log_lo, inv_w, hb, finals, partials,
                       hist, n_blocks, s);
}
