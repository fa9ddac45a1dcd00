// Calibration kernels of the headline benchmark: the dispatch floor and the
// integer issue-rate probe.
//
// Replaces:
// - experiments/exp_grid_overhead.py:43 _make (pl.pallas_call at :66), the
//   do-nothing kernel whose time bench.py:157 reports as the dispatch floor.
//   Per 8192-path tile, variant "const" writes finals (64, 128) = 1.0 and
//   partials (8, 128) = 2.0; the random variant writes the tile's u23
//   uniforms to finals and their column sum over the 64 rows, eight times,
//   to the partials. The TPU kernel draws the hardware PRNG seeded with
//   _tile_seed_i32(seed, tile0 + tile); its counterpart here, "counter",
//   draws the port's counter stream from that seed: key 0 of
//   _TileRng(_tile_seed_i32(seed, tile0 + tile), "arith"). The TPU grid
//   step covers `group` tiles.
// - experiments/exp_hist_roofline.py:60 make_calib_call (:102), the kernel
//   pair bench.py:231 times to get the sustained integer issue rate. Per
//   path: x = the counter word of key 0 of the tile seeded seed + tile (the
//   TPU kernel's prng_seed(iscal[0] + pid) under the arith stream), then
//   (n_periods / 8) * 8 months of n_ops / 4 steps of y ^= y << 5;
//   y ^= y >> 7 (logical); y *= 2654435761; y += k + 1, each month ending in
//   total *= 1 + float(int32 y) * 1e-12.
// Plain versions: ops/calibration.py grid_overhead_chunk_plain and
// calib_chunk_plain.
//
// What bounds them on an H100:
// - Grid overhead: bytes. A 2^24-path chunk writes 64 MiB of finals and
//   8 MiB of partials, 75.5 MB, 22.5 us at 3.35 TB/s; the counter variant
//   adds two hashes and a u23 per path, well under that.
// - Calibration: the issue rate of 32-bit integer instructions. nvcc
//   compiles a step of four source operators into five instructions: an
//   IMAD for the multiply and the add, a second IMAD for the next step's
//   y << 5 (folded into a multiply by 32 * 2654435761), two LOP3 and one
//   SHF. A month of the built kernel is 24.625 SASS instructions at
//   n_ops = 16 and 64.625 at 48 (the 8-month loop body over 8: 4 or 12
//   steps, I2FP, FMUL, FADD, FMUL, and the loop's count and branch), so
//   the 32 extra operators are 40 instructions (cuobjdump -sass, CUDA
//   12.8, sm_90a). The headline reads these counts from the SASS
//   (calibration.calib_sass_instructions), not from the source.
//
// What the design does about it:
// - One thread a path, 256-thread blocks. For the grid overhead a block
//   owns `group` consecutive tiles and loops over them: group is not a grid
//   dimension, so group 16 launches 1/16 of the blocks of group 1 with the
//   same work, which is what the TPU experiment varies. The column sum runs
//   in row order through shared memory (the tile's 32 KB of uniforms) with
//   no atomics: group 1 and group 16 agree bit for bit, and the sum rounds
//   as a sequential sum over the rows does.
// - The calibration chain stays serial within a thread, as in the TPU
//   kernel; n_ops is a template parameter, so the chain unrolls, and the
//   months run as an outer loop of n_periods / 8 iterations (not unrolled)
//   over 8 unrolled months, the TPU kernel's fori_loop of UNROLL = 8. The
//   output depends on every month's y, so nothing of the chain is dead.
// - Built with -fmad=false: 1 + y * 1e-12 rounds twice, as the torch
//   version does.
#include "smmc_common.cuh"

namespace {

using namespace smmc;

constexpr int kRows = 64;         // rows of a tile (64 x 128 paths)
constexpr int kPartialRows = 8;   // partial rows a tile writes
constexpr int kCalibUnroll = 8;   // months of one iteration of the loop
constexpr uint32_t kCalibMul = 2654435761u;

template <bool COUNTER>
__global__ void __launch_bounds__(kBlock)
grid_overhead_kernel(uint32_t seed, uint32_t tile0, int group,
                     float* __restrict__ finals,
                     float* __restrict__ partials) {
  __shared__ float s_u[COUNTER ? kTilePaths : 1];
  for (int g = 0; g < group; ++g) {
    const int tile = blockIdx.x * group + g;
    float* f = finals + (size_t)tile * kTilePaths;
    float* p = partials + (size_t)tile * kPartialRows * 128;
    if (!COUNTER) {
      for (int i = threadIdx.x; i < kTilePaths; i += kBlock) f[i] = 1.0f;
      for (int i = threadIdx.x; i < kPartialRows * 128; i += kBlock)
        p[i] = 2.0f;
      continue;
    }
    const uint32_t h = tile_seed(tile_seed(seed, tile0 + (uint32_t)tile), 0u);
    for (int i = threadIdx.x; i < kTilePaths; i += kBlock) {
      const float u = u23(arith_word(h, (uint32_t)i));
      f[i] = u;
      s_u[i] = u;
    }
    __syncthreads();
    if (threadIdx.x < 128) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += s_u[r * 128 + threadIdx.x];
      for (int r = 0; r < kPartialRows; ++r) p[r * 128 + threadIdx.x] = s;
    }
    __syncthreads();  // s_u is rewritten by the next tile
  }
}

template <int N_OPS>
__global__ void __launch_bounds__(kBlock)
calib_kernel(uint32_t seed, int n_iters, int n_paths,
             float* __restrict__ out) {
  const int gid = blockIdx.x * kBlock + threadIdx.x;
  if (gid >= n_paths) return;
  const uint32_t tile = (uint32_t)gid / kTilePaths;
  const uint32_t pos = (uint32_t)gid % kTilePaths;
  uint32_t y = arith_word(tile_seed(seed + tile, 0u), pos);
  float total = 1.0f;
#pragma unroll 1
  for (int i = 0; i < n_iters; ++i) {
#pragma unroll
    for (int m = 0; m < kCalibUnroll; ++m) {
#pragma unroll
      for (int k = 0; k < N_OPS / 4; ++k) {
        y ^= y << 5;
        y ^= y >> 7;
        y *= kCalibMul;
        y += (uint32_t)(k + 1);
      }
      total = total * (1.0f + (float)(int32_t)y * F(1e-12));
    }
  }
  out[gid] = total;
}

template <int N_OPS>
cudaError_t launch_calib(uint32_t seed, int n_iters, int n_paths, float* out,
                         cudaStream_t stream) {
  const int n_blocks = (n_paths + kBlock - 1) / kBlock;
  calib_kernel<N_OPS><<<n_blocks, kBlock, 0, stream>>>(seed, n_iters,
                                                       n_paths, out);
  return cudaGetLastError();
}

}  // namespace

// One grid-overhead chunk of n_blocks * group tiles: variant 0 const, 1
// counter. finals (tiles * 8192,) and partials (tiles * 1024,) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int smmc_grid_overhead(int variant, unsigned int seed,
                                  unsigned int tile0, int group, int n_blocks,
                                  float* finals, float* partials,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      grid_overhead_kernel<false><<<n_blocks, kBlock, 0, s>>>(
          seed, tile0, group, finals, partials);
      break;
    case 1:
      grid_overhead_kernel<true><<<n_blocks, kBlock, 0, s>>>(
          seed, tile0, group, finals, partials);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// One calibration chunk of n_paths (a multiple of 8192) paths and
// n_iters * 8 months; tile t is seeded seed + t. out (n_paths,) float32.
// n_ops: 16 or 48.
extern "C" int smmc_calib(int n_ops, unsigned int seed, int n_iters,
                          int n_paths, float* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_ops) {
    case 16: return launch_calib<16>(seed, n_iters, n_paths, out, s);
    case 48: return launch_calib<48>(seed, n_iters, n_paths, out, s);
    default: return cudaErrorInvalidValue;
  }
}
