// Calibration kernels of the headline benchmark (the dispatch floor and the
// integer issue-rate probe) and the CLT's op-class toys.
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
// - experiments/exp_clt_roofline.py:56 _make_toy(op) (:104), the op-class
//   toys that calibrate the CLT's block chain: per (4096, 128) tile (4096
//   tiles a 2^24-path chunk equivalent, 2^31 elements), a carried chain of
//   12 passes of one op class, rows 0-7 of each tile written out:
//   mul x = x*c; fma x = a + x*c (FMUL then FADD: -fmad=false, as the
//   CLT's affine step issues it); iadd xi = xi + ci; shf xi = (xi >> 1) +
//   ci (logical); cvt bacc = bacc + bf16(xi), xi = xi + ci (bf16
//   accumulator, out = bacc + xi); mm y = bf16(x) @ Q (float32
//   accumulate), x = a + y*c. A seventh class, hash, is the port's own:
//   xi = finalize(xi + ci * golden), the counter stream's word, which the
//   CLT hashes per count and the TPU's hardware PRNG did not. x starts at
//   c, xi at 3, bacc at 0 (the TPU toy's 1.0 * c, 3 and 0).
// Plain versions: ops/calibration.py grid_overhead_chunk_plain,
// calib_chunk_plain and op_toy_chunk_plain.
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
// - Toys: operations of one class, 12 x 2^31 a chunk equivalent: mul
//   2.6e10 FMUL, 0.77 ms at the issue rate; mm 6.6e12 flop, 6.7 ms at the
//   data-sheet bf16 rate. No memory traffic beyond 16 MiB of output.
//
// SASS of the toys (cuobjdump -sass, CUDA 12.8, sm_90a; ops/calibration.py
// op_toy_sass reads it): a thread's 12 passes of 16 chains (192 element-
// passes; mm: one pass of its 64), chain opcodes first, setup and stores
// after:
//   mul   FMUL 207 (192 + 15 to start the chains); 1.34 an element-pass
//   fma   FMUL 207, FADD 192 (-fmad=false); 2.34
//   iadd  IADD3 97, VIADD 27 (the addends and the chains' starts): each
//         pass adds its own addend register, and one IADD3 (a three-input
//         add) takes two passes' adds, all on the integer pipe; 0.98
//   shf   LEA 194: (x >> 1) + cp is one LEA.HI, the shift is free; 1.48
//   cvt   I2F 192 (int32 to bf16, on the 16-lane conversion unit), HFMA2
//         51 and HADD2 45 (the bf16 adds, two a instruction), IMAD 120,
//         PRMT 106, IADD3 97; 3.70
//   mm    a pass: HMMA 128, LDS 128 (the B fragments, reloaded each
//         pass), F2FP 32 (two bf16 a pack), FMUL 64, FADD 64; 6.64
//   hash  IMAD 595, SHF 594, LOP3 580: three of each a word; 9.51
// (A first build without the threadIdx term ran the integer chains on the
// uniform datapath: ULEA, UIADD3, UIMAD.)
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
// - Toys: a thread carries 16 independent chains (64 for mm) in registers,
//   so the pipes stay full: the toy measures a throughput. The chains start
//   from runtime values (x_k = x_{k-1} * one, xi_k = xi_{k-1} + zero, one
//   = 1 and zero = 0 passed in, the first chain offset by threadIdx & zero),
//   so the compiler can neither fold a chain, nor merge equal ones, nor
//   run a chain once a warp on the uniform datapath (which it did with the
//   integer chains before the threadIdx term). The integer adds go through
//   inline PTX, and pass p adds its own register cp[p] = ci + p * zero:
//   with one ci, ptxas added two passes as x + 2ci in a LEA or an IMAD on
//   the FMA pipe. Two adds still fit one IADD3, whatever the addends, so
//   the chain issues one IADD3 for two passes. Only rows 0-7 of a
//   tile are written, as the TPU toy writes them; every other chain ends in
//   a compare with a runtime sentinel that never matches (a bit pattern no
//   chain reaches), so no chain is dead. mm keeps x in the accumulator
//   layout of mma.sync m16n8k16 (a warp owns 16 rows, all 128 columns):
//   the accumulators of n-tiles 2ks and 2ks+1 are the A fragment of k-step
//   ks, packed to bf16 in registers, so x never leaves the registers.
#include <cuda_bf16.h>

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

enum ToyOp { kMul = 0, kFma = 1, kIadd = 2, kShf = 3, kCvt = 4, kMm = 5,
             kHash = 6 };
constexpr int kToyRows = 4096;                  // rows of a toy tile
constexpr int kToyTileElems = kToyRows * 128;   // 2^19
constexpr int kToyPasses = 12;
constexpr int kToyOutRows = 8;                  // rows written a tile
constexpr int kToyChains = 16;                  // chains a thread (not mm)
constexpr int kToyMmThreads = 128;              // mm: 4 warps, 64 rows

struct ToyArgs {
  float c, a, one;
  uint32_t xi0, ci, zero, never;
  const unsigned short* q;  // mm: Q (128, 128) bf16 bits
  float* out;               // (n_tiles * 8, 128)
};

// x + y, opaque to the compiler's reassociation
__device__ __forceinline__ uint32_t add_u32(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("add.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mm: a warp owns 16 rows of a tile and all 128 columns; x[nt][e] is row
// gid + 8*(e >> 1), column nt*8 + 2*tig + (e & 1) (the C layout).
__device__ __forceinline__ void op_toy_mm(const ToyArgs& g) {
  __shared__ uint2 s_q[kMixFrags];
  stage_mix_frags(g.q, s_q);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  constexpr int blocks_per_tile = kToyRows / (kToyMmThreads / 2);
  const int row = (blockIdx.x % blocks_per_tile) * (kToyMmThreads / 2) +
                  (threadIdx.x >> 5) * 16 + gid;
  float x[kMixNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kMixNTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nt][e] = g.c;
#pragma unroll 1
  for (int p = 0; p < kToyPasses; ++p) {
    float acc[kMixNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kMixNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kMixKSteps; ++ks) {
      const uint32_t a[4] = {
          bf16x2_bits(x[2 * ks][0], x[2 * ks][1]),
          bf16x2_bits(x[2 * ks][2], x[2 * ks][3]),
          bf16x2_bits(x[2 * ks + 1][0], x[2 * ks + 1][1]),
          bf16x2_bits(x[2 * ks + 1][2], x[2 * ks + 1][3])};
#pragma unroll
      for (int nt = 0; nt < kMixNTiles; ++nt)
        mma_16x8x16(acc[nt], a, s_q[(ks * kMixNTiles + nt) * 32 + lane]);
    }
#pragma unroll
    for (int nt = 0; nt < kMixNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[nt][e] = g.a + acc[nt][e] * g.c;
  }
  const size_t tile = blockIdx.x / blocks_per_tile;
  if (row < kToyOutRows) {
    float* dst = g.out + (tile * kToyOutRows + row) * 128 + tig * 2;
#pragma unroll
    for (int nt = 0; nt < kMixNTiles; ++nt)
      *reinterpret_cast<float2*>(dst + nt * 8) = make_float2(x[nt][0],
                                                             x[nt][1]);
    return;
  }
  bool hit = false;
#pragma unroll
  for (int nt = 0; nt < kMixNTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hit |= __float_as_uint(x[nt][e]) == g.never;
  if (hit) g.out[0] = x[0][0];
}

template <int OP>
__global__ void __launch_bounds__(OP == kMm ? kToyMmThreads : kBlock)
op_toy_kernel(const ToyArgs g) {
  if constexpr (OP == kMm) {
    op_toy_mm(g);
  } else {
    // 16 consecutive elements of one tile row a thread
    const size_t e0 = ((size_t)blockIdx.x * kBlock + threadIdx.x) *
                      kToyChains;
    const uint32_t w = (uint32_t)(e0 % kToyTileElems);
    float x[kToyChains];
    uint32_t xi[kToyChains];
    __nv_bfloat16 bacc[kToyChains];
    // threadIdx-dependent starts (lane_zero is 0): a chain that depends on
    // kernel arguments alone is warp-uniform, and nvcc would run it once a
    // warp on the uniform datapath instead of once a thread
    const uint32_t lane_zero = threadIdx.x & g.zero;
    x[0] = __uint_as_float(add_u32(__float_as_uint(g.c), lane_zero));
    xi[0] = add_u32(g.xi0, lane_zero);
#pragma unroll
    for (int k = 1; k < kToyChains; ++k) {
      x[k] = x[k - 1] * g.one;
      xi[k] = add_u32(xi[k - 1], g.zero);
    }
#pragma unroll
    for (int k = 0; k < kToyChains; ++k) bacc[k] = __float2bfloat16_rn(0.0f);
    // a register of its own for each pass's addend (ci + p * zero): with one
    // ci, ptxas adds two passes' ci at once as x + 2ci (a LEA or an IMAD)
    uint32_t cp[kToyPasses];
    cp[0] = add_u32(g.ci, lane_zero);
#pragma unroll
    for (int p = 1; p < kToyPasses; ++p) cp[p] = add_u32(cp[p - 1], g.zero);
    const uint32_t step = g.ci * kGolden;
#pragma unroll
    for (int p = 0; p < kToyPasses; ++p)
#pragma unroll
      for (int k = 0; k < kToyChains; ++k) {
        if constexpr (OP == kMul) {
          x[k] = x[k] * g.c;
        } else if constexpr (OP == kFma) {
          x[k] = g.a + x[k] * g.c;
        } else if constexpr (OP == kIadd) {
          xi[k] = add_u32(xi[k], cp[p]);
        } else if constexpr (OP == kShf) {
          xi[k] = add_u32(xi[k] >> 1, cp[p]);
        } else if constexpr (OP == kCvt) {
          bacc[k] = __hadd(bacc[k], __int2bfloat16_rn((int)xi[k]));
          xi[k] = add_u32(xi[k], cp[p]);
        } else {
          xi[k] = finalize(xi[k] + step);
        }
      }
    float v[kToyChains];
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kToyChains; ++k) {
      if constexpr (OP == kMul || OP == kFma)
        v[k] = x[k];
      else if constexpr (OP == kCvt)
        v[k] = __bfloat162float(bacc[k]) + (float)(int32_t)xi[k];
      else if constexpr (OP == kHash)
        v[k] = (float)(xi[k] >> 8);
      else
        v[k] = (float)(int32_t)xi[k];
      hit |= __float_as_uint(v[k]) == g.never;
    }
    if (w < kToyOutRows * 128) {
      float4* dst = reinterpret_cast<float4*>(
          g.out + (e0 / kToyTileElems) * (kToyOutRows * 128) + w);
#pragma unroll
      for (int k = 0; k < kToyChains; k += 4)
        dst[k / 4] = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else if (hit) {
      g.out[0] = v[0];
    }
  }
}

template <int OP>
cudaError_t launch_toy(const ToyArgs& g, int n_tiles, cudaStream_t stream) {
  const int threads = OP == kMm ? kToyMmThreads : kBlock;
  const long long per_block = OP == kMm ? (long long)threads / 2 * 128
                                        : (long long)threads * kToyChains;
  const long long n_blocks = (long long)n_tiles * kToyTileElems / per_block;
  op_toy_kernel<OP><<<(unsigned)n_blocks, threads, 0, stream>>>(g);
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

// One op-class toy of n_tiles (4096, 128) tiles: op 0 mul, 1 fma, 2 iadd,
// 3 shf, 4 cvt, 5 mm (reads q, Q as bf16 bits), 6 hash; c and a as the
// TPU toy's fscal[0] and fscal[1]. out (n_tiles * 8, 128) float32: rows
// 0-7 of each tile.
extern "C" int smmc_op_toy(int op, float c, float a, const unsigned short* q,
                           int n_tiles, float* out, void* stream) {
  if (n_tiles < 1 || (op == kMm && q == nullptr)) return cudaErrorInvalidValue;
  const ToyArgs g{c, a, 1.0f, 3u, 1u, 0u, 0xFFFFFFFFu, q, out};
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kMul: return launch_toy<kMul>(g, n_tiles, s);
    case kFma: return launch_toy<kFma>(g, n_tiles, s);
    case kIadd: return launch_toy<kIadd>(g, n_tiles, s);
    case kShf: return launch_toy<kShf>(g, n_tiles, s);
    case kCvt: return launch_toy<kCvt>(g, n_tiles, s);
    case kMm: return launch_toy<kMm>(g, n_tiles, s);
    case kHash: return launch_toy<kHash>(g, n_tiles, s);
    default: return cudaErrorInvalidValue;
  }
}
