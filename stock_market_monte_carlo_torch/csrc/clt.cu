// CLT Gaussian kernel: plain, keep-fold and with-strategy (prefix).
//
// Replaces: stock_market_monte_carlo_tpu/ops/pallas_engine.py
//   _build_clt_kernel (:791), built by _build_clt_call (pl.pallas_call at
//   :1048) and run by _clt_chunk_stats. Plain version: ops/clt.py
//   clt_chunk_plain.
//
// What it computes: for each path and each block j of 128 months, the
// 16-bit counts of 128 words of the arithmetic counter stream (tile of
// p_tile paths, key j, position p_local*128 + c), rounded to bf16, times
// the orthogonal 128x128 matrix Q with float32 accumulation; growth
// arow[j,c] + zraw*cs[j,c]. Then per path:
// - plain / keep-fold: the product over blocks per column, and
//   V = v0 * exp(sum_c log prod_c);
// - prefix: per block, gk = g*keep, y = log(max(gk, 1e-37)), the
//   exclusive prefix excl_c = exp(sum_{d<c} y_d), the withdrawn
//   wsum += (v0*carry) * sum_c excl_c*g_c*(1-keep_c), carry *= excl*gk of
//   the last column; V = v0 * carry.
// Then the chunk's stats row and log histogram, as the month loop.
//
// What bounds it on an H100: per path and block, 128 hashes and count
// conversions (13 32-bit ops each) and a 128x128 product (32768 flop,
// bf16 in, float32 out). At 2^24 paths and three blocks the product is
// 1.65e12 flop: ~1.7 ms on the tensor cores at the data-sheet bf16 rate,
// ~25 ms on the float32 pipes. The scalar work (hashes, affine step, logs)
// is ~1.1e11 32-bit ops, ~3.2 ms at the SMs' issue rate, so with the
// product on the tensor cores the scalar work bounds it
// (chip_smoke.py::bound). No device-memory traffic beyond Q, the
// constants and the per-block rows.
//
// What the design does about it:
// - The product runs on the tensor cores, as mma.sync m16n8k16 (bf16 in,
//   f32 accumulate): each warp owns a 16-path strip and all 128 columns.
//   The fragment layouts of that instruction are fixed by the PTX ISA, so
//   each thread builds its A fragment (the counts of its two rows and
//   eight months per k-step) straight from the hash in registers: the
//   count tile never touches memory. Q is staged once per block in shared
//   memory, already in B-fragment order (32 KB, one 8-byte load per mma).
// - The accumulators come out in the same known layout (row, column), so
//   the affine growth and the running product over blocks stay in
//   registers. A path's row is finished by one thread through a padded
//   shared-memory tile: the 128 logs and the exp (plain), or per block
//   the prefix and the withdrawn total (prefix), column by column.
// - The wgmma / TMA / warp-specialised form is later work.
// - Built with -fmad=false: the affine step, the prefix and the moments
//   round as the plain version does; only the product's accumulation order
//   differs from it (tensor-core vs. torch.matmul), hence the relative bars.
//
// Probe instances (smmc_clt_probe, the plain variant only; smmc_clt never
// instantiates them, so its kernels do not move) port two experiments:
// - experiments/exp_clt_ablate.py:45 make_kernel (pl.pallas_call at :146):
//   ABLATE removes one part of the kernel. kNoHist: no histogram (the
//   caller's zeros stay); kNoLogExp: V = (v0 * sum_c prod_c) * 2^-7 in
//   place of v0 * exp(sum_c log prod_c); kNoDraw: one draw, key 0, feeds
//   all three blocks (packed to A fragments once before the block loop and
//   kept in 32 registers, so no block hashes, shifts or rounds, and every
//   block keeps the product, with no test in the k-steps); kNoMM: no product, zraw = float(count) * 2^-9, hashed at the
//   accumulator positions of a thread (rows gid and gid+8, columns
//   nt*8 + 2*tig + (e&1)) instead of its A-fragment positions. kBase
//   removes nothing: the production arithmetic in a probe instance.
// - experiments/exp_clt_ts2.py:41 kernel_ts2 (:112): tiles_per_block TS.
//   TS = 0 strides the blocks over 64-path groups as smmc_clt does; TS >= 1
//   gives block b the groups of stream tiles [b*TS, b*TS + TS) in order,
//   with one histogram flush and one partial row a block. Streams are per
//   tile, so finals, histogram, counts, min and max do not depend on TS;
//   the float64 power sums group the paths by block.
#include <cuda_bf16.h>

#include "smmc_common.cuh"

namespace {

using namespace smmc;

constexpr int kK = 128;                 // months per block = mixing dimension
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;      // paths per CUDA block
constexpr int kKSteps = kK / 16;        // k-steps of m16n8k16
constexpr int kNTiles = kK / 8;         // 8-column output tiles
constexpr int kStride = kK + 1;         // padded row of the shared tile
constexpr int kQFrags = kKSteps * kNTiles * 32;  // B fragments (uint2)

enum Variant { kPlain = 0, kKeepFold = 1, kPrefix = 2 };
// kNone: the production kernel (smmc_clt); the rest: probe instances
enum Ablate { kNone = 0, kBase = 1, kNoHist = 2, kNoLogExp = 3, kNoDraw = 4,
              kNoMM = 5 };

struct Args {
  const unsigned short* q;  // (128, 128) bf16 bits, [month in][column out]
  const float* arow;        // (nblocks, 128)
  const float* cs;          // (nblocks, 128)
  const float* keep;        // (nblocks, 128), prefix only
  int nblocks;
  uint32_t p_tile, seed_base, tile0;
  int valid;
  float v0, inv0, target, shift, log_lo, inv_w;
  int hb;
  float* finals;            // (valid,) or null
  double* partials;         // (gridDim.x, 8)
  int* hist;                // (hb,) or null
  int tiles_per_block;      // probe instances only: 0 strides, >= 1 groups
};

// bf16 bits of the 16-bit count of the word at `pos` of the draw keyed h
// (float conversion is exact below 2^24; bf16 rounds to nearest even)
__device__ __forceinline__ uint32_t count_bf16(uint32_t h, uint32_t pos) {
  const float c = (float)(arith_word(h, pos) >> 16);
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(c));
}

// Fragment layouts: smmc_common.cuh (mma_16x8x16).
template <int VARIANT, int ABLATE>
__global__ void __launch_bounds__(kThreads) clt_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* s_q = reinterpret_cast<uint2*>(smem);
  float* s_tile = reinterpret_cast<float*>(s_q + kQFrags);
  int* s_hist = reinterpret_cast<int*>(s_tile + kRows * kStride);
  const bool with_hist = g.hist != nullptr && ABLATE != kNoHist;

  if (ABLATE != kNoMM) stage_mix_frags(g.q, s_q);
  if (with_hist)
    for (int i = threadIdx.x; i < g.hb; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int r_lo = (threadIdx.x >> 5) * 16 + gid;  // rows r_lo and r_lo + 8
  const bool row_thread = threadIdx.x < kRows;     // finishes row threadIdx.x
  Stats st;
  const int n_groups = (g.valid + kRows - 1) / kRows;
  int grp_begin = blockIdx.x, grp_end = n_groups, grp_step = gridDim.x;
  if (ABLATE != kNone && g.tiles_per_block > 0) {
    const int span = g.tiles_per_block * (int)(g.p_tile / kRows);
    grp_begin = blockIdx.x * span;
    grp_end = min(n_groups, grp_begin + span);
    grp_step = 1;
  }
  uint32_t a_keep[kKSteps][4];  // kNoDraw: the one draw's A fragments
  for (int grp = grp_begin; grp < grp_end; grp += grp_step) {
    // kRows divides p_tile: the group lies inside one stream tile
    const uint32_t row0 = (uint32_t)grp * kRows;
    const uint32_t seed = tile_seed(g.seed_base, g.tile0 + row0 / g.p_tile);
    const uint32_t pos_lo = ((row0 + r_lo) % g.p_tile) * kK;
    const uint32_t pos_hi = pos_lo + 8u * kK;
    float prod[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) prod[nt][e] = 1.0f;
    float carry = 1.0f, wsum = 0.0f;
    if (ABLATE == kNoDraw) {
      // the one draw (key 0), packed once for all blocks
      const uint32_t h0 = tile_seed(seed, 0u);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t m = ks * 16 + tig * 2;
        a_keep[ks][0] = pack2(count_bf16(h0, pos_lo + m),
                              count_bf16(h0, pos_lo + m + 1));
        a_keep[ks][1] = pack2(count_bf16(h0, pos_hi + m),
                              count_bf16(h0, pos_hi + m + 1));
        a_keep[ks][2] = pack2(count_bf16(h0, pos_lo + m + 8),
                              count_bf16(h0, pos_lo + m + 9));
        a_keep[ks][3] = pack2(count_bf16(h0, pos_hi + m + 8),
                              count_bf16(h0, pos_hi + m + 9));
      }
    }

    for (int j = 0; j < g.nblocks; ++j) {
      const uint32_t h = tile_seed(seed, (uint32_t)j);
      float acc[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
      if (ABLATE == kNoMM) {
        // the counts at the accumulator positions, unmixed
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t pos = (e >> 1 ? pos_hi : pos_lo) + nt * 8 +
                                 tig * 2 + (e & 1);
            acc[nt][e] = (float)(arith_word(h, pos) >> 16) * F(0.001953125);
          }
      } else {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          const uint32_t m = ks * 16 + tig * 2;
          uint32_t a[4];
          if (ABLATE == kNoDraw) {
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = a_keep[ks][r];
          } else {
            a[0] = pack2(count_bf16(h, pos_lo + m),
                         count_bf16(h, pos_lo + m + 1));
            a[1] = pack2(count_bf16(h, pos_hi + m),
                         count_bf16(h, pos_hi + m + 1));
            a[2] = pack2(count_bf16(h, pos_lo + m + 8),
                         count_bf16(h, pos_lo + m + 9));
            a[3] = pack2(count_bf16(h, pos_hi + m + 8),
                         count_bf16(h, pos_hi + m + 9));
          }
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt)
            mma_16x8x16(acc[nt], a, s_q[(ks * kNTiles + nt) * 32 + lane]);
        }
      }
      const float* ar = g.arow + j * kK;
      const float* cr = g.cs + j * kK;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + tig * 2 + (e & 1);
          const float gr = __ldg(ar + col) + acc[nt][e] * __ldg(cr + col);
          if (VARIANT == kPrefix)
            s_tile[(r_lo + (e >> 1) * 8) * kStride + col] = gr;
          else
            prod[nt][e] = prod[nt][e] * gr;
        }
      if (VARIANT == kPrefix) {
        __syncthreads();
        if (row_thread) {
          const float* row = s_tile + threadIdx.x * kStride;
          const float* kr = g.keep + j * kK;
          float run = 0.0f, s = 0.0f, last = 0.0f;
          for (int c = 0; c < kK; ++c) {
            const float gr = row[c];
            const float k = __ldg(kr + c);
            const float gk = gr * k;
            const float excl = expf(run);
            s = s + excl * gr * (1.0f - k);
            if (c == kK - 1) last = excl * gk;
            run = run + logf(fmaxf(gk, F(1e-37)));
          }
          wsum = wsum + (g.v0 * carry) * s;
          carry = carry * last;
        }
        __syncthreads();
      }
    }

    float total = 0.0f;
    if (VARIANT == kPrefix) {
      total = g.v0 * carry;
    } else {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_tile[(r_lo + (e >> 1) * 8) * kStride + nt * 8 + tig * 2 +
                 (e & 1)] = prod[nt][e];
      __syncthreads();
      if (row_thread) {
        const float* row = s_tile + threadIdx.x * kStride;
        float s = 0.0f;
        if (ABLATE == kNoLogExp) {
          for (int c = 0; c < kK; ++c) s = s + row[c];
          total = (g.v0 * s) * F(0.0078125);
        } else {
          for (int c = 0; c < kK; ++c) s = s + logf(row[c]);
          total = g.v0 * expf(s);
        }
      }
    }
    const int p = (int)row0 + threadIdx.x;
    if (row_thread && p < g.valid) {
      if (g.finals) g.finals[p] = total;
      st.add(total, wsum, g.inv0, g.shift, g.target);
      if (with_hist)
        atomicAdd(&s_hist[bin_index(total, g.log_lo, g.inv_w, g.hb)], 1);
    }
    __syncthreads();  // the next group rewrites s_tile
  }
  st.store_block(g.partials + 8 * blockIdx.x);
  if (with_hist) {
    __syncthreads();
    flush_hist(s_hist, g.hist, g.hb);
  }
}

template <int VARIANT, int ABLATE = kNone>
cudaError_t launch(const Args& g, int n_blocks, cudaStream_t stream) {
  const size_t smem = kQFrags * sizeof(uint2) +
                      kRows * kStride * sizeof(float) +
                      (g.hist ? g.hb * sizeof(int) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      clt_kernel<VARIANT, ABLATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  clt_kernel<VARIANT, ABLATE><<<n_blocks, kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// One chunk. variant: 0 plain, 1 keep-fold (keep folded into arow/cs by
// the caller), 2 prefix (reads keep). p_tile: paths per stream tile, a
// multiple of 64. finals and hist may be null. Returns cudaGetLastError()
// after the launch.
extern "C" int smmc_clt(int variant, const unsigned short* q,
                        const float* arow, const float* cs, const float* keep,
                        int nblocks, int p_tile, unsigned int seed_base,
                        unsigned int tile0, int valid, float v0, float inv0,
                        float target, float shift, float log_lo, float inv_w,
                        int hb, float* finals, double* partials, int* hist,
                        int n_blocks, void* stream) {
  if (nblocks < 1 || p_tile < kRows || p_tile % kRows != 0)
    return cudaErrorInvalidValue;
  if (variant == kPrefix && keep == nullptr) return cudaErrorInvalidValue;
  const Args g{q, arow, cs, keep, nblocks, (uint32_t)p_tile, seed_base,
               tile0, valid, v0, inv0, target, shift, log_lo, inv_w, hb,
               finals, partials, hist, 0};
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kPlain: return launch<kPlain>(g, n_blocks, s);
    case kKeepFold: return launch<kKeepFold>(g, n_blocks, s);
    case kPrefix: return launch<kPrefix>(g, n_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// One chunk of a probe instance of the plain variant: ablate 1 base, 2
// nohist, 3 nologexp, 4 nodraw, 5 nomm; tiles_per_block 0 strides the
// n_blocks blocks over the 64-path groups, >= 1 gives each block that many
// stream tiles (n_blocks must cover ceil(valid / p_tile) / tiles_per_block
// blocks). Arguments otherwise as smmc_clt's.
extern "C" int smmc_clt_probe(int ablate, int tiles_per_block,
                              const unsigned short* q, const float* arow,
                              const float* cs, int nblocks, int p_tile,
                              unsigned int seed_base, unsigned int tile0,
                              int valid, float v0, float inv0, float target,
                              float shift, float log_lo, float inv_w, int hb,
                              float* finals, double* partials, int* hist,
                              int n_blocks, void* stream) {
  if (nblocks < 1 || p_tile < kRows || p_tile % kRows != 0 ||
      tiles_per_block < 0)
    return cudaErrorInvalidValue;
  if (tiles_per_block > 0) {
    const long long tiles = ((long long)valid + p_tile - 1) / p_tile;
    if ((long long)n_blocks * tiles_per_block < tiles)
      return cudaErrorInvalidValue;
  }
  const Args g{q, arow, cs, nullptr, nblocks, (uint32_t)p_tile, seed_base,
               tile0, valid, v0, inv0, target, shift, log_lo, inv_w, hb,
               finals, partials, hist, tiles_per_block};
  auto s = static_cast<cudaStream_t>(stream);
  switch (ablate) {
    case kBase: return launch<kPlain, kBase>(g, n_blocks, s);
    case kNoHist: return launch<kPlain, kNoHist>(g, n_blocks, s);
    case kNoLogExp: return launch<kPlain, kNoLogExp>(g, n_blocks, s);
    case kNoDraw: return launch<kPlain, kNoDraw>(g, n_blocks, s);
    case kNoMM: return launch<kPlain, kNoMM>(g, n_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}
