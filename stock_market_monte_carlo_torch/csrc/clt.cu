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
// (bench/roofline.py). No device-memory traffic beyond Q, the constants
// and the per-block rows.
//
// What the design does about it:
// - A block is one warpgroup (4 warps) over 64 paths; each warp owns a
//   16-path strip and all 128 columns.
// - The product runs on the tensor cores, in every variant and probe:
//   wgmma m64n128k16, bf16 in, float32 accumulate, 8 k-steps a block of
//   months for the warpgroup. A comes from registers: each thread
//   builds its fragments (the counts of its two rows, eight months a
//   k-step; the m16n8k16 A layout, which wgmma's shares for each warp's 16
//   rows) straight from the hash, so the count tile never touches memory;
//   k-step ks+1's are hashed and packed while ks runs (two register
//   buffers, wait_group 1). B is Q, staged once a block in shared memory in
//   wgmma's K-major layout without swizzle (32 KB), read through a matrix
//   descriptor. The prefix variant stages Q's columns permuted
//   (prefix_column), so that its finish runs along months in registers
//   (below); on mma.sync m16n8k16 the same finish was 35-55 % slower
//   (PERF.md).
// - The accumulators come out in a known (row, column) layout, so the
//   affine growth and the running product over blocks stay in registers.
//   Plain and keep-fold finish there too: each thread takes the logs of
//   its 64 values (32 columns of its two rows), sums each row's in its own
//   column order, two xor shuffles add the quad's four partial sums, and
//   lanes tig 0 and 1 of the quad finish the two rows (exp, statistics,
//   histogram): no shared-memory tile and no barrier. The prefix variant
//   finishes each block of months there too (prefix_block): in each part
//   of 32 months of a row a lane holds a run of 8 consecutive months,
//   sums their logs in order (its running prefix), the quad scans the four
//   lanes' sums with three shuffles, and every lane takes the exps of its
//   own prefixes and the withdrawn terms; two xor shuffles add the quad's
//   withdrawn sums, one shuffle brings month 127's factor to the carry.
//   No shared tile and no barrier in the block loop; 2 blocks a SM
//   (clt._PREFIX_BLOCKS_PER_SM). Its log is log_normal (smmc_common.cuh),
//   logf's steps without the branches the clamp at 1e-37 rules out: the
//   same bits as logf, ~6 instructions fewer a month.
// - Built with -fmad=false: the affine step, the prefix and the moments
//   round as the plain version does; the product's accumulation order and
//   the finish's sum and prefix order (clt.finish_sum_twin,
//   clt.prefix_finish_twin) differ from it, hence the relative bars.
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
constexpr int kQFrags = kKSteps * kNTiles * 32;  // B fragments (uint2)
static_assert(kK == kQDim, "the block of months is Q's dimension");

enum Variant { kPlain = 0, kKeepFold = 1, kPrefix = 2 };
// the prefix variant: months a lane runs through in order before its quad
// scans the lanes' sums (a part of 4 kRun months of a row; clt.PREFIX_RUN),
// and the accumulator tiles that hold one run
constexpr int kRun = 8;
constexpr int kRunTiles = kRun / 2;
constexpr int kParts = kK / (4 * kRun);
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

// The A fragments of k-step ks of the draw keyed h: the bf16 counts of
// rows pos_lo / pos_hi (positions of their first month), months ks*16 +
// 2 tig + {0, 1, 8, 9} (the m16n8k16 layout, which wgmma's A in registers
// shares for each warp's 16 rows)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], uint32_t h,
                                       uint32_t pos_lo, uint32_t pos_hi,
                                       int ks, int tig) {
  const uint32_t m = ks * 16 + tig * 2;
  a[0] = pack2(count_bf16(h, pos_lo + m), count_bf16(h, pos_lo + m + 1));
  a[1] = pack2(count_bf16(h, pos_hi + m), count_bf16(h, pos_hi + m + 1));
  a[2] = pack2(count_bf16(h, pos_lo + m + 8), count_bf16(h, pos_lo + m + 9));
  a[3] = pack2(count_bf16(h, pos_hi + m + 8), count_bf16(h, pos_hi + m + 9));
}

// The month that the prefix variant's accumulator column n holds: lane
// tig's columns nt*8 + 2 tig + e of part P = nt / kRunTiles hold months
// 4 kRun P + kRun tig + 2 (nt % kRunTiles) + e, so in each part a lane
// holds a run of kRun consecutive months of each of its rows.
__device__ __forceinline__ int prefix_column(int n) {
  const int nt = n >> 3;
  return 4 * kRun * (nt / kRunTiles) + kRun * ((n >> 1) & 3) +
         2 * (nt % kRunTiles) + (n & 1);
}

// Dynamic shared memory of one block: Q in the wgmma layout (32 KB) and
// the histogram.
size_t smem_bytes(const Args& g) {
  return kQFrags * sizeof(uint2) + (g.hist ? g.hb * sizeof(int) : 0);
}

// One block of months of the prefix variant, finished in the accumulators'
// layout. Q's columns are staged permuted (prefix_column): in part P of a
// row (months 4 kRun P ..), lane tig of a quad holds the run of months
// 4 kRun P + kRun tig + i, i = 0 .. kRun-1, of rows r_lo (acc[nt][0..1])
// and r_lo + 8 (acc[nt][2..3]). Per row and part: the lane's running sum
// of y = log(max(g*keep, 1e-37)) over its run, in order from 0; the quad's
// exclusive scan of the four lanes' sums r (0, r0, r0 + r1,
// r0 + (r1 + r2)) added to the row's prefix before the part; a month's
// exclusive prefix is that plus the lane's running sum before it; the
// part's total ((r0 + r1) + (r2 + r3)) then joins the row's prefix. Each
// lane adds its terms excl*g*(1-keep) in its column order; the quad adds its
// four sums as (s0 + s1) + (s2 + s3). Every lane keeps each row's carry
// and withdrawn sum (the same values). g*keep is finite (the mix's z is
// bounded) and the clamp keeps it at 1e-37 or more: log_normal's domain.
// CPU twin: clt.prefix_finish_twin.
__device__ __forceinline__ void prefix_block(float (&acc)[kNTiles][4],
                                             const float* ar, const float* cr,
                                             const float* kr, int tig,
                                             float v0, float (&carry)[2],
                                             float (&wsum)[2]) {
  constexpr unsigned kAll = 0xffffffffu;
  float pre[2] = {0.0f, 0.0f};  // each row's prefix before the part
  float s[2] = {0.0f, 0.0f};
  float last[2] = {0.0f, 0.0f};
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
    const int m0 = 4 * kRun * part + kRun * tig;
    float run[kRunTiles][4];  // the lane's sum of y before each month
    float r[2] = {0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < kRunTiles; ++q) {
      const int nt = part * kRunTiles + q;
      const float2 a = __ldg(reinterpret_cast<const float2*>(ar + m0 + 2 * q));
      const float2 c = __ldg(reinterpret_cast<const float2*>(cr + m0 + 2 * q));
      const float2 k = __ldg(reinterpret_cast<const float2*>(kr + m0 + 2 * q));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nt][e] = (e & 1 ? a.y : a.x) + acc[nt][e] * (e & 1 ? c.y : c.x);
        const float gk = acc[nt][e] * (e & 1 ? k.y : k.x);
        run[q][e] = r[e >> 1];
        r[e >> 1] = r[e >> 1] + log_normal(fmaxf(gk, F(1e-37)));
      }
    }
    float base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float u = __shfl_up_sync(kAll, r[h], 1, 4);
      const float s1 = tig >= 1 ? u + r[h] : r[h];
      u = __shfl_up_sync(kAll, s1, 2, 4);
      const float incl = tig >= 2 ? u + s1 : s1;
      u = __shfl_up_sync(kAll, incl, 1, 4);
      base[h] = pre[h] + (tig >= 1 ? u : 0.0f);
      pre[h] = pre[h] + __shfl_sync(kAll, incl, 3, 4);
    }
#pragma unroll
    for (int q = 0; q < kRunTiles; ++q) {
      const int nt = part * kRunTiles + q;
      const float2 k = __ldg(reinterpret_cast<const float2*>(kr + m0 + 2 * q));
      const float omk0 = 1.0f - k.x, omk1 = 1.0f - k.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(base[e >> 1] + run[q][e]);
        s[e >> 1] = s[e >> 1] + x * acc[nt][e] * (e & 1 ? omk1 : omk0);
        if (nt == kNTiles - 1 && (e & 1))  // month 127 at tig 3
          last[e >> 1] = x * (acc[nt][e] * k.y);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] = s[h] + __shfl_xor_sync(kAll, s[h], 1);
    s[h] = s[h] + __shfl_xor_sync(kAll, s[h], 2);
    last[h] = __shfl_sync(kAll, last[h], 3, 4);
    wsum[h] = wsum[h] + (v0 * carry[h]) * s[h];
    carry[h] = carry[h] * last[h];
  }
}

// Fragment layouts and the wgmma helpers: smmc_common.cuh.
template <int VARIANT, int ABLATE>
__global__ void __launch_bounds__(kThreads) clt_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned short* s_q = reinterpret_cast<unsigned short*>(smem);
  int* s_hist = reinterpret_cast<int*>(smem + kQFrags * sizeof(uint2));
  const bool with_hist = g.hist != nullptr && ABLATE != kNoHist;

  if (ABLATE != kNoMM) {
    stage_q(g.q, s_q, [](int n) {
      return VARIANT == kPrefix ? prefix_column(n) : n;
    });
    fence_async_shared();
  }
  if (with_hist)
    for (int i = threadIdx.x; i < g.hb; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int r_lo = (threadIdx.x >> 5) * 16 + gid;  // rows r_lo and r_lo + 8
  const uint64_t desc = q_descriptor(s_q);
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
  float acc[kNTiles][4];
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
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
    float wsum = 0.0f;
    float carry[2] = {1.0f, 1.0f}, wrow[2] = {0.0f, 0.0f};  // prefix rows
    if (ABLATE == kNoDraw) {
      // the one draw (key 0), packed once for all blocks
      const uint32_t h0 = tile_seed(seed, 0u);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        pack_a(a_keep[ks], h0, pos_lo, pos_hi, ks, tig);
    }

    for (int j = 0; j < g.nblocks; ++j) {
      const uint32_t h = tile_seed(seed, (uint32_t)j);
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
        // eight k-steps of the warpgroup's 64 x 128 product: k-step ks+1's
        // A is hashed and packed while ks runs (double-buffered registers)
        uint32_t a[2][4];
        if (ABLATE != kNoDraw) pack_a(a[0], h, pos_lo, pos_hi, 0, tig);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          wgmma_m64n128k16(acc, ABLATE == kNoDraw ? a_keep[ks] : a[ks & 1],
                           desc + 256u * ks, ks);
          wgmma_commit();
          if (ABLATE != kNoDraw && ks + 1 < kKSteps) {
            wgmma_wait<1>();  // k-step ks-1 has read a[(ks+1) & 1]
            pack_a(a[(ks + 1) & 1], h, pos_lo, pos_hi, ks + 1, tig);
            wgmma_fence();
          }
        }
        wgmma_wait<0>();
        fence_operands(acc);
      }
      const float* ar = g.arow + j * kK;
      const float* cr = g.cs + j * kK;
      if constexpr (VARIANT == kPrefix) {
        prefix_block(acc, ar, cr, g.keep + j * kK, tig, g.v0, carry, wrow);
      } else {
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + tig * 2 + (e & 1);
            const float gr = __ldg(ar + col) + acc[nt][e] * __ldg(cr + col);
            prod[nt][e] = prod[nt][e] * gr;
          }
      }
    }

    // the finish: lane tig < 2 of each quad finishes row r_lo + 8 tig: from
    // the row's carry and withdrawn sum (prefix), or from the sum over its
    // quad of each thread's columns of that row
    const int r = r_lo + 8 * tig;
    const bool row_thread = tig < 2;
    float total = 0.0f;
    if (VARIANT == kPrefix) {
      total = g.v0 * (tig == 0 ? carry[0] : carry[1]);
      wsum = tig == 0 ? wrow[0] : wrow[1];
    } else {
      // each row's own columns nt*8 + 2 tig + (e & 1) in order, then the
      // quad's four partial sums as (p0 + p1) + (p2 + p3)
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e >> 1] = s[e >> 1] + (ABLATE == kNoLogExp ? prod[nt][e]
                                                       : logf(prod[nt][e]));
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s[0] = s[0] + __shfl_xor_sync(0xffffffffu, s[0], o);
        s[1] = s[1] + __shfl_xor_sync(0xffffffffu, s[1], o);
      }
      const float sum = tig == 0 ? s[0] : s[1];
      total = ABLATE == kNoLogExp ? (g.v0 * sum) * F(0.0078125)
                                  : g.v0 * expf(sum);
    }
    const int p = (int)row0 + r;
    if (row_thread && p < g.valid) {
      if (g.finals) g.finals[p] = total;
      st.add(total, wsum, g.inv0, g.shift, g.target);
      if (with_hist)
        atomicAdd(&s_hist[bin_index(total, g.log_lo, g.inv_w, g.hb)], 1);
    }
  }
  st.store_block(g.partials + 8 * blockIdx.x);
  if (with_hist) {
    __syncthreads();
    flush_hist(s_hist, g.hist, g.hb);
  }
}

template <int VARIANT, int ABLATE = kNone>
cudaError_t launch(const Args& g, int n_blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
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
