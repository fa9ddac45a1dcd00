// Byte planes of the counter stream.
//
// Replaces: experiments/exp_prng_bytes.py:19 kern (pl.pallas_call at :34)
// and experiments/exp_prng_crossword.py:26 kern (:41), one body: seed the
// generator with a raw seed, draw one (1024, 128) block of 32-bit words,
// and write its four bytes as float32 planes (4 * 1024, 128), plane b row r
// column c = (w >> 8b) & 0xFF. The TPU kernels draw the hardware PRNG; the
// port draws its counter stream from the same seed, as the probes' arith
// stub does: w = arith_word(tile_seed(seed, 0), r * 128 + c), key 0 of
// _TileRng(seed, "arith"). Plain version: ops/byte_planes.py
// byte_planes_plain.
//
// What bounds it on an H100: bytes. A seed writes 2 MiB of planes (0.63 us
// at 3.35 TB/s); the word's hash and four byte extractions are ~22 32-bit
// operations per 16 bytes written, far below the issue rate.
//
// What the design does about it: one thread a word, consecutive threads on
// consecutive words, so each of the four plane stores is coalesced; one
// grid row a seed.
#include "smmc_common.cuh"

namespace {

using namespace smmc;

constexpr int kWords = 1024 * 128;  // words of one draw

__global__ void __launch_bounds__(kBlock)
byte_planes_kernel(const uint32_t* __restrict__ seeds, int n_seeds,
                   float* __restrict__ out) {
  const int s = blockIdx.y;
  if (s >= n_seeds) return;
  const uint32_t pos = blockIdx.x * kBlock + threadIdx.x;
  const uint32_t w = arith_word(tile_seed(seeds[s], 0u), pos);
  float* o = out + (size_t)s * 4 * kWords + pos;
#pragma unroll
  for (int b = 0; b < 4; ++b) o[b * kWords] = (float)((w >> (8 * b)) & 0xFFu);
}

}  // namespace

// The byte planes of n_seeds draws: seeds (n_seeds,) uint32 on the card,
// out (n_seeds, 4 * 1024, 128) float32. Returns cudaGetLastError() after
// the launch.
extern "C" int smmc_byte_planes(const unsigned int* seeds, int n_seeds,
                                float* out, void* stream) {
  if (n_seeds < 1 || n_seeds > 65535) return cudaErrorInvalidValue;
  byte_planes_kernel<<<dim3(kWords / kBlock, n_seeds), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(seeds, n_seeds,
                                                            out);
  return cudaGetLastError();
}
