// Packed-bitmap boolean combine with popcount on Hopper (sm_90a).
//
//   bitset_combine  replaces repro/kernels/bitset.py::bitset_combine_blocks
//                   (_bitset_kernel): the T-way AND or OR of (T, W) uint32
//                   bitmaps, word by word, and the number of set bits of
//                   each 1,024-word block of the result.
//
// One block of 1,024 threads per 1,024-word block, one thread per word:
// the thread reads its word of each of the T bitmaps (neighbouring threads,
// neighbouring words), writes the combined word, and counts its bits with
// __popc, the same function as the reference's five-step SWAR popcount.  A
// warp shuffle sum and one sum over the 32 warps give the block's count,
// exact in int32 (at most 32,768).
//
// Bound on an H100: bytes (3.35 TB/s).  The work reads each input word once
// (4 B x T x W), writes each combined word once (4 B x W) and one int32 per
// block; its few integer operations per word are far below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

#define BITSET_BLOCK 1024  // words per block (the reference's 8 x 128 block)

__global__ void __launch_bounds__(BITSET_BLOCK) bitset_kernel(
    const unsigned* __restrict__ bits, int n_terms, int64_t w, int conjunctive,
    unsigned* __restrict__ out, int* __restrict__ counts) {
  __shared__ int warp_c[BITSET_BLOCK / 32];
  const int64_t i = (int64_t)blockIdx.x * BITSET_BLOCK + threadIdx.x;
  unsigned acc = bits[i];
  for (int t = 1; t < n_terms; ++t) {
    const unsigned x = bits[t * w + i];
    acc = conjunctive ? (acc & x) : (acc | x);
  }
  out[i] = acc;
  int c = __popc(acc);
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_c[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    c = warp_c[threadIdx.x];
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if (threadIdx.x == 0) counts[blockIdx.x] = c;
  }
}

extern "C" {

int bitset_block() { return BITSET_BLOCK; }

int bitset_combine(const unsigned* bits, int n_terms, long long w,
                   int conjunctive, unsigned* out, int* counts, void* stream) {
  if (n_terms <= 0 || w <= 0) return 0;
  const long long n_blocks = w / BITSET_BLOCK;
  bitset_kernel<<<(unsigned)n_blocks, BITSET_BLOCK, 0, (cudaStream_t)stream>>>(
      bits, n_terms, (int64_t)w, conjunctive, out, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
