// Packed-bitmap boolean combine with popcount on Hopper (sm_90a).
//
//   bitset_combine  replaces repro/kernels/bitset.py::bitset_combine_blocks
//                   (_bitset_kernel) and the padding and sum around it in
//                   repro/kernels/ops.py::bitset_combine: the T-way AND or
//                   OR of (T, W) uint32 bitmaps, word by word, for any W,
//                   the number of set bits of each 1,024-word unit of the
//                   result (when asked for) and the total, in one launch.
//
// Bound on an H100: bytes (3.35 TB/s).  The work reads each input word once
// (4 B x T x W), writes each combined word once (4 B x W), the total and,
// for the blocks API, one int32 a unit; its few integer operations per word
// are far below the card's rate.  So the design keeps many loads in flight
// and launches once:
//
//   * A block of BITSET_THREADS threads takes one BITSET_BLOCK-word unit (the
//     reference's (8, 128) block) at a time: thread j reads words j, j + 256,
//     j + 512 and j + 768 of the unit in every row, so each warp load is 128
//     contiguous bytes whatever W is (no alignment asked: a row starts at
//     t x W words, and W is often odd).
//   * A thread issues the loads of BITSET_ROWS rows (4 words each) before it
//     combines any of them, so no row's load waits on the row before; rows
//     past T load nothing and give the identity.  Reads are non-caching
//     (__ldg): every word is read once.
//   * Words at or past W are predicated off: not read, not written, not
//     counted.  The output has exactly W words.
//   * The grid is one wave (the blocks the card holds at once, from the
//     occupancy API, at most one a unit): block x takes units x, x + grid, ...
//   * The total comes out of the same launch: each block adds its exact
//     integer count to one 64-bit scratch word together with a ticket
//     (count below bit TICKET_SHIFT, tickets above it), so the block that
//     draws the last ticket holds the whole sum and writes it, then leaves
//     the word zero for the next call.  Integer adds: the same total in any
//     order.  No memset launch, no float atomic.

#include <cuda_runtime.h>
#include <stdint.h>

#define BITSET_BLOCK 1024   // words of a unit (the reference's 8 x 128 block)
#define BITSET_THREADS 256  // threads of a block
#define BITSET_WPT (BITSET_BLOCK / BITSET_THREADS)  // words a thread reads of each row
#define BITSET_ROWS 4       // rows whose loads a thread issues together
// The scratch word: a block's set bits below bit 40, its ticket above.  A
// total reaches 2^40 only past 2^35 words a row (128 GiB), tickets 2^24
// only past 2^24 blocks; a grid is at most the blocks the card holds.
#define TICKET_SHIFT 40

// bits (T, W) row-major; out (W,); counts (ceil(W / BITSET_BLOCK),) or
// null; scratch one 64-bit word, zero on entry and on exit; total one
// int64, written by the launch's last block.
__global__ void __launch_bounds__(BITSET_THREADS) bitset_combine_kernel(
    const unsigned* __restrict__ bits, int n_terms, int64_t w, int conjunctive,
    unsigned* __restrict__ out, int* __restrict__ counts,
    unsigned long long* __restrict__ scratch, long long* __restrict__ total) {
  __shared__ int unit_c[2][BITSET_THREADS / 32];  // by the unit's parity
  __shared__ unsigned long long block_c[BITSET_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ident = conjunctive ? 0xffffffffu : 0u;
  const int64_t n_units = (w + BITSET_BLOCK - 1) / BITSET_BLOCK;
  unsigned long long mine = 0;  // this thread's set bits over its units
  int parity = 0;
  for (int64_t unit = blockIdx.x; unit < n_units; unit += gridDim.x, parity ^= 1) {
    const int64_t base = unit * BITSET_BLOCK + threadIdx.x;
    unsigned acc[BITSET_WPT];
    #pragma unroll
    for (int i = 0; i < BITSET_WPT; ++i) acc[i] = ident;
    for (int t0 = 0; t0 < n_terms; t0 += BITSET_ROWS) {
      unsigned x[BITSET_ROWS][BITSET_WPT];
      #pragma unroll
      for (int r = 0; r < BITSET_ROWS; ++r) {  // every load of the chunk, then the combine
        const unsigned* row = bits + (int64_t)(t0 + r) * w;
        #pragma unroll
        for (int i = 0; i < BITSET_WPT; ++i) {
          const int64_t j = base + i * BITSET_THREADS;
          x[r][i] = (t0 + r < n_terms && j < w) ? __ldg(row + j) : ident;
        }
      }
      #pragma unroll
      for (int r = 0; r < BITSET_ROWS; ++r) {
        #pragma unroll
        for (int i = 0; i < BITSET_WPT; ++i)
          acc[i] = conjunctive ? (acc[i] & x[r][i]) : (acc[i] | x[r][i]);
      }
    }
    int c = 0;
    #pragma unroll
    for (int i = 0; i < BITSET_WPT; ++i) {
      const int64_t j = base + i * BITSET_THREADS;
      if (j < w) {
        out[j] = acc[i];
        c += __popc(acc[i]);
      }
    }
    mine += c;
    if (counts != nullptr) {  // the unit's count (at most 32,768: exact in int32)
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0) unit_c[parity][warp] = c;
      __syncthreads();  // two buffers: the next unit's writes never meet these reads
      if (threadIdx.x == 0) {
        int s = 0;
        #pragma unroll
        for (int k = 0; k < BITSET_THREADS / 32; ++k) s += unit_c[parity][k];
        counts[unit] = s;
      }
    }
  }
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, off);
  if (lane == 0) block_c[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block = 0;
    #pragma unroll
    for (int k = 0; k < BITSET_THREADS / 32; ++k) block += block_c[k];
    // No fence before the ticket (K6's and K10's tickets order data they
    // keep apart): the count rides in the ticket's own atomic, and no block
    // reads another's words.  A fence here cost 0.25-0.32 us a call at 16
    // blocks on an H100 80GB HBM3 at 700 W.
    const unsigned long long old =
        atomicAdd(scratch, (1ull << TICKET_SHIFT) + block);
    if ((old >> TICKET_SHIFT) == gridDim.x - 1) {  // the last block: every count is in
      *total = (long long)((old & ((1ull << TICKET_SHIFT) - 1)) + block);
      *scratch = 0ull;
    }
  }
}

extern "C" {

// the block layout kernels/bitset.py mirrors: BITSET_BLOCK (which = 0),
// BITSET_THREADS (1), BITSET_ROWS (2)
int bitset_layout(int which) {
  const int layout[3] = {BITSET_BLOCK, BITSET_THREADS, BITSET_ROWS};
  return which >= 0 && which < 3 ? layout[which] : -1;
}

// blocks of bitset_combine one SM holds at once (0 on error): the launch's
// grid is at most this times the SMs
int bitset_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bitset_combine_kernel, BITSET_THREADS, 0) != cudaSuccess)
    return 0;
  return blocks;
}

int bitset_combine(const unsigned* bits, int n_terms, long long w, int conjunctive,
                   int grid, unsigned* out, int* counts, void* scratch,
                   long long* total, void* stream) {
  if (n_terms <= 0 || w <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  bitset_combine_kernel<<<grid, BITSET_THREADS, 0, (cudaStream_t)stream>>>(
      bits, n_terms, (int64_t)w, conjunctive, out, counts,
      (unsigned long long*)scratch, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
