// BM25 scoring + per-tile top-k for the term query family, on Hopper (sm_90a).
//
//   term_topk  replaces repro/kernels/fused_exec.py::term_topk_tiles (the
//              Pallas kernel inside the fused term program, fused.py:137).
//              Reads each query row's postings straight from the
//              device-resident CSR through the (starts, lengths) row
//              coordinates it is given -- the row gather of
//              fused.py:129-136 is folded into the kernel -- gathers the
//              packed (doc_len << 1) | live word once per posting, and
//              writes each 1,024-posting tile's top-k.
//   bm25_topk  replaces repro/kernels/bm25_topk.py::bm25_topk_blocks (the
//              single-query kernel behind Searcher._search_term), over the
//              pre-gathered (P,) freqs / doc lengths / valid flags that
//              repro_torch.kernels.term_topk stages as kernels/ops.py:50-53
//              does, and writes each 1,024-posting tile's top-k.
//
// Bound on an H100 (3.35 TB/s HBM): bytes.  term_topk moves, per posting in
// a row, 4 B of doc id + 4 B of freq from the CSR and 4 B of the dl_live
// gather, plus the winners it writes (8 B per output slot, 4 B per tile
// count); bm25_topk reads 12 B per posting and writes 8 B per slot.  There
// are ~10 flops per posting, far below the card's compute roof.  Scores
// never leave registers or shared memory, and no (B, P) staging array
// exists in device memory.
//
// At one segment a launch each kernel is a few microseconds of dependent
// steps, far above that bound; their design shortens the chain
// (warp_select.cuh).  term_topk:
//   * one wave over the work that exists: 128-thread blocks, the grid at
//     most the blocks the card holds at once (the occupancy API,
//     kernels/term_topk.py::grid_blocks); the items are only the tiles
//     that hold postings, row by row, and block x takes items x, x + grid,
//     ... (locate_item, which loads the rows' lengths, starts and idfs in
//     one step; kernels/term_topk.py::work_items mirrors it); the slots
//     of tiles past a row's end get (-inf, -1) and count 0 from a strided
//     store loop all blocks share after their items, with no barrier;
//   * each thread owns 8 contiguous postings and starts all 8 dl_live
//     gathers before it scores any;
//   * the select is finish_tile's: a thread sorts its 8 keys, each warp
//     takes its top min(k, matches) with one __reduce_max_sync a round,
//     warp 0 merges the 4 lists: one block barrier a tile.
// bm25_topk: the same blocks, select and one wave (at most the blocks the
// card holds at once, kernels/term_topk.py::grid_blocks), block x taking
// tiles x, x + grid, ...; each thread owns 8 contiguous postings and starts
// its six 16-byte loads of freqs, dl and valid before it scores any, so a
// tile is one load step and one block barrier, not k block-wide argmax
// rounds of three barriers each.
//
// Parity with the JAX package (bit-exact float32 scores): see bm25_score in
// tile_topk.cuh; division is IEEE (-prec-div defaults to true; never
// --use_fast_math).
//
// This file also holds the library's shared queries (tile width, widest k,
// CUDA error strings) that every kernel's wrapper uses.

#include <climits>

#include "warp_select.cuh"

// tiles of a row of len postings that hold postings, at most n_tiles
__device__ __forceinline__ int row_tiles(int len, int n_tiles) {
  return min((len + TILE - 1) / TILE, n_tiles);
}

// An item of term_topk: a (row, tile) that holds postings, with the row's
// coordinates and the number of its postings in the tile.
struct Item {
  int row, tile, start, n;
  float idf;
};

// term_topk's flat items: the tiles that hold postings, row by row (item =
// the tiles of the rows before it + tile).  One warp scans the rows' tile
// counts 32 rows at a time, loading each row's start and idf beside its
// length; every lane returns the number of items and, when item is below
// it, sets it (it.row stays -1 otherwise).
__device__ __forceinline__ int locate_item(const int* __restrict__ starts,
                                           const int* __restrict__ lengths,
                                           const float* __restrict__ idfs, int n_rows,
                                           int n_tiles, int item, Item& it) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  it.row = -1;
  for (int r0 = 0; r0 < n_rows; r0 += 32) {
    const bool on = r0 + lane < n_rows;
    const int len = on ? lengths[r0 + lane] : 0;
    const int st = on ? starts[r0 + lane] : 0;
    const float idf = on ? idfs[r0 + lane] : 0.0f;
    const int t = row_tiles(len, n_tiles);
    int incl = t;  // inclusive prefix over the chunk's lanes
    #pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const unsigned past = __ballot_sync(0xffffffffu, item < carry + incl);
    const int l = past ? __ffs(past) - 1 : 0;
    const int before = __shfl_sync(0xffffffffu, incl - t, l);
    const int row_len = __shfl_sync(0xffffffffu, len, l);
    const int row_start = __shfl_sync(0xffffffffu, st, l);
    const float row_idf = __shfl_sync(0xffffffffu, idf, l);
    if (it.row < 0 && past) {
      it.row = r0 + l;
      it.tile = item - carry - before;
      it.start = row_start + it.tile * TILE;
      it.n = min(TILE, row_len - it.tile * TILE);
      it.idf = row_idf;
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  return carry;
}

// grid: at most the blocks the card holds at once, at most n_rows *
// n_tiles.  Block x takes the items x, x + gridDim.x, ...; every block
// shares the stores of the empty slots.
__global__ void __launch_bounds__(DT_THREADS) term_topk_kernel(
    const int* __restrict__ csr_docs, const int* __restrict__ csr_freqs,
    const int* __restrict__ dl_live, const int* __restrict__ starts,
    const int* __restrict__ lengths, const float* __restrict__ idfs,
    float avgdl, float k1, float b, int n_rows, int n_tiles, int k,
    float* __restrict__ out_vals, int* __restrict__ out_ids,
    int* __restrict__ out_cnt) {
  __shared__ int cand[TILE];
  __shared__ int wn[DT_WARPS];
  const int q0 = threadIdx.x * DT_DPT;
  Item it;
  const int n_items = locate_item(starts, lengths, idfs, n_rows, n_tiles, blockIdx.x, it);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    if (item != blockIdx.x) {
      locate_item(starts, lengths, idfs, n_rows, n_tiles, item, it);
      __syncthreads();  // the last item's merge has read cand
    }
    const int64_t first = (int64_t)it.start + q0;
    int d[DT_DPT], f[DT_DPT], g[DT_DPT];
    #pragma unroll
    for (int i = 0; i < DT_DPT; ++i) {
      const bool in = q0 + i < it.n;
      d[i] = in ? csr_docs[first + i] : 0;
      f[i] = in ? csr_freqs[first + i] : 0;
    }
    #pragma unroll
    for (int i = 0; i < DT_DPT; ++i) g[i] = dl_live[d[i]];  // all 8 in flight
    int key[DT_DPT];
    int c = 0;
    #pragma unroll
    for (int i = 0; i < DT_DPT; ++i) {
      const bool ok = f[i] > 0 && (g[i] & 1);
      key[i] = ok ? order_key(bm25_score(f[i], g[i] >> 1, it.idf, avgdl, k1, b)) : NO_KEY;
      c += ok;
    }
    finish_tile(key, c, k, [&](int i) { return d[i]; }, (int64_t)it.row * n_tiles + it.tile,
                out_vals, out_ids, out_cnt, cand, wn);
  }
  // the tiles past each row's end, nothing to read: after the items, so
  // their stores stay off an item's chain (the host keeps rows * n_tiles *
  // k below 2^30)
  const int n_out = n_rows * n_tiles * k;
  for (int e = blockIdx.x * DT_THREADS + threadIdx.x; e < n_out; e += gridDim.x * DT_THREADS) {
    const int slot = e / k;
    const int row = slot / n_tiles;
    if (slot - row * n_tiles >= row_tiles(lengths[row], n_tiles)) {
      out_vals[e] = -CUDART_INF_F;
      out_ids[e] = -1;
      if (e == slot * k) out_cnt[slot] = 0;
    }
  }
}

// grid: at most the blocks the card holds at once, at most n_tiles; block x
// takes tiles x, x + gridDim.x, ... of one pre-gathered postings row.
// freqs/dl/valid (n_tiles * TILE,), 16-byte aligned.
__global__ void __launch_bounds__(DT_THREADS) bm25_topk_kernel(
    const int* __restrict__ freqs, const int* __restrict__ dl,
    const int* __restrict__ valid, float idf, float avgdl, float k1, float b,
    int n_tiles, int k, float* __restrict__ out_vals, int* __restrict__ out_idx) {
  __shared__ int cand[TILE];
  __shared__ int wn[DT_WARPS];
  const int q0 = threadIdx.x * DT_DPT;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int first = tile * TILE + q0;  // the host keeps n_tiles * TILE in an int
    int f[DT_DPT], d[DT_DPT], v[DT_DPT];
    load4(freqs + first, f);  // all six loads in flight
    load4(dl + first, d);
    load4(valid + first, v);
    int key[DT_DPT];
    int c = 0;
    #pragma unroll
    for (int i = 0; i < DT_DPT; ++i) {
      const bool ok = v[i] > 0;
      key[i] = ok ? order_key(bm25_score(f[i], d[i], idf, avgdl, k1, b)) : NO_KEY;
      c += ok;
    }
    if (tile != blockIdx.x) __syncthreads();  // the last tile's merge has read cand
    finish_tile(key, c, k, PosFrom{first}, tile, out_vals, out_idx, nullptr, cand, wn);
  }
}

extern "C" {

// shared by every kernel's wrapper: the constants of tile_topk.cuh and the
// message of a CUDA error code a launch returned
int kernels_tile() { return TILE; }
int kernels_max_k() { return MAX_K; }
const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the block layout kernels/term_topk.py mirrors: DT_THREADS (which = 0),
// DT_DPT (1)
int term_topk_layout(int which) {
  const int layout[2] = {DT_THREADS, DT_DPT};
  return which >= 0 && which < 2 ? layout[which] : -1;
}

// blocks of term_topk (which = 0) or bm25_topk (1) that one SM holds at
// once (0 on error): the launch's grid is at most this times the SMs
int term_topk_blocks_per_sm(int which) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, term_topk_kernel, DT_THREADS, 0);
  else if (which == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bm25_topk_kernel, DT_THREADS, 0);
  return err == cudaSuccess ? blocks : 0;
}

// n_blocks: the grid (kernels/term_topk.py::grid_blocks), clipped to the
// n_rows * n_tiles slots
int term_topk(const int* csr_docs, const int* csr_freqs, const int* dl_live,
              const int* starts, const int* lengths, const float* idfs,
              float avgdl, float k1, float b, int n_rows, int n_tiles, int n_blocks,
              int k, float* out_vals, int* out_ids, int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  if (n_blocks <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  if ((int64_t)n_rows * n_tiles * k >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const int slots = n_rows * n_tiles;
  term_topk_kernel<<<n_blocks < slots ? n_blocks : slots, DT_THREADS, 0,
                     (cudaStream_t)stream>>>(
      csr_docs, csr_freqs, dl_live, starts, lengths, idfs, avgdl, k1, b, n_rows,
      n_tiles, k, out_vals, out_ids, out_cnt);
  return (int)cudaGetLastError();
}

// n_blocks: the grid (kernels/term_topk.py::grid_blocks), clipped to the
// n_tiles tiles
int bm25_topk(const int* freqs, const int* dl, const int* valid, float idf,
              float avgdl, float k1, float b, int n_tiles, int n_blocks, int k,
              float* out_vals, int* out_idx, void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_blocks <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  if ((int64_t)n_tiles * TILE > INT_MAX || (int64_t)n_tiles * k >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  bm25_topk_kernel<<<n_blocks < n_tiles ? n_blocks : n_tiles, DT_THREADS, 0,
                     (cudaStream_t)stream>>>(
      freqs, dl, valid, idf, avgdl, k1, b, n_tiles, k, out_vals, out_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
