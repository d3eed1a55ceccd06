// BM25 scoring + per-tile top-k for the term query family, on Hopper (sm_90a).
//
// Two entry points share one device routine (score a tile of postings into
// shared memory, count the valid ones, then pick the tile's top-k with
// tile_topk.cuh):
//
//   term_topk  replaces repro/kernels/fused_exec.py::term_topk_tiles (the
//              Pallas kernel inside the fused term program, fused.py:137).
//              Each block reads its own postings straight from the
//              device-resident CSR through the (starts, lengths) row
//              coordinates it is given -- the row gather of
//              fused.py:129-136 is folded into the kernel -- and gathers
//              the packed (doc_len << 1) | live word once per posting.
//   bm25_topk  replaces repro/kernels/bm25_topk.py::bm25_topk_blocks (the
//              single-query kernel behind Searcher._search_term), over the
//              pre-gathered (P,) freqs / doc lengths / valid flags that
//              repro_torch.kernels.term_topk stages as kernels/ops.py:50-53
//              does.
//
// Bound on an H100 (3.35 TB/s HBM): bytes.  term_topk moves, per posting in
// a row, 4 B of doc id + 4 B of freq from the CSR and 4 B of the dl_live
// gather, plus the winners it writes (8 B per output slot, 4 B per tile
// count); bm25_topk reads 12 B per posting and writes 8 B per slot.  There
// are ~10 flops per posting, far below the card's compute roof.  The design
// touches each input byte once: the row gather happens in the kernel (no
// (B, P) staging array in device memory), scores never leave shared memory,
// and a tile past its row's end writes its empty winners without reading
// anything.  The k rounds of block argmax run in shared memory and registers
// and stop early once the tile's valid postings are exhausted.
//
// Parity with the JAX package (bit-exact float32 scores): see bm25_score in
// tile_topk.cuh; division is IEEE (-prec-div defaults to true; never
// --use_fast_math).
//
// This file also holds the library's shared queries (tile width, widest k,
// CUDA error strings) that every kernel's wrapper uses.

#include "tile_topk.cuh"

// term_topk: tile position -> the posting's segment-local doc id
struct DocAt {
  const int* docs;
  __device__ __forceinline__ int operator()(int p) const { return docs[p]; }
};

// grid (n_tiles, B): tile x of query row y
__global__ void __launch_bounds__(THREADS) term_topk_kernel(
    const int* __restrict__ csr_docs, const int* __restrict__ csr_freqs,
    const int* __restrict__ dl_live, const int* __restrict__ starts,
    const int* __restrict__ lengths, const float* __restrict__ idfs,
    float avgdl, float k1, float b, int n_tiles, int k,
    float* __restrict__ out_vals, int* __restrict__ out_ids,
    int* __restrict__ out_cnt) {
  __shared__ float s[TILE];
  __shared__ int docs[TILE];
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
  const int64_t slot = (int64_t)row * n_tiles + tile;
  float* ov = out_vals + slot * k;
  int* oi = out_ids + slot * k;

  const int len = lengths[row];
  const int base = tile * TILE;
  if (base >= len) {  // past the row's end: nothing to read
    for (int r = threadIdx.x; r < k; r += THREADS) {
      ov[r] = -CUDART_INF_F;
      oi[r] = -1;
    }
    if (threadIdx.x == 0) out_cnt[slot] = 0;
    return;
  }
  const int n = min(TILE, len - base);
  const int64_t first = (int64_t)starts[row] + base;
  const float idf = idfs[row];
  int c = 0;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    float sc = -CUDART_INF_F;
    int d = 0;
    if (i < n) {
      d = csr_docs[first + i];
      const int f = csr_freqs[first + i];
      const int g = dl_live[d];
      if (f > 0 && (g & 1)) {
        sc = bm25_score(f, g >> 1, idf, avgdl, k1, b);
        ++c;
      }
    }
    s[i] = sc;
    docs[i] = d;
  }
  const int n_valid = block_count(c);  // its __syncthreads also publishes s/docs
  if (threadIdx.x == 0) out_cnt[slot] = n_valid;
  tile_topk(s, n_valid, k, ov, oi, DocAt{docs});
}

// grid (n_tiles,): tile x of one pre-gathered postings row
__global__ void __launch_bounds__(THREADS) bm25_topk_kernel(
    const int* __restrict__ freqs, const int* __restrict__ dl,
    const int* __restrict__ valid, float idf, float avgdl, float k1, float b,
    int k, float* __restrict__ out_vals, int* __restrict__ out_idx) {
  __shared__ float s[TILE];
  const int tile = blockIdx.x;
  const int64_t base = (int64_t)tile * TILE;
  int c = 0;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    float sc = -CUDART_INF_F;
    if (valid[base + i] > 0) {
      sc = bm25_score(freqs[base + i], dl[base + i], idf, avgdl, k1, b);
      ++c;
    }
    s[i] = sc;
  }
  const int n_valid = block_count(c);
  tile_topk(s, n_valid, k, out_vals + (int64_t)tile * k,
            out_idx + (int64_t)tile * k, PosFrom{(int)base});
}

extern "C" {

// shared by every kernel's wrapper: the constants of tile_topk.cuh and the
// message of a CUDA error code a launch returned
int kernels_tile() { return TILE; }
int kernels_max_k() { return MAX_K; }
const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int term_topk(const int* csr_docs, const int* csr_freqs, const int* dl_live,
              const int* starts, const int* lengths, const float* idfs,
              float avgdl, float k1, float b, int n_rows, int n_tiles, int k,
              float* out_vals, int* out_ids, int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  dim3 grid(n_tiles, n_rows);
  term_topk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      csr_docs, csr_freqs, dl_live, starts, lengths, idfs, avgdl, k1, b,
      n_tiles, k, out_vals, out_ids, out_cnt);
  return (int)cudaGetLastError();
}

int bm25_topk(const int* freqs, const int* dl, const int* valid, float idf,
              float avgdl, float k1, float b, int n_tiles, int k,
              float* out_vals, int* out_idx, void* stream) {
  if (n_tiles <= 0) return 0;
  bm25_topk_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      freqs, dl, valid, idf, avgdl, k1, b, k, out_vals, out_idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
