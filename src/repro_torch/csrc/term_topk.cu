// BM25 scoring + per-tile top-k for the term query family, on Hopper (sm_90a).
//
// Two entry points share one device routine (score a tile of postings into
// shared memory, count the valid ones, then pick the tile's top-k):
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
// Parity with the JAX package (bit-exact float32 scores): XLA:CPU evaluates
//   idf * (tf * (k1 + 1)) / (tf + k1 * ((1 - b) + (b * dl) / avgdl))
// with exactly one fused multiply-add, fma(k1, x, tf) in the denominator, and
// every other operation IEEE round-to-nearest.  This file is built with
// -fmad=false (no other contraction) and writes that one __fmaf_rn by hand;
// division is IEEE (-prec-div defaults to true; never --use_fast_math).
//
// Selection order: score descending, then position ascending.  Postings are
// doc-sorted within a row, so position order is doc order (Lucene's
// tie-break).  Outputs per tile are k slots: the first min(k, valid) hold the
// winners, the rest hold (-inf, -1).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define TILE 1024     // postings per thread block
#define THREADS 256   // TILE / THREADS entries per thread
#define PER_THREAD (TILE / THREADS)
#define WARPS (THREADS / 32)
#define MAX_K 128

struct Best {
  float v;
  int p;
};

// tile position -> reported id
struct DocAt {  // term_topk: the posting's segment-local doc id
  const int* docs;
  __device__ __forceinline__ int operator()(int p) const { return docs[p]; }
};
struct PosFrom {  // bm25_topk: the position in the (P,) row
  int base;
  __device__ __forceinline__ int operator()(int p) const { return base + p; }
};

// a beats b: higher score, or equal score at a lower position
__device__ __forceinline__ bool beats(float av, int ap, float bv, int bp) {
  return av > bv || (av == bv && ap < bp);
}

__device__ __forceinline__ float bm25_score(int tf_i, int dl_i, float idf,
                                            float avgdl, float k1, float b) {
  const float tf = __int2float_rn(tf_i);
  const float dl = __int2float_rn(dl_i);
  const float x = __fadd_rn(__fsub_rn(1.0f, b), __fdiv_rn(__fmul_rn(b, dl), avgdl));
  const float denom = __fmaf_rn(k1, x, tf);
  const float num = __fmul_rn(idf, __fmul_rn(tf, __fadd_rn(k1, 1.0f)));
  return __fdiv_rn(num, denom);
}

// best of this thread's entries (strided: i = t, t + THREADS, ...)
__device__ __forceinline__ Best local_best(const float* s, int t) {
  Best r{-CUDART_INF_F, TILE};
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = t + j * THREADS;
    if (beats(s[i], i, r.v, r.p)) {
      r.v = s[i];
      r.p = i;
    }
  }
  return r;
}

// Top-k of the scored tile s[0..TILE) with n_valid finite entries.  Writes
// out_v[0..k) / out_id[0..k); id_of maps a tile position to the reported id.
template <typename IdOf>
__device__ void tile_topk(float* s, int n_valid, int k, float* out_v,
                          int* out_id, IdOf id_of) {
  __shared__ float warp_v[WARPS];
  __shared__ int warp_p[WARPS];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int rounds = n_valid < k ? n_valid : k;

  Best mine = local_best(s, t);
  for (int r = 0; r < rounds; ++r) {
    Best w = mine;
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, w.v, off);
      const int op = __shfl_down_sync(0xffffffffu, w.p, off);
      if (beats(ov, op, w.v, w.p)) {
        w.v = ov;
        w.p = op;
      }
    }
    if (lane == 0) {
      warp_v[warp] = w.v;
      warp_p[warp] = w.p;
    }
    __syncthreads();
    if (warp == 0) {
      w.v = lane < WARPS ? warp_v[lane] : -CUDART_INF_F;
      w.p = lane < WARPS ? warp_p[lane] : TILE;
      #pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, w.v, off);
        const int op = __shfl_down_sync(0xffffffffu, w.p, off);
        if (beats(ov, op, w.v, w.p)) {
          w.v = ov;
          w.p = op;
        }
      }
      if (lane == 0) {
        out_v[r] = w.v;
        out_id[r] = id_of(w.p);
        warp_p[0] = w.p;  // broadcast the winner's position
      }
    }
    __syncthreads();
    const int won = warp_p[0];
    if ((won % THREADS) == t) {  // only the owner's candidate changes
      s[won] = -CUDART_INF_F;
      mine = local_best(s, t);
    }
    __syncthreads();  // warp_p[0] is rewritten next round
  }
  for (int r = rounds + t; r < k; r += THREADS) {
    out_v[r] = -CUDART_INF_F;
    out_id[r] = -1;
  }
}

__device__ __forceinline__ int block_count(int c) {
  __shared__ int warp_c[WARPS];
  #pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_c[threadIdx.x >> 5] = c;
  __syncthreads();
  int total = 0;
  #pragma unroll
  for (int w = 0; w < WARPS; ++w) total += warp_c[w];
  return total;
}

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

int term_topk_tile() { return TILE; }
int term_topk_max_k() { return MAX_K; }

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

const char* term_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
