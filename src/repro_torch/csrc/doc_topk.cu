// Doc-space query families on Hopper (sm_90a): boolean, sort, range and
// facet.  Each kernel runs one thread block per (query row, 1,024-doc tile
// of the segment's doc space) and writes that tile's winners (or histogram
// counts) and its match count; the cross-tile and cross-segment merge is
// one stable sort in PyTorch (repro_torch/core/query/exec.py).
//
// Postings are doc-sorted, so the postings of one CSR row that fall in a
// doc tile form one contiguous sub-range; the block finds it with two
// binary searches over the row given by (starts, lengths).  That folds the
// reference's XLA scatter prologues (fused.py:184-203, :222-230, :262-266)
// into the kernels, with no atomics on scores and no (B, ND_pad) buffer in
// device memory.
//
//   bool_topk   replaces repro/kernels/fused_exec.py::bool_topk_tiles.
//               Scores each term's sub-range into shared dense[]/count[],
//               term by term with a barrier between terms: docs are unique
//               within a term row, so no two threads touch one doc in a
//               term, and every doc's sum is added in term order from 0.0,
//               as XLA:CPU adds the reference's scatter.  Then AND
//               (count == T) or OR (count > 0), and live, and the tile's
//               top-k of the sums.
//   sort_topk   replaces fused_exec.py::sort_topk_tiles.  Marks the docs of
//               the term's sub-range with freq > 0 that are live; the key
//               is the doc value rounded to float32 (__int2float_rn, as
//               XLA's astype), -inf where unmatched; top-k descending.
//   range_topk  replaces fused_exec.py::range_topk_tiles.  lo <= dv <= hi
//               and live; the score is the constant 1.0, so the winners
//               are the k lowest matching doc ids, found with one block
//               prefix count instead of k argmax rounds (the reference
//               ranks a -doc float key, the same order below 2^24 docs).
//   facet_hist  replaces fused_exec.py::facet_hist_tiles.  Counts matched
//               live docs per bin (bins < 0 clip to 0, bins >= n_bins drop:
//               jnp.bincount's rule) in shared int counters, then adds them
//               to the row's int32 histogram in device memory with integer
//               atomics: exact and order-free.  Match-all facets run one
//               row whose matched set is the live bitmap.
//
// Bound on an H100 (3.35 TB/s HBM): bytes, as for the term kernels (a few
// float32 operations per posting or doc).  The least traffic the work needs
// is each posting once (4 B doc + 4 B freq, plus a 4 B doc-length gather in
// bool_topk), each shared doc-space column (dl_live or live, dv, bins) once
// per launch, the per-row coordinates, and the winners (8 B), counts (4 B)
// and histograms (4 B a bin) written.  The design reads each posting once;
// it reads the doc-space columns once per (row, tile) block, B times per
// launch, and relies on the 50 MB L2 to hold them (a 50,000-doc segment's
// column is 200 KB), so device memory sees them about once.  Scores and
// match flags stay in shared memory.  Bool and sort pay tile_topk's
// min(k, matches) argmax rounds per tile, which bound them by latency, not
// bytes, when a tile holds many matches.
//
// The binary searches cost log2(row length) dependent reads per term per
// block: 16-17 at the main path's 50,000-doc segments.

#include "tile_topk.cuh"

#define FACET_SHARED_BINS 8192  // above this, facet_hist counts in device memory

// Threads 0 and 1 write range[0..2): the positions in row docs[0..len) of
// the first doc >= base and the first doc >= base + TILE.  The caller
// synchronises before reading them.
__device__ __forceinline__ void tile_range(const int* __restrict__ docs,
                                           int len, int base, int* range) {
  if (threadIdx.x < 2) range[threadIdx.x] = lower_bound(docs, len, base + threadIdx.x * TILE);
}

// grid (n_tiles, B): doc tile x of query row y; starts/lengths/idfs (B, T)
__global__ void __launch_bounds__(THREADS) bool_topk_kernel(
    const int* __restrict__ csr_docs, const int* __restrict__ csr_freqs,
    const int* __restrict__ dl_live, const int* __restrict__ starts,
    const int* __restrict__ lengths, const float* __restrict__ idfs,
    float avgdl, float k1, float b, int n_terms, int conjunctive, int n_tiles,
    int k, float* __restrict__ out_vals, int* __restrict__ out_ids,
    int* __restrict__ out_cnt) {
  __shared__ float dense[TILE];
  __shared__ int count[TILE];
  __shared__ int range[2];
  const int row = blockIdx.y;
  const int base = blockIdx.x * TILE;
  const int64_t slot = (int64_t)row * n_tiles + blockIdx.x;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    dense[threadIdx.x + j * THREADS] = 0.0f;
    count[threadIdx.x + j * THREADS] = 0;
  }
  for (int t = 0; t < n_terms; ++t) {
    const int q = row * n_terms + t;
    const int* docs = csr_docs + starts[q];
    const int* freqs = csr_freqs + starts[q];
    tile_range(docs, lengths[q], base, range);
    // publishes range[] and orders the previous term's adds before these
    __syncthreads();
    const float idf = idfs[q];
    const int hi = range[1];
    for (int i = range[0] + threadIdx.x; i < hi; i += THREADS) {
      const int f = freqs[i];
      if (f > 0) {
        const int d = docs[i];
        const int j = d - base;
        dense[j] = __fadd_rn(dense[j], bm25_score(f, dl_live[d] >> 1, idf, avgdl, k1, b));
        count[j] += 1;
      }
    }
    __syncthreads();  // range[] is rewritten for the next term
  }
  int c = 0;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int n = count[i];
    const bool ok = (conjunctive ? n == n_terms : n > 0) && (dl_live[base + i] & 1);
    if (!ok) dense[i] = -CUDART_INF_F;
    c += ok;
  }
  const int n_valid = block_count(c);
  if (threadIdx.x == 0) out_cnt[slot] = n_valid;
  tile_topk(dense, n_valid, k, out_vals + slot * k, out_ids + slot * k, PosFrom{base});
}

// grid (n_tiles, B); starts/lengths (B,); dv/live (ND_pad,)
__global__ void __launch_bounds__(THREADS) sort_topk_kernel(
    const int* __restrict__ csr_docs, const int* __restrict__ csr_freqs,
    const int* __restrict__ live, const int* __restrict__ dv,
    const int* __restrict__ starts, const int* __restrict__ lengths,
    int n_tiles, int k, float* __restrict__ out_vals, int* __restrict__ out_ids,
    int* __restrict__ out_cnt) {
  __shared__ float key[TILE];
  __shared__ int matched[TILE];
  __shared__ int range[2];
  const int row = blockIdx.y;
  const int base = blockIdx.x * TILE;
  const int64_t slot = (int64_t)row * n_tiles + blockIdx.x;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) matched[threadIdx.x + j * THREADS] = 0;
  const int* docs = csr_docs + starts[row];
  const int* freqs = csr_freqs + starts[row];
  tile_range(docs, lengths[row], base, range);
  __syncthreads();
  const int hi = range[1];
  for (int i = range[0] + threadIdx.x; i < hi; i += THREADS) {
    const int d = docs[i];
    if (freqs[i] > 0 && live[d] > 0) matched[d - base] = 1;
  }
  __syncthreads();
  int c = 0;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int m = matched[i];
    key[i] = m ? __int2float_rn(dv[base + i]) : -CUDART_INF_F;
    c += m;
  }
  const int n_valid = block_count(c);
  if (threadIdx.x == 0) out_cnt[slot] = n_valid;
  tile_topk(key, n_valid, k, out_vals + slot * k, out_ids + slot * k, PosFrom{base});
}

// grid (n_tiles, B); los/his (B,); dv/live (ND_pad,).  Thread t owns the
// contiguous docs [PER_THREAD * t, PER_THREAD * (t + 1)) of its tile, so a
// prefix count over threads ranks the matches in doc order.
__global__ void __launch_bounds__(THREADS) range_topk_kernel(
    const int* __restrict__ dv, const int* __restrict__ live,
    const int* __restrict__ los, const int* __restrict__ his, int n_tiles,
    int k, float* __restrict__ out_vals, int* __restrict__ out_ids,
    int* __restrict__ out_cnt) {
  __shared__ int warp_n[WARPS];
  const int row = blockIdx.y;
  const int base = blockIdx.x * TILE;
  const int64_t slot = (int64_t)row * n_tiles + blockIdx.x;
  const int lo = los[row];
  const int hi = his[row];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = base + threadIdx.x * PER_THREAD;
  bool ok[PER_THREAD];
  int c = 0;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int v = dv[first + j];
    ok[j] = v >= lo && v <= hi && live[first + j] > 0;
    c += ok[j];
  }
  int incl = c;  // inclusive prefix count within the warp
  #pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_n[warp] = incl;
  __syncthreads();
  int rank = incl - c;
  int total = 0;
  #pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) rank += warp_n[w];
    total += warp_n[w];
  }
  float* ov = out_vals + slot * k;
  int* oi = out_ids + slot * k;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (ok[j]) {
      if (rank < k) {
        ov[rank] = 1.0f;
        oi[rank] = first + j;
      }
      ++rank;
    }
  }
  if (threadIdx.x == 0) out_cnt[slot] = total;
  for (int r = min(total, k) + threadIdx.x; r < k; r += THREADS) {  // no winner
    ov[r] = -CUDART_INF_F;
    oi[r] = -1;
  }
}

// grid (n_tiles, B); hist (B, n_bins) int32, zeroed by the caller.  With
// match_all the one row's matched set is the live bitmap and starts/lengths
// are not read.  Dynamic shared memory: n_bins ints when shared_bins.
__global__ void __launch_bounds__(THREADS) facet_hist_kernel(
    const int* __restrict__ csr_docs, const int* __restrict__ csr_freqs,
    const int* __restrict__ live, const int* __restrict__ bins,
    const int* __restrict__ starts, const int* __restrict__ lengths,
    int match_all, int n_bins, int shared_bins, int n_tiles,
    int* __restrict__ out_hist, int* __restrict__ out_cnt) {
  extern __shared__ int hist_s[];
  __shared__ int matched[TILE];
  __shared__ int range[2];
  const int row = blockIdx.y;
  const int base = blockIdx.x * TILE;
  const int64_t slot = (int64_t)row * n_tiles + blockIdx.x;
  int* row_hist = out_hist + (int64_t)row * n_bins;
  int* hist = shared_bins ? hist_s : row_hist;
  if (shared_bins) {
    for (int i = threadIdx.x; i < n_bins; i += THREADS) hist_s[i] = 0;
  }
  if (!match_all) {
    #pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) matched[threadIdx.x + j * THREADS] = 0;
    const int* docs = csr_docs + starts[row];
    const int* freqs = csr_freqs + starts[row];
    tile_range(docs, lengths[row], base, range);
    __syncthreads();
    const int hi = range[1];
    for (int i = range[0] + threadIdx.x; i < hi; i += THREADS) {
      if (freqs[i] > 0) matched[docs[i] - base] = 1;
    }
  }
  __syncthreads();
  int c = 0;
  #pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if ((match_all || matched[i]) && live[base + i] > 0) {
      ++c;
      const int bin = max(bins[base + i], 0);
      if (bin < n_bins) atomicAdd(&hist[bin], 1);
    }
  }
  const int n_matched = block_count(c);  // its barrier also ends the shared adds
  if (threadIdx.x == 0) out_cnt[slot] = n_matched;
  if (shared_bins) {
    for (int i = threadIdx.x; i < n_bins; i += THREADS) {
      const int v = hist_s[i];
      if (v) atomicAdd(&row_hist[i], v);
    }
  }
}

extern "C" {

int facet_shared_bins() { return FACET_SHARED_BINS; }

int bool_topk(const int* csr_docs, const int* csr_freqs, const int* dl_live,
              const int* starts, const int* lengths, const float* idfs,
              float avgdl, float k1, float b, int n_terms, int conjunctive,
              int n_rows, int n_tiles, int k, float* out_vals, int* out_ids,
              int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  dim3 grid(n_tiles, n_rows);
  bool_topk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      csr_docs, csr_freqs, dl_live, starts, lengths, idfs, avgdl, k1, b,
      n_terms, conjunctive, n_tiles, k, out_vals, out_ids, out_cnt);
  return (int)cudaGetLastError();
}

int sort_topk(const int* csr_docs, const int* csr_freqs, const int* live,
              const int* dv, const int* starts, const int* lengths, int n_rows,
              int n_tiles, int k, float* out_vals, int* out_ids, int* out_cnt,
              void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  dim3 grid(n_tiles, n_rows);
  sort_topk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      csr_docs, csr_freqs, live, dv, starts, lengths, n_tiles, k, out_vals,
      out_ids, out_cnt);
  return (int)cudaGetLastError();
}

int range_topk(const int* dv, const int* live, const int* los, const int* his,
               int n_rows, int n_tiles, int k, float* out_vals, int* out_ids,
               int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  dim3 grid(n_tiles, n_rows);
  range_topk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      dv, live, los, his, n_tiles, k, out_vals, out_ids, out_cnt);
  return (int)cudaGetLastError();
}

int facet_hist(const int* csr_docs, const int* csr_freqs, const int* live,
               const int* bins, const int* starts, const int* lengths,
               int match_all, int n_bins, int n_rows, int n_tiles,
               int* out_hist, int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0 || n_bins <= 0) return 0;
  const int shared_bins = n_bins <= FACET_SHARED_BINS;
  const size_t smem = shared_bins ? (size_t)n_bins * sizeof(int) : 0;
  dim3 grid(n_tiles, n_rows);
  facet_hist_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      csr_docs, csr_freqs, live, bins, starts, lengths, match_all, n_bins,
      shared_bins, n_tiles, out_hist, out_cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
