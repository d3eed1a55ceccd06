// Dense-vector and hybrid scoring on Hopper (sm_90a).
//
//   vector_topk  replaces repro/kernels/vector_topk.py::vector_topk_tiles:
//                dot or cosine of every doc row of a segment's vector
//                column against each query vector, live mask, the tile's
//                top-k per query and its live count.
//   hybrid_topk  replaces repro/kernels/vector_topk.py::hybrid_topk_tiles
//                and the XLA scatter prologue that feeds it
//                (repro/core/query/fused.py:312-325): each row's term
//                postings in the tile (one CSR sub-range, found by two
//                binary searches) are scored with the one-FMA BM25 into
//                shared dense[] (0 for docs without the term; docs are
//                unique in a row, so no atomics and no (B, ND_pad) buffer
//                in device memory), then the similarity, the blend of
//                t = s/(s+1) and vnorm(c) with the one FMA XLA:CPU puts in
//                the reference's a*t + (1-a)*vnorm -- fma(a, t, (1-a) *
//                c/(1+|c|)) for dot, fma(1-a, (c+1)*0.5, a*t) for cosine --
//                the live mask and the top-k.
//
// One thread block of 256 threads owns a 1,024-doc tile and VROWS = 8
// query rows: grid (ceil(B / 8), n_tiles), row groups fastest, so the
// blocks that read one tile of the column run together and the re-reads
// hit L2.  Thread t accumulates docs 4t .. 4t+3 against the 8 rows (32
// accumulators in registers): the column is staged through shared memory
// KC = 16 components at a time (16-byte loads, transposed to
// component-major so the inner loop reads conflict-free), and each
// (row, doc) score is one sequential __fmaf_rn chain over the components
// j = 0 .. dim-1 from 0.0 -- the order the plain version
// (repro_torch/kernels/vector_topk.py::similarity) computes and, up to 32
// components, the one XLA:CPU gives the reference.  Cosine norms are chains
// of the same kind (vv per doc by its thread, qq per row by thread r), then
// __fsqrt_rn, __fmul_rn and __fdiv_rn, 0 where den <= 0.  Lanes past dim
// (the D_pad padding) are loaded but never added.  Every step is IEEE
// round-to-nearest: the library is built with -fmad=false and the only
// fused multiply-adds are the explicit ones.  Scores go to shared memory
// and each of the 8 warps selects one row's top-k (warp_topk, no block
// barriers).
//
// Scores mode (vector_score_rows, hybrid_score_rows): the same chains,
// norms, blend and live mask, but each thread stores its 4 docs' scores
// per row (-inf for dead and padded docs) straight into a (B, ND_pad)
// float32 tensor in place of the tile top-k, for the callers that rank a
// whole row themselves: k above MAX_K, in search_batch (the PyTorch
// selection path) and in search_single.  The per-tile live counts are
// written in both modes.
//
// Bound on an H100 (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor
// cores): at a 50,176-doc segment, 32 rows and 768 components the column
// is 154 MB (46 us) and the products 2.47 GFLOP (37 us): bytes by a little.
// This design reads the column once per row group (4 times at B = 32),
// from L2 after the first; its inner loop is 32 FMAs per three 16-byte
// shared loads.  On an H100 80GB HBM3 at 700 W it takes ~0.41 ms at that
// shape (chip_smoke.py), 11% of the bound: the staging is not overlapped
// with the FMAs (a barrier every 16 components, ~1.5 blocks per SM), the
// likely limit.  No tensor cores: their products round differently from
// the chain.

#include "tile_topk.cuh"

#define VROWS 8       // query rows per block; one warp selects each
#define KC 16         // components staged per step
#define DIM_ALIGN 4   // components per 16-byte load; D_pad % DIM_ALIGN == 0
#define DOCS (TILE / THREADS)  // docs per thread (4: one float4)

// dynamic shared memory, in floats: vs[KC][TILE] staged components,
// qs[KC][VROWS] staged query components, sc[VROWS][TILE] scores (the dense
// BM25 first, for hybrid_topk), qq[VROWS] query norms
#define SMEM_FLOATS (KC * TILE + KC * VROWS + VROWS * TILE + VROWS)

template <bool HYBRID>
__global__ void __launch_bounds__(THREADS) vector_kernel(
    const float* __restrict__ vmat, int d_pad, int dim,
    const float* __restrict__ qvecs, const int* __restrict__ doc_words,
    int cosine, const int* __restrict__ csr_docs,
    const int* __restrict__ csr_freqs, const int* __restrict__ starts,
    const int* __restrict__ lengths, const float* __restrict__ idfs,
    const float* __restrict__ alphas, float avgdl, float k1, float b,
    int n_rows, int n_tiles, int k, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int* __restrict__ out_cnt,
    float* __restrict__ out_scores) {
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;
  float* qs = vs + KC * TILE;
  float* sc = qs + KC * VROWS;
  float* qq_s = sc + VROWS * TILE;
  __shared__ int range[2 * VROWS];
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * VROWS;
  const int base = blockIdx.y * TILE;
  const int d0 = t * DOCS;  // this thread's docs in the tile

  if (HYBRID) {  // doc_words is dl_live: (doc_len << 1) | live
    for (int i = t; i < VROWS * TILE; i += THREADS) sc[i] = 0.0f;
    if (t < 2 * VROWS) {
      const int r = row0 + (t >> 1);
      range[t] = r < n_rows
          ? lower_bound(csr_docs + starts[r], lengths[r], base + (t & 1) * TILE)
          : 0;
    }
    __syncthreads();
    for (int rr = 0; rr < VROWS && row0 + rr < n_rows; ++rr) {
      const int r = row0 + rr;
      const int* docs = csr_docs + starts[r];
      const int* freqs = csr_freqs + starts[r];
      const float idf = idfs[r];
      const int hi = range[2 * rr + 1];
      for (int i = range[2 * rr] + t; i < hi; i += THREADS) {
        const int f = freqs[i];
        if (f > 0) {
          const int d = docs[i];
          sc[rr * TILE + d - base] = bm25_score(f, doc_words[d] >> 1, idf, avgdl, k1, b);
        }
      }
    }
    // published by the first barrier of the component loop
  }

  float acc[VROWS][DOCS];
  float vv[DOCS];
  #pragma unroll
  for (int i = 0; i < DOCS; ++i) {
    vv[i] = 0.0f;
    #pragma unroll
    for (int r = 0; r < VROWS; ++r) acc[r][i] = 0.0f;
  }
  float qq = 0.0f;  // threads r < VROWS: the norm chain of row row0 + r

  for (int j0 = 0; j0 < dim; j0 += KC) {
    for (int idx = t; idx < TILE * (KC / 4); idx += THREADS) {
      const int doc = idx % TILE;
      const int c = (idx / TILE) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j0 + c < d_pad) {
        x = *reinterpret_cast<const float4*>(vmat + (int64_t)(base + doc) * d_pad + j0 + c);
      }
      vs[(c + 0) * TILE + doc] = x.x;
      vs[(c + 1) * TILE + doc] = x.y;
      vs[(c + 2) * TILE + doc] = x.z;
      vs[(c + 3) * TILE + doc] = x.w;
    }
    if (t < KC * VROWS) {
      const int c = t / VROWS;
      const int r = row0 + t % VROWS;
      qs[t] = (r < n_rows && j0 + c < d_pad) ? qvecs[(int64_t)r * d_pad + j0 + c] : 0.0f;
    }
    __syncthreads();
    const int n = dim - j0 < KC ? dim - j0 : KC;
    #pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float4 v4 = *reinterpret_cast<const float4*>(vs + jj * TILE + d0);
      const float4 qa = *reinterpret_cast<const float4*>(qs + jj * VROWS);
      const float4 qb = *reinterpret_cast<const float4*>(qs + jj * VROWS + 4);
      const float v[DOCS] = {v4.x, v4.y, v4.z, v4.w};
      const float q[VROWS] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      #pragma unroll
      for (int r = 0; r < VROWS; ++r) {
        #pragma unroll
        for (int i = 0; i < DOCS; ++i) acc[r][i] = __fmaf_rn(v[i], q[r], acc[r][i]);
      }
      if (cosine) {
        #pragma unroll
        for (int i = 0; i < DOCS; ++i) vv[i] = __fmaf_rn(v[i], v[i], vv[i]);
        if (t < VROWS) {
          const float x = qs[jj * VROWS + t];
          qq = __fmaf_rn(x, x, qq);
        }
      }
    }
    __syncthreads();  // vs/qs are restaged next step
  }
  if (t < VROWS) qq_s[t] = qq;
  __syncthreads();

  // epilogue: similarity (cosine), blend (hybrid), live mask, into sc
  int c = 0;
  bool alive[DOCS];
  float vroot[DOCS];
  #pragma unroll
  for (int i = 0; i < DOCS; ++i) {
    const int w = doc_words[base + d0 + i];
    alive[i] = HYBRID ? (w & 1) : (w > 0);
    c += alive[i];
    vroot[i] = __fsqrt_rn(vv[i]);
  }
  #pragma unroll
  for (int r = 0; r < VROWS; ++r) {
    float4* out = reinterpret_cast<float4*>(sc + r * TILE + d0);
    const float4 dense = HYBRID ? *out : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float s_in[DOCS] = {dense.x, dense.y, dense.z, dense.w};
    const float qroot = __fsqrt_rn(qq_s[r]);
    const float a = HYBRID && row0 + r < n_rows ? alphas[row0 + r] : 0.0f;
    float s_out[DOCS];
    #pragma unroll
    for (int i = 0; i < DOCS; ++i) {
      float sim = acc[r][i];
      if (cosine) {
        const float den = __fmul_rn(vroot[i], qroot);
        sim = den > 0.0f ? __fdiv_rn(sim, den) : 0.0f;
      }
      float s = sim;
      if (HYBRID) {
        const float tn = __fdiv_rn(s_in[i], __fadd_rn(s_in[i], 1.0f));
        const float om = __fsub_rn(1.0f, a);
        s = cosine
            ? __fmaf_rn(om, __fmul_rn(__fadd_rn(sim, 1.0f), 0.5f), __fmul_rn(a, tn))
            : __fmaf_rn(a, tn, __fmul_rn(om, __fdiv_rn(sim, __fadd_rn(1.0f, fabsf(sim)))));
      }
      s_out[i] = alive[i] ? s : -CUDART_INF_F;
    }
    const float4 s4 = make_float4(s_out[0], s_out[1], s_out[2], s_out[3]);
    if (out_scores == nullptr) {
      *out = s4;
    } else if (row0 + r < n_rows) {  // scores mode: the row's scores out
      *reinterpret_cast<float4*>(
          out_scores + (int64_t)(row0 + r) * n_tiles * TILE + base + d0) = s4;
    }
  }
  const int n_valid = block_count(c);  // its barrier publishes sc

  const int warp = t >> 5;
  const int row = row0 + warp;
  if (row < n_rows) {
    const int64_t slot = (int64_t)row * n_tiles + blockIdx.y;
    if ((t & 31) == 0) out_cnt[slot] = n_valid;
    if (out_scores == nullptr) {
      warp_topk(sc + warp * TILE, n_valid, k, out_vals + slot * k,
                out_ids + slot * k, PosFrom{base});
    }
  }
}

template <bool HYBRID>
static int launch(const float* vmat, int d_pad, int dim, const float* qvecs,
                  const int* doc_words, int cosine, const int* csr_docs,
                  const int* csr_freqs, const int* starts, const int* lengths,
                  const float* idfs, const float* alphas, float avgdl,
                  float k1, float b, int n_rows, int n_tiles, int k,
                  float* out_vals, int* out_ids, int* out_cnt,
                  float* out_scores, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vector_kernel<HYBRID>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_rows + VROWS - 1) / VROWS, n_tiles);
  vector_kernel<HYBRID><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      vmat, d_pad, dim, qvecs, doc_words, cosine, csr_docs, csr_freqs, starts,
      lengths, idfs, alphas, avgdl, k1, b, n_rows, n_tiles, k, out_vals,
      out_ids, out_cnt, out_scores);
  return (int)cudaGetLastError();
}

extern "C" {

int vector_rows() { return VROWS; }
int vector_dim_align() { return DIM_ALIGN; }

int vector_topk(const float* vmat, int d_pad, int dim, const float* qvecs,
                const int* live, int cosine, int n_rows, int n_tiles, int k,
                float* out_vals, int* out_ids, int* out_cnt, void* stream) {
  return launch<false>(vmat, d_pad, dim, qvecs, live, cosine, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f, 0.0f,
                       n_rows, n_tiles, k, out_vals, out_ids, out_cnt,
                       nullptr, stream);
}

int hybrid_topk(const float* vmat, int d_pad, int dim, const float* qvecs,
                const int* dl_live, int cosine, const int* csr_docs,
                const int* csr_freqs, const int* starts, const int* lengths,
                const float* idfs, const float* alphas, float avgdl, float k1,
                float b, int n_rows, int n_tiles, int k, float* out_vals,
                int* out_ids, int* out_cnt, void* stream) {
  return launch<true>(vmat, d_pad, dim, qvecs, dl_live, cosine, csr_docs,
                      csr_freqs, starts, lengths, idfs, alphas, avgdl, k1, b,
                      n_rows, n_tiles, k, out_vals, out_ids, out_cnt,
                      nullptr, stream);
}

// scores mode: out_scores (n_rows, n_tiles * TILE) float32, out_cnt as above
int vector_score_rows(const float* vmat, int d_pad, int dim, const float* qvecs,
                      const int* live, int cosine, int n_rows, int n_tiles,
                      float* out_scores, int* out_cnt, void* stream) {
  return launch<false>(vmat, d_pad, dim, qvecs, live, cosine, nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f, 0.0f,
                       n_rows, n_tiles, 0, nullptr, nullptr, out_cnt,
                       out_scores, stream);
}

int hybrid_score_rows(const float* vmat, int d_pad, int dim, const float* qvecs,
                      const int* dl_live, int cosine, const int* csr_docs,
                      const int* csr_freqs, const int* starts, const int* lengths,
                      const float* idfs, const float* alphas, float avgdl,
                      float k1, float b, int n_rows, int n_tiles,
                      float* out_scores, int* out_cnt, void* stream) {
  return launch<true>(vmat, d_pad, dim, qvecs, dl_live, cosine, csr_docs,
                      csr_freqs, starts, lengths, idfs, alphas, avgdl, k1, b,
                      n_rows, n_tiles, 0, nullptr, nullptr, out_cnt,
                      out_scores, stream);
}

}  // extern "C"
