// Dense-vector and hybrid scoring on Hopper (sm_90a).
//
//   vector_topk  replaces repro/kernels/vector_topk.py::vector_topk_tiles:
//                dot or cosine of every doc row of a segment's vector
//                column against each query vector, live mask, the tile's
//                top-k per query and its live count.
//   hybrid_topk  replaces repro/kernels/vector_topk.py::hybrid_topk_tiles
//                and the XLA scatter prologue that feeds it
//                (repro/core/query/fused.py:312-325): each row's term
//                postings among a block's docs (one CSR sub-range, found by
//                two binary searches) are scored with the one-FMA BM25 in
//                shared memory (0 for docs without the term; docs are
//                unique in a row, so no atomics and no dense BM25 in
//                device memory), then the similarity, the blend of
//                t = s/(s+1) and vnorm(c) with the one FMA XLA:CPU puts in
//                the reference's a*t + (1-a)*vnorm -- fma(a, t, (1-a) *
//                c/(1+|c|)) for dot, fma(1-a, (c+1)*0.5, a*t) for cosine --
//                the live mask and the top-k.
//
// What bounds it on an H100 (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores): at a 50,176-doc segment, 32 rows and 768 components the
// column is 154 MB (46 us) and the products 2.47 GFLOP (37 us) -- bytes by
// a little, so the column has to stream at full rate while the FMA pipe
// issues near its peak.  No tensor cores, no TF32: their products round
// differently from the chain.
//
// The score pass, a register-tiled product on the CUDA cores.  A block of
// 128 threads takes 128 docs and every row of a group of up to VROWS = 32
// (the column is read once from device memory per group); grid (row
// groups, ND_pad / 128), row groups fastest.  Thread (warp w, lane l)
// holds 8 rows (8w .. 8w+7) x 4 docs (l, l+32, l+64, l+96): 32 sequential
// __fmaf_rn chains in registers.
//   * The column and the query rows stream through a ring of VSTAGES
//     shared-memory stages of KC = 32 components (128 contiguous bytes of a
//     doc) by cp.async 16-byte copies, two stages ahead: one barrier per
//     stage, the copies of the next stages overlapping the FMAs.  Docs are
//     staged at a 36-float pitch, so the 16-byte reads of a quarter-warp
//     (8 docs) hit 32 distinct banks; query reads are broadcasts.
//   * Each (row, doc) score is one sequential __fmaf_rn chain over the
//     components j = 0 .. dim-1 from 0.0, 4 components at a time in order
//     (x, y, z, w) -- the order the plain version
//     (repro_torch/kernels/vector_topk.py::similarity) computes and, up to
//     32 components, the one XLA:CPU gives the reference.  Components past
//     dim are never copied or added.  Cosine norms are chains of the same
//     kind: vv of doc l + 32w by thread (w, l), qq of row 8w + l by lane
//     l < 8 of warp w; then __fsqrt_rn, __fmul_rn and __fdiv_rn, 0 where
//     den <= 0.  Every step is IEEE round-to-nearest: the library is built
//     with -fmad=false and the only fused multiply-adds are the explicit
//     ones.  At 5-8 components the callers that stand for the reference's
//     unfused route ask for strict norms (each square rounded, then
//     added): doc rows below strict_rows, and every query row under flag
//     bit 0 -- what XLA:CPU computes there (repro_torch/kernels/
//     vector_topk.py::strict_norm_rows).  Flag bit 1: strict BM25.  Flag
//     bit 2: the cosine blend in the dot form's operand order.
//   * Hybrid: two binary searches a row find its postings among the
//     block's docs while the first copies fly; after the component loop
//     the one-FMA BM25 of those postings goes into the freed ring (dense
//     BM25, 0 for docs without the term), then the blend.
//   * The per-tile live counts: the first block of each 1,024-doc tile
//     writes them for its rows.
//
// Scores mode (vector_score_rows, hybrid_score_rows) is the score pass
// alone: every (row, doc) score, -inf for dead and padded docs, into a
// (B, ND_pad) float32 tensor, for the callers that rank a whole row
// themselves (k above MAX_K, search_single).  Top-k mode (vector_topk,
// hybrid_topk) writes the scores to a scratch tensor and a second launch,
// tile_select_kernel, selects each (row, 1,024-doc tile)'s top-k with
// warp_topk (a warp a row).  Folding the selection into the score pass
// through clusters of the tile's 8 blocks (distributed shared memory) was
// measured slower: 8-block clusters must be co-scheduled on one GPC and the
// grid no longer ran in one wave (PERF.md, PR 15).
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has the table), at
// that shape: 0.096 ms in scores mode (50% of the bound; torch.mm 0.086
// ms), 0.110 ms in top-k mode (the select launch 0.013 ms of it); 3 blocks
// of 4 warps an SM (registers and shared memory).

#include "async_copy.cuh"
#include "tile_topk.cuh"

#define VROWS 32      // query rows per block: 4 warps x RT rows
#define VDOCS 128     // docs per block: lanes l, l + 32, l + 64, l + 96
#define VTHREADS 128
#define RT 8          // rows of a thread's register tile
#define DT 4          // docs of a thread's register tile
#define KC 32         // components per ring stage: 128 contiguous bytes of a doc
#define VPITCH 36     // floats per staged doc: 16-byte reads of 8 lanes hit 32 banks
#define VSTAGES 3     // ring depth: copies VSTAGES - 1 stages ahead
#define DIM_ALIGN 4   // components per 16-byte copy; D_pad % DIM_ALIGN == 0
#define VSTAGE (VDOCS * VPITCH + VROWS * KC)  // floats of one stage: docs, then queries

// dynamic shared memory, in floats: the ring (after the component loop,
// hybrid: sc[VROWS][VDOCS] dense BM25), vv[VDOCS] doc norms, qq[VROWS]
// query norms
#define SMEM_FLOATS (VSTAGES * VSTAGE + VDOCS + VROWS)

// one fused multiply-add chain step per (row, doc) of the register tile,
// components in order: x, y, z, w
__device__ __forceinline__ void fma4(float& acc, const float4 v, const float4 q) {
  acc = __fmaf_rn(v.x, q.x, acc);
  acc = __fmaf_rn(v.y, q.y, acc);
  acc = __fmaf_rn(v.z, q.z, acc);
  acc = __fmaf_rn(v.w, q.w, acc);
}

// one step of a norm chain: fma(x, x, acc), or strict: acc + round(x * x)
__device__ __forceinline__ float sq_step(float acc, float x, bool strict) {
  return strict ? __fadd_rn(acc, __fmul_rn(x, x)) : __fmaf_rn(x, x, acc);
}

__device__ __forceinline__ void sq4(float& acc, const float4 v, bool strict) {
  acc = sq_step(acc, v.x, strict);
  acc = sq_step(acc, v.y, strict);
  acc = sq_step(acc, v.z, strict);
  acc = sq_step(acc, v.w, strict);
}

template <bool HYBRID>
__global__ void __launch_bounds__(VTHREADS, 3) vector_score_kernel(
    const float* __restrict__ vmat, int d_pad, int dim,
    const float* __restrict__ qvecs, const int* __restrict__ doc_words,
    int cosine, int strict_rows, int flags, const int* __restrict__ csr_docs,
    const int* __restrict__ csr_freqs, const int* __restrict__ starts,
    const int* __restrict__ lengths, const float* __restrict__ idfs,
    const float* __restrict__ alphas, float avgdl, float k1, float b,
    int n_rows, int n_tiles, float* __restrict__ out_scores,
    int* __restrict__ out_cnt) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* vv_s = ring + VSTAGES * VSTAGE;
  float* qq_s = vv_s + VDOCS;
  float* sc = ring;  // HYBRID, after the component loop
  __shared__ int range[2 * VROWS];
  __shared__ int warp_c[VTHREADS / 32];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * VROWS;
  const int base = blockIdx.y * VDOCS;
  const int n_stages = (dim + KC - 1) / KC;

  // stage st: components [st * KC, st * KC + KC) of the block's docs and
  // rows, 16 bytes a copy; copies past dim are skipped (never read)
  auto issue = [&](int st) {
    if (st < n_stages) {
      float* vs = ring + (st % VSTAGES) * VSTAGE;
      float* qs = vs + VDOCS * VPITCH;
      const int j0 = st * KC;
      #pragma unroll
      for (int i = t; i < VDOCS * (KC / 4); i += VTHREADS) {
        const int doc = i / (KC / 4), c = (i % (KC / 4)) * 4;
        if (j0 + c < dim)
          cp_async16(vs + doc * VPITCH + c, vmat + (int64_t)(base + doc) * d_pad + j0 + c);
      }
      #pragma unroll
      for (int i = t; i < VROWS * (KC / 4); i += VTHREADS) {
        const int r = i / (KC / 4), c = (i % (KC / 4)) * 4;
        if (row0 + r < n_rows && j0 + c < dim)
          cp_async16(qs + r * KC + c, qvecs + (int64_t)(row0 + r) * d_pad + j0 + c);
      }
    }
    cp_async_commit();  // one group per stage index, empty past the end
  };
  #pragma unroll
  for (int st = 0; st < VSTAGES - 1; ++st) issue(st);

  if (HYBRID && t < 2 * VROWS) {  // each row's postings in the block's docs
    const int r = row0 + (t >> 1);
    range[t] = r < n_rows
        ? lower_bound(csr_docs + starts[r], lengths[r], base + (t & 1) * VDOCS)
        : 0;
  }  // published by the first barrier of the component loop

  // thread (warp, lane): rows warp * RT .. + RT - 1 of the group, docs
  // lane + 32 i of the block; each (row, doc) one sequential chain
  float acc[RT][DT];
  #pragma unroll
  for (int i = 0; i < DT; ++i) {
    #pragma unroll
    for (int r = 0; r < RT; ++r) acc[r][i] = 0.0f;
  }
  float vv = 0.0f;  // cosine: the norm chain of doc lane + 32 * warp
  float qq = 0.0f;  // lanes < RT: the norm chain of row warp * RT + lane
  const bool active = row0 + warp * RT < n_rows;  // warp-uniform
  const int qrow = warp * RT + (lane & (RT - 1));
  const int vdoc = (lane + 32 * warp) * VPITCH;
  const bool narrow = dim >= 5 && dim <= 8;  // strict norms apply only here
  const bool vstrict = narrow && base + lane + 32 * warp < strict_rows;
  const bool qstrict = narrow && (flags & 1);

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<VSTAGES - 2>();  // this thread's copies of stage st landed
    __syncthreads();  // everyone's landed; the buffer of stage st - 1 is free
    issue(st + VSTAGES - 1);
    const float* vs = ring + (st % VSTAGES) * VSTAGE;
    const float* qs = vs + VDOCS * VPITCH;
    const int n = dim - st * KC < KC ? dim - st * KC : KC;
    const int nq = n & ~3;
    if (cosine) {  // every warp, one doc a thread: the doc norms
      for (int jj = 0; jj < nq; jj += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + vdoc + jj);
        sq4(vv, v4, vstrict);
      }
      for (int jj = nq; jj < n; ++jj) vv = sq_step(vv, vs[vdoc + jj], vstrict);
    }
    if (!active) continue;
    #pragma unroll 4
    for (int jj = 0; jj < nq; jj += 4) {
      float4 v4[DT];
      #pragma unroll
      for (int i = 0; i < DT; ++i)
        v4[i] = *reinterpret_cast<const float4*>(vs + (lane + 32 * i) * VPITCH + jj);
      #pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + (warp * RT + r) * KC + jj);
        #pragma unroll
        for (int i = 0; i < DT; ++i) fma4(acc[r][i], v4[i], q4);
      }
      if (cosine && lane < RT) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + qrow * KC + jj);
        sq4(qq, q4, qstrict);
      }
    }
    for (int jj = nq; jj < n; ++jj) {  // the last 1-3 components of dim
      float v[DT];
      #pragma unroll
      for (int i = 0; i < DT; ++i) v[i] = vs[(lane + 32 * i) * VPITCH + jj];
      #pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float q = qs[(warp * RT + r) * KC + jj];
        #pragma unroll
        for (int i = 0; i < DT; ++i) acc[r][i] = __fmaf_rn(v[i], q, acc[r][i]);
      }
      if (cosine && lane < RT) {
        qq = sq_step(qq, qs[qrow * KC + jj], qstrict);
      }
    }
  }
  cp_async_wait<0>();
  if (cosine) {
    vv_s[lane + 32 * warp] = vv;
    if (active && lane < RT) qq_s[qrow] = qq;
  }
  __syncthreads();  // the ring is free

  if (HYBRID) {  // doc_words is dl_live: (doc_len << 1) | live
    for (int i = t; i < VROWS * VDOCS; i += VTHREADS) sc[i] = 0.0f;
    __syncthreads();
    // four threads a row, each every fourth of the row's postings here
    const int rr = t >> 2;
    if (row0 + rr < n_rows) {
      const int r = row0 + rr;
      const int* docs = csr_docs + starts[r];
      const int* freqs = csr_freqs + starts[r];
      const float idf = idfs[r];
      const int hi = range[2 * rr + 1];
      for (int i = range[2 * rr] + (t & 3); i < hi; i += 4) {
        const int f = freqs[i];
        if (f > 0) {
          const int d = docs[i];
          sc[rr * VDOCS + d - base] =
              bm25_score(f, doc_words[d] >> 1, idf, avgdl, k1, b, flags & 2);
        }
      }
    }
    __syncthreads();
  }

  // the live count of the 1,024-doc tile, by the tile's first block, for
  // every row of the group (live does not depend on the row)
  if ((base & (TILE - 1)) == 0) {
    int c = 0;
    for (int i = t; i < TILE; i += VTHREADS) {
      const int w = doc_words[base + i];
      c += HYBRID ? (w & 1) : (w > 0);
    }
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
    if (lane == 0) warp_c[warp] = c;
    __syncthreads();
    int total = 0;
    #pragma unroll
    for (int w = 0; w < VTHREADS / 32; ++w) total += warp_c[w];
    for (int r = t; r < VROWS && row0 + r < n_rows; r += VTHREADS)
      out_cnt[(int64_t)(row0 + r) * n_tiles + base / TILE] = total;
  }

  // similarity (cosine), blend (hybrid), live mask: the scores out
  if (!active) return;
  bool alive[DT];
  float vroot[DT];
  #pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int w = doc_words[base + lane + 32 * i];
    alive[i] = HYBRID ? (w & 1) : (w > 0);
    vroot[i] = __fsqrt_rn(vv_s[lane + 32 * i]);
  }
  const int64_t nd_pad = (int64_t)n_tiles * TILE;
  #pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + warp * RT + r;
    if (row >= n_rows) break;
    const float qroot = __fsqrt_rn(qq_s[warp * RT + r]);
    const float a = HYBRID ? alphas[row] : 0.0f;
    #pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int doc = lane + 32 * i;
      float sim = acc[r][i];
      if (cosine) {
        const float den = __fmul_rn(vroot[i], qroot);
        sim = den > 0.0f ? __fdiv_rn(sim, den) : 0.0f;
      }
      float s = sim;
      if (HYBRID) {
        const float s_in = sc[(warp * RT + r) * VDOCS + doc];
        const float tn = __fdiv_rn(s_in, __fadd_rn(s_in, 1.0f));
        const float om = __fsub_rn(1.0f, a);
        // flag bit 2: the cosine blend in the dot form's operand order (the
        // reference's jnp core over a one-document segment)
        s = !cosine ? __fmaf_rn(a, tn, __fmul_rn(om, __fdiv_rn(sim, __fadd_rn(1.0f, fabsf(sim)))))
            : (flags & 4) ? __fmaf_rn(a, tn, __fmul_rn(om, __fmul_rn(__fadd_rn(sim, 1.0f), 0.5f)))
            : __fmaf_rn(om, __fmul_rn(__fadd_rn(sim, 1.0f), 0.5f), __fmul_rn(a, tn));
      }
      out_scores[row * nd_pad + base + doc] = alive[i] ? s : -CUDART_INF_F;
    }
  }
}

// Top-k mode's second launch: warp w of block (x, tile) selects row
// x * WARPS + w's top-k of the 1,024-doc tile from the scores the score
// pass wrote (-inf for dead docs), with the tile's live count as n_valid.
__global__ void __launch_bounds__(THREADS) tile_select_kernel(
    const float* __restrict__ scores, const int* __restrict__ cnt, int n_rows,
    int n_tiles, int k, float* __restrict__ out_vals, int* __restrict__ out_ids) {
  __shared__ __align__(16) float s[WARPS][TILE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp, tile = blockIdx.y;
  if (row >= n_rows) return;  // no block barrier below
  const float4* src = reinterpret_cast<const float4*>(
      scores + ((int64_t)row * n_tiles + tile) * TILE);
  float4* dst = reinterpret_cast<float4*>(s[warp]);
  #pragma unroll
  for (int i = lane; i < TILE / 4; i += 32) dst[i] = src[i];
  __syncwarp();
  const int64_t slot = (int64_t)row * n_tiles + tile;
  warp_topk(s[warp], cnt[slot], k, out_vals + slot * k, out_ids + slot * k,
            PosFrom{tile * TILE});
}

template <bool HYBRID>
static int launch(const float* vmat, int d_pad, int dim, const float* qvecs,
                  const int* doc_words, int cosine, int strict_rows, int flags,
                  const int* csr_docs,
                  const int* csr_freqs, const int* starts, const int* lengths,
                  const float* idfs, const float* alphas, float avgdl,
                  float k1, float b, int n_rows, int n_tiles, int k,
                  float* scores, float* out_vals, int* out_ids, int* out_cnt,
                  void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vector_score_kernel<HYBRID>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  // row groups fastest: the blocks that read one doc range run together
  const dim3 grid((n_rows + VROWS - 1) / VROWS, n_tiles * (TILE / VDOCS));
  vector_score_kernel<HYBRID><<<grid, VTHREADS, smem, s>>>(
      vmat, d_pad, dim, qvecs, doc_words, cosine, strict_rows, flags, csr_docs,
      csr_freqs, starts,
      lengths, idfs, alphas, avgdl, k1, b, n_rows, n_tiles, scores, out_cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess || out_vals == nullptr) return (int)err;
  tile_select_kernel<<<dim3((n_rows + WARPS - 1) / WARPS, n_tiles), THREADS, 0, s>>>(
      scores, out_cnt, n_rows, n_tiles, k, out_vals, out_ids);
  return (int)cudaGetLastError();
}

extern "C" {

int vector_rows() { return VROWS; }
int vector_docs() { return VDOCS; }
int vector_dim_align() { return DIM_ALIGN; }

// top-k mode: scores (n_rows, n_tiles * TILE) float32 scratch that the
// score pass fills and the select launch reads
int vector_topk(const float* vmat, int d_pad, int dim, const float* qvecs,
                const int* live, int cosine, int strict_rows, int flags, int n_rows,
                int n_tiles, int k, float* scores, float* out_vals, int* out_ids,
                int* out_cnt, void* stream) {
  return launch<false>(vmat, d_pad, dim, qvecs, live, cosine, strict_rows, flags,
                       nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f, 0.0f,
                       n_rows, n_tiles, k, scores, out_vals, out_ids, out_cnt,
                       stream);
}

int hybrid_topk(const float* vmat, int d_pad, int dim, const float* qvecs,
                const int* dl_live, int cosine, int strict_rows, int flags,
                const int* csr_docs,
                const int* csr_freqs, const int* starts, const int* lengths,
                const float* idfs, const float* alphas, float avgdl, float k1,
                float b, int n_rows, int n_tiles, int k, float* scores,
                float* out_vals, int* out_ids, int* out_cnt, void* stream) {
  return launch<true>(vmat, d_pad, dim, qvecs, dl_live, cosine, strict_rows, flags,
                      csr_docs, csr_freqs, starts, lengths, idfs, alphas, avgdl,
                      k1, b, n_rows, n_tiles, k, scores, out_vals, out_ids,
                      out_cnt, stream);
}

// scores mode: out_scores (n_rows, n_tiles * TILE) float32, out_cnt as above
int vector_score_rows(const float* vmat, int d_pad, int dim, const float* qvecs,
                      const int* live, int cosine, int strict_rows, int flags,
                      int n_rows, int n_tiles, float* out_scores, int* out_cnt,
                      void* stream) {
  return launch<false>(vmat, d_pad, dim, qvecs, live, cosine, strict_rows, flags,
                       nullptr, nullptr,
                       nullptr, nullptr, nullptr, nullptr, 0.0f, 0.0f, 0.0f,
                       n_rows, n_tiles, 0, out_scores, nullptr, nullptr, out_cnt,
                       stream);
}

int hybrid_score_rows(const float* vmat, int d_pad, int dim, const float* qvecs,
                      const int* dl_live, int cosine, int strict_rows, int flags,
                      const int* csr_docs,
                      const int* csr_freqs, const int* starts, const int* lengths,
                      const float* idfs, const float* alphas, float avgdl,
                      float k1, float b, int n_rows, int n_tiles,
                      float* out_scores, int* out_cnt, void* stream) {
  return launch<true>(vmat, d_pad, dim, qvecs, dl_live, cosine, strict_rows, flags,
                      csr_docs, csr_freqs, starts, lengths, idfs, alphas, avgdl,
                      k1, b, n_rows, n_tiles, 0, out_scores, nullptr, nullptr,
                      out_cnt, stream);
}

}  // extern "C"
