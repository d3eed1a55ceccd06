// Device routines shared by every kernel source in csrc/: the tile layout,
// the BM25 score, the binary search of a doc-sorted postings row and the
// shared-memory top-k of one tile by one warp.
//
// Every function here is inline or a template, so each .cu that includes
// this header gets its own copy (the library is built without relocatable
// device code).
//
// Selection order: score descending, then tile position ascending.  A
// position is a posting's index in its doc-sorted row (term kernels) or a
// doc id within a 1,024-doc tile (doc-space kernels), so position order is
// doc order: Lucene's tie-break, and the lowest-index order of
// jax.lax.top_k.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define TILE 1024     // postings or docs per tile
#define THREADS 256   // threads of vector_topk.cu's select block
#define WARPS (THREADS / 32)
#define MAX_K 128     // widest per-tile winner row

struct Best {
  float v;
  int p;
};

// tile position -> reported id: base + position (a row position for
// bm25_topk, a segment-local doc id for the doc-space kernels)
struct PosFrom {
  int base;
  __device__ __forceinline__ int operator()(int p) const { return base + p; }
};

// a beats b: higher score, or equal score at a lower position
__device__ __forceinline__ bool beats(float av, int ap, float bv, int bp) {
  return av > bv || (av == bv && ap < bp);
}

// idf * (tf * (k1 + 1)) / fma(k1, (1 - b) + (b * dl) / avgdl, tf): every
// step IEEE round-to-nearest, and the one fused multiply-add that XLA:CPU
// puts in the reference's bm25 (the library is built with -fmad=false, so
// nvcc adds no other).  strict: tf + k1 * x in two roundings, as XLA:CPU
// computes the reference's unfused bm25 over a one-document segment
// (repro_torch/kernels/term_topk.py::one_doc)
__device__ __forceinline__ float bm25_score(int tf_i, int dl_i, float idf,
                                            float avgdl, float k1, float b,
                                            bool strict = false) {
  const float tf = __int2float_rn(tf_i);
  const float dl = __int2float_rn(dl_i);
  const float x = __fadd_rn(__fsub_rn(1.0f, b), __fdiv_rn(__fmul_rn(b, dl), avgdl));
  const float denom = strict ? __fadd_rn(tf, __fmul_rn(k1, x)) : __fmaf_rn(k1, x, tf);
  const float num = __fmul_rn(idf, __fmul_rn(tf, __fadd_rn(k1, 1.0f)));
  return __fdiv_rn(num, denom);
}

// first i in [0, n) with docs[i] >= key, or n (docs ascending)
__device__ __forceinline__ int lower_bound(const int* __restrict__ docs, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (docs[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// best of lane l's entries l, l + 32, ... of a TILE-entry score row
__device__ __forceinline__ Best lane_best(const float* s, int lane) {
  Best r{-CUDART_INF_F, TILE};
  for (int i = lane; i < TILE; i += 32) {
    if (beats(s[i], i, r.v, r.p)) {
      r.v = s[i];
      r.p = i;
    }
  }
  return r;
}

// Top-k of the scored tile s[0..TILE) with n_valid finite entries, by one
// warp: the first min(k, n_valid) slots of out_v/out_id hold the winners
// (score descending, position ascending), the rest (-inf, -1); id_of maps
// a tile position to the reported id.  Lane l owns the
// entries l, l + 32, ...; only the winner's owner rescans, so the warp needs
// no barrier and the warps of a block can each select a row of their own.
template <typename IdOf>
__device__ void warp_topk(float* s, int n_valid, int k, float* out_v,
                          int* out_id, IdOf id_of) {
  const int lane = threadIdx.x & 31;
  const int rounds = n_valid < k ? n_valid : k;
  Best mine = lane_best(s, lane);
  for (int r = 0; r < rounds; ++r) {
    // butterfly: every lane ends with the winner
    Best w = mine;
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, w.v, off);
      const int op = __shfl_xor_sync(0xffffffffu, w.p, off);
      if (beats(ov, op, w.v, w.p)) {
        w.v = ov;
        w.p = op;
      }
    }
    if (lane == 0) {
      out_v[r] = w.v;
      out_id[r] = id_of(w.p);
    }
    if ((w.p & 31) == lane) {  // only the owner's candidate changes
      s[w.p] = -CUDART_INF_F;
      mine = lane_best(s, lane);
    }
  }
  for (int r = rounds + lane; r < k; r += 32) {
    out_v[r] = -CUDART_INF_F;
    out_id[r] = -1;
  }
}
