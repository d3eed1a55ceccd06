// The one-wave machinery of the redesigned tile kernels (term_topk.cu's
// term_topk and bm25_topk, doc_topk.cu's bool_topk, sort_topk, range_topk
// and facet_hist): 128-thread blocks that own 8 contiguous tile positions a
// thread, the many-way search of a doc-sorted postings row, 16-byte loads
// into registers, and the tile's top-k by warp selects merged by one warp.
//
// Every function here is inline or a template, so each .cu that includes
// this header gets its own copy (the library is built without relocatable
// device code).

#pragma once

#include "tile_topk.cuh"

#define DT_THREADS 128                  // threads of a one-wave block
#define DT_WARPS (DT_THREADS / 32)
#define DT_DPT (TILE / DT_THREADS)      // contiguous tile positions a thread owns
#define DT_WARP_DOCS (32 * DT_DPT)      // contiguous tile positions a warp owns
#define NO_KEY (-2147483647 - 1)        // below every order_key

static_assert(DT_DPT % 4 == 0, "a thread's positions are whole 16-byte loads");
static_assert(DT_WARPS <= 32, "warp 0 merges one list a lane");

// lanes of a search group: the largest power of two <= n, at most 32
constexpr int group_lanes(int n) {
  return n >= 32 ? 32 : n >= 16 ? 16 : n >= 8 ? 8 : n >= 4 ? 4 : n >= 2 ? 2 : 1;
}

// First i in [0, n) with docs[i] >= key, or n, found by a group of L lanes
// (aligned, L a power of two <= 32); docs ascend.  Each step the group
// probes L evenly spaced positions of [lo, hi) at once and keeps the gap
// that holds the answer, at most 1/(L+1) of the span: ceil(log_{L+1}(n + 1))
// dependent reads, 4 at 50,000 postings with 16 or 32 lanes.  Every lane of
// the warp calls it; the groups of a warp may search different rows and
// keys.  Every lane of a group returns the group's answer.  Mirrored by
// kernels/doc_topk.py::many_way_lower_bound.
template <int L>
__device__ __forceinline__ int group_lower_bound(const int* __restrict__ docs, int n,
                                                 int key) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (L - 1);
  const int first = lane & ~(L - 1);
  const unsigned group = L == 32 ? 0xffffffffu : ((1u << (L & 31)) - 1u);
  int lo = 0, hi = n;
  while (__any_sync(0xffffffffu, lo < hi)) {
    // probes lo + floor((j + 1) * span / (L + 1)) < hi, in 32 bits
    const int span = hi - lo;
    const int q = span / (L + 1);
    const int p = lo + q * (j + 1) + (span - q * (L + 1)) * (j + 1) / (L + 1);
    const bool less = span > 0 && docs[p] < key;
    // probes ascend, so the lanes below the answer form a prefix of the group
    const int c = __popc((__ballot_sync(0xffffffffu, less) >> first) & group);
    const int below = __shfl_sync(0xffffffffu, p, first + ((c - 1) & (L - 1)));
    const int at = __shfl_sync(0xffffffffu, p, first + (c & (L - 1)));
    if (span > 0) {
      if (c > 0) lo = below + 1;
      if (c < L) hi = at;
    }
  }
  return lo;
}

// N ints from p (16-byte aligned) into registers
template <int N>
__device__ __forceinline__ void load4(const int* p, int (&out)[N]) {
  #pragma unroll
  for (int i = 0; i < N; i += 4) {
    const int4 x = *reinterpret_cast<const int4*>(p + i);
    out[i] = x.x;
    out[i + 1] = x.y;
    out[i + 2] = x.z;
    out[i + 3] = x.w;
  }
}

// float -> int in the same order, so score descending becomes key
// descending.  A bijection: key_value gives the float back bit for bit.
// It ranks -0.0 below +0.0, which the plain versions call equal; no key
// here is -0.0 (BM25 scores and sums are +0.0 or above, __int2float_rn(0)
// is +0.0).
__device__ __forceinline__ int order_key(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// Warp w's sorted candidates of a tile: keys at cand + w * DT_WARP_DOCS,
// ids MAX_K ints further on.  cand holds DT_THREADS * DT_DPT ints.
static_assert(DT_WARP_DOCS >= 2 * MAX_K, "a warp's list fits its slice");

// the warp's highest key
__device__ __forceinline__ int warp_max(int key) {
  return __reduce_max_sync(0xffffffffu, key);
}

// The tile's winners from each thread's keys (order_key of its positions'
// scores, NO_KEY where a position does not match) and match count c.
// Thread t owns tile positions [DT_DPT t, DT_DPT (t + 1)), so lane order is
// position order; id_of(i) is the id reported for the thread's position
// DT_DPT t + i (i a compile-time index after unrolling, so it may read the
// caller's registers).  Each thread sorts its (key, id) pairs (a stable
// bubble network: key descending, position ascending); then each round a
// warp takes the highest head key with one warp_max, and the first lane
// that holds it holds the winner (Lucene's tie-break: the lower position,
// which in a doc-sorted row or a doc tile is the lower doc), which shifts
// its list.  Each warp selects the top min(k, its matches) of its slice that
// way, one barrier, then warp 0 merges the warps' sorted lists (lane w
// follows list w) the same way, one output a round.  Writes the slot's k
// winners (score descending, position ascending; (-inf, -1) past the
// matches) and, unless out_cnt is null, its count.  The caller separates two
// calls with a barrier.
template <typename IdOf>
__device__ __forceinline__ void finish_tile(int (&key)[DT_DPT], int c, int k, IdOf id_of,
                                            int64_t slot, float* __restrict__ out_vals,
                                            int* __restrict__ out_ids,
                                            int* __restrict__ out_cnt, int* cand,
                                            int* wn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int id[DT_DPT];
  #pragma unroll
  for (int i = 0; i < DT_DPT; ++i) id[i] = id_of(i);
  #pragma unroll
  for (int a = 0; a < DT_DPT - 1; ++a) {
    #pragma unroll
    for (int j = 0; j < DT_DPT - 1 - a; ++j) {
      if (key[j + 1] > key[j]) {
        const int tk = key[j], ti = id[j];
        key[j] = key[j + 1];
        id[j] = id[j + 1];
        key[j + 1] = tk;
        id[j + 1] = ti;
      }
    }
  }
  const int wc = __reduce_add_sync(0xffffffffu, c);
  const int wrounds = wc < k ? wc : k;
  for (int r = 0; r < wrounds; ++r) {
    const int top = warp_max(key[0]);
    if (lane == __ffs(__ballot_sync(0xffffffffu, key[0] == top)) - 1) {
      cand[warp * DT_WARP_DOCS + r] = key[0];
      cand[warp * DT_WARP_DOCS + MAX_K + r] = id[0];
      #pragma unroll
      for (int i = 0; i < DT_DPT - 1; ++i) {
        key[i] = key[i + 1];
        id[i] = id[i + 1];
      }
      key[DT_DPT - 1] = NO_KEY;
    }
  }
  if (lane == 0) wn[warp] = wc;
  __syncthreads();  // the warps' lists and counts
  int n_valid = 0;
  #pragma unroll
  for (int w = 0; w < DT_WARPS; ++w) n_valid += wn[w];
  const int rounds = n_valid < k ? n_valid : k;
  float* ov = out_vals + slot * k;
  int* oi = out_ids + slot * k;
  if (threadIdx.x == 0 && out_cnt != nullptr) out_cnt[slot] = n_valid;
  for (int r = rounds + threadIdx.x; r < k; r += DT_THREADS) {  // no winner
    ov[r] = -CUDART_INF_F;
    oi[r] = -1;
  }
  if (warp != 0) return;
  // list w holds positions below list w + 1's, so the first lane with the
  // top key again holds the winner; a lane keeps its list's next entry
  // in registers
  const int m = lane < DT_WARPS ? min(wn[lane], k) : 0;
  const int* ck = cand + lane * DT_WARP_DOCS;
  const int* ci = ck + MAX_K;
  int hk = m > 0 ? ck[0] : NO_KEY;
  int hi = m > 0 ? ci[0] : 0;
  int nk = m > 1 ? ck[1] : NO_KEY;
  int ni = m > 1 ? ci[1] : 0;
  for (int r = 0, h = 1; r < rounds; ++r) {
    const int top = warp_max(hk);
    if (lane == __ffs(__ballot_sync(0xffffffffu, hk == top)) - 1) {
      ov[r] = key_value(hk);
      oi[r] = hi;
      hk = nk;
      hi = ni;
      ++h;
      nk = h < m ? ck[h] : NO_KEY;
      ni = h < m ? ci[h] : 0;
    }
  }
}
