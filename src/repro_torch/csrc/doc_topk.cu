// Doc-space query families on Hopper (sm_90a): boolean, sort, range and
// facet.  Each kernel writes, per (query row, 1,024-doc tile of the
// segment's doc space), that tile's winners (or histogram counts) and its
// match count; the cross-tile and cross-segment merge is one stable sort in
// PyTorch (repro_torch/core/query/exec.py).
//
// Postings are doc-sorted, so the postings of one CSR row that fall in a
// doc tile form one contiguous sub-range, found by searching the row given
// by (starts, lengths).  That folds the reference's XLA scatter prologues
// (fused.py:184-203, :222-230, :262-266) into the kernels, with no atomics
// on scores and no (B, ND_pad) buffer in device memory.
//
//   bool_topk   replaces repro/kernels/fused_exec.py::bool_topk_tiles.
//               Scores each posting of the tile (the one-FMA BM25, the doc's
//               length from shared memory) into its term's shared row;
//               then the thread that owns a doc adds its terms' scores in
//               term order from 0.0, as XLA:CPU adds the reference's
//               scatter; no float atomics.  Then AND (every term hits) or
//               OR (some term hits), and live, and the tile's top-k of the
//               sums.
//   sort_topk   replaces fused_exec.py::sort_topk_tiles.  Marks the docs of
//               the term's sub-range with freq > 0; the owner of a marked
//               live doc keys it by its doc value rounded to float32
//               (__int2float_rn, as XLA's astype); top-k descending.
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
// is each posting once (4 B doc + 4 B freq), each shared doc-space column
// (dl_live or live, dv, bins) once per launch (bool_topk's doc lengths come
// from dl_live), the per-row coordinates, and the winners (8 B), counts
// (4 B) and histograms (4 B a bin) written.  The kernels read each posting once;
// they read the doc-space columns once per (row, tile), B times per
// launch, and rely on the 50 MB L2 to hold them (a 50,000-doc segment's
// column is 200 KB), so device memory sees them about once.  Scores and
// match flags stay in shared memory.
//
// At one segment a launch none of them comes near that bound: a (row,
// tile) is microseconds of dependent steps.  range_topk and facet_hist run
// one block per (row, tile) and find a term's sub-range with two binary
// searches (log2(row length) dependent reads).  bool_topk and sort_topk are
// built around those latency chains:
//   * one wave: 128-thread blocks, the grid at most the blocks the card
//     holds at once (the occupancy API, kernels/doc_topk.py::grid_blocks),
//     block x taking the flat work items x, x + grid, ... (item = row *
//     n_tiles + tile; kernels/doc_topk.py::work_schedule mirrors it);
//   * a many-way search: a group of lanes per (term, tile edge), all of a
//     pass's at once (sort_topk: a warp per edge; bool_topk: 16 lanes, 6
//     groups for a pass of 3 terms), each step probing evenly spaced
//     postings: at 50,000 postings 4 dependent reads a bound with 32 or 16
//     lanes, not 16 (group_lower_bound);
//   * a scatter with no dependent read of device memory: a thread loads
//     two postings at once, doc lengths come from shared memory, and a
//     doc's owner thread reads its live bit and doc value with 16-byte
//     loads;
//   * a select with no block-wide rounds: each thread sorts its 8 keys,
//     each warp takes the top min(k, its matches) of its 256 contiguous
//     docs with one __reduce_max_sync a round, and warp 0 merges the 4
//     sorted lists the same way.
// A (row, tile) takes 3 block barriers (bool with more than 3 terms: 2 more
// a pass of 3 terms).

#include "tile_topk.cuh"

#define FACET_SHARED_BINS 8192  // above this, facet_hist counts in device memory

// Threads 0 and 1 write range[0..2): the positions in row docs[0..len) of
// the first doc >= base and the first doc >= base + TILE.  The caller
// synchronises before reading them.
__device__ __forceinline__ void tile_range(const int* __restrict__ docs,
                                           int len, int base, int* range) {
  if (threadIdx.x < 2) range[threadIdx.x] = lower_bound(docs, len, base + threadIdx.x * TILE);
}

// ---------------------------------------------------------------------------
// bool_topk and sort_topk: flat work items, many-way search, warp selects
// ---------------------------------------------------------------------------

#define DT_THREADS 128                  // threads of a bool/sort block
#define DT_WARPS (DT_THREADS / 32)
#define DT_DPT (TILE / DT_THREADS)      // contiguous docs a thread owns
#define DT_WARP_DOCS (32 * DT_DPT)      // contiguous docs a warp owns
#define BOOL_PASS 3                     // bool terms scattered per pass
#define SORT_LANES 32                   // lanes of a sort_topk search group
#define SCATTER_BATCH 2                 // postings a thread loads at once
#define NO_KEY (-2147483647 - 1)        // below every order_key

static_assert(DT_DPT % 4 == 0, "a thread's docs are whole 16-byte loads");
static_assert(DT_WARPS <= 32, "warp 0 merges one list a lane");

// lanes of a search group: the largest power of two <= n, at most 32
constexpr int group_lanes(int n) {
  return n >= 32 ? 32 : n >= 16 ? 16 : n >= 8 ? 8 : n >= 4 ? 4 : n >= 2 ? 2 : 1;
}
// bool_topk searches a pass's two tile edges of each term at once
constexpr int BOOL_LANES = group_lanes(DT_THREADS / (2 * BOOL_PASS));

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
// here is -0.0 (sums start from +0.0, __int2float_rn(0) is +0.0).
__device__ __forceinline__ int order_key(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// Warp w's sorted candidates of a tile: keys at cand + w * DT_WARP_DOCS,
// positions MAX_K ints further on.  bool_topk keeps them in the warp's own
// slice of its score rows, which only that warp reads once it has summed.
static_assert(DT_WARP_DOCS >= 2 * MAX_K, "a warp's list fits its slice");

// the warp's highest key
__device__ __forceinline__ int warp_max(int key) {
  return __reduce_max_sync(0xffffffffu, key);
}

// The tile's winners from each thread's keys (order_key of its docs' scores,
// NO_KEY where a doc does not match) and match count c.  Thread t owns tile
// positions [DT_DPT t, DT_DPT (t + 1)), so lane order is position order.
// Each thread sorts its keys (a stable bubble network: key descending,
// position ascending); then each round a warp takes the highest head key
// with one warp_max, and the first lane that holds it holds the winner
// (Lucene's tie-break: the lower doc), which shifts its list.  Each warp
// selects the top min(k, its matches) of its slice that way, one barrier,
// then warp 0 merges the warps' sorted lists (lane w follows list w) the
// same way, one output a round.  Writes the slot's k winners (score
// descending, doc ascending; (-inf, -1) past the matches) and its count.
// The caller separates two calls with a barrier.
__device__ __forceinline__ void finish_tile(int (&key)[DT_DPT], int c, int k, int base,
                                            int64_t slot, float* __restrict__ out_vals,
                                            int* __restrict__ out_ids,
                                            int* __restrict__ out_cnt, int* cand,
                                            int* wn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int pos[DT_DPT];
  #pragma unroll
  for (int i = 0; i < DT_DPT; ++i) pos[i] = threadIdx.x * DT_DPT + i;
  #pragma unroll
  for (int a = 0; a < DT_DPT - 1; ++a) {
    #pragma unroll
    for (int j = 0; j < DT_DPT - 1 - a; ++j) {
      if (key[j + 1] > key[j]) {
        const int tk = key[j], tp = pos[j];
        key[j] = key[j + 1];
        pos[j] = pos[j + 1];
        key[j + 1] = tk;
        pos[j + 1] = tp;
      }
    }
  }
  const int wc = __reduce_add_sync(0xffffffffu, c);
  const int wrounds = wc < k ? wc : k;
  for (int r = 0; r < wrounds; ++r) {
    const int top = warp_max(key[0]);
    if (lane == __ffs(__ballot_sync(0xffffffffu, key[0] == top)) - 1) {
      cand[warp * DT_WARP_DOCS + r] = key[0];
      cand[warp * DT_WARP_DOCS + MAX_K + r] = pos[0];
      #pragma unroll
      for (int i = 0; i < DT_DPT - 1; ++i) {
        key[i] = key[i + 1];
        pos[i] = pos[i + 1];
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
  if (threadIdx.x == 0) out_cnt[slot] = n_valid;
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
  const int* cp = ck + MAX_K;
  int hk = m > 0 ? ck[0] : NO_KEY;
  int hp = m > 0 ? cp[0] : 0;
  int nk = m > 1 ? ck[1] : NO_KEY;
  int np = m > 1 ? cp[1] : 0;
  for (int r = 0, h = 1; r < rounds; ++r) {
    const int top = warp_max(hk);
    if (lane == __ffs(__ballot_sync(0xffffffffu, hk == top)) - 1) {
      ov[r] = key_value(hk);
      oi[r] = base + hp;
      hk = nk;
      hp = np;
      ++h;
      nk = h < m ? ck[h] : NO_KEY;
      np = h < m ? cp[h] : 0;
    }
  }
}

// grid: at most the blocks the card holds at once; block x takes the work
// items x, x + gridDim.x, ... (item = row * n_tiles + tile).  starts/
// lengths/idfs (B, T); dl_live (ND_pad,), 16-byte aligned.
__global__ void __launch_bounds__(DT_THREADS) bool_topk_kernel(
    const int* __restrict__ csr_docs, const int* __restrict__ csr_freqs,
    const int* __restrict__ dl_live, const int* __restrict__ starts,
    const int* __restrict__ lengths, const float* __restrict__ idfs,
    float avgdl, float k1, float b, int n_terms, int conjunctive, int n_tiles,
    int n_items, int k, float* __restrict__ out_vals, int* __restrict__ out_ids,
    int* __restrict__ out_cnt) {
  // a pass's BM25 bits where hit[][] is set; after the sums, row 0 holds
  // each warp's candidate list in the warp's own slice
  __shared__ __align__(16) int score[BOOL_PASS][TILE];
  __shared__ __align__(16) unsigned char hit[BOOL_PASS][TILE];
  __shared__ __align__(16) int dl_s[TILE];  // the tile's dl_live
  __shared__ int wn[DT_WARPS];
  __shared__ int lo_s[BOOL_PASS], hi_s[BOOL_PASS], st_s[BOOL_PASS];
  __shared__ float idf_s[BOOL_PASS];
  const int q0 = threadIdx.x * DT_DPT;
  const int search = threadIdx.x / BOOL_LANES;  // (term of the pass, tile edge)
  #pragma unroll
  for (int t = 0; t < BOOL_PASS; ++t) {
    #pragma unroll
    for (int i = 0; i < DT_DPT; i += 4) *reinterpret_cast<int*>(&hit[t][q0 + i]) = 0;
  }
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row = item / n_tiles;
    const int base = (item - row * n_tiles) * TILE;
    #pragma unroll
    for (int i = 0; i < DT_DPT; i += 4)
      *reinterpret_cast<int4*>(&dl_s[q0 + i]) = *reinterpret_cast<const int4*>(dl_live + base + q0 + i);
    float sum[DT_DPT];
    #pragma unroll
    for (int i = 0; i < DT_DPT; ++i) sum[i] = 0.0f;
    unsigned seen = 0u, missed = 0u;  // bit i: some term hit / missed doc q0 + i
    bool dead = false;  // AND, and a term has no posting in the tile
    // one pass even with no terms: its barrier orders the last merge
    for (int t0 = 0; t0 == 0 || t0 < n_terms; t0 += BOOL_PASS) {
      const int nc = min(BOOL_PASS, n_terms - t0);
      {
        const int t = search >> 1;
        const bool on = t < nc;
        const int q = row * n_terms + t0 + t;
        const int st = on ? starts[q] : 0;
        const int r = group_lower_bound<BOOL_LANES>(csr_docs + st, on ? lengths[q] : 0,
                                                    base + (search & 1) * TILE);
        if (on && (threadIdx.x & (BOOL_LANES - 1)) == 0) {
          if (search & 1) {
            hi_s[t] = r;
          } else {
            lo_s[t] = r;
            st_s[t] = st;
            idf_s[t] = idfs[q];
          }
        }
      }
      // publishes the bounds and dl_s; orders the last pass's reads of
      // score/hit before this pass's writes (and the last merge before the
      // next lists)
      __syncthreads();
      int pre[BOOL_PASS], off[BOOL_PASS];  // flat offset, row position - flat
      int total = 0;
      bool empty = false;
      #pragma unroll
      for (int t = 0; t < BOOL_PASS; ++t) {
        const int len = t < nc ? hi_s[t] - lo_s[t] : 0;
        empty |= t < nc && len == 0;
        pre[t] = total;
        off[t] = t < nc ? st_s[t] + lo_s[t] - total : 0;
        total += len;
      }
      if (conjunctive && empty) {
        dead = true;
        break;
      }
      // every posting of the pass, all terms at once; docs are unique
      // within a term row, so no two threads write one entry
      for (int f0 = threadIdx.x; f0 < total; f0 += SCATTER_BATCH * DT_THREADS) {
        int fq[SCATTER_BATCH], d[SCATTER_BATCH], tt[SCATTER_BATCH];
        #pragma unroll
        for (int x = 0; x < SCATTER_BATCH; ++x) {  // the batch's loads, all in flight
          const int f = f0 + x * DT_THREADS;
          int t = 0, i = off[0] + f;
          #pragma unroll
          for (int u = 1; u < BOOL_PASS; ++u) {
            if (f >= pre[u] && u < nc) {
              t = u;
              i = off[u] + f;
            }
          }
          tt[x] = t;
          fq[x] = f < total ? csr_freqs[i] : 0;
          d[x] = f < total ? csr_docs[i] : base;
        }
        #pragma unroll
        for (int x = 0; x < SCATTER_BATCH; ++x) {
          if (fq[x] > 0) {
            const int j = d[x] - base;
            score[tt[x]][j] =
                __float_as_int(bm25_score(fq[x], dl_s[j] >> 1, idf_s[tt[x]], avgdl, k1, b));
            hit[tt[x]][j] = 1;
          }
        }
      }
      __syncthreads();  // the pass's scores
      // each thread adds its own docs' scores in term order
      for (int t = 0; t < nc; ++t) {
        int s[DT_DPT];
        load4(&score[t][q0], s);
        #pragma unroll
        for (int i = 0; i < DT_DPT; i += 4) {
          unsigned* w = reinterpret_cast<unsigned*>(&hit[t][q0 + i]);
          const unsigned h = *w;
          *w = 0u;
          #pragma unroll
          for (int u = 0; u < 4; ++u) {
            if ((h >> (8 * u)) & 1u) {
              sum[i + u] = __fadd_rn(sum[i + u], __int_as_float(s[i + u]));
              seen |= 1u << (i + u);
            } else {
              missed |= 1u << (i + u);
            }
          }
        }
      }
    }
    int key[DT_DPT];
    int c = 0;
    #pragma unroll
    for (int i = 0; i < DT_DPT; ++i) {
      const bool ok = !dead && ((conjunctive ? ~missed : seen) >> i & 1u) && (dl_s[q0 + i] & 1);
      key[i] = ok ? order_key(sum[i]) : NO_KEY;
      c += ok;
    }
    finish_tile(key, c, k, base, item, out_vals, out_ids, out_cnt,
                &score[0][0], wn);
  }
}

// the grid and items of bool_topk_kernel; starts/lengths (B,); live/dv
// (ND_pad,), 16-byte aligned.  Held to 12 blocks an SM (40 registers, no
// spill): 132 SMs then hold the main path's 32 x 49 items at once.
__global__ void __launch_bounds__(DT_THREADS, 12) sort_topk_kernel(
    const int* __restrict__ csr_docs, const int* __restrict__ csr_freqs,
    const int* __restrict__ live, const int* __restrict__ dv,
    const int* __restrict__ starts, const int* __restrict__ lengths,
    int n_tiles, int n_items, int k, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int* __restrict__ out_cnt) {
  __shared__ __align__(16) int hit[TILE];  // 1 where a posting has freq > 0
  __shared__ int cand[TILE];
  __shared__ int wn[DT_WARPS];
  __shared__ int bound_s[2];
  const int q0 = threadIdx.x * DT_DPT;
  const int warp = threadIdx.x >> 5;
  #pragma unroll
  for (int i = 0; i < DT_DPT; i += 4)
    *reinterpret_cast<int4*>(&hit[q0 + i]) = make_int4(0, 0, 0, 0);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row = item / n_tiles;
    const int base = (item - row * n_tiles) * TILE;
    int lv[DT_DPT], v[DT_DPT];
    load4(live + base + q0, lv);
    load4(dv + base + q0, v);
    const int st = starts[row];
    // warps 0 and 1 find the tile's two edges
    const int r = group_lower_bound<SORT_LANES>(csr_docs + st, warp < 2 ? lengths[row] : 0,
                                                base + warp * TILE);
    if (warp < 2 && (threadIdx.x & 31) == 0) bound_s[warp] = r;
    __syncthreads();  // the bounds; the last item's reads of hit and its merge
    const int hi = st + bound_s[1];
    for (int i0 = st + bound_s[0] + threadIdx.x; i0 < hi; i0 += SCATTER_BATCH * DT_THREADS) {
      int fq[SCATTER_BATCH], d[SCATTER_BATCH];
      #pragma unroll
      for (int x = 0; x < SCATTER_BATCH; ++x) {  // the batch's loads, all in flight
        const int i = i0 + x * DT_THREADS;
        fq[x] = i < hi ? csr_freqs[i] : 0;
        d[x] = i < hi ? csr_docs[i] : base;
      }
      #pragma unroll
      for (int x = 0; x < SCATTER_BATCH; ++x)
        if (fq[x] > 0) hit[d[x] - base] = 1;
    }
    __syncthreads();  // hit[]
    int m[DT_DPT];
    load4(&hit[q0], m);
    #pragma unroll
    for (int i = 0; i < DT_DPT; i += 4)
      *reinterpret_cast<int4*>(&hit[q0 + i]) = make_int4(0, 0, 0, 0);
    int key[DT_DPT];
    int c = 0;
    #pragma unroll
    for (int i = 0; i < DT_DPT; ++i) {
      const bool ok = m[i] && lv[i] > 0;
      key[i] = ok ? order_key(__int2float_rn(v[i])) : NO_KEY;
      c += ok;
    }
    finish_tile(key, c, k, base, item, out_vals, out_ids, out_cnt, cand, wn);
  }
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

// the block layout kernels/doc_topk.py mirrors: DT_THREADS (which = 0),
// BOOL_PASS (1), BOOL_LANES (2), SORT_LANES (3)
int doc_topk_layout(int which) {
  const int layout[4] = {DT_THREADS, BOOL_PASS, BOOL_LANES, SORT_LANES};
  return which >= 0 && which < 4 ? layout[which] : -1;
}

// blocks of bool_topk (which = 0) or sort_topk (1) that one SM holds at
// once (0 on error): the launch's grid is at most this times the SMs
int doc_topk_blocks_per_sm(int which) {
  int blocks = 0;
  const cudaError_t err =
      which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bool_topk_kernel,
                                                                 DT_THREADS, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sort_topk_kernel,
                                                                 DT_THREADS, 0);
  return err == cudaSuccess ? blocks : 0;
}

// n_blocks: the grid (kernels/doc_topk.py::grid_blocks), clipped to the
// n_rows * n_tiles work items
int bool_topk(const int* csr_docs, const int* csr_freqs, const int* dl_live,
              const int* starts, const int* lengths, const float* idfs,
              float avgdl, float k1, float b, int n_terms, int conjunctive,
              int n_rows, int n_tiles, int n_blocks, int k, float* out_vals,
              int* out_ids, int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  if (n_blocks <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const int n_items = n_rows * n_tiles;
  bool_topk_kernel<<<n_blocks < n_items ? n_blocks : n_items, DT_THREADS, 0,
                     (cudaStream_t)stream>>>(
      csr_docs, csr_freqs, dl_live, starts, lengths, idfs, avgdl, k1, b, n_terms,
      conjunctive, n_tiles, n_items, k, out_vals, out_ids, out_cnt);
  return (int)cudaGetLastError();
}

int sort_topk(const int* csr_docs, const int* csr_freqs, const int* live,
              const int* dv, const int* starts, const int* lengths, int n_rows,
              int n_tiles, int n_blocks, int k, float* out_vals, int* out_ids,
              int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  if (n_blocks <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const int n_items = n_rows * n_tiles;
  sort_topk_kernel<<<n_blocks < n_items ? n_blocks : n_items, DT_THREADS, 0,
                     (cudaStream_t)stream>>>(
      csr_docs, csr_freqs, live, dv, starts, lengths, n_tiles, n_items, k, out_vals,
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
