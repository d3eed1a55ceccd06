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
//               are the k lowest matching doc ids, ranked by a prefix count
//               instead of k argmax rounds (the reference ranks a -doc
//               float key, the same order below 2^24 docs).
//   facet_hist  replaces fused_exec.py::facet_hist_tiles.  Counts matched
//               live docs per bin (bins < 0 clip to 0, bins >= n_bins drop:
//               jnp.bincount's rule) in shared int counters, then adds them
//               to the row's int32 scratch histogram in device memory with
//               integer atomics: exact and order-free.  The last tile of a
//               row to finish (a ticket per row) writes the row's float32
//               counts and zeroes its scratch, so a call is one launch.
//               Match-all facets run one row whose matched set is the live
//               bitmap.
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
// tile) is microseconds of dependent steps.  They are built around those
// latency chains (warp_select.cuh):
//   * one wave: 128-thread blocks, the grid at most the blocks the card
//     holds at once (the occupancy API, kernels/doc_topk.py::grid_blocks),
//     block x taking the flat work items x, x + grid, ... (item = row *
//     n_tiles + tile; kernels/doc_topk.py::work_schedule mirrors it);
//     range_topk's unit is a warp, not a block: warp w of block x takes
//     items 4x + w, + 4 grid, ... (kernels/doc_topk.py::warp_schedule), so
//     the main path's 32 x 49 items are 392 blocks, and a wave holds 4x
//     the items of a block-an-item grid;
//   * a many-way search: a group of lanes per (term, tile edge), all of a
//     pass's at once (sort_topk, facet_hist: a warp per edge; bool_topk: 16
//     lanes, 6 groups for a pass of 3 terms), each step probing evenly
//     spaced postings: at 50,000 postings 4 dependent reads a bound with 32
//     or 16 lanes, not 16 (group_lower_bound);
//   * a scatter with no dependent read of device memory: a thread loads
//     two postings at once, doc lengths come from shared memory, match
//     flags are bits, and a doc's owner thread reads its live bit, doc
//     value or bin with 16-byte loads;
//   * a select with no block-wide rounds: each thread sorts its 8 keys,
//     each warp takes the top min(k, its matches) of its 256 contiguous
//     docs with one __reduce_max_sync a round, and warp 0 merges the 4
//     sorted lists the same way (finish_tile);
//   * range_topk has no select and no barrier: the item's warp reads the
//     tile as 8 chunks of 128 docs, each one coalesced 16-byte load a lane
//     of dv and of live (all 16 in flight; lane l owns docs 4l..4l+3 of
//     each chunk), keeps a 32-bit match mask, and ranks its matches in doc
//     order by one warp scan of the 8 chunks' counts packed a byte each
//     into two words (10 shuffles).  (32 contiguous docs a lane, loads of
//     a 128-byte stride across the warp, took 6.0 us on an H100 at the
//     main path's shape against this layout's 4.3: each load touched 32
//     cache lines.)
// A (row, tile) takes 3 block barriers (bool with more than 3 terms: 2 more
// a pass of 3 terms; facet_hist 4, match-all 2; range_topk none).

#include "warp_select.cuh"

#define FACET_SHARED_BINS 8192  // above this, facet_hist counts in device memory
#define BOOL_PASS 3                     // bool terms scattered per pass
#define SORT_LANES 32                   // lanes of a sort_topk / facet_hist search group
#define SCATTER_BATCH 2                 // postings a thread loads at once
#define RANGE_CHUNK (32 * 4)            // docs of one range_topk warp load: an int4 a lane
#define RANGE_CHUNKS (TILE / RANGE_CHUNK)

static_assert(RANGE_CHUNKS == 8, "a lane's matches are one 32-bit mask, its chunk counts 8 bytes");

// bool_topk searches a pass's two tile edges of each term at once
constexpr int BOOL_LANES = group_lanes(DT_THREADS / (2 * BOOL_PASS));

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
    finish_tile(key, c, k, PosFrom{base + q0}, item, out_vals, out_ids, out_cnt,
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
    finish_tile(key, c, k, PosFrom{base + q0}, item, out_vals, out_ids, out_cnt, cand, wn);
  }
}

// grid: at most the blocks the card holds at once, at most one a
// DT_WARPS items; warp w of block x takes the work items x * DT_WARPS + w,
// + gridDim.x * DT_WARPS, ... (item = row * n_tiles + tile).  los/his (B,);
// dv/live (ND_pad,), 16-byte aligned.  Lane l owns docs RANGE_CHUNK i + 4 l
// + j (j < 4) of chunk i: bit 4 i + j of its mask.
__global__ void __launch_bounds__(DT_THREADS) range_topk_kernel(
    const int* __restrict__ dv, const int* __restrict__ live,
    const int* __restrict__ los, const int* __restrict__ his, int n_tiles,
    int n_items, int k, float* __restrict__ out_vals, int* __restrict__ out_ids,
    int* __restrict__ out_cnt) {
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * DT_WARPS;
  for (int item = blockIdx.x * DT_WARPS + (threadIdx.x >> 5); item < n_items; item += step) {
    const int row = item / n_tiles;
    const int base = (item - row * n_tiles) * TILE;
    const int lo = los[row];
    const int hi = his[row];
    const int4* v4 = reinterpret_cast<const int4*>(dv + base) + lane;
    const int4* l4 = reinterpret_cast<const int4*>(live + base) + lane;
    int4 v[RANGE_CHUNKS], lv[RANGE_CHUNKS];
    #pragma unroll
    for (int i = 0; i < RANGE_CHUNKS; ++i) {  // all 16 loads in flight
      v[i] = v4[32 * i];
      lv[i] = l4[32 * i];
    }
    unsigned mask = 0u;
    #pragma unroll
    for (int i = 0; i < RANGE_CHUNKS; ++i) {
      const int a[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
      const int b[4] = {lv[i].x, lv[i].y, lv[i].z, lv[i].w};
      #pragma unroll
      for (int j = 0; j < 4; ++j)
        mask |= (unsigned)(a[j] >= lo && a[j] <= hi && b[j] > 0) << (4 * i + j);
    }
    // chunk i's matches in byte i % 4 of word i / 4 (a warp's byte sums to
    // at most RANGE_CHUNK = 128), scanned over the lanes
    unsigned own[2] = {0u, 0u};
    #pragma unroll
    for (int i = 0; i < RANGE_CHUNKS; ++i)
      own[i / 4] |= (unsigned)__popc((mask >> (4 * i)) & 0xfu) << (8 * (i % 4));
    unsigned incl[2] = {own[0], own[1]};
    #pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y0 = __shfl_up_sync(0xffffffffu, incl[0], off);
      const unsigned y1 = __shfl_up_sync(0xffffffffu, incl[1], off);
      if (lane >= off) {
        incl[0] += y0;
        incl[1] += y1;
      }
    }
    const unsigned chunk_n[2] = {__shfl_sync(0xffffffffu, incl[0], 31),
                                 __shfl_sync(0xffffffffu, incl[1], 31)};
    float* ov = out_vals + (int64_t)item * k;
    int* oi = out_ids + (int64_t)item * k;
    int total = 0;  // matches of the chunks before chunk i, then of the tile
    #pragma unroll
    for (int i = 0; i < RANGE_CHUNKS; ++i) {
      const int sh = 8 * (i % 4);
      unsigned m = (mask >> (4 * i)) & 0xfu;
      int rank = total + (int)(((incl[i / 4] - own[i / 4]) >> sh) & 0xffu);
      for (; m != 0u && rank < k; ++rank) {
        ov[rank] = 1.0f;
        oi[rank] = base + RANGE_CHUNK * i + 4 * lane + __ffs(m) - 1;
        m &= m - 1u;
      }
      total += (int)((chunk_n[i / 4] >> sh) & 0xffu);
    }
    if (lane == 0) out_cnt[item] = total;
    for (int r = min(total, k) + lane; r < k; r += 32) {  // no winner
      ov[r] = -CUDART_INF_F;
      oi[r] = -1;
    }
  }
}

// grid: at most the blocks the card holds at once; block x takes the work
// items x, x + gridDim.x, ... (item = row * n_tiles + tile).  live/bins
// (ND_pad,), 16-byte aligned; starts/lengths (B,), not read with
// match_all (one row whose matched set is the live bitmap).  scratch: B
// tickets, then a (B, n_bins) int32 histogram; zero on entry, and the
// kernel leaves it zero.  Dynamic shared memory: n_bins ints when
// shared_bins, else the tile counts straight into the scratch row.  Held
// to 12 blocks an SM, as sort_topk: 132 SMs then hold the main path's 32 x
// 49 items at once, one a block (at 9 an SM, 380 blocks took two).
__global__ void __launch_bounds__(DT_THREADS, 12) facet_hist_kernel(
    const int* __restrict__ csr_docs, const int* __restrict__ csr_freqs,
    const int* __restrict__ live, const int* __restrict__ bins,
    const int* __restrict__ starts, const int* __restrict__ lengths,
    int match_all, int n_bins, int shared_bins, int n_tiles, int n_items,
    int* __restrict__ scratch, float* __restrict__ out_hist,
    int* __restrict__ out_cnt) {
  extern __shared__ int hist_s[];
  __shared__ unsigned matched[TILE / 32];  // bit j of word w: doc 32 w + j has a posting
  __shared__ int wn[DT_WARPS];
  __shared__ int bound_s[2];
  const int q0 = threadIdx.x * DT_DPT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_rows = n_items / n_tiles;
  int* tickets = scratch;
  if (shared_bins) {
    for (int i = threadIdx.x; i < n_bins; i += DT_THREADS) hist_s[i] = 0;
  }
  // the zeroed bins before the first item's adds: a match_all item has no
  // barrier ahead of them
  __syncthreads();
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row = item / n_tiles;
    const int base = (item - row * n_tiles) * TILE;
    int* row_scratch = scratch + n_rows + (int64_t)row * n_bins;
    int* hist = shared_bins ? hist_s : row_scratch;
    int lv[DT_DPT], bn[DT_DPT];
    load4(live + base + q0, lv);
    load4(bins + base + q0, bn);
    unsigned m = 0xffu;  // bit i: doc q0 + i is matched
    if (!match_all) {
      if (threadIdx.x < TILE / 32) matched[threadIdx.x] = 0u;
      const int st = starts[row];
      // warps 0 and 1 find the tile's two edges
      const int r = group_lower_bound<SORT_LANES>(csr_docs + st, warp < 2 ? lengths[row] : 0,
                                                  base + warp * TILE);
      if (warp < 2 && lane == 0) bound_s[warp] = r;
      __syncthreads();  // the bounds and the cleared flags
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
          if (fq[x] > 0) atomicOr(&matched[(d[x] - base) >> 5], 1u << ((d[x] - base) & 31));
      }
      __syncthreads();  // the flags
      m = (matched[threadIdx.x / 4] >> (8 * (threadIdx.x & 3))) & 0xffu;
    }
    int c = 0;
    #pragma unroll
    for (int i = 0; i < DT_DPT; ++i) {
      const bool hit = ((m >> i) & 1u) && lv[i] > 0;
      c += hit;
      const int bin = max(bn[i], 0);
      if (hit && bin < n_bins) atomicAdd(&hist[bin], 1);  // integers: exact, order-free
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) wn[warp] = c;
    __syncthreads();  // the tile's counts; the flags' last reads
    int n_matched = 0;
    #pragma unroll
    for (int w = 0; w < DT_WARPS; ++w) n_matched += wn[w];
    if (shared_bins) {  // into the row's scratch histogram, leaving zeros
      for (int i = threadIdx.x; i < n_bins; i += DT_THREADS) {
        const int v = hist_s[i];
        if (v) {
          atomicAdd(&row_scratch[i], v);
          hist_s[i] = 0;
        }
      }
    }
    __syncthreads();  // this tile's adds are done
    if (warp == 0) {
      // the last tile of the row to finish writes the row's float32
      // counts and leaves its scratch and ticket zero for the next call
      int last = 0;
      if (lane == 0) {
        out_cnt[item] = n_matched;
        // cumulative: orders the block's adds, which the barrier showed
        // this thread, before its ticket (a release, as a semaphore's)
        __threadfence();
        last = atomicAdd(&tickets[row], 1) == n_tiles - 1;
      }
      if (__shfl_sync(0xffffffffu, last, 0)) {
        __threadfence();
        float* out = out_hist + (int64_t)row * n_bins;
        for (int i = lane; i < n_bins; i += 32) out[i] = (float)atomicExch(&row_scratch[i], 0);
        if (lane == 0) tickets[row] = 0;
      }
    }
  }
}

extern "C" {

int facet_shared_bins() { return FACET_SHARED_BINS; }

// the block layout kernels/doc_topk.py mirrors: DT_THREADS (which = 0),
// BOOL_PASS (1), BOOL_LANES (2), SORT_LANES (3), RANGE_CHUNKS (4)
int doc_topk_layout(int which) {
  const int layout[5] = {DT_THREADS, BOOL_PASS, BOOL_LANES, SORT_LANES, RANGE_CHUNKS};
  return which >= 0 && which < 5 ? layout[which] : -1;
}

// blocks of bool_topk (which = 0), sort_topk (1), facet_hist (2, with smem
// bytes of dynamic shared memory) or range_topk (3) that one SM holds at
// once (0 on error): the launch's grid is at most this times the SMs
int doc_topk_blocks_per_sm(int which, int smem) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bool_topk_kernel, DT_THREADS, 0);
  else if (which == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sort_topk_kernel, DT_THREADS, 0);
  else if (which == 2)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, facet_hist_kernel, DT_THREADS,
                                                        (size_t)smem);
  else if (which == 3)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, range_topk_kernel, DT_THREADS, 0);
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

// n_blocks: the grid (kernels/doc_topk.py::grid_blocks), clipped to one
// block a DT_WARPS of the n_rows * n_tiles work items
int range_topk(const int* dv, const int* live, const int* los, const int* his,
               int n_rows, int n_tiles, int n_blocks, int k, float* out_vals,
               int* out_ids, int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0) return 0;
  if (n_blocks <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  if ((int64_t)n_rows * n_tiles * k >= (1 << 30)) return (int)cudaErrorInvalidValue;
  const int n_items = n_rows * n_tiles;
  const int need = (n_items + DT_WARPS - 1) / DT_WARPS;
  range_topk_kernel<<<n_blocks < need ? n_blocks : need, DT_THREADS, 0,
                      (cudaStream_t)stream>>>(
      dv, live, los, his, n_tiles, n_items, k, out_vals, out_ids, out_cnt);
  return (int)cudaGetLastError();
}

// n_blocks: the grid (kernels/doc_topk.py::grid_blocks), clipped to the
// n_rows * n_tiles work items; scratch: n_rows + n_rows * n_bins zeroed
// ints, left zero
int facet_hist(const int* csr_docs, const int* csr_freqs, const int* live,
               const int* bins, const int* starts, const int* lengths,
               int match_all, int n_bins, int n_rows, int n_tiles, int n_blocks,
               int* scratch, float* out_hist, int* out_cnt, void* stream) {
  if (n_rows <= 0 || n_tiles <= 0 || n_bins <= 0) return 0;
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const int shared_bins = n_bins <= FACET_SHARED_BINS;
  const size_t smem = shared_bins ? (size_t)n_bins * sizeof(int) : 0;
  const int n_items = n_rows * n_tiles;
  facet_hist_kernel<<<n_blocks < n_items ? n_blocks : n_items, DT_THREADS, smem,
                      (cudaStream_t)stream>>>(
      csr_docs, csr_freqs, live, bins, starts, lengths, match_all, n_bins, shared_bins,
      n_tiles, n_items, scratch, out_hist, out_cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
