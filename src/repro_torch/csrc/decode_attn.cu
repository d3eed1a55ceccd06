// Grouped-query decode attention on Hopper (sm_90a).
//
//   decode_attn  replaces repro/kernels/decode_attn.py::decode_attn (body
//                _decode_attn_kernel): one new token's attention against a
//                KV cache.  q (B, Hkv, G, D), k (B, Hkv, S, D), v (B, Hkv,
//                S, Dv), kv_len (B,): s = q.k * scale in float32, positions
//                >= kv_len masked, softmax over the positions, p.v, float32
//                out (B, Hkv, G, Dv) = acc / max(l, 1e-30) -- so a row with
//                kv_len = 0 gives 0, as the Pallas kernel does.
//
// What bounds it on an H100 (3.35 TB/s HBM, 67 TFLOP/s float32 outside the
// tensor cores): the bytes of K and V up to each row's length.  A position
// costs 4 * G * D operations for 2 * D * (2 or 4) bytes: 6 operations a
// byte for bf16 K/V at G = 6, 3 for float32, where the FMA pipe sustains
// ~20 per byte of HBM.  So the kernel is bound by bytes; it runs its
// products on the FMA pipe, not the tensor cores, and its design is about
// keeping enough bytes in flight and the arithmetic out of their way.
//
// One launch, 128 threads a block:
//   * The schedule (work-balanced).  Segment (b, j) is row b's positions
//     for one KV head and HB of its G query heads.  The grid is the blocks
//     the card holds at once (the wrapper asks the occupancy API).  The
//     block reads kv_len and lays the segments end to end: with long rows
//     every block takes the same share of positions (a DA_TILE multiple),
//     across segment ends, whatever the rows' lengths, so one wave ends
//     together; when every 64-position chunk of every segment can have a
//     block (short rows, the serving engine), block x takes chunk x.
//   * K and V stream through a ring of DA_STAGES shared-memory stages of tp
//     positions in their storage type (bf16 stays 2 bytes) by cp.async
//     16-byte copies issued two tiles ahead: one barrier per tile; the q
//     heads load while the first copies fly.  K rows are staged at a pitch
//     that keeps a quarter-warp's 16-byte reads on distinct banks.  The
//     wrapper requires rows that start 16-byte aligned and hold whole
//     16-byte slices.
//   * Warps own positions.  Scores: lpp lanes (2-32, chosen so the ring
//     fits) take a position, each every lpp-th 16-byte slice of its K row
//     against the HB pre-scaled query heads in shared memory, then a
//     shuffle sum.  Softmax: one max per head and tile over the warp's
//     positions, one warp-uniform branch when a max rises, the weights to
//     shared memory.  p.v: a lane owns CPL components of V and runs over
//     the warp's positions with HB x CPL accumulators in registers.  The
//     warps merge once per segment, through shared memory.
//   * Blocks that share a segment combine without a second launch: each
//     writes its piece (m, l, acc), takes a ticket from the segment's
//     counter, and the block holding the last ticket rescales the pieces
//     to their common max, divides, writes out and resets the counter to 0
//     for the next call (the counters are zeroed once, when the wrapper
//     allocates them).  Its threads issue a batch of piece loads before
//     using any.  A segment wholly inside one block is written out
//     directly.
//
// Strides are element strides of q, k, v, so the model passes its cache
// (B, S, Hkv, D) as a transposed view and nothing is copied.  q is float32
// or bf16 (a runtime flag: it is read once per segment), K/V float32 or
// bf16 (templated); the softmax (base 2) and the accumulation are float32.
// Built with -fmad=false: the fused multiply-adds are the explicit ones.
// The (CPL, HB) instances built below are the ones kernels/decode_attn.py's
// kernel_plan chooses from.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has the table):
// 0.019 ms at the serving engine's shape, 0.19 ms over 196,000 float32
// positions (63% of the byte bound), 0.13 ms over bf16 ones (47%; SDPA
// 0.11 ms).  With 2 blocks of 4 warps an SM (shared memory), the copies
// and the arithmetic's latency overlap only in part: in development builds
// each alone took well over the byte bound over bf16 caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "async_copy.cuh"

#define DA_THREADS 128
#define DA_WARPS (DA_THREADS / 32)
#define DA_TILE 64    // the split width is a multiple of it
#define DA_STAGES 3   // ring depth: copies DA_STAGES - 1 tiles ahead
#define DA_LOG2E 1.4426950408889634f
#define DA_FULL 0xffffffffu

struct Geometry {
  long long q[4];  // element strides of q (B, Hkv, G, D)
  long long k[3];  // of K (B, Hkv, S); the last one is 1
  long long v[3];
  int B, H, G, S, D, DV;
  int width;   // positions per block (a DA_TILE multiple), 0: even shares
  int lpp;     // lanes per position in the score phase
  int tp;      // positions per ring stage: DA_WARPS * 32 / lpp
  int kpitch;  // bytes per staged K row (padded: conflict-free reads)
  int q_bf16;
  float scale2;  // 1/sqrt(D) * log2(e)
};

// the 16-byte slice r as float32 values
__device__ __forceinline__ void unpack(const uint4 r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4 r, float* f, __nv_bfloat16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: element 2i in the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// CPL values of a staged V row from component c (< DV, a multiple of CPL);
// 16-byte pieces past DV are zeros
template <typename TKV, int CPL>
__device__ __forceinline__ void load_v(const TKV* row, int c, int dv, float (&f)[CPL]) {
  constexpr int EPV = 16 / sizeof(TKV);
  if constexpr (CPL < EPV) {  // bf16, 4 values: 8 bytes
    const uint2 r = *reinterpret_cast<const uint2*>(row + c);
    f[0] = __uint_as_float(r.x << 16);
    f[1] = __uint_as_float(r.x & 0xffff0000u);
    f[2] = __uint_as_float(r.y << 16);
    f[3] = __uint_as_float(r.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < CPL / EPV; ++i) {
      if (c + i * EPV < dv) {
        unpack(*reinterpret_cast<const uint4*>(row + c + i * EPV), f + i * EPV, TKV());
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) f[i * EPV + e] = 0.0f;
      }
    }
  }
}

__device__ __forceinline__ float q_at(const void* q, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

// the largest b < B with at[b] * mult <= x (at[0] = 0, at ascending): the
// row holding laid-out position (or chunk) x; empty rows share their
// successor's offset and are never chosen
__device__ __forceinline__ int last_at_or_below(const int* at, int B, int mult, long long x) {
  int lo = 0, hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if ((long long)at[mid] * mult <= x) lo = mid; else hi = mid;
  }
  return lo;
}

// weight of a partial with max m against the common max mx (0 for a
// partial that saw no position)
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == -CUDART_INF_F ? 0.0f : exp2f(m - mx);
}

template <typename TKV, int CPL, int HB>
__global__ void __launch_bounds__(DA_THREADS, 3) decode_attn_kernel(
    const void* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
    const int* __restrict__ kv_len, const Geometry gm, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int* __restrict__ tickets, float* __restrict__ out) {
  constexpr int EPV = 16 / sizeof(TKV);  // elements per 16-byte slice
  constexpr int HP = (HB + 3) & ~3;      // a position's weights, padded to float4s
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_m[DA_WARPS][HB], red_l[DA_WARPS][HB];
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = gm.D, DV = gm.DV, tp = gm.tp, kpitch = gm.kpitch;
  const int HN = gm.H * (gm.G / HB);  // segments of a row: (KV head, head chunk)
  const int items = HB * DV;          // (head, component) outputs of a segment
  const int SK = D / EPV, SV = DV / EPV;  // 16-byte slices of a K, V row
  const int llog = __ffs(gm.lpp) - 1, lpp = gm.lpp;
  const int P = 32 >> llog;  // positions of a warp per tile
  const int pos = lane >> llog, part = lane & (lpp - 1);
  const int cl = lane * CPL;  // this lane's V components
  const int stage_bytes = tp * (kpitch + DV * (int)sizeof(TKV));
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + DA_STAGES * stage_bytes);  // [HB][D]
  float* ps = qs + HB * D;  // [DA_WARPS][P][HP] softmax weights
  int* row_at = reinterpret_cast<int*>(ps + DA_WARPS * P * HP);  // [B + 1]
  int* chunk_at = row_at + gm.B + 1;                               // [B + 1]

  // The schedule.  Segment (b, j) is row b's positions for KV head j / (G /
  // HB) and head chunk j % (G / HB); laid end to end, row by row, they form
  // T positions.  When every DA_TILE-position chunk of every segment can
  // have a block of its own, block x takes chunk x (short rows: latency);
  // otherwise block x takes positions [x * W, x * W + W), a segment's
  // pieces wherever they fall: every block the same share, whatever the
  // rows' lengths (long rows: bandwidth).
  if (warp == 0) {  // row_at[b], chunk_at[b]: positions, chunks before row b
    int carry = 0, carry_c = 0;
    for (int b0 = 0; b0 < gm.B; b0 += 32) {
      int n = b0 + lane < gm.B ? kv_len[b0 + lane] : 0;
      n = n < 0 ? 0 : (n > gm.S ? gm.S : n);
      const int c = (n + DA_TILE - 1) / DA_TILE;
      int x = n, y = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int xo = __shfl_up_sync(DA_FULL, x, o), yo = __shfl_up_sync(DA_FULL, y, o);
        if (lane >= o) {
          x += xo;
          y += yo;
        }
      }
      if (b0 + lane < gm.B) {
        row_at[b0 + lane] = carry + x - n;
        chunk_at[b0 + lane] = carry_c + y - c;
      }
      carry += __shfl_sync(DA_FULL, x, 31);
      carry_c += __shfl_sync(DA_FULL, y, 31);
    }
    if (lane == 0) {
      row_at[gm.B] = carry;
      chunk_at[gm.B] = carry_c;
    }
  }
  __syncthreads();
  const long long T = (long long)row_at[gm.B] * HN;
  const bool chunked = gm.width == 0 && (long long)chunk_at[gm.B] * HN <= gridDim.x;
  long long W = gm.width;
  if (W == 0) {
    W = (T + gridDim.x - 1) / gridDim.x;
    W = W < DA_TILE ? DA_TILE : (W + DA_TILE - 1) / DA_TILE * DA_TILE;
  }
  if (blockIdx.x == 0) {  // rows with no position give 0
    for (int b = 0; b < gm.B; ++b) {
      if (row_at[b + 1] == row_at[b]) {
        float* o = out + (int64_t)b * gm.H * gm.G * DV;
        for (int i = tid; i < gm.H * gm.G * DV; i += DA_THREADS) o[i] = 0.0f;
      }
    }
  }
  long long x0 = blockIdx.x * W;
  long long x1 = (blockIdx.x + 1) * W < T ? (blockIdx.x + 1) * W : T;
  if (chunked) {
    x0 = x1 = 0;
    if (blockIdx.x < chunk_at[gm.B] * HN) {
      const int b = last_at_or_below(chunk_at, gm.B, HN, blockIdx.x);
      const int cb = chunk_at[b + 1] - chunk_at[b], n = row_at[b + 1] - row_at[b];
      const int kx = blockIdx.x - chunk_at[b] * HN, j = kx / cb;
      x0 = (long long)row_at[b] * HN + (long long)j * n + (long long)(kx - j * cb) * DA_TILE;
      x1 = x0 + DA_TILE < (long long)row_at[b] * HN + (long long)(j + 1) * n
          ? x0 + DA_TILE : (long long)row_at[b] * HN + (long long)(j + 1) * n;
    }
  }

  for (long long x = x0; x < x1;) {
    // the segment holding position x: row b (row_at ascending), then j
    const int b = last_at_or_below(row_at, gm.B, HN, x);
    const int n = row_at[b + 1] - row_at[b];
    const long long row0 = (long long)row_at[b] * HN;
    const int j = (int)((x - row0) / n);
    const long long seg0 = row0 + (long long)j * n;  // the segment's first position
    const int a = (int)(x - seg0);
    const int e = seg0 + n < x1 ? n : (int)(x1 - seg0);
    x = seg0 + e;
    const int seg = b * HN + j;
    const int h = j / (gm.G / HB), g0 = (j - h * (gm.G / HB)) * HB;
    float* outp = out + ((int64_t)(b * gm.H + h) * gm.G + g0) * DV;

    const TKV* kb = k + b * gm.k[0] + h * gm.k[1];
    const TKV* vb = v + b * gm.v[0] + h * gm.v[1];
    const int n_tiles = (e - a + tp - 1) / tp;
    // producer: thread tid copies slices tid mod WS, + WS, ... of positions
    // tid / WS, + DA_THREADS / WS, ... (WS: a power of two <= DA_THREADS)
    const int need = SK > SV ? SK : SV;
    int wlog = 32 - __clz(need - 1);
    wlog = wlog > 7 ? 7 : wlog;
    const int WS = 1 << wlog;
    const int pc = tid & (WS - 1), pr0 = tid >> wlog, pstep = DA_THREADS >> wlog;

    auto issue = [&](int tile) {
      if (tile < n_tiles) {
        unsigned char* ks = ring + (tile % DA_STAGES) * stage_bytes;
        unsigned char* vs = ks + tp * kpitch;
        const int p0 = a + tile * tp;
        const int np = e - p0 < tp ? e - p0 : tp;
        for (int t = pr0; t < np; t += pstep) {
          const TKV* kr = kb + (p0 + t) * gm.k[2];
          const TKV* vr = vb + (p0 + t) * gm.v[2];
          for (int c = pc; c < SK; c += WS) cp_async16(ks + t * kpitch + c * 16, kr + c * EPV);
          for (int c = pc; c < SV; c += WS)
            cp_async16(vs + (t * DV + c * EPV) * (int)sizeof(TKV), vr + c * EPV);
        }
      }
      cp_async_commit();  // one group per tile index, empty past the end
    };

    float m[HB], l[HB], acc[HB][CPL];
#pragma unroll
    for (int g = 0; g < HB; ++g) {
      m[g] = -CUDART_INF_F;
      l[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[g][c] = 0.0f;
    }

#pragma unroll
    for (int st = 0; st < DA_STAGES - 1; ++st) issue(st);
    // the segment's query heads, pre-scaled by scale * log2 e (read after
    // the first barrier of the tile loop; loaded once the first tiles'
    // copies are in flight)
    const long long qb = b * gm.q[0] + h * gm.q[1];
    for (int i = tid; i < HB * D; i += DA_THREADS) {
      const int g = i / D, d = i - g * D;
      qs[i] = __fmul_rn(q_at(q, gm.q_bf16, qb + (g0 + g) * gm.q[2] + d * gm.q[3]),
                        gm.scale2);
    }

    for (int tile = 0; tile < n_tiles; ++tile) {
      cp_async_wait<DA_STAGES - 2>();  // this thread's copies of `tile` landed
      __syncthreads();  // everyone's landed; the buffer of tile - 1 is free
      issue(tile + DA_STAGES - 1);
      const unsigned char* ks = ring + (tile % DA_STAGES) * stage_bytes;
      const TKV* vs = reinterpret_cast<const TKV*>(ks + tp * kpitch);
      const int p0 = a + tile * tp;
      const int np = e - p0 < tp ? e - p0 : tp;
      const int tw = warp * P;  // the warp's positions: tw .. tw + P - 1
      if (tw >= np) continue;   // warp-uniform

      // scores: lpp lanes a position, each every lpp-th 16-byte slice of K
      const int t = tw + pos;
      const bool valid = t < np;
      float dot[HB];
#pragma unroll
      for (int g = 0; g < HB; ++g) dot[g] = 0.0f;
      if (valid) {
#pragma unroll 2
        for (int js = part; js < SK; js += lpp) {
          float kf[EPV];
          unpack(*reinterpret_cast<const uint4*>(ks + t * kpitch + js * 16), kf, TKV());
#pragma unroll
          for (int g = 0; g < HB; ++g) {
            const float* qg = qs + g * D + js * EPV;
#pragma unroll
            for (int e4 = 0; e4 < EPV; e4 += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qg + e4);
              dot[g] = __fmaf_rn(q4.x, kf[e4], dot[g]);
              dot[g] = __fmaf_rn(q4.y, kf[e4 + 1], dot[g]);
              dot[g] = __fmaf_rn(q4.z, kf[e4 + 2], dot[g]);
              dot[g] = __fmaf_rn(q4.w, kf[e4 + 3], dot[g]);
            }
          }
        }
      }
      // the lane group's sum: the heads' shuffles of a level run together
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        if ((1 << i) < lpp) {
#pragma unroll
          for (int g = 0; g < HB; ++g)
            dot[g] = __fadd_rn(dot[g], __shfl_xor_sync(DA_FULL, dot[g], 1 << i));
        }
      }

      // online softmax over the warp's positions: one max per head and
      // tile, one warp-uniform branch when any head's max rises
      float mt[HB];
#pragma unroll
      for (int g = 0; g < HB; ++g) {
        dot[g] = valid ? dot[g] : -CUDART_INF_F;
        mt[g] = dot[g];
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        if ((1 << i) >= lpp) {
#pragma unroll
          for (int g = 0; g < HB; ++g)
            mt[g] = fmaxf(mt[g], __shfl_xor_sync(DA_FULL, mt[g], 1 << i));
        }
      }
      bool rise = false;
#pragma unroll
      for (int g = 0; g < HB; ++g) rise |= mt[g] > m[g];
      if (rise) {  // rescale what came before (alpha 1 where the max held)
#pragma unroll
        for (int g = 0; g < HB; ++g) {
          const float mx = fmaxf(m[g], mt[g]);
          const float alpha = exp2f(__fsub_rn(m[g], mx));  // 0 from -inf
          l[g] = __fmul_rn(l[g], alpha);
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[g][c] = __fmul_rn(acc[g][c], alpha);
          m[g] = mx;
        }
      }
      float pr[HP];
#pragma unroll
      for (int g = 0; g < HP; ++g) pr[g] = 0.0f;
#pragma unroll
      for (int g = 0; g < HB; ++g) {
        pr[g] = valid ? exp2f(__fsub_rn(dot[g], m[g])) : 0.0f;
        l[g] = __fadd_rn(l[g], part == 0 ? pr[g] : 0.0f);
      }
      float* pw = ps + warp * P * HP;
      if (part == 0) {
#pragma unroll
        for (int g4 = 0; g4 < HP; g4 += 4)
          *reinterpret_cast<float4*>(pw + pos * HP + g4) =
              make_float4(pr[g4], pr[g4 + 1], pr[g4 + 2], pr[g4 + 3]);
      }
      __syncwarp();

      // p.v: the lane's CPL components of each of the warp's rows of V
      if (cl < DV) {
        const int nt = np - tw < P ? np - tw : P;
#pragma unroll 4
        for (int u = 0; u < nt; ++u) {
          float pv[HP];
#pragma unroll
          for (int g4 = 0; g4 < HP; g4 += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(pw + u * HP + g4);
            pv[g4] = w4.x;
            pv[g4 + 1] = w4.y;
            pv[g4 + 2] = w4.z;
            pv[g4 + 3] = w4.w;
          }
          float vf[CPL];
          load_v<TKV, CPL>(vs + (tw + u) * DV, cl, DV, vf);
#pragma unroll
          for (int g = 0; g < HB; ++g) {
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[g][c] = __fmaf_rn(pv[g], vf[c], acc[g][c]);
          }
        }
      }
      __syncwarp();  // the weights are rewritten next tile
    }
    cp_async_wait<0>();

    // each warp's sum of weights (lanes of part 0 hold one position's each)
#pragma unroll
    for (int g = 0; g < HB; ++g) {
#pragma unroll
      for (int o = 16; o; o >>= 1) l[g] += __shfl_xor_sync(DA_FULL, l[g], o);
    }
    __syncthreads();  // every warp is done with the ring: it takes the warps' sums
    float* wacc = reinterpret_cast<float*>(smem);  // [DA_WARPS][HB][DV]
#pragma unroll
    for (int g = 0; g < HB; ++g) {
      if (lane == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < CPL; c += 4) {
        if (cl + c < DV) {
#pragma unroll
          for (int i = 0; i < 4; ++i) wacc[(warp * HB + g) * DV + cl + c + i] = acc[g][c + i];
        }
      }
    }
    __syncthreads();

    // this block's piece of the segment, one (head, component) item a
    // thread at a time; a segment wholly in this block is written out
    const bool whole = a == 0 && e == n;
    const int piece = blockIdx.x + seg;  // pieces are numbered along the positions
    float* pm = part_ml + (int64_t)piece * 2 * HB;  // m[HB] then l[HB]
    float* pa = part_acc + (int64_t)piece * items;
    for (int i = tid; i < items; i += DA_THREADS) {
      const int g = i / DV, c = i - g * DV;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < DA_WARPS; ++w) mx = fmaxf(mx, red_m[w][g]);
      float L = 0.0f, A = 0.0f;
#pragma unroll
      for (int w = 0; w < DA_WARPS; ++w) {
        const float wt = rescale(red_m[w][g], mx);
        L += red_l[w][g] * wt;
        A += wacc[(w * HB + g) * DV + c] * wt;
      }
      if (whole) {
        outp[i] = __fdiv_rn(A, fmaxf(L, 1e-30f));
      } else {
        pa[i] = A;
        if (c == 0) {
          pm[g] = mx;
          pm[HB + g] = L;
        }
      }
    }
    if (!whole) {
      // the last block of the segment to finish combines its pieces: those
      // of blocks first .. last
      int first = (int)(seg0 / W), last = (int)((seg0 + n - 1) / W);
      if (chunked) {
        const int cb = chunk_at[b + 1] - chunk_at[b];
        first = chunk_at[b] * HN + j * cb;
        last = first + cb - 1;
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) is_last = atomicAdd(tickets + seg, 1) == last - first;
      __syncthreads();
      if (is_last) {
        __threadfence();
        if (tid == 0) tickets[seg] = 0;  // ready for the next call
        const int n_p = last - first + 1;
        const float* pm0 = part_ml + (int64_t)(first + seg) * 2 * HB;
        const float* pa0 = part_acc + (int64_t)(first + seg) * items;
        for (int g = warp; g < HB; g += DA_WARPS) {  // common max and sum of a head
          float mx = -CUDART_INF_F;
          for (int s = lane; s < n_p; s += 32) mx = fmaxf(mx, __ldcg(pm0 + s * 2 * HB + g));
#pragma unroll
          for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(DA_FULL, mx, o));
          float L = 0.0f;
          for (int s = lane; s < n_p; s += 32)
            L += __ldcg(pm0 + s * 2 * HB + HB + g) * rescale(__ldcg(pm0 + s * 2 * HB + g), mx);
#pragma unroll
          for (int o = 16; o; o >>= 1) L += __shfl_xor_sync(DA_FULL, L, o);
          if (lane == 0) {
            red_m[0][g] = mx;
            red_l[0][g] = L;
          }
        }
        __syncthreads();
        for (int i = tid; i < items; i += DA_THREADS) {
          const int g = i / DV;
          const float mx = red_m[0][g];
          float A = 0.0f;
          for (int s0 = 0; s0 < n_p; s0 += 8) {
            float ms[8], as[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {  // the batch's loads first
              const int s = s0 + u;
              ms[u] = s < n_p ? __ldcg(pm0 + s * 2 * HB + g) : -CUDART_INF_F;
              as[u] = s < n_p ? __ldcg(pa0 + s * items + i) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) A += as[u] * rescale(ms[u], mx);
          }
          outp[i] = __fdiv_rn(A, fmaxf(red_l[0][g], 1e-30f));
        }
      }
    }
    __syncthreads();  // the ring, qs and red_* are reused by the next segment
  }
}

// dynamic shared bytes of a block: the ring (or the warps' sums, if
// larger), the query heads, the softmax weights, the row offsets
template <typename TKV, int HB>
static int shared_bytes(const Geometry& gm) {
  constexpr int HP = (HB + 3) & ~3;
  const int ring = DA_STAGES * gm.tp * (gm.kpitch + gm.DV * (int)sizeof(TKV));
  const int merge = DA_WARPS * HB * gm.DV * (int)sizeof(float);
  return (ring > merge ? ring : merge) +
         (int)sizeof(float) * (HB * gm.D + DA_WARPS * (32 / gm.lpp) * HP) +
         (int)sizeof(int) * 2 * (gm.B + 1);
}

template <typename TKV, int CPL, int HB>
static int launch(const void* q, const void* k, const void* v, const int* kv_len,
                  const Geometry& gm, int n_blocks, float* part_ml, float* part_acc,
                  int* tickets, float* out, cudaStream_t stream) {
  const int smem = shared_bytes<TKV, HB>(gm);
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<TKV, CPL, HB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_attn_kernel<TKV, CPL, HB><<<n_blocks, DA_THREADS, smem, stream>>>(
      q, (const TKV*)k, (const TKV*)v, kv_len, gm, part_ml, part_acc, tickets, out);
  return (int)cudaGetLastError();
}

template <typename TKV, int CPL, int HB>
static int occupancy(const Geometry& gm) {
  const int smem = shared_bytes<TKV, HB>(gm);
  if (cudaFuncSetAttribute(decode_attn_kernel<TKV, CPL, HB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decode_attn_kernel<TKV, CPL, HB>,
                                                    DA_THREADS, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// the (CPL, HB) instances: kernels/decode_attn.py::INSTANCES.  n_blocks < 0
// asks for the blocks of that instance an SM holds at once
template <typename TKV>
static int dispatch(int cpl, int hb, const void* q, const void* k, const void* v,
                    const int* kv_len, const Geometry& gm, int n_blocks, float* part_ml,
                    float* part_acc, int* tickets, float* out, cudaStream_t s) {
#define DA_CASE(CPL_, HB_)                                                         \
  if (cpl == CPL_ && hb == HB_)                                                    \
    return n_blocks < 0 ? occupancy<TKV, CPL_, HB_>(gm)                            \
                        : launch<TKV, CPL_, HB_>(q, k, v, kv_len, gm, n_blocks,    \
                                                 part_ml, part_acc, tickets, out, s);
  DA_CASE(4, 8) DA_CASE(4, 6) DA_CASE(4, 4) DA_CASE(4, 3) DA_CASE(4, 2) DA_CASE(4, 1)
  DA_CASE(8, 4) DA_CASE(8, 2) DA_CASE(8, 1)
#undef DA_CASE
  return n_blocks < 0 ? 0 : (int)cudaErrorInvalidValue;
}

static Geometry geometry(const long long* strides, int q_bf16, int B, int H, int G, int S,
                         int D, int DV, float scale, int width, int lpp, int tp,
                         int kpitch) {
  Geometry gm;
  for (int i = 0; i < 4; ++i) gm.q[i] = strides ? strides[i] : 0;
  for (int i = 0; i < 3; ++i) {
    gm.k[i] = strides ? strides[4 + i] : 0;
    gm.v[i] = strides ? strides[7 + i] : 0;
  }
  gm.B = B;
  gm.H = H;
  gm.G = G;
  gm.S = S;
  gm.D = D;
  gm.DV = DV;
  gm.width = width;
  gm.lpp = lpp;
  gm.tp = tp;
  gm.kpitch = kpitch;
  gm.q_bf16 = q_bf16;
  gm.scale2 = scale * DA_LOG2E;
  return gm;
}

extern "C" {

int decode_attn_tile() { return DA_TILE; }
int decode_attn_stages() { return DA_STAGES; }
int decode_attn_warps() { return DA_WARPS; }

// blocks of the instance for this plan that one SM holds at once (0 if
// none)
int decode_attn_blocks_per_sm(int kv_bf16, int B, int D, int DV, int lpp, int cpl,
                              int hb, int tp, int kpitch) {
  const Geometry gm = geometry(nullptr, 0, B, 1, hb, 1, D, DV, 1.0f, 0, lpp, tp, kpitch);
  if (kv_bf16)
    return dispatch<__nv_bfloat16>(cpl, hb, nullptr, nullptr, nullptr, nullptr, gm, -1,
                                   nullptr, nullptr, nullptr, nullptr, nullptr);
  return dispatch<float>(cpl, hb, nullptr, nullptr, nullptr, nullptr, gm, -1, nullptr,
                         nullptr, nullptr, nullptr, nullptr);
}

// strides: 10 element strides, q's four, then k's and v's first three (the
// last is 1); width: positions per block (a DA_TILE multiple; 0: the
// positions shared evenly by the n_blocks); lpp, cpl, hb, tp, kpitch: the
// wrapper's kernel_plan; part_ml/part_acc: (n_blocks + B * Hkv * G / hb)
// pieces; tickets: B * Hkv * G / hb zeroed int32 counters, left zeroed
int decode_attn(const void* q, const void* k, const void* v, const int* kv_len,
                int q_bf16, int kv_bf16, int B, int H, int G, int S, int D, int DV,
                const long long* strides, float scale, int n_blocks, int width, int lpp,
                int cpl, int hb, int tp, int kpitch, float* part_ml, float* part_acc,
                int* tickets, float* out, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || DV <= 0) return 0;
  const int es = kv_bf16 ? 2 : 4;
  if ((D * es) % 16 || (DV * es) % 16 || hb <= 0 || G % hb || lpp < 2 || lpp > 32 ||
      (lpp & (lpp - 1)) || tp != DA_WARPS * 32 / lpp || DV > 32 * cpl ||
      kpitch < D * es || kpitch % 16 || n_blocks <= 0 || width < 0 || width % DA_TILE)
    return (int)cudaErrorInvalidValue;
  const Geometry gm =
      geometry(strides, q_bf16, B, H, G, S, D, DV, scale, width, lpp, tp, kpitch);
  cudaStream_t s = (cudaStream_t)stream;
  if (kv_bf16)
    return dispatch<__nv_bfloat16>(cpl, hb, q, k, v, kv_len, gm, n_blocks, part_ml,
                                   part_acc, tickets, out, s);
  return dispatch<float>(cpl, hb, q, k, v, kv_len, gm, n_blocks, part_ml, part_acc,
                         tickets, out, s);
}

}  // extern "C"
