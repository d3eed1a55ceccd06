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
// Flash-decoding in two launches.  The split kernel's grid is (n_split,
// B * Hkv): block (s, bh) takes positions [s * chunk, (s + 1) * chunk) of
// one (batch row, KV head) and stops at once when they lie at or past the
// row's kv_len (blocks past kv_len read nothing).  It stages the query
// group in shared memory once, then streams K and V through shared memory
// DA_TP = 32 positions at a time (converted to float32 on load): each of
// the G * 32 (head, position) scores is one sequential __fmaf_rn chain over
// D, times the scale; each warp keeps one head's running max and sum
// (online softmax, exp of the max-shifted scores); each thread keeps up to
// DA_MAX_ACC (head, component) accumulators of p.v in registers.  The block
// writes its unnormalised partial (m, l, acc).  The combine kernel (one
// block per (batch row, KV head)) rescales the partials to their common max
// and divides.  The wrapper sizes the split so the grid holds about four
// blocks per SM at the cache's full length.
//
// Strides are element strides of q, k, v, so the model passes its cache
// (B, S, Hkv, D) as a transposed view and nothing is copied.  q and K/V are
// float32 or bf16 each (templated); accumulation is float32.  Built with
// -fmad=false: the fused multiply-adds are the explicit ones.
//
// Bound on an H100 (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor
// cores): the bytes of K and V up to kv_len, read once (a float32 cache of
// 32,768 positions, B = 8, Hkv = 2, D = 128: 537 MB, 0.16 ms); the
// 4 * G * D operations per (row, head, position) are 12x below the byte
// time at G = 6.  This first design reads each position once from device
// memory but does not overlap the staging with the arithmetic (a barrier
// per 32 positions; several blocks per SM hide it), and its products run
// on the FMA pipe, not the tensor cores.  On an H100 80GB HBM3 at 700 W
// (chip_smoke.py): 27 us at the serving engine's shape (8 rows, ~1,560
// positions in all; bound ~1 us: launch latency), 0.70 ms over 196,000
// float32 positions (17% of the byte bound), 0.86 ms over bf16 ones (7%:
// two-byte scalar loads), where PyTorch's SDPA takes 0.10 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define DA_THREADS 256
#define DA_TP 32         // positions per shared-memory tile (one per lane)
#define DA_MAX_ACC 16    // (head, component) accumulators a thread: G * Dv <= 4096
#define DA_UNROLL 8      // loads in flight per thread while staging a tile

struct Strides {
  long long q[4], k[4], v[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// dst[i] = float(src[row(i) * s_row + col(i) * s_col]) for i < n, with
// i = row * width + col; DA_UNROLL loads issued before their stores
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* __restrict__ src,
                                      long long s_row, long long s_col, int n, int width) {
  for (int i0 = threadIdx.x; i0 < n; i0 += DA_UNROLL * DA_THREADS) {
    float r[DA_UNROLL];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int i = i0 + u * DA_THREADS;
      r[u] = i < n ? to_f(src[(i / width) * s_row + (i % width) * s_col]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int i = i0 + u * DA_THREADS;
      if (i < n) dst[(i / width) * pitch + i % width] = r[u];
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(DA_THREADS) decode_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
    const int* __restrict__ kv_len, Strides st, int H, int G, int S, int D,
    int DV, float scale, int chunk, float* __restrict__ part_ml,
    float* __restrict__ part_acc) {
  extern __shared__ float smem[];
  const int kp = D + 1;  // odd pitch: a warp reads one column of 32 rows conflict-free
  float* ks = smem;                 // [DA_TP][D + 1]
  float* vs = ks + DA_TP * kp;      // [DA_TP][DV]
  float* qs = vs + DA_TP * DV;      // [G][D]
  float* ss = qs + G * D;           // [G][DA_TP] scores, then weights
  float* m_s = ss + G * DA_TP;      // [G] running max
  float* l_s = m_s + G;             // [G] running sum
  float* a_s = l_s + G;             // [G] this tile's rescale factor

  const int split = blockIdx.x, n_split = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  int n = kv_len[b];
  n = n < 0 ? 0 : (n > S ? S : n);
  const int c0 = split * chunk;
  const int c1 = c0 + chunk < n ? c0 + chunk : n;
  const int64_t part = (int64_t)bh * n_split + split;
  float* ml = part_ml + part * 2 * G;  // m[G] then l[G]
  if (c0 >= c1) {  // no position of this row here: an empty partial
    for (int g = tid; g < G; g += DA_THREADS) {
      ml[g] = -CUDART_INF_F;
      ml[G + g] = 0.0f;
    }
    return;
  }

  stage(qs, D, q + b * st.q[0] + h * st.q[1], st.q[2], st.q[3], G * D, D);
  for (int g = tid; g < G; g += DA_THREADS) {
    m_s[g] = -CUDART_INF_F;
    l_s[g] = 0.0f;
  }
  float acc[DA_MAX_ACC];
#pragma unroll
  for (int j = 0; j < DA_MAX_ACC; ++j) acc[j] = 0.0f;
  const int gdv = G * DV;
  const int warp = tid >> 5, lane = tid & 31;
  const TKV* kb = k + b * st.k[0] + h * st.k[1];
  const TKV* vb = v + b * st.v[0] + h * st.v[1];

  for (int t0 = c0; t0 < c1; t0 += DA_TP) {
    const int nt = c1 - t0 < DA_TP ? c1 - t0 : DA_TP;
    __syncthreads();  // the last tile's readers are done; qs, m_s, l_s set
    stage(ks, kp, kb + t0 * st.k[2], st.k[2], st.k[3], nt * D, D);
    stage(vs, DV, vb + t0 * st.v[2], st.v[2], st.v[3], nt * DV, DV);
    __syncthreads();
    for (int i = tid; i < G * DA_TP; i += DA_THREADS) {
      const int g = i / DA_TP, t = i % DA_TP;
      float s = -CUDART_INF_F;
      if (t < nt) {
        const float* qr = qs + g * D;
        const float* kr = ks + t * kp;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = __fmaf_rn(qr[d], kr[d], dot);
        s = __fmul_rn(dot, scale);
      }
      ss[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += DA_THREADS / 32) {
      const float s = ss[g * DA_TP + lane];
      float mt = s;
#pragma unroll
      for (int o = 16; o; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);  // finite: position t0 is valid
      const float p = lane < nt ? expf(__fsub_rn(s, m_new)) : 0.0f;
      float ps = p;
#pragma unroll
      for (int o = 16; o; o >>= 1) ps = __fadd_rn(ps, __shfl_xor_sync(0xffffffffu, ps, o));
      ss[g * DA_TP + lane] = p;
      if (lane == 0) {
        const float alpha = m_old == -CUDART_INF_F ? 0.0f : expf(__fsub_rn(m_old, m_new));
        a_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = __fmaf_rn(l_s[g], alpha, ps);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DA_MAX_ACC; ++j) {
      const int i = tid + j * DA_THREADS;
      if (i < gdv) {
        const int g = i / DV, c = i % DV;
        const float* pr = ss + g * DA_TP;
        float sum = 0.0f;
        for (int t = 0; t < nt; ++t) sum = __fmaf_rn(pr[t], vs[t * DV + c], sum);
        acc[j] = __fmaf_rn(acc[j], a_s[g], sum);
      }
    }
  }
  float* pacc = part_acc + part * gdv;
#pragma unroll
  for (int j = 0; j < DA_MAX_ACC; ++j) {
    const int i = tid + j * DA_THREADS;
    if (i < gdv) pacc[i] = acc[j];
  }
  for (int g = tid; g < G; g += DA_THREADS) {  // m_s/l_s: last written before a barrier
    ml[g] = m_s[g];
    ml[G + g] = l_s[g];
  }
}

// out (B * Hkv, G, DV) from the n_split partials of each (row, head):
// empty partials (m = -inf) are skipped, never multiplied
__global__ void __launch_bounds__(DA_THREADS) decode_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    int n_split, int G, int DV, float* __restrict__ out) {
  const int bh = blockIdx.x;
  const int gdv = G * DV;
  const float* ml = part_ml + (int64_t)bh * n_split * 2 * G;
  const float* pacc = part_acc + (int64_t)bh * n_split * gdv;
  for (int i = threadIdx.x; i < gdv; i += DA_THREADS) {
    const int g = i / DV;
    float mx = -CUDART_INF_F;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[s * 2 * G + g]);
    float l = 0.0f, a = 0.0f;
    if (mx != -CUDART_INF_F) {
      for (int s = 0; s < n_split; ++s) {
        const float m = ml[s * 2 * G + g];
        if (m == -CUDART_INF_F) continue;
        const float w = expf(__fsub_rn(m, mx));
        l = __fmaf_rn(ml[s * 2 * G + G + g], w, l);
        a = __fmaf_rn(pacc[(int64_t)s * gdv + i], w, a);
      }
    }
    out[(int64_t)bh * gdv + i] = __fdiv_rn(a, fmaxf(l, 1e-30f));
  }
}

static int smem_bytes(int G, int D, int DV) {
  return (int)sizeof(float) * (DA_TP * (D + 1) + DA_TP * DV + G * D + G * DA_TP + 3 * G);
}

template <typename TQ, typename TKV>
static int launch(const void* q, const void* k, const void* v, const int* kv_len,
                  int B, int H, int G, int S, int D, int DV, const Strides& st,
                  float scale, int chunk, int n_split, float* part_ml,
                  float* part_acc, float* out, cudaStream_t stream) {
  const int smem = smem_bytes(G, D, DV);
  cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_split_kernel<TQ, TKV><<<dim3(n_split, B * H), DA_THREADS, smem, stream>>>(
      (const TQ*)q, (const TKV*)k, (const TKV*)v, kv_len, st, H, G, S, D, DV, scale,
      chunk, part_ml, part_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * H, DA_THREADS, 0, stream>>>(part_ml, part_acc, n_split,
                                                          G, DV, out);
  return (int)cudaGetLastError();
}

extern "C" {

int decode_attn_tile() { return DA_TP; }
int decode_attn_max_acc() { return DA_MAX_ACC * DA_THREADS; }

// strides: 12 element strides, q's four then k's then v's
int decode_attn(const void* q, const void* k, const void* v, const int* kv_len,
                int q_bf16, int kv_bf16, int B, int H, int G, int S, int D, int DV,
                const long long* strides, float scale, int chunk, int n_split,
                float* part_ml, float* part_acc, float* out, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || DV <= 0) return 0;
  if (G * DV > DA_MAX_ACC * DA_THREADS) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, kv_len, B, H, G, S, D, DV, st,
                                                scale, chunk, n_split, part_ml, part_acc, out, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, k, v, kv_len, B, H, G, S, D, DV, st, scale,
                                        chunk, n_split, part_ml, part_acc, out, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, k, v, kv_len, B, H, G, S, D, DV, st, scale,
                                        chunk, n_split, part_ml, part_acc, out, s);
  return launch<float, float>(q, k, v, kv_len, B, H, G, S, D, DV, st, scale, chunk,
                              n_split, part_ml, part_acc, out, s);
}

}  // extern "C"
