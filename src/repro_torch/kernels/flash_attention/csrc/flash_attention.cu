// Flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` (body `_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py, reached through
// `ops.flash_attn`.  For batch row b, query head h and query i:
//
//   out[b, i, h] = sum_j p_ij v[b, j, h / (H / KV)] / max(sum_j p_ij, 1e-30)
//   s_ij = cap(q[b, i, h] . k[b, j, h / (H / KV)] * scale)
//   p_ij = visible(i, j) ? exp(s_ij - m_i) : 0
//
// with cap(s) = tanh(s / logit_cap) * logit_cap when logit_cap > 0, the
// query at key position i + (Skv - Sq) (the causal mask is aligned for
// decode offsets), and key j visible when j < Skv, j <= that position
// (causal) and j > that position - window (window > 0).  The softmax runs
// online in f32 over key tiles: running max m, sum l and accumulator
// rescaled by exp(m_prev - m_new) per tile; masked probabilities are
// exactly 0, so a row with no visible key gives 0 — the TPU kernel's
// arithmetic, with expf/tanhf and IEEE divides.
//
// What bounds it on an H100: at prefill lengths the work is 4 * hd
// operations per visible (query, key) pair per head, while each q, k, v
// and out byte moves once; at Gemma-2's hd 128 that is ~100 operations
// per byte at S 1024 and more beyond, so the operations bound it.  This
// first version runs them in f32 on the CUDA cores (67 TFLOP/s peak), not
// on the tensor cores (989 TFLOP/s in bf16): wgmma, TMA and bf16 p are
// later perf work.  The design:
//   * one block per (query tile of BQ = 64 rows, query head, batch row);
//     256 threads as 16 x 16, thread (ty, tx) owns rows ty + 16 r (r < 4),
//     keys tx + 16 c (c < 4) of the scores and column pairs 2 tx + 32 c of
//     the output, so each thread keeps 16 scores and up to 64 accumulators
//     in registers;
//   * the q tile and each BK = 64-key tile of K and V are staged through
//     shared memory in the input dtype (16-byte loads, rows padded by two
//     elements so the score loop reads without bank conflicts); scores,
//     probabilities and the accumulator are f32;
//   * tiles wholly outside the causal or window range are skipped (they
//     would add exactly zero; the TPU kernel iterates over them);
//   * deterministic: no atomics, and every sum runs in one fixed order (a
//     row's 16 lanes reduce by one xor butterfly, which gives all lanes
//     the same bits).
// GQA blocks of one KV head read the same K/V tiles, from L2 after the
// first; one block per query head keeps the kernel simple.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int RPT = BQ / 16;   // rows per thread
constexpr int KPT = BK / 16;   // keys per thread
constexpr int PSTR = BK + 16;  // probability tile stride: the two
                               // half-warps' rows land 16 banks apart

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

// elements per 16-byte load
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);   // round to nearest even, as torch's cast
}

template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p) {
  return to_f2(*reinterpret_cast<const typename Pair<T>::type*>(p));
}

// Stage 64 rows of hd elements (row r at src + r * src_stride) into
// shared memory (row stride sstr); rows >= valid are zero.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int sstr, const T* src,
                                      size_t src_stride, int valid, int hd) {
  using P = typename Pair<T>::type;
  constexpr int V = Vec<T>::N;
  const int vpr = hd / V;
  for (int i = threadIdx.x; i < 64 * vpr; i += THREADS) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * V;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      raw = __ldg(reinterpret_cast<const uint4*>(src + r * src_stride + c));
    const P* pairs = reinterpret_cast<const P*>(&raw);
    P* d = reinterpret_cast<P*>(dst + r * sstr + c);
#pragma unroll
    for (int u = 0; u < V / 2; ++u) d[u] = pairs[u];
  }
}

template <typename T>
size_t smem_bytes(int hd) {
  return (size_t)(BQ + 2 * BK) * (hd + 2) * sizeof(T) +
         (size_t)BQ * PSTR * sizeof(float);
}

// q, out (B, Sq, H, hd); k, v (B, Skv, KV, hd); grid (ceil(Sq / BQ), H,
// B), THREADS threads, smem_bytes<T>(hd) shared bytes.  NCP column pairs
// per thread cover hd <= 32 * NCP.
template <typename T, int NCP>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int KV, int hd, float scale, float logit_cap, int causal,
             int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sstr = hd + 2;
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + BQ * sstr;
  T* v_s = k_s + BK * sstr;
  float* p_s = reinterpret_cast<float*>(v_s + BK * sstr);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int offset = Skv - Sq;       // query i sits at key position i + offset
  const size_t q_step = (size_t)H * hd;
  const size_t kv_step = (size_t)KV * hd;
  const T* qb = q + ((size_t)b * Sq * H + h) * hd;
  const T* kb = k + ((size_t)b * Skv * KV + kvh) * hd;
  const T* vb = v + ((size_t)b * Skv * KV + kvh) * hd;

  stage(q_s, sstr, qb + (size_t)q0 * q_step, q_step, min(BQ, Sq - q0), hd);

  // the keys any row of this tile can see
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + BQ, Sq) + offset);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + offset - window + 1);

  float m[RPT], l[RPT], acc[RPT][2 * NCP];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * NCP; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int nk = min(BK, Skv - k0);
    __syncthreads();   // the last tile's reads are done (and q_s staged)
    stage(k_s, sstr, kb + (size_t)k0 * kv_step, kv_step, nk, hd);
    stage(v_s, sstr, vb + (size_t)k0 * kv_step, kv_step, nk, hd);
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < KPT; ++c) s[r][c] = 0.f;
    for (int d = 0; d < hd; d += 2) {
      float2 qv[RPT], kv[KPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        qv[r] = load_pair(q_s + (ty + 16 * r) * sstr + d);
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        kv[c] = load_pair(k_s + (tx + 16 * c) * sstr + d);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
          s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
        }
    }

    // mask, softcap and the online softmax, one row at a time; a row's 16
    // lanes (one half-warp) reduce its max and sum by xor butterflies
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qpos = q0 + ty + 16 * r + offset;
      bool vis[KPT];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (logit_cap > 0.f) x = tanhf(x / logit_cap) * logit_cap;
        vis[c] = kpos < Skv && (!causal || kpos <= qpos) &&
                 (window <= 0 || kpos > qpos - window);
        s[r][c] = vis[c] ? x : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        // masked keys get exactly zero weight (a fully masked tile would
        // otherwise give exp(0) = 1)
        const float p = vis[c] ? expf(s[r][c] - m_new) : 0.f;
        p_s[(ty + 16 * r) * PSTR + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * NCP; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      float p[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) p[r] = p_s[(ty + 16 * r) * PSTR + j];
#pragma unroll
      for (int c = 0; c < NCP; ++c) {
        const int col = 2 * tx + 32 * c;
        if (col < hd) {
          const float2 vv = load_pair(v_s + j * sstr + col);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            acc[r][2 * c] = fmaf(p[r], vv.x, acc[r][2 * c]);
            acc[r][2 * c + 1] = fmaf(p[r], vv.y, acc[r][2 * c + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= Sq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    T* o = out + (((size_t)b * Sq + qi) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NCP; ++c) {
      const int col = 2 * tx + 32 * c;
      if (col < hd) {
        store(acc[r][2 * c] / lr, o + col);
        store(acc[r][2 * c + 1] / lr, o + col + 1);
      }
    }
  }
}

template <typename T, int NCP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KV, int hd, float scale,
           float logit_cap, int causal, int window, void* stream) {
  const size_t smem = smem_bytes<T>(hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NCP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, NCP><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, hd,
      scale, logit_cap, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Skv, int H, int KV, int hd, float scale,
              float logit_cap, int causal, int window, void* stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale,
                        logit_cap, causal, window, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale,
                        logit_cap, causal, window, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale,
                        logit_cap, causal, window, stream);
  return launch<T, 8>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale, logit_cap,
                      causal, window, stream);
}

}  // namespace

// q and out (B, Sq, H, hd), k and v (B, Skv, KV, hd), all of one dtype
// (0 float32, 1 bfloat16), contiguous and 16-byte aligned.  H % KV == 0,
// hd % 8 == 0 and hd <= 256; window <= 0 means no window.  All pointers
// are on the device; launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int Sq, int Skv,
                               int H, int KV, int hd, float scale,
                               float logit_cap, int causal, int window,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd % 8 != 0 || hd > 256 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_hd<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale,
                              logit_cap, causal, window, stream);
    case 1:
      return launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd,
                                      scale, logit_cap, causal, window,
                                      stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
