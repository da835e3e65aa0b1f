// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention` (body `_kernel`) of
// src/repro/kernels/flash_attention/paged_attention.py.  For every batch
// row b and query head h:
//
//   out[b, h] = softmax_j(cap(q[b, h] . k[j] * scale)) . v[j]
//
// over the row's keys j < lens[b], where key j lives in pool block
// tables[b, j / bs] at offset j % bs, KV head h / (H / KV) (GQA), and
// cap(s) = tanh(s / logit_cap) * logit_cap when logit_cap > 0.  The
// softmax runs online in f32 across pages (running max m, sum l and
// accumulator rescaled by exp(m_prev - m_new) per page); masked keys take
// NEG_INF = -1e30 and probability 0, l is floored at 1e-30, and the
// output takes q's dtype — the TPU kernel's arithmetic.
//
// What bounds it on an H100: every owned key and value row is read once
// from device memory and used by the `group` query heads that share its
// KV head, so the K/V bytes of the owned pages set the floor (Qwen2.5-3B:
// 1 KiB of K+V per token per KV head in bf16); the operations (4 * hd per
// key per query head) are ~100x below the tensor cores' rate.  The
// design therefore reads nothing it does not need:
//   * one block per (KV head, row) holds that head's `group` query heads
//     (8 for Qwen2.5-3B's 16/2), so each K/V row is read once per block
//     and reused by all of them;
//   * the block walks only the row's ceil(len / bs) owned pages — pages
//     past the length contribute nothing, so skipping them changes no
//     result — with 16-byte loads of the hd-long rows (8 bf16 or 4 f32);
//   * scores, the online softmax and the accumulator stay in shared
//     memory; only q, the owned K/V rows, the table row and out move.
// Rows run in parallel blocks but the pages of one row run in order in
// one block: a long row on a small batch leaves most SMs idle.  Splitting
// a row's pages across blocks (with a second reduction pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// elements per 16-byte load
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* src,
                                         float* dst) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

size_t smem_bytes(int group, int hd, int bs) {
  return sizeof(float) * ((size_t)bs * (hd + 1) + (size_t)bs * hd +
                          2 * (size_t)group * hd + (size_t)group * bs +
                          3 * (size_t)group);
}

// q, out (B, H, hd); pools (NB, bs, KV, hd); tables (B, P); lens (B,).
// grid (KV, B), THREADS threads, smem_bytes(group, hd, bs) shared bytes.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lens, TQ* __restrict__ out,
                    int H, int KV, int hd, int bs, int P, float scale,
                    float logit_cap) {
  extern __shared__ __align__(16) float sm[];
  const int group = H / KV;
  const int kstride = hd + 1;                 // odd stride: no bank conflicts
  float* k_s = sm;                            // bs x (hd + 1)
  float* v_s = k_s + bs * kstride;            // bs x hd
  float* q_s = v_s + bs * hd;                 // group x hd
  float* acc = q_s + group * hd;              // group x hd
  float* p_s = acc + group * hd;              // group x bs
  float* m_s = p_s + group * bs;              // group
  float* l_s = m_s + group;                   // group
  float* a_s = l_s + group;                   // group

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lens[b];
  const int n_pages = min((len + bs - 1) / bs, P);
  const size_t head0 = (size_t)b * H + (size_t)kvh * group;

  for (int i = tid; i < group * hd; i += THREADS) {
    q_s[i] = to_f32(q[head0 * hd + i]);
    acc[i] = 0.f;
  }
  if (tid < group) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  constexpr int VEC = Vec<TKV>::N;
  const int vec_per_row = hd / VEC;
  for (int pg = 0; pg < n_pages; ++pg) {
    const size_t blk = (size_t)tables[(size_t)b * P + pg];
    for (int i = tid; i < bs * vec_per_row; i += THREADS) {
      const int j = i / vec_per_row;
      const int c = (i - j * vec_per_row) * VEC;
      const size_t off = ((blk * bs + j) * KV + kvh) * (size_t)hd + c;
      float t[VEC];
      load_vec(k_pool + off, t);
#pragma unroll
      for (int u = 0; u < VEC; ++u) k_s[j * kstride + c + u] = t[u];
      load_vec(v_pool + off, t);
#pragma unroll
      for (int u = 0; u < VEC; ++u) v_s[j * hd + c + u] = t[u];
    }
    __syncthreads();

    // scores of this page: (group, bs)
    for (int i = tid; i < group * bs; i += THREADS) {
      const int g = i / bs;
      const int j = i - g * bs;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + j * kstride;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (logit_cap > 0.f) s = tanhf(s / logit_cap) * logit_cap;
      p_s[i] = pg * bs + j < len ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax, one thread per query head
    if (tid < group) {
      float* ps = p_s + tid * bs;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int j = 0; j < bs; ++j) m_new = fmaxf(m_new, ps[j]);
      float sum = 0.f;
      for (int j = 0; j < bs; ++j) {
        // masked keys get exactly zero weight (a fully masked page would
        // otherwise give exp(0) = 1)
        const float p = pg * bs + j < len ? expf(ps[j] - m_new) : 0.f;
        ps[j] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < group * hd; i += THREADS) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* ps = p_s + g * bs;
      float a = acc[i] * a_s[g];
      for (int j = 0; j < bs; ++j) a = fmaf(ps[j], v_s[j * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * hd; i += THREADS) {
    const float l = fmaxf(l_s[i / hd], 1e-30f);
    store(acc[i] / l, out + head0 * hd + i);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int32_t* tables, const int32_t* lens, void* out, int B,
           int H, int KV, int hd, int bs, int P, float scale,
           float logit_cap, void* stream) {
  const size_t smem = smem_bytes(H / KV, hd, bs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(KV, B);
  paged_decode_kernel<TQ, TKV><<<grid, THREADS, smem,
                                 (cudaStream_t)stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), tables, lens, static_cast<TQ*>(out),
      H, KV, hd, bs, P, scale, logit_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// q and out (B, H, hd) of q_dtype, pools (NB, bs, KV, hd) of kv_dtype
// (dtype codes: 0 float32, 1 bfloat16), 16-byte aligned; tables (B, P)
// int32 block ids; lens (B,) int32 valid keys per row.  H % KV == 0,
// hd % 8 == 0 and hd <= 256.  All pointers are on the device; launches on
// `stream` and returns cudaGetLastError().
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const int32_t* tables,
                                      const int32_t* lens, void* out,
                                      int q_dtype, int kv_dtype, int B,
                                      int H, int KV, int hd, int bs, int P,
                                      float scale, float logit_cap,
                                      void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd % 8 != 0 ||
      hd > 256 || bs <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const int code = q_dtype * 2 + kv_dtype;
  switch (code) {
    case 0:
      return launch<float, float>(q, k_pool, v_pool, tables, lens, out, B, H,
                                  KV, hd, bs, P, scale, logit_cap, stream);
    case 1:
      return launch<float, bf16>(q, k_pool, v_pool, tables, lens, out, B, H,
                                 KV, hd, bs, P, scale, logit_cap, stream);
    case 2:
      return launch<bf16, float>(q, k_pool, v_pool, tables, lens, out, B, H,
                                 KV, hd, bs, P, scale, logit_cap, stream);
    case 3:
      return launch<bf16, bf16>(q, k_pool, v_pool, tables, lens, out, B, H,
                                KV, hd, bs, P, scale, logit_cap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
