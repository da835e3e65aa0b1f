// Error-configurable approx-MAC GEMMs for Hopper (sm_90a).
//
// Replaces three TPU kernels of src/repro/kernels/approx_mac/approx_mac.py,
// all from ONE kernel body templated on the activation type, the epilogue
// and an expert axis:
//
//   approx_mac_fused_matmul (body `_fused_kernel`), TA = float, TOut = float:
//     out[m, n] = float(sum_k ta(q(x[m, k])) * tb(w[k, n])) * scale_row[n]
//     where q is the in-kernel dynamic int8 quantization
//     clip(round_half_even(x / x_scale), +-127) with an IEEE divide;
//   approx_mac_matmul (body `_kernel`), TA = int8, TOut = int32:
//     out[m, n] = sum_k ta(a[m, k]) * tb(w[k, n])     (int32)
//   approx_mac_grouped_matmul (body `_grouped_kernel`, approx_mac.py:326),
//     the fused instance with GROUPED = true: E fused GEMMs in one launch,
//     blockIdx.z = expert e, each with its own (M, K) activations, (K, N)
//     int8 bank slice, (N,) combined scales and (n_blocks, 4) config rows,
//     one shared x_scale; rows at index >= group_rows[e] are absent (their
//     outputs are zero) and a tile with no present row writes zeros and
//     returns before it reads a weight byte.
//
// ta/tb truncate operand LSBs with the (depth_a, depth_b, gate, rtn) row of
// the output column's config block: cfg[(n / cfg_bn) * cfg_stride + 0..3]
// (grouped: from cfg + e * cfg_expert_stride).  The config rows and the
// row counts are device data read at run time, so one compiled kernel
// serves all 32 configs and any per-block or per-expert mix (the knob
// stays data).
//
// What bounds it on an H100: at decode (M = 4) every weight byte is read
// once and used for 4 MACs, so the int8 weight bytes set the floor — one
// Qwen2.5-3B layer's seven GEMMs read 77,070,336 B, about 2.77 GB per
// decode step over 36 layers, ~0.83 ms at 3.35 TB/s — while the int8
// operations at M = 4 take ~11 us at 1,979 TOPS.  The paper MLP's GEMMs
// (M = 10,000, K = 62/30, N = 30/10) are bound by the activation and
// output bytes.  The grouped GEMMs of an OLMoE-1B-7B decode step (4 slots,
// top-8 of 64 experts) are bound by the bank bytes of the experts the
// step's tokens touch: about 27 of 64, so ~170 MB per layer (gate, up,
// down) and ~2.7 GB per step over 16 layers, ~0.8 ms; reading every
// expert's bank would be 6.44 GB, ~1.9 ms.
// The design spends nothing on tensor cores and everything on streaming W:
//   * one block owns BM = 4 output rows x BN = 32 columns, so a
//     2048 x 11008 GEMM runs 344 blocks; each of its 256 threads streams
//     one 8-byte weight row segment per k-step (a warp reads 8 rows x 32
//     contiguous bytes, whole 32-byte sectors) with several loads in
//     flight, and the block's 64 k-lanes are summed at the end;
//   * truncation of either operand is one lookup in a 256-entry table
//     the block builds from its config row, so the knob costs one
//     shared-memory load per weight byte and no extra device-memory bytes;
//   * the block's activation rows are quantized (float input) and
//     truncated once into shared memory (int8, 4 x K bytes) and reused for
//     all its columns;
//   * grouped: the expert is a grid dimension, and a tile past its
//     expert's row count exits at once, so an expert no token was routed
//     to costs a launch slot per tile and no weight bytes, and a touched
//     expert's bank is read by its filled m-blocks only;
//   * products of int8 magnitudes <= 128 accumulate exactly in int32 in
//     any order, so the k-lane split changes no bit.
// A tensor-core (wgmma) version with TMA-fed pipelines is later work; so
// is reading a touched bank once for all its m-blocks (each m-block of
// 4 rows streams the expert's columns again, from L2 where they fit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 4;                               // output rows per block
constexpr int BN = 32;                              // output columns per block
constexpr int THREADS = 256;
constexpr int COLS = 8;                             // columns per thread
constexpr int COL_GROUPS = BN / COLS;               // 4
constexpr int K_LANES = THREADS / COL_GROUPS;       // 64
constexpr int WARPS = THREADS / 32;                 // 8
constexpr int UNROLL = 4;                           // weight loads in flight
constexpr int LUT_BYTES = 2 * 256 * sizeof(int);
constexpr int RED_BYTES = WARPS * COL_GROUPS * BM * COLS * sizeof(int);

// repro.core.quantization.truncate_operand_lsb on one int8 value: depth 0
// is a strict identity (even for -128), magnitudes below the gate pass
// through, round-to-nearest clamps the magnitude at 127.
__device__ __forceinline__ int truncate_operand(int v, int depth, int gate,
                                                int rtn) {
  const int mag = v < 0 ? -v : v;
  if (depth <= 0 || mag < gate) return v;
  const int low_mask = (1 << depth) - 1;
  int tmag;
  if (rtn) {
    tmag = min((mag + (1 << (depth - 1))) & ~low_mask, 127);
  } else {
    tmag = mag & ~low_mask;
  }
  return v < 0 ? -tmag : tmag;
}

// LUT index of an activation: float inputs are quantized first.
__device__ __forceinline__ int activation_index(float x, float s) {
  float v = rintf(__fdiv_rn(x, s));
  v = fminf(fmaxf(v, -127.f), 127.f);
  return (int)v + 128;
}
__device__ __forceinline__ int activation_index(int8_t a, float) {
  return (int)a + 128;
}

__device__ __forceinline__ void store(float* out, size_t i, int sum,
                                      const float* scale_row, int n) {
  out[i] = (float)sum * scale_row[n];
}
__device__ __forceinline__ void store(int32_t* out, size_t i, int sum,
                                      const float*, int) {
  out[i] = sum;
}

// TA: float (quantized in-kernel with x_scale) or int8_t (used as is);
// TOut: float (scaled by scale_row) or int32_t (the raw accumulator);
// GROUPED: blockIdx.z is the expert, which offsets a, w, scale_row, out
// and cfg, and rows at index >= group_rows[e] are absent.
template <typename TA, typename TOut, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
approx_mac_kernel(const TA* __restrict__ a, const int8_t* __restrict__ w,
                  const float* __restrict__ scale_row,
                  const float* __restrict__ x_scale,
                  const int32_t* __restrict__ cfg, int cfg_stride,
                  int cfg_bn, const int32_t* __restrict__ group_rows,
                  int cfg_expert_stride, TOut* __restrict__ out, int M,
                  int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lut_a = reinterpret_cast<int*>(smem);
  int* lut_b = lut_a + 256;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + LUT_BYTES);   // BM x K
  int* red = reinterpret_cast<int*>(smem + LUT_BYTES);        // reuses xs

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  int rows = M;                       // rows present in this GEMM
  if constexpr (GROUPED) {
    const size_t e = blockIdx.z;
    a += e * M * K;
    w += e * K * N;
    scale_row += e * N;
    out += e * M * N;
    cfg += e * cfg_expert_stride;
    rows = min(M, max(group_rows[e], 0));
    if (m0 >= rows) {
      // no present row in this tile: zeros, what the MAC of its
      // (absent, zero) rows would give, and no weight byte read
      if (tid < BM * BN) {
        const int m = tid / BN, n = tid % BN;
        if (m0 + m < M && n0 + n < N)
          out[(size_t)(m0 + m) * N + n0 + n] = (TOut)0;
      }
      return;
    }
  }

  // this block's columns lie inside one config block (cfg_bn % BN == 0)
  const int32_t* c = cfg + (size_t)(n0 / cfg_bn) * cfg_stride;
  const int depth_a = c[0], depth_b = c[1], gate = c[2], rtn = c[3];
  // LUT index of int8 value v is v + 128 (THREADS == 256 entries)
  lut_a[tid] = truncate_operand(tid - 128, depth_a, gate, rtn);
  lut_b[tid] = truncate_operand(tid - 128, depth_b, gate, rtn);
  __syncthreads();

  // quantize (float input) + truncate this block's activation rows once
  const float s = x_scale != nullptr ? x_scale[0] : 1.f;
  for (int i = tid; i < BM * K; i += THREADS) {
    const int m = i / K;
    const int k = i - m * K;
    int q = 0;
    if (m0 + m < rows)
      q = lut_a[activation_index(a[(size_t)(m0 + m) * K + k], s)];
    xs[i] = (int8_t)q;
  }
  __syncthreads();

  const int cg = tid % COL_GROUPS;
  const int kl = tid / COL_GROUPS;
  const int8_t* wp = w + n0 + cg * COLS;
  int acc[BM][COLS];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0;

  for (int k = kl; k < K; k += K_LANES * UNROLL) {
    uint2 p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int kk = k + u * K_LANES;
      p[u] = kk < K
          ? __ldg(reinterpret_cast<const uint2*>(wp + (size_t)kk * N))
          : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int kk = k + u * K_LANES;
      if (kk >= K) break;
      int wt[COLS];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte b as int8 v has LUT index v + 128 == b ^ 0x80
        wt[j] = lut_b[((p[u].x >> (8 * j)) & 0xffu) ^ 0x80u];
        wt[j + 4] = lut_b[((p[u].y >> (8 * j)) & 0xffu) ^ 0x80u];
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int av = xs[m * K + kk];
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[m][j] += av * wt[j];
      }
    }
  }

  // sum the k-lanes: first the 8 lanes of a warp that share a column
  // group (lane bits 2..4), then the 8 warps through shared memory
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      int v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  __syncthreads();   // every thread is done reading xs
  const int warp = tid / 32, lane = tid % 32;
  if (lane < COL_GROUPS) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        red[((warp * COL_GROUPS + lane) * BM + m) * COLS + j] = acc[m][j];
  }
  __syncthreads();
  if (tid < BM * BN) {
    const int m = tid / BN, n = tid % BN;
    const int g = n / COLS, j = n % COLS;
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi)
      sum += red[((wi * COL_GROUPS + g) * BM + m) * COLS + j];
    if (m0 + m < M && n0 + n < N)
      store(out, (size_t)(m0 + m) * N + n0 + n, sum, scale_row, n0 + n);
  }
}

template <typename TA, typename TOut, bool GROUPED>
int launch(const TA* a, const int8_t* w, const float* scale_row,
           const float* x_scale, const int32_t* cfg, int cfg_stride,
           int cfg_bn, const int32_t* group_rows, int cfg_expert_stride,
           TOut* out, int E, int M, int K, int N, void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || K <= 0 || N <= 0 || N % BN != 0 ||
      cfg_bn <= 0 || cfg_bn % BN != 0 || (M + BM - 1) / BM > 65535 ||
      (GROUPED && group_rows == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t xs_bytes = (size_t)BM * K;
  const size_t smem = LUT_BYTES + (xs_bytes > RED_BYTES ? xs_bytes
                                                        : (size_t)RED_BYTES);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        approx_mac_kernel<TA, TOut, GROUPED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(N / BN, (M + BM - 1) / BM, E);
  approx_mac_kernel<TA, TOut, GROUPED>
      <<<grid, THREADS, smem, (cudaStream_t)stream>>>(
          a, w, scale_row, x_scale, cfg, cfg_stride, cfg_bn, group_rows,
          cfg_expert_stride, out, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32, w (K, N) int8 with N % 32 == 0 and 8-byte aligned rows,
// scale_row (N,) f32 = x_scale * w_scale rounded once by the caller,
// x_scale (1,) f32, cfg rows of (depth_a, depth_b, gate, rtn) int32 with
// row stride cfg_stride (0 broadcasts one row), cfg_bn the logical config
// block width (a multiple of 32), out (M, N) f32.  All pointers are on the
// device; launches on `stream` and returns cudaGetLastError().
extern "C" int approx_mac_fused_matmul(const float* x, const int8_t* w,
                                       const float* scale_row,
                                       const float* x_scale,
                                       const int32_t* cfg, int cfg_stride,
                                       int cfg_bn, float* out, int M, int K,
                                       int N, void* stream) {
  return launch<float, float, false>(x, w, scale_row, x_scale, cfg,
                                     cfg_stride, cfg_bn, nullptr, 0, out, 1,
                                     M, K, N, stream);
}

// a (M, K) int8, w (K, N) int8 with N % 32 == 0 and 8-byte aligned rows,
// cfg / cfg_stride / cfg_bn as above, out (M, N) int32.
extern "C" int approx_mac_matmul(const int8_t* a, const int8_t* w,
                                 const int32_t* cfg, int cfg_stride,
                                 int cfg_bn, int32_t* out, int M, int K,
                                 int N, void* stream) {
  return launch<int8_t, int32_t, false>(a, w, nullptr, nullptr, cfg,
                                        cfg_stride, cfg_bn, nullptr, 0, out,
                                        1, M, K, N, stream);
}

// x (E, M, K) f32, w (E, K, N) int8 with N % 32 == 0 and 8-byte aligned
// rows, scale_rows (E, N) f32 = x_scale * w_scale[e] rounded once by the
// caller, x_scale (1,) f32 shared by every expert, group_rows (E,) int32
// rows present per expert, cfg rows of expert e's config block i at
// cfg + e * cfg_expert_stride + i * cfg_stride, cfg_bn as above, out
// (E, M, N) f32 (every element written: absent rows get zeros).
extern "C" int approx_mac_grouped_matmul(const float* x, const int8_t* w,
                                         const float* scale_rows,
                                         const float* x_scale,
                                         const int32_t* group_rows,
                                         const int32_t* cfg,
                                         int cfg_expert_stride,
                                         int cfg_stride, int cfg_bn,
                                         float* out, int E, int M, int K,
                                         int N, void* stream) {
  return launch<float, float, true>(x, w, scale_rows, x_scale, cfg,
                                    cfg_stride, cfg_bn, group_rows,
                                    cfg_expert_stride, out, E, M, K, N,
                                    stream);
}
