// Error-configurable approx-MAC GEMMs for Hopper (sm_90a).
//
// Replaces three TPU kernels of src/repro/kernels/approx_mac/approx_mac.py:
//
//   approx_mac_fused_matmul (body `_fused_kernel`), TOut = float:
//     out[m, n] = float(sum_k ta(q(x[m, k])) * tb(w[k, n])) * scale_row[n]
//     where q is the dynamic int8 quantization clip(round_half_even(x /
//     x_scale), +-127) with an IEEE divide, in the GEMM (TA = float, M <=
//     16) or once before it (TA = int8);
//   approx_mac_matmul (body `_kernel`), TA = int8, TOut = int32:
//     out[m, n] = sum_k ta(a[m, k]) * tb(w[k, n])     (int32)
//   approx_mac_grouped_matmul (body `_grouped_kernel`, approx_mac.py:326):
//     E fused GEMMs in one launch, each expert e with its own (M, K)
//     activations, (K, N) int8 bank slice, (N,) combined scales and
//     (n_blocks, 4) config rows, one shared x_scale; rows at index >=
//     group_rows[e] are absent: their outputs are zero whatever x holds
//     there;
//   approx_mac_grouped_matmul_int, TOut = int32: the grouped GEMMs with
//     the epilogue left out (the int32 sums, zeros in absent rows), for
//     an expert bank whose contraction dim is split across ranks.
//
// ta/tb truncate operand LSBs with the (depth_a, depth_b, gate, rtn) row of
// the output column's config block: cfg[(n / cfg_bn) * cfg_stride + 0..3]
// (grouped: from cfg + e * cfg_expert_stride).  The config rows and the
// row counts are device data read at run time, so one compiled kernel
// serves all 32 configs and any per-block or per-expert mix (the knob
// stays data).  Products of int8 magnitudes <= 128 accumulate exactly in
// int32 in any order, so the tensor cores and the K split across a
// cluster of blocks change no bit.
//
// All three run one body, `mma_body`: the fused and int GEMMs as
// `approx_mac_kernel_mma`, the grouped ones as `approx_mac_kernel_grouped`.
//
// What bounds them on an H100.  At decode (M = 4) and prefill (M <= 64)
// every weight byte is used for at most 64 MACs, far below the ~590 int8
// operations per byte where the tensor cores would be the limit, so the
// int8 weight bytes set the floor: one Gemma-2-27B layer's seven GEMMs
// read 566 MB, 0.169 ms at 3.35 TB/s; an OLMoE-1B-7B decode step's expert
// GEMMs read only the banks of the experts its tokens picked.  In practice
// the floor is the instructions spent per weight byte on its way to the
// tensor cores: the truncation (~3.5 a byte), the 4 x 4 transpose and the
// shared-memory traffic, together more than the SMs issue in the time the
// bytes take to arrive.  At M in the thousands the GEMM is bound by its
// int8 operations (1,979 TOP/s).  The paper MLP (M = 10,000, K = 62 / 30,
// N = 30 / 10) is bound by launch latency.
//
// The design:
//   * a block owns BM = (8 / WN) * MT * 16 rows and BN = WN * NT * 8
//     columns with all its rows in one tile, so a GEMM of M <= 64 reads
//     every weight byte once (the earlier body re-read the weights for
//     every 4 rows of M); the host's plans (approx_mac.gemm_plan,
//     approx_mac.grouped_plan) pick the instance (MT, NT, WN) and the K
//     split from host ints;
//   * int8 `mma.sync.m16n8k32` on the tensor cores: each warp owns an
//     MT x NT grid of 16 x 8 output fragments and reads its operand
//     fragments with ldmatrix;
//   * the weights stream through a ring of cp.async stages (16 B per
//     thread, 64 k-rows a stage), so the next stages' loads overlap the
//     current stage's truncation and products;
//   * the truncation is packed-byte arithmetic on four int8 values a word
//     (sign mask by byte permute, magnitude, round and mask, clamp, gate,
//     sign back: ~14 integer instructions, no byte carries), with the
//     parameters taken from the block's config rows at run time; a table
//     lookup per byte, the first version of this body, spent two shared
//     memory wavefronts a lookup and ran the kernel at ~7 B/clk per SM;
//   * the weight pass reads 4 x 4 byte blocks of the (K, N) stage,
//     truncates them and writes the four k-consecutive bytes of each
//     column as one word of an (N, K) tile -- the layout of the mma's B
//     fragment -- with 8 byte permutes; at config depth 0 it only
//     transposes;
//   * activations: at M <= 16 a block quantizes (float) and truncates its
//     rows of its whole K slice once, into shared memory, before the loop;
//     at M > 16 the fused and grouped GEMMs first quantize x to int8 once
//     in a kernel of their own (truncating it there when one config row
//     serves every column, of the GEMM or of the expert), since every
//     column tile would otherwise divide the same rows again, and the int8
//     rows stream through the ring (the int GEMM's rows too, or are read
//     directly where K is ragged);
//   * a pass for stage k+1 and the products of stage k run between the
//     same two barriers (double-buffered staged tiles), one barrier a stage;
//   * where (M, N) tiles are fewer than 4 x 132, K is split across up to 16
//     blocks that form one thread block cluster: each leaves its int32
//     partial tile in its own shared memory and, after a cluster barrier,
//     sums a share of the tile over all of them through distributed shared
//     memory, so the split needs no global workspace, no atomics and no
//     memset, and a captured call replays as it is;
//   * the epilogue is one f32 multiply by the combined scale (fused,
//     grouped) or the raw int32 sum (int);
//   * grouped: blockIdx.y walks the experts and their row tiles; a block
//     offsets a, w, scale_row, out and cfg by its expert and reads
//     group_rows[e] on the device.  A tile with no present row writes
//     zeros and returns before it reads a weight byte, so an expert no
//     token picked costs launch slots and no bank bytes; the K splits of a
//     tile share its expert and row tile, so a cluster exits whole or not
//     at all.  Rows past the count inside a tile are neither quantized,
//     loaded nor multiplied (a warp skips its fragments past them) and are
//     stored as zeros.  The quantize kernel of M > 16 reads the present
//     rows only.
// At M 4,352 every 128-row tile streams the weights again (the x tile
// stays in L2), and its int8 rows are truncated again for each 128-column
// tile: 34 reads of the weights where one would do, which a persistent
// grid that walks the rows of one column tile could save.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                // 8 warps
constexpr int BK = 64;                      // k-rows per pipeline stage
constexpr int ST = BK + 16;                 // staged row stride (bytes):
                                            // 8 ldmatrix rows hit 8
                                            // distinct 16 B bank groups
constexpr int MAX_SUB = 8;                  // config blocks a tile spans
constexpr int MAX_SMEM = 232448;            // 227 KB a block on sm_90
constexpr int MAX_CLUSTER = 16;             // K splits: blocks a cluster

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0xff in each byte of x whose bit 7 is set, else 0 (prmt's sign
// replication: selector nibbles 8..b)
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xBA98;" : "=r"(r) : "r"(x), "r"(0u));
  return r;
}

// the low bytes of a, b, c, d as one word (a lowest)
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// repro.core.quantization.truncate_operand_lsb on the four int8 values of
// a word at once (no byte carries: every per-byte sum below stays under
// 256): magnitudes below the gate pass through, round-to-nearest clamps
// the magnitude at 127.  One config row's parameters, per byte: keep =
// ~low_mask, half = the rounding half (0 without rtn), gate4 = 0x80 - gate
// (gate >= 1; gated false for gate 0, where every magnitude truncates).
// Depth 0, a strict identity (even for -128), never gets here.
struct Trunc {
  uint32_t keep, half, gate4;
  int rtn, gated;
};

template <bool RTN, bool GATED>
__device__ __forceinline__ uint32_t trunc4(uint32_t w, const Trunc& p) {
  const uint32_t s = sign_bytes(w);                 // negative bytes
  const uint32_t one = s & 0x01010101u;
  const uint32_t mag = (w ^ s) + one;               // |v|, 0..128
  uint32_t t = (mag + p.half) & p.keep;             // <= 144
  if (RTN) {                                        // min(t, 127)
    const uint32_t c = sign_bytes(t);
    t = (t & ~c) | (0x7f7f7f7fu & c);
  }
  const uint32_t u = t ^ s;                         // -t in negative bytes:
  const uint32_t r = ((u & 0x7f7f7f7fu) + one) ^ (u & 0x80808080u);
  if (!GATED) return r;
  const uint32_t cut = sign_bytes(mag + p.gate4);   // mag >= gate
  return (r & cut) | (w & ~cut);
}

__device__ __forceinline__ uint32_t trunc4(uint32_t w, const Trunc& p) {
  if (p.rtn)
    return p.gated ? trunc4<true, true>(w, p) : trunc4<true, false>(w, p);
  return p.gated ? trunc4<false, true>(w, p) : trunc4<false, false>(w, p);
}

// trunc4 on four words that share one config row: one branch
// (uniform across the warp) for the four
__device__ __forceinline__ void trunc16(uint32_t& w0, uint32_t& w1,
                                        uint32_t& w2, uint32_t& w3,
                                        const Trunc& p) {
#define APPROX_MAC_TRUNC16(R, G)                                          \
  {                                                                       \
    w0 = trunc4<R, G>(w0, p);                                             \
    w1 = trunc4<R, G>(w1, p);                                             \
    w2 = trunc4<R, G>(w2, p);                                             \
    w3 = trunc4<R, G>(w3, p);                                             \
  }
  if (p.rtn) {
    if (p.gated) APPROX_MAC_TRUNC16(true, true)
    else APPROX_MAC_TRUNC16(true, false)
  } else {
    if (p.gated) APPROX_MAC_TRUNC16(false, true)
    else APPROX_MAC_TRUNC16(false, false)
  }
#undef APPROX_MAC_TRUNC16
}

__device__ __forceinline__ Trunc trunc_params(int depth, int gate, int rtn) {
  Trunc p;
  const uint32_t low = depth > 0 ? (1u << depth) - 1u : 0u;
  p.keep = (~low & 0xffu) * 0x01010101u;
  p.half = rtn && depth > 0 ? (1u << (depth - 1)) * 0x01010101u : 0u;
  p.gate4 = gate > 0 ? (uint32_t)(0x80 - min(gate, 128)) * 0x01010101u : 0u;
  p.rtn = rtn;
  p.gated = gate > 0;
  return p;
}

// the int8 activation byte of x quantized with scale s: clip(round half
// even(x / s), +-127) with an IEEE divide
__device__ __forceinline__ uint32_t quantize_byte(float x, float s) {
  float v = rintf(__fdiv_rn(x, s));
  v = fminf(fmaxf(v, -127.f), 127.f);
  return (uint32_t)((int)v & 0xff);
}

__device__ __forceinline__ void store2(float* out, int s0, int s1,
                                       const float* scale_row, int n) {
  *reinterpret_cast<float2*>(out) =
      make_float2((float)s0 * scale_row[n], (float)s1 * scale_row[n + 1]);
}
__device__ __forceinline__ void store2(int32_t* out, int s0, int s1,
                                       const float*, int) {
  *reinterpret_cast<int2*>(out) = make_int2(s0, s1);
}

// How the activations reach the staged tiles (int8, truncated):
//   A_SLICE  the block's whole K slice of its rows (at most SLICE_ROWS of
//            them), quantized (float) and truncated once before the loop;
//   A_RING   int8 rows, 16 B aligned, through the cp.async ring, then
//            truncated per stage into the staged tile;
//   A_READY  int8 rows already truncated (one config for every column),
//            copied by the ring straight into the staged layout (one
//            slot more than the weights', since the products read it);
//   A_DIRECT int8 rows read directly in the per-stage pass (ragged K).
enum { A_SLICE = 0, A_RING = 1, A_READY = 2, A_DIRECT = 3 };
constexpr int SLICE_ROWS = 16;

__host__ __device__ constexpr int stages_of(int mt, int nt) {
  return mt * nt >= 16 ? 3 : 4;
}
// row stride of the A_SLICE tile: 16 mod 128, so that ldmatrix's 8 rows
// hit distinct 16 B bank groups
__host__ __device__ inline int slice_stride(int kslice) {
  return (kslice + 127) / 128 * 128 + 16;
}
// Shared memory of one block, in bytes (the carve-up in the kernel).
// (A_SLICE keeps only the present rows, at most SLICE_ROWS: rows)
__host__ __device__ inline int smem_bytes(int mt, int nt, int bm, int bn,
                                          int n_sub, int a_mode, int kslice,
                                          int rows) {
  const int stages = stages_of(mt, nt);
  int a = 0;
  if (a_mode == A_SLICE)
    a = rows * slice_stride(kslice) + (n_sub > 1 ? 2 * n_sub * bm * ST : 0);
  else if (a_mode == A_RING)
    a = stages * bm * BK + 2 * n_sub * bm * ST;
  else if (a_mode == A_READY)
    a = (stages + 1) * bm * ST;
  else
    a = 2 * n_sub * bm * ST;
  return stages * BK * bn + a + 2 * bn * ST;
}

// Quantize an (M, K) f32 matrix to int8 once, for the GEMMs whose rows are
// re-read by many column tiles (M > SLICE_ROWS), and truncate it with
// cfg's first row when every column shares it (truncate != 0).
__global__ void __launch_bounds__(THREADS)
approx_mac_kernel_quantize(const float* __restrict__ x,
                           const float* __restrict__ x_scale,
                           const int32_t* __restrict__ cfg, int truncate,
                           int8_t* __restrict__ q, size_t n, int vec) {
  const float s = x_scale[0];
  const bool cut = truncate && cfg[0] > 0 && cfg[2] <= 128;
  const Trunc p = trunc_params(cfg[0], cfg[2], cfg[3]);
  const size_t stride = (size_t)gridDim.x * THREADS;
  size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (vec) {
    for (; 4 * i < n; i += stride) {
      const float4 f = reinterpret_cast<const float4*>(x)[i];
      const uint32_t b = pack4(quantize_byte(f.x, s), quantize_byte(f.y, s),
                               quantize_byte(f.z, s), quantize_byte(f.w, s));
      reinterpret_cast<uint32_t*>(q)[i] = cut ? trunc4(b, p) : b;
    }
  } else {
    for (; i < n; i += stride) {
      const uint32_t b = quantize_byte(x[i], s);
      q[i] = (int8_t)(cut ? trunc4(b, p) : b);
    }
  }
}

// The present rows of an (E, M, K) f32 stack quantized to int8 once, for
// the grouped GEMMs of M > SLICE_ROWS: block (i, e) takes expert e's rows
// [i * rows_per_block, ...) below group_rows[e] (absent rows are neither
// read nor written) and truncates them with the expert's first config row
// when one row serves all its columns (truncate != 0).
__global__ void __launch_bounds__(THREADS)
approx_mac_kernel_grouped_quantize(const float* __restrict__ x,
                                   const float* __restrict__ x_scale,
                                   const int32_t* __restrict__ group_rows,
                                   const int32_t* __restrict__ cfg,
                                   int cfg_expert_stride, int truncate,
                                   int8_t* __restrict__ q, int M, int K,
                                   int rows_per_block, int vec) {
  const int e = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(min(M, max(group_rows[e], 0)), r0 + rows_per_block);
  if (r0 >= r1) return;
  const int32_t* c = cfg + (size_t)e * cfg_expert_stride;
  const bool cut = truncate && c[0] > 0 && c[2] <= 128;
  const Trunc p = trunc_params(c[0], c[2], c[3]);
  const float s = x_scale[0];
  const size_t base = ((size_t)e * M + r0) * K;
  const size_t n = (size_t)(r1 - r0) * K;
  if (vec) {
    const float4* xv = reinterpret_cast<const float4*>(x + base);
    uint32_t* qv = reinterpret_cast<uint32_t*>(q + base);
    for (size_t i = threadIdx.x; 4 * i < n; i += THREADS) {
      const float4 f = xv[i];
      const uint32_t b = pack4(quantize_byte(f.x, s), quantize_byte(f.y, s),
                               quantize_byte(f.z, s), quantize_byte(f.w, s));
      qv[i] = cut ? trunc4(b, p) : b;
    }
  } else {
    for (size_t i = threadIdx.x; i < n; i += THREADS) {
      const uint32_t b = quantize_byte(x[base + i], s);
      q[base + i] = (int8_t)(cut ? trunc4(b, p) : b);
    }
  }
}

// zeros in rows [r0, r1) x columns [n0, n0 + ncols) of an f32 output of
// row stride N (ncols even): the share `part` of `parts` (a tile's K
// splits share the work)
template <typename TOut>
__device__ __forceinline__ void zero_rows(TOut* out, int r0, int r1,
                                          int n0, int ncols, int N,
                                          int part, int parts) {
  // float 0.f and int32 0 are the same bits: one 8-byte store a pair
  const int half = ncols / 2;
  const int pairs = max(r1 - r0, 0) * half;
  const int lo = part * pairs / parts, hi = (part + 1) * pairs / parts;
  for (int i = lo + (int)threadIdx.x; i < hi; i += THREADS) {
    const int r = i / half, c = 2 * (i % half);
    *reinterpret_cast<int2*>(out + (size_t)(r0 + r) * N + n0 + c) =
        make_int2(0, 0);
  }
}

// The GEMM body.  TA: float (quantized in-kernel with x_scale) or int8_t
// (used as is); TOut: float (sum * scale_row[n]) or int32_t (the sum).
// MT x NT: each warp's 16 x 8 fragments; WN warps across the columns,
// 8 / WN across the rows.  blockIdx = (column tile, row tile, K split);
// the K split z covers [z * kslice, min((z + 1) * kslice, K)), and a
// tile's gridDim.z blocks are launched as one cluster.  a_mode: how the
// activations arrive (above; float rows only as A_SLICE).  GROUPED:
// blockIdx.y = expert * row tiles + row tile, rows of expert e at index
// >= group_rows[e] absent (zeros of TOut).
template <typename TA, typename TOut, int MT, int NT, int WN, bool GROUPED>
__device__ __forceinline__ void mma_body(
    const TA* __restrict__ a, const int8_t* __restrict__ w,
    const float* __restrict__ scale_row, const float* __restrict__ x_scale,
    const int32_t* __restrict__ cfg, int cfg_stride, int cfg_bn,
    const int32_t* __restrict__ group_rows, int cfg_expert_stride,
    TOut* __restrict__ out, int M, int K, int N, int kslice, int a_mode) {
  constexpr int STAGES = stages_of(MT, NT);
  constexpr int BM = (8 / WN) * MT * 16, BN = WN * NT * 8;
  constexpr int CH = BN / 16;                     // 16 B chunks a k-row
  // each thread's share of a stage: weight chunks, 4 x 4 weight blocks
  // (rounded up; the excess threads skip)
  constexpr int LOAD_B = (BK * CH + THREADS - 1) / THREADS;
  constexpr int PASS_B = ((BK / 4) * (BN / 4) + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Trunc trunc_a[MAX_SUB], trunc_b[MAX_SUB];
  __shared__ int ident_a[MAX_SUB], ident_b[MAX_SUB];
  __shared__ int sub_of_group[MAX_SUB];           // 32-column group ->
                                                  // config block of tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  int m0 = blockIdx.y * BM;
  int rows = M;                                   // rows present in the GEMM
  if constexpr (GROUPED) {
    const int mtiles = (M + BM - 1) / BM;
    const size_t e = blockIdx.y / mtiles;
    m0 = (blockIdx.y - (int)e * mtiles) * BM;
    a += e * M * K;
    w += e * K * N;
    scale_row += e * N;
    out += e * M * N;
    cfg += e * cfg_expert_stride;
    rows = min(M, max(group_rows[e], 0));
  }
  const int kbeg = blockIdx.z * kslice;
  const int kend = min(K, kbeg + kslice);
  const int nk = (kend - kbeg + BK - 1) / BK;
  const int trows = min(BM, M - m0);              // rows of the tile
  const int arows = min(BM, rows - m0);           // rows present
  const int ncols = min(BN, N - n0);              // columns present
  if constexpr (GROUPED) {
    if (arows <= 0) {
      // no present row: zeros, and no weight byte read (every K split of
      // the tile decides alike, so its cluster exits whole)
      zero_rows(out, m0, m0 + trows, n0, ncols, N, blockIdx.z, gridDim.z);
      return;
    }
  }
  const int first = n0 / cfg_bn;                  // config blocks spanned
  const int n_sub = (n0 + ncols - 1) / cfg_bn - first + 1;
  const int sst = slice_stride(kslice);

  // shared memory: weight ring, then the activations' buffers (by mode),
  // then the double-buffered staged weight tile
  uint8_t* b_raw = smem;                          // [STAGES][BK][BN]
  uint8_t* a_buf = b_raw + STAGES * BK * BN;
  uint8_t* a_raw = a_buf;                         // A_RING [STAGES][BM][BK]
  uint8_t* a_slice = a_buf;                       // A_SLICE [arows][sst]
  uint8_t* a_st = a_buf;                          // [2][n_sub][BM][ST]
  int a_bytes;
  if (a_mode == A_SLICE) {
    a_st = a_buf + arows * sst;
    a_bytes = arows * sst + (n_sub > 1 ? 2 * n_sub * BM * ST : 0);
  } else if (a_mode == A_RING) {
    a_st = a_buf + STAGES * BM * BK;
    a_bytes = STAGES * BM * BK + 2 * n_sub * BM * ST;
  } else if (a_mode == A_READY) {
    a_bytes = (STAGES + 1) * BM * ST;             // the ring is staged
  } else {
    a_bytes = 2 * n_sub * BM * ST;
  }
  uint8_t* b_st = a_buf + a_bytes;                // [2][BN][ST]

  // this thread's weight chunks of a stage: k-row, shared offset (the
  // chunk index XOR-swizzled by k-row / 4, so that the weight pass's
  // column reads spread over the banks) and global offset
  int ld_row[LOAD_B], ld_smem[LOAD_B];
  size_t ld_glob[LOAD_B];
  bool ld_ok[LOAD_B];
#pragma unroll
  for (int j = 0; j < LOAD_B; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CH, c = i % CH;
    ld_row[j] = r;
    ld_smem[j] = r * BN + 16 * (c ^ ((r >> 2) & (CH - 1)));
    ld_glob[j] = (size_t)r * N + n0 + 16 * c;
    ld_ok[j] = i < BK * CH && n0 + 16 * c < N;
  }

  auto load_stage = [&](int kt) {
    if (kt < nk) {
      const int kb = kbeg + kt * BK;
      uint8_t* bs = b_raw + (kt % STAGES) * BK * BN;
      const int8_t* wk = w + (size_t)kb * N;
#pragma unroll
      for (int j = 0; j < LOAD_B; ++j) {
        if (LOAD_B * THREADS > BK * CH && tid + j * THREADS >= BK * CH)
          break;
        const bool ok = ld_ok[j] && kb + ld_row[j] < kend;
        cp_async16(bs + ld_smem[j], ok ? wk + ld_glob[j] : w, ok);
      }
      if constexpr (sizeof(TA) == 1) {
        if (a_mode == A_RING || a_mode == A_READY) {
          // 16 B chunks of the present rows: into the raw ring (A_RING)
          // or straight into the staged layout (A_READY)
          const bool ready = a_mode == A_READY;
          const int stride = ready ? ST : BK;
          uint8_t* as =
              a_buf + (ready ? kt % (STAGES + 1) : kt % STAGES) * BM * stride;
          for (int i = tid; i < arows * (BK / 16); i += THREADS) {
            const int r = i / (BK / 16), c = i % (BK / 16);
            const bool ok = kb + 16 * c < kend;
            cp_async16(as + r * stride + 16 * c,
                       ok ? a + (size_t)(m0 + r) * K + kb + 16 * c : a, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  // four activations of row r (present) at k, as int8 bytes in a word;
  // zero past kend
  const float xs = sizeof(TA) == 4 ? x_scale[0] : 1.f;
  auto load_a4 = [&](int r, int k) -> uint32_t {
    const TA* row = a + (size_t)(m0 + r) * K;
    if constexpr (sizeof(TA) == 4) {
      uint32_t q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[e] = k + e < kend ? quantize_byte(__ldg(row + k + e), xs) : 0u;
      return pack4(q[0], q[1], q[2], q[3]);
    } else {
      uint32_t q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        q[e] = k + e < kend ? (uint32_t)(uint8_t)__ldg(row + k + e) : 0u;
      return pack4(q[0], q[1], q[2], q[3]);
    }
  };

  // per stage (all modes but A_READY and a one-block A_SLICE): the stage's
  // activation words truncated once per config block into
  // a_st[n_sub][BM][ST]; rows past the present ones are left as they are
  // (their products land in output rows that are never written, or get
  // zeros)
  auto pass_a = [&](int kt, uint8_t* dst) {
    const int kb = kbeg + kt * BK;
    const uint8_t* as = a_raw + (kt % STAGES) * BM * BK;
    for (int i = tid; i < arows * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), c = i % (BK / 4);
      uint32_t q;
      if (a_mode == A_SLICE)
        q = *reinterpret_cast<const uint32_t*>(a_slice + r * sst +
                                               kt * BK + 4 * c);
      else if (a_mode == A_RING)
        q = *reinterpret_cast<const uint32_t*>(as + r * BK + 4 * c);
      else
        q = load_a4(r, kb + 4 * c);
      for (int s = 0; s < n_sub; ++s)
        *reinterpret_cast<uint32_t*>(dst + (s * BM + r) * ST + 4 * c) =
            ident_a[s] ? q : trunc4(q, trunc_a[s]);
    }
  };

  const int wm = warp / WN, wn = warp % WN;
  const int wrow = wm * MT * 16, wcol = wn * NT * 8;
  const bool warp_live = wrow < arows && wcol < ncols;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the products of one staged k-tile (A rows at stride as_stride, rows
  // past a_last read row a_last: they feed output rows never written);
  // the warp's columns lie in one 32-column group, so in one config block
  // (cfg_bn % 32 == 0); grouped, a fragment with no present row is
  // skipped (warp-uniform)
  auto frag_live = [&](int i) {
    return !GROUPED || wrow + i * 16 < arows;
  };
  auto mma_stage = [&](const uint8_t* as, int as_stride, int a_last,
                       const uint8_t* bs) {
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (frag_live(i))
          ldmatrix_x4(af[i], as + min(wrow + i * 16 + (lane & 15), a_last) *
                                      as_stride +
                                 ks * 32 + (lane >> 4) * 16);
      uint32_t bf[NT][2];
      if constexpr (NT == 1)        // one n-tile: lanes 0-15 address it
        ldmatrix_x2(bf[0], bs + (wcol + (lane & 7)) * ST + ks * 32 +
                               ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wcol + p * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                ST +
                            ks * 32 + ((lane >> 3) & 1) * 16);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (frag_live(i))
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  };

  // the first stages' copies go out before anything waits on memory
#pragma unroll
  for (int s = 0; s < STAGES; ++s) load_stage(s);
  // the truncation of each operand in each config block the tile spans
  if (tid < n_sub) {
    const int32_t* c = cfg + (size_t)(first + tid) * cfg_stride;
    trunc_a[tid] = trunc_params(c[0], c[2], c[3]);
    trunc_b[tid] = trunc_params(c[1], c[2], c[3]);
    // no magnitude reaches a gate above 128; A_READY rows are truncated
    ident_a[tid] = c[0] <= 0 || c[2] > 128 || a_mode == A_READY;
    ident_b[tid] = c[1] <= 0 || c[2] > 128;
  }
  if (tid < MAX_SUB)
    sub_of_group[tid] = min(max((n0 + 32 * tid) / cfg_bn - first, 0),
                            n_sub - 1);
  __syncthreads();                    // the truncation parameters
  if (a_mode == A_SLICE) {
    // the block's rows of its whole K slice, quantized (float) and, for
    // a tile inside one config block, truncated: once, while the first
    // weight stages load
    const bool cut = n_sub == 1 && !ident_a[0];
    const Trunc p = trunc_a[0];
    const int words = (nk * BK) / 4;
    for (int i = tid; i < arows * words; i += THREADS) {
      const int r = i / words, c = i % words;
      const uint32_t q = load_a4(r, kbeg + 4 * c);
      *reinterpret_cast<uint32_t*>(a_slice + r * sst + 4 * c) =
          cut ? trunc4(q, p) : q;
    }
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();                    // stage 0 and the slice in place

  // this thread's 4 x 4 weight blocks of a stage (a warp's 32 lanes take
  // 16 k-quads of 8 columns): raw offset, staged offset, truncation
  int pb_src[PASS_B], pb_dst[PASS_B];
  bool pb_cut[PASS_B];
  Trunc pb_p[PASS_B];
#pragma unroll
  for (int j = 0; j < PASS_B; ++j) {
    const int i = tid + j * THREADS;
    const int kq = i % (BK / 4), nq = i / (BK / 4);
    pb_src[j] = 4 * kq * BN + 16 * ((nq >> 2) ^ (kq & (CH - 1))) +
                4 * (nq & 3);
    pb_dst[j] = 4 * nq * ST + 4 * kq;
    const int s = sub_of_group[min(nq >> 3, MAX_SUB - 1)];
    pb_cut[j] = !ident_b[s];
    pb_p[j] = trunc_b[s];
  }
  // weights of stage kt: each 4 x 4 byte block of the (k, n) stage is
  // truncated and transposed into b_st[BN][ST] (k contiguous per column:
  // the mma's B fragment layout)
  auto pass_b = [&](int kt, uint8_t* dst) {
    const uint8_t* bs = b_raw + (kt % STAGES) * BK * BN;
#pragma unroll
    for (int j = 0; j < PASS_B; ++j) {
      if (PASS_B * THREADS > (BK / 4) * (BN / 4) &&
          tid + j * THREADS >= (BK / 4) * (BN / 4))
        break;
      const uint8_t* src = bs + pb_src[j];
      uint32_t w0 = *reinterpret_cast<const uint32_t*>(src);
      uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + BN);
      uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + 2 * BN);
      uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + 3 * BN);
      if (pb_cut[j]) trunc16(w0, w1, w2, w3, pb_p[j]);
      const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
      const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
      const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
      const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
      uint8_t* d = dst + pb_dst[j];
      *reinterpret_cast<uint32_t*>(d) = __byte_perm(t0, t2, 0x5410);
      *reinterpret_cast<uint32_t*>(d + ST) = __byte_perm(t0, t2, 0x7632);
      *reinterpret_cast<uint32_t*>(d + 2 * ST) = __byte_perm(t1, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(d + 3 * ST) = __byte_perm(t1, t3, 0x7632);
    }
  };

  // where the products of stage kt read their activations
  const bool per_stage_a = a_mode != A_READY && !(a_mode == A_SLICE && n_sub == 1);
  const int wsub = sub_of_group[wcol >> 5];
  auto a_tile = [&](int kt, const uint8_t*& p, int& stride, int& last) {
    last = BM - 1;
    if (a_mode == A_READY) {
      p = a_buf + (kt % (STAGES + 1)) * BM * ST;
      stride = ST;
    } else if (!per_stage_a) {
      p = a_slice + kt * BK;
      stride = sst;
      last = arows - 1;
    } else {
      p = a_st + ((kt & 1) * n_sub + wsub) * BM * ST;
      stride = ST;
    }
  };

  if (per_stage_a) pass_a(0, a_st);
  pass_b(0, b_st);
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt + 1 landed; pass kt's staged tiles complete; products of
    // kt - 1 done (their staged buffer and ring slot kt are free)
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_stage(kt + STAGES);
    const int nb = (kt + 1) & 1;
    if (kt + 1 < nk) {
      if (per_stage_a) pass_a(kt + 1, a_st + nb * n_sub * BM * ST);
      pass_b(kt + 1, b_st + nb * BN * ST);
    }
    if (warp_live) {
      const uint8_t* ap;
      int astride, alast;
      a_tile(kt, ap, astride, alast);
      mma_stage(ap, astride, alast, b_st + (kt & 1) * BN * ST);
    }
  }
  cp_async_wait<0>();                 // no copy outlives the block

  // epilogue: fragment (i, j) holds rows g, g + 8 and columns 2t, 2t + 1
  const int g = lane >> 2, t = lane & 3;
  if (gridDim.z == 1) {
    if constexpr (GROUPED)
      zero_rows(out, m0 + arows, m0 + trows, n0, ncols, N, 0, 1);
    if (!warp_live) return;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wcol + j * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wrow + i * 16 + g + 8 * h;
          if (m < m0 + arows && n < N)
            store2(out + (size_t)m * N + n, acc[i][j][2 * h],
                   acc[i][j][2 * h + 1], scale_row, n);
        }
      }
    return;
  }
  // split K: the tile's gridDim.z blocks are one thread block cluster.
  // Each puts its int32 partial tile in its own shared memory (free now);
  // after a cluster barrier, block z of the cluster sums a 1 / gridDim.z
  // share of the tile over every block's copy (distributed shared memory)
  // and writes it out; a second barrier keeps every copy alive until read.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  int* part = reinterpret_cast<int*>(smem);       // [BM][BN]
  __syncthreads();                    // every warp's last products done
  if (warp_live) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(
              part + (wrow + i * 16 + g + 8 * h) * BN + wcol + j * 8 + 2 * t) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
  cluster.sync();
  const int splits = gridDim.z, rank = blockIdx.z;
  const int pairs = BM * BN / 2;
  const int lo = rank * pairs / splits, hi = (rank + 1) * pairs / splits;
  for (int e = lo + tid; e < hi; e += THREADS) {
    const int r = (2 * e) / BN, c = (2 * e) % BN;
    if (r >= arows || c >= ncols) continue;
    int s0 = 0, s1 = 0;
    for (int q = 0; q < splits; ++q) {
      const int2 v = *reinterpret_cast<const int2*>(
          cluster.map_shared_rank(part, q) + 2 * e);
      s0 += v.x;
      s1 += v.y;
    }
    store2(out + (size_t)(m0 + r) * N + n0 + c, s0, s1, scale_row, n0 + c);
  }
  if constexpr (GROUPED)
    zero_rows(out, m0 + arows, m0 + trows, n0, ncols, N, rank, splits);
  cluster.sync();
}

// The fused and int GEMMs.
template <typename TA, typename TOut, int MT, int NT, int WN>
__global__ void __launch_bounds__(THREADS, MT * NT >= 16 ? 2 : 3)
approx_mac_kernel_mma(const TA* __restrict__ a, const int8_t* __restrict__ w,
                      const float* __restrict__ scale_row,
                      const float* __restrict__ x_scale,
                      const int32_t* __restrict__ cfg, int cfg_stride,
                      int cfg_bn, const int32_t* __restrict__ group_rows,
                      int cfg_expert_stride, TOut* __restrict__ out, int M,
                      int K, int N, int kslice, int a_mode) {
  mma_body<TA, TOut, MT, NT, WN, false>(a, w, scale_row, x_scale, cfg,
                                        cfg_stride, cfg_bn, group_rows,
                                        cfg_expert_stride, out, M, K, N,
                                        kslice, a_mode);
}

// The grouped GEMMs (TOut float or int32): the same parameters, with a, w,
// scale_row, out and cfg the first expert's and group_rows (E,).
template <typename TA, typename TOut, int MT, int NT, int WN>
__global__ void __launch_bounds__(THREADS, MT * NT >= 16 ? 2 : 3)
approx_mac_kernel_grouped(const TA* __restrict__ a,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scale_row,
                          const float* __restrict__ x_scale,
                          const int32_t* __restrict__ cfg, int cfg_stride,
                          int cfg_bn, const int32_t* __restrict__ group_rows,
                          int cfg_expert_stride, TOut* __restrict__ out,
                          int M, int K, int N, int kslice, int a_mode) {
  mma_body<TA, TOut, MT, NT, WN, true>(a, w, scale_row, x_scale, cfg,
                                       cfg_stride, cfg_bn, group_rows,
                                       cfg_expert_stride, out, M, K, N,
                                       kslice, a_mode);
}

template <bool GROUPED, typename TA, typename TOut, int MT, int NT, int WN>
auto kernel_of() {
  if constexpr (GROUPED)
    return approx_mac_kernel_grouped<TA, TOut, MT, NT, WN>;
  else
    return approx_mac_kernel_mma<TA, TOut, MT, NT, WN>;
}

template <bool GROUPED, typename TA, typename TOut, int MT, int NT, int WN>
int launch_mma(const TA* a, const int8_t* w, const float* scale_row,
               const float* x_scale, const int32_t* cfg, int cfg_stride,
               int cfg_bn, const int32_t* group_rows, int cfg_expert_stride,
               TOut* out, int E, int M, int K, int N, int kslice, int a_ready,
               void* stream) {
  auto kernel = kernel_of<GROUPED, TA, TOut, MT, NT, WN>();
  static int max_dynamic = -1;        // the block's limit less static smem
  if (max_dynamic < 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
    max_dynamic = MAX_SMEM - (int)fa.sharedSizeBytes;
  }
  constexpr int bm = (8 / WN) * MT * 16, bn = WN * NT * 8;
  // the most config blocks a tile spans
  const int n_sub = cfg_bn % bn == 0 ? 1 : bn / 32;
  const bool aligned = K % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0;
  int a_mode;
  if (sizeof(TA) == 4 || M <= SLICE_ROWS)
    a_mode = A_SLICE;
  else if (!aligned)
    a_mode = A_DIRECT;
  else
    a_mode = a_ready ? A_READY : A_RING;
  if (a_mode == A_SLICE && (M > SLICE_ROWS || M * slice_stride(kslice) >
                                                  64 * 1024))
    return (int)cudaErrorInvalidValue;
  const int splits = (K + kslice - 1) / kslice;
  const long row_tiles = (long)E * ((M + bm - 1) / bm);
  int smem = smem_bytes(MT, NT, bm, bn, n_sub, a_mode, kslice, M);
  if (splits > 1 && smem < bm * bn * 4) smem = bm * bn * 4;   // partials
  if (smem > max_dynamic || row_tiles > 65535 || splits > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3((N + bn - 1) / bn, (unsigned)row_tiles, splits);
  lc.blockDim = dim3(THREADS);
  lc.dynamicSmemBytes = smem;
  lc.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = splits;
  lc.attrs = &attr;
  lc.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &lc, kernel, a, w, scale_row, x_scale, cfg, cfg_stride, cfg_bn,
      group_rows, cfg_expert_stride, out, M, K, N, kslice, a_mode);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the launch contract both dispatches check
bool bad_gemm(const int8_t* w, int M, int K, int N, int cfg_bn, int kslice) {
  return M <= 0 || K <= 0 || N <= 0 || N % 32 != 0 || cfg_bn <= 0 ||
         cfg_bn % 32 != 0 || kslice <= 0 || kslice % 32 != 0 ||
         reinterpret_cast<uintptr_t>(w) % 16 != 0;
}

// the plan's (mt, nt, warps_n) -> the built instance
template <typename TA, typename TOut>
int dispatch(int mt, int nt, int warps_n, const TA* a, const int8_t* w,
             const float* scale_row, const float* x_scale,
             const int32_t* cfg, int cfg_stride, int cfg_bn, TOut* out,
             int M, int K, int N, int kslice, int a_ready, void* stream) {
  if (bad_gemm(w, M, K, N, cfg_bn, kslice)) return (int)cudaErrorInvalidValue;
#define APPROX_MAC_CASE(MT_, NT_, WN_)                                      \
  if (mt == MT_ && nt == NT_ && warps_n == WN_)                             \
    return launch_mma<false, TA, TOut, MT_, NT_, WN_>(                      \
        a, w, scale_row, x_scale, cfg, cfg_stride, cfg_bn, nullptr, 0, out, \
        1, M, K, N, kslice, a_ready, stream);
  // approx_mac.gemm_plan's tilings: every row in one tile (M <= 64),
  // then 128 x 128 tiles and their narrow-N forms (M > 64); float rows
  // reach the GEMM only at M <= SLICE_ROWS (more are quantized once)
  APPROX_MAC_CASE(1, 2, 8)
  APPROX_MAC_CASE(1, 2, 4)
  APPROX_MAC_CASE(1, 2, 2)
  APPROX_MAC_CASE(1, 1, 2)
  if constexpr (sizeof(TA) == 1) {
    APPROX_MAC_CASE(2, 2, 8)
    APPROX_MAC_CASE(2, 2, 4)
    APPROX_MAC_CASE(3, 2, 8)
    APPROX_MAC_CASE(4, 2, 8)
    APPROX_MAC_CASE(4, 4, 4)
  }
#undef APPROX_MAC_CASE
  return (int)cudaErrorInvalidValue;
}

// the grouped plan's (mt, nt, warps_n) -> the built grouped instance
template <typename TA, typename TOut>
int dispatch_grouped(int mt, int nt, int warps_n, const TA* a,
                     const int8_t* w, const float* scale_rows,
                     const float* x_scale, const int32_t* cfg,
                     int cfg_stride, int cfg_bn, const int32_t* group_rows,
                     int cfg_expert_stride, TOut* out, int E, int M, int K,
                     int N, int kslice, int a_ready, void* stream) {
  if (bad_gemm(w, M, K, N, cfg_bn, kslice) || E <= 0 ||
      group_rows == nullptr)
    return (int)cudaErrorInvalidValue;
#define APPROX_MAC_GROUPED_CASE(MT_, NT_, WN_)                              \
  if (mt == MT_ && nt == NT_ && warps_n == WN_)                             \
    return launch_mma<true, TA, TOut, MT_, NT_, WN_>(                       \
        a, w, scale_rows, x_scale, cfg, cfg_stride, cfg_bn, group_rows,     \
        cfg_expert_stride, out, E, M, K, N, kslice, a_ready, stream);
  // approx_mac.grouped_plan's tilings: an expert's rows in one tile of
  // 128 columns (M <= 64), then 128 x 128 tiles (M > 64); float rows only
  // at M <= SLICE_ROWS
  APPROX_MAC_GROUPED_CASE(1, 2, 8)
  if constexpr (sizeof(TA) == 1) {
    APPROX_MAC_GROUPED_CASE(2, 2, 8)
    APPROX_MAC_GROUPED_CASE(3, 2, 8)
    APPROX_MAC_GROUPED_CASE(4, 2, 8)
    APPROX_MAC_GROUPED_CASE(4, 4, 4)
  }
#undef APPROX_MAC_GROUPED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) f32, w (K, N) int8 with N % 32 == 0 and 16-byte aligned rows,
// scale_row (N,) f32 = x_scale * w_scale rounded once by the caller,
// x_scale (1,) f32, cfg rows of (depth_a, depth_b, gate, rtn) int32 with
// row stride cfg_stride (0 broadcasts one row), cfg_bn the logical config
// block width (a multiple of 32), out (M, N) f32; (mt, nt, warps_n,
// kslice) from approx_mac.gemm_plan; xq (M, K) int8 scratch, needed where
// M > 16: x is quantized into it once by its own kernel (and truncated
// there when cfg_stride is 0) and the GEMM reads the int8 rows.  All
// pointers are on the device; launches on `stream` and returns
// cudaGetLastError().
extern "C" int approx_mac_fused_matmul(const float* x, const int8_t* w,
                                       const float* scale_row,
                                       const float* x_scale,
                                       const int32_t* cfg, int cfg_stride,
                                       int cfg_bn, float* out, int8_t* xq,
                                       int M, int K, int N, int mt, int nt,
                                       int warps_n, int kslice,
                                       void* stream) {
  if (M <= SLICE_ROWS)
    return dispatch<float, float>(mt, nt, warps_n, x, w, scale_row, x_scale,
                                  cfg, cfg_stride, cfg_bn, out, M, K, N,
                                  kslice, 0, stream);
  if (xq == nullptr) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)M * K;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 4 == 0;
  const size_t items = vec ? n / 4 : n;
  const int blocks = (int)min((items + THREADS - 1) / THREADS, (size_t)1024);
  const int ready = cfg_stride == 0;
  approx_mac_kernel_quantize<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, x_scale, cfg, ready, xq, n, vec ? 1 : 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return dispatch<int8_t, float>(mt, nt, warps_n, xq, w, scale_row, x_scale,
                                 cfg, cfg_stride, cfg_bn, out, M, K, N,
                                 kslice, ready, stream);
}

// a (M, K) int8, w (K, N) int8 with N % 32 == 0 and 16-byte aligned rows,
// cfg / cfg_stride / cfg_bn / plan as above, out (M, N) int32.
extern "C" int approx_mac_matmul(const int8_t* a, const int8_t* w,
                                 const int32_t* cfg, int cfg_stride,
                                 int cfg_bn, int32_t* out, int M, int K,
                                 int N, int mt, int nt, int warps_n,
                                 int kslice, void* stream) {
  return dispatch<int8_t, int32_t>(mt, nt, warps_n, a, w, nullptr, nullptr,
                                   cfg, cfg_stride, cfg_bn, out, M, K, N,
                                   kslice, 0, stream);
}

// x (E, M, K) f32, w (E, K, N) int8 with N % 32 == 0 and 16-byte aligned
// rows, scale_rows (E, N) f32 = x_scale * w_scale[e] rounded once by the
// caller, x_scale (1,) f32 shared by every expert, group_rows (E,) int32
// rows present per expert, cfg rows of expert e's config block i at
// cfg + e * cfg_expert_stride + i * cfg_stride, cfg_bn as above, out
// (E, M, N) f32 (every element written: absent rows get zeros); (mt, nt,
// warps_n, kslice) from approx_mac.grouped_plan; xq (E, M, K) int8
// scratch, needed where M > 16: the present rows of x are quantized into
// it once by their own kernel (and truncated there with the expert's
// config row when cfg_stride is 0).
namespace {

// both grouped entry points: the float rows straight into the GEMM at
// M <= SLICE_ROWS, else quantized once by their own kernel
template <typename TOut>
int grouped_matmul(const float* x, const int8_t* w, const float* scale_rows,
                   const float* x_scale, const int32_t* group_rows,
                   const int32_t* cfg, int cfg_expert_stride, int cfg_stride,
                   int cfg_bn, TOut* out, int8_t* xq, int E, int M, int K,
                   int N, int mt, int nt, int warps_n, int kslice,
                   void* stream) {
  if (M <= SLICE_ROWS)
    return dispatch_grouped<float, TOut>(mt, nt, warps_n, x, w, scale_rows,
                                         x_scale, cfg, cfg_stride, cfg_bn,
                                         group_rows, cfg_expert_stride, out,
                                         E, M, K, N, kslice, 0, stream);
  if (xq == nullptr || E <= 0 || E > 65535 || K <= 0 || group_rows == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 4 == 0;
  const int rows_per_block = max(1, 8192 / K);    // ~32 KB of f32 a block
  const int ready = cfg_stride == 0;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, E);
  approx_mac_kernel_grouped_quantize<<<grid, THREADS, 0,
                                       (cudaStream_t)stream>>>(
      x, x_scale, group_rows, cfg, cfg_expert_stride, ready, xq, M, K,
      rows_per_block, vec ? 1 : 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return dispatch_grouped<int8_t, TOut>(mt, nt, warps_n, xq, w, scale_rows,
                                        x_scale, cfg, cfg_stride, cfg_bn,
                                        group_rows, cfg_expert_stride, out,
                                        E, M, K, N, kslice, ready, stream);
}

}  // namespace

extern "C" int approx_mac_grouped_matmul(
    const float* x, const int8_t* w, const float* scale_rows,
    const float* x_scale, const int32_t* group_rows, const int32_t* cfg,
    int cfg_expert_stride, int cfg_stride, int cfg_bn, float* out,
    int8_t* xq, int E, int M, int K, int N, int mt, int nt, int warps_n,
    int kslice, void* stream) {
  return grouped_matmul<float>(x, w, scale_rows, x_scale, group_rows, cfg,
                               cfg_expert_stride, cfg_stride, cfg_bn, out,
                               xq, E, M, K, N, mt, nt, warps_n, kslice,
                               stream);
}

// the same grouped GEMMs with the epilogue left out: out (E, M, N) int32
// holds each expert's sums (zeros in absent rows); no scale_rows.
extern "C" int approx_mac_grouped_matmul_int(
    const float* x, const int8_t* w, const float* x_scale,
    const int32_t* group_rows, const int32_t* cfg, int cfg_expert_stride,
    int cfg_stride, int cfg_bn, int32_t* out, int8_t* xq, int E, int M,
    int K, int N, int mt, int nt, int warps_n, int kslice, void* stream) {
  return grouped_matmul<int32_t>(x, w, nullptr, x_scale, group_rows, cfg,
                                 cfg_expert_stride, cfg_stride, cfg_bn, out,
                                 xq, E, M, K, N, mt, nt, warps_n, kslice,
                                 stream);
}
