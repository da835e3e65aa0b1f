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
// arithmetic.
//
// What bounds it on an H100: at prefill lengths the work is 4 * hd
// operations per visible (query, key) pair per head, while each q, k, v
// and out byte moves once; at Gemma-2's hd 128 that is ~100 operations
// per byte at S 1024 and more beyond, so the operations bound it, and
// only the tensor cores (989 TFLOP/s dense bf16) come near that bound.
//
// The bf16 instance (`flash_kernel_mma`) is FlashAttention-2's design on
// `mma.sync.m16n8k16` (bf16 operands, f32 accumulators):
//   * a block of NW warps takes a query tile of one head of one batch
//     row, each warp MT m-tiles of 16 rows.  The tile height is chosen
//     per launch from the host ints Sq, H and B: the tallest whose grid
//     still fills the 132 SMs — 128 rows (4 warps x 2 m-tiles, hd <= 128:
//     FlashAttention-2's tile, where each K and V fragment feeds two
//     products), then 64 rows (4 warps x 1), else one-warp blocks of 16
//     rows, so a short prompt (S 48 at H 32: 96 blocks, not 32) spreads;
//   * q.k^T and p.v run on the tensor cores, their operands read from
//     shared memory by `ldmatrix` (`.trans` for V); at one m-tile a
//     warp's q fragments stay in registers across the key loop (hd <=
//     128), otherwise they are re-read per k-step, where registers would
//     spill;
//   * K and V tiles of 64 keys move through a two-stage ring of
//     `cp.async.cg` 16-byte copies (commit_group / wait_group): tile n + 1
//     is in flight while tile n is computed, behind one barrier a tile.
//     Rows are XOR-swizzled in 16-byte chunks (chunk c of row r at
//     c ^ (r & 7)), not padded, so `ldmatrix` reads without bank
//     conflicts; rows past Skv are zero-filled by the copy itself;
//   * the online softmax runs on the accumulator fragments in registers:
//     a row's max reduces over the 4 lanes that share it, l sums the f32
//     p, and p is rounded to bf16 in registers and fed straight in as the
//     A operand of p.v — it never touches shared memory;
//   * the causal, window and ragged-end predicates run only on tiles that
//     straddle a boundary (decided per warp); interior tiles skip them.
//     Tiles wholly outside the causal or window range are not visited,
//     and causal query tiles are scheduled heaviest first (reversed
//     blockIdx.x);
//   * any hd % 8 == 0, hd <= 256 is read unpadded from device memory; when
//     hd is not a multiple of 16 (Danube's 120) the k-dimension is
//     zero-filled in shared memory up to the next 16, which is exact for
//     q.k^T, and the output columns past hd are not stored.  hd equal to
//     the tile width (128, 256, ...) takes an instance whose loop bounds
//     are constants: the runtime bounds cost a quarter of the time;
//   * deterministic: no atomics and no split of the keys across blocks;
//     every sum runs in one fixed order, and the 4-lane xor butterflies
//     leave every lane of a row the same bits.
// The rounding of p to bf16 moves each p_j by at most 2^-9 p_j, so the
// output moves by at most 2^-9 max|v| against the f32 plain version: the
// bf16 tolerance is rtol 1.6e-2 with atol 2^-8 max|v|.
//
// Why mma.sync and not wgmma/TMA: FlashAttention-2, from which PyTorch's
// flash backend of scaled_dot_product_attention is built, is an mma.sync
// design, so this one can reach that yardstick without wgmma descriptors.
// What wgmma/TMA would add (FlashAttention-3's design) is the rest of the
// tensor cores' rate: mma.sync tops out near two thirds of it on Hopper,
// and asynchronous warpgroup products let the softmax of one tile overlap
// the products of the next, with one producer warp issuing TMA copies.
// That is the follow-up if this kernel stays slower than SDPA.
//
// The f32 instance (`flash_kernel<float, NCP>`, the CPU smoke dtype and
// one check case) keeps the first version's body: f32 FMAs on the CUDA
// cores, one block of 256 threads per 64-query tile, K/V staged
// synchronously; its tolerance stays 2e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1.0e30f;
constexpr int BK = 64;         // keys per tile (both instances)

// ---------------------------------------------------------------------------
// f32 instance: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int BQ = 64;         // query rows per block
constexpr int THREADS = 256;   // 16 x 16
constexpr int RPT = BQ / 16;   // rows per thread
constexpr int KPT = BK / 16;   // keys per thread
constexpr int PSTR = BK + 16;  // probability tile stride: the two
                               // half-warps' rows land 16 banks apart

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Stage 64 rows of hd floats (row r at src + r * src_stride) into shared
// memory (row stride sstr); rows >= valid are zero.
__device__ __forceinline__ void stage(float* dst, int sstr, const float* src,
                                      size_t src_stride, int valid, int hd) {
  const int vpr = hd / 4;
  for (int i = threadIdx.x; i < 64 * vpr; i += THREADS) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * 4;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      raw = __ldg(reinterpret_cast<const float4*>(src + r * src_stride + c));
    float2* d = reinterpret_cast<float2*>(dst + r * sstr + c);
    d[0] = make_float2(raw.x, raw.y);
    d[1] = make_float2(raw.z, raw.w);
  }
}

size_t smem_bytes_f32(int hd) {
  return (size_t)(BQ + 2 * BK) * (hd + 2) * sizeof(float) +
         (size_t)BQ * PSTR * sizeof(float);
}

// q, out (B, Sq, H, hd); k, v (B, Skv, KV, hd); grid (ceil(Sq / BQ), H,
// B), THREADS threads, smem_bytes_f32(hd) shared bytes.  NCP column pairs
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
        o[col] = acc[r][2 * c] / lr;
        o[col + 1] = acc[r][2 * c + 1] / lr;
      }
    }
  }
}

template <int NCP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int Sq, int Skv, int H, int KV, int hd, float scale,
               float logit_cap, int causal, int window, void* stream) {
  const size_t smem = smem_bytes_f32(hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<float, NCP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<float, NCP><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H, KV,
      hd, scale, logit_cap, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 instance: tensor cores
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; zero-filled (and
// nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Row stride (elements) of every shared-memory tile: at least 64, so that
// the 8-chunk XOR swizzle maps the 8 rows an `ldmatrix` phase reads to 8
// distinct 16-byte bank groups.
template <int HDP>
__host__ __device__ constexpr int row_elems() { return HDP < 64 ? 64 : HDP; }

// Query rows of a block: NW warps of MT 16-row m-tiles each.
template <int NW, int MT>
__host__ __device__ constexpr int block_rows() { return 16 * NW * MT; }

template <int HDP, int NW, int MT>
size_t smem_bytes_mma() {
  return (size_t)(block_rows<NW, MT>() + 4 * BK) * row_elems<HDP>() *
         sizeof(bf16);
}

// Byte address of 16-byte chunk `c` of row `r` of a swizzled tile.
template <int RS>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  return base + (uint32_t)(r * RS + ((c ^ (r & 7)) << 3)) * sizeof(bf16);
}

// Copy `rows` rows of hd elements (row r at src + (row0 + r) * stride)
// into a swizzled tile; rows with row0 + r >= limit are zero-filled.
// Where the block's threads divide into whole rows, each thread keeps one
// chunk column and steps through rows (no division per chunk).
template <int RS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          size_t stride, int row0, int limit,
                                          int rows, int chunks) {
  if (NT % chunks == 0) {
    const int c = threadIdx.x % chunks;
    const int step = NT / chunks;
    for (int r = threadIdx.x / chunks; r < rows; r += step) {
      const bool ok = row0 + r < limit;
      const bf16* s = ok ? src + (size_t)(row0 + r) * stride + c * 8 : src;
      cp_async16(tile_addr<RS>(dst, r, c), s, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * chunks; i += NT) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const bool ok = row0 + r < limit;
    const bf16* s = ok ? src + (size_t)(row0 + r) * stride + c * 8 : src;
    cp_async16(tile_addr<RS>(dst, r, c), s, ok);
  }
}

// q, out (B, Sq, H, hd); k, v (B, Skv, KV, hd), bf16.  grid (ceil(Sq /
// block_rows), H, B), 32 NW threads, smem_bytes_mma<HDP, NW, MT>() shared
// bytes; hd <= HDP, hd % 8 == 0 (EXACT: hd == HDP, so every loop bound
// is a constant).  Each warp owns MT m-tiles of 16 rows, so one K or V
// fragment feeds MT products.  QREG (MT == 1 only) keeps q's fragments
// in registers; otherwise they are re-read per k-step.
template <int HDP, int NW, int MT, bool QREG, bool EXACT>
__global__ void __launch_bounds__(NW * 32)
flash_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                 int Skv, int H, int KV, int hd, float scale,
                 float logit_cap, int causal, int window) {
  static_assert(!QREG || MT == 1, "q fragments in registers at MT 1 only");
  constexpr int BQM = block_rows<NW, MT>();
  constexpr int WR = 16 * MT;       // rows per warp
  constexpr int NT = 32 * NW;
  constexpr int RS = row_elems<HDP>();
  constexpr int KS = HDP / 16;      // k-steps of q.k^T, n-pairs of p.v
  constexpr int NO = HDP / 8;       // output n-tiles per m-tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);       // BQM x RS
  const uint32_t q_base = smem_addr(q_s);           // then stage st: K at
  const uint32_t kv_base = q_base + BQM * RS * sizeof(bf16);  // 2 st,
  constexpr uint32_t TILE_BYTES = BK * RS * sizeof(bf16);     // V 2 st + 1

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;          // fragment row (and row + 8)
  const int t = lane & 3;           // fragment column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQM;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int offset = Skv - Sq;      // query i sits at key position i + offset
  const size_t q_step = (size_t)H * hd;
  const size_t kv_step = (size_t)KV * hd;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * hd;
  const bf16* kb = k + ((size_t)b * Skv * KV + kvh) * hd;
  const bf16* vb = v + ((size_t)b * Skv * KV + kvh) * hd;
  // 16-byte chunks of a row in memory; k-steps of 16
  const int chunks = EXACT ? HDP / 8 : hd / 8;
  const int ksteps = EXACT ? KS : (hd + 15) / 16;

  // hd % 16 == 8: zero the one chunk between hd and the next 16 in every
  // row of every tile, once (no copy ever writes it)
  if (ksteps * 2 != chunks) {
    for (int r = tid; r < BQM + 4 * BK; r += NT)
      *reinterpret_cast<uint4*>(q_s + r * RS + ((chunks ^ (r & 7)) << 3)) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // the keys any row of this tile can see, in whole 64-key tiles
  int k_end = Skv;
  if (causal) k_end = min(k_end, min(q0 + BQM, Sq) + offset);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 + offset - window + 1) / BK * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  load_tile<RS, NT>(q_base, qb, q_step, q0, Sq, BQM, chunks);
  if (n_tiles > 0) {
    load_tile<RS, NT>(kv_base, kb, kv_step, k_begin, Skv, BK, chunks);
    load_tile<RS, NT>(kv_base + TILE_BYTES, vb, kv_step, k_begin, Skv, BK,
                      chunks);
  }
  cp_commit();

  // this warp's rows sit at key positions qlo .. qlo + WR - 1
  const int row0 = warp * WR;
  const int qlo = q0 + row0 + offset;
  // the softcap as tanh(s * srcap) * cap2, already in base-2 units;
  // without it a raw score times mul is in base-2 units
  const float srcap = logit_cap > 0.f ? scale / logit_cap : 0.f;
  const float cap2 = logit_cap * LOG2E;
  const float mul = logit_cap > 0.f ? 1.f : scale * LOG2E;
  float o[MT][NO][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }
  uint32_t qf[QREG ? KS : 1][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    const int st = it & 1;
    // tile it has landed and every warp is past tile it - 1, whose stage
    // then takes tile it + 1 while this one is computed: one barrier a
    // tile
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const uint32_t nxt = kv_base + 2 * (st ^ 1) * TILE_BYTES;
      load_tile<RS, NT>(nxt, kb, kv_step, k0 + BK, Skv, BK, chunks);
      load_tile<RS, NT>(nxt + TILE_BYTES, vb, kv_step, k0 + BK, Skv, BK,
                        chunks);
      cp_commit();
    }
    const uint32_t k_tile = kv_base + 2 * st * TILE_BYTES;
    const uint32_t v_tile = k_tile + TILE_BYTES;

    if (QREG && it == 0) {
#pragma unroll
      for (int ks = 0; ks < (QREG ? KS : 1); ++ks)
        if (ks < ksteps)
          ldsm_x4(qf[ks], tile_addr<RS>(q_base, row0 + (lane & 15),
                                        2 * ks + (lane >> 4)));
    }

    // s = q . k^T: MT x 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks >= ksteps) break;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (QREG) {
#pragma unroll
          for (int u = 0; u < 4; ++u) a[mt][u] = qf[QREG ? ks : 0][u];
        } else {
          ldsm_x4(a[mt], tile_addr<RS>(q_base,
                                       row0 + 16 * mt + (lane & 15),
                                       2 * ks + (lane >> 4)));
        }
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, tile_addr<RS>(k_tile,
                                  jp * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * ks + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * jp], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * jp + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // the softcap (base-2 units after it); the mask only where the tile
    // straddles a boundary of some row of this warp
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > qlo) ||
                      (window > 0 && k0 <= qlo + WR - 1 - window);
    if (logit_cap > 0.f) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = tanhf(s[mt][j][e] * srcap) * cap2;
    }
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = qlo + 16 * mt + g + 8 * (e >> 1);
            const bool vis = kpos < Skv && (!causal || kpos <= qpos) &&
                             (window <= 0 || kpos > qpos - window);
            if (!vis) s[mt][j][e] = NEG_INF;
          }
    }

    // online softmax on the fragments, in base 2 (s * mul is a score
    // times log2(e)): rows g (e 0, 1) and g + 8 (e 2, 3) of each m-tile,
    // each shared by the 4 lanes of a quad
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
        const float mn = fmaxf(m[mt][r], mx[r] * mul);
        alpha[r] = exp2f(m[mt][r] - mn);
        m[mt][r] = mn;
      }
      if (edge) {
        // masked keys get exactly zero weight (a row masked so far has
        // m = NEG_INF, where exp would give 1)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[mt][j][e];
            const float p = x == NEG_INF
                ? 0.f : exp2f(fmaf(x, mul, -m[mt][e >> 1]));
            s[mt][j][e] = p;
            sum[e >> 1] += p;
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(fmaf(s[mt][j][e], mul, -m[mt][e >> 1]));
            s[mt][j][e] = p;
            sum[e >> 1] += p;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + sum[r];
      // rescale only where some row's max moved (a factor of exactly 1
      // changes no bits)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[mt][n][0] *= alpha[0];
          o[mt][n][1] *= alpha[0];
          o[mt][n][2] *= alpha[1];
          o[mt][n][3] *= alpha[1];
        }
      }
    }

    // o += p . v: p (bf16, in registers) is the A operand, 4 k-steps of
    // 16 keys; V by transposing ldmatrix, each fragment for all m-tiles
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        if (dp >= ksteps) break;
        uint32_t bv[4];
        ldsm_x4_trans(bv, tile_addr<RS>(
            v_tile, kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
            2 * dp + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], a[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_wait<0>();        // (no tile at all: the q copy is still pending)

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float lr = l[mt][half];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        lr += __shfl_xor_sync(0xffffffffu, lr, off);
      const float d = fmaxf(lr, 1e-30f);
      const int qi = q0 + row0 + 16 * mt + g + 8 * half;
      if (qi >= Sq) continue;
      bf16* orow = out + (((size_t)b * Sq + qi) * H + h) * hd;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * t;
        if (8 * n < hd)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[mt][n][2 * half] / d, o[mt][n][2 * half + 1] / d);
      }
    }
}

template <int HDP, int NW, int MT, bool EXACT>
int launch_mma_exact(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Skv, int H, int KV, int hd,
                     float scale, float logit_cap, int causal, int window,
                     void* stream) {
  constexpr bool QREG = MT == 1 && HDP <= 128;
  const size_t smem = smem_bytes_mma<HDP, NW, MT>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel_mma<HDP, NW, MT, QREG, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int BQM = block_rows<NW, MT>();
  const dim3 grid((Sq + BQM - 1) / BQM, H, B);
  flash_kernel_mma<HDP, NW, MT, QREG, EXACT>
      <<<grid, 32 * NW, smem, (cudaStream_t)stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H,
          KV, hd, scale, logit_cap, causal, window);
  return (int)cudaGetLastError();
}

template <int HDP, int NW, int MT>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int B, int Sq, int Skv, int H, int KV, int hd, float scale,
               float logit_cap, int causal, int window, void* stream) {
  if (hd == HDP)
    return launch_mma_exact<HDP, NW, MT, true>(q, k, v, out, B, Sq, Skv, H,
                                               KV, hd, scale, logit_cap,
                                               causal, window, stream);
  return launch_mma_exact<HDP, NW, MT, false>(q, k, v, out, B, Sq, Skv, H,
                                              KV, hd, scale, logit_cap,
                                              causal, window, stream);
}

constexpr int NUM_SMS = 132;   // H100 SXM

// The query-tile height from host ints only: the tallest tile whose grid
// still fills the SMs — 128 rows (4 warps of two m-tiles; 64 at hd 256,
// where two m-tiles' accumulators would spill), then 64 rows (4 warps),
// else 16-row one-warp blocks, so a short prompt still spreads.
template <int HDP>
int launch_mma_rows(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Skv, int H, int KV, int hd,
                    float scale, float logit_cap, int causal, int window,
                    void* stream) {
  constexpr int MT = HDP <= 128 ? 2 : 1;
  const long heads = (long)H * B;
  if ((Sq + 16 * 4 * MT - 1) / (16 * 4 * MT) * heads >= NUM_SMS)
    return launch_mma<HDP, 4, MT>(q, k, v, out, B, Sq, Skv, H, KV, hd,
                                  scale, logit_cap, causal, window, stream);
  if (MT == 2 && (Sq + 63) / 64 * heads >= NUM_SMS)
    return launch_mma<HDP, 4, 1>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale,
                                 logit_cap, causal, window, stream);
  return launch_mma<HDP, 1, 1>(q, k, v, out, B, Sq, Skv, H, KV, hd, scale,
                               logit_cap, causal, window, stream);
}

}  // namespace

// q and out (B, Sq, H, hd), k and v (B, Skv, KV, hd), all of one dtype
// (0 float32, 1 bfloat16), contiguous and 16-byte aligned.  H % KV == 0,
// hd % 8 == 0 and hd <= 256; window <= 0 means no window.  All pointers
// are on the device; one launch on `stream`; returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int Sq, int Skv,
                               int H, int KV, int hd, float scale,
                               float logit_cap, int causal, int window,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd % 8 != 0 || hd > 256 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
#define FLASH_ARGS \
  q, k, v, out, B, Sq, Skv, H, KV, hd, scale, logit_cap, causal, window, stream
  switch (dtype) {
    case 0:
      if (hd <= 32) return launch_f32<1>(FLASH_ARGS);
      if (hd <= 64) return launch_f32<2>(FLASH_ARGS);
      if (hd <= 128) return launch_f32<4>(FLASH_ARGS);
      return launch_f32<8>(FLASH_ARGS);
    case 1:
      if (hd <= 32) return launch_mma_rows<32>(FLASH_ARGS);
      if (hd <= 64) return launch_mma_rows<64>(FLASH_ARGS);
      if (hd <= 128) return launch_mma_rows<128>(FLASH_ARGS);
      return launch_mma_rows<256>(FLASH_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}
