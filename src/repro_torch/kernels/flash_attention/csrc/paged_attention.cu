// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention` (body `_kernel`) of
// src/repro/kernels/flash_attention/paged_attention.py.  For every batch
// row b and query head h:
//
//   out[b, h] = softmax_j(cap(q[b, h] . k[j] * scale)) . v[j]
//
// over the row's keys j < lens[b] (and j < P * bs), where key j lives in
// pool block tables[b, j / bs] at offset j % bs, KV head h / (H / KV)
// (GQA), and cap(s) = tanh(s / logit_cap) * logit_cap when logit_cap > 0.
// The softmax runs online in f32; l is floored at 1e-30 and the output
// takes q's dtype — the TPU kernel's arithmetic.
//
// What bounds it on an H100: every owned key and value row is read once
// from device memory and used by the `group` query heads that share its
// KV head, so the K/V bytes of the owned pages set the floor (Qwen2.5-3B:
// 512 bytes of K+V per token per KV head in bf16); the operations (4 * hd
// per key per query head, 8 heads per 512-byte row) are far below the
// tensor cores' line, so the arithmetic stays f32 on the CUDA cores.
// The design (flash-decoding) spreads those bytes over the whole card:
//   * the grid is (KV heads x head chunks, B, n_split): each row's keys
//     are cut into n_split splits of `kps` keys, both chosen on the host
//     from B, KV, the group and the table width P — never from the
//     lengths, which live on the device — so that a short batch still
//     covers the 132 SMs twice and the launch can be captured in a CUDA
//     graph.  A split past its row's length writes an empty partial
//     (m = -1e30, l = 0) and exits;
//   * inside a block, thread (x, y, z) is lane x of query head y in
//     stream z: lx lanes span a row's 16-byte chunks (4 chunks a lane;
//     lx 4 for bf16 hd 128), one thread row per query head of the KV
//     head (up to 8), and the streams (4 of them at group 8) deal the
//     keys of each tile between them.  A tile of K and V rows is copied
//     once from device memory with cp.async 16-byte copies into a
//     four-stage ring shared by the block, so the next tiles are in
//     flight while one is computed; every query head's thread row reads
//     the same shared chunk (a broadcast), so a row is read once for all
//     the heads.  q's slice (one 16-byte load a chunk) and the
//     accumulator stay in registers; a score sums four independent
//     partial products and reduces over the lx lanes by log2(lx) warp
//     shuffles, and the online softmax (in base 2, the scale folded with
//     log2(e)) updates once per tile for the stream's 4 keys;
//   * the key loop has no branch: a key past the tile reads the tile's
//     last row (its weight is exactly 0) and a chunk past hd reads the
//     row's last chunk (q is 0 there).  A branch around each shared load
//     serialised the loads behind it and tripled the kernel's time;
//   * each stream keeps its own online softmax (m, l, acc); at the end
//     the block merges its streams through shared memory in stream
//     order and writes one f32 partial (acc, m, l) per query head (the
//     output itself when the row has one split);
//   * a second kernel merges the partials of each (row, query head) in
//     a fixed order — m = max m_s, l = sum l_s exp(m_s - m), acc likewise —
//     divides by max(l, 1e-30) and casts to q's dtype.  It is launched as
//     a programmatic dependent of the first (griddepcontrol), so its
//     launch overlaps the first kernel's tail.  With one split the first
//     kernel writes the output itself.  No atomics: the result is
//     deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1.0e30f;
constexpr int THREADS = 128;
constexpr int STAGES = 4;      // key tiles in the ring
constexpr int GMAX = 8;        // query heads per block
constexpr int CPL = 4;         // 16-byte chunks of a K/V row per lane
constexpr int KPT = 4;         // keys per stream per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TKMAX = 64;      // keys per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, bf16* o) {
  *o = __float2bfloat16(v);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ void unpack(const uint4& raw, float* dst, float) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* dst, bf16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// N elements of q (a pool chunk's width) as f32, zeros when !ok: one
// 16-byte load where they fill one, else element by element
template <int N, typename TQ>
__device__ __forceinline__ void load_q(const TQ* src, bool ok, float* d) {
  if constexpr (sizeof(TQ) * N == 16) {
    unpack(ok ? __ldg(reinterpret_cast<const uint4*>(src))
              : make_uint4(0u, 0u, 0u, 0u), d, TQ());
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) d[u] = ok ? to_f32(src[u]) : 0.f;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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

// Lanes across a row: the least power of two that holds a row's 16-byte
// chunks at CPL chunks a lane.
int lanes_per_row(int hd, int vec) {
  const int need = (hd / vec + CPL - 1) / CPL;
  int lx = 1;
  while (lx < need) lx <<= 1;
  return lx;
}

struct Geometry {
  int lx, ns, tk, tbl;         // lanes per row, streams, keys per tile,
  size_t smem;                 // table slots; shared-memory bytes
};

template <typename TKV, int GB>
Geometry geometry(int hd, int bs, int kps) {
  Geometry g;
  g.lx = lanes_per_row(hd, 16 / (int)sizeof(TKV));
  g.ns = THREADS / (g.lx * GB);
  g.tk = g.ns * KPT < TKMAX ? g.ns * KPT : TKMAX;
  if (kps < g.tk) g.tk = kps;
  g.tbl = (kps + bs - 1) / bs + 1;
  // the cp.async ring; after the key loop, the stream merge: (ns, GB)
  // rows of hd + 4 floats (padded against bank conflicts), (ns, GB)
  // maxes and sums and the merged (GB) max and sum
  const size_t ring = (size_t)STAGES * 2 * g.tk * hd * sizeof(TKV);
  const size_t merge =
      ((size_t)g.ns * GB * (hd + 4) + 2 * g.ns * GB + 2 * GB) * 4;
  g.smem = (((size_t)g.tbl * 4 + 15) / 16) * 16 +
           (ring > merge ? ring : merge);
  return g;
}

// q, out (B, H, hd); pools (NB, bs, KV, hd); tables (B, P); lens (B,);
// part_acc (B, H, n_split, hd) and part_ml (B, H, n_split, 2) f32 when
// n_split > 1.  grid (KV * hchunks, B, n_split), THREADS threads,
// geometry().smem shared bytes; a chunk of at most GB heads per block.
// Thread (x, y, z) = tid % lx, (tid / lx) % GB, tid / (lx GB): lane x of
// query head y in stream z.
template <typename TQ, typename TKV, int GB>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lens, TQ* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int H, int KV, int hd, int bs, int P, int n_split,
                    int kps, int lx, int tk, int tbl, float scale,
                    float logit_cap) {
  constexpr int VEC = 16 / sizeof(TKV);
  constexpr int EPL = CPL * VEC;    // elements of a row per lane
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tbl_s = reinterpret_cast<int32_t*>(smem);
  unsigned char* big = smem + ((tbl * 4 + 15) / 16) * 16;
  const uint32_t ring = smem_addr(big);   // the K/V tiles, later the merge

  const int tid = threadIdx.x;
  const int x = tid % lx;
  const int y = (tid / lx) % GB;
  const int z = tid / (lx * GB);
  const int ns = THREADS / (lx * GB);
  const int group = H / KV;
  const int hchunks = (group + GMAX - 1) / GMAX;
  const int kvh = blockIdx.x / hchunks;
  const int h0 = kvh * group + (blockIdx.x % hchunks) * GMAX;
  const int gcount = min(GB, kvh * group + group - h0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int kb = split * kps;
  const size_t bh0 = (size_t)b * H + h0;   // (row, first head)
  // the split's slice of the block table and this thread's slice of its
  // query head, read beside the row's length (neither depends on it)
  const int p_lo = kb / bs;
  const int n_tbl = min(tbl, P - p_lo);
  for (int i = tid; i < n_tbl; i += THREADS)
    tbl_s[i] = tables[(size_t)b * P + p_lo + i];
  const int cpr = hd / VEC;         // 16-byte chunks per row
  const bool head_ok = y < gcount;
  // lane x holds chunks x + lx i of the row (columns VEC (x + lx i) ..)
  float qr[EPL], acc[EPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = x + lx * i;
    load_q<VEC>(q + (bh0 + y) * hd + c * VEC, head_ok && c < cpr,
                qr + i * VEC);
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[i * VEC + u] = 0.f;
  }
  const int klen = min(lens[b], P * bs);
  const int ke = min(kb + kps, klen);

  if (kb >= klen && n_split > 1) {         // an empty partial
    if (tid < gcount) {
      const size_t at = ((bh0 + tid) * n_split + split) * 2;
      part_ml[at] = NEG_INF;
      part_ml[at + 1] = 0.f;
    }
    return;
  }
  float m = NEG_INF, l = 0.f;
  __syncthreads();                  // the table slice is in

  const int n_tiles = ke > kb ? (ke - kb + tk - 1) / tk : 0;
  const float sl2 = scale * LOG2E;
  const float cap2 = logit_cap * LOG2E;
  const size_t tile_bytes = (size_t)tk * hd * sizeof(TKV);
  // tile t into ring stage t % STAGES: K rows, then V rows; keys past
  // the split are zero-filled
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const uint32_t st = ring + (uint32_t)((t % STAGES) * 2 * tile_bytes);
      const int k0 = kb + t * tk;
      for (int i = tid; i < tk * cpr; i += THREADS) {
        const int j = i / cpr;
        const int c = i - j * cpr;
        const int key = k0 + j;
        const bool ok = key < ke;
        const size_t off = ok
            ? (((size_t)tbl_s[key / bs - p_lo] * bs + key % bs) * KV + kvh)
                  * hd + c * VEC
            : 0;
        const uint32_t dst = st + (uint32_t)(i * 16);
        cp_async16(dst, k_pool + off, ok);
        cp_async16(dst + (uint32_t)tile_bytes, v_pool + off, ok);
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + STAGES - 1);
    cp_wait<STAGES - 1>();
    __syncthreads();
    const unsigned char* kt = big + (size_t)(t % STAGES) * 2 * tile_bytes;
    const unsigned char* vt = kt + tile_bytes;
    // this stream's keys of the tile: j = z + ns * jj < nk
    const int k0 = kb + t * tk;
    const int nk = min(tk, ke - k0);
    // Branch-free, so every shared load of the tile can be in flight at
    // once: a row past the tile reads the tile's last row (its score is
    // masked below, its weight exactly 0) and a chunk past hd reads the
    // row's last chunk (q is 0 there; the accumulator's columns past hd
    // are never stored).
    float s[KPT];
    int cl[CPL];                    // this lane's chunks, clamped
#pragma unroll
    for (int i = 0; i < CPL; ++i) cl[i] = min(x + lx * i, cpr - 1);
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const uint4* kr = reinterpret_cast<const uint4*>(
          kt + (size_t)min(z + ns * jj, tk - 1) * cpr * 16);
      float d[CPL];                 // one partial sum per chunk
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float kf[VEC];
        unpack(kr[cl[i]], kf, TKV());
        d[i] = 0.f;
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          d[i] = fmaf(qr[i * VEC + u], kf[u], d[i]);
      }
      s[jj] = (d[0] + d[1]) + (d[2] + d[3]);
    }
    for (int o = lx >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj)
        s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], o);
    }
    // the online softmax in base 2 (scores times log2(e)), once per
    // tile; keys past the split get NEG_INF and exactly zero weight
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      float v = s[jj];
      if (logit_cap > 0.f)
        v = tanhf(v * scale / logit_cap) * cap2;
      else
        v *= sl2;
      s[jj] = z + ns * jj < nk ? v : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = s[jj] == NEG_INF ? 0.f : exp2f(s[jj] - mx);
      s[jj] = p;
      sum += p;
    }
    l = l * alpha + sum;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const uint4* vr = reinterpret_cast<const uint4*>(
          vt + (size_t)min(z + ns * jj, tk - 1) * cpr * 16);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float vf[VEC];
        unpack(vr[cl[i]], vf, TKV());
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          acc[i * VEC + u] = fmaf(s[jj], vf[u], acc[i * VEC + u]);
      }
    }
    __syncthreads();                // this stage is refilled next
  }
  cp_wait<0>();
  __syncthreads();                  // the ring becomes the merge buffer

  // merge the streams in stream order: (ns, GB, hd) accumulators, then
  // (ns, GB) maxes and sums, then the merged (GB) max and (GB) sum
  const int hs = hd + 4;            // padded row
  float* acc_s = reinterpret_cast<float*>(big);
  float* m_s = acc_s + ns * GB * hs;
  float* l_s = m_s + ns * GB;
  float* mm = l_s + ns * GB;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = x + lx * i;
    if (c < cpr) {
#pragma unroll
      for (int u = 0; u < VEC; u += 4)
        *reinterpret_cast<float4*>(acc_s + (z * GB + y) * hs + c * VEC +
                                   u) =
            make_float4(acc[i * VEC + u], acc[i * VEC + u + 1],
                        acc[i * VEC + u + 2], acc[i * VEC + u + 3]);
    }
  }
  if (x == 0) {
    m_s[z * GB + y] = m;
    l_s[z * GB + y] = l;
  }
  __syncthreads();
  if (tid < gcount) {               // weights of the streams, in order
    float mx = NEG_INF;
    for (int zz = 0; zz < ns; ++zz) mx = fmaxf(mx, m_s[zz * GB + tid]);
    float sum = 0.f;
    for (int zz = 0; zz < ns; ++zz) {
      const float w = exp2f(m_s[zz * GB + tid] - mx);
      m_s[zz * GB + tid] = w;
      sum += l_s[zz * GB + tid] * w;
    }
    mm[tid] = mx;
    mm[GB + tid] = sum;
  }
  __syncthreads();
  for (int d = tid; d < hd; d += THREADS) {   // GB independent chains
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= gcount) break;
      float a = 0.f;
      for (int zz = 0; zz < ns; ++zz)
        a = fmaf(acc_s[(zz * GB + g) * hs + d], m_s[zz * GB + g], a);
      if (n_split == 1)
        store(a / fmaxf(mm[GB + g], 1e-30f), out + (bh0 + g) * hd + d);
      else
        part_acc[((bh0 + g) * n_split + split) * hd + d] = a;
    }
  }
  if (n_split > 1 && tid < gcount) {
    const size_t at = ((bh0 + tid) * n_split + split) * 2;
    part_ml[at] = mm[tid];            // base-2 max
    part_ml[at + 1] = mm[GB + tid];
  }
}

// grid (H, B), THREADS threads, n_split (hd + 2) floats of shared
// memory: merge the nonempty splits of each (row, head) in a fixed order
// (split s into chain s % 4, the four chains summed pairwise; maxes in
// base 2, as the split kernel leaves them).
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel_merge(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int32_t* __restrict__ lens,
                          TQ* __restrict__ out, int H, int hd, int bs, int P,
                          int n_split, int kps) {
  extern __shared__ __align__(16) float smf[];
  float* acc_s = smf;                // (n_split, hd) accumulators, then
  float* sm = smf + n_split * hd;    // (n_split, 2) maxes and sums
  __shared__ float l_sum;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t bh = (size_t)b * H + h;
  const int klen = min(lens[b], P * bs);
  // launched as a programmatic dependent of the split kernel: wait here
  // until that grid has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // every partial into shared memory in one round trip (empty partials
  // are read and then skipped)
  const float* pml = part_ml + bh * n_split * 2;
  const float* pa = part_acc + bh * n_split * hd;
  const uint32_t acc_addr = smem_addr(acc_s);
  for (int i = threadIdx.x; i < n_split * hd / 4; i += THREADS)
    cp_async16(acc_addr + i * 16, pa + 4 * i, true);
  cp_commit();
  for (int i = threadIdx.x; i < 2 * n_split; i += THREADS) sm[i] = pml[i];
  const int nu = min(n_split, (klen + kps - 1) / kps);
  cp_wait<0>();
  __syncthreads();
  if (threadIdx.x < 32) {            // one warp: max, weights, sum
    float mx = NEG_INF;
    for (int s = threadIdx.x; s < nu; s += 32) mx = fmaxf(mx, sm[2 * s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    for (int s = threadIdx.x; s < nu; s += 32)
      sm[2 * s] = exp2f(sm[2 * s] - mx);     // the split's weight
    __syncwarp();
    if (threadIdx.x == 0) {          // the sum, in a fixed order
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < nu; s += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (s + u < nu)
            part[u] = fmaf(sm[2 * (s + u) + 1], sm[2 * (s + u)], part[u]);
      }
      l_sum = fmaxf((part[0] + part[1]) + (part[2] + part[3]), 1e-30f);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    // four interleaved chains of splits, combined in a fixed order
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < nu; s += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s + u < nu)
          a[u] = fmaf(acc_s[(s + u) * hd + d], sm[2 * (s + u)], a[u]);
    }
    store(((a[0] + a[1]) + (a[2] + a[3])) / l_sum, out + bh * hd + d);
  }
}

template <typename TQ, typename TKV, int GB>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int32_t* tables, const int32_t* lens, void* out,
           float* part_acc, float* part_ml, int B, int H, int KV, int hd,
           int bs, int P, int n_split, int kps, float scale,
           float logit_cap, void* stream) {
  const Geometry geo = geometry<TKV, GB>(hd, bs, kps);
  if (geo.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<TQ, TKV, GB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int group = H / KV;
  const dim3 grid(KV * ((group + GMAX - 1) / GMAX), B, n_split);
  paged_decode_kernel<TQ, TKV, GB>
      <<<grid, THREADS, geo.smem, (cudaStream_t)stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
          static_cast<const TKV*>(v_pool), tables, lens,
          static_cast<TQ*>(out), part_acc, part_ml, H, KV, hd, bs, P,
          n_split, kps, geo.lx, geo.tk, geo.tbl, scale, logit_cap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const size_t wbytes = (size_t)n_split * (hd + 2) * sizeof(float);
  if (wbytes > 48 * 1024) {
    e = cudaFuncSetAttribute(paged_decode_kernel_merge<TQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wbytes);
    if (e != cudaSuccess) return (int)e;
  }
  // a programmatic dependent launch: the merge grid may start (and read
  // the lengths) while the split grid drains; griddepcontrol.wait in the
  // merge kernel holds it until the split grid's writes are visible
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = wbytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_decode_kernel_merge<TQ>,
                         (const float*)part_acc, (const float*)part_ml, lens,
                         static_cast<TQ*>(out), H, hd, bs, P, n_split, kps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_group(const void* q, const void* k_pool, const void* v_pool,
                 const int32_t* tables, const int32_t* lens, void* out,
                 float* part_acc, float* part_ml, int B, int H, int KV,
                 int hd, int bs, int P, int n_split, int kps, float scale,
                 float logit_cap, void* stream) {
#define PAGED_ARGS                                                        \
  q, k_pool, v_pool, tables, lens, out, part_acc, part_ml, B, H, KV, hd, \
      bs, P, n_split, kps, scale, logit_cap, stream
  const int group = H / KV;
  if (group <= 1) return launch<TQ, TKV, 1>(PAGED_ARGS);
  if (group <= 2) return launch<TQ, TKV, 2>(PAGED_ARGS);
  if (group <= 4) return launch<TQ, TKV, 4>(PAGED_ARGS);
  return launch<TQ, TKV, 8>(PAGED_ARGS);
#undef PAGED_ARGS
}

}  // namespace

// q and out (B, H, hd) of q_dtype, pools (NB, bs, KV, hd) of kv_dtype
// (dtype codes: 0 float32, 1 bfloat16), 16-byte aligned; tables (B, P)
// int32 block ids; lens (B,) int32 valid keys per row; n_split splits of
// kps keys (n_split == ceil(P * bs / kps)); part_acc (B, H, n_split, hd)
// and part_ml (B, H, n_split, 2) f32 scratch, unused when n_split == 1.
// H % KV == 0, hd % 8 == 0 and hd <= 256.  All pointers are on the
// device; launches on `stream` (two kernels when n_split > 1) and returns
// cudaGetLastError().
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int32_t* tables, const int32_t* lens, void* out, float* part_acc,
    float* part_ml, int q_dtype, int kv_dtype, int B, int H, int KV, int hd,
    int bs, int P, int n_split, int kps, float scale, float logit_cap,
    void* stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || H % KV != 0 || hd <= 0 ||
      hd % 8 != 0 || hd > 256 || bs <= 0 || P <= 0 || kps <= 0 ||
      n_split <= 0 || n_split > 65535 ||
      n_split != (int)(((long)P * bs + kps - 1) / kps))
    return (int)cudaErrorInvalidValue;
#define PAGED_ARGS                                                        \
  q, k_pool, v_pool, tables, lens, out, part_acc, part_ml, B, H, KV, hd, \
      bs, P, n_split, kps, scale, logit_cap, stream
  switch (q_dtype * 2 + kv_dtype) {
    case 0: return launch_group<float, float>(PAGED_ARGS);
    case 1: return launch_group<float, bf16>(PAGED_ARGS);
    case 2: return launch_group<bf16, float>(PAGED_ARGS);
    case 3: return launch_group<bf16, bf16>(PAGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_ARGS
}
