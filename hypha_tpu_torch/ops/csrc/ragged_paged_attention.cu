// Ragged paged attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (hypha_tpu/ops/paged_attention.py:213-277, launched by
// `_ragged_attention_tpu`). Semantics are those of the plain PyTorch
// version `ragged_block_attention` in hypha_tpu_torch/ops/paged_attention.py:
//   out[b, i, h, :] = softmax_k(q[b, i, h] . K[k] * D^-0.5) V[k]
// over the keys k of lane b's occupied blocks, with the causal mask
// qi >= ki (qi = q_offset[b] + i), the pad floor ki >= k_start[b] and an
// optional window ki > qi - window. Sentinel table entries (== blocks),
// entries at j >= occupancy (sum(table[b] != blocks)) and blocks wholly
// past the lane's causal frontier are skipped. Fully masked rows and idle
// lanes give exact zeros. In int8 mode each pool row carries one f32
// scale per kv head and is dequantized as payload * scale in the loop.
//
// Layout: the pool is read in place, [(blocks + 1) * block_size, Hkv, D]:
// one head's row is D contiguous elements. q and out are [B, Sq, Hq, D].
//
// Two routes, one entry point; the caller picks by shape
// (`_ragged_route` in paged_attention.py), and both are held against the
// plain version on the card:
//   * "simt", ragged_kernel: f32 math on CUDA cores. It serves decode
//     (Sq = 1), which is bound by bytes: it reads every occupied K/V row
//     once per query head and does 4 flops per element read, so tensor
//     cores have nothing to win there. It also serves every f32 call: the
//     card tests hold f32 to 1e-4, and the reference pool run must give
//     the same tokens as generate, which bf16 products cannot promise.
//     One CTA per (lane, query head, tile of 8 query rows); its 4 warps
//     take the lane's blocks round robin, stage each block's keys in
//     shared memory as f32 with coalesced 16-byte loads, and each keeps an
//     f32 online softmax per query row (every lane owns D/32 dims; the q.k
//     dot is a warp all-reduce). The warps' partial (m, l, acc) merge
//     through shared memory at the end.
//   * "mma", ragged_mma_kernel: bf16 q (bf16 or int8 pools) with a
//     prefill chunk of queries. At Sq = 64 the work is 64 query rows
//     against each K/V row, ~250 flops per byte read, near the card's
//     ~295 bf16 flops per byte: the simt route, at 8 rows per CTA, re-read
//     every K/V block 8 times and did its dot products as shuffle
//     all-reduces. Here one CTA owns (lane, query head, 64 query rows),
//     4 warps of 16; Q is held as ldmatrix A fragments; K/V tiles of 64
//     logical keys are gathered row by row through the lane's table
//     (any block size) into a 2-stage ring of XOR-swizzled bf16 tiles,
//     by cp.async for bf16 pools and through registers (payload * scale)
//     for int8 pools; S = Q K^T and O += P V run on mma.sync.m16n8k16
//     bf16 -> f32 (attention_mma.cuh) with the online softmax in
//     registers. Rows whose entry is a sentinel or at or past the
//     occupancy are never read: they are zero-filled and masked.
// Not yet here: wgmma, TMA, sharing a K/V tile across a GQA group, split-K
// across CTAs for long lanes.
//
// Where the roundings depart from the Pallas kernel: the mma route rounds
// int8-dequantized K and V to bf16 (payload * scale in f32, then bf16)
// where the Pallas kernel keeps them f32 (:250-251); it rounds P to bf16
// before P V, as the Pallas kernel's p.astype(v.dtype) (:271) does for
// bf16 pools (for int8 pools the Pallas kernel multiplies f32 P by f32 V);
// and its exponentials are exp2 of log2-domain scores. The simt route
// keeps f32 throughout, as the plain version's streaming branch does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;   // query rows per CTA
constexpr int kKeys = 16;  // keys per shared-memory tile, per warp

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte load of pool elements, widened to f32.
template <typename KV>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* o) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    float4 f = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = f.x;
    o[1] = f.y;
    o[2] = f.z;
    o[3] = f.w;
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* o) {
    int4 u = __ldg(reinterpret_cast<const int4*>(p));
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = static_cast<float>(c[i]);
  }
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, const KV* __restrict__ kpool,
              const KV* __restrict__ vpool, const float* __restrict__ kscale,
              const float* __restrict__ vscale, const int* __restrict__ table,
              const int* __restrict__ q_offset, const int* __restrict__ k_start,
              T* __restrict__ out, int Sq, int Hq, int Hkv, int blocks, int bs,
              int max_blocks, int window, int has_window, float scale) {
  constexpr int DPL = D / 32;  // dims owned by each lane
  constexpr int VN = Vec<KV>::N;
  constexpr int VPR = D / VN;  // 16-byte vectors per pool row
  extern __shared__ float smem[];
  __shared__ int s_count;

  const int b = blockIdx.x / Hq;
  const int hq = blockIdx.x % Hq;
  const int hkv = hq / (Hq / Hkv);
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, Sq - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int* tab = table + static_cast<size_t>(b) * max_blocks;

  // Occupancy: the number of non-sentinel entries, as the reference counts it.
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  int c = 0;
  for (int j = threadIdx.x; j < max_blocks; j += kThreads) c += (tab[j] != blocks);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (lane == 0) atomicAdd(&s_count, c);
  __syncthreads();
  const int count = s_count;

  const int qoff = q_offset[b];
  const int kst = k_start[b];
  const int q_last = qoff + row0 + nrows - 1;

  float qr[kRows][DPL];
  float acc[kRows][DPL];
  float m[kRows];
  float l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    const T* qp = q + ((static_cast<size_t>(b) * Sq + row0 + r) * Hq + hq) * D + lane * DPL;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      acc[r][d] = 0.f;
      qr[r][d] = 0.f;
      if (r < nrows) qr[r][d] = to_f<T>(qp[d]);
    }
  }

  float* ks = smem + warp * (2 * kKeys * D);
  float* vs = ks + kKeys * D;
  const size_t row_stride = static_cast<size_t>(Hkv) * D;

  for (int j = warp; j < count; j += kWarps) {
    const int entry = tab[j];
    if (entry == blocks) continue;
    if (static_cast<long long>(j) * bs > q_last) break;  // past the causal frontier
    const int blk = min(max(entry, 0), blocks);
    for (int t0 = 0; t0 < bs; t0 += kKeys) {
      const int nk = min(kKeys, bs - t0);
      for (int e = lane; e < nk * VPR; e += 32) {
        const int key = e / VPR;
        const int d0 = (e % VPR) * VN;
        const size_t prow = static_cast<size_t>(blk) * bs + t0 + key;
        const size_t off = prow * row_stride + static_cast<size_t>(hkv) * D + d0;
        float kf[VN], vf[VN];
        Vec<KV>::load(kpool + off, kf);
        Vec<KV>::load(vpool + off, vf);
        float ksc = 1.f, vsc = 1.f;
        if (kscale != nullptr) {
          ksc = kscale[prow * Hkv + hkv];
          vsc = vscale[prow * Hkv + hkv];
        }
#pragma unroll
        for (int i = 0; i < VN; ++i) {
          ks[key * D + d0 + i] = kf[i] * ksc;
          vs[key * D + d0 + i] = vf[i] * vsc;
        }
      }
      __syncwarp();
      for (int i = 0; i < nk; ++i) {
        const int ki = j * bs + t0 + i;
        float kd[DPL], vd[DPL];
#pragma unroll
        for (int d = 0; d < DPL; ++d) {
          kd[d] = ks[i * D + lane * DPL + d];
          vd[d] = vs[i * D + lane * DPL + d];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r >= nrows) break;
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < DPL; ++d) s = fmaf(qr[r][d], kd[d], s);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          s *= scale;
          const int qi = qoff + row0 + r;
          const bool keep = qi >= ki && ki >= kst && (!has_window || ki > qi - window);
          if (!keep) continue;
          const float m_new = fmaxf(m[r], s);
          const float alpha = expf(m[r] - m_new);  // exp(-inf) = 0 on the first key
          const float p = expf(s - m_new);
          l[r] = l[r] * alpha + p;
#pragma unroll
          for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(p, vd[d], acc[r][d] * alpha);
          m[r] = m_new;
        }
      }
      __syncwarp();
    }
  }

  // Merge the warps' partial softmax states through shared memory.
  __syncthreads();
  float* ms = smem;                    // [kWarps][kRows]
  float* ls = ms + kWarps * kRows;     // [kWarps][kRows]
  float* as = ls + kWarps * kRows;     // [kWarps][kRows][D]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (lane == 0) {
      ms[warp * kRows + r] = m[r];
      ls[warp * kRows + r] = l[r];
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) as[(warp * kRows + r) * D + lane * DPL + d] = acc[r][d];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * kRows + r]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = ms[w * kRows + r];
        if (mw == -INFINITY) continue;
        const float f = expf(mw - mx);
        lsum += ls[w * kRows + r] * f;
        o += as[(w * kRows + r) * D + d] * f;
      }
    }
    out[((static_cast<size_t>(b) * Sq + row0 + r) * Hq + hq) * D + d] =
        from_f<T>(o / fmaxf(lsum, 1e-20f));
  }
}

// ------------------------------------------- prefill chunks, tensor cores

constexpr int kMmaRows = 64;  // query rows per CTA: 4 warps x 16
constexpr int kMmaKeys = 64;  // logical keys per K/V tile
constexpr int kMmaThreads = (kMmaRows / 16) * 32;

// Gather the lane's logical keys [k0, k0 + kMmaKeys) for kv head hkv into
// swizzled bf16 tiles. Key ki lives at pool row table[ki / bs] * bs +
// ki % bs; it is read only if ki < k_hi and its entry lies below the
// occupancy and is not the sentinel. Other rows are zero-filled and marked
// 0 in `valid`. bf16 pools copy by cp.async (the caller commits); int8
// pools load through registers and store payload * scale rounded to bf16.
template <typename KV, int D>
__device__ __forceinline__ void stage_keys(__nv_bfloat16* kdst, __nv_bfloat16* vdst, int* valid,
                                           const KV* kpool, const KV* vpool,
                                           const float* kscale, const float* vscale,
                                           const int* tab, int count, int blocks, int bs,
                                           int Hkv, int hkv, int k0, int k_hi) {
  using namespace attn_mma;
  constexpr int BYTES = sizeof(KV);
  constexpr int CPR = D * BYTES / 16;  // 16-byte source chunks per row
  constexpr int EPC = 16 / BYTES;      // elements per source chunk
#pragma unroll
  for (int i = 0; i < kMmaKeys * CPR / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / CPR;
    const int c = e % CPR;
    const int ki = k0 + r;
    const int j = ki / bs;
    bool ok = ki < k_hi && j < count;
    const int entry = ok ? tab[j] : blocks;
    ok = ok && entry != blocks;
    const size_t prow = static_cast<size_t>(min(max(entry, 0), blocks)) * bs + (ki - j * bs);
    const size_t off = (prow * Hkv + hkv) * D + static_cast<size_t>(c) * EPC;
    if (c == 0) valid[r] = ok;
    if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
      cp_async_16(smem_u32(kdst + swz<D>(r, c)), ok ? kpool + off : kpool, ok ? 16 : 0);
      cp_async_16(smem_u32(vdst + swz<D>(r, c)), ok ? vpool + off : vpool, ok ? 16 : 0);
    } else {
      uint4 kw[2] = {}, vw[2] = {};
      if (ok) {
        const int4 kr = __ldg(reinterpret_cast<const int4*>(kpool + off));
        const int4 vr = __ldg(reinterpret_cast<const int4*>(vpool + off));
        const float ksc = kscale[prow * Hkv + hkv];
        const float vsc = vscale[prow * Hkv + hkv];
        const int8_t* kc = reinterpret_cast<const int8_t*>(&kr);
        const int8_t* vc = reinterpret_cast<const int8_t*>(&vr);
        uint32_t* kp = reinterpret_cast<uint32_t*>(kw);
        uint32_t* vp = reinterpret_cast<uint32_t*>(vw);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          kp[x] = pack_bf16(static_cast<float>(kc[2 * x]) * ksc,
                            static_cast<float>(kc[2 * x + 1]) * ksc);
          vp[x] = pack_bf16(static_cast<float>(vc[2 * x]) * vsc,
                            static_cast<float>(vc[2 * x + 1]) * vsc);
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        *reinterpret_cast<uint4*>(kdst + swz<D>(r, 2 * c + x)) = kw[x];
        *reinterpret_cast<uint4*>(vdst + swz<D>(r, 2 * c + x)) = vw[x];
      }
    }
  }
}

template <typename KV, int D>
__global__ void __launch_bounds__(kMmaThreads)
ragged_mma_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kpool,
                  const KV* __restrict__ vpool, const float* __restrict__ kscale,
                  const float* __restrict__ vscale, const int* __restrict__ table,
                  const int* __restrict__ q_offset, const int* __restrict__ k_start,
                  __nv_bfloat16* __restrict__ out, int Sq, int Hq, int Hkv, int blocks, int bs,
                  int max_blocks, int window, int has_window, float scale) {
  using namespace attn_mma;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kMmaRows][D]
  __nv_bfloat16* ks = qs + kMmaRows * D;                            // [2][kMmaKeys][D]
  __nv_bfloat16* vs = ks + 2 * kMmaKeys * D;                        // [2][kMmaKeys][D]
  int* valid = reinterpret_cast<int*>(vs + 2 * kMmaKeys * D);       // [2][kMmaKeys]
  __shared__ int s_count;

  const int b = blockIdx.x / Hq;
  const int hq = blockIdx.x % Hq;
  const int hkv = hq / (Hq / Hkv);
  const int row0 = blockIdx.y * kMmaRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* tab = table + static_cast<size_t>(b) * max_blocks;

  // Occupancy: the number of non-sentinel entries, as the reference counts it.
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  int c = 0;
  for (int j = threadIdx.x; j < max_blocks; j += kMmaThreads) c += (tab[j] != blocks);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (lane == 0) atomicAdd(&s_count, c);
  __syncthreads();
  const int count = s_count;

  const int qoff = q_offset[b];
  const int kst = k_start[b];
  const int q_first = qoff + row0;
  const int q_last = qoff + min(row0 + kMmaRows, Sq) - 1;
  // Keys from the window's and k_start's first tile up to the causal
  // frontier of the tile's last row, and never past the occupied blocks.
  int k_lo = max(kst, 0);
  if (has_window) k_lo = max(k_lo, q_first - window + 1);
  const long long k_hi_ll = min(static_cast<long long>(count) * bs, q_last + 1LL);
  const int k_hi = static_cast<int>(max(k_hi_ll, 0LL));
  const int t_lo = (k_lo / kMmaKeys) * kMmaKeys;
  const int n_tiles = k_hi > t_lo ? (k_hi - t_lo + kMmaKeys - 1) / kMmaKeys : 0;

  stage_rows<D, kMmaRows, kMmaThreads>(qs, q + (static_cast<size_t>(b) * Sq * Hq + hq) * D,
                                       static_cast<long long>(Hq) * D, row0, Sq);
  if (n_tiles > 0)
    stage_keys<KV, D>(ks, vs, valid, kpool, vpool, kscale, vscale, tab, count, blocks, bs, Hkv,
                      hkv, t_lo, k_hi);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a_rows<D>(qf, qs, warp * 16, lane);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int wr = row0 + warp * 16;  // the warp's first query row
  const int wq = qoff + wr;         // and its position
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = t_lo + it * kMmaKeys;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) & 1;
      stage_keys<KV, D>(ks + nx * kMmaKeys * D, vs + nx * kMmaKeys * D, valid + nx * kMmaKeys,
                        kpool, vpool, kscale, vscale, tab, count, blocks, bs, Hkv, hkv,
                        k0 + kMmaKeys, k_hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // Rows past Sq are never stored; a tile wholly above the warp's
    // causal frontier or wholly behind its window changes nothing.
    const bool skip = wr >= Sq || k0 > wq + 15 ||
                      (has_window && k0 + kMmaKeys - 1 <= wq - window);
    if (!skip) {
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      qk_tile<D>(s, qf, ks + st * kMmaKeys * D, lane);
      const int* vld = valid + st * kMmaKeys;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          const int ki = k0 + col;
          const int qi = wq + g + (e >> 1) * 8;
          const bool keep =
              vld[col] && qi >= ki && ki >= kst && (!has_window || ki > qi - window);
          s[n][e] = keep ? s[n][e] * sl2 : -INFINITY;
        }
      }
      softmax_step<D>(s, m, l, acc);
      pv_tile<D>(acc, s, vs + st * kMmaKeys * D, lane);
    }
    __syncthreads();  // the next copies overwrite the stage just read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + r * 8;
    const float den = fmaxf(quad_sum(l[r]), 1e-20f);
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Sq + row) * Hq + hq) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *table, *q_offset, *k_start;
  void* out;
  int B, Sq, Hq, Hkv, blocks, bs, max_blocks, window, has_window;
};

template <typename T, typename KV, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t tiles = static_cast<size_t>(kWarps) * 2 * kKeys * D * sizeof(float);
  const size_t merge =
      (static_cast<size_t>(2) * kWarps * kRows + static_cast<size_t>(kWarps) * kRows * D) *
      sizeof(float);
  const size_t smem = tiles > merge ? tiles : merge;
  auto kern = ragged_kernel<T, KV, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.Hq, (a.Sq + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      a.ks, a.vs, a.table, a.q_offset, a.k_start, static_cast<T*>(a.out), a.Sq, a.Hq, a.Hkv,
      a.blocks, a.bs, a.max_blocks, a.window, a.has_window, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename KV, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kMmaRows + 4 * kMmaKeys) * D * sizeof(__nv_bfloat16) +
                      2 * kMmaKeys * sizeof(int);
  auto kern = ragged_mma_kernel<KV, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.Hq, (a.Sq + kMmaRows - 1) / kMmaRows);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.ks, a.vs, a.table, a.q_offset, a.k_start,
      static_cast<__nv_bfloat16*>(a.out), a.Sq, a.Hq, a.Hkv, a.blocks, a.bs, a.max_blocks,
      a.window, a.has_window, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// route 0: the simt kernel; route 1: the mma kernel (bf16 q only).
template <typename T, typename KV>
cudaError_t launch_d(const Args& a, int D, int route, cudaStream_t stream) {
  if (route == 0) {
    if (D == 64) return launch<T, KV, 64>(a, stream);
    if (D == 128) return launch<T, KV, 128>(a, stream);
  } else if (route == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (D == 64) return launch_mma<KV, 64>(a, stream);
      if (D == 128) return launch_mma<KV, 128>(a, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of the
// launch: 0 on success. q_dtype: 0 = bfloat16, 1 = float32; kv_int8 != 0
// reads int8 pools with per-(row, kv-head) f32 scales; route: 0 = simt,
// 1 = mma (bf16 q only; anything else is cudaErrorInvalidValue).
extern "C" int ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* table, const void* q_offset, const void* k_start, void* out, int B, int Sq,
    int Hq, int Hkv, int D, int blocks, int block_size, int max_blocks, int window,
    int has_window, int q_dtype, int kv_int8, int route, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,
         k,
         v,
         static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(table),
         static_cast<const int*>(q_offset),
         static_cast<const int*>(k_start),
         out,
         B,
         Sq,
         Hq,
         Hkv,
         blocks,
         block_size,
         max_blocks,
         window,
         has_window};
  if (!kv_int8) a.ks = a.vs = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0) {
    err = kv_int8 ? launch_d<__nv_bfloat16, int8_t>(a, D, route, st)
                  : launch_d<__nv_bfloat16, __nv_bfloat16>(a, D, route, st);
  } else if (q_dtype == 1) {
    err = kv_int8 ? launch_d<float, int8_t>(a, D, route, st)
                  : launch_d<float, float>(a, D, route, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ragged_paged_attention_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
