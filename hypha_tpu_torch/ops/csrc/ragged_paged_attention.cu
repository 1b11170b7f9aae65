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
// Three routes, one entry point; the caller picks by shape and dtype
// (`_ragged_route` in paged_attention.py), and each is held against the
// plain version on the card:
//   * "decode", ragged_decode_kernel (+ ragged_decode_merge_kernel): bf16
//     q with one query row (bf16 or int8 pools). Decode is bound by bytes:
//     each K/V element read feeds one multiply-add per query head of its
//     group, ~1 flop per byte against the card's ~295 bf16 flops per byte,
//     so the only gain is in moving each byte once and keeping enough of
//     them in flight. One CTA per (lane, kv head, key split) computes all
//     G = Hq / Hkv query heads of its kv head (G need not be a power of
//     two; past 8 heads the group is cut into CTAs of 8), so each occupied
//     K/V row leaves HBM once per kv head per call. The lane's visible keys
//     [k_lo, k_hi) (k_start, window and causal frontier applied, never past
//     the occupied blocks) are cut into 32-key tiles and the tiles into
//     `splits` contiguous runs, one per CTA ("flash-decoding"); the count
//     comes from the shapes alone (`_decode_splits`), so a launch is the
//     same at every step. Inside the CTA the run is dealt out in 8-key warp
//     tiles, and each of the 4 warps is its own pipeline with no barrier
//     across the CTA: it gathers its tiles row by row through the table
//     into a private 4-stage cp.async ring (bf16: 16-byte chunks; int8: the
//     payload and its f32 scales, dequantised as the tile leaves shared
//     memory, by byte permute rather than the quarter-rate I2F), so three
//     tiles are in flight while one is computed. Per tile: each key's dot
//     product is split over D/8 lanes of 8 dims (4 or 3 shuffles), the
//     tile's scores stay in registers, then one max, one rescale and P.V
//     into f32 registers. The warps' (m, l, acc) merge in warp order at
//     the end. All arithmetic is f32 on CUDA cores, as in the plain
//     version's streaming branch; the output rounds to bf16 once. With one
//     split the CTA writes the output; with more, each split writes its
//     (m, l, acc) partial to an f32 workspace and the merge kernel combines
//     them in split order (no atomics: reruns give the same bits; a second
//     small kernel rather than a last-CTA merge, because that needs a
//     counter buffer kept at zero between calls, and at the Llama-2-7B
//     serving shape the rule picks one split, so no merge launches). A
//     split with no visible key writes m = -inf, l = 0 and exits.
//   * "simt", ragged_kernel: f32 math on CUDA cores for every f32 call
//     (the card tests hold f32 to 1e-4, and the reference pool run must
//     give the same tokens as generate, which bf16 products cannot
//     promise) and for bf16 chunks of 2 to 15 query rows. One CTA per
//     (lane, query head, tile of 8 query rows); its 4 warps take the
//     lane's blocks round robin, stage each block's keys in shared memory
//     as f32 with coalesced 16-byte loads, and each keeps an f32 online
//     softmax per query row (every lane owns D/32 dims; the q.k dot is a
//     warp all-reduce). The warps' partial (m, l, acc) merge through
//     shared memory at the end.
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
// Not yet here: wgmma and TMA for the prefill chunks, and sharing a K/V
// tile across a GQA group there.
//
// Where the roundings depart from the Pallas kernel: the mma route rounds
// int8-dequantized K and V to bf16 (payload * scale in f32, then bf16)
// where the Pallas kernel keeps them f32 (:250-251); it rounds P to bf16
// before P V, as the Pallas kernel's p.astype(v.dtype) (:271) does for
// bf16 pools (for int8 pools the Pallas kernel multiplies f32 P by f32 V);
// and its exponentials are exp2 of log2-domain scores. The simt and
// decode routes keep f32 throughout, as the plain version's streaming
// branch does (decode: exp2 of log2-domain scores, and an int8 row's scale
// applied to the dot product and to P rather than to each element).

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

// ------------------------------------------- decode: split-KV, GQA-packed

// A deeper ring (5 or 6 stages), 16-key warp tiles or an L2 prefetch-size
// hint on the copies measured no faster at the serving shape: the MHA call
// runs at the rate the pool's head-interleaved 256-byte rows allow, and
// the GQA call is bound by latency.
constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecKeys = 32;   // logical keys per split tile: splits cut at multiples of it
constexpr int kWarpKeys = 8;   // keys of one warp tile
constexpr int kDecStages = 4;  // each warp's cp.async ring: three tiles in flight, one computed

// 4-byte global -> shared copy (an int8 row's scale); src_bytes 0 writes a
// zero and reads nothing.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Bytes of one stage of a warp's ring: the K and V tiles, then (int8) their
// scales, then the rows' valid flags.
template <typename KV, int D>
__host__ __device__ constexpr int dec_stage_bytes() {
  return 2 * kWarpKeys * D * static_cast<int>(sizeof(KV)) +
         (sizeof(KV) == 1 ? 2 * kWarpKeys * 4 : 0) + kWarpKeys * 4;
}

// One warp gathers the lane's logical keys [k0, k0 + kWarpKeys) for kv
// head hkv into a stage of its ring, row-major [kWarpKeys][D] (a lane later
// reads 8 dims of a row, 16 bytes of bf16 or 8 of int8, contiguous across
// the row's lanes, so no swizzle is needed). Key ki lives at pool row
// table[ki / bs] * bs + ki % bs and is read only if ki < k_hi and its entry
// lies below the occupancy and is not the sentinel; other rows are
// zero-filled and get valid = 0. Lane r < kWarpKeys resolves row r, the
// others take its pool row by shuffle. The caller commits.
template <typename KV, int D>
__device__ __forceinline__ void stage_decode(unsigned char* stage, const KV* kpool,
                                             const KV* vpool, const float* kscale,
                                             const float* vscale, const int* tab, int count,
                                             int blocks, int bs, int Hkv, int hkv, int k0,
                                             int k_hi, int lane) {
  using namespace attn_mma;
  constexpr int CPR = D * static_cast<int>(sizeof(KV)) / 16;  // 16-byte chunks per row
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));      // elements per chunk
  static_assert(kWarpKeys * CPR % 32 == 0, "whole chunks per lane");
  KV* kdst = reinterpret_cast<KV*>(stage);
  KV* vdst = kdst + kWarpKeys * D;
  float* ksd = reinterpret_cast<float*>(vdst + kWarpKeys * D);
  float* vsd = ksd + kWarpKeys;
  int* valid = reinterpret_cast<int*>(stage + dec_stage_bytes<KV, D>()) - kWarpKeys;
  int prow = -1;  // lane r's row: its pool row, or -1 where it is not read
  if (lane < kWarpKeys) {
    const int ki = k0 + lane;
    const int j = ki / bs;
    if (ki < k_hi && j < count) {
      const int entry = tab[j];
      if (entry != blocks) prow = min(max(entry, 0), blocks) * bs + (ki - j * bs);
    }
    valid[lane] = prow >= 0;
  }
#pragma unroll
  for (int i = 0; i < kWarpKeys * CPR / 32; ++i) {
    const int e = lane + i * 32;
    const int r = e / CPR;
    const int c = e % CPR;
    const int pr = __shfl_sync(0xffffffffu, prow, r);
    const bool ok = pr >= 0;
    const size_t off = (static_cast<size_t>(ok ? pr : 0) * Hkv + hkv) * D +
                       static_cast<size_t>(c) * EPC;
    cp_async_16(smem_u32(kdst + r * D + c * EPC), kpool + off, ok ? 16 : 0);
    cp_async_16(smem_u32(vdst + r * D + c * EPC), vpool + off, ok ? 16 : 0);
  }
  if constexpr (sizeof(KV) == 1) {
    const int r = lane % kWarpKeys;
    const int pr = __shfl_sync(0xffffffffu, prow, r);
    const size_t so = static_cast<size_t>(pr >= 0 ? pr : 0) * Hkv + hkv;
    if (lane < kWarpKeys)
      cp_async_4(smem_u32(ksd + r), kscale + so, pr >= 0 ? 4 : 0);
    else if (lane < 2 * kWarpKeys)
      cp_async_4(smem_u32(vsd + r), vscale + so, pr >= 0 ? 4 : 0);
  }
}

// 8 consecutive pool elements from shared memory, widened to f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// int8 to f32 without the quarter-rate I2F: byte x ^ 0x80 = x + 128 placed
// in the mantissa of 2^23 gives 2^23 + 128 + x exactly, one byte permute
// and one add per element.
__device__ __forceinline__ void load8(const int8_t* p, float (&o)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7540u + (i % 4))) - 8388736.f;
}

// One CTA per (key split, kv head x head chunk, lane); GM is the largest
// number of query heads a CTA takes (1, 4 or 8; a group of G heads takes
// min(G, GM) per CTA). The split's keys are cut into 8-key warp tiles,
// dealt round robin to the 4 warps; each warp runs its own cp.async ring
// and its own online softmax, with no barrier across the CTA until the
// warps' (m, l, acc) merge at the end. In a warp, lane t owns dims
// [8 (t % CPR), +8) of the keys of group t / CPR: the group's CPR lanes
// split each key's dot product (log2 CPR shuffles), and accumulate P V for
// those dims over the group's keys.
template <typename KV, int D, int GM>
__global__ void __launch_bounds__(kDecThreads)
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kpool,
                     const KV* __restrict__ vpool, const float* __restrict__ kscale,
                     const float* __restrict__ vscale, const int* __restrict__ table,
                     const int* __restrict__ q_offset, const int* __restrict__ k_start,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int Hq, int Hkv,
                     int blocks, int bs, int max_blocks, int window, int has_window,
                     float scale) {
  constexpr int CPR = D / 8;                // lanes per key
  constexpr int KW = 32 / CPR;              // keys a warp takes at once
  constexpr int STEPS = kWarpKeys / KW;     // such steps per warp tile
  constexpr int STAGE = dec_stage_bytes<KV, D>();
  constexpr int RING = kDecStages * STAGE;  // one warp's ring
  constexpr bool kQuant = sizeof(KV) == 1;
  static_assert(kWarpKeys % KW == 0, "whole steps per warp tile");
  static_assert(RING >= GM * D * 4, "a warp's ring holds its partial accumulator at the end");
  extern __shared__ __align__(16) unsigned char smem_dec[];
  float* wml = reinterpret_cast<float*>(smem_dec + kDecWarps * RING);  // [2][warps][GM]

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int G = Hq / Hkv;
  const int ngc = (G + GM - 1) / GM;
  const int hkv = blockIdx.y / ngc;
  const int g0 = (blockIdx.y % ngc) * GM;
  const int gn = min(GM, G - g0);           // query heads of this CTA
  const int hq0 = hkv * G + g0;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane % CPR;
  const int grp = lane / CPR;
  const int* tab = table + static_cast<size_t>(b) * max_blocks;
  const int qi = q_offset[b];
  const int kst = k_start[b];

  // Occupancy: the number of non-sentinel entries, as the reference counts
  // it; each warp counts for itself, so no barrier is needed.
  int count = 0;
  for (int j = lane; j < max_blocks; j += 32) count += (tab[j] != blocks);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(0xffffffffu, count, o);

  // The visible keys: from k_start and the window's first key up to the
  // query's own position, never past the occupied blocks. This split takes
  // the keys of split tiles [t0, t1) of them.
  int k_lo = max(kst, 0);
  if (has_window) k_lo = max(k_lo, qi - window + 1);
  const int k_hi = static_cast<int>(min(static_cast<long long>(count) * bs, qi + 1LL));
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kDecKeys - 1) / kDecKeys : 0;
  const int t0 = static_cast<int>(static_cast<long long>(n_tiles) * split / splits);
  const int t1 = static_cast<int>(static_cast<long long>(n_tiles) * (split + 1) / splits);
  const size_t rows = static_cast<size_t>(B) * Hq;  // workspace: m [rows][splits], l, acc [.][D]
  if (t1 == t0 && splits > 1) {  // nothing visible: an empty partial
    if (threadIdx.x < gn) {
      const size_t idx = (static_cast<size_t>(b) * Hq + hq0 + threadIdx.x) * splits + split;
      ws[idx] = -INFINITY;
      ws[rows * splits + idx] = 0.f;
    }
    return;
  }
  const int k_first = k_lo + t0 * kDecKeys;
  const int k_end = min(k_lo + t1 * kDecKeys, k_hi);
  const int n_wt = (k_end - k_first + kWarpKeys - 1) / kWarpKeys;  // warp tiles of the split
  const int nw = n_wt > warp ? (n_wt - warp + kDecWarps - 1) / kDecWarps : 0;  // this warp's

  float qf[GM][8];
  float acc[GM][8];
  float m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] = acc[g][i] = 0.f;
    if (g < gn) load8(q + (static_cast<size_t>(b) * Hq + hq0 + g) * D + c * 8, qf[g]);
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const float sl2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  unsigned char* ring = smem_dec + warp * RING;

#pragma unroll
  for (int p = 0; p < kDecStages - 1; ++p) {
    if (p < nw)
      stage_decode<KV, D>(ring + p * STAGE, kpool, vpool, kscale, vscale, tab, count, blocks,
                          bs, Hkv, hkv, k_first + (warp + p * kDecWarps) * kWarpKeys, k_end,
                          lane);
    attn_mma::cp_async_commit();
  }
  for (int it = 0; it < nw; ++it) {
    attn_mma::cp_async_wait<kDecStages - 2>();
    __syncwarp();  // tile `it` has landed for every lane; all are done with tile it - 1
    const int nx = it + kDecStages - 1;
    if (nx < nw)
      stage_decode<KV, D>(ring + (nx % kDecStages) * STAGE, kpool, vpool, kscale, vscale, tab,
                          count, blocks, bs, Hkv, hkv,
                          k_first + (warp + nx * kDecWarps) * kWarpKeys, k_end, lane);
    attn_mma::cp_async_commit();
    const unsigned char* st = ring + (it % kDecStages) * STAGE;
    const KV* kt = reinterpret_cast<const KV*>(st);
    const KV* vt = kt + kWarpKeys * D;
    const float* ksd = reinterpret_cast<const float*>(vt + kWarpKeys * D);
    const float* vsd = ksd + kWarpKeys;
    const int* valid = reinterpret_cast<const int*>(st + STAGE) - kWarpKeys;

    // Scores of the group's keys of the tile, log2 domain; rows not read
    // are -inf. Every lane of the group ends with the whole dot product.
    float s[GM][STEPS];
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      const int r = grp + t * KW;
      float kf[8];
      load8(kt + r * D + c * 8, kf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qf[g][i], kf[i], d);
        s[g][t] = d;
      }
#pragma unroll
      for (int o = CPR / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g][t] += __shfl_xor_sync(0xffffffffu, s[g][t], o);
      }
      const float f = kQuant ? ksd[r] * sl2 : sl2;
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g][t] = valid[r] ? s[g][t] * f : -INFINITY;
    }

    // One max and one rescale per head and warp tile, then P V.
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = s[g][0];
#pragma unroll
      for (int t = 1; t < STEPS; ++t) mx = fmaxf(mx, s[g][t]);
#pragma unroll
      for (int o = CPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[g] - safe);  // 0 while m is -inf
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < STEPS; ++t) {
        s[g][t] = exp2f(s[g][t] - safe);  // 0 for a row not read
        sum += s[g][t];
      }
#pragma unroll
      for (int o = CPR; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      const int r = grp + t * KW;
      float vf[8];
      load8(vt + r * D + c * 8, vf);
      const float vs = kQuant ? vsd[r] : 1.f;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = kQuant ? s[g][t] * vs : s[g][t];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
  }

  // The warp's groups hold partial sums of the same dims: add them, park
  // the warp's (m, l, acc) in its own ring, and merge the warps in order.
#pragma unroll
  for (int o = CPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
    }
  }
  attn_mma::cp_async_wait<0>();
  __syncwarp();  // no copy or read of the ring is left in flight
  float* wacc = reinterpret_cast<float*>(ring);  // [GM][D]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < gn) {
        float4* dst = reinterpret_cast<float4*>(wacc + g * D + c * 8);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      wml[warp * GM + g] = m[g];
      wml[(kDecWarps + warp) * GM + g] = l[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gn * D; e += kDecThreads) {
    const int g = e / D;
    const int dd = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, wml[w * GM + g]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float mw = wml[w * GM + g];
        if (mw == -INFINITY) continue;
        const float f = exp2f(mw - mx);
        lsum += wml[(kDecWarps + w) * GM + g] * f;
        o += reinterpret_cast<const float*>(smem_dec + w * RING)[g * D + dd] * f;
      }
    }
    const size_t row = static_cast<size_t>(b) * Hq + hq0 + g;
    if (splits == 1) {
      out[row * D + dd] = __float2bfloat16(o / fmaxf(lsum, 1e-20f));
    } else {
      const size_t idx = row * splits + split;
      ws[2 * rows * splits + idx * D + dd] = o;
      if (dd == 0) {
        ws[idx] = mx;
        ws[rows * splits + idx] = lsum;
      }
    }
  }
}

// One CTA per (lane, query head), one thread per dim: the splits' partials
// in split order, those with no visible key skipped. A row no split saw
// gives exact zeros, as the plain version's acc / max(l, 1e-20) does.
template <int D>
__global__ void __launch_bounds__(D)
ragged_decode_merge_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                           int rows, int splits) {
  const size_t row = blockIdx.x;
  const int dd = threadIdx.x;
  const float* m = ws + row * splits;
  const float* l = ws + static_cast<size_t>(rows) * splits + row * splits;
  const float* acc = ws + 2 * static_cast<size_t>(rows) * splits + row * splits * D;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s]);
  float lsum = 0.f, o = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      if (m[s] == -INFINITY) continue;
      const float f = exp2f(m[s] - mx);
      lsum += l[s] * f;
      o += acc[static_cast<size_t>(s) * D + dd] * f;
    }
  }
  out[row * D + dd] = __float2bfloat16(o / fmaxf(lsum, 1e-20f));
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *table, *q_offset, *k_start;
  void* out;
  int B, Sq, Hq, Hkv, blocks, bs, max_blocks, window, has_window;
  int splits;  // the decode route's key splits
  float* ws;   // and its f32 workspace (splits > 1)
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

template <typename KV, int D, int GM>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(kDecWarps) * kDecStages * dec_stage_bytes<KV, D>() +
                          2 * kDecWarps * GM * sizeof(float);
  auto kern = ragged_decode_kernel<KV, D, GM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int ngc = (a.Hq / a.Hkv + GM - 1) / GM;
  dim3 grid(a.splits, a.Hkv * ngc, a.B);
  kern<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.ks, a.vs, a.table, a.q_offset, a.k_start,
      static_cast<__nv_bfloat16*>(a.out), a.ws, a.Hq, a.Hkv, a.blocks, a.bs, a.max_blocks,
      a.window, a.has_window, 1.0f / sqrtf(static_cast<float>(D)));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  ragged_decode_merge_kernel<D><<<a.B * a.Hq, D, 0, stream>>>(
      a.ws, static_cast<__nv_bfloat16*>(a.out), a.B * a.Hq, a.splits);
  return cudaGetLastError();
}

// The decode kernel's heads per CTA: 1 (MHA), 4 (groups of 2 to 4) or 8
// (larger groups, cut into CTAs of 8 past that).
template <typename KV, int D>
cudaError_t launch_decode_g(const Args& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G == 1) return launch_decode<KV, D, 1>(a, stream);
  if (G <= 4) return launch_decode<KV, D, 4>(a, stream);
  return launch_decode<KV, D, 8>(a, stream);
}

// route 0: the simt kernel; route 1: the mma kernel (bf16 q only); route 2:
// the decode kernel (bf16 q, one query row).
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
  } else if (route == 2) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (a.Sq != 1 || a.splits < 1 || (a.splits > 1 && a.ws == nullptr))
        return cudaErrorInvalidValue;
      if (D == 64) return launch_decode_g<KV, 64>(a, stream);
      if (D == 128) return launch_decode_g<KV, 128>(a, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of the
// launch: 0 on success. q_dtype: 0 = bfloat16, 1 = float32; kv_int8 != 0
// reads int8 pools with per-(row, kv-head) f32 scales; route: 0 = simt,
// 1 = mma (bf16 q only), 2 = decode (bf16 q, Sq 1), anything else is
// cudaErrorInvalidValue. splits and workspace serve route 2 only: the key
// splits per (lane, kv head), and with more than one an f32 workspace of
// B * Hq * splits * (D + 2) floats (m, then l, then the D-wide partials).
extern "C" int ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* table, const void* q_offset, const void* k_start, void* out, int B, int Sq,
    int Hq, int Hkv, int D, int blocks, int block_size, int max_blocks, int window,
    int has_window, int q_dtype, int kv_int8, int route, int splits, void* workspace,
    void* stream) {
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
         has_window,
         splits,
         static_cast<float*>(workspace)};
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
