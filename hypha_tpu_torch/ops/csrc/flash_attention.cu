// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of hypha_tpu/ops/flash_attention.py:
//   * flash_fwd_mma_kernel (bf16), flash_fwd_kernel (f32)
//                       <- _fwd_kernel (:115-174, pallas_call at :311)
//   * flash_dq_mma_kernel (bf16), flash_dq_kernel (f32)
//                       <- _dq_kernel  (:177-219, pallas_call at :367)
//   * flash_dkv_mma_kernel (bf16), flash_dkv_kernel (f32)
//                       <- _dkv_kernel (:222-272, pallas_call at :398)
// Semantics are those of the plain PyTorch versions flash_forward_reference
// and flash_backward_reference in hypha_tpu_torch/ops/flash_attention.py:
//   S = Q K^T * scale (causal: key j visible to query i iff j <= i),
//   O = softmax(S) V, L = rowwise logsumexp(S) (-inf on a fully masked row,
//   whose O is 0), and with P = exp(S - L), Delta = rowsum(dO * O):
//   dV = P^T dO, dS = P * (dO V^T - Delta), dQ = dS K * scale,
//   dK = dS^T Q * scale. GQA: query head h reads kv head h / (H / Hkv).
//   A sliding window w > 0 (Mistral) also masks keys j <= i - w, so query i
//   sees keys in (i - w, i]; w = 0 means no window.
//
// Layout: q/k/v/o/dO are read in place as [B, S, heads, D] through their
// batch, sequence and head strides (the last dim contiguous); the TPU
// wrapper's [B*H, S, D] transposes are a TPU layout rule and are gone.
// Outputs: o, dq [B, Sq, H, D], dk/dv [B, Sk, Hkv, D] contiguous; L f32
// [B, H, Sq] (one value per row, not the TPU's 128-lane replication).
//
// Precision follows the TPU kernels: bf16 operands, f32 products and sums;
// P is rounded to bf16 before P V (fwd, the Pallas kernel's p.astype at
// :160) and before P^T dO (dV, :262); dS is rounded to bf16 before dS K
// (:214) and dS^T Q (:265). On the tensor cores each of these roundings is
// the packing of f32 C fragments into the bf16 A operand of the next
// product (attention_mma.cuh pv_tile), so P and dS never touch shared
// memory. f32 calls round nowhere. Where the bf16 kernels depart: their
// exponentials are exp2 of log2-domain scores (scale * log2 e folded in),
// and the forward rounds P against the running row maximum of the online
// softmax, as the Pallas kernel does, not the final one.
//
// Bound on this card: operations. At the training shape (B 2, S 2048,
// 32 heads, D 128, causal) the forward does 2*B*H*S^2*D = 68.7 GFLOP on
// 50 MB of inputs and outputs (1,400 flops per byte, far above the H100's
// ~295 bf16 flops per byte), the backward 3.5x that.
//
// Routes, by dtype:
//   * bf16: tensor cores, mma.sync.m16n8k16 bf16 -> f32 (attention_mma.cuh),
//     every tile staged by cp.async into XOR-swizzled shared memory, read by
//     ldmatrix / ldmatrix.trans without bank conflicts.
//     - forward, flash_fwd_mma_kernel: a CTA owns 128 query rows, 8 warps
//       of 16; Q is held as ldmatrix A fragments; K/V tiles of 64 keys pass
//       through a 2-stage cp.async ring; the online softmax lives in
//       registers and P is reused in registers as the A fragment of P V.
//       96 KB of shared memory at D 128.
//     - dQ, flash_dq_mma_kernel: the forward's shape, with Q and dO both
//       resident. Per K/V tile: S = Q K^T and dP = dO V^T, P = exp2(S - L)
//       with L per row in registers, dS = P (dP - Delta), dQ += dS K.
//       128 KB at D 128.
//     - dK/dV, flash_dkv_mma_kernel: a CTA owns 64 keys of one kv head,
//       4 warps of 16, with K and V resident; every (GQA group member,
//       64-row query tile) it must visit passes through a 2-stage Q/dO
//       ring. Products are transposed (rows are keys, columns queries):
//       S^T = K Q^T, P^T = exp2(S^T - L), dV += P^T dO, dP^T = V dO^T,
//       dS^T = P^T (dP^T - Delta), dK += dS^T Q. 96 KB at D 128, two CTAs
//       per SM.
//     The backward kernels read the resident rows' A fragments from shared
//     memory one 16-wide slice of D at a time (rows_tile) instead of
//     holding them: dK/dV's two accumulators alone take 128 registers a
//     thread at D 128. Delta = rowsum(dO * O) is recomputed in each kernel
//     from the staged dO rows and O, with O's loads issued before the
//     cp.async wait. Only tiles that cross a warp's diagonal, the window's
//     edge or S are masked per element. Grids put the longest causal tiles
//     first (the forward's and dQ's last query tiles, dK/dV's first key
//     tiles). Not yet: wgmma, TMA, warp specialisation.
//   * f32: f32 FMAs on CUDA cores (67 TFLOP/s peak, not the 989 TFLOP/s
//     of bf16 tensor cores): the card tests hold f32 to 1e-4, which bf16
//     products cannot meet. 64 x 64 tiles staged in shared memory with
//     rows padded to D + 1 floats (conflict-free column reads); 256
//     threads as a 16 x 16 grid, each owning a 4 x 4 block of the score
//     tile (rows ty + 16 i, cols tx + 16 j) and 4 x D/16 outputs; row
//     reductions are shuffles across the 16 lanes that share a row.
//   * Both routes: the forward and dQ loop over key tiles only from the
//     window's first tile up to the causal frontier, dK/dV over every
//     (group member, query tile) at or below the diagonal and inside the
//     window of the tile's last key, so tiles that see nothing are never
//     loaded. Each CTA owns its output tile for the whole loop and the GQA
//     sum stays inside the dK/dV CTA: no atomics, so every kernel gives
//     the same bits from run to run.
// Blocks run in no order and share nothing; every ragged edge (S not a
// multiple of the tile) is masked in the kernel, so any S works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kTile = 64;  // query rows and key rows per tile
constexpr int kThreads = 256;
constexpr int kLP = kTile + 1;  // padded row length of a 64 x 64 tile
constexpr float kLog2e = 1.4426950408889634f;

struct Layout {
  long long q[3], k[3], v[3], o[3], d[3];  // (batch, seq, head) strides, in elements
};

// Stage rows [r0, r0 + kTile) of one head into dst[kTile][D + 1], with
// 16-byte loads; rows at or past `seq` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long row_stride,
                                          int r0, int seq) {
  constexpr int VPR = D / 4;
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kTile * VPR; e += kThreads) {
    const int r = e / VPR;
    const int c = (e % VPR) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < seq)
      f = __ldg(reinterpret_cast<const float4*>(base + static_cast<long long>(r0 + r) * row_stride +
                                                c));
    float* d = dst + r * LD + c;
    d[0] = f.x;
    d[1] = f.y;
    d[2] = f.z;
    d[3] = f.w;
  }
}

// Whether query qi sees key kj: the causal frontier and the sliding window
// (window 0: none). The caller checks kj < Sk.
__device__ __forceinline__ bool visible(int qi, int kj, int causal, int window) {
  return (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
}

// The first key tile that a query tile starting at q0 can see.
__device__ __forceinline__ int first_key_tile(int q0, int window) {
  return window > 0 ? (max(0, q0 - window + 1) / kTile) * kTile : 0;
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// L and Delta = rowsum(dO * O) for the 64 query rows of a tile: four
// threads per row, dO from shared memory (already staged), O from device
// memory. Rows past Sq get L = -inf, so their P is 0.
template <int D>
__device__ __forceinline__ void row_stats(float* Lrow, float* Drow, const float* dos,
                                          const float* ob, long long o_row, const float* lse_row,
                                          int q0, int Sq) {
  constexpr int LD = D + 1;
  constexpr int PER = D / 4;
  const int r = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  float acc = 0.f;
  if (q0 + r < Sq) {
    const float* orow = ob + static_cast<long long>(q0 + r) * o_row + part * PER;
    const float* drow = dos + r * LD + part * PER;
#pragma unroll 8
    for (int e = 0; e < PER; ++e) acc = fmaf(drow[e], orow[e], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    Drow[r] = acc;
    Lrow[r] = q0 + r < Sq ? lse_row[q0 + r] : -INFINITY;
  }
}

// ------------------------------------------------------------ forward, f32

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int H, int Hkv, int Sq, int Sk, Layout lay, float scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [kTile][LD]
  float* ks = qs + kTile * LD;  // [kTile][LD]
  float* vs = ks + kTile * LD;  // [kTile][LD]
  float* ps = vs + kTile * LD;  // [kTile][kLP]

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  const float* qb = q + b * lay.q[0] + h * lay.q[2];
  const float* kb = k + b * lay.k[0] + hk * lay.k[2];
  const float* vb = v + b * lay.v[0] + hk * lay.v[2];
  load_tile<D>(qs, qb, lay.q[1], q0, Sq);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  for (int k0 = first_key_tile(q0, window); k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done with ks, vs, ps
    load_tile<D>(ks, kb, lay.k[1], k0, Sk);
    load_tile<D>(vs, vb, lay.v[1], k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool keep = kj < Sk && visible(qi, kj, causal, window);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_max16(rmax);
      const float m_new = fmaxf(m[i], rmax);
      // A fully masked row keeps m = -inf: clamp so exp never sees -inf - -inf.
      const float safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - safe);
        rsum += p;
        ps[(ty + 16 * i) * kLP + tx + 16 * j] = p;
      }
      rsum = row_sum16(rsum);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kLP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* orow = o + ((static_cast<long long>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = acc[i][c] / den;
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qi] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(den);
  }
}

// ------------------------------------------ forward, bf16, on tensor cores

constexpr int kMmaQ = 128;  // query rows per CTA: 8 warps x 16 rows
constexpr int kMmaK = 64;   // keys per K/V tile
constexpr int kMmaThreads = (kMmaQ / 16) * 32;

// Q is staged once by cp.async and held as A fragments; K/V tiles of 64
// keys pass through a 2-stage cp.async ring (tile j + 1 loads while tile j
// computes); S = Q K^T and O += P V run on mma.sync with f32 sums; the
// online softmax stays in registers (log2 domain, scale * log2 e folded
// in) and P goes to bf16 in registers as the A fragment of P V. Only
// tiles that cross the warp's diagonal, the window's edge or Sk are
// masked per element. No atomics: o and L are the same bits every run.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, Layout lay,
                     float scale, int causal, int window) {
  using namespace attn_mma;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kMmaQ][D]
  __nv_bfloat16* ks = qs + kMmaQ * D;                               // [2][kMmaK][D]
  __nv_bfloat16* vs = ks + 2 * kMmaK * D;                           // [2][kMmaK][D]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  // Blocks launch in index order: under causal masking the last query
  // tiles see the most keys, so they go first and the short tiles near
  // the start fill the tail of the grid.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = q0 + warp * 16;  // the warp's first query row

  const __nv_bfloat16* kb = k + b * lay.k[0] + hk * lay.k[2];
  const __nv_bfloat16* vb = v + b * lay.v[0] + hk * lay.v[2];
  const int kt0 = first_key_tile(q0, window);
  const int k_end = causal ? min(Sk, q0 + kMmaQ) : Sk;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kMmaK - 1) / kMmaK : 0;

  stage_rows<D, kMmaQ, kMmaThreads>(qs, q + b * lay.q[0] + h * lay.q[2], lay.q[1], q0, Sq);
  if (n_tiles > 0) {
    stage_rows<D, kMmaK, kMmaThreads>(ks, kb, lay.k[1], kt0, Sk);
    stage_rows<D, kMmaK, kMmaThreads>(vs, vb, lay.v[1], kt0, Sk);
  }
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

  const float sl2 = scale * kLog2e;  // exp(x) = exp2(x log2 e)
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kt0 + it * kMmaK;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      stage_rows<D, kMmaK, kMmaThreads>(ks + st * kMmaK * D, kb, lay.k[1], k0 + kMmaK, Sk);
      stage_rows<D, kMmaK, kMmaThreads>(vs + st * kMmaK * D, vb, lay.v[1], k0 + kMmaK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // Rows past Sq are never stored; a tile wholly above the warp's
    // diagonal or wholly behind its window changes nothing.
    const bool skip = wq >= Sq || (causal && k0 > wq + 15) ||
                      (window > 0 && k0 + kMmaK - 1 <= wq - window);
    if (!skip) {
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      qk_tile<D>(s, qf, ks + (it & 1) * kMmaK * D, lane);
      const bool edge = k0 + kMmaK > Sk || (causal && k0 + kMmaK - 1 > wq) ||
                        (window > 0 && k0 <= wq + 15 - window);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (edge) {
            const int kj = k0 + n * 8 + 2 * t + (e & 1);
            const int qi = wq + g + (e >> 1) * 8;
            if (kj >= Sk || !visible(qi, kj, causal, window)) x = -INFINITY;
          }
          s[n][e] = x;
        }
      }
      softmax_step<D>(s, m, l, acc);
      pv_tile<D>(acc, s, vs + (it & 1) * kMmaK * D, lane);
    }
    __syncthreads();  // the next copies overwrite the stage just read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq + g + r * 8;
    const float den = fmaxf(quad_sum(l[r]), 1e-20f);
    if (qi >= Sq) continue;
    __nv_bfloat16* orow = o + ((static_cast<long long>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + qi] =
          m[r] == -INFINITY ? -INFINITY : m[r] * 0.6931471805599453f + logf(den);
  }
}

// ------------------------------------ backward row statistics, bf16 routes

// For ROWS query rows from q0: stat[r] = L log2 e and stat[ROWS + r] =
// Delta = rowsum(dO * O), NT / ROWS threads to a row. O comes from device
// memory, its loads issued before the wait so they overlap the copies in
// flight; dO from the swizzled tile dos once the calling thread's cp.async
// groups have landed (this waits for all of them). Rows past Sq, and rows
// that see no key (L = -inf), get L = +inf: exp2(S - L) is then 0 for
// them, never NaN. Begins and ends with __syncthreads.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void mma_row_stats(float* stat, const __nv_bfloat16* dos,
                                              const __nv_bfloat16* ob, long long o_row,
                                              const float* lse_row, int q0, int Sq) {
  using namespace attn_mma;
  constexpr int TPR = NT / ROWS;
  constexpr int CH = D / 8 / TPR;  // 16-byte chunks per thread
  static_assert(TPR == 2 && CH * TPR * 8 == D, "two threads to a row");
  const int r = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const bool live = q0 + r < Sq;
  uint4 ov[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i)
    ov[i] = live ? __ldg(reinterpret_cast<const uint4*>(
                       ob + static_cast<long long>(q0 + r) * o_row + (part * CH + i) * 8))
                 : make_uint4(0u, 0u, 0u, 0u);
  const float L = live ? lse_row[q0 + r] : -INFINITY;
  cp_async_wait<0>();
  __syncthreads();
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const uint4 dv = *reinterpret_cast<const uint4*>(dos + swz<D>(r, part * CH + i));
    const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(dh[j]);
      const float2 c = __bfloat1622float2(oh[j]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (part == 0) {
    stat[r] = L == -INFINITY ? INFINITY : L * kLog2e;
    stat[ROWS + r] = acc;
  }
  __syncthreads();
}

// ------------------------------------------------ dQ, bf16, on tensor cores

// The forward's shape and tile order: 128 query rows of 8 warps, Q and dO
// staged once (their A fragments re-read from shared memory per tile),
// K/V tiles of 64 keys through the 2-stage cp.async ring, the same
// skipping and edge masking. L and Delta of the warp's rows stay in
// registers; dS goes to bf16 in registers as the A fragment of dS K.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, Layout lay,
                    float scale, int causal, int window) {
  using namespace attn_mma;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kMmaQ][D]
  __nv_bfloat16* dos = qs + kMmaQ * D;                              // [kMmaQ][D]
  __nv_bfloat16* ks = dos + kMmaQ * D;                              // [2][kMmaK][D]
  __nv_bfloat16* vs = ks + 2 * kMmaK * D;                           // [2][kMmaK][D]
  float* stat = reinterpret_cast<float*>(vs + 2 * kMmaK * D);       // [2][kMmaQ]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaQ;  // longest causal tiles first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq = q0 + warp * 16;

  const __nv_bfloat16* kb = k + b * lay.k[0] + hk * lay.k[2];
  const __nv_bfloat16* vb = v + b * lay.v[0] + hk * lay.v[2];
  const int kt0 = first_key_tile(q0, window);
  const int k_end = causal ? min(Sk, q0 + kMmaQ) : Sk;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kMmaK - 1) / kMmaK : 0;

  stage_rows<D, kMmaQ, kMmaThreads>(qs, q + b * lay.q[0] + h * lay.q[2], lay.q[1], q0, Sq);
  stage_rows<D, kMmaQ, kMmaThreads>(dos, dout + b * lay.d[0] + h * lay.d[2], lay.d[1], q0, Sq);
  if (n_tiles > 0) {
    stage_rows<D, kMmaK, kMmaThreads>(ks, kb, lay.k[1], kt0, Sk);
    stage_rows<D, kMmaK, kMmaThreads>(vs, vb, lay.v[1], kt0, Sk);
  }
  cp_async_commit();
  mma_row_stats<D, kMmaQ, kMmaThreads>(stat, dos, o + b * lay.o[0] + h * lay.o[2], lay.o[1],
                                       lse + (static_cast<long long>(b) * H + h) * Sq, q0, Sq);
  const float l2[2] = {stat[warp * 16 + g], stat[warp * 16 + g + 8]};
  const float dl[2] = {stat[kMmaQ + warp * 16 + g], stat[kMmaQ + warp * 16 + g + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const float sl2 = scale * kLog2e;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kt0 + it * kMmaK;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      stage_rows<D, kMmaK, kMmaThreads>(ks + st * kMmaK * D, kb, lay.k[1], k0 + kMmaK, Sk);
      stage_rows<D, kMmaK, kMmaThreads>(vs + st * kMmaK * D, vb, lay.v[1], k0 + kMmaK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool skip = wq >= Sq || (causal && k0 > wq + 15) ||
                      (window > 0 && k0 + kMmaK - 1 <= wq - window);
    if (!skip) {
      const __nv_bfloat16* kt = ks + (it & 1) * kMmaK * D;
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      rows_tile<D>(s, qs, warp * 16, kt, lane);                           // S = Q K^T
      rows_tile<D>(dp, dos, warp * 16, vs + (it & 1) * kMmaK * D, lane);  // dP = dO V^T
      const bool edge = k0 + kMmaK > Sk || (causal && k0 + kMmaK - 1 > wq) ||
                        (window > 0 && k0 <= wq + 15 - window);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(s[n][e], sl2, -l2[e >> 1]);
          if (edge) {
            const int kj = k0 + n * 8 + 2 * t + (e & 1);
            const int qi = wq + g + (e >> 1) * 8;
            if (kj >= Sk || !visible(qi, kj, causal, window)) x = -INFINITY;
          }
          s[n][e] = exp2f(x) * (dp[n][e] - dl[e >> 1]);  // dS = P (dP - Delta)
        }
      }
      pv_tile<D>(acc, s, kt, lane);  // dQ += dS K
    }
    __syncthreads();  // the next copies overwrite the stage just read
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq + g + r * 8;
    if (qi >= Sq) continue;
    __nv_bfloat16* row = dq + ((static_cast<long long>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// --------------------------------------------- dK/dV, bf16, on tensor cores

constexpr int kDkvK = 64;  // keys per CTA: 4 warps x 16 keys
constexpr int kDkvQ = 64;  // query rows per Q/dO tile
constexpr int kDkvThreads = (kDkvK / 16) * 32;

// K and V resident, every (group member, query tile) the CTA's keys can
// see streamed through a 2-stage Q/dO ring with its L and Delta (one
// copy in flight while a tile computes). In transposed form each warp's
// 16 keys are the rows of S^T, P^T, dP^T and dS^T, the 64 queries their
// columns, and L and Delta are read per column from shared memory. P^T
// and dS^T go to bf16 in registers as the A fragments of P^T dO and
// dS^T Q. Keys past Sk need no mask: their rows of dK and dV are never
// stored, and no other row reads them.
template <int D>
__global__ void __launch_bounds__(kDkvThreads)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                     int Hkv, int Sq, int Sk, Layout lay, float scale, int causal, int window) {
  using namespace attn_mma;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kDkvK][D]
  __nv_bfloat16* vs = ks + kDkvK * D;                               // [kDkvK][D]
  __nv_bfloat16* qs = vs + kDkvK * D;                               // [2][kDkvQ][D]
  __nv_bfloat16* dos = qs + 2 * kDkvQ * D;                          // [2][kDkvQ][D]
  float* stat = reinterpret_cast<float*>(dos + 2 * kDkvQ * D);      // [2][kDkvQ]

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int reps = H / Hkv;
  // Under causal masking the first key tiles see the most queries; blocks
  // launch in index order, so they go first.
  const int k0 = blockIdx.y * kDkvK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wk = k0 + warp * 16;  // the warp's first key

  // Query tiles wholly above the diagonal, or wholly past the window of
  // the CTA's last key (k0 + kDkvK - 1), see none of its keys.
  const int q_begin = causal ? (k0 / kDkvQ) * kDkvQ : 0;
  const long long reach = k0 + kDkvK - 1LL + window;  // no query from here on is in reach
  const int q_end = window > 0 ? static_cast<int>(min(static_cast<long long>(Sq), reach)) : Sq;
  const int n_q = q_end > q_begin ? (q_end - q_begin + kDkvQ - 1) / kDkvQ : 0;
  const int n_tiles = reps * n_q;

  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

  const __nv_bfloat16* qb = q + b * lay.q[0];
  const __nv_bfloat16* db = dout + b * lay.d[0];
  if (n_tiles > 0) {
    stage_rows<D, kDkvK, kDkvThreads>(ks, k + b * lay.k[0] + hk * lay.k[2], lay.k[1], k0, Sk);
    stage_rows<D, kDkvK, kDkvThreads>(vs, v + b * lay.v[0] + hk * lay.v[2], lay.v[1], k0, Sk);
    const int h0 = hk * reps;
    stage_rows<D, kDkvQ, kDkvThreads>(qs, qb + h0 * lay.q[2], lay.q[1], q_begin, Sq);
    stage_rows<D, kDkvQ, kDkvThreads>(dos, db + h0 * lay.d[2], lay.d[1], q_begin, Sq);
    cp_async_commit();
  }
  const float sl2 = scale * kLog2e;
  for (int it = 0; it < n_tiles; ++it) {
    const int h = hk * reps + it / n_q;
    const int q0 = q_begin + (it % n_q) * kDkvQ;
    const __nv_bfloat16* qt = qs + (it & 1) * kDkvQ * D;
    const __nv_bfloat16* dt = dos + (it & 1) * kDkvQ * D;
    // Waits for this tile; after its first barrier no warp reads the
    // other stage or the previous tile's statistics any more.
    mma_row_stats<D, kDkvQ, kDkvThreads>(stat, dt, o + b * lay.o[0] + h * lay.o[2], lay.o[1],
                                         lse + (static_cast<long long>(b) * H + h) * Sq, q0, Sq);
    if (it + 1 < n_tiles) {
      const int hn = hk * reps + (it + 1) / n_q;
      const int qn = q_begin + ((it + 1) % n_q) * kDkvQ;
      const int st = (it + 1) & 1;
      stage_rows<D, kDkvQ, kDkvThreads>(qs + st * kDkvQ * D, qb + hn * lay.q[2], lay.q[1], qn, Sq);
      stage_rows<D, kDkvQ, kDkvThreads>(dos + st * kDkvQ * D, db + hn * lay.d[2], lay.d[1], qn, Sq);
      cp_async_commit();
    }
    // A tile wholly above the warp's keys' diagonal or wholly past their
    // window changes nothing.
    const bool skip = wk >= Sk || (causal && wk > q0 + kDkvQ - 1) ||
                      (window > 0 && q0 - window >= wk + 15);
    if (skip) continue;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    rows_tile<D>(s, ks, warp * 16, qt, lane);  // S^T = K Q^T
    const bool edge = (causal && wk + 15 > q0) || (window > 0 && q0 + kDkvQ - 1 - window >= wk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(stat + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fmaf(s[n][e], sl2, -((e & 1) ? l2.y : l2.x));
        if (edge) {
          const int qi = q0 + n * 8 + 2 * t + (e & 1);
          const int kj = wk + g + (e >> 1) * 8;
          if (!visible(qi, kj, causal, window)) x = -INFINITY;
        }
        s[n][e] = exp2f(x);  // P^T
      }
    }
    pv_tile<D>(gv, s, dt, lane);  // dV += P^T dO
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    rows_tile<D>(dp, vs, warp * 16, dt, lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(stat + kDkvQ + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - ((e & 1) ? d2.y : d2.x));
    }
    pv_tile<D>(gk, dp, qt, lane);  // dK += dS^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = wk + g + r * 8;
    if (kj >= Sk) continue;
    const long long off = ((static_cast<long long>(b) * Sk + kj) * Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          pack_bf16(gk[n][2 * r] * scale, gk[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) =
          pack_bf16(gv[n][2 * r], gv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- dQ, f32

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ o,
                const float* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, Layout lay, float scale,
                int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [kTile][LD]
  float* dos = qs + kTile * LD;   // [kTile][LD]
  float* ks = dos + kTile * LD;   // [kTile][LD]
  float* vs = ks + kTile * LD;    // [kTile][LD]
  float* dss = vs + kTile * LD;   // [kTile][kLP]
  float* Lrow = dss + kTile * kLP;
  float* Drow = Lrow + kTile;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  const float* kb = k + b * lay.k[0] + hk * lay.k[2];
  const float* vb = v + b * lay.v[0] + hk * lay.v[2];
  load_tile<D>(qs, q + b * lay.q[0] + h * lay.q[2], lay.q[1], q0, Sq);
  load_tile<D>(dos, dout + b * lay.d[0] + h * lay.d[2], lay.d[1], q0, Sq);
  __syncthreads();
  row_stats<D>(Lrow, Drow, dos, o + b * lay.o[0] + h * lay.o[2], lay.o[1],
               lse + (static_cast<long long>(b) * H + h) * Sq, q0, Sq);

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kTile) : Sk;
  for (int k0 = first_key_tile(q0, window); k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, kb, lay.k[1], k0, Sk);
    load_tile<D>(vs, vb, lay.v[1], k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], dv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * LD + d];
        dv[i] = dos[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
      const float L = Lrow[r];
      const float delta = Drow[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool keep = kj < Sk && visible(qi, kj, causal, window) && L != -INFINITY;
        const float p = keep ? expf(s[i][j] * scale - L) : 0.f;
        dss[r * kLP + tx + 16 * j] = p * (dp[i][j] - delta);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float sv[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty + 16 * i) * kLP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    float* row = dq + ((static_cast<long long>(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = acc[i][c] * scale;
  }
}

// ------------------------------------------------------------- dK/dV, f32

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                 Layout lay, float scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;               // [kTile][LD], resident
  float* vs = ks + kTile * LD;    // [kTile][LD], resident
  float* qs = vs + kTile * LD;    // [kTile][LD]
  float* dos = qs + kTile * LD;   // [kTile][LD]
  float* pts = dos + kTile * LD;  // [kTile keys][kLP queries]: P^T
  float* dst = pts + kTile * kLP; // [kTile keys][kLP queries]: dS^T
  float* Lrow = dst + kTile * kLP;
  float* Drow = Lrow + kTile;

  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int reps = H / Hkv;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<D>(ks, k + b * lay.k[0] + hk * lay.k[2], lay.k[1], k0, Sk);
  load_tile<D>(vs, v + b * lay.v[0] + hk * lay.v[2], lay.v[1], k0, Sk);

  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[i][c] = gv[i][c] = 0.f;

  // Query tiles wholly above the diagonal, or wholly past the window of
  // the tile's last key (k0 + kTile - 1), see none of these keys.
  const int q_begin = causal ? (k0 / kTile) * kTile : 0;
  const int q_end =
      window > 0 ? static_cast<int>(min(static_cast<long long>(Sq), k0 + kTile - 1LL + window)) : Sq;
  for (int g = 0; g < reps; ++g) {
    const int h = hk * reps + g;
    const float* qb = q + b * lay.q[0] + h * lay.q[2];
    const float* db = dout + b * lay.d[0] + h * lay.d[2];
    const float* ob = o + b * lay.o[0] + h * lay.o[2];
    const float* lrow = lse + (static_cast<long long>(b) * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
      __syncthreads();
      load_tile<D>(qs, qb, lay.q[1], q0, Sq);
      load_tile<D>(dos, db, lay.d[1], q0, Sq);
      __syncthreads();
      row_stats<D>(Lrow, Drow, dos, ob, lay.o[1], lrow, q0, Sq);
      __syncthreads();

      // Transposed tiles: rows are keys (ty + 16 i), cols are queries (tx + 16 j).
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty + 16 * i) * LD + d];
          vv[i] = vs[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * LD + d];
          dv[j] = dos[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int kj = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int qi = q0 + c;
          const float L = Lrow[c];
          const bool keep =
              kj < Sk && qi < Sq && visible(qi, kj, causal, window) && L != -INFINITY;
          const float p = keep ? expf(s[i][j] * scale - L) : 0.f;
          pts[r * kLP + c] = p;
          dst[r * kLP + c] = p * (dp[i][j] - Drow[c]);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[4], sv[4], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pts[(ty + 16 * i) * kLP + qq];
          sv[i] = dst[(ty + 16 * i) * kLP + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dos[qq * LD + tx + 16 * c];
          qv[c] = qs[qq * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            gv[i][c] = fmaf(pv[i], dov[c], gv[i][c]);
            gk[i][c] = fmaf(sv[i], qv[c], gk[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Sk) continue;
    const long long off = ((static_cast<long long>(b) * Sk + kj) * Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = gk[i][c] * scale;
      dv[off + tx + 16 * c] = gv[i][c];
    }
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *out, *lse, *dq, *dk, *dv;
  int B, H, Hkv, Sq, Sk;
  Layout lay;
  float scale;
  int causal;
  int window;
};

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

using bf16 = __nv_bfloat16;

template <int D>
cudaError_t launch_fwd(const Args& a, cudaStream_t st) {
  const size_t smem = (3 * kTile * (D + 1) + kTile * kLP) * sizeof(float);
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kTile - 1) / kTile, a.B * a.H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), static_cast<float*>(a.lse),
      a.H, a.Hkv, a.Sq, a.Sk, a.lay, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_mma(const Args& a, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(kMmaQ + 4 * kMmaK) * D * sizeof(bf16);
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Sq + kMmaQ - 1) / kMmaQ);
  kern<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<bf16*>(a.out), static_cast<float*>(a.lse), a.H, a.Hkv, a.Sq, a.Sk, a.lay,
      a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t st) {
  const size_t smem = (4 * kTile * (D + 1) + kTile * kLP + 2 * kTile) * sizeof(float);
  auto kern = flash_dq_kernel<D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + kTile - 1) / kTile, a.B * a.H);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.dq), a.H, a.Hkv, a.Sq, a.Sk, a.lay, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const Args& a, cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(2 * kMmaQ + 4 * kMmaK) * D * sizeof(bf16) + 2 * kMmaQ * sizeof(float);
  auto kern = flash_dq_mma_kernel<D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Sq + kMmaQ - 1) / kMmaQ);
  kern<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<bf16*>(a.dq), a.H, a.Hkv, a.Sq, a.Sk, a.lay,
      a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t st) {
  const size_t smem = (4 * kTile * (D + 1) + 2 * kTile * kLP + 2 * kTile) * sizeof(float);
  auto kern = flash_dkv_kernel<D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + kTile - 1) / kTile, a.B * a.Hkv);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.Hkv, a.Sq, a.Sk, a.lay,
      a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const Args& a, cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(2 * kDkvK + 4 * kDkvQ) * D * sizeof(bf16) + 2 * kDkvQ * sizeof(float);
  auto kern = flash_dkv_mma_kernel<D>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.Hkv, (a.Sk + kDkvK - 1) / kDkvK);
  kern<<<grid, kDkvThreads, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H,
      a.Hkv, a.Sq, a.Sk, a.lay, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

// which: 0 forward, 1 dQ, 2 dK/dV. bf16 runs on the tensor cores; f32
// stays on the CUDA-core kernels, whose f32 sums the card tests hold to
// 1e-4.
template <int D>
cudaError_t dispatch_which(int which, bool bf16_in, const Args& a, cudaStream_t st) {
  switch (which) {
    case 0:
      return bf16_in ? launch_fwd_mma<D>(a, st) : launch_fwd<D>(a, st);
    case 1:
      return bf16_in ? launch_dq_mma<D>(a, st) : launch_dq<D>(a, st);
    case 2:
      return bf16_in ? launch_dkv_mma<D>(a, st) : launch_dkv<D>(a, st);
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 bfloat16, 1 float32.
cudaError_t dispatch(int which, int dtype, int D, const Args& a, cudaStream_t st) {
  if (a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.Sq <= 0 || a.Sk <= 0 ||
      a.window < 0 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (D == 64) return dispatch_which<64>(which, dtype == 0, a, st);
  if (D == 128) return dispatch_which<128>(which, dtype == 0, a, st);
  return cudaErrorInvalidValue;
}

Layout read_layout(const long long* s) {
  Layout lay;
  for (int i = 0; i < 3; ++i) {
    lay.q[i] = s[i];
    lay.k[i] = s[3 + i];
    lay.v[i] = s[6 + i];
    lay.o[i] = s[9 + i];
    lay.d[i] = s[12 + i];
  }
  return lay;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the cudaError_t of
// its launch, 0 on success. `strides` points to 15 host int64s: the
// (batch, seq, head) element strides of q, k, v, o and dO, in that order
// (the forward ignores the last six). `window` is the sliding window, 0 for
// none; `dtype` 0 is bfloat16 (tensor cores), 1 float32 (CUDA cores).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
                                       const long long* strides, float scale, int causal,
                                       int window, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.lse = lse;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.lay = read_layout(strides);
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return static_cast<int>(dispatch(0, dtype, D, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_backward_dq(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* dq, int B, int H, int Hkv, int Sq, int Sk,
                                           int D, const long long* strides, float scale,
                                           int causal, int window, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = const_cast<void*>(lse);
  a.dq = dq;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.lay = read_layout(strides);
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return static_cast<int>(dispatch(1, dtype, D, a, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_backward_dkv(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const void* lse,
                                            void* dk, void* dv, int B, int H, int Hkv, int Sq,
                                            int Sk, int D, const long long* strides,
                                            float scale, int causal, int window, int dtype,
                                            void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = const_cast<void*>(lse);
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.lay = read_layout(strides);
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return static_cast<int>(dispatch(2, dtype, D, a, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
