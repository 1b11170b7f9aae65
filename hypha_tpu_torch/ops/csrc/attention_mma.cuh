// Warp-level tensor-core building blocks shared by the attention kernels
// (flash_attention.cu, ragged_paged_attention.cu): cp.async copies into
// swizzled shared-memory tiles, ldmatrix fragment loads and the bf16
// mma.sync.m16n8k16 product with f32 accumulation (sm_80 and later; the
// kernels build for sm_90a).
//
// Fragments of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A 16x16 bf16, 4 regs: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//                         a2 (row g, cols 2t+8..2t+9), a3 (row g+8, same);
//   B 16x8 bf16, 2 regs:  b0 (k rows 2t..2t+1, col g), b1 (k rows 2t+8..2t+9);
//   C 16x8 f32, 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Two C tiles side by side (cols 0-7 and 8-15) packed to bf16 pairs are
// exactly the A fragment of the next product, so P never leaves registers.
//
// Tiles in shared memory are rows of D bf16 (D = 64 or 128: 8 or 16
// chunks of 16 bytes). Chunk c of row r is stored at chunk c ^ (r % 8) of
// that row, so the 8 rows one ldmatrix reads at one logical chunk land in
// 8 different 16-byte bank groups: no bank conflicts for ldmatrix, its
// .trans form, or the cp.async writes.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_mma {

// Element offset of (row, chunk) in a swizzled tile of rows of D bf16.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(D % 64 == 0, "rows must hold a multiple of 8 chunks");
  return row * D + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes and reads
// nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b on the tensor cores: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [r0, r0 + ROWS) of a strided bf16 source into a swizzled
// [ROWS][D] tile with cp.async, NT threads each taking whole 16-byte
// chunks; rows at or past `limit` are zero-filled. The caller commits.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long row_stride, int r0, int limit) {
  constexpr int CPR = D / 8;
  static_assert(ROWS * CPR % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CPR;
    const int c = e % CPR;
    const bool ok = r0 + r < limit;
    const __nv_bfloat16* src =
        ok ? base + static_cast<long long>(r0 + r) * row_stride + c * 8 : base;
    cp_async_16(smem_u32(dst + swz<D>(r, c)), src, ok ? 16 : 0);
  }
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// A fragments of a warp's 16 query rows (tile rows r0 .. r0 + 15), one per
// 16-wide slice of D.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], const __nv_bfloat16* tile,
                                            int r0, int lane) {
  const int mi = lane >> 3;
  const int row = r0 + (lane & 7) + (mi & 1) * 8;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    ldmatrix_x4(a[kd], smem_u32(tile + swz<D>(row, kd * 2 + (mi >> 1))));
}

// s[n] (8 keys each, 64 keys) += a K^T over the 16-wide slice kd of D, for
// the 16 rows whose A fragment is a; K is a [64][D] tile (rows are keys).
template <int D>
__device__ __forceinline__ void qk_slice(float (&s)[8][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* ks, int kd, int lane) {
  const int mi = lane >> 3;
  const int r = lane & 7;
#pragma unroll
  for (int kn = 0; kn < 4; ++kn) {
    uint32_t b[4];  // keys kn*16 + 0..7 then + 8..15, each at d chunks 2kd, 2kd + 1
    ldmatrix_x4(b, smem_u32(ks + swz<D>(kn * 16 + r + (mi >> 1) * 8, kd * 2 + (mi & 1))));
    mma_bf16(s[2 * kn], a, b[0], b[1]);
    mma_bf16(s[2 * kn + 1], a, b[2], b[3]);
  }
}

// s[n] (8 keys each, 64 keys) += Q K^T for the warp's 16 rows, whose A
// fragments qf are held in registers; K is a [64][D] tile (rows are keys).
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const uint32_t (&qf)[D / 16][4],
                                        const __nv_bfloat16* ks, int lane) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) qk_slice<D>(s, qf[kd], ks, kd, lane);
}

// As qk_tile, with the warp's rows r0 .. r0 + 15 of the swizzled tile a
// read from shared memory one slice of D at a time: 4 registers of A are
// live instead of D / 4, for kernels whose accumulators leave no room to
// hold the rows across their loop.
template <int D>
__device__ __forceinline__ void rows_tile(float (&s)[8][4], const __nv_bfloat16* a, int r0,
                                          const __nv_bfloat16* ks, int lane) {
  const int mi = lane >> 3;
  const int row = r0 + (lane & 7) + (mi & 1) * 8;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_u32(a + swz<D>(row, kd * 2 + (mi >> 1))));
    qk_slice<D>(s, af, ks, kd, lane);
  }
}

// acc[n] (8 dims each) += P V for the warp's 16 rows; P is s (64 keys)
// rounded to bf16 in registers, V a [64][D] tile (rows are keys).
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 8][4], const float (&s)[8][4],
                                        const __nv_bfloat16* vs, int lane) {
  const int mi = lane >> 3;
  const int r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t p[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];  // keys kk*16 + 0..7 and + 8..15 at d chunk 2dn, then 2dn + 1
      ldmatrix_x4_trans(b, smem_u32(vs + swz<D>(kk * 16 + r + (mi & 1) * 8, dn * 2 + (mi >> 1))));
      mma_bf16(acc[2 * dn], p, b[0], b[1]);
      mma_bf16(acc[2 * dn + 1], p, b[2], b[3]);
    }
  }
}

// One online-softmax step over a 64-key tile for the warp's rows g and
// g + 8. s holds log2-domain scores (scale * log2 e folded in; masked
// entries -inf) and becomes P = exp2(s - m_new); m, l (this thread's
// partial row sums) and acc are rescaled. A row with every key masked so
// far keeps m = -inf and contributes P = 0.
template <int D>
__device__ __forceinline__ void softmax_step(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[D / 8][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float safe = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m[h] - safe);  // 0 while m is -inf
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][2 * h] = exp2f(s[n][2 * h] - safe);
      s[n][2 * h + 1] = exp2f(s[n][2 * h + 1] - safe);
      sum += s[n][2 * h] + s[n][2 * h + 1];
    }
    l[h] = l[h] * alpha + sum;
    m[h] = mx;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][2 * h] *= alpha;
      acc[n][2 * h + 1] *= alpha;
    }
  }
}

// The row sums of a quad (the 4 threads that share rows g and g + 8).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace attn_mma
