// Seeded parameter draws, bit-equal to the JAX package's model.init on the CPU.
//
// One elementwise kernel: element t of the output is flat element start + t
// of a leaf drawn as hypha_tpu_torch/models/seed_init.py draws it:
// threefry2x32 of the element's flat index (two u32 counter words), the
// uniform's mantissa trick, XLA's CPU erf_inv (Giles' polynomial over XLA's
// log1p expansion), the clip of a truncated normal and the initializer's
// scale. Every float step is an explicitly rounded intrinsic (__fadd_rn,
// __fmul_rn, __fmaf_rn, __fdiv_rn, __fsqrt_rn) placed where the CPU path
// rounds, so nvcc contracts nothing and the card's bits equal the CPU's.
//
// This ports no TPU kernel: the reference draws with XLA (model.init). It
// exists because the same draw as int64 torch ops, a few hundred passes over
// each leaf, would take hours over the 6.7 G parameters of a 7B model.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float bits_f(uint32_t b) { return __uint_as_float(b); }

// XLA's CPU log(y) for 0 < y <= 1 (seed_init.py _xla_log).
__device__ __forceinline__ float xla_log(float y) {
  const float minnorm = bits_f(0x00800000u);
  float ym = y > minnorm ? y : minnorm;
  uint32_t b = __float_as_uint(ym);
  int e = (int)((b >> 23) & 0x1FFu) - 127;
  float m = bits_f((b & 0x7FFFFFu) | 0x3F000000u);
  float ef = __fadd_rn(__int2float_rn(e), 1.0f);
  bool small = m < bits_f(0x3F3504F3u);
  float x = __fadd_rn(__fadd_rn(m, -1.0f), small ? m : 0.0f);
  ef = __fsub_rn(ef, small ? 1.0f : 0.0f);
  float z = __fmul_rn(x, x);
  float x3 = __fmul_rn(z, x);
  float a = __fmaf_rn(__fmaf_rn(x, bits_f(0x3D9021BBu), bits_f(0xBDEBD1B8u)), x, bits_f(0x3DEF251Au));
  float c1 = __fmaf_rn(__fmaf_rn(x, bits_f(0xBDFE5D4Fu), bits_f(0x3E11E9BFu)), x, bits_f(0xBE2AAE50u));
  float c2 = __fmaf_rn(__fmaf_rn(x, bits_f(0x3E4CCEACu), bits_f(0xBE7FFFFCu)), x, bits_f(0x3EAAAAAAu));
  a = __fmaf_rn(__fmaf_rn(a, x3, c1), x3, c2);
  a = __fmaf_rn(a, x3, __fmul_rn(ef, bits_f(0xB95E8083u)));
  float out = __fadd_rn(__fsub_rn(x, __fmul_rn(z, 0.5f)), a);
  return __fadd_rn(out, __fmul_rn(ef, bits_f(0x3F318000u)));
}

// XLA's CPU log1p for x in (-1, 0] (seed_init.py _xla_log1p).
__device__ __forceinline__ float xla_log1p(float x) {
  if (fabsf(x) < bits_f(0x3ED413CDu)) {
    const uint32_t den[6] = {0x417101ADu, 0x42A6185Bu, 0x435DC32Du, 0x439A8CA3u, 0x43586D8Au, 0x42707982u};
    const uint32_t num[7] = {0x383DE04Bu, 0x3EFF40C5u, 0x40D284FAu, 0x41EF4B9Cu, 0x4273CC76u,
                             0x426473ADu, 0x41A05101u};
    float zero = __fmul_rn(x, 0.0f);
    float d = __fadd_rn(zero, 1.0f);
#pragma unroll
    for (int i = 0; i < 6; ++i) d = __fmaf_rn(d, x, bits_f(den[i]));
    float n = __fadd_rn(zero, bits_f(num[0]));
#pragma unroll
    for (int i = 1; i < 7; ++i) n = __fmaf_rn(n, x, bits_f(num[i]));
    float x2 = __fmul_rn(x, x);
    float t = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(n, d));
    return __fadd_rn(x, __fadd_rn(__fmul_rn(x2, -0.5f), t));
  }
  return xla_log(__fadd_rn(x, 1.0f));
}

__device__ __forceinline__ float xla_erf_inv(float x) {
  const uint32_t lo[9] = {0x32F16588u, 0x34B84B36u, 0xB66C7357u, 0xB6935AC1u, 0x396532DBu,
                          0xBAA45408u, 0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
  const uint32_t hi[9] = {0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u, 0xBB70BDE7u, 0x3BBC127Bu,
                          0xBBF9C5D7u, 0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};
  float w = -xla_log1p(__fmul_rn(x, -x));
  bool central = w < 5.0f;
  w = central ? __fadd_rn(w, -2.5f) : __fadd_rn(__fsqrt_rn(w), -3.0f);
  const uint32_t* c = central ? lo : hi;
  float p = bits_f(c[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, bits_f(c[i]));
  return __fmul_rn(p, x);  // |x| < 1: a draw's uniform never reaches 1
}

__global__ void seed_init_draw_kernel(float* __restrict__ out, long long start, long long n,
                                      uint32_t k1, uint32_t k2, float lo, float span, int clip,
                                      float clip_lo, float clip_hi, float mul) {
  const float sqrt2 = bits_f(0x3FB504F3u);
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    unsigned long long idx = (unsigned long long)(start + t);
    uint32_t x0 = (uint32_t)(idx >> 32), x1 = (uint32_t)idx;
    threefry(k1, k2, x0, x1);
    uint32_t bits = x0 ^ x1;
    float f = __fadd_rn(bits_f((bits >> 9) | 0x3F800000u), -1.0f);
    float u = fmaxf(lo, __fmaf_rn(f, span, lo));
    float v = __fmul_rn(sqrt2, xla_erf_inv(u));
    if (clip) v = fminf(fmaxf(v, clip_lo), clip_hi);
    out[t] = __fmul_rn(v, mul);
  }
}

}  // namespace

extern "C" {

const char* seed_init_error(int code) { return cudaGetErrorString((cudaError_t)code); }

int seed_init_draw(float* out, long long start, long long n, unsigned int k1, unsigned int k2,
                   float lo, float span, int clip, float clip_lo, float clip_hi, float mul,
                   void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  seed_init_draw_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
      out, start, n, k1, k2, lo, span, clip, clip_lo, clip_hi, mul);
  return (int)cudaGetLastError();
}

}  // extern "C"
