// MX block arithmetic shared by every kernel of the port (device code).
//
// One 16-block of fp32 values becomes 16 sign-magnitude int8 mantissas, an
// int8 shared exponent and 8 packed micro-exponent bits; the rules are
// those of repro_torch/kernels/ref.py::mx_quantize_ref, bit for bit:
//   - an exponent field of 0 (zero or fp32 denormal) counts as zero, with
//     exponent EXP_MIN = -126 and mantissa 0 — masked explicitly, so the
//     infinite quantize scale of an all-zero block never meets a zero
//     (0 * inf = NaN);
//   - rounding is rintf (half to even, as jnp.round / torch.round);
//   - powers of two are built from exponent bits (pow2), never with exp2f
//     (on an H100 the GEMMs measured 2-6 % faster with it than with
//     ldexpf).
// mx_quantize_kernel stores the result of quantize_block; the GEMM kernels
// (mx_gemm.cu) quantize and dequantize their tiles with the same two
// functions, so a tile quantized inside a GEMM is bit for bit what the
// quantize kernel stores. (mx_dequantize_kernel keeps its own loop, with
// the same exact values.)
//
// Compile without --use_fast_math: flush-to-zero would change denormal
// scales and products.
#pragma once

#include <stdint.h>

namespace mx {

constexpr int kBlock = 16;

// Unbiased fp32 exponent; zero and denormals (field 0) give -126.
__device__ __forceinline__ int exponent_of(uint32_t bits) {
  int field = (bits >> 23) & 0xFF;
  return max(field, 1) - 127;
}

__device__ __forceinline__ bool is_zero(uint32_t bits) {
  return (bits & 0x7F800000u) == 0u;
}

// Exact 2**n in fp32, as ref.py::_pow2: inf above 127, denormals from
// -127 to -149, zero below.
__device__ __forceinline__ float pow2(int n) {
  if (n > 127) return __uint_as_float(0x7F800000u);
  if (n >= -126) return __uint_as_float((uint32_t)(n + 127) << 23);
  if (n >= -149) return __uint_as_float(1u << (n + 149));
  return 0.0f;
}

// Quantize one 16-block given as raw fp32 bits, mb mantissa bits
// (2 / 4 / 7 for mx4 / mx6 / mx9).
__device__ __forceinline__ void quantize_block(const uint32_t (&u)[kBlock],
                                               int mb, int8_t (&m)[kBlock],
                                               int& e_shared,
                                               uint32_t& packed) {
  int e[kBlock];
  e_shared = exponent_of(u[0]);
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    e[i] = exponent_of(u[i]);
    e_shared = max(e_shared, e[i]);
  }
  const float top = (float)((1 << mb) - 1);
  packed = 0;
#pragma unroll
  for (int j = 0; j < kBlock / 2; ++j) {
    int sub = max(e[2 * j], e[2 * j + 1]) < e_shared ? 1 : 0;
    packed |= (uint32_t)sub << j;
    float scale = pow2((mb - 1) - (e_shared - sub));
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int i = 2 * j + t;
      float q = 0.0f;
      if (!is_zero(u[i])) {
        float v = __uint_as_float(u[i]);
        q = fminf(rintf(fabsf(v) * scale), top);
        if (v < 0.0f) q = -q;
      }
      m[i] = (int8_t)(int)q;
    }
  }
}

// Dequantize one 16-block: v[i] = m[i] * 2**(e - bit(i/2) - (mb - 1)).
__device__ __forceinline__ void dequantize_block(const int8_t (&m)[kBlock],
                                                 int e, uint32_t packed,
                                                 int mb, float (&v)[kBlock]) {
#pragma unroll
  for (int j = 0; j < kBlock / 2; ++j) {
    float scale = pow2(e - (int)((packed >> j) & 1u) - (mb - 1));
    v[2 * j] = (float)m[2 * j] * scale;
    v[2 * j + 1] = (float)m[2 * j + 1] * scale;
  }
}

}  // namespace mx
