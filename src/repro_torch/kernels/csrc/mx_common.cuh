// MX block arithmetic shared by every kernel of the port (device code).
//
// One 16-block of fp32 values becomes 16 sign-magnitude int8 mantissas, an
// int8 shared exponent and 8 packed micro-exponent bits; the rules are
// those of repro_torch/kernels/ref.py::mx_quantize_ref, bit for bit:
//   - an exponent field of 0 (zero or fp32 denormal) counts as zero, with
//     exponent EXP_MIN = -126 and mantissa 0 — masked explicitly, so the
//     infinite quantize scale of an all-zero block never meets a zero
//     (0 * inf = NaN);
//   - rounding is half to even, as jnp.round / torch.round (round_clip:
//     rintf's result without the conversion unit);
//   - powers of two are built from exponent bits (pow2), never with exp2f
//     (on an H100 the GEMMs measured 2-6 % faster with it than with
//     ldexpf).
// mx_quantize_kernel stores the result of quantize_block; the GEMM kernels
// (mx_gemm.cu) quantize and dequantize their tiles with its core
// quantize_block_f and dequantize_block's core dequantize_block_f (the
// mantissas kept as exact floats instead of int8), so a tile quantized
// inside a GEMM is bit for bit what the quantize kernel stores and the
// dequantize kernel returns. (mx_dequantize_kernel keeps its own loop,
// with the same exact values.)
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
// -127 to -149, zero below. Selects, no branches: a branch here splits the
// quantize loop into regions the compiler cannot interleave.
__device__ __forceinline__ float pow2(int n) {
  const uint32_t normal = (uint32_t)(min(max(n, -126), 128) + 127) << 23;
  const uint32_t denormal = n >= -149 ? 1u << ((n + 149) & 31) : 0u;
  return __uint_as_float(n >= -126 ? normal : denormal);
}

// fminf(rintf(a * s), top) for a >= 0 or NaN (NaN gives top) and s a
// power of two, without the conversion unit (FRND runs at a fraction of
// the FMA rate): below 2^23, a * s + 2^23 rounds a * s to an integer, half
// to even, and the subtraction is exact; from 2^23 up (inf included) both
// forms give top. One rounding (fma) equals two (mul, add): a * s is exact
// unless it leaves the normal range, where both forms round to 0 or top.
__device__ __forceinline__ float round_clip(float a, float s, float top) {
  const float big = 8388608.0f;  // 2^23
  return fminf(__fsub_rn(__fmaf_rn(a, s, big), big), top);
}

// An int8 mantissa as an exact float without the conversion unit: the
// float with bits 0x4B000000 | (m + 128) is 2^23 + m + 128.
__device__ __forceinline__ float mantissa_float(int8_t m) {
  return __fsub_rn(
      __uint_as_float(0x4B000000u | (uint32_t)(uint8_t)(m ^ 0x80)),
      8388736.0f);
}

// Quantize one 16-block given as raw fp32 bits, mb mantissa bits
// (2 / 4 / 7 for mx4 / mx6 / mx9), the mantissas as exact floats (integers
// of at most mb magnitude bits, signed as the input; a zero mantissa of a
// negative input is -0). quantize_block stores them as int8; the GEMMs
// (mx_gemm.cu) dequantize them directly.
// The exponent field grows with the magnitude's bit pattern, so the
// largest field of a pair or a block is that of its largest |bits|; a
// block has two scales, one for the pairs below the shared exponent.
__device__ __forceinline__ void quantize_block_f(const uint32_t (&u)[kBlock],
                                                 int mb, float (&q)[kBlock],
                                                 int& e_shared,
                                                 uint32_t& packed) {
  uint32_t pair_max[kBlock / 2], block_max = 0;
#pragma unroll
  for (int j = 0; j < kBlock / 2; ++j) {
    pair_max[j] = max(u[2 * j] & 0x7FFFFFFFu, u[2 * j + 1] & 0x7FFFFFFFu);
    block_max = max(block_max, pair_max[j]);
  }
  e_shared = exponent_of(block_max);
  const float top = (float)((1 << mb) - 1);
  const float scale_top = pow2((mb - 1) - e_shared);
  const float scale_sub = pow2((mb - 1) - (e_shared - 1));
  packed = 0;
#pragma unroll
  for (int j = 0; j < kBlock / 2; ++j) {
    const bool sub = exponent_of(pair_max[j]) < e_shared;
    packed |= (uint32_t)sub << j;
    const float scale = sub ? scale_sub : scale_top;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int i = 2 * j + t;
      float v = __uint_as_float(u[i]);
      float r = is_zero(u[i]) ? 0.0f : round_clip(fabsf(v), scale, top);
      q[i] = v < 0.0f ? -r : r;
    }
  }
}

__device__ __forceinline__ void quantize_block(const uint32_t (&u)[kBlock],
                                               int mb, int8_t (&m)[kBlock],
                                               int& e_shared,
                                               uint32_t& packed) {
  float q[kBlock];
  quantize_block_f(u, mb, q, e_shared, packed);
#pragma unroll
  for (int i = 0; i < kBlock; ++i) m[i] = (int8_t)(int)q[i];
}

// Dequantize one 16-block: v[i] = q[i] * 2**(e - bit(i/2) - (mb - 1)),
// the mantissas given as exact floats.
__device__ __forceinline__ void dequantize_block_f(const float (&q)[kBlock],
                                                   int e, uint32_t packed,
                                                   int mb,
                                                   float (&v)[kBlock]) {
  const float scale_top = pow2(e - (mb - 1));
  const float scale_sub = pow2(e - 1 - (mb - 1));
#pragma unroll
  for (int j = 0; j < kBlock / 2; ++j) {
    const float scale = (packed >> j) & 1u ? scale_sub : scale_top;
    v[2 * j] = q[2 * j] * scale;
    v[2 * j + 1] = q[2 * j + 1] * scale;
  }
}

__device__ __forceinline__ void dequantize_block(const int8_t (&m)[kBlock],
                                                 int e, uint32_t packed,
                                                 int mb, float (&v)[kBlock]) {
  float q[kBlock];
#pragma unroll
  for (int i = 0; i < kBlock; ++i) q[i] = mantissa_float(m[i]);
  dequantize_block_f(q, e, packed, mb, v);
}

}  // namespace mx
