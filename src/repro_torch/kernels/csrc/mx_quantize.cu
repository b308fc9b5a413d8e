// MX quantize / dequantize for Hopper (sm_90a), written by hand.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/mx_quantize.py::_quantize_kernel (and its inverse, the jnp
// oracle kernels/ref.py::mx_dequantize_ref, which the serving path runs
// after every quantize). The plain PyTorch versions these kernels are held
// to, bitwise, are repro_torch/kernels/ref.py::mx_quantize_ref and
// ::mx_dequantize_ref; read that module for the numerics (zero and
// denormal inputs count as zero, scales are exact powers of two).
//
// Layout: x is [M, K] fp32, row-major, K % 16 == 0, so 16-block b of the
// flattened array starts at element 16*b whatever the row. Outputs are
// mantissa int8 [M, K], exponent int8 [M, K/16], micro-exponent bits
// uint8 [M, K/16].
//
// Bound: both kernels are memory-bound. Quantize reads 4 bytes and writes
// 1 + 2/16 bytes per element (5.125 B/element), dequantize the reverse;
// at the H100 SXM's 3.35 TB/s a [9216, 1024] fp32 leaf (the largest of
// full-width WideResNet50) moves 48.4 MB, a bound of 14.4 us. The work per
// element is a handful of integer and fp32 operations, far below the
// card's operation rate, so the design spends nothing on the arithmetic
// and keeps the memory traffic at the minimum: one thread owns one
// 16-block, loads it as four 16-byte float4 loads (read once, no shared
// memory, no second pass), computes the shared exponent and the 8
// pair-maxima in registers, and stores the 16 mantissas as one 16-byte
// store plus one byte each of exponent and bits. Dequantize mirrors it
// (one 16-byte load, four float4 stores). The grid has one thread per
// block, so a [9216, 1024] leaf launches 589,824 threads — enough to fill
// the 132 SMs many times over.
//
// Numerics: the quantize arithmetic is mx_common.cuh's, shared with the
// GEMM kernels (mx_gemm.cu); compiled without --use_fast_math (no
// flush-to-zero), rounding half to even as jnp.round (rintf's result, by
// mx_common.cuh::round_clip), exact power-of-two scales.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_common.cuh"

namespace {

constexpr int kBlock = mx::kBlock;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mx_quantize_kernel(const float4* __restrict__ x, uint4* __restrict__ mant,
                   int8_t* __restrict__ expo, uint8_t* __restrict__ bits,
                   long long n_blocks, int mb) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  uint32_t u[kBlock];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 t = x[b * 4 + i];
    u[4 * i + 0] = __float_as_uint(t.x);
    u[4 * i + 1] = __float_as_uint(t.y);
    u[4 * i + 2] = __float_as_uint(t.z);
    u[4 * i + 3] = __float_as_uint(t.w);
  }
  int8_t m[kBlock];
  int e_shared;
  uint32_t packed;
  mx::quantize_block(u, mb, m, e_shared, packed);
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    words[i / 4] |= (uint32_t)(uint8_t)m[i] << (8 * (i % 4));
  }
  mant[b] = make_uint4(words[0], words[1], words[2], words[3]);
  expo[b] = (int8_t)e_shared;
  bits[b] = (uint8_t)packed;
}

__global__ void __launch_bounds__(kThreads)
mx_dequantize_kernel(const uint4* __restrict__ mant,
                     const int8_t* __restrict__ expo,
                     const uint8_t* __restrict__ bits,
                     float4* __restrict__ out, long long n_blocks, int mb) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  // Not mx::dequantize_block: this loop (ldexpf scales, exact) measured
  // ~7 % faster here on an H100 at [9216, 1024] (PERF.md).
  uint4 w = mant[b];
  uint32_t words[4] = {w.x, w.y, w.z, w.w};
  int e = expo[b];
  uint32_t packed = bits[b];
  float v[kBlock];
#pragma unroll
  for (int j = 0; j < kBlock / 2; ++j) {
    int e_eff = e - (int)((packed >> j) & 1u);
    float scale = ldexpf(1.0f, e_eff - (mb - 1));
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int i = 2 * j + t;
      int8_t m = (int8_t)((words[i / 4] >> (8 * (i % 4))) & 0xFFu);
      v[i] = (float)m * scale;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[b * 4 + i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                 v[4 * i + 3]);
  }
}

unsigned int grid_for(long long n_blocks) {
  return (unsigned int)((n_blocks + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers must be 16-byte aligned
// (the wrapper checks). Each function launches on `stream` and returns
// cudaGetLastError() (0 on success); nothing here synchronizes.
extern "C" int mx_quantize_f32(const void* x, void* mant, void* expo,
                               void* bits, long long n_blocks, int mb,
                               void* stream) {
  if (n_blocks > 0) {
    mx_quantize_kernel<<<grid_for(n_blocks), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const float4*)x, (uint4*)mant, (int8_t*)expo, (uint8_t*)bits,
        n_blocks, mb);
  }
  return (int)cudaGetLastError();
}

extern "C" int mx_dequantize_f32(const void* mant, const void* expo,
                                 const void* bits, void* out,
                                 long long n_blocks, int mb, void* stream) {
  if (n_blocks > 0) {
    mx_dequantize_kernel<<<grid_for(n_blocks), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint4*)mant, (const int8_t*)expo, (const uint8_t*)bits,
        (float4*)out, n_blocks, mb);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
