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
// Numerics: compiled without --use_fast_math (no flush-to-zero), rounding
// with rintf (half to even, as jnp.round), scales with ldexpf (exact).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;
constexpr int kThreads = 256;

// Unbiased fp32 exponent; zero and denormals (field 0) give EXP_MIN = -126.
__device__ __forceinline__ int exponent_of(uint32_t bits) {
  int field = (bits >> 23) & 0xFF;
  return max(field, 1) - 127;
}

__device__ __forceinline__ bool is_zero(uint32_t bits) {
  return (bits & 0x7F800000u) == 0u;
}

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
  int e[kBlock];
  int e_shared = exponent_of(u[0]);
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    e[i] = exponent_of(u[i]);
    e_shared = max(e_shared, e[i]);
  }
  const float top = (float)((1 << mb) - 1);
  uint32_t packed = 0;
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kBlock / 2; ++j) {
    int mx = max(e[2 * j], e[2 * j + 1]) < e_shared ? 1 : 0;
    packed |= (uint32_t)mx << j;
    float scale = ldexpf(1.0f, (mb - 1) - (e_shared - mx));
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int i = 2 * j + t;
      float m = 0.0f;
      if (!is_zero(u[i])) {
        float v = __uint_as_float(u[i]);
        m = fminf(rintf(fabsf(v) * scale), top);
        if (v < 0.0f) m = -m;
      }
      uint32_t byte = (uint32_t)(uint8_t)(int8_t)(int)m;
      words[i / 4] |= byte << (8 * (i % 4));
    }
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
