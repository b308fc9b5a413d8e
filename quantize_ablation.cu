// The grouped MX quantize / dequantize kernels' other design: shared-memory
// staging. Built by quantize_ablation.py into a library of its own, beside
// the kernels as built (csrc/mx_quantize.cu: four lanes a block), and timed
// and checked against them. Not part of the port.
//
// A CTA takes a chunk of kChunk (256) blocks of one leaf, as the built
// kernels do, with their table, planner and host path. Quantize copies the
// chunk's fp32 values into shared memory with coalesced 16-byte loads (a
// warp reads 512 contiguous bytes), then each thread runs mx::quantize_block
// on one block from shared memory and stores its 16 mantissas as one
// 16-byte store (a warp writes 512 contiguous bytes) and one byte each of
// exponent and bits (32 contiguous bytes). Each staged block takes 20
// floats, not 16: a quarter-warp's 16-byte reads of eight blocks then fall
// on distinct banks. Dequantize mirrors it: a thread reads its block's 16
// mantissas, exponent and bits, runs mx::dequantize_block into shared
// memory, and the CTA writes the chunk out with coalesced float4 stores.
//
// The table's entry points keep their names, so that the built wrappers
// (kernels/mx_quantize.py) drive this library unchanged; the built
// kernels' entry points are renamed out of the way.
#define mx_quantize_many mx_quantize_many_lanes
#define mx_dequantize_many mx_dequantize_many_lanes
#include "mx_quantize.cu"
#undef mx_quantize_many
#undef mx_dequantize_many

namespace {

constexpr int kPad = 20;  // floats a staged block takes in shared memory
static_assert(kChunk == kThreads, "one block a thread");

__global__ void __launch_bounds__(kThreads)
staged_quantize_kernel(const __grid_constant__ Table t) {
  __shared__ float4 tile[kChunk * kPad / 4];
  const long long first = (long long)blockIdx.x * kChunk;
  const Leaf& leaf = find_leaf(t, first);
  const int base = (int)(first - leaf.begin);
  for (int f = threadIdx.x; f < kChunk * 4; f += kThreads) {
    uint32_t u[4];
    load4(leaf, base + f / 4, f % 4, u);
    tile[(f / 4) * (kPad / 4) + f % 4] =
        make_float4(__uint_as_float(u[0]), __uint_as_float(u[1]),
                    __uint_as_float(u[2]), __uint_as_float(u[3]));
  }
  __syncthreads();
  const int b = threadIdx.x;
  uint32_t u[kBlock];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = tile[b * (kPad / 4) + i];
    u[4 * i + 0] = __float_as_uint(v.x);
    u[4 * i + 1] = __float_as_uint(v.y);
    u[4 * i + 2] = __float_as_uint(v.z);
    u[4 * i + 3] = __float_as_uint(v.w);
  }
  int8_t m[kBlock];
  int e;
  uint32_t packed;
  mx::quantize_block(u, t.mb, m, e, packed);
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    words[i / 4] |= (uint32_t)(uint8_t)m[i] << (8 * (i % 4));
  }
  // Whole chunks are the leaf's own (the planner), as for the built kernel.
  ((uint4*)leaf.dst)[base + b] =
      make_uint4(words[0], words[1], words[2], words[3]);
  ((int8_t*)leaf.expo)[base + b] = (int8_t)e;
  ((uint8_t*)leaf.bits)[base + b] = (uint8_t)packed;
}

__global__ void __launch_bounds__(kThreads)
staged_dequantize_kernel(const __grid_constant__ Table t) {
  __shared__ float4 tile[kChunk * kPad / 4];
  const long long first = (long long)blockIdx.x * kChunk;
  const Leaf& leaf = find_leaf(t, first);
  const int base = (int)(first - leaf.begin);
  const int b = threadIdx.x;
  int8_t m[kBlock];
  int e = 0;
  uint32_t packed = 0u;
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (base + b < leaf.blocks) {
    w = __ldg((const uint4*)leaf.src + base + b);
    e = __ldg((const int8_t*)leaf.expo + base + b);
    packed = __ldg((const uint8_t*)leaf.bits + base + b);
  }
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < kBlock; ++i) {
    m[i] = (int8_t)(words[i / 4] >> (8 * (i % 4)));
  }
  float v[kBlock];
  mx::dequantize_block(m, e, packed, t.mb, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tile[b * (kPad / 4) + i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < kChunk * 4; f += kThreads) {
    const float4 q = tile[(f / 4) * (kPad / 4) + f % 4];
    const float y[4] = {q.x, q.y, q.z, q.w};
    store4(leaf, base + f / 4, f % 4, y);
  }
}

}  // namespace

extern "C" int mx_quantize_many(const void* leaves, int n, int mb,
                                long long chunks, void* stream) {
  Table t;
  const cudaError_t bad = make_table(leaves, n, mb, chunks, t);
  if (bad != cudaSuccess) return (int)bad;
  if (chunks > 0) {
    staged_quantize_kernel<<<(unsigned)chunks, kThreads, 0,
                             (cudaStream_t)stream>>>(t);
  }
  return (int)cudaGetLastError();
}

extern "C" int mx_dequantize_many(const void* leaves, int n, int mb,
                                  long long chunks, void* stream) {
  Table t;
  const cudaError_t bad = make_table(leaves, n, mb, chunks, t);
  if (bad != cudaSuccess) return (int)bad;
  if (chunks > 0) {
    staged_dequantize_kernel<<<(unsigned)chunks, kThreads, 0,
                               (cudaStream_t)stream>>>(t);
  }
  return (int)cudaGetLastError();
}
