// MX quantize / dequantize for Hopper (sm_90a), written by hand: one launch
// for a whole tree of weight leaves.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/mx_quantize.py::_quantize_kernel (and its inverse, the jnp
// oracle kernels/ref.py::mx_dequantize_ref, which the serving path runs
// after every quantize). The plain PyTorch versions these kernels are held
// to, bitwise, are repro_torch/kernels/ref.py::mx_quantize_ref and
// ::mx_dequantize_ref; read that module for the numerics (zero and
// denormal inputs count as zero, scales are exact powers of two).
//
// Layout: leaf x is [M, K] fp32, row-major; Kp is K rounded up to 16.
// Quantize writes mantissa int8 [M, Kp], exponent int8 [M, Kp/16] and
// micro-exponent bits uint8 [M, Kp/16]; dequantize reads them and writes
// fp32 [M, K].
//
// One launch per tree. A serving-copy fill quantizes every weight leaf of a
// parameter tree (21 to 54 of them in the four models) and dequantizes
// them back. Each kernel takes a table of leaf descriptors (Table) BY VALUE
// as its parameter: CUDA 12.1+ allows 32,764 bytes of parameters on sm_70
// and later, so no host-to-device copy is made and no host buffer has to
// outlive the launch. A descriptor holds the leaf's pointers (the wrapper
// places mantissas, exponents and bits in three arenas, one each per tree),
// its real width K, its blocks per row Kp/16, its block count and `begin`,
// the prefix count of 16-blocks before it in the launch. The planner
// (kernels/mx_quantize.py::plan_many) rounds each leaf's range up to whole
// chunks of kChunk blocks, so a chunk lies in one leaf: each CTA takes one
// chunk and finds its leaf by a binary search of the prefix counts (the
// same for every thread, a broadcast read of the parameter bank). A tree of
// more than kMaxLeaves leaves takes more than one launch.
//
// Coalescing. Four lanes share a 16-block, each holding four consecutive
// values: one float4 of fp32, one 32-bit word of mantissas. A warp so
// reads or writes 8 blocks of fp32 (512 contiguous bytes) or of mantissas
// (128 contiguous bytes) per instruction. The shared exponent is the
// quad's integer max of |bits| (two __shfl_xor), the micro-exponent pairs
// (0,1) and (2,3) of a lane lie in its own four values, and the packed bits
// are the quad's OR (two more). A warp takes 32 consecutive blocks: kSteps
// steps of 8, every load issued before any arithmetic. Quantize gathers
// their 32 exponent and 32 bits bytes by shuffles and stores each set as
// eight 32-bit words, one whole 32-byte sector; dequantize reads them one
// byte a lane, one sector each, and shuffles each block's to its quad.
//
// Ragged K. A leaf whose K is not a multiple of 16 (the classifier heads,
// K = 1000) is quantized where it lies: columns K..Kp-1 read as zero, as
// the reference's zero padding, and dequantize writes only the K real
// columns, straight into the leaf's [M, K] output, so neither side makes a
// padded copy. Where K % 4 == 0 and the fp32 side is 16-byte aligned
// (every leaf of the four models) a lane moves one float4; elsewhere four
// masked scalars.
//
// Bound: both kernels are memory-bound. Quantize reads 4 bytes and writes
// 1 + 2/16 bytes per element (5.125 B/element), dequantize the reverse; at
// the H100 SXM's 3.35 TB/s a [9216, 1024] fp32 leaf (the largest of
// full-width WideResNet50) moves 48.4 MB, a bound of 14.4 us. The work per
// element is a handful of integer and fp32 operations, far below the
// card's operation rate, so the design spends nothing on the arithmetic
// and keeps the traffic at the minimum, each byte moved once, in whole
// sectors.
//
// Numerics: the arithmetic is mx_common.cuh's, shared with the GEMM
// kernels (mx_gemm.cu); quantize_quad and dequantize_quad below are
// mx::quantize_block_f and mx::dequantize_block_f with the block split over
// a quad, operation for operation. Compiled without --use_fast_math (no
// flush-to-zero), rounding half to even as jnp.round (mx::round_clip),
// exact power-of-two scales (mx::pow2).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mx_common.cuh"

namespace {

constexpr int kBlock = mx::kBlock;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;                     // 8-block steps of a warp
constexpr int kWarpBlocks = 8 * kSteps;       // 32: one exponent byte a lane
constexpr int kChunk = kWarps * kWarpBlocks;  // 256 blocks: a CTA's pass
constexpr int kMaxLeaves = 128;               // leaves of one launch
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kWarpBlocks == 32, "the exponent gather assumes a block a lane");

// One leaf of a launch (kernels/mx_quantize.py::LEAF_DTYPE mirrors it).
struct Leaf {
  const void* src;  // quantize: fp32 [M, K]; dequantize: int8 mantissa [M, Kp]
  void* dst;        // quantize: int8 mantissa [M, Kp]; dequantize: fp32 [M, K]
  void* expo;       // int8 [M, Kp/16]: quantize writes it, dequantize reads it
  void* bits;       // uint8 [M, Kp/16]: likewise
  long long begin;  // 16-blocks of the launch before this leaf (kChunk multiple)
  int blocks;       // M * Kp / 16
  int k;            // real K
  int kb;           // Kp / 16, blocks per row
  int vec;          // 1: K % 4 == 0 and the fp32 side 16-byte aligned
};

// A launch's parameter.
struct Table {
  int n;             // leaves, 1..kMaxLeaves
  int mb;            // mantissa bits: 2 / 4 / 7 for mx4 / mx6 / mx9
  long long chunks;  // kChunk-block chunks of the launch
  Leaf leaf[kMaxLeaves];
};

// The leaf holding block `block` of the launch: the last one whose range
// begins at or before it (an empty leaf shares its successor's begin).
__device__ __forceinline__ const Leaf& find_leaf(const Table& t,
                                                 long long block) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].begin <= block) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return t.leaf[lo];
}

// Element offset, in the leaf's [M, K] fp32 side, of lane s's four values
// of block blk, and how many of them are real columns (0..4).
__device__ __forceinline__ long long fp32_offset(const Leaf& leaf, int blk,
                                                 int s, int& real) {
  if (leaf.k == leaf.kb * kBlock) {
    real = 4;
    return (long long)blk * kBlock + 4 * s;
  }
  const int row = blk / leaf.kb;
  const int col = (blk - row * leaf.kb) * kBlock + 4 * s;
  real = min(max(leaf.k - col, 0), 4);
  return (long long)row * leaf.k + col;
}

// Lane s's four fp32 values of block blk as raw bits; zero past the leaf's
// last block and past its K real columns.
__device__ __forceinline__ void load4(const Leaf& leaf, int blk, int s,
                                      uint32_t (&u)[4]) {
  u[0] = u[1] = u[2] = u[3] = 0u;
  if (blk >= leaf.blocks) return;
  int real;
  const float* x = (const float*)leaf.src + fp32_offset(leaf, blk, s, real);
  if (leaf.vec) {  // K % 4 == 0: all four values are real, or none
    if (real == 4) {
      const float4 v = __ldg((const float4*)x);
      u[0] = __float_as_uint(v.x);
      u[1] = __float_as_uint(v.y);
      u[2] = __float_as_uint(v.z);
      u[3] = __float_as_uint(v.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < real) u[i] = __float_as_uint(__ldg(x + i));
    }
  }
}

// Lane lane % 4's fp32 values of the warp's kSteps blocks seg + 8i +
// lane / 4, as load4 gives them, every load issued before any is used: where
// a float4 lane's block is out of range it loads the leaf's first values
// and drops them, so that no load waits on a branch.
__device__ __forceinline__ void load_steps(const Leaf& leaf, int seg,
                                           int lane,
                                           uint32_t (&u)[kSteps][4]) {
  const int s = lane % 4;
  if (!leaf.vec) {
#pragma unroll
    for (int i = 0; i < kSteps; ++i) load4(leaf, seg + 8 * i + lane / 4, s, u[i]);
    return;
  }
  float4 v[kSteps];
  bool ok[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int blk = seg + 8 * i + lane / 4;
    int real;
    const long long off = fp32_offset(leaf, blk, s, real);
    ok[i] = blk < leaf.blocks && real == 4;
    v[i] = __ldg((const float4*)leaf.src + (ok[i] ? off / 4 : 0));
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    u[i][0] = ok[i] ? __float_as_uint(v[i].x) : 0u;
    u[i][1] = ok[i] ? __float_as_uint(v[i].y) : 0u;
    u[i][2] = ok[i] ? __float_as_uint(v[i].z) : 0u;
    u[i][3] = ok[i] ? __float_as_uint(v[i].w) : 0u;
  }
}

// Lane s's four values of block blk into the leaf's [M, K] output; nothing
// past its last block or its K real columns.
__device__ __forceinline__ void store4(const Leaf& leaf, int blk, int s,
                                       const float (&v)[4]) {
  if (blk >= leaf.blocks) return;
  int real;
  float* y = (float*)leaf.dst + fp32_offset(leaf, blk, s, real);
  if (leaf.vec) {
    if (real == 4) *(float4*)y = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < real) y[i] = v[i];
    }
  }
}

// mx::quantize_block_f (and quantize_block's int8 cast) over a 16-block
// held by the four lanes of a quad, lane s holding values 4s..4s+3, i.e.
// pairs 2s and 2s+1: the same operations, with the block's max and the
// packed micro-exponent bits reduced across the quad. Every lane of the
// warp must call it. Returns the lane's four mantissas as one word.
__device__ __forceinline__ uint32_t quantize_quad(const uint32_t (&u)[4],
                                                  int s, int mb,
                                                  int& e_shared,
                                                  uint32_t& packed) {
  const uint32_t pair0 = max(u[0] & 0x7FFFFFFFu, u[1] & 0x7FFFFFFFu);
  const uint32_t pair1 = max(u[2] & 0x7FFFFFFFu, u[3] & 0x7FFFFFFFu);
  uint32_t block_max = max(pair0, pair1);
  block_max = max(block_max, __shfl_xor_sync(kFull, block_max, 1));
  block_max = max(block_max, __shfl_xor_sync(kFull, block_max, 2));
  e_shared = mx::exponent_of(block_max);
  const float top = (float)((1 << mb) - 1);
  const float scale_top = mx::pow2((mb - 1) - e_shared);
  const float scale_sub = mx::pow2((mb - 1) - (e_shared - 1));
  const bool sub0 = mx::exponent_of(pair0) < e_shared;
  const bool sub1 = mx::exponent_of(pair1) < e_shared;
  packed = ((uint32_t)sub0 | ((uint32_t)sub1 << 1)) << (2 * s);
  packed |= __shfl_xor_sync(kFull, packed, 1);
  packed |= __shfl_xor_sync(kFull, packed, 2);
  uint32_t word = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float scale = (i < 2 ? sub0 : sub1) ? scale_sub : scale_top;
    const float v = __uint_as_float(u[i]);
    const float r =
        mx::is_zero(u[i]) ? 0.0f : mx::round_clip(fabsf(v), scale, top);
    const float q = v < 0.0f ? -r : r;
    word |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * i);
  }
  return word;
}

// mx::dequantize_block_f for lane s's four values (pairs 2s and 2s+1) of a
// block with shared exponent e and packed micro-exponent bits.
__device__ __forceinline__ void dequantize_quad(uint32_t word, int e,
                                                uint32_t packed, int s,
                                                int mb, float (&v)[4]) {
  const float scale_top = mx::pow2(e - (mb - 1));
  const float scale_sub = mx::pow2(e - 1 - (mb - 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float scale =
        (packed >> (2 * s + i / 2)) & 1u ? scale_sub : scale_top;
    v[i] = mx::mantissa_float((int8_t)(word >> (8 * i))) * scale;
  }
}

// One CTA's chunk of kChunk blocks.
__device__ __forceinline__ void quantize_chunk(const Table& t,
                                               long long chunk) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, s = lane % 4;
  const long long first = chunk * kChunk;
  const Leaf& leaf = find_leaf(t, first);
  // The warp's 32 blocks, counted from the leaf's first.
  const int seg = (int)(first - leaf.begin) + warp * kWarpBlocks;
  uint32_t u[kSteps][4];
  load_steps(leaf, seg, lane, u);
  uint32_t eb[kSteps];  // a block's exponent byte | its bits byte << 8
  uint32_t* mant = (uint32_t*)leaf.dst;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    int e;
    uint32_t packed;
    const uint32_t word = quantize_quad(u[i], s, t.mb, e, packed);
    // Unmasked: the planner reserves whole chunks, so a block past the
    // leaf's last still lies in the leaf's own range of the arenas.
    mant[(long long)(seg + 8 * i + lane / 4) * (kBlock / 4) + s] = word;
    eb[i] = ((uint32_t)e & 0xFFu) | (packed << 8);
  }
  // Block `lane` of the warp's 32 was step lane / 8's quad lane % 8.
  uint32_t mine = 0u;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const uint32_t v = __shfl_sync(kFull, eb[i], (lane % 8) * 4);
    if (lane / 8 == i) mine = v;
  }
  // Lane 4j gathers blocks 4j..4j+3: [e0 p0 e1 p1] and [e2 p2 e3 p3].
  const uint32_t two = mine | (__shfl_down_sync(kFull, mine, 1) << 16);
  const uint32_t four = __shfl_down_sync(kFull, two, 2);
  if (lane % 4 == 0) {
    ((uint32_t*)((int8_t*)leaf.expo + seg))[lane / 4] =
        __byte_perm(two, four, 0x6420);
    ((uint32_t*)((uint8_t*)leaf.bits + seg))[lane / 4] =
        __byte_perm(two, four, 0x7531);
  }
}

__device__ __forceinline__ void dequantize_chunk(const Table& t,
                                                 long long chunk) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, s = lane % 4;
  const long long first = chunk * kChunk;
  const Leaf& leaf = find_leaf(t, first);
  const int seg = (int)(first - leaf.begin) + warp * kWarpBlocks;
  // Exponent and bits of the warp's block `lane` (one sector each), and
  // each step's mantissa word; out-of-range lanes load the leaf's first
  // block's and drop it, so that every load issues at once.
  const int own = seg + lane < leaf.blocks ? seg + lane : 0;
  const uint32_t eb =
      (uint32_t)(uint8_t)__ldg((const int8_t*)leaf.expo + own) |
      ((uint32_t)__ldg((const uint8_t*)leaf.bits + own) << 8);
  uint32_t w[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int blk = seg + 8 * i + lane / 4;
    const bool ok = blk < leaf.blocks;
    w[i] = __ldg((const uint32_t*)leaf.src +
                 (ok ? (long long)blk * (kBlock / 4) + s : 0));
    w[i] = ok ? w[i] : 0u;
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const uint32_t v = __shfl_sync(kFull, eb, 8 * i + lane / 4);
    float y[4];
    dequantize_quad(w[i], (int)(int8_t)(v & 0xFFu), v >> 8, s, t.mb, y);
    store4(leaf, seg + 8 * i + lane / 4, s, y);
  }
}

// One CTA a chunk: a grid-stride loop over CTAs that fit on the card at
// once measured slower on every tree (quantize_ablation.py). Quantize keeps
// to 32 registers, eight CTAs an SM: about 4 % faster on the model trees
// (5 % slower on one [9216, 1024] leaf) than the 42 it takes uncapped.
__global__ void __launch_bounds__(kThreads, 8)
mx_quantize_many_kernel(const __grid_constant__ Table t) {
  quantize_chunk(t, blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
mx_dequantize_many_kernel(const __grid_constant__ Table t) {
  dequantize_chunk(t, blockIdx.x);
}

// The launch's parameter from the caller's `n` leaves; cudaErrorInvalidValue
// for a table out of range.
cudaError_t make_table(const void* leaves, int n, int mb, long long chunks,
                       Table& t) {
  if (leaves == nullptr || n < 1 || n > kMaxLeaves || mb < 1 || mb > 7 ||
      chunks < 0) {
    return cudaErrorInvalidValue;
  }
  t.n = n;
  t.mb = mb;
  t.chunks = chunks;
  memcpy(t.leaf, leaves, sizeof(Leaf) * n);
  return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes. `leaves` points to `n` host Leaf
// records (kernels/mx_quantize.py::LEAF_DTYPE); the launch takes a copy of
// them as its parameter, so the caller's buffer may go as soon as the call
// returns. Each function launches on `stream` (nothing when `chunks` is 0)
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a table out of range; nothing here synchronizes.
extern "C" int mx_quantize_many(const void* leaves, int n, int mb,
                                long long chunks, void* stream) {
  Table t;
  const cudaError_t bad = make_table(leaves, n, mb, chunks, t);
  if (bad != cudaSuccess) return (int)bad;
  if (chunks > 0) {
    mx_quantize_many_kernel<<<(unsigned)chunks, kThreads, 0,
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
    mx_dequantize_many_kernel<<<(unsigned)chunks, kThreads, 0,
                                (cudaStream_t)stream>>>(t);
  }
  return (int)cudaGetLastError();
}

// The table's shape, which the wrapper's mirror must match.
extern "C" long long mx_many_max_leaves() { return kMaxLeaves; }
extern "C" long long mx_many_chunk_blocks() { return kChunk; }
extern "C" long long mx_many_leaf_bytes() { return (long long)sizeof(Leaf); }

extern "C" const char* mx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
