// MX GEMMs for Hopper (sm_90a), written by hand: the four Pallas GEMM
// kernels of the JAX package, on one tiled fp32 GEMM.
//
//   mx_gemm_mx        replaces kernels/mx_matmul.py::mx_matmul (:76;
//                     _matmul_kernel :60, _dequant_lhs :40, _dequant_rhs :46)
//   mx_gemm_fused     replaces kernels/mx_fused.py::mx_matmul_fused (:102;
//                     _fused_kernel :85, _quant_dequant_lhs/_rhs :43/:65)
//   mx_gemm_bwd_pair  replaces kernels/mx_fused.py::mx_matmul_bwd_pair
//                     (:189; _bwd_pair_kernel :135)
//   mx_gemm_prequant  replaces kernels/mx_fused.py::mx_matmul_prequant
//                     (:301; _prequant_kernel :280)
//
// The plain versions they are held to are repro_torch/kernels/ref.py::
// mx_matmul_ref, mx_matmul_fused_ref, mx_matmul_bwd_pair_ref and
// mx_matmul_prequant_ref (dequantized operands, then a float32 matmul).
//
// Design. C [M, N] = A [M, K] @ B [K, N] in fp32 on the CUDA cores. A block
// computes a 128 x 128 tile of C with 256 threads, each an 8 x 8 register
// block. The k-step is one MX block (16): every lhs row segment and every
// rhs column segment of a k-step is exactly one MX block, so a loader
// thread turns one 16-block into 16 fp32 values and writes them to shared
// memory (threads 0..127 one lhs row each, threads 128..255 one rhs column
// each). The kernels differ only in their loaders:
//   LhsF32 / RhsF32 — fp32 values, read through strides (so A or B may be a
//       transposed view, with no copy) and quantize-dequantized in-tile by
//       mx_common.cuh's quantize_block / dequantize_block: bit for bit what
//       mx_quantize_kernel would store and mx_dequantize_kernel return;
//   LhsMX — a stored MXTensor, K-last: mantissa [M, Kp], planes [M, Kp/16];
//   RhsMX — a stored MXTensor, K-first: mantissa [Kp, N], planes [Kp/16, N].
// Blocks start at k = 0 and k >= K reads as zero: the zero padding of K
// to Kp = 16 * ceil(K / 16) that the reference applies (ops.py:200-203).
// Ragged M and N edges are masked (loaders give zeros, stores are
// skipped); the 8/128 padding of the Pallas path is TPU tiling and is not
// needed here.
//
// Numerics. Every output is one fp32 FMA chain over k = 0, 1, ..., Kp-1 in
// that order, starting from 0: no split-K, no atomics. So a result repeats
// bit for bit from run to run and does not depend on the tiling, and since
// all four kernels share the loop, the JAX package's contracts hold
// bitwise on the card:
//   fused(a, b) == mx(quantize(a), quantize_rhs(b)) == prequant(a,
//   quantize_rhs(b)), and bwd_pair(g, x, w) == (fused(g, w^T),
//   fused(x^T, g)).
// A product of two dequantized MX values (at most 8 significant bits
// each) is exact in fp32 outside the denormal range, so the kernels
// differ from the plain version's matmul only by summation order.
//
// Bound (H100 SXM, NVIDIA data sheet). The least time is the larger of
//   operations: 2 M N K (4 M N K for the pair) over 989 TFLOP/s — the
//       dequantized operands are exact in bf16, so a tensor-core (wgmma)
//       design could run at the bf16 rate;
//   bytes: fp32 operands at 4 bytes an element, stored MX operands at
//       1 + 2/16 bytes, the fp32 output once, over 3.35 TB/s.
// For ResNet18's GEMMs at batch 32 the bytes bound: with fp32 operands
// and N <= 1000 they carry fewer operations per byte than the ~295 the
// bf16 rate needs. What this simple design does about either bound:
// nothing yet. It runs on the CUDA cores, whose fp32 peak is 67 TFLOP/s,
// with no software pipelining; a GEMM whose output has few tiles but a
// long contraction (the pair's dW, contracted over M) runs on few SMs.
// wgmma on bf16 tiles fed by TMA, and a fixed-order split of long
// contractions, are left to later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mx_common.cuh"

namespace {

constexpr int kBK = mx::kBlock;  // one MX block per k-step
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kThreads = 256;
static_assert(kThreads == kBM + kBN, "one loader thread per row / column");

__device__ __forceinline__ void zero16(float (&v)[kBK]) {
#pragma unroll
  for (int i = 0; i < kBK; ++i) v[i] = 0.0f;
}

__device__ __forceinline__ void quant_dequant(const uint32_t (&u)[kBK],
                                              int mb, float (&v)[kBK]) {
  int8_t q[kBK];
  int e;
  uint32_t bits;
  mx::quantize_block(u, mb, q, e, bits);
  mx::dequantize_block(q, e, bits, mb, v);
}

// fp32 lhs: element (m, k) at p[m * sm + k * sk].
struct LhsF32 {
  const float* p;
  long long sm, sk;
  int mb;
  __device__ __forceinline__ void load(int m, int M, int k0, int K,
                                       float (&v)[kBK]) const {
    if (m >= M) return zero16(v);
    const float* row = p + (long long)m * sm;
    uint32_t u[kBK];
#pragma unroll
    for (int i = 0; i < kBK; ++i) {
      int k = k0 + i;
      u[i] = k < K ? __float_as_uint(__ldg(row + (long long)k * sk)) : 0u;
    }
    quant_dequant(u, mb, v);
  }
};

// fp32 rhs: element (k, n) at p[k * sk + n * sn].
struct RhsF32 {
  const float* p;
  long long sk, sn;
  int mb;
  __device__ __forceinline__ void load(int k0, int K, int n, int N,
                                       float (&v)[kBK]) const {
    if (n >= N) return zero16(v);
    const float* col = p + (long long)n * sn;
    uint32_t u[kBK];
#pragma unroll
    for (int i = 0; i < kBK; ++i) {
      int k = k0 + i;
      u[i] = k < K ? __float_as_uint(__ldg(col + (long long)k * sk)) : 0u;
    }
    quant_dequant(u, mb, v);
  }
};

// Stored MX lhs, K-last: mantissa [M, kp] (16-byte aligned rows),
// exponent / bits [M, kp / 16].
struct LhsMX {
  const int8_t* mant;
  const int8_t* expo;
  const uint8_t* bits;
  long long kp;
  int mb;
  __device__ __forceinline__ void load(int m, int M, int k0, int,
                                       float (&v)[kBK]) const {
    if (m >= M) return zero16(v);
    uint4 w = __ldg(reinterpret_cast<const uint4*>(mant + (long long)m * kp
                                                   + k0));
    uint32_t words[4] = {w.x, w.y, w.z, w.w};
    int8_t q[kBK];
#pragma unroll
    for (int i = 0; i < kBK; ++i) {
      q[i] = (int8_t)((words[i / 4] >> (8 * (i % 4))) & 0xFFu);
    }
    long long b = (long long)m * (kp / kBK) + k0 / kBK;
    mx::dequantize_block(q, __ldg(expo + b), __ldg(bits + b), mb, v);
  }
};

// Stored MX rhs, K-first: mantissa [Kp, ld], exponent / bits [Kp / 16, ld].
struct RhsMX {
  const int8_t* mant;
  const int8_t* expo;
  const uint8_t* bits;
  long long ld;
  int mb;
  __device__ __forceinline__ void load(int k0, int, int n, int N,
                                       float (&v)[kBK]) const {
    if (n >= N) return zero16(v);
    int8_t q[kBK];
#pragma unroll
    for (int i = 0; i < kBK; ++i) {
      q[i] = __ldg(mant + (long long)(k0 + i) * ld + n);
    }
    long long b = (long long)(k0 / kBK) * ld + n;
    mx::dequantize_block(q, __ldg(expo + b), __ldg(bits + b), mb, v);
  }
};

// One GEMM: C [M, N] (row-major, ld N) over a contraction of length K.
template <class A, class B>
struct Gemm {
  A a;
  B b;
  float* c;
  int M, N, K;
  int tiles_n, tiles;
};

template <class A, class B>
Gemm<A, B> make_gemm(A a, B b, void* c, int M, int N, int K) {
  int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  return Gemm<A, B>{a, b, (float*)c, M, N, K, tiles_n, tiles_m * tiles_n};
}

template <class A, class B>
__device__ __forceinline__ void gemm_tile(const Gemm<A, B>& g, int tile,
                                          float (&As)[kBK][kBM],
                                          float (&Bs)[kBK][kBN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = (tile / g.tiles_n) * kBM, n0 = (tile % g.tiles_n) * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int kp = (g.K + kBK - 1) / kBK * kBK;
  for (int k0 = 0; k0 < kp; k0 += kBK) {
    float v[kBK];
    if (tid < kBM) {
      g.a.load(m0 + tid, g.M, k0, g.K, v);
#pragma unroll
      for (int i = 0; i < kBK; ++i) As[i][tid] = v[i];
    } else {
      const int j = tid - kBM;
      g.b.load(k0, g.K, n0 + j, g.N, v);
#pragma unroll
      for (int i = 0; i < kBK; ++i) Bs[i][j] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= g.M) continue;
    float* row = g.c + (long long)m * g.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < g.N) row[n] = acc[i][j];
    }
  }
}

// One GEMM; a 1-D grid of its tiles, row-major over (tile_m, tile_n) so
// neighbouring blocks share an lhs row panel in L2.
template <class A, class B>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm<A, B> g) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  gemm_tile(g, blockIdx.x, As, Bs);
}

// The backward pair in one launch: the grid covers the tiles of dX, then
// those of dW, and a block computes the GEMM its index falls in — the
// Hopper form of the Pallas kernel's two-phase 1-D grid.
template <class A1, class B1, class A2, class B2>
__global__ void __launch_bounds__(kThreads)
pair_kernel(Gemm<A1, B1> g1, Gemm<A2, B2> g2) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int t = blockIdx.x;
  if (t < g1.tiles) {
    gemm_tile(g1, t, As, Bs);
  } else {
    gemm_tile(g2, t - g1.tiles, As, Bs);
  }
}

template <class A, class B>
int launch(const Gemm<A, B>& g, void* stream) {
  if (g.tiles > 0) {
    gemm_kernel<A, B><<<g.tiles, kThreads, 0, (cudaStream_t)stream>>>(g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every function launches on
// `stream` and returns cudaGetLastError() (0 on success); nothing here
// synchronizes or allocates. Outputs are row-major fp32. Precisions are
// mantissa bits (2 / 4 / 7). The wrapper checks devices, types, shapes
// and the 16-byte alignment of MX mantissa rows.

// Unfused: lhs MXTensor K-last (mantissa [M, Kp]), rhs MXTensor K-first
// (mantissa [Kp, N]) -> c [M, N].
extern "C" int mx_gemm_mx(const void* lm, const void* le, const void* lx,
                          int mb_a, const void* rm, const void* re,
                          const void* rx, int mb_b, void* c, int M, int N,
                          int Kp, void* stream) {
  LhsMX a{(const int8_t*)lm, (const int8_t*)le, (const uint8_t*)lx, Kp, mb_a};
  RhsMX b{(const int8_t*)rm, (const int8_t*)re, (const uint8_t*)rx, N, mb_b};
  return launch(make_gemm(a, b, c, M, N, Kp), stream);
}

// Fused: fp32 a (element (m, k) at a[m * sam + k * sak]) and fp32 b
// (element (k, n) at b[k * sbk + n * sbn]), both quantized in-tile.
extern "C" int mx_gemm_fused(const void* a, long long sam, long long sak,
                             int mb_a, const void* b, long long sbk,
                             long long sbn, int mb_b, void* c, int M, int N,
                             int K, void* stream) {
  LhsF32 la{(const float*)a, sam, sak, mb_a};
  RhsF32 rb{(const float*)b, sbk, sbn, mb_b};
  return launch(make_gemm(la, rb, c, M, N, K), stream);
}

// Weight-resident serving: fp32 a quantized in-tile, a stored rhs-layout
// weight (mantissa [Kp, N], Kp = 16 * ceil(K / 16)) only dequantized.
extern "C" int mx_gemm_prequant(const void* a, long long sam, long long sak,
                                int mb_a, const void* rm, const void* re,
                                const void* rx, int mb_b, void* c, int M,
                                int N, int K, void* stream) {
  LhsF32 la{(const float*)a, sam, sak, mb_a};
  RhsMX b{(const int8_t*)rm, (const int8_t*)re, (const uint8_t*)rx, N, mb_b};
  return launch(make_gemm(la, b, c, M, N, K), stream);
}

// Backward pair of y = x @ w: g [M, N], x [M, K], w [K, N], row-major.
//   dx [M, K] = q(g) @ q(w^T): g read as an lhs, quantized along N; w^T
//       read through strides as an rhs, quantized along N.
//   dw [K, N] = q(x^T) @ q(g): x^T read through strides as an lhs,
//       quantized along M; g read as an rhs, quantized in 16-row slabs
//       along M — the same cotangent quantized a second time, along the
//       other axis, as the Pallas kernel does.
extern "C" int mx_gemm_bwd_pair(const void* g, const void* x, const void* w,
                                int mb, void* dx, void* dw, int M, int N,
                                int K, void* stream) {
  LhsF32 g_lhs{(const float*)g, N, 1, mb};
  RhsF32 wt_rhs{(const float*)w, 1, N, mb};
  LhsF32 xt_lhs{(const float*)x, 1, K, mb};
  RhsF32 g_rhs{(const float*)g, N, 1, mb};
  auto g1 = make_gemm(g_lhs, wt_rhs, dx, M, K, N);
  auto g2 = make_gemm(xt_lhs, g_rhs, dw, K, N, M);
  int tiles = g1.tiles + g2.tiles;
  if (tiles > 0) {
    pair_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(g1, g2);
  }
  return (int)cudaGetLastError();
}
