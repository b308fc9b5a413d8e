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
// Numerics. Long contractions are split in a fixed order. The wrapper
// chooses, from the GEMM's shape alone (mx_matmul.py::gemm_split_plan, a
// pure function of (M, N, Kp)), S chunks of the contraction whose
// boundaries fall on multiples of 16, so every MX block quantized along
// the contraction stays whole; S = 1 wherever the output's tiles fill the
// card. Each partial is one fp32 FMA chain over its chunk, k in order,
// starting from 0; a second kernel (split_reduce_kernel) adds the S
// partials in the order s = 0, 1, ..., S-1. No atomics. So a result
// repeats bit for bit from run to run; it depends on the shape-chosen
// chunking, not on the tiling. Since all four kernels share the driver
// and the plan, the JAX package's contracts hold bitwise on the card:
//   fused(a, b) == mx(quantize(a), quantize_rhs(b)) == prequant(a,
//   quantize_rhs(b)), and bwd_pair(g, x, w) == (fused(g, w^T),
//   fused(x^T, g)) — the pair's dW and fused(x^T, g) see the same
//   (K, N, Mp), so the same chunks.
// A product of two dequantized MX values (at most 8 significant bits
// each) is exact in fp32 outside the denormal range, so the kernels
// differ from the plain version's matmul only by summation order; a
// chunked sum is one more summation order, so the limits
// 2·Kp·2⁻²⁴·(|A_q| @ |B_q|) and 4·√Kp·2⁻²⁴·√(A_q² @ B_q²) of ref.py::
// gemm_error_limits still cover it.
//
// Bound (H100 SXM, NVIDIA data sheet). The least time is the larger of
//   operations: 2 M N K (4 M N K for the pair) over 989 TFLOP/s — the
//       dequantized operands are exact in bf16, so a tensor-core (wgmma)
//       design could run at the bf16 rate;
//   bytes: fp32 operands at 4 bytes an element, stored MX operands at
//       1 + 2/16 bytes, the fp32 output once, over 3.35 TB/s.
// For ResNet18's GEMMs at batch 32 the bytes bound: with fp32 operands
// and N <= 1000 they carry fewer operations per byte than the ~295 the
// bf16 rate needs. What this design does about either bound: it runs on
// the CUDA cores, whose fp32 peak is 67 TFLOP/s, with no software
// pipelining; the split keeps the SMs busy where the output has few
// tiles (the pair's dW, contracted over M = 401,408, has 2 tiles at
// ResNet18's stem at batch 32). wgmma on bf16 tiles fed by TMA is later
// work.
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

// One GEMM: C [M, N] (row-major, ld N) over a contraction of length K,
// split into `split` chunks of `chunk` (a multiple of 16). With split = 1
// the tiles write C; otherwise chunk s writes its partial to ws[s] [M, N]
// and split_reduce_kernel sums them into C.
template <class A, class B>
struct Gemm {
  A a;
  B b;
  float* c;
  float* ws;
  int M, N, K;
  int split, chunk;
  int tiles_n, tiles;  // tiles of C
  int ctas;            // tiles * split
};

template <class A, class B>
Gemm<A, B> make_gemm(A a, B b, void* c, int M, int N, int K, int split,
                     int chunk, void* ws) {
  int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  int tiles = tiles_m * tiles_n;
  return Gemm<A, B>{a, b, (float*)c, (float*)ws, M, N, K, split, chunk,
                    tiles_n, tiles, tiles * split};
}

// CTA `cta` computes chunk cta / tiles of tile cta % tiles: the tiles of
// one chunk are neighbours in the grid, so they share its rhs rows in L2.
// kSplit = false (split = 1) is the whole contraction into C.
template <bool kSplit, class A, class B>
__device__ __forceinline__ void gemm_tile(const Gemm<A, B>& g, int cta,
                                          float (&As)[kBK][kBM],
                                          float (&Bs)[kBK][kBN]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int s = kSplit ? cta / g.tiles : 0;
  const int tile = kSplit ? cta % g.tiles : cta;
  const int m0 = (tile / g.tiles_n) * kBM, n0 = (tile % g.tiles_n) * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int kp = (g.K + kBK - 1) / kBK * kBK;
  const int k_begin = kSplit ? s * g.chunk : 0;
  const int k_end =
      kSplit ? (int)min((long long)kp, (long long)(s + 1) * g.chunk) : kp;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
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
  float* out = kSplit ? g.ws + (long long)s * g.M * g.N : g.c;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= g.M) continue;
    float* row = out + (long long)m * g.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < g.N) row[n] = acc[i][j];
    }
  }
}

// One GEMM; a 1-D grid of its (tile, chunk) CTAs, tiles row-major over
// (tile_m, tile_n) so neighbouring blocks share an lhs row panel in L2.
template <bool kSplit, class A, class B>
__global__ void __launch_bounds__(kThreads) gemm_kernel(Gemm<A, B> g) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  gemm_tile<kSplit>(g, blockIdx.x, As, Bs);
}

template <class A, class B>
__device__ __forceinline__ void any_tile(const Gemm<A, B>& g, int cta,
                                         float (&As)[kBK][kBM],
                                         float (&Bs)[kBK][kBN]) {
  if (g.split == 1) {
    gemm_tile<false>(g, cta, As, Bs);
  } else {
    gemm_tile<true>(g, cta, As, Bs);
  }
}

// The backward pair in one launch: the grid covers the CTAs of dX, then
// those of dW, and a block computes the GEMM its index falls in — the
// Hopper form of the Pallas kernel's two-phase 1-D grid.
template <class A1, class B1, class A2, class B2>
__global__ void __launch_bounds__(kThreads)
pair_kernel(Gemm<A1, B1> g1, Gemm<A2, B2> g2) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int t = blockIdx.x;
  if (t < g1.ctas) {
    any_tile(g1, t, As, Bs);
  } else {
    any_tile(g2, t - g1.ctas, As, Bs);
  }
}

// c[i] = ws[0][i] + ws[1][i] + ... + ws[split - 1][i], in that order.
__global__ void split_reduce_kernel(const float* __restrict__ ws,
                                    float* __restrict__ c, long long mn,
                                    int split) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < mn; i += (long long)gridDim.x * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < split; ++s) acc += ws[s * mn + i];
    c[i] = acc;
  }
}

template <class A, class B>
void launch_reduce(const Gemm<A, B>& g, cudaStream_t stream) {
  if (g.split == 1 || g.tiles == 0) return;
  const long long mn = (long long)g.M * g.N;
  const int threads = 256;
  const long long blocks = min((mn + threads - 1) / threads, 8LL * 1024);
  split_reduce_kernel<<<(int)blocks, threads, 0, stream>>>(g.ws, g.c, mn,
                                                           g.split);
}

template <class A, class B>
int launch(const Gemm<A, B>& g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (g.ctas > 0 && g.split == 1) {
    gemm_kernel<false, A, B><<<g.ctas, kThreads, 0, s>>>(g);
  } else if (g.ctas > 0) {
    gemm_kernel<true, A, B><<<g.ctas, kThreads, 0, s>>>(g);
    launch_reduce(g, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Every function launches on
// `stream` and returns cudaGetLastError() (0 on success); nothing here
// synchronizes or allocates. Outputs are row-major fp32. Precisions are
// mantissa bits (2 / 4 / 7). (split, chunk, ws) is the GEMM's split of
// its contraction (mx_matmul.py::gemm_split_plan) and, where split > 1,
// an fp32 workspace [split, M, N]. The wrapper checks devices, types,
// shapes and the 16-byte alignment of MX mantissa rows.

// Unfused: lhs MXTensor K-last (mantissa [M, Kp]), rhs MXTensor K-first
// (mantissa [Kp, N]) -> c [M, N].
extern "C" int mx_gemm_mx(const void* lm, const void* le, const void* lx,
                          int mb_a, const void* rm, const void* re,
                          const void* rx, int mb_b, void* c, int M, int N,
                          int Kp, int split, int chunk, void* ws,
                          void* stream) {
  LhsMX a{(const int8_t*)lm, (const int8_t*)le, (const uint8_t*)lx, Kp, mb_a};
  RhsMX b{(const int8_t*)rm, (const int8_t*)re, (const uint8_t*)rx, N, mb_b};
  return launch(make_gemm(a, b, c, M, N, Kp, split, chunk, ws), stream);
}

// Fused: fp32 a (element (m, k) at a[m * sam + k * sak]) and fp32 b
// (element (k, n) at b[k * sbk + n * sbn]), both quantized in-tile.
extern "C" int mx_gemm_fused(const void* a, long long sam, long long sak,
                             int mb_a, const void* b, long long sbk,
                             long long sbn, int mb_b, void* c, int M, int N,
                             int K, int split, int chunk, void* ws,
                             void* stream) {
  LhsF32 la{(const float*)a, sam, sak, mb_a};
  RhsF32 rb{(const float*)b, sbk, sbn, mb_b};
  return launch(make_gemm(la, rb, c, M, N, K, split, chunk, ws), stream);
}

// Weight-resident serving: fp32 a quantized in-tile, a stored rhs-layout
// weight (mantissa [Kp, N], Kp = 16 * ceil(K / 16)) only dequantized.
extern "C" int mx_gemm_prequant(const void* a, long long sam, long long sak,
                                int mb_a, const void* rm, const void* re,
                                const void* rx, int mb_b, void* c, int M,
                                int N, int K, int split, int chunk, void* ws,
                                void* stream) {
  LhsF32 la{(const float*)a, sam, sak, mb_a};
  RhsMX b{(const int8_t*)rm, (const int8_t*)re, (const uint8_t*)rx, N, mb_b};
  return launch(make_gemm(la, b, c, M, N, K, split, chunk, ws), stream);
}

// Backward pair of y = x @ w: g [M, N], x [M, K], w [K, N], row-major.
//   dx [M, K] = q(g) @ q(w^T): g read as an lhs, quantized along N; w^T
//       read through strides as an rhs, quantized along N.
//   dw [K, N] = q(x^T) @ q(g): x^T read through strides as an lhs,
//       quantized along M; g read as an rhs, quantized in 16-row slabs
//       along M — the same cotangent quantized a second time, along the
//       other axis, as the Pallas kernel does.
// One launch covers the (tile, chunk) CTAs of both; a reduce launch
// follows for each GEMM whose split is above 1.
extern "C" int mx_gemm_bwd_pair(const void* g, const void* x, const void* w,
                                int mb, void* dx, void* dw, int M, int N,
                                int K, int split_dx, int chunk_dx,
                                void* ws_dx, int split_dw, int chunk_dw,
                                void* ws_dw, void* stream) {
  LhsF32 g_lhs{(const float*)g, N, 1, mb};
  RhsF32 wt_rhs{(const float*)w, 1, N, mb};
  LhsF32 xt_lhs{(const float*)x, 1, K, mb};
  RhsF32 g_rhs{(const float*)g, N, 1, mb};
  auto g1 = make_gemm(g_lhs, wt_rhs, dx, M, K, N, split_dx, chunk_dx, ws_dx);
  auto g2 = make_gemm(xt_lhs, g_rhs, dw, K, N, M, split_dw, chunk_dw, ws_dw);
  cudaStream_t s = (cudaStream_t)stream;
  int ctas = g1.ctas + g2.ctas;
  if (ctas > 0) {
    pair_kernel<<<ctas, kThreads, 0, s>>>(g1, g2);
    launch_reduce(g1, s);
    launch_reduce(g2, s);
  }
  return (int)cudaGetLastError();
}
