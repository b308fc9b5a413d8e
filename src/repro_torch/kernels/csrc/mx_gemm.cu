// MX GEMMs for Hopper (sm_90a), written by hand: the four Pallas GEMM
// kernels of the JAX package, on one bf16 wgmma mainloop.
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
// Bound (H100 SXM, NVIDIA data sheet): the larger of 2 M N K operations
// (4 M N K for the pair) over 989 TFLOP/s bf16, and the bytes — fp32
// operands at 4 bytes an element, stored MX operands at 1 + 2/16, the
// fp32 output once — over 3.35 TB/s. Every GEMM of ResNet18 at batch 32
// is bytes-bound: the fused forward does 15-178 operations a byte against
// the ~295 at which bf16 tensor cores become the limit. Bytes bounds of
// the fused (prequant) forward, us: the stem (401408, 64, 147) 101.1
// (101.1); layer1 (100352, 64, 576) 76.7 (76.7) x4; layer2 (25088, 128,
// K) 21.2 (21.1) at K 576, 38.5 (38.4) x3 at 1152, 5.8 (5.8) at 64;
// layer3 (6272, 256, K) 10.9 (10.6) at 1152, 19.9 (19.4) x3 at 2304, 2.9
// (2.9) at 128; layer4 (1568, 512, K) 6.7 (5.7) at 2304, 12.4 (10.4) x3
// at 4608, 1.6 (1.5) at 256; the head (32, 1000, 512) 0.7 (0.2). A pass:
// 670 (660) us. The pair (g, x and w read, dX and dW written) bounds at
// 171.6 us at the stem, 1245.4 us a pass; staging its operands as bf16
// (below) adds their bytes written and read once: 305.8 us and 2012.9 us
// (chip_smoke.pair_staged_floor_ms).
//
// Design. A dequantized MX value is an integer of at most 7 bits times a
// power of two, exact in bf16 down to bf16's smallest subnormal step
// 2^-133 (the smallest MX scale), so the products run on the tensor
// cores: wgmma.mma_async m64n(BN/2)k16, bf16 operands, fp32 accumulators.
// One k16 step is one MX block. A CTA of four warpgroups (512 threads) in a
// 2 x 2 grid computes a 128 x BN tile of C, each warpgroup 64 rows x BN / 2
// columns; BN is a pure function of N (mx_matmul.py::tile_n: 64 for
// N <= 64, else 128), so the stem and layer1 (N = 64) fill their tiles.
// One CTA an SM (the ring fills shared memory), persistent: it walks the
// (chunk, tile) units cta, cta + grid, ... and its ring runs on across
// units. The k-loop runs in slabs of BK = 64 (four MX blocks):
//   copies — the raw operand slabs (fp32 values, or int8 mantissas and
//       exponent / bit planes) go into a ring of 2-4 stages (as many as
//       227 KB hold), issued kStages - 1 slabs ahead of the slab being
//       converted. Where an fp32 operand's rows are contiguous and 16-byte
//       aligned (every operand of the forward GEMMs but the stem's lhs),
//       thread 0 issues 2-D TMA boxes of 32 values by the slab's rows,
//       128-byte swizzled, zero-filled past the edges, and the stage's
//       mbarrier counts their bytes. Otherwise every thread issues
//       cp.async copies that write the same layout, out of line of the
//       slab loop: 4 bytes an fp32 value, neighbouring threads on the
//       stride-1 axis (the pair's x^T at K = 147); MX operands 16 bytes
//       where aligned, else whole aligned words read at their byte offset
//       (MX planes, N not a multiple of 16). TMA needs a 16-byte aligned
//       box start, which the stem's 588-byte rows cannot give (see the
//       panel path below).
//   converters — all 512 threads take (row, 16-block) units of the lhs and
//       (column, 16-block) units of the rhs and quantize and dequantize
//       each with mx_common.cuh's quantize_block_f / dequantize_block_f
//       (the cores of quantize_block / dequantize_block: bit for bit what
//       mx_quantize_kernel stores and mx_dequantize_kernel returns; MX
//       operands are only dequantized), writing 16 bf16 values (the high
//       halves of the fp32 patterns, exact) into the K-major core-matrix
//       layout wgmma reads (8 x 16-byte rows a core matrix, no swizzle) —
//       for the rhs too: a converter reads an N-contiguous rhs down a
//       column and transposes it in registers. No MX tensor of a fused or
//       prequant operand reaches device memory.
//   MMA — two bf16 buffers: slab i converts into buffer i % 2, then (after
//       a proxy fence and a barrier) the warpgroups wait on the wgmmas of
//       slab i - 1, promote them, and issue slab i's, which run while slab
//       i + 1 converts.
//   resident rhs — a rhs under a single 64-wide tile column with no split
//       and Kp <= 768 (layer1) is converted once per CTA into a resident
//       bf16 buffer, and the ring carries the lhs alone.
//   panel path (panel_kernel) — an fp32 lhs of contiguous rows that are
//       not 16-byte aligned (the stem's K = 147) over a short contraction,
//       N <= 64, no split: a tile's whole lhs panel (128 rows, one span of
//       512 K bytes on a 16-byte boundary) comes by one cp.async.bulk
//       while the tile before converts, and the rhs stays resident.
//   the backward pair (pair_stage_kernel, pair_kernel) — converts each
//       operand value once for each axis it is quantized along (in-tile
//       conversion repeated the cotangent's and the weight's up to 36
//       times), into bf16 operands written once, then runs two pure bf16
//       GEMMs on them: a producer warp keeps TMA boxes in flight in a ring
//       of 4-7 stages, two consumer warpgroups issue wgmma and nothing
//       else (see "The backward pair, staged" below).
// Rows past M and columns past N are not stored.
//
// Accumulation and order. Each slab's wgmmas start from zero (scale-d =
// 0 on the first) and the slab's sum is added to a second fp32 register
// accumulator with an ordinary FADD (round to nearest) once the wgmmas
// are waited on: the tensor cores align and truncate inside an
// instruction, an error biased toward zero that over a whole contraction
// would grow faster than sqrt(K); over four MX blocks it does not. Long
// contractions are split in a fixed order (mx_matmul.py::gemm_split_plan,
// a pure function of (M, N, Kp)): S chunks whose boundaries fall on
// multiples of 16, each summed in slabs of 64 from its start (the last
// slab may be shorter), into ws[s]; split_reduce_kernel adds the S
// partials in the order s = 0, 1, ..., S-1. No atomics: a result repeats
// bit for bit from run to run. An output element's bits depend on its
// operands' bf16 values, the chunking and the slab order, never on the
// tile, the path or on which kernel loaded the values, and all four
// kernels feed the same wgmma sequence the same values (the pair's staged
// GEMMs with their operands K-major or MN-major, which the tensor cores
// read alike). (One exception,
// without effect: quantize_block_f gives -0 for a zero mantissa of a
// negative input, a stored MX mantissa +0. A zero product never changes a
// sum with a nonzero term, and the promotion, which starts from +0,
// turns a sum of zeros into +0.) So the JAX package's contracts hold
// bitwise on the card:
//   fused(a, b) == mx(quantize(a), quantize_rhs(b)) == prequant(a,
//   quantize_rhs(b)), and bwd_pair(g, x, w) == (fused(g, w^T),
//   fused(x^T, g)) — the pair's dW and fused(x^T, g) see the same
//   (K, N, Mp), so the same chunks.
// A product of two dequantized MX values is exact in fp32 outside the
// subnormal range, so the kernels differ from the plain version's fp32
// matmul only by the order and rounding of the sums, within the limits
// 2·Kp·2⁻²⁴·(|A_q| @ |B_q|) and 4·sqrt(Kp)·2⁻²⁴·sqrt(A_q² @ B_q²) of
// ref.py::gemm_error_limits (chip_smoke.py phase 6 shows the readings).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mx_common.cuh"

namespace {

constexpr int kBM = 128;  // rows of a tile: two warpgroup rows of 64
constexpr int kBK = 64;   // a slab: four MX blocks, four k16 wgmmas
constexpr int kKB = kBK / mx::kBlock;
constexpr int kThreads = 512;  // four warpgroups, 2 x 2 over the tile
constexpr int kSmemMax = 232448;  // dynamic shared memory a block can use

// Streaming multiprocessors of the current card (host).
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `size` (4 or 16) bytes, of which the first `src_bytes` are
// read and the rest zero-filled.
template <int kSize>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (kSize == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Orders this thread's generic shared-memory accesses before the async
// proxy's: the converters' writes before the wgmmas read them, the
// converters' reads before a TMA copy overwrites the stage.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads across a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A 2-D TMA copy of the box at (c0 inner, c1 outer) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16, 16-byte aligned ends) into
// shared memory, completing `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, K-major without swizzle: core matrices
// of 8 rows x 16 bytes (128 contiguous bytes); `lbo` bytes between the two
// core matrices of a k16 step, `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma shared-memory descriptor of a tile that TMA wrote with the 128-byte
// swizzle (1024-byte aligned atoms of 8 rows x 128 bytes). K-major (rows
// the M or N index, 64 bf16 of the contraction a row): 8-row groups
// `sbo` = 1024 bytes apart, k16 step kk 32 kk bytes in. MN-major (rows the
// contraction, 64 M or N indices a row): 8-row groups `sbo` = 1024 bytes
// apart along the contraction, 64-wide atoms `lbo` bytes apart along M or
// N, k16 step kk 2048 kk bytes in.
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo = 16) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma with bf16 operands from shared memory: both K-major (kT = 0; the
// forward GEMMs' ring, the pair's dX) or both MN-major (kT = 1, read
// transposed: the pair's dW).
template <int kT>
__device__ __forceinline__ void wgmma_m64n64t(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kT));
}

template <int kT>
__device__ __forceinline__ void wgmma_m64n128t(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kT));
}

template <int kT>
__device__ __forceinline__ void wgmma_m64n152t(float (&d)[76], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %78, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75"
      "}, %76, %77, p, 1, 1, %79, %79;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kT));
}

// 16 dequantized values of unit (x, kb) as bf16 into the K-major
// core-matrix layout of an X-row operand: k16 step kb, 8-row group x / 8,
// its two core matrices (k 0-7, k 8-15) 128 bytes apart. A dequantized MX
// value has at most 7 significant bits and is a multiple of 2^-133, so
// the low 16 bits of its fp32 pattern are zero and the high 16 are its
// bf16 pattern, exactly (one byte permute a pair, no conversion).
template <int X>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* buf, int x, int kb,
                                           const float (&v)[mx::kBlock]) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = __byte_perm(__float_as_uint(v[2 * i]),
                       __float_as_uint(v[2 * i + 1]), 0x7632);
  }
  char* p = reinterpret_cast<char*>(buf) + (kb * (X / 8) + x / 8) * 256 +
            (x % 8) * 16;
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(p + 128) = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ int clamp_bytes(long long n, int most) {
  return (int)max(0LL, min((long long)most, n));
}

// An fp32 operand of X rows (M for the lhs, N for the rhs) quantized
// along the contraction: element (x, k) at p[x * sx + k * sk], valid for
// x < ext_x and k < ext_k (zero beyond). A slab (X x kBK) keeps its
// stride-1 axis inner — [x][k] when inner_k, else [k][x] — cut into
// regions of 32 inner values (128 bytes a row), each row's 16-byte chunks
// XOR-ed with row % 8: TMA's 128-byte swizzle, which the cp.async paths
// write too, so that the converters read without bank conflicts.
template <int X>
struct F32Op {
  static constexpr int kStageBytes = X * kBK * 4;
  CUtensorMap tmap;  // inner x outer, box 32 x rows; valid where tma
  const float* p;
  long long sx, sk;
  int ext_x, ext_k, mb;
  int inner_k;  // the slab is [x][k] (else [k][x])
  int tma;      // the slab comes by TMA (thread 0 issues it)

  // Bytes the slab's TMA copies bring (the whole box, zero-filled past the
  // edge), 0 where the slab comes by cp.async.
  __device__ __forceinline__ uint32_t tma_bytes() const {
    return tma ? (uint32_t)kStageBytes : 0u;
  }

  // Float offset of element (o, i) — outer row o, inner index i — in a
  // slab of `rows` outer rows.
  __device__ __forceinline__ static int at(int rows, int o, int i) {
    return (i >> 5) * rows * 32 + o * 32 + ((((i >> 2) & 7) ^ (o & 7)) << 2) +
           (i & 3);
  }

  // Thread 0 issues the slab's TMA boxes.
  template <bool kInnerK>
  __device__ __forceinline__ void load_tma(float* raw, int x0, int k0,
                                           uint64_t* bar) const {
    constexpr int W = kInnerK ? kBK : X;  // inner extent
    constexpr int R = kInnerK ? X : kBK;  // outer rows
#pragma unroll
    for (int h = 0; h < W / 32; ++h) {
      tma_load_2d(raw + h * R * 32, &tmap, (kInnerK ? k0 : x0) + 32 * h,
                  kInnerK ? x0 : k0, bar);
    }
  }

  // Every thread issues its cp.async copies of the slab. Out of line: a
  // fallback, kept out of the slab loop's code.
  template <bool kInnerK>
  __device__ __noinline__ void load_cp_async(float* raw, int x0,
                                             int k0) const {
    constexpr int W = kInnerK ? kBK : X;  // inner extent
    constexpr int R = kInnerK ? X : kBK;  // outer rows
#pragma unroll 4
    for (int j = 0; j < R * W / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int o = e / W, i = e % W;
      const int x = kInnerK ? o : i, k = kInnerK ? i : o;
      const int gx = x0 + x, gk = k0 + k;
      const bool ok = gx < ext_x && gk < ext_k;
      cp_async<4>(raw + at(R, o, i), ok ? p + gx * sx + gk * sk : p,
                  ok ? 4 : 0);
    }
  }

  __device__ __forceinline__ void load(void* raw_v, int x0, int k0,
                                       uint64_t* bar) const {
    float* raw = static_cast<float*>(raw_v);
    if (tma) {
      if (threadIdx.x != 0) return;
      if (inner_k) {
        load_tma<true>(raw, x0, k0, bar);
      } else {
        load_tma<false>(raw, x0, k0, bar);
      }
    } else if (inner_k) {
      load_cp_async<true>(raw, x0, k0);
    } else {
      load_cp_async<false>(raw, x0, k0);
    }
  }

  // Unit u = (x = u % X, kb = u / X): quantize-dequantize one 16-block.
  __device__ __forceinline__ void convert(const void* raw_v, int, int, int u,
                                          __nv_bfloat16* buf) const {
    const float* raw = static_cast<const float*>(raw_v);
    const int x = u % X, kb = u / X;
    uint32_t bits[mx::kBlock];
    if (inner_k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(
            raw + at(X, x, mx::kBlock * kb + 4 * q));
        bits[4 * q] = __float_as_uint(f.x);
        bits[4 * q + 1] = __float_as_uint(f.y);
        bits[4 * q + 2] = __float_as_uint(f.z);
        bits[4 * q + 3] = __float_as_uint(f.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < mx::kBlock; ++j) {
        bits[j] = __float_as_uint(raw[at(kBK, mx::kBlock * kb + j, x)]);
      }
    }
    float q[mx::kBlock], v[mx::kBlock];
    int e;
    uint32_t packed;
    mx::quantize_block_f(bits, mb, q, e, packed);
    mx::dequantize_block_f(q, e, packed, mb, v);
    store_bf16<X>(buf, x, kb, v);
  }
};

// ROWS rows of WIDTH bytes, row r at g0 + r * gpitch, into shared memory
// (row pitch spitch >= WIDTH + 16); rows >= rows_valid and bytes past
// width_valid zero-filled. 16-byte copies when g0 and gpitch are 16-byte
// aligned; else whole aligned words from the word holding row r's first
// byte, which then sits at byte_shift(g0, gpitch, r) of its shared row.
__device__ __forceinline__ bool aligned16(const void* g0, long long gpitch) {
  return (((uintptr_t)g0 | (uintptr_t)gpitch) & 15) == 0;
}

__device__ __forceinline__ int byte_shift(const void* g0, long long gpitch,
                                          int r) {
  return aligned16(g0, gpitch) ? 0
                               : (int)(((uintptr_t)g0 + r * gpitch) & 3);
}

template <int ROWS, int WIDTH>
__device__ __forceinline__ void copy_bytes(uint8_t* s, int spitch,
                                           const int8_t* g0, long long gpitch,
                                           int rows_valid, int width_valid) {
  if (aligned16(g0, gpitch)) {
    constexpr int kC = (WIDTH + 15) / 16;
    for (int i = threadIdx.x; i < ROWS * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      const int n = r < rows_valid ? clamp_bytes(width_valid - 16LL * c, 16)
                                   : 0;
      cp_async<16>(s + r * spitch + 16 * c, n ? g0 + r * gpitch + 16 * c : g0,
                   n);
    }
  } else {
    constexpr int kC = WIDTH / 4 + 1;
    const int8_t* any = reinterpret_cast<const int8_t*>((uintptr_t)g0 & ~3ull);
    for (int i = threadIdx.x; i < ROWS * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      const int8_t* g = g0 + r * gpitch;
      const int8_t* w0 = reinterpret_cast<const int8_t*>((uintptr_t)g & ~3ull);
      const int n = r < rows_valid
                        ? clamp_bytes((g - w0) + width_valid - 4LL * c, 4)
                        : 0;
      cp_async<4>(s + r * spitch + 4 * c, n ? w0 + 4 * c : any, n);
    }
  }
}

// A stored MX operand of X rows, only dequantized. kInnerK (the lhs,
// K-last): mantissa (x, k) at mant[x * pitch_m + k], planes (x, kb) at
// [x * pitch_p + kb]. Else (the rhs, K-first): mantissa at
// mant[k * pitch_m + x], planes at [kb * pitch_p + x]. Valid for x < ext_x
// and k < ext_kp (Kp). A slab keeps the global layout, rows padded.
template <int X, bool kInnerK>
struct MXOp {
  static constexpr int kMP = kInnerK ? kBK + 16 : X + 16;  // mantissa pitch
  static constexpr int kPP = kInnerK ? 16 : X + 16;        // plane pitch
  static constexpr int kMRows = kInnerK ? X : kBK;
  static constexpr int kPRows = kInnerK ? X : kKB;
  static constexpr int kStageBytes = (kMRows * kMP) + 2 * (kPRows * kPP);
  const int8_t* mant;
  const int8_t* expo;
  const uint8_t* bits;
  long long pitch_m, pitch_p;
  int ext_x, ext_kp, mb;

  // Slab bases: the mantissa and the two planes at (x0, k0).
  __device__ __forceinline__ const int8_t* mant0(int x0, int k0) const {
    return kInnerK ? mant + x0 * pitch_m + k0 : mant + k0 * pitch_m + x0;
  }
  __device__ __forceinline__ long long plane_off(int x0, int k0) const {
    const int kb0 = k0 / mx::kBlock;
    return kInnerK ? x0 * pitch_p + kb0 : kb0 * pitch_p + x0;
  }

  __device__ __forceinline__ uint32_t tma_bytes() const { return 0u; }

  __device__ __noinline__ void load(void* raw_v, int x0, int k0,
                                    uint64_t*) const {
    uint8_t* raw = static_cast<uint8_t*>(raw_v);
    uint8_t* pe = raw + kMRows * kMP;
    uint8_t* pb = pe + kPRows * kPP;
    const long long po = plane_off(x0, k0);
    const int8_t* bits8 = reinterpret_cast<const int8_t*>(bits);
    if constexpr (kInnerK) {
      const int rows = ext_x - x0, kw = min(kBK, ext_kp - k0);
      copy_bytes<X, kBK>(raw, kMP, mant0(x0, k0), pitch_m, rows, kw);
      copy_bytes<X, kKB>(pe, kPP, expo + po, pitch_p, rows, kw / 16);
      copy_bytes<X, kKB>(pb, kPP, bits8 + po, pitch_p, rows, kw / 16);
    } else {
      const int cols = ext_x - x0, kr = ext_kp - k0;
      copy_bytes<kBK, X>(raw, kMP, mant0(x0, k0), pitch_m, kr, cols);
      copy_bytes<kKB, X>(pe, kPP, expo + po, pitch_p, kr / 16, cols);
      copy_bytes<kKB, X>(pb, kPP, bits8 + po, pitch_p, kr / 16, cols);
    }
  }

  // Unit u = (x = u % X, kb = u / X) of the slab at (x0, k0).
  __device__ __forceinline__ void convert(const void* raw_v, int x0, int k0,
                                          int u, __nv_bfloat16* buf) const {
    const uint8_t* raw = static_cast<const uint8_t*>(raw_v);
    const uint8_t* pe = raw + kMRows * kMP;
    const uint8_t* pb = pe + kPRows * kPP;
    const int x = u % X, kb = u / X;
    const int8_t* m0 = mant0(x0, k0);
    const long long po = plane_off(x0, k0);
    float q[mx::kBlock];
    int e;
    uint32_t packed;
    if constexpr (kInnerK) {
      const uint8_t* row = raw + x * kMP + byte_shift(m0, pitch_m, x) +
                           mx::kBlock * kb;
      if (aligned16(m0, pitch_m)) {
        const uint4 w = *reinterpret_cast<const uint4*>(row);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < mx::kBlock; ++i) {
          q[i] = mx::mantissa_float(
              (int8_t)((words[i / 4] >> (8 * (i % 4))) & 0xFFu));
        }
      } else {
#pragma unroll
        for (int i = 0; i < mx::kBlock; ++i) {
          q[i] = mx::mantissa_float((int8_t)row[i]);
        }
      }
      const int se = x * kPP + byte_shift(expo + po, pitch_p, x) + kb;
      const int sb = x * kPP +
                     byte_shift(bits + po, pitch_p, x) + kb;
      e = (int8_t)pe[se];
      packed = pb[sb];
    } else {
#pragma unroll
      for (int i = 0; i < mx::kBlock; ++i) {
        const int r = mx::kBlock * kb + i;
        q[i] = mx::mantissa_float(
            (int8_t)raw[r * kMP + byte_shift(m0, pitch_m, r) + x]);
      }
      e = (int8_t)pe[kb * kPP + byte_shift(expo + po, pitch_p, kb) + x];
      packed = pb[kb * kPP + byte_shift(bits + po, pitch_p, kb) + x];
    }
    float v[mx::kBlock];
    mx::dequantize_block_f(q, e, packed, mb, v);
    store_bf16<X>(buf, x, kb, v);
  }
};

// A warpgroup's share of a 128 x BN tile: 64 rows x BN / 2 columns.
template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 4], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_m64n32(d, da, db, scale_d);
  } else {
    wgmma_m64n64t<0>(d, da, db, scale_d);
  }
}

// One GEMM: C [M, N] (row-major, ld N) = A [M, Kp] @ B [Kp, N], the
// contraction split into `split` chunks of `chunk` (a multiple of 16; the
// last may be shorter). With split = 1 the tiles write C; otherwise chunk
// s writes its partial to ws[s] [M, N] and split_reduce_kernel sums them.
// A unit is (chunk s, tile): unit = s * tiles + tile, tiles row-major
// over (tile_m, tile_n), so the tiles of one chunk are neighbours.
template <int BN, class A, class B>
struct Gemm {
  A a;
  B b;
  float* c;
  float* ws;
  int M, N, kp;
  int split, chunk;
  int tiles_n, tiles, units;
};

// Shared memory of one instantiation, from a 1024-byte aligned base (TMA's
// 128-byte swizzle): kStages raw slabs, each 1024-byte aligned; two bf16
// buffers (slab i converts into buffer i % 2 while the wgmmas of slab i - 1
// read the other), each the lhs [kKB][kBM / 8][2][8 x 16 bytes] and the rhs
// [kKB][BN / 8][2][...]; one mbarrier a stage (the TMA bytes of its slab).
// kResB: the rhs is converted once, whole, into a resident bf16 buffer of
// kResKp rows (a 64-wide rhs under a single tile column, no split: layer1),
// and the ring and the two buffers carry the lhs alone.
constexpr int kResKp = 768;

template <int BN, class A, class B, bool kResB = false>
struct Layout {
  static constexpr int kStage =
      (A::kStageBytes + (kResB ? 0 : B::kStageBytes) + 1023) / 1024 * 1024;
  static constexpr int kBf16 = (kBM + (kResB ? 0 : BN)) * kBK * 2;  // one
  static constexpr int kRes = kResB ? kResKp * BN * 2 : 0;
  static_assert(B::kStageBytes <= kStage, "the rhs is staged in stage 0");
  static constexpr int kFixed = 2 * kBf16 + kRes + 8 * 8 + 1024;
  static constexpr int kFit = (kSmemMax - kFixed) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBytes = kStages * kStage + kFixed;
  static_assert(kStages >= 2, "a slab in flight while one converts");
};

// A warpgroup's accumulators (rows 64 wm + ..., columns wn BN / 2 + ...;
// wgmma's fragment layout) into out [M, N] at the tile (m0, n0).
template <int BN>
__device__ __forceinline__ void store_tile(const float (&total)[BN / 4],
                                           float* out, int M, int N, int m0,
                                           int n0) {
  const int wm = threadIdx.x / 128 % 2, wn = threadIdx.x / 256;
  const int lane = threadIdx.x % 32, w4 = (threadIdx.x % 128) / 32;
  const int row0 = m0 + 64 * wm + 16 * w4 + lane / 4;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const int col = n0 + wn * (BN / 2) + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      float* p = out + (long long)row * N + col;
      const float v0 = total[4 * j + 2 * h], v1 = total[4 * j + 2 * h + 1];
      if (pairs && col + 1 < N) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        if (col < N) p[0] = v0;
        if (col + 1 < N) p[1] = v1;
      }
    }
  }
}

// Where the ring stands: a unit (its tile at rows m0, columns n0) and the
// slab [k0, k0 + kBK) of its contraction [lo, hi).
struct Cursor {
  int unit, k0, hi, m0, n0;
};

// The units first, first + stride, ... of one GEMM on one CTA.
template <bool kResB, int BN, class A, class B>
__device__ __forceinline__ void run(const Gemm<BN, A, B>& g, int first,
                                    int stride, uint8_t* smem_raw) {
  using L = Layout<BN, A, B, kResB>;
  constexpr int S = L::kStages;
  constexpr int kAcc = BN / 4;
  // (row or column, block) units of a slab
  constexpr int kUnits = (kBM + (kResB ? 0 : BN)) * kKB;
  // Offset, not a cast through an integer: the compiler keeps the
  // pointer in the shared window (LDS / STS, not generic loads).
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* abuf =
      reinterpret_cast<__nv_bfloat16*>(smem + S * L::kStage);
  __nv_bfloat16* bres = abuf + L::kBf16;  // kResB: the resident rhs
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S * L::kStage +
                                               2 * L::kBf16 + L::kRes);
  const int wm = threadIdx.x / 128 % 2, wn = threadIdx.x / 256;
  if (threadIdx.x == 0) {
    for (int s = 0; s <= S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (kResB) {
    // The whole rhs (tile column 0, no split), slab by slab through stage
    // 0, converted once into bres; bars[S] counts its TMA bytes.
    for (int k0 = 0, r = 0; k0 < g.kp; k0 += kBK, ++r) {
      if (threadIdx.x == 0) {
        fence_proxy_async();
        mbar_expect_tx(&bars[S], g.b.tma_bytes());
      }
      g.b.load(smem, 0, k0, &bars[S]);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(&bars[S], r & 1);
      __syncthreads();
      for (int u = threadIdx.x; u < BN * kKB; u += kThreads) {
        if (k0 + mx::kBlock * (u / BN) < g.kp) {
          g.b.convert(smem, 0, k0, u,
                      bres + (k0 / mx::kBlock) * (BN / 8) * 128);
        }
      }
      __syncthreads();
    }
  }

  auto begin = [&](Cursor& cur, int unit) {
    cur.unit = unit;
    const int s = unit / g.tiles, tile = unit - s * g.tiles;
    const int tm = tile / g.tiles_n;
    cur.k0 = s * g.chunk;
    cur.hi = min(g.kp, cur.k0 + g.chunk);
    cur.m0 = tm * kBM;
    cur.n0 = (tile - tm * g.tiles_n) * BN;
  };
  auto next = [&](Cursor& cur) {
    cur.k0 += kBK;
    if (cur.k0 >= cur.hi) begin(cur, cur.unit + stride);
  };
  auto issue = [&](const Cursor& cur, int stage) {
    uint8_t* st = smem + stage * L::kStage;
    if (threadIdx.x == 0) {  // one arrival a phase, with the TMA bytes
      fence_proxy_async();
      mbar_expect_tx(&bars[stage],
                     g.a.tma_bytes() + (kResB ? 0u : g.b.tma_bytes()));
    }
    g.a.load(st, cur.m0, cur.k0, &bars[stage]);
    if (!kResB) g.b.load(st + A::kStageBytes, cur.n0, cur.k0, &bars[stage]);
  };

  Cursor prod, cons;
  begin(prod, first);
  begin(cons, first);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (prod.unit < g.units) {
      issue(prod, s);
      next(prod);
    }
    cp_async_commit();
  }
  float acc[kAcc], total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = total[i] = 0.0f;
  int ps = S - 1, cs = 0;
  uint32_t phase = 0;  // parity of stage cs's barrier in this round
  Cursor pend = cons;  // the slab whose wgmmas are in flight
  bool pend_last = false;

  // Wait on the wgmmas of the slab before (none at the start: acc = 0),
  // promote, and store its tile if it was the unit's last slab.
  auto settle = [&]() {
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) total[i] += acc[i];
    if (pend_last) {
      float* out = g.split > 1
                       ? g.ws + (long long)(pend.unit / g.tiles) * g.M * g.N
                       : g.c;
      store_tile<BN>(total, out, g.M, g.N, pend.m0, pend.n0);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) total[i] = 0.0f;
    }
  };

  for (int slab = 0; cons.unit < g.units; ++slab) {
    if (prod.unit < g.units) {
      issue(prod, ps);
      next(prod);
    }
    cp_async_commit();
    ps = ps + 1 == S ? 0 : ps + 1;
    cp_async_wait<S - 1>();
    mbar_wait(&bars[cs], phase);
    __syncthreads();  // slab cs has landed
    const uint8_t* st = smem + cs * L::kStage;
    __nv_bfloat16* a16 = abuf + (slab & 1) * (L::kBf16 / 2);
    __nv_bfloat16* b16 = a16 + kBM * kBK;
#pragma unroll 1
    for (int j = 0; j < (kUnits + kThreads - 1) / kThreads; ++j) {
      const int u = threadIdx.x + j * kThreads;
      if (u < kBM * kKB) {
        g.a.convert(st, cons.m0, cons.k0, u, a16);
      } else if (u < kUnits) {
        g.b.convert(st + A::kStageBytes, cons.n0, cons.k0, u - kBM * kKB,
                    b16);
      }
    }
    fence_proxy_async();
    __syncthreads();  // slab cs converted; its stage is free for a copy
    settle();  // the slab before, whose wgmmas ran while this one converted
    const int nk = min(kKB, (cons.hi - cons.k0) / mx::kBlock);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) {
      if (kk < nk) {
        const __nv_bfloat16* bk =
            kResB ? bres + (cons.k0 / mx::kBlock + kk) * (BN / 8) * 128
                  : b16 + kk * (BN / 8) * 128;
        wgmma_tile<BN>(
            acc, desc(a16 + (kk * (kBM / 8) + 8 * wm) * 128, 128, 256),
            desc(bk + wn * (BN / 16) * 128, 128, 256), kk > 0);
      }
    }
    wgmma_commit();
    pend = cons;
    pend_last = cons.k0 + kBK >= cons.hi;
    next(cons);
    if (++cs == S) {
      cs = 0;
      phase ^= 1;
    }
  }
  settle();
  cp_async_wait<0>();
}

template <bool kResB, int BN, class A, class B>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ Gemm<BN, A, B> g) {
  extern __shared__ __align__(128) uint8_t smem[];
  run<kResB>(g, blockIdx.x, gridDim.x, smem);
}

// The backward pair, staged (mx_pair_stage, then mx_gemm_bwd_pair). Each
// operand value is converted once for each axis it is quantized along, by
// pair_stage_kernel, into bf16 operands that keep their source's row
// layout, so no conversion writes across rows:
//   gn [M][Np] = q_N(g) and wn [K][Np] = q_N(w) — dX's lhs and rhs,
//       K-major (the contraction N along a row, zero-padded to Np);
//   xt [Mp][Kq] = q_M(x) and gt [Mp][Nq] = q_M(g) — dW's lhs and rhs,
//       MN-major (the contraction M down the rows, zero rows from M to Mp;
//       Kq, Nq: K, N rounded up to 8, 16-byte rows).
// Then pair_kernel runs two pure bf16 GEMMs with no conversion in their
// mainloop (run_staged): dX = gn · wn^T with both operands K-major, dW =
// xt^T · gt with both MN-major (wgmma reads them transposed). The bf16
// values are those the fused kernel's converters write, so the pair stays
// bit for bit fused(g, w^T) and fused(x^T, g).

// One source of the stage: src [R, C] fp32, row-major. dst_c [R][cp] takes
// the 16-blocks along C (each row's; cp = C rounded up to 16, zero-filled),
// dst_r [rp][cq] those along R (each column's, in place: rp = R rounded
// up to 16, zero rows past R; cq >= C the row pitch); either may be null.
// A CTA takes a tile of 8192 values, tr = 8192 / tc rows by tc columns (tc
// the power of two from 16 to 256 that covers C, or 256): it reads the
// tile into shared memory (a warp on up to 512 contiguous bytes of a row),
// then converts it along each axis it needs from there — along C, 512
// (row, block) units, two a thread, a warp on 32 rows of one block (row
// pitch tc + 4 floats: conflict-free 16-byte reads); along R, 256 (column
// pair, row block) units, one a thread, a warp on neighbouring columns,
// writing a 4-byte word of each row (a warp's store is one contiguous span
// of a row).
struct StageJob {
  const float* src;
  __nv_bfloat16* dst_c;
  __nv_bfloat16* dst_r;
  int R, C, cp, rp, cq;
  int lt;  // log2 of the tile's columns tc
  int tiles_c, blocks;
};

struct Stage {
  StageJob job[3];  // g (both axes), w (along N), x (along M)
  int mb;
};

constexpr int kStageThreads = 256;
constexpr int kStageTile = 8192;  // values of a stage tile
constexpr int kStageTCMax = 256;  // its widest rows

// Quantize-dequantize one 16-block given as raw fp32 bits: its 16 bf16
// values (the high halves of the fp32 patterns, exact) packed two a word —
// the arithmetic of F32Op::convert and store_bf16.
__device__ __forceinline__ void stage_block(const uint32_t (&bits)[mx::kBlock],
                                            int mb, uint32_t (&w)[8]) {
  float q[mx::kBlock], v[mx::kBlock];
  int e;
  uint32_t packed;
  mx::quantize_block_f(bits, mb, q, e, packed);
  mx::dequantize_block_f(q, e, packed, mb, v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = __byte_perm(__float_as_uint(v[2 * i]),
                       __float_as_uint(v[2 * i + 1]), 0x7632);
  }
}

// How a stage tile is read: 16-byte loads of each row where rows are
// 16-byte aligned (kRows); where the tile spans whole rows (C <= tc) that
// are not, 16-byte loads of the tile's one contiguous span, each value put
// at (f / C, f % C) of the tile (kSpan: the stem's x, 588-byte rows); else
// 4-byte loads (kWords). Each is compiled apart (in one body the compiler
// issued the row path's loads one at a time: 0.29 against 0.19 ms at
// layer1 on an H100) and runs three CTAs an SM.
enum StageLoad { kRows, kSpan, kWords };

StageLoad stage_load(const float* src, int C, int tc) {
  if ((C & 3) == 0 && ((uintptr_t)src & 15) == 0) return kRows;
  // a span starts at row r0 * C, r0 a multiple of tr >= 32
  if (C <= tc && C >= 4 && ((uintptr_t)src & 15) == 0) return kSpan;
  return kWords;
}

template <int kLoad>
__global__ void __launch_bounds__(kStageThreads, 3)
    pair_stage_kernel(const __grid_constant__ Stage st) {
  // tr rows of tc + 4 floats: at most 512 x 20 (tc = 16)
  __shared__ __align__(16) float tile[kStageTile + 4 * kStageTile / 16];
  int b = blockIdx.x, j = 0;
  while (j < 2 && b >= st.job[j].blocks) b -= st.job[j++].blocks;
  const StageJob& jb = st.job[j];
  const int lt = jb.lt, tc = 1 << lt, tr = kStageTile >> lt;
  const int pitch = tc + 4;
  const int ti_r = b / jb.tiles_c;
  const int r0 = ti_r * tr, c0 = (b - ti_r * jb.tiles_c) * tc;
  const int t = threadIdx.x;
  constexpr int kV = kStageTile / 4 / kStageThreads;  // float4 a thread
  // The tile, zero past R and C.
  // Every load of a thread is issued before the first store to shared
  // memory (the compiler does not hoist them past the stores itself).
  if constexpr (kLoad == kRows) {
    float4 f[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int q = t + kStageThreads * i;
      const int r = q >> (lt - 2), c = (q & (tc / 4 - 1)) << 2;
      const bool ok = r0 + r < jb.R && c0 + c < jb.C;
      f[i] = ok ? __ldg(reinterpret_cast<const float4*>(
                      jb.src + (long long)(r0 + r) * jb.C + c0 + c))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int q = t + kStageThreads * i;
      const int r = q >> (lt - 2), c = (q & (tc / 4 - 1)) << 2;
      *reinterpret_cast<float4*>(tile + r * pitch + c) = f[i];
    }
  } else if constexpr (kLoad == kSpan) {
    const float* span = jb.src + (long long)r0 * jb.C;
    const int count = min(tr, jb.R - r0) * jb.C;
    float4 f[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int e = 4 * (t + kStageThreads * i);
      f[i] = e + 4 <= count
                 ? __ldg(reinterpret_cast<const float4*>(span + e))
                 : make_float4(e < count ? __ldg(span + e) : 0.f,
                               e + 1 < count ? __ldg(span + e + 1) : 0.f,
                               e + 2 < count ? __ldg(span + e + 2) : 0.f,
                               0.f);
    }
    for (int i = t; i < kStageTile / 4; i += kStageThreads) {
      *reinterpret_cast<float4*>(tile + 4 * i + (4 * i / tc) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // the tile is zero before the span lands in it
    // element e = 4 t + 1024 i of the span: row r, column c, walked
    int r = 4 * t / jb.C, c = 4 * t - r * jb.C;
    const int dr = 4 * kStageThreads / jb.C;
    const int dc = 4 * kStageThreads - dr * jb.C;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int e = 4 * (t + kStageThreads * i);
      const float v[4] = {f[i].x, f[i].y, f[i].z, f[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ck = c + k, wrap = ck >= jb.C;
        if (e + k < count) tile[(r + wrap) * pitch + ck - wrap * jb.C] = v[k];
      }
      r += dr;
      c += dc;
      if (c >= jb.C) {
        c -= jb.C;
        ++r;
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < kStageTile / kStageThreads; h += 8) {
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = t + kStageThreads * (h + i);
        const int r = q >> lt, c = q & (tc - 1);
        f[i] = r0 + r < jb.R && c0 + c < jb.C
                   ? __ldg(jb.src + (long long)(r0 + r) * jb.C + c0 + c)
                   : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = t + kStageThreads * (h + i);
        tile[(q >> lt) * pitch + (q & (tc - 1))] = f[i];
      }
    }
  }
  __syncthreads();
  uint32_t bits[mx::kBlock], w[8];
  if (jb.dst_c != nullptr) {
#pragma unroll
    for (int i = 0; i < kStageTile / mx::kBlock / kStageThreads; ++i) {
      const int v = t + kStageThreads * i;
      const int r = v & (tr - 1), c = mx::kBlock * (v >> (13 - lt));
      if (r0 + r < jb.R && c0 + c < jb.cp) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 f =
              *reinterpret_cast<const float4*>(tile + r * pitch + c + 4 * q);
          bits[4 * q] = __float_as_uint(f.x);
          bits[4 * q + 1] = __float_as_uint(f.y);
          bits[4 * q + 2] = __float_as_uint(f.z);
          bits[4 * q + 3] = __float_as_uint(f.w);
        }
        stage_block(bits, st.mb, w);
        uint4* p = reinterpret_cast<uint4*>(
            jb.dst_c + (long long)(r0 + r) * jb.cp + c0 + c);
        p[0] = make_uint4(w[0], w[1], w[2], w[3]);
        p[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
  }
  if (jb.dst_r != nullptr) {
    const int c = 2 * (t & (tc / 2 - 1)), rb = mx::kBlock * (t >> (lt - 1));
    if (c0 + c < jb.C && r0 + rb < jb.rp) {
      uint32_t hi[mx::kBlock], wh[8];
#pragma unroll
      for (int e = 0; e < mx::kBlock; ++e) {
        const float2 f =
            *reinterpret_cast<const float2*>(tile + (rb + e) * pitch + c);
        bits[e] = __float_as_uint(f.x);
        hi[e] = __float_as_uint(f.y);
      }
      stage_block(bits, st.mb, w);
      stage_block(hi, st.mb, wh);
      const int words = jb.cq / 2;  // a row of dst_r
      uint32_t* out = reinterpret_cast<uint32_t*>(
          jb.dst_r + (long long)(r0 + rb) * jb.cq + c0 + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // rows 2e and 2e + 1: the low and the high halves of w[e], wh[e]
        out[(2 * e) * words] = __byte_perm(w[e], wh[e], 0x5410);
        out[(2 * e + 1) * words] = __byte_perm(w[e], wh[e], 0x7632);
      }
    }
  }
}

// One staged GEMM: C [M, N] (row-major, ld N) = A · B over a contraction
// of kp (a multiple of 16), split as Gemm is and its units walked in the
// same order. K-major (kMN = 0): A [M][kp], B [N][kp], one TMA box of 64
// contraction values by 128 (A) or BN (B) rows a slab. MN-major (kMN =
// 1): A [kp][M], B [kp][N], boxes of 64 M or N values by 64 contraction
// rows, two for A's 128 rows and BN / 64 for B's columns. Every box is
// 128-byte swizzled and zero-filled past the edges.
template <int BN, int kMN>
struct Staged {
  CUtensorMap ta, tb;
  float* c;
  float* ws;
  int M, N, kp;
  int split, chunk;
  int tiles_n, tiles, units;
};

// Threads of pair_kernel: two consumer warpgroups, each 64 rows x BN of
// the 128 x BN tile, and one producer warp whose lane 0 issues the TMA
// copies.
constexpr int kConsumers = 256;
constexpr int kPairThreads = kConsumers + 32;

// Shared memory of a staged GEMM: kStages stages, each the A slab (128 x
// 64 bf16) and the B slab (BN x 64), 1024-byte aligned; each consumer
// warpgroup's output block [64][BN + 8] (fp32; the pad puts a half warp's
// fragment writes on 32 banks); a full and an empty mbarrier a stage.
template <int BN>
struct StagedLayout {
  static constexpr int kA = kBM * kBK * 2;
  static constexpr int kStage = kA + BN * kBK * 2;
  static constexpr int kPitch = BN + 8;  // floats a row of an output block
  static constexpr int kOut = 2 * 64 * kPitch * 4;
  static constexpr int kFit = (kSmemMax - 1024 - 256 - kOut) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kBytes = kStages * kStage + kOut + 16 * kStages + 1024;
  static_assert(kStage % 1024 == 0, "stages 1024-byte aligned");
  static_assert(kStages >= 2, "a slab in flight while one is multiplied");
};

template <int BN, int kT>
__device__ __forceinline__ void wgmma_staged(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_m64n64t<kT>(d, da, db, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_m64n128t<kT>(d, da, db, scale_d);
  } else {
    static_assert(BN == 152, "a staged tile is 64, 128 or 152 wide");
    wgmma_m64n152t<kT>(d, da, db, scale_d);
  }
}

// Barrier `id` (1 + a consumer warpgroup) over that warpgroup's 128
// threads.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A consumer warpgroup's accumulators for a 64 x BN block of C at rows
// r0 + ..., columns c0 + ... into out [M, N], through its output block in
// shared memory: fragment layout in (store_tile's), rows out, 16 bytes a
// thread where the rows are 16-byte aligned. Where the tile spans every
// column (N <= BN), its rows are one contiguous span, stored as such, 16
// bytes a thread, whatever the alignment of a row (the stem's dX: 588-byte
// rows).
template <int BN>
__device__ __forceinline__ void store_rows(const float (&total)[BN / 2],
                                           float* blk, float* out, int M,
                                           int N, int r0, int c0, int id) {
  constexpr int P = StagedLayout<BN>::kPitch;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row0 = 16 * (t / 32) + lane / 4;
  warpgroup_sync(id);  // the block's last rows are out
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(blk + (row0 + 8 * h) * P + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(total[4 * j + 2 * h], total[4 * j + 2 * h + 1]);
    }
  }
  warpgroup_sync(id);
  const int rows = min(64, M - r0), cols = min(BN, N - c0);
  float* base = out + (long long)r0 * N + c0;
  if (N <= BN && N >= 4 && ((uintptr_t)base & 15) == 0) {
    // Element f of the span is (f / N, f % N) of the block; a thread's
    // elements f = 4 t + 512 i are walked without a division a step.
    const int count = rows * N;
    int r = 4 * t / N, c = 4 * t - r * N;
    const int dr = 512 / N, dc = 512 - dr * N;
    for (int f = 4 * t; f < count; f += 4 * 128) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ce = c + e, wrap = ce >= N;
        v[e] = f + e < count ? blk[(r + wrap) * P + ce - wrap * N] : 0.0f;
      }
      if (f + 4 <= count) {
        *reinterpret_cast<float4*>(base + f) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (f + e < count) base[f + e] = v[e];
        }
      }
      r += dr;
      c += dc;
      if (c >= N) {
        c -= N;
        ++r;
      }
    }
  } else if ((N & 3) == 0) {
    for (int i = t; i < 64 * (BN / 4); i += 128) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      if (r < rows && c < cols) {
        *reinterpret_cast<float4*>(base + (long long)r * N + c) =
            *reinterpret_cast<const float4*>(blk + r * P + c);
      }
    }
  } else {
    for (int i = t; i < 64 * BN; i += 128) {
      const int r = i / BN, c = i % BN;
      if (r < rows && c < cols) base[(long long)r * N + c] = blk[r * P + c];
    }
  }
}

// The units first, first + stride, ... of one staged GEMM on one CTA. The
// producer runs kStages slabs ahead of the consumers; a consumer
// warpgroup issues a slab's k16 wgmmas (from zero), waits on them, frees
// the stage and promotes the slab's sum into its fp32 total, as run does,
// so every output element sees the same sequence of operations.
template <int BN, int kMN>
__device__ __forceinline__ void run_staged(const Staged<BN, kMN>& g,
                                           int first, int stride,
                                           uint8_t* smem_raw) {
  using L = StagedLayout<BN>;
  constexpr int S = L::kStages;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* blocks = reinterpret_cast<float*>(smem + S * L::kStage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + S * L::kStage + L::kOut);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  };
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) return;
    for (int unit = first; unit < g.units; unit += stride) {
      const int s = unit / g.tiles, tile = unit - s * g.tiles;
      const int tm = tile / g.tiles_n;
      const int m0 = tm * kBM, n0 = (tile - tm * g.tiles_n) * BN;
      const int hi = min(g.kp, (s + 1) * g.chunk);
      for (int k0 = s * g.chunk; k0 < hi; k0 += kBK) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = smem + stage * L::kStage;
        mbar_expect_tx(&full[stage], L::kStage);
        if constexpr (kMN) {
#pragma unroll
          for (int h = 0; h < kBM / 64; ++h) {
            tma_load_2d(st + h * 8192, &g.ta, m0 + 64 * h, k0, &full[stage]);
          }
#pragma unroll
          for (int h = 0; h < BN / 64; ++h) {
            tma_load_2d(st + L::kA + h * 8192, &g.tb, n0 + 64 * h, k0,
                        &full[stage]);
          }
        } else {
          tma_load_2d(st, &g.ta, k0, m0, &full[stage]);
          tma_load_2d(st + L::kA, &g.tb, k0, n0, &full[stage]);
        }
        advance();
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  float acc[BN / 2], total[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.0f;
  for (int unit = first; unit < g.units; unit += stride) {
    const int s = unit / g.tiles, tile = unit - s * g.tiles;
    const int tm = tile / g.tiles_n;
    const int m0 = tm * kBM, n0 = (tile - tm * g.tiles_n) * BN;
    const int hi = min(g.kp, (s + 1) * g.chunk);
    for (int k0 = s * g.chunk; k0 < hi; k0 += kBK) {
      const int nk = min(kKB, (hi - k0) / mx::kBlock);
      mbar_wait(&full[stage], phase);
      const uint8_t* st = smem + stage * L::kStage;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) {
        if (kk < nk) {
          if constexpr (kMN) {
            wgmma_staged<BN, 1>(
                acc, desc_sw128(st + wg * 8192 + 2048 * kk, 8192),
                desc_sw128(st + L::kA + 2048 * kk, 8192), kk > 0);
          } else {
            wgmma_staged<BN, 0>(
                acc, desc_sw128(st + wg * (L::kA / 2) + 32 * kk),
                desc_sw128(st + L::kA + 32 * kk), kk > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) total[i] += acc[i];
      advance();
    }
    float* out = g.split > 1 ? g.ws + (long long)s * g.M * g.N : g.c;
    store_rows<BN>(total, blocks + wg * 64 * L::kPitch, out, g.M, g.N,
                   m0 + 64 * wg, n0, 1 + wg);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] = 0.0f;
  }
}

// Both staged GEMMs of the pair in one launch: ctas1 CTAs walk dX's units
// (K-major), ctas2 dW's (MN-major) — the Hopper form of the Pallas
// kernel's two-phase grid; dX's CTAs come first unless dw_first.
template <int BN1, int BN2>
__global__ void __launch_bounds__(kPairThreads, 1)
    pair_kernel(const __grid_constant__ Staged<BN1, 0> g1,
                const __grid_constant__ Staged<BN2, 1> g2, int ctas1,
                int ctas2, int dw_first) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int b = blockIdx.x;
  const int i1 = dw_first ? b - ctas2 : b;  // this CTA's place among dX's
  if (i1 >= 0 && i1 < ctas1) {
    run_staged(g1, i1, ctas1, smem);
  } else {
    run_staged(g2, dw_first ? b : b - ctas1, ctas2, smem);
  }
}

// The stem's path: an fp32 lhs [M, K] whose rows are contiguous but not
// 16-byte aligned (K % 4 != 0: the stem's K = 147, 588-byte rows), which
// neither TMA nor 16-byte cp.async can cut into k-slabs, over a contraction
// short enough that two of a tile's lhs panels fit in shared memory — 128
// rows x K, one contiguous span of 512 K bytes on a 16-byte boundary, one
// cp.async.bulk — with N <= 64 (one tile column) and no split. The rhs is
// the same for every tile, so a CTA converts it once and keeps it as bf16;
// the next tile's panel loads while this one converts. The wgmmas and the
// promotions run in the ring's order (slabs of 64 from k = 0), so outputs
// are bit for bit the ring's (the unfused stem takes the ring).
struct Panel {
  const float* a;
  int M, K, kp, mb;
  int tiles;        // ceil(M / 128)
  int panel_bytes;  // one panel buffer, a multiple of 1024
};

template <class B>
__global__ void __launch_bounds__(kThreads, 1)
    panel_kernel(const __grid_constant__ Panel pa,
                 const __grid_constant__ B b, float* c, int N) {
  constexpr int BN = 64;
  constexpr int kAcc = BN / 4;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* panel0 = reinterpret_cast<float*>(smem);
  float* panel1 = reinterpret_cast<float*>(smem + pa.panel_bytes);
  __nv_bfloat16* abuf =
      reinterpret_cast<__nv_bfloat16*>(smem + 2 * pa.panel_bytes);
  __nv_bfloat16* bbuf = abuf + kBM * pa.kp;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bbuf + BN * pa.kp);
  const int wm = threadIdx.x / 128 % 2, wn = threadIdx.x / 256;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue_panel = [&](int tile, float* dst, uint64_t* bar) {
    if (threadIdx.x == 0) {
      const int rows = min(kBM, pa.M - tile * kBM);
      const uint32_t bytes = (uint32_t)rows * pa.K * 4;
      mbar_expect_tx(bar, bytes);
      bulk_load(dst, pa.a + (long long)tile * kBM * pa.K, bytes, bar);
    }
  };
  if ((int)blockIdx.x < pa.tiles) issue_panel(blockIdx.x, panel0, &bars[0]);
  // The rhs, slab by slab through panel1, into the resident bf16 rhs.
  for (int k0 = 0, r = 0; k0 < pa.kp; k0 += kBK, ++r) {
    if (threadIdx.x == 0) {
      fence_proxy_async();
      mbar_expect_tx(&bars[2], b.tma_bytes());
    }
    b.load(panel1, 0, k0, &bars[2]);
    cp_async_commit();
    cp_async_wait<0>();
    mbar_wait(&bars[2], r & 1);
    __syncthreads();
    for (int u = threadIdx.x; u < BN * kKB; u += kThreads) {
      if (k0 + mx::kBlock * (u / BN) < pa.kp) {
        b.convert(panel1, 0, k0, u,
                  bbuf + (k0 / mx::kBlock) * (BN / 8) * 128);
      }
    }
    __syncthreads();
  }
  float acc[kAcc], total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = total[i] = 0.0f;
  const int blocks = pa.kp / mx::kBlock;
  int i = 0;
  for (int tile = blockIdx.x; tile < pa.tiles; tile += gridDim.x, ++i) {
    float* cur = i & 1 ? panel1 : panel0;
    if (tile + (int)gridDim.x < pa.tiles) {
      if (threadIdx.x == 0) fence_proxy_async();
      issue_panel(tile + gridDim.x, i & 1 ? panel0 : panel1,
                  &bars[(i + 1) & 1]);
    }
    mbar_wait(&bars[i & 1], (i >> 1) & 1);
#pragma unroll 1
    for (int u = threadIdx.x; u < kBM * blocks; u += kThreads) {
      const int x = u % kBM, kb = u / kBM;
      const float* row = cur + x * pa.K + mx::kBlock * kb;
      const int valid = pa.K - mx::kBlock * kb;
      uint32_t bits[mx::kBlock];
#pragma unroll
      for (int e = 0; e < mx::kBlock; ++e) {
        bits[e] = e < valid ? __float_as_uint(row[e]) : 0u;
      }
      float q[mx::kBlock], v[mx::kBlock];
      int ex;
      uint32_t packed;
      mx::quantize_block_f(bits, pa.mb, q, ex, packed);
      mx::dequantize_block_f(q, ex, packed, pa.mb, v);
      store_bf16<kBM>(abuf, x, kb, v);
    }
    fence_proxy_async();
    __syncthreads();
    for (int k0 = 0; k0 < pa.kp; k0 += kBK) {
      const int nk = min(kKB, (pa.kp - k0) / mx::kBlock);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) {
        if (kk < nk) {
          const int kb = k0 / mx::kBlock + kk;
          wgmma_tile<BN>(
              acc, desc(abuf + (kb * (kBM / 8) + 8 * wm) * 128, 128, 256),
              desc(bbuf + (kb * (BN / 8) + wn * (BN / 16)) * 128, 128, 256),
              kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) total[e] += acc[e];
    }
    store_tile<BN>(total, c, pa.M, N, tile * kBM, 0);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) total[e] = 0.0f;
    __syncthreads();  // every warpgroup's wgmmas have read this tile's bf16
  }
}

// Shared memory of panel_kernel for a contraction of K (0 if the path
// does not apply).
int panel_smem(int K) {
  const int kp = (K + mx::kBlock - 1) / mx::kBlock * mx::kBlock;
  const int panel = (kBM * K * 4 + 1023) / 1024 * 1024;
  const int bytes = 2 * panel + (kBM + 64) * kp * 2 + 3 * 8 + 1024;
  return bytes <= kSmemMax && 64 * kBK * 4 <= panel ? bytes : 0;
}

// Whether an fp32 lhs (element (m, k) at a[m * sam + k * sak]) takes the
// panel path (panel_kernel's conditions).
bool panel_path(const void* a, long long sam, long long sak, int M, int N,
                int K, int split) {
  return sak == 1 && sam == K && K % 4 != 0 && M % 4 == 0 && M > 0 &&
         (uintptr_t)a % 16 == 0 && split == 1 && N <= 64 &&
         panel_smem(K) > 0;
}

template <class B>
int launch_panel(const void* a, int M, int K, int mb, const B& b, void* c,
                 int N, void* stream) {
  const int kp = (K + mx::kBlock - 1) / mx::kBlock * mx::kBlock;
  const Panel pa{(const float*)a, M, K, kp, mb, (M + kBM - 1) / kBM,
                 (kBM * K * 4 + 1023) / 1024 * 1024};
  const int bytes = panel_smem(K);
  auto kernel = panel_kernel<B>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  kernel<<<min(pa.tiles, sm_count()), kThreads, bytes,
           (cudaStream_t)stream>>>(pa, b, (float*)c, N);
  return (int)cudaGetLastError();
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

// The tile width BN as a function of N (mx_matmul.py::tile_n).
inline bool narrow(int n) { return n <= 64; }

template <int BN, class A, class B>
Gemm<BN, A, B> make_gemm(A a, B b, void* c, int M, int N, int kp, int split,
                         int chunk, void* ws) {
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  return Gemm<BN, A, B>{a,      b,     (float*)c, (float*)ws, M,
                        N,      kp,    split,     chunk,      tiles_n,
                        tiles,  tiles * split};
}

template <class G>
void launch_reduce(const G& g, cudaStream_t stream) {
  if (g.split == 1 || g.units == 0) return;
  const long long mn = (long long)g.M * g.N;
  const int threads = 256;
  const long long blocks = min((mn + threads - 1) / threads, 8LL * 1024);
  split_reduce_kernel<<<(int)blocks, threads, 0, stream>>>(g.ws, g.c, mn,
                                                           g.split);
}

// An empty contraction (Kp = 0) is a zero output.
template <class G>
bool empty(const G& g, cudaStream_t s) {
  if (g.units > 0 && g.kp == 0) {
    cudaMemsetAsync(g.c, 0, sizeof(float) * g.M * g.N, s);
  }
  return g.units == 0 || g.kp == 0;
}

template <int BN, class A, class B>
int launch(const Gemm<BN, A, B>& g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!empty(g, s)) {
    auto go = [&](auto res) {
      constexpr bool kResB = decltype(res)::value;
      constexpr int bytes = Layout<BN, A, B, kResB>::kBytes;
      auto kernel = gemm_kernel<kResB, BN, A, B>;
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      kernel<<<min(g.units, sm_count()), kThreads, bytes, s>>>(g);
    };
    if constexpr (BN == 64) {
      if (g.split == 1 && g.tiles_n == 1 && g.kp <= kResKp) {
        go(std::true_type{});
      } else {
        go(std::false_type{});
      }
    } else {
      go(std::false_type{});
    }
    launch_reduce(g, s);
  }
  return (int)cudaGetLastError();
}

// The driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against the driver library).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(sym);
    }
  }
  return fn;
}

// An fp32 operand of X rows: element (x, k) at p[x * sx + k * sk].
template <int X>
F32Op<X> f32_op(const void* p, long long sx, long long sk, int ext_x,
                int ext_k, int mb) {
  F32Op<X> op{};
  op.p = (const float*)p;
  op.sx = sx;
  op.sk = sk;
  op.ext_x = ext_x;
  op.ext_k = ext_k;
  op.mb = mb;
  op.inner_k = !(sx == 1 && sk != 1);
  const long long inner = op.inner_k ? sk : sx, outer = op.inner_k ? sx : sk;
  auto encode = tensor_map_encoder();
  if (inner == 1 && outer % 4 == 0 && (uintptr_t)p % 16 == 0) {
    // A stride-1 inner axis and 16-byte aligned rows: the slab as boxes of
    // 32 inner values by its outer rows, 128-byte swizzled, zero-filled
    // past the edges. 4-byte cp.async where TMA does not take it.
    const cuuint64_t dims[2] = {
        (cuuint64_t)(op.inner_k ? ext_k : ext_x),
        (cuuint64_t)(op.inner_k ? ext_x : ext_k)};
    const cuuint64_t strides[1] = {(cuuint64_t)outer * 4};
    const cuuint32_t box[2] = {32, (cuuint32_t)(op.inner_k ? X : kBK)};
    const cuuint32_t unit[2] = {1, 1};
    op.tma = encode != nullptr && dims[0] > 0 && dims[1] > 0 &&
             encode(&op.tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                    const_cast<void*>(p), dims, strides, box, unit,
                    CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  return op;
}

// A staged GEMM over bf16 operands: K-major (kMN = 0) a [M][kp] and b
// [N][kp]; MN-major (kMN = 1) a [kp][pitch_a] and b [kp][pitch_b], valid
// for M and N columns. The maps' boxes are those Staged describes, 128-byte
// swizzled, zero-filled past the edges. False where a map cannot be
// encoded (the launch is then refused, never replaced).
template <int BN, int kMN>
bool make_staged(Staged<BN, kMN>& g, const void* a, int pitch_a,
                 const void* b, int pitch_b, void* c, int M, int N, int kp,
                 int split, int chunk, void* ws) {
  g.c = (float*)c;
  g.ws = (float*)ws;
  g.M = M;
  g.N = N;
  g.kp = kp;
  g.split = split;
  g.chunk = chunk;
  g.tiles_n = (N + BN - 1) / BN;
  g.tiles = (M + kBM - 1) / kBM * g.tiles_n;
  g.units = g.tiles * split;
  if (g.units == 0 || kp == 0) return true;  // nothing to load
  auto encode = tensor_map_encoder();
  // inner x outer elements, rows `pitch` elements apart; boxes bi x bo
  auto map = [&](CUtensorMap* m, const void* p, int inner, int outer,
                 int pitch, int bi, int bo) {
    const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
    const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
    const cuuint32_t box[2] = {(cuuint32_t)bi, (cuuint32_t)bo};
    const cuuint32_t unit[2] = {1, 1};
    return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(p), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (encode == nullptr) return false;
  if constexpr (kMN) {
    return map(&g.ta, a, M, kp, pitch_a, 64, kBK) &&
           map(&g.tb, b, N, kp, pitch_b, 64, kBK);
  }
  return map(&g.ta, a, kp, M, kp, kBK, kBM) &&
         map(&g.tb, b, kp, N, kp, kBK, BN);
}

// Bytes one unit of a staged GEMM moves: its slabs and its output tile.
template <class G>
long long unit_bytes(const G& g, int bn) {
  const long long slabs = (min(g.chunk, g.kp) + kBK - 1) / kBK;
  return slabs * (kBM + bn) * kBK * 2 + (long long)kBM * bn * 4;
}

template <int BN1, int BN2>
int launch_pair(const Staged<BN1, 0>& g1, const Staged<BN2, 1>& g2,
                cudaStream_t s) {
  const bool skip1 = empty(g1, s), skip2 = empty(g2, s);
  const int ctas1 = skip1 ? 0 : min(g1.units, sm_count());
  const int ctas2 = skip2 ? 0 : min(g2.units, sm_count());
  if (ctas1 + ctas2 > 0) {
    constexpr int b1 = StagedLayout<BN1>::kBytes;
    constexpr int b2 = StagedLayout<BN2>::kBytes;
    constexpr int bytes = b1 > b2 ? b1 : b2;
    auto kernel = pair_kernel<BN1, BN2>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    // The GEMM of the longer units first: its CTAs take the SMs at the
    // start, the other's fill them as they free.
    const bool dw_first = !skip1 && !skip2 &&
                          unit_bytes(g2, BN2) > unit_bytes(g1, BN1);
    kernel<<<ctas1 + ctas2, kPairThreads, bytes, s>>>(g1, g2, ctas1, ctas2,
                                                      dw_first);
    if (!skip1) launch_reduce(g1, s);
    if (!skip2) launch_reduce(g2, s);
  }
  return (int)cudaGetLastError();
}

using LhsF32 = F32Op<kBM>;
using LhsMX = MXOp<kBM, true>;
template <int BN>
using RhsMX = MXOp<BN, false>;

}  // namespace

// Plain C interface, loaded with ctypes. Every function launches on
// `stream` and returns cudaGetLastError() (0 on success); nothing here
// synchronizes or allocates. Outputs are row-major fp32. Precisions are
// mantissa bits (2 / 4 / 7). (split, chunk, ws) is the GEMM's split of
// its contraction (mx_matmul.py::gemm_split_plan) and, where split > 1,
// an fp32 workspace [split, M, N]. The wrapper checks devices, types,
// shapes and the 16-byte alignment of MX tensors.

// Unfused: lhs MXTensor K-last (mantissa [M, Kp]), rhs MXTensor K-first
// (mantissa [Kp, N]) -> c [M, N].
extern "C" int mx_gemm_mx(const void* lm, const void* le, const void* lx,
                          int mb_a, const void* rm, const void* re,
                          const void* rx, int mb_b, void* c, int M, int N,
                          int Kp, int split, int chunk, void* ws,
                          void* stream) {
  LhsMX a{(const int8_t*)lm, (const int8_t*)le, (const uint8_t*)lx, Kp,
          Kp / mx::kBlock, M, Kp, mb_a};
  if (narrow(N)) {
    const RhsMX<64> b{(const int8_t*)rm, (const int8_t*)re,
                      (const uint8_t*)rx, N, N, N, Kp, mb_b};
    return launch(make_gemm<64>(a, b, c, M, N, Kp, split, chunk, ws),
                  stream);
  }
  const RhsMX<128> b{(const int8_t*)rm, (const int8_t*)re,
                     (const uint8_t*)rx, N, N, N, Kp, mb_b};
  return launch(make_gemm<128>(a, b, c, M, N, Kp, split, chunk, ws), stream);
}

// Fused: fp32 a (element (m, k) at a[m * sam + k * sak]) and fp32 b
// (element (k, n) at b[k * sbk + n * sbn]), both quantized in-tile.
extern "C" int mx_gemm_fused(const void* a, long long sam, long long sak,
                             int mb_a, const void* b, long long sbk,
                             long long sbn, int mb_b, void* c, int M, int N,
                             int K, int split, int chunk, void* ws,
                             void* stream) {
  const LhsF32 la = f32_op<kBM>(a, sam, sak, M, K, mb_a);
  const int kp = (K + mx::kBlock - 1) / mx::kBlock * mx::kBlock;
  if (panel_path(a, sam, sak, M, N, K, split)) {
    return launch_panel(a, M, K, mb_a, f32_op<64>(b, sbn, sbk, N, K, mb_b),
                        c, N, stream);
  }
  if (narrow(N)) {
    return launch(make_gemm<64>(la, f32_op<64>(b, sbn, sbk, N, K, mb_b), c,
                                M, N, kp, split, chunk, ws),
                  stream);
  }
  return launch(make_gemm<128>(la, f32_op<128>(b, sbn, sbk, N, K, mb_b), c,
                               M, N, kp, split, chunk, ws),
                stream);
}

// Weight-resident serving: fp32 a quantized in-tile, a stored rhs-layout
// weight (mantissa [Kp, N], Kp = 16 * ceil(K / 16)) only dequantized.
extern "C" int mx_gemm_prequant(const void* a, long long sam, long long sak,
                                int mb_a, const void* rm, const void* re,
                                const void* rx, int mb_b, void* c, int M,
                                int N, int K, int split, int chunk, void* ws,
                                void* stream) {
  const LhsF32 la = f32_op<kBM>(a, sam, sak, M, K, mb_a);
  const int kp = (K + mx::kBlock - 1) / mx::kBlock * mx::kBlock;
  if (panel_path(a, sam, sak, M, N, K, split)) {
    return launch_panel(a, M, K, mb_a,
                        RhsMX<64>{(const int8_t*)rm, (const int8_t*)re,
                                  (const uint8_t*)rx, N, N, N, kp, mb_b},
                        c, N, stream);
  }
  if (narrow(N)) {
    return launch(make_gemm<64>(la, RhsMX<64>{(const int8_t*)rm,
                                               (const int8_t*)re,
                                               (const uint8_t*)rx, N, N, N,
                                               kp, mb_b},
                                c, M, N, kp, split, chunk, ws),
                  stream);
  }
  return launch(make_gemm<128>(la, RhsMX<128>{(const int8_t*)rm,
                                              (const int8_t*)re,
                                              (const uint8_t*)rx, N, N, N,
                                              kp, mb_b},
                               c, M, N, kp, split, chunk, ws),
                stream);
}

// Backward pair of y = x @ w: g [M, N], x [M, K], w [K, N], row-major,
// in two calls. mx_pair_stage converts each operand once for each axis it
// is quantized along, into bf16 operands in their source's row layout
// (the wrapper allocates them; Np, Mp: N, M rounded up to 16; Nq, Kq: N,
// K rounded up to 8):
//   gn [M][Np] = q_N(g), wn [K][Np] = q_N(w) — dX's lhs and rhs;
//   xt [Mp][Kq] = q_M(x), gt [Mp][Nq] = q_M(g) — dW's lhs and rhs: the
//       same cotangent quantized a second time, along the other axis, as
//       the Pallas kernel does.
// mx_gemm_bwd_pair then computes, in one launch,
//   dx [M, K] = gn · wn^T (contracted over N) and dw [K, N] = xt^T · gt
//   (over M),
// and a reduce launch follows for each GEMM whose split is above 1.
extern "C" int mx_pair_stage(const void* g, const void* x, const void* w,
                             int mb, void* gn, void* wn, void* xt, void* gt,
                             int M, int N, int K, void* stream) {
  Stage st{};
  st.mb = mb;
  auto round = [](int n, int to) { return (n + to - 1) / to * to; };
  auto job = [&](StageJob& jb, const void* src, int R, int C, void* dst_c,
                 void* dst_r) {
    jb.src = (const float*)src;
    jb.dst_c = (__nv_bfloat16*)dst_c;
    jb.dst_r = (__nv_bfloat16*)dst_r;
    jb.R = R;
    jb.C = C;
    jb.cp = round(C, mx::kBlock);
    jb.rp = round(R, mx::kBlock);
    jb.cq = round(C, 8);
    jb.lt = 4;
    while ((1 << jb.lt) < C && (1 << jb.lt) < kStageTCMax) ++jb.lt;
    const int tc = 1 << jb.lt, tr = kStageTile / tc;
    jb.tiles_c = (C + tc - 1) / tc;
    jb.blocks = (R + tr - 1) / tr * jb.tiles_c;
  };
  job(st.job[0], g, M, N, gn, gt);
  job(st.job[1], w, K, N, wn, nullptr);
  job(st.job[2], x, M, K, nullptr, xt);
  // One launch for each way of reading that the jobs take (one, except
  // at the stem), each over its own jobs.
  for (StageLoad mode : {kRows, kSpan, kWords}) {
    Stage part = st;
    long long blocks = 0;
    for (StageJob& jb : part.job) {
      if (stage_load(jb.src, jb.C, 1 << jb.lt) != mode) jb.blocks = 0;
      blocks += jb.blocks;
    }
    if (blocks == 0) continue;
    auto kernel = mode == kRows   ? pair_stage_kernel<kRows>
                  : mode == kSpan ? pair_stage_kernel<kSpan>
                                  : pair_stage_kernel<kWords>;
    kernel<<<(unsigned)blocks, kStageThreads, 0, (cudaStream_t)stream>>>(
        part);
  }
  return (int)cudaGetLastError();
}

extern "C" int mx_gemm_bwd_pair(const void* gn, const void* wn,
                                const void* xt, const void* gt, void* dx,
                                void* dw, int M, int N, int K, int split_dx,
                                int chunk_dx, void* ws_dx, int split_dw,
                                int chunk_dw, void* ws_dw, void* stream) {
  auto round = [](int n, int to) { return (n + to - 1) / to * to; };
  const int np = round(N, mx::kBlock), mp = round(M, mx::kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto bn1, auto bn2) {
    constexpr int BN1 = decltype(bn1)::value, BN2 = decltype(bn2)::value;
    Staged<BN1, 0> g1{};
    Staged<BN2, 1> g2{};
    if (!make_staged(g1, gn, np, wn, np, dx, M, K, np, split_dx, chunk_dx,
                     ws_dx) ||
        !make_staged(g2, xt, round(K, 8), gt, round(N, 8), dw, K, N, mp,
                     split_dw, chunk_dw, ws_dw)) {
      return (int)cudaErrorInvalidValue;
    }
    return launch_pair(g1, g2, s);
  };
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I152 = std::integral_constant<int, 152>;
  // With a narrow N, dX's tile spans its K columns up to 152 (the stem's
  // 147: one tile column, whose rows are one contiguous span of dx).
  if (narrow(K)) return narrow(N) ? go(I64{}, I64{}) : go(I64{}, I128{});
  if (!narrow(N)) return go(I128{}, I128{});
  return K > 128 && K <= 152 ? go(I152{}, I64{}) : go(I128{}, I64{});
}
