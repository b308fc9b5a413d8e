// Forward flash attention for Hopper (sm_90a), written by hand.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention.py::flash_attention (body _attn_kernel): GQA
// attention over q [B, Sq, H, D] and k/v [B, Skv, Kv, D], non-causal or
// causal, with an optional sliding window, logit softcap, scale and query
// offset; output [B, Sq, H, D] in q's dtype (fp32 or bf16). The plain
// PyTorch version it is held to is
// repro_torch/kernels/ref.py::flash_attention_ref, which also states how
// the Pallas kernel differs from the JAX oracle (q_offset, fully masked
// rows); this kernel follows the Pallas kernel.
//
// Numerics, as in the Pallas kernel: logits s = (q . k) * scale in fp32,
// then softcap * tanhf(s / softcap), then masked to -1e30 where the key is
// outside the causal / window range (query row i sits at position
// q_offset + i); online softmax with fp32 running max m, sum l and
// accumulator acc; masked probabilities are zeroed, and the output is
// acc / max(l, 1e-30), so a row with no unmasked key comes out 0. bf16
// inputs are widened on load, the output rounded with __float2bfloat16_rn.
// expf / tanhf, no intrinsics, no --use_fast_math.
//
// Design: one CTA of 256 threads (16 x 16) per (batch * head, tile of 64
// query rows). The Q tile stays in shared memory; a sequential loop over
// kv tiles of kBK rows (64, or 32 for D >= 128 so that D = 256 fits in
// shared memory) loads K and V into shared memory, computes the 64 x kBK
// logits (thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j),
// updates m and l per row with 16-lane shuffles, writes the probabilities
// to shared memory and accumulates P V into registers (thread (ty, tx)
// owns output columns tx + 16 j of the same four rows, so m, l and acc
// never leave the thread). Row strides are padded so that column reads
// are free of bank conflicts. kv tiles that hold no unmasked pair for the
// CTA's rows are skipped: the loop runs only over the causal / window
// range, so causal work is about S^2/2 and windowed work about S * W, as
// with the Pallas kernel's pl.when. Ragged Sq and Skv are masked here
// (loads beyond the edge are zero, stores are guarded), so 197 tokens need
// no padding. q, k, v and o are read and written through their (batch,
// sequence, head) strides with D contiguous, so strided views cost no copy.
//
// Bound: the work is 4 * B * H * D FLOPs per unmasked (query, key) pair
// and the bytes are q, k, v and o once each. At ViT-B/16's shape (32, 197,
// 12, 64) fp32 that is 3.8 GFLOP and 77.5 MB: bytes-bound on the H100
// (23 us at 3.35 TB/s against 3.9 us at 989 TFLOP/s). This first kernel computes on the fp32 CUDA cores
// out of shared memory (about two FMAs per shared-memory load in the inner
// loops), far from either bound; wgmma tiles fed by TMA, FA3-style, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kRows = kBQ / 16;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int h, kvh, sq, skv;
  float scale, softcap;
  int has_softcap, causal, has_window, window, q_offset;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
__host__ __device__ constexpr int kv_tile() {
  return D >= 128 ? 32 : 64;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q [kBQ][D+1], K [kBK][D+1], V [kBK][D], P [kBQ][kBK+16] floats.
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + (size_t)kv_tile<D>() * (D + 1) +
          (size_t)kv_tile<D>() * D + (size_t)kBQ * (kv_tile<D>() + 16));
}

__device__ __forceinline__ float reduce16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Params p) {
  constexpr int kBK = kv_tile<D>();
  constexpr int kCols = kBK / 16;  // logit columns per thread
  constexpr int kDC = D / 16;      // output columns per thread
  constexpr int kQS = D + 1;       // padded row strides (floats)
  constexpr int kKS = D + 1;
  constexpr int kPS = kBK + 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * kQS;
  float* vs = ks + kBK * kKS;
  float* ps = vs + kBK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int kvi = hi / (p.h / p.kvh);
  const int q0 = blockIdx.x * kBQ;
  const T* qg = (const T*)p.q + bi * p.q_sb + hi * p.q_sh;
  const T* kg = (const T*)p.k + bi * p.k_sb + kvi * p.k_sh;
  const T* vg = (const T*)p.v + bi * p.v_sb + kvi * p.v_sh;
  T* og = (T*)p.o + bi * p.o_sb + hi * p.o_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * kQS + c] =
        q0 + r < p.sq ? load_f32(qg + (long long)(q0 + r) * p.q_ss + c) : 0.f;
  }

  // The kv range [kv_lo, kv_hi) that can hold an unmasked pair for rows
  // q0 .. q_last (positions q_offset + row).
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int kv_lo = 0, kv_hi = p.skv;
  if (p.causal) kv_hi = min(kv_hi, p.q_offset + q_last + 1);
  if (p.has_window) kv_lo = max(kv_lo, p.q_offset + q0 - p.window + 1);

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = (kv_lo / kBK) * kBK; t0 < kv_hi; t0 += kBK) {
    __syncthreads();  // the Q tile is in; the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = t0 + r < p.skv;
      ks[r * kKS + c] =
          in ? load_f32(kg + (long long)(t0 + r) * p.k_ss + c) : 0.f;
      vs[r * D + c] =
          in ? load_f32(vg + (long long)(t0 + r) * p.v_ss + c) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * kQS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * kKS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = p.q_offset + q0 + ty + 16 * i;
      bool keep[kCols];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = t0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kpos < p.skv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.has_window) ok = ok && kpos > qpos - p.window;
        keep[j] = ok;
        s[i][j] = ok ? x : kNegInf;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], reduce16_max(tile_max));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = e;
        sum += e;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + reduce16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int jd = 0; jd < kDC; ++jd) {
        const float vv = vs[c * D + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = og + (long long)row * p.o_ss;
#pragma unroll
    for (int jd = 0; jd < kDC; ++jd)
      store_out(orow + tx + 16 * jd, acc[i][jd] / denom);
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.h);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Params& p, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o: element strides (batch, sequence, head) with D contiguous;
// is_bf16 selects bf16 for all four tensors (else fp32). Launches nothing
// when the output is empty. Returns the CUDA error code of the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int batch, int h, int kvh, int sq, int skv, int d, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale,
    int has_softcap, float softcap, int causal, int has_window, int window,
    int q_offset, void* stream) {
  if (batch <= 0 || h <= 0 || sq <= 0) return 0;
  if (kvh <= 0 || h % kvh) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_ss = k_ss, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_ss = v_ss, p.v_sh = v_sh;
  p.o_sb = o_sb, p.o_ss = o_ss, p.o_sh = o_sh;
  p.h = h, p.kvh = kvh, p.sq = sq, p.skv = skv;
  p.scale = scale, p.softcap = softcap, p.has_softcap = has_softcap;
  p.causal = causal, p.has_window = has_window, p.window = window;
  p.q_offset = q_offset;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_d<__nv_bfloat16>(p, batch, d, s)
                 : launch_d<float>(p, batch, d, s);
}
