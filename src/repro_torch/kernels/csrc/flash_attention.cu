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
// Numerics, as in the Pallas kernel: logits s = (q . k) * scale with fp32
// accumulation, then softcap * tanhf(s / softcap), then masked to -1e30
// where the key is outside the causal / window range (query row i sits at
// position q_offset + i); online softmax with fp32 running max m, sum l
// and accumulator o; masked probabilities are zeroed, and the output is
// o / max(l, 1e-30), so a row with no unmasked key comes out 0. expf /
// tanhf, no intrinsics, no --use_fast_math.
//
// Design (FlashAttention-2 on mma.sync). A CTA of 4 warps takes 64 query
// rows of one (batch, head); each warp owns 16 rows, and S = Q K^T and
// O += P V run as tensor-core fragments with fp32 accumulators, so m, l
// and O never leave the warp's registers (row max and sum reduce over the
// 4 lanes of a quad). K and V tiles of BK keys (kv_tile) stream through
// two shared-memory stages by cp.async: tile i + 1 loads while tile i
// computes, with one barrier a tile. A tile whose every (row, key) pair
// is unmasked for the warp takes a path with no mask and no per-group
// branch, so that the compiler can interleave the independent MMAs; the
// edge tiles take a guarded path. The two dtypes differ in the fragments:
//   bf16 — m16n8k16 bf16 MMAs fed by ldmatrix (V through .trans). The
//       products of bf16 values are exact in fp32. P is rounded to bf16
//       for P V, FA2's practice (about 2^-9 of each weight; the row sum l
//       stays the fp32 sum).
//   fp32 — 3xTF32 on m16n8k8 TF32 MMAs: x = hi + lo with hi = tf32(x), lo
//       = tf32(x - hi), and a.b = hi.hi + hi.lo + lo.hi, which keeps about
//       22 bits of each operand (plain TF32 keeps 11, ~1e-3: outside the
//       2e-5 limit). S gathers hi.hi and the two small products in two
//       accumulators, added at the end of the tile, so that no MMA waits
//       on the one before it. The C fragment of S holds keys 2t, 2t+1 of a
//       group of 8 in lane t of a quad; P V reads them as the A fragment's
//       columns t and t + 4 and takes V's rows in the same order, so P
//       needs no shuffle. Each warp splits its own K and V fragments, and
//       the splits are about half of its instructions; fp32 at D <= 64
//       therefore runs in at most 128 registers, four CTAs an SM, so that
//       more warps hide each other's latency (16-key tiles at D = 64).
// Ragged edges cost MMA granularity, not tiles: a warp computes only the
// 8-key groups of a tile that hold a key its rows may see (197 keys cost
// 200), a warp whose 16 rows lie past Sq does no arithmetic, and kv tiles
// outside the causal / window range of the CTA are never loaded. Rows and
// keys past the edge load as zero (a zero probability times an unset
// shared-memory value could be NaN), stores are guarded. q, k, v and o
// are read through their (batch, sequence, head) strides with D
// contiguous and every row 16-byte aligned (the wrapper copies what is
// not), so strided views cost no copy.
//
// kv split. When B * H * ceil(Sq / 64) CTAs cannot fill the card and the
// kv range is long (a decode-append: 16 CTAs against 8192 keys), the
// wrapper (flash_attention.py::attention_plan, a pure function of the
// shapes and options) cuts the kv range into S pieces on 64-key
// boundaries; blockIdx.z picks the piece, whose keys the CTA masks like
// any other. Each CTA writes its fp32 partial (O, m, l) to a workspace,
// and combine_kernel merges the S partials of a row in the fixed order s
// = 0..S-1: m = max m_s, l = sum l_s e^(m_s - m), O = sum O_s e^(m_s - m)
// / max(l, 1e-30). Results repeat bit for bit; a row whose every piece
// has l = 0 comes out 0.
//
// Bound: 4 * D FLOPs per unmasked (query, key) pair and head, and the
// bytes of q, k, v and o once each, against 989 TFLOP/s and 3.35 TB/s.
// ViT-B/16 (32, 197, 12, 64) fp32 is bytes-bound (3.8 GFLOP, 77.5 MB: 23
// us against 3.9 us); so are ViT-B/32 and the decode-append. GQA causal
// bf16 and gemma2-2b's local layer (D 256, window 4096) are bound by
// operations. What holds this design back from either bound: mma.sync
// (the card's full tensor-core rate needs wgmma), three TF32 MMAs and
// the splits per fp32 product, and the online softmax between the two
// products; TMA + wgmma with warp specialisation, FA3-style, is later
// work.
//
// Registers (-Xptxas -v, nvcc 12.8, sm_90a; chip_smoke.py prints them):
// fp32 D 16/32 (BK 32) 116/124, D 64 (BK 16) 128, D 128/256 (BK 32)
// 208/246; bf16 D 16/32/64 (BK 64) 167/167/195, D 128/256 (BK 32)
// 189/255; combine 32. No instantiation spills; bf16 D = 256 holds its 128
// O registers in 255 with 32-key tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per CTA, 16 per warp
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
  int h, kvh, sq, skv, d;
  float scale, softcap;
  int has_softcap, causal, has_window, window, q_offset;
  // kv split: piece s holds keys [split_lo + s * split_len, + split_len).
  int splits, split_lo, split_len;
  float* part_o;   // [splits, B * H, Sq, D] unnormalized O (splits > 1)
  float* part_ml;  // [splits, B * H, Sq, 2] (m, l)
};

// Tile shapes of one instantiation: 64 query rows a CTA (16 a warp), BK
// keys per kv tile, two stages of K and V in shared memory. Row strides
// are padded by 8 elements (4 floats for fp32 V) so that the fragment
// loads are free of bank conflicts: ldmatrix's 8 rows, the fp32 8-byte
// loads of Q's and K's rows g, and the fp32 loads of V's rows 2t and
// 2t + 1 each hit distinct banks. kMinBlocks: fp32 at D <= 64 is held to
// 128 registers, so that four CTAs share an SM.
template <typename T, int D, int BK>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kNG = BK / 8;  // 8-key groups per tile
  static constexpr int kQS = D + 8;
  static constexpr int kKS = kQS;
  static constexpr int kVS = kBf16 ? kQS : D + 4;
  static constexpr int kSmem =
      (int)sizeof(T) * (kBQ * kQS + 2 * BK * (kKS + kVS));
  static constexpr int kMinBlocks = (!kBf16 && D <= 64) ? 4 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a [seq, D] matrix (row stride `ld`) into
// shared memory with row stride STRIDE; rows at or past `rows` are zero.
template <typename T, int D, int ROWS, int STRIDE>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int row0, int rows) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * STRIDE + c,
               ok ? src + (long long)(row0 + r) * ld + c : src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16 x 8] += a[16 x 8] b[8 x 8], TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both TF32 (low 13 bits zero), |x - hi - lo| <= 2^-23 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
  lo &= 0xffffe000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// S[16 x BK] = Q K^T for the warp's rows (shared-memory row `qrow`).
// kFull: every 8-key group of the tile; else only the groups [j_lo, j_hi)
// (the others stay 0). The fragments of all groups are loaded first and
// the MMAs issued in passes over independent accumulators.
template <typename T, int D, int BK, bool kFull>
__device__ __forceinline__ void scores(const T* qs, const T* ks, int qrow,
                                       int j_lo, int j_hi,
                                       float (&s)[BK / 8][4]) {
  using C = Cfg<T, D, BK>;
  constexpr int kNG = C::kNG;
  const int lane = threadIdx.x % 32;
  if constexpr (C::kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[kNG][2];
      ldmatrix_x4(a, qs + (qrow + (lane & 15)) * C::kQS + 16 * kk +
                         (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        if (!kFull && (j < j_lo || j >= j_hi)) continue;
        ldmatrix_x2(b[j], ks + (8 * j + (lane & 7)) * C::kKS + 16 * kk +
                              ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        if (!kFull && (j < j_lo || j >= j_hi)) continue;
        mma_bf16(s[j], a, b[j][0], b[j][1]);
      }
    }
  } else {
    const int g = lane / 4, t = lane % 4;
    float small[kNG][4];
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) small[j][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      // Column t of the fragment is d = 8 kk + 2t, column t + 4 is
      // d = 8 kk + 2t + 1, for Q and K alike.
      const float* q = qs + (qrow + g) * C::kQS + 8 * kk + 2 * t;
      const float2 q0 = *reinterpret_cast<const float2*>(q);
      const float2 q1 = *reinterpret_cast<const float2*>(q + 8 * C::kQS);
      uint32_t ah[4], al[4], bh[kNG][2], bl[kNG][2];
      split_tf32(q0.x, ah[0], al[0]);
      split_tf32(q1.x, ah[1], al[1]);
      split_tf32(q0.y, ah[2], al[2]);
      split_tf32(q1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        if (!kFull && (j < j_lo || j >= j_hi)) continue;
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (8 * j + g) * C::kKS + 8 * kk + 2 * t);
        split_tf32(kv.x, bh[j][0], bl[j][0]);
        split_tf32(kv.y, bh[j][1], bl[j][1]);
      }
      // 3xTF32: hi . hi into S, the two small products into their own
      // accumulator, so that the three chains do not wait on each other.
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        if (!kFull && (j < j_lo || j >= j_hi)) continue;
        mma_tf32(s[j], ah, bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        if (!kFull && (j < j_lo || j >= j_hi)) continue;
        mma_tf32(small[j], al, bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kNG; ++j) {
        if (!kFull && (j < j_lo || j >= j_hi)) continue;
        mma_tf32(small[j], ah, bl[j][0], bl[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] += small[j][i];
    }
  }
}

// Online softmax over one tile, in place (S becomes P). Lane t of a quad
// holds keys 8j + 2t + e of rows g (s[j][e]) and g + 8 (s[j][2 + e]).
// kFull: every (row, key) pair of the tile is unmasked; else keys outside
// [row_lo, row_hi) of a row are masked and the groups outside [j_lo,
// j_hi) stay 0.
template <int kNG, int kND, bool kFull>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kNG][4], float (&m)[2], float (&l)[2], float (&o)[kND][4],
    const Params& p, int t0, int j_lo, int j_hi, const int (&row_lo)[2],
    const int (&row_hi)[2]) {
  const int t = threadIdx.x % 4;
  if (p.has_softcap) {
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[j][i] * p.scale;
        s[j][i] = p.softcap * tanhf(x / p.softcap);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] *= p.scale;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
      if (!kFull && (j < j_lo || j >= j_hi)) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * r + e];
        if (!kFull) {
          const int kpos = t0 + 8 * j + 2 * t + e;
          if (kpos < row_lo[r] || kpos >= row_hi[r]) x = kNegInf;
        }
        tile_max = fmaxf(tile_max, x);
      }
    }
    const float m_new = fmaxf(m[r], quad_max(tile_max));
    const float alpha = expf(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
      if (!kFull && (j < j_lo || j >= j_hi)) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * r + e];
        float pe = expf(x - m_new);
        if (!kFull) {
          const int kpos = t0 + 8 * j + 2 * t + e;
          if (kpos < row_lo[r] || kpos >= row_hi[r]) pe = 0.f;
        }
        x = pe;
        sum += pe;
      }
    }
    l[r] = l[r] * alpha + sum;
    m[r] = m_new;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      o[n][2 * r] *= alpha;
      o[n][2 * r + 1] *= alpha;
    }
  }
}

// O[16 x D] += P V over the tile (kFull) or its groups [j_lo, j_hi).
template <typename T, int D, int BK, bool kFull>
__device__ __forceinline__ void accumulate(const T* vs, int j_lo, int j_hi,
                                           const float (&s)[BK / 8][4],
                                           float (&o)[D / 8][4]) {
  using C = Cfg<T, D, BK>;
  constexpr int kNG = C::kNG;
  const int lane = threadIdx.x % 32;
  if constexpr (C::kBf16) {
    constexpr int kNB = D / 16 < 4 ? D / 16 : 4;  // 16-column blocks a pass
#pragma unroll
    for (int c = 0; c < kNG / 2; ++c) {
      if (!kFull && (2 * c + 1 < j_lo || 2 * c >= j_hi)) continue;
      // The C fragments of key groups 2c and 2c + 1 are the A fragment.
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int np0 = 0; np0 < D / 16; np0 += kNB) {
        uint32_t b[kNB][4];
#pragma unroll
        for (int i = 0; i < kNB; ++i)
          ldmatrix_x4_trans(b[i], vs + (16 * c + (lane & 15)) * C::kVS +
                                      16 * (np0 + i) + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          mma_bf16(o[2 * (np0 + i)], a, b[i][0], b[i][1]);
          mma_bf16(o[2 * (np0 + i) + 1], a, b[i][2], b[i][3]);
        }
      }
    }
  } else {
    constexpr int kNB = D / 8 < 4 ? D / 8 : 4;  // 8-column blocks a pass
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < kNG; ++j) {
      if (!kFull && (j < j_lo || j >= j_hi)) continue;
      // Lane t holds P at keys 8j + 2t (c0, c2) and 8j + 2t + 1 (c1, c3):
      // A's columns t and t + 4, so V's rows t and t + 4 are those keys.
      uint32_t ah[4], al[4];
      split_tf32(s[j][0], ah[0], al[0]);
      split_tf32(s[j][2], ah[1], al[1]);
      split_tf32(s[j][1], ah[2], al[2]);
      split_tf32(s[j][3], ah[3], al[3]);
      const float* v = vs + (8 * j + 2 * t) * C::kVS + g;
#pragma unroll
      for (int n0 = 0; n0 < D / 8; n0 += kNB) {
        uint32_t bh[kNB][2], bl[kNB][2];
#pragma unroll
        for (int i = 0; i < kNB; ++i) {
          split_tf32(v[8 * (n0 + i)], bh[i][0], bl[i][0]);
          split_tf32(v[C::kVS + 8 * (n0 + i)], bh[i][1], bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < kNB; ++i)
          mma_tf32(o[n0 + i], al, bh[i][0], bh[i][1]);
#pragma unroll
        for (int i = 0; i < kNB; ++i)
          mma_tf32(o[n0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
        for (int i = 0; i < kNB; ++i)
          mma_tf32(o[n0 + i], ah, bh[i][0], bh[i][1]);
      }
    }
  }
}

// One kv tile for one warp: S, the online softmax, P V.
template <typename T, int D, int BK, bool kFull>
__device__ __forceinline__ void tile_step(
    const T* qs, const T* ks, const T* vs, int qrow, const Params& p, int t0,
    int j_lo, int j_hi, const int (&row_lo)[2], const int (&row_hi)[2],
    float (&m)[2], float (&l)[2], float (&o)[D / 8][4]) {
  float s[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  }
  scores<T, D, BK, kFull>(qs, ks, qrow, j_lo, j_hi, s);
  softmax_tile<BK / 8, D / 8, kFull>(s, m, l, o, p, t0, j_lo, j_hi, row_lo,
                                     row_hi);
  accumulate<T, D, BK, kFull>(vs, j_lo, j_hi, s, o);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads, (Cfg<T, D, BK>::kMinBlocks))
attention_kernel(Params p) {
  using C = Cfg<T, D, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * C::kQS;      // two stages of [BK][kKS]
  T* vs = ks + 2 * BK * C::kKS;   // two stages of [BK][kVS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvi = hi / (p.h / p.kvh);
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.z;
  const T* qg = (const T*)p.q + bi * p.q_sb + hi * p.q_sh;
  const T* kg = (const T*)p.k + bi * p.k_sb + kvi * p.k_sh;
  const T* vg = (const T*)p.v + bi * p.v_sb + kvi * p.v_sh;

  // The keys [kv_lo, kv_hi) this CTA may need: its piece of the kv split,
  // cut to the causal / window range of rows q0 .. q_last.
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int kv_lo = max(0, p.split_lo + split * p.split_len);
  int kv_hi = (int)min((long long)p.skv,
                       (long long)p.split_lo + (long long)(split + 1) *
                                                   p.split_len);
  if (p.causal) kv_hi = min(kv_hi, p.q_offset + q_last + 1);
  if (p.has_window) kv_lo = max(kv_lo, p.q_offset + q0 - p.window + 1);
  // This warp's 16 rows: the keys any of them may see, [w_lo, w_hi), and
  // those all of them see, [w_lo_all, w_hi_all); per row (g and g + 8),
  // [row_lo, row_hi).
  const int r0 = q0 + 16 * warp;
  const bool warp_live = r0 < p.sq;
  int w_lo = kv_lo, w_hi = kv_hi, w_lo_all = kv_lo, w_hi_all = kv_hi;
  if (p.causal) {
    w_hi = min(kv_hi, p.q_offset + min(r0 + 16, p.sq));
    w_hi_all = min(kv_hi, p.q_offset + r0 + 1);
  }
  if (p.has_window) {
    w_lo = max(kv_lo, p.q_offset + r0 - p.window + 1);
    w_lo_all = max(kv_lo, p.q_offset + r0 + 15 - p.window + 1);
  }
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = p.q_offset + r0 + g + 8 * r;
    row_lo[r] = p.has_window ? max(kv_lo, qpos - p.window + 1) : kv_lo;
    row_hi[r] = p.causal ? min(kv_hi, qpos + 1) : kv_hi;
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // Two stages: tile i + 1 loads while tile i computes, one barrier a tile.
  const int t_first = (kv_lo / BK) * BK;
  const int tiles = kv_lo < kv_hi ? (kv_hi - t_first + BK - 1) / BK : 0;
  if (tiles > 0) {
    load_tile<T, D, kBQ, C::kQS>(qs, qg, p.q_ss, q0, p.sq);
    load_tile<T, D, BK, C::kKS>(ks, kg, p.k_ss, t_first, p.skv);
    load_tile<T, D, BK, C::kVS>(vs, vg, p.v_ss, t_first, p.skv);
    cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    const int t0 = t_first + it * BK;
    const int stage = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it in; every warp is done with tile it - 1
    if (it + 1 < tiles) {
      load_tile<T, D, BK, C::kKS>(ks + (stage ^ 1) * BK * C::kKS, kg,
                                  p.k_ss, t0 + BK, p.skv);
      load_tile<T, D, BK, C::kVS>(vs + (stage ^ 1) * BK * C::kVS, vg,
                                  p.v_ss, t0 + BK, p.skv);
      cp_async_commit();
    }
    // The 8-key groups of this tile that hold a key of the warp's rows.
    const int j_lo = max(0, (w_lo - t0) >> 3);
    const int j_hi = min(C::kNG, (w_hi - t0 + 7) >> 3);
    if (!warp_live || j_lo >= j_hi) continue;
    const T* kb = ks + stage * BK * C::kKS;
    const T* vb = vs + stage * BK * C::kVS;
    if (t0 >= w_lo_all && t0 + BK <= w_hi_all) {
      tile_step<T, D, BK, true>(qs, kb, vb, 16 * warp, p, t0, j_lo, j_hi,
                                row_lo, row_hi, m, l, o);
    } else {
      tile_step<T, D, BK, false>(qs, kb, vb, 16 * warp, p, t0, j_lo, j_hi,
                                 row_lo, row_hi, m, l, o);
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float l_row = quad_sum(l[r]);
    if (row >= p.sq) continue;
    if (p.splits == 1) {
      T* orow = (T*)p.o + bi * p.o_sb + row * p.o_ss + hi * p.o_sh;
      const float denom = fmaxf(l_row, 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(orow + 8 * n + 2 * t, o[n][2 * r] / denom,
               o[n][2 * r + 1] / denom);
    } else {
      const long long prow =
          ((long long)split * gridDim.y + bh) * p.sq + row;
      float* po = p.part_o + prow * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(po + 8 * n + 2 * t, o[n][2 * r], o[n][2 * r + 1]);
      if (t == 0) store2(p.part_ml + 2 * prow, m[r], l_row);
    }
  }
}

// Merges the kv split's partials, one thread per output element, in the
// fixed order s = 0..S-1.
template <typename T>
__global__ void combine_kernel(Params p, long long rows) {
  const long long n = rows * p.d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long prow = i / p.d;  // (b * H + h) * Sq + row
    const int dd = (int)(i % p.d);
    float mx = kNegInf;
    for (int s = 0; s < p.splits; ++s)
      mx = fmaxf(mx, p.part_ml[2 * (s * rows + prow)]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float w = expf(p.part_ml[2 * (s * rows + prow)] - mx);
      l += p.part_ml[2 * (s * rows + prow) + 1] * w;
      acc += p.part_o[(s * rows + prow) * p.d + dd] * w;
    }
    const long long bh = prow / p.sq;
    const int row = (int)(prow % p.sq);
    T* out = (T*)p.o + (bh / p.h) * p.o_sb + row * p.o_ss +
             (bh % p.h) * p.o_sh + dd;
    store1(out, acc / fmaxf(l, 1e-30f));
  }
}

// Keys per kv tile: bf16 64 up to D = 64; fp32 16 at D = 64, where the
// 3xTF32 fragments of larger tiles would not fit in 128 registers, and 32
// below it (fewer dependent steps over a short sequence); 32 from D = 128,
// where two stages of K and V (and fp32's registers) would not fit two
// CTAs an SM.
template <typename T, int D>
constexpr int kv_tile() {
  if (D >= 128) return 32;
  if (std::is_same<T, __nv_bfloat16>::value) return 64;
  return D == 64 ? 16 : 32;
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kBK = kv_tile<T, D>();
  using C = Cfg<T, D, kBK>;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, D, kBK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.h, p.splits);
  attention_kernel<T, D, kBK><<<grid, kThreads, C::kSmem, stream>>>(p);
  if (p.splits > 1) {
    const long long rows = (long long)batch * p.h * p.sq;
    const long long blocks = min((rows * D + 255) / 256, 8LL * 1024);
    combine_kernel<T><<<(int)blocks, 256, 0, stream>>>(p, rows);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Params& p, int batch, cudaStream_t stream) {
  switch (p.d) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o: element strides (batch, sequence, head) with D contiguous and
// every row 16-byte aligned; is_bf16 selects bf16 for all four tensors
// (else fp32). (splits, split_lo, split_len) is the kv split of
// flash_attention.py::attention_plan; with splits > 1, part_o [splits, B *
// H, Sq, D] and part_ml [splits, B * H, Sq, 2] are fp32 workspaces and a
// combine launch follows. Launches nothing when the output is empty.
// Returns the CUDA error code of the launches.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int batch, int h, int kvh, int sq, int skv, int d, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale,
    int has_softcap, float softcap, int causal, int has_window, int window,
    int q_offset, int splits, int split_lo, int split_len, void* part_o,
    void* part_ml, void* stream) {
  if (batch <= 0 || h <= 0 || sq <= 0) return 0;
  if (kvh <= 0 || h % kvh || splits < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_ss = k_ss, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_ss = v_ss, p.v_sh = v_sh;
  p.o_sb = o_sb, p.o_ss = o_ss, p.o_sh = o_sh;
  p.h = h, p.kvh = kvh, p.sq = sq, p.skv = skv, p.d = d;
  p.scale = scale, p.softcap = softcap, p.has_softcap = has_softcap;
  p.causal = causal, p.has_window = has_window, p.window = window;
  p.q_offset = q_offset;
  p.splits = splits, p.split_lo = split_lo, p.split_len = split_len;
  p.part_o = (float*)part_o;
  p.part_ml = (float*)part_ml;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_d<__nv_bfloat16>(p, batch, s)
                 : launch_d<float>(p, batch, s);
}
