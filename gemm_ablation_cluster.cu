// The backward pair's alternative design, for gemm_ablation.py only: not
// part of the kernel library. gemm_ablation.py appends this file to a copy
// of src/repro_torch/kernels/csrc/mx_gemm.cu (it uses that file's
// operands, ring and wgmma helpers) and builds the result into a library
// of its own, to time it against the staged pair.
//
// mx_gemm_pair_cluster computes what mx_gemm_bwd_pair does — dX =
// fused(g, w^T) and dW = fused(x^T, g), bit for bit — with no staged bf16
// copies: each GEMM is the fused kernel's in-tile-converting ring, launched
// in thread-block clusters. The CTAs of a cluster compute the tiles that
// share one operand slab (dX: the tile row's tiles, which share g; dW:
// the tile column's tiles, which share g along M), so each CTA converts
// 1 / C of the shared slab and stores its bf16 values into the buffers of
// all C CTAs through distributed shared memory; the other operand is its
// own (dX: w^T, converted once per CTA into a resident buffer, since a
// CTA keeps its tile column; dW: x^T). Each CTA still reads the whole raw
// shared slab (from L2; no TMA multicast). One cluster barrier a slab, after
// each CTA has waited on its previous slab's wgmmas, orders the stores
// before the wgmmas that read them and keeps a buffer from being
// overwritten while a peer's wgmmas read it. C is the shared axis' tile
// count and at most 8, so only GEMMs with at most 8 tiles along it run
// (the stem and layer1 of ResNet18); dX also needs N <= 64 (one slab).
namespace {

constexpr int kResKpCluster = 64;  // dX's resident rhs: one slab

template <int BN, class A, class B, bool kShareB>
struct ClusterLayout {
  static constexpr bool kResB = !kShareB;
  static constexpr int kStage =
      (A::kStageBytes + (kResB ? 0 : B::kStageBytes) + 1023) / 1024 * 1024;
  static constexpr int kBf16 = (kBM + (kResB ? 0 : BN)) * kBK * 2;  // one
  static constexpr int kRes = kResB ? kResKpCluster * BN * 2 : 0;
  static_assert(B::kStageBytes <= kStage, "the rhs is staged in stage 0");
  static constexpr int kFixed = 2 * kBf16 + kRes + 8 * 8 + 1024;
  static constexpr int kFit = (kSmemMax - kFixed) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBytes = kStages * kStage + kFixed;
  static_assert(kStages >= 2, "a slab in flight while one converts");
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address of shared byte `addr` of this CTA in the CTA of `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t a,
                                           uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile(
      "st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(a), "r"(b), "r"(c), "r"(d)
      : "memory");
}

// F32Op::convert's values, unstored.
template <int X>
__device__ __forceinline__ void convert_values(const F32Op<X>& op,
                                               const float* raw, int u,
                                               float (&v)[mx::kBlock]) {
  const int x = u % X, kb = u / X;
  uint32_t bits[mx::kBlock];
  if (op.inner_k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(
          raw + F32Op<X>::at(X, x, mx::kBlock * kb + 4 * q));
      bits[4 * q] = __float_as_uint(f.x);
      bits[4 * q + 1] = __float_as_uint(f.y);
      bits[4 * q + 2] = __float_as_uint(f.z);
      bits[4 * q + 3] = __float_as_uint(f.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < mx::kBlock; ++j) {
      bits[j] = __float_as_uint(raw[F32Op<X>::at(kBK, mx::kBlock * kb + j,
                                                 x)]);
    }
  }
  float q[mx::kBlock];
  int e;
  uint32_t packed;
  mx::quantize_block_f(bits, op.mb, q, e, packed);
  mx::dequantize_block_f(q, e, packed, op.mb, v);
}

// store_bf16 into the same buffer of every CTA of the cluster.
template <int X>
__device__ __forceinline__ void store_bf16_peers(uint32_t buf, int x, int kb,
                                                 const float (&v)[mx::kBlock],
                                                 int ctas) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = __byte_perm(__float_as_uint(v[2 * i]),
                       __float_as_uint(v[2 * i + 1]), 0x7632);
  }
  const uint32_t p = buf + (kb * (X / 8) + x / 8) * 256 + (x % 8) * 16;
  for (int r = 0; r < ctas; ++r) {
    st_cluster(map_rank(p, r), w[0], w[1], w[2], w[3]);
    st_cluster(map_rank(p + 128, r), w[4], w[5], w[6], w[7]);
  }
}

struct GroupCursor {
  int group, s, k0, hi, m0, n0;
};

// One GEMM of the pair; a cluster walks groups cluster, cluster + count,
// ..., a group being (chunk s, the shared tile row or column), its CTA of
// rank r on tile column r (dX) or tile row r (dW).
template <int BN, class A, class B, bool kShareB>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_kernel(const __grid_constant__ Gemm<BN, A, B> g) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  using L = ClusterLayout<BN, A, B, kShareB>;
  constexpr bool kResB = L::kResB;
  constexpr int S = L::kStages;
  constexpr int kAcc = BN / 4;
  constexpr int kShared = (kShareB ? BN : kBM) * kKB;  // units a slab
  constexpr int kOwn = kShareB ? kBM * kKB : 0;
  const int ctas = (int)cluster_ctas(), rank = (int)cluster_rank();
  const int first = (int)cluster_index(), stride = (int)cluster_count();
  const int tiles_m = g.tiles / g.tiles_n;
  const int per_split = kShareB ? g.tiles_n : tiles_m;
  const int groups = per_split * g.split;
  const int lo = kShared * rank / ctas, hi = kShared * (rank + 1) / ctas;
  const int work = kOwn + hi - lo;

  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* abuf =
      reinterpret_cast<__nv_bfloat16*>(smem + S * L::kStage);
  __nv_bfloat16* bres = abuf + L::kBf16;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S * L::kStage +
                                               2 * L::kBf16 + L::kRes);
  const int wm = threadIdx.x / 128 % 2, wn = threadIdx.x / 256;
  if (threadIdx.x == 0) {
    for (int s = 0; s <= S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every peer runs before a store reaches its memory
  if constexpr (kResB) {
    const int n0 = rank * BN;  // this CTA's tile column, every unit
    for (int k0 = 0, r = 0; k0 < g.kp; k0 += kBK, ++r) {
      if (threadIdx.x == 0) {
        fence_proxy_async();
        mbar_expect_tx(&bars[S], g.b.tma_bytes());
      }
      g.b.load(smem, n0, k0, &bars[S]);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(&bars[S], r & 1);
      __syncthreads();
      for (int u = threadIdx.x; u < BN * kKB; u += kThreads) {
        if (k0 + mx::kBlock * (u / BN) < g.kp) {
          g.b.convert(smem, n0, k0, u,
                      bres + (k0 / mx::kBlock) * (BN / 8) * 128);
        }
      }
      __syncthreads();
    }
  }

  auto begin = [&](GroupCursor& cur, int group) {
    cur.group = group;
    const int s = group / per_split, t = group - s * per_split;
    const int tm = kShareB ? rank : t, tn = kShareB ? t : rank;
    cur.s = s;
    cur.k0 = s * g.chunk;
    cur.hi = min(g.kp, cur.k0 + g.chunk);
    cur.m0 = tm * kBM;
    cur.n0 = tn * BN;
  };
  auto next = [&](GroupCursor& cur) {
    cur.k0 += kBK;
    if (cur.k0 >= cur.hi) begin(cur, cur.group + stride);
  };
  auto issue = [&](const GroupCursor& cur, int stage) {
    uint8_t* st = smem + stage * L::kStage;
    if (threadIdx.x == 0) {
      fence_proxy_async();
      mbar_expect_tx(&bars[stage],
                     g.a.tma_bytes() + (kResB ? 0u : g.b.tma_bytes()));
    }
    g.a.load(st, cur.m0, cur.k0, &bars[stage]);
    if (!kResB) g.b.load(st + A::kStageBytes, cur.n0, cur.k0, &bars[stage]);
  };

  GroupCursor prod, cons;
  begin(prod, first);
  begin(cons, first);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (prod.group < groups) {
      issue(prod, s);
      next(prod);
    }
    cp_async_commit();
  }
  float acc[kAcc], total[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = total[i] = 0.0f;
  int ps = S - 1, cs = 0;
  uint32_t phase = 0;
  GroupCursor pend = cons;
  bool pend_last = false;

  auto settle = [&]() {
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) total[i] += acc[i];
    if (pend_last) {
      float* out =
          g.split > 1 ? g.ws + (long long)pend.s * g.M * g.N : g.c;
      store_tile<BN>(total, out, g.M, g.N, pend.m0, pend.n0);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) total[i] = 0.0f;
    }
  };

  for (int slab = 0; cons.group < groups; ++slab) {
    if (prod.group < groups) {
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
    for (int j = threadIdx.x; j < work; j += kThreads) {
      float v[mx::kBlock];
      if (j < kOwn) {
        g.a.convert(st, cons.m0, cons.k0, j, a16);
      } else if constexpr (kShareB) {
        const int u = lo + j - kOwn;
        convert_values(g.b, reinterpret_cast<const float*>(
                                st + A::kStageBytes), u, v);
        store_bf16_peers<BN>(smem_u32(b16), u % BN, u / BN, v, ctas);
      } else {
        const int u = lo + j - kOwn;
        convert_values(g.a, reinterpret_cast<const float*>(st), u, v);
        store_bf16_peers<kBM>(smem_u32(a16), u % kBM, u / kBM, v, ctas);
      }
    }
    settle();        // this CTA's wgmmas of the slab before
    cluster_sync();  // every CTA's slab converted, its last wgmmas done
    // The peers' stores, acquired, before this CTA's wgmmas read them (a
    // proxy fence on the writers' side, .shared::cluster or generic, makes
    // ptxas 12 crash).
    fence_proxy_async();
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
  cluster_sync();  // no peer stores into this CTA once it exits
}

template <bool kShareB, int BN, class A, class B>
int launch_cluster(const Gemm<BN, A, B>& g, cudaStream_t s) {
  if (empty(g, s)) return (int)cudaGetLastError();
  using L = ClusterLayout<BN, A, B, kShareB>;
  const int tiles_m = g.tiles / g.tiles_n;
  const int ctas = kShareB ? tiles_m : g.tiles_n;
  if (ctas > 8 || (!kShareB && (g.split != 1 || g.kp > kResKpCluster))) {
    return (int)cudaErrorInvalidValue;
  }
  const int groups = g.units / ctas;
  auto kernel = cluster_kernel<BN, A, B, kShareB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int most = 0;
  e = cudaOccupancyMaxActiveClusters(&most, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (most < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(min(groups, most) * ctas);
  e = cudaLaunchKernelEx(&cfg, kernel, g);
  if (e != cudaSuccess) return (int)e;
  launch_reduce(g, s);
  return (int)cudaGetLastError();
}

}  // namespace

// g [M, N], x [M, K], w [K, N] fp32 row-major -> dx [M, K] (where parts
// has bit 0), dw [K, N] (bit 1), with mx_gemm_bwd_pair's splits; N <= 64
// and K > 64 (the stem, layer1).
extern "C" int mx_gemm_pair_cluster(const void* g, const void* x,
                                    const void* w, int mb, int parts,
                                    void* dx, void* dw,
                                    int M, int N, int K, int split_dx,
                                    int chunk_dx, void* ws_dx, int split_dw,
                                    int chunk_dw, void* ws_dw, void* stream) {
  auto round = [](int n, int to) { return (n + to - 1) / to * to; };
  cudaStream_t s = (cudaStream_t)stream;
  if (!narrow(N) || narrow(K)) return (int)cudaErrorInvalidValue;
  // dX = fused(g, w^T): g (m, n) at g[m N + n], w^T (n, k) at w[k N + n].
  const auto gx = make_gemm<128>(f32_op<kBM>(g, N, 1, M, N, mb),
                                 f32_op<128>(w, N, 1, K, N, mb), dx, M, K,
                                 round(N, mx::kBlock), split_dx, chunk_dx,
                                 ws_dx);
  // dW = fused(x^T, g): x^T (k, m) at x[m K + k], g (m, n) at g[m N + n].
  const auto gw = make_gemm<64>(f32_op<kBM>(x, 1, K, K, M, mb),
                                f32_op<64>(g, 1, N, N, M, mb), dw, K, N,
                                round(M, mx::kBlock), split_dw, chunk_dw,
                                ws_dw);
  const int e = parts & 1 ? launch_cluster<false>(gx, s) : 0;
  if (e != 0 || !(parts & 2)) return e;
  return launch_cluster<true>(gw, s);
}
