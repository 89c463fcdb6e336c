// Two-segment decode attention on Hopper (sm_90a): one query token per row
// against [frozen cache keys < cache_len[b] | tail keys < tail_len[b]] in one
// softmax, grouped-query (G = H / KV query heads per KV head).
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/decode_attention.py::decode_attention
// (body `kernel_body`) and carries the same math as the serving programs' XLA
// attention, s2s_tpu/parallel/batched_decode.py::_concat_attention:
//   s = (q . k) in f32, times scale;  p = softmax(s) over the valid keys of both
//   segments, in f32;  p rounded to the K/V element type;  out = sum p * v
//   accumulated in f32 and rounded once to the element type.
// The Pallas contract (write the new K/V slot at `pos`, attend keys <= pos) is
// this kernel with cache_len = pos and a one-key tail holding the new slot
// (s2s_tpu_torch/ops/decode_attention.py::decode_attention).
//
// What bounds it: every row reads its valid K and V rows once (2 * keys * hd
// * 2 bytes per KV head in bf16) for ~4 * G * hd flops per key, far below the
// card's ~295 flops per byte, so the bytes of the valid keys bound it, and at
// the serving path's small batches the latency of the copies: 128 (row, KV
// head) pairs at the LM's 4 slots, 8 for the talker at one.
//
// How the design answers that:
// - One thread-block cluster of C CTAs per (row, KV head); C in {1, 2, 4, 8}
//   is one value for the launch, chosen by the wrapper so that the grid fills
//   the card and a CTA's keys fit half an SM's shared memory, two CTAs per SM
//   (ops/decode_attention.py::launch_plan, which also lays out the shared
//   memory and passes the layout in). CTA r takes keys
//   [r * ceil(nk / C), min(nk, (r + 1) * ceil(nk / C))) of its row's nk =
//   cache_len + tail_len: the ranges depend on nk and C alone, so rows with
//   equal inputs give bit-equal outputs (the gathered programs pad a width
//   bucket with duplicate rows and rely on that).
// - One thread copies the CTA's slice of K and of V into shared memory with
//   1-D bulk async copies (cp.async.bulk, at most two segments per tile:
//   cache rows, then tail rows, each contiguous in the (B, KV, T, hd)
//   layout), K's and V's issued together, so V arrives while the scores and
//   the softmax run. Only valid keys are read. Where the slice fits (every
//   shape of the serving defaults) it is one tile on one mbarrier per
//   tensor; where it does not (the talker or Qwen3-1.7B near their
//   max_seq_len), it streams through a ring of `stages` tiles of 64 keys per
//   tensor, each stage refilled as soon as the CTA has read it. Only the
//   f32 scores of the CTA's keys stay resident.
// - Scores from shared memory with 16-byte loads: a key row's hd elements
//   spread over hd * size / 16 lanes (8 for bf16 hd 64, 16 for hd 128), so a
//   warp scores 4 or 2 keys per step and reduces over 3 or 4 shuffles; the
//   group's G queries sit in registers, each K row serves all G heads.
// - Exact softmax in one launch: each CTA takes its max m_r and sum l_r =
//   sum exp(s - m_r) (the exponentials and, below, the divisions spread over
//   all its threads); the cluster exchanges them through distributed shared
//   memory (barrier.cluster); every CTA forms m = max m_r, l = sum l_r *
//   exp(m_r - m), then p = exp(s - m) / l rounded to the element type, and
//   accumulates its partial PV in f32; after a second cluster barrier rank 0
//   sums the C partials in rank order and writes the row's output; a third
//   barrier keeps every CTA's shared memory alive until rank 0 has read it.
//   Sums run in a fixed order with no atomics: the same bits on every run.
// - A row with no valid key writes zeros (the plain PyTorch version returns
//   the mean of all keys there, as JAX's masked softmax does); the serving
//   programs never make such a row. A CTA with an empty range contributes
//   m = -inf and l = 0.
// - Tried on the card and dropped: a running (m, l) kept while scoring, with p
//   formed inside the PV loop, fewer barriers but the exponentials and
//   divisions on a few lanes of each warp: slower at every shape.
//
// The earlier design (one 1024-thread block per (row, KV head), one key row per
// warp step with a 5-shuffle sum per key and query head, two-pass softmax with
// V read after every score): 22.1 us at the LM steady chunk (B 4, n 6, T 512)
// against a 2.99 us bound and SDPA's 16.0 (H100 80GB HBM3, 700 W, PERF.md).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16 bytes at p as E f32 values (E = 8 for bf16, 4 for f32).
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from global src to this CTA's shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Fold the softmax statistics (mo, lo) of other keys into (m, l): the max and
// the sum of exp(s - max) over both sets; a set with no key has m = -inf.
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + (mo == -INFINITY ? 0.f : lo * expf(mo - mn));
  m = mn;
}

// The launch plan the wrapper makes (ops/decode_attention.py::launch_plan):
// how many keys a CTA holds, how they are staged, and where each region of
// its dynamic shared memory starts.
struct Plan {
  int rows_max;   // keys per CTA at most: ceil((T + n) / C)
  int tile_rows;  // keys per staged K (and V) tile
  int stages;     // tiles of K, and of V, in flight; 2 * stages mbarriers at byte 0
  // byte offsets: part, this CTA's partial PV, f32 [G][hd]; stat, this CTA's
  // m[8], l[8], then the cluster's m[8], l[8]; red, per-warp sums, f32
  // [kWarps][G][hd]; sc, scores then p, f32 [G][rows_max rounded up to 4];
  // k and v, the rings of `stages` tiles of tile_rows K and V rows; bytes,
  // the total
  int part, stat, red, sc, k, v, bytes;
};

template <typename T, int HD>
struct TileCopy {
  // Issues the copies of this CTA's keys [a, z) (row-relative, cache keys
  // first) of one tensor into dst, completing on bar: at most two bulk copies,
  // the cache rows [a, min(z, clen)) and the tail rows after them.
  const T* cache;
  const T* tail;
  size_t cache_row0, tail_row0;  // the (row, KV head)'s first row in each tensor
  int clen;
  __device__ __forceinline__ void operator()(uint32_t dst, uint32_t bar, int a, int z) const {
    constexpr uint32_t RB = HD * sizeof(T);
    const int c_rows = max(0, min(z, clen) - a);
    const int t0 = max(a, clen) - clen, t_rows = z - a - c_rows;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"((z - a) * RB) : "memory");
    if (c_rows > 0) bulk_copy(dst, cache + (cache_row0 + a) * HD, c_rows * RB, bar);
    if (t_rows > 0) bulk_copy(dst + c_rows * RB, tail + (tail_row0 + t0) * HD, t_rows * RB, bar);
  }
};

template <typename T, int HD, int MG>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ ck, const T* __restrict__ cv,
                        const T* __restrict__ tk, const T* __restrict__ tv, const int* __restrict__ cache_len,
                        const int* __restrict__ tail_len, T* __restrict__ out, int H, int KV, int Tc, int n,
                        const Plan plan, float scale) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = HD / E;        // lanes per key row
  constexpr int RPW = 32 / LPR;      // key rows per warp step
  constexpr int RB = HD * sizeof(T); // bytes per key row
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int kv = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR, rg = lane / LPR;  // 16-byte column, row within the warp step

  const int clen = min(max(cache_len[b], 0), Tc);
  const int tlen = min(max(tail_len[b], 0), n);
  const int nk = clen + tlen;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G;
  if (nk == 0) {  // the same for every CTA of the cluster: no barrier is skipped by only some
    if (rank == 0)
      for (int i = tid; i < G * HD; i += kThreads) out[head0 * HD + i] = from_f32<T>(0.f);
    return;
  }
  const int chunk = (nk + C - 1) / C;
  const int j0 = min(nk, rank * chunk), j1 = min(nk, j0 + chunk);
  const int rows = j1 - j0;
  const int R = plan.tile_rows, S = plan.stages;
  const int tiles = (rows + R - 1) / R;

  extern __shared__ __align__(16) uint8_t smem[];
  float* part = reinterpret_cast<float*>(smem + plan.part);
  float* stat = reinterpret_cast<float*>(smem + plan.stat);
  float* red = reinterpret_cast<float*>(smem + plan.red);
  float* sc = reinterpret_cast<float*>(smem + plan.sc);
  const T* ks = reinterpret_cast<const T*>(smem + plan.k);
  const T* vs = reinterpret_cast<const T*>(smem + plan.v);
  const int rows4 = (plan.rows_max + 3) & ~3;
  const uint32_t bars = smem_u32(smem);  // K's full barriers, then V's
  auto kbar = [&](int s) { return bars + 8u * s; };
  auto vbar = [&](int s) { return bars + 8u * (S + s); };
  const size_t bk = static_cast<size_t>(b) * KV + kv;
  const TileCopy<T, HD> copy_k{ck, tk, bk * Tc, bk * n, clen};
  const TileCopy<T, HD> copy_v{cv, tv, bk * Tc, bk * n, clen};
  // tile t of the CTA's keys into its stage of a ring at `ring`
  auto issue = [&](const TileCopy<T, HD>& copy, uint32_t ring, uint32_t bar, int t) {
    copy(ring + static_cast<uint32_t>((t % S) * R * RB), bar, j0 + t * R, j0 + min(rows, (t + 1) * R));
  };

  if (tid == 0) {
    for (int s = 0; s < 2 * S; ++s) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bars + 8u * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // the first tiles of K, then of V: V arrives while the scores and the softmax run
    for (int t = 0; t < min(S, tiles); ++t) issue(copy_k, smem_u32(ks), kbar(t), t);
    for (int t = 0; t < min(S, tiles); ++t) issue(copy_v, smem_u32(vs), vbar(t), t);
  }

  // this lane's 16-byte column of the group's G queries, in f32
  float qr[MG][E];
#pragma unroll
  for (int g = 0; g < MG; ++g)
    if (g < G) load16(q + (head0 + g) * HD + sub * E, qr[g]);

  // pass 1: scores of the CTA's keys for the G query heads, and their max
  float mloc[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) mloc[g] = -INFINITY;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % S, base = t * R, cnt = min(R, rows - base);
    mbar_wait(kbar(s), (t / S) & 1);
    const T* kt = ks + static_cast<size_t>(s) * R * HD;
    for (int jb = warp * RPW; jb < cnt; jb += kWarps * RPW) {  // the same trip count across the warp
      const int j = jb + rg;
      float kf[E];
      if (j < cnt) {
        load16(kt + j * HD + sub * E, kf);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          float sg = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) sg = fmaf(qr[g][e], kf[e], sg);
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1) sg += __shfl_xor_sync(0xffffffffu, sg, off);
          sg *= scale;
          if (sub == 0 && j < cnt) {
            sc[g * rows4 + base + j] = sg;
            mloc[g] = fmaxf(mloc[g], sg);
          }
        }
      }
    }
    if (t + S < tiles) {  // the stage is read: refill it with the tile S ahead
      __syncthreads();
      if (tid == 0) issue(copy_k, smem_u32(ks), kbar(s), t + S);
    }
  }
  // the CTA's max per head: lanes, then warps in order
#pragma unroll
  for (int g = 0; g < MG; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mloc[g] = fmaxf(mloc[g], __shfl_xor_sync(0xffffffffu, mloc[g], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) red[warp * MG + g] = mloc[g];
  }
  __syncthreads();
  if (tid < G) {
    float mc = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mc = fmaxf(mc, red[w * MG + tid]);
    stat[tid] = mc;
  }
  __syncthreads();
  // the CTA's sum l_r = sum exp(s - m_r), every thread over its share of the keys
  float lsum[MG];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    lsum[g] = 0.f;
    if (g < G) {
      const float mc = stat[g];
      for (int j = tid; j < rows; j += kThreads) lsum[g] += expf(sc[g * rows4 + j] - mc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) red[(kWarps + warp) * MG + g] = lsum[g];
  }
  __syncthreads();
  if (tid < G) {
    float lc = 0.f;
    for (int w = 0; w < kWarps; ++w) lc += red[(kWarps + w) * MG + tid];
    stat[kMaxGroup + tid] = lc;
  }

  // exchange (m_r, l_r) across the cluster; every CTA forms the global m, l
  cluster.sync();
  float* glob = stat + 2 * kMaxGroup;
  if (tid < G) {
    float mr[kMaxCluster], lr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < C) {
        const float* st = cluster.map_shared_rank(stat, r);
        mr[r] = st[tid];
        lr[r] = st[kMaxGroup + tid];
      }
    }
    float mg = -INFINITY, lg = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) merge_stats(mg, lg, mr[r], lr[r]);
    glob[tid] = mg;
    glob[kMaxGroup + tid] = lg;
  }
  __syncthreads();

  // p = exp(s - m) / l, rounded to the element type
  for (int i = tid; i < G * rows; i += kThreads) {
    const int g = i / rows, j = i - g * rows;
    float* sp = sc + g * rows4 + j;
    *sp = to_f32(from_f32<T>(expf(*sp - glob[g]) / glob[kMaxGroup + g]));
  }
  __syncthreads();

  // pass 2: this CTA's partial sum_j p_j * v_j in f32
  float acc[MG][E];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  for (int t = 0; t < tiles; ++t) {
    const int s = t % S, base = t * R, cnt = min(R, rows - base);
    mbar_wait(vbar(s), (t / S) & 1);
    const T* vt = vs + static_cast<size_t>(s) * R * HD;
    for (int j = warp * RPW + rg; j < cnt; j += kWarps * RPW) {
      float vf[E];
      load16(vt + j * HD + sub * E, vf);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const float p = sc[g * rows4 + base + j];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    if (t + S < tiles) {
      __syncthreads();
      if (tid == 0) issue(copy_v, smem_u32(vs), vbar(s), t + S);
    }
  }
  // sum the warp's row groups (lanes LPR apart), then the warps in order
#pragma unroll
  for (int g = 0; g < MG; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < E; ++e) red[(warp * G + g) * HD + sub * E + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * G * HD + i];
    part[i] = sum;
  }

  // rank 0 sums the C partials in rank order and writes the row's output
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < G * HD; i += kThreads) {
      float v[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < C) v[r] = cluster.map_shared_rank(part, r)[i];
      float sum = v[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < C) sum += v[r];
      out[head0 * HD + i] = from_f32<T>(sum);
    }
  }
  cluster.sync();  // every CTA's partial stays readable until rank 0 is done
}

constexpr int kMaxDevices = 64;

// Whether `plan`'s regions lie in order, each large enough, within its bytes.
bool plan_fits(const Plan& p, int G, int HD, int esize) {
  const long long ring = static_cast<long long>(p.stages) * p.tile_rows * HD * esize;
  return p.rows_max >= 1 && p.tile_rows >= 1 && p.stages >= 1 && p.part >= 16 * p.stages &&
         p.stat >= p.part + 4LL * G * HD && p.red >= p.stat + 16LL * kMaxGroup &&
         p.sc >= p.red + 4LL * kWarps * G * HD && p.k >= p.sc + 4LL * G * ((p.rows_max + 3) & ~3) &&
         p.v >= p.k + ring && p.bytes >= p.v + ring &&
         (p.part | p.stat | p.red | p.sc | p.k | p.v) % 16 == 0 && (p.tile_rows * HD * esize) % 16 == 0;
}

template <typename T, int HD, int MG>
int launch(const void* q, const void* ck, const void* cv, const void* tk, const void* tv, const int* cache_len,
           const int* tail_len, void* out, int B, int H, int KV, int Tc, int n, int C, const Plan& plan,
           float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, HD, MG>;
  // the largest dynamic shared memory already allowed for this kernel, per
  // device: a steady-state call only launches
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (plan.bytes > 48 * 1024 && plan.bytes > allowed[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int seen = allowed[dev].load(std::memory_order_relaxed);
    while (seen < plan.bytes && !allowed[dev].compare_exchange_weak(seen, plan.bytes)) {
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = plan.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(ck),
                           static_cast<const T*>(cv), static_cast<const T*>(tk), static_cast<const T*>(tv), cache_len,
                           tail_len, static_cast<T*>(out), H, KV, Tc, n, plan, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_group(const void* q, const void* ck, const void* cv, const void* tk, const void* tv, const int* cl,
                   const int* tl, void* out, int B, int H, int KV, int Tc, int n, int C, const Plan& p,
                   float scale, cudaStream_t st) {
  const int G = H / KV;
  if (G == 1) return launch<T, HD, 1>(q, ck, cv, tk, tv, cl, tl, out, B, H, KV, Tc, n, C, p, scale, st);
  if (G == 2) return launch<T, HD, 2>(q, ck, cv, tk, tv, cl, tl, out, B, H, KV, Tc, n, C, p, scale, st);
  if (G <= 4) return launch<T, HD, 4>(q, ck, cv, tk, tv, cl, tl, out, B, H, KV, Tc, n, C, p, scale, st);
  return launch<T, HD, 8>(q, ck, cv, tk, tv, cl, tl, out, B, H, KV, Tc, n, C, p, scale, st);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* ck, const void* cv, const void* tk, const void* tv, const int* cl,
                const int* tl, void* out, int B, int H, int KV, int Tc, int n, int C, const Plan& p, float scale,
                cudaStream_t st) {
  if (hd == 64) return dispatch_group<T, 64>(q, ck, cv, tk, tv, cl, tl, out, B, H, KV, Tc, n, C, p, scale, st);
  if (hd == 128) return dispatch_group<T, 128>(q, ck, cv, tk, tv, cl, tl, out, B, H, KV, Tc, n, C, p, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point, bound with ctypes. q (B, H, hd); ck/cv (B, KV, T, hd); tk/tv
// (B, KV, n, hd); out (B, H, hd), all contiguous and of one element type
// (dtype 0: bf16, 1: f32), K/V 16-byte aligned; cache_len / tail_len (B,)
// int32 on the device; `plan` the wrapper's launch plan, 11 ints: the cluster
// size C (CTAs per (row, KV head), one of 1, 2, 4, 8), then Plan's fields in
// order. Shapes are checked by the Python wrapper
// (s2s_tpu_torch/ops/decode_attention.py): hd in {64, 128}, H % KV == 0,
// H / KV <= 8. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a plan whose regions do not hold the keys it gives a CTA).
extern "C" int s2s_decode_attention(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                                    const void* cache_len, const void* tail_len, void* out, int B, int H, int KV,
                                    int T, int n, int hd, int dtype, float scale, const int* plan, void* stream) {
  const int C = plan[0];
  const Plan p{plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7], plan[8], plan[9], plan[10]};
  const int esize = dtype == 0 ? 2 : 4;
  if (KV < 1 || H % KV != 0 || H / KV > kMaxGroup || B < 1 || B > 65535 || KV > 65535 || T + n < 1 ||
      (C != 1 && C != 2 && C != 4 && C != kMaxCluster) || p.rows_max < (T + n + C - 1) / C ||
      !plan_fits(p, H / KV, hd, esize))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* cl = static_cast<const int*>(cache_len);
  const auto* tl = static_cast<const int*>(tail_len);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<__nv_bfloat16>(hd, q, ck, cv, tk, tv, cl, tl, out, B, H, KV, T, n, C, p, scale, st);
  if (dtype == 1) return dispatch_hd<float>(hd, q, ck, cv, tk, tv, cl, tl, out, B, H, KV, T, n, C, p, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory one block of `device` may opt in to
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), which the wrapper plans
// against; a negative cudaError_t when the query fails.
extern "C" int s2s_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}
