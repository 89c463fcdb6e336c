// Weight-only matmul on Hopper (sm_90a): the one template behind
// csrc/int8_matmul.cu (W8A16) and csrc/int4_matmul.cu (packed W4A16).
//
//   out (B, N) bf16 = (x (B, K) bf16 @ W (K, N)) * scale (N,) f32
//
// with W read as stored: int8 (K, N), or packed int4 (K/2, N) whose row k
// holds W[k] in its low nibble and W[k + K/2] in its high nibble. The two
// formats differ only in the unpack step (Int8Weights, Int4Weights below):
// a format has P "planes", the weight rows one stored row carries (1 for
// int8, 2 for int4), and plane p of stored row j pairs with x[:, p * K / P +
// j]. Numerics in both regimes: int8 values and int4 nibbles are exact in
// bf16 and f32, bf16 x bf16 products are exact in f32, sums run in f32, the
// scale is applied once in f32 and the result is rounded once to bf16. Sums
// run in a fixed order with no atomics: the same inputs give the same bits.
//
// Both regimes split K over a thread-block cluster of C CTAs (launched with
// cudaLaunchKernelEx and a cluster dimension) and finish in the one launch:
// CTA r of a cluster takes the whole 64-row tiles [r * T / C, (r + 1) * T /
// C) of the T tiles of the K / P stored rows, of one column tile of TN
// columns; it sums its f32 partial tile in its
// shared memory and pushes each 1/C slice of it, through distributed shared
// memory, to the CTA that finishes that slice; after one cluster barrier
// every CTA sums the C partials of its slice in rank order, applies the
// scale and writes bf16 (see the combine below). The wrapper allocates only
// the output.
// The weight streams through a ring of shared-memory stages of 64 stored
// rows x TN bytes, each a TMA box (cp.async.bulk.tensor.2d) that one
// producer thread issues and an mbarrier completes; the consumers release a
// stage on another mbarrier. The launch plan (regime, TN, C, stages, row
// tile, shared bytes) comes from the wrapper
// (s2s_tpu_torch/ops/weight_only.py::launch_plan); the kernel derives its
// shared-memory layout from it and refuses a plan whose bytes do not hold it.
// A CTA takes more than half an SM's shared memory, so one CTA holds an SM,
// and the plan keeps the grid within the clusters the card runs at once
// (an H100 runs 15 clusters of 8, 17 of 6, 30 of 4, not 132 / C: a grid past
// that runs in two waves); C is any of 1-8, so a 2048-column layer can take
// 96 SMs (16 tiles x 6) where powers of two gave 64. The launch is a
// programmatic dependent launch: its CTAs may start while the kernel before
// it drains, and wait (griddepcontrol.wait) before they touch global memory.
//
// Regime 0, CUDA cores (B below the plan's cutoff, 5 rows for int8 and 3
// for int4: every single-session decode step, and the 4-session int8
// ones): bound by the weight bytes (K * N / P bytes
// over 3.35 TB/s) and, at 1-4 MB layers, by a launch's fixed latency (the
// first box's round trip, the cluster barriers, the combine). 8 consumer
// warps and a producer warp per CTA; the stages keep about 48 KB of weight
// in flight per SM. Each CTA copies its x slice (RB rows, both planes for
// int4) and its scales into shared memory once. Each consumer thread reads
// 16 weight bytes (16 columns of one stored row) per step, unpacks them with
// integer tricks (int8: a byte permute into a magic-number float; int4:
// shift and lop3 into one) and accumulates RB rows x 16 columns in f32
// registers: at 4 rows the FMAs and the unpack, not the bytes, set the
// loop's time. Lanes that share columns are summed by shuffles, the 8 warps
// in order through shared memory, then the cluster.
//
// Regime 1, tensor cores (from the cutoff to 64 rows): wgmma.mma_async
// m64n128k16, bf16 in, f32 out. A is the x tile, a TMA box of 64 rows x 64
// columns with 128-byte swizzle (rows past B zero-filled by TMA), one box
// per plane per stage. B is the weight tile: the stage's int8 box is
// converted (an int4 box unpacked into two) to bf16 with integer tricks and
// stored in the 128-byte swizzled (K, N) layout TMA would give a bf16
// tensor, read MN-major with the transpose bit, as csrc/flash_attention.cu
// reads V. Each weight byte is read from device memory once for all B rows.
// The convert, not the tensor work, bounds the loop, so two consumer
// warpgroups take alternate tiles, each into its own bf16 buffer and its
// own f32 sums: while one converts, the other's products run (one
// warpgroup converting every tile, or two splitting each tile's columns,
// were slower on the card). A warpgroup releases a stage once the products
// that read its x box have completed. The two sums join the cluster's
// combine as two partials per CTA, in a fixed order. One producer warp
// issues the TMA boxes.

#pragma once

#include <atomic>

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace weight_only {

namespace cg = cooperative_groups;

constexpr int kTileK = 64;              // stored weight rows per stage
constexpr int kGemvWarps = 8;           // regime 0 consumer warps
constexpr int kGemvThreads = 32 * (kGemvWarps + 1);
constexpr int kTcGroups = 2;            // regime 1 consumer warpgroups, on alternate tiles
constexpr int kTcTileN = 128;           // regime 1 columns per CTA
constexpr int kTcThreads = 32 * (4 * kTcGroups + 1);  // and a producer warp
constexpr int kXBox = kTileK * 64 * 2;  // one x box: 64 rows x 64 bf16 columns
constexpr int kMaxDevices = 64;

// The wrapper's launch plan: 6 ints, in this order.
struct Plan {
  int regime;   // 0: CUDA cores, 1: tensor cores
  int tile_n;   // columns per CTA (TN)
  int cluster;  // CTAs per column tile, splitting K (C)
  int stages;   // ring depth
  int rows;     // regime 0: row tile RB >= B; regime 1: B rounded up to 8
  int bytes;    // dynamic shared memory of a CTA
};

// Byte offsets from a 1024-byte aligned base of dynamic shared memory, and
// the total a CTA needs (1024 bytes of slack to align the base included).
struct Layout {
  int ring, xs, recv, wb, sc, bars, bytes;
};

// The float4s of the rows x TN outputs that each CTA of a cluster of C
// finishes (the last CTA's slice may be shorter), and the bytes a CTA
// receives for them: `sets` partials from each of the C CTAs.
__host__ __device__ inline int slice4(int rows, int tn, int cluster) { return (rows * tn / 4 + cluster - 1) / cluster; }
__host__ __device__ inline int recv_bytes(int rows, int tn, int cluster, int sets) {
  return sets * cluster * slice4(rows, tn, cluster) * 16;
}

// Regime 0: mbarriers in the first 1024 bytes; the ring (reused for the
// per-warp sums once every stage is read); the x slice, bf16 [P][RB][kc];
// the received partials of this CTA's slice of the outputs; the tile's
// scales, f32 [TN].
__host__ __device__ inline Layout gemv_layout(int tn, int rb, int planes, int kc, int stages, int cluster) {
  Layout l{};
  const int ring = stages * kTileK * tn, red = kGemvWarps * rb * tn * 4;
  l.bars = 0;
  l.ring = 1024;
  l.xs = l.ring + (ring > red ? ring : red);
  l.recv = l.xs + planes * rb * kc * 2;
  l.sc = l.recv + recv_bytes(rb, tn, cluster, 1);
  l.wb = 0;
  l.bytes = l.sc + tn * 4 + 1024;
  return l;
}

// Regime 1: `stages` stages of P x boxes then the weight box (reused for
// the warpgroups' f32 sums [kTcGroups][rows][TN] once every product is
// done); per consumer warpgroup a bf16 weight buffer of P tiles (64 x TN);
// the received partials (two per CTA: one per warpgroup) of this CTA's
// slice of the rows x TN outputs (rows: B rounded up to 8); the tile's
// scales, f32 [TN]; the mbarriers.
__host__ __device__ inline Layout tc_layout(int tn, int planes, int stages, int rows, int cluster) {
  Layout l{};
  const int ring = stages * (planes * kXBox + kTileK * tn), sums = kTcGroups * rows * tn * 4;
  l.ring = 0;
  l.xs = 0;
  l.wb = ring > sums ? ring : sums;
  l.recv = l.wb + kTcGroups * planes * kTileK * tn * 2;
  l.sc = l.recv + recv_bytes(rows, tn, cluster, kTcGroups);
  l.bars = l.sc + tn * 4;
  l.bytes = l.bars + 16 * stages + 1024;
  return l;
}

__host__ __device__ constexpr int tc_stage_bytes(int tn, int planes) { return planes * kXBox + kTileK * tn; }

// CTA r of a cluster of C takes the stored-row tiles [r * T / C, (r + 1) *
// T / C) of the T = rows / kTileK tiles of K: whole tiles, in rank order,
// the counts differing by at most one. Its shared memory is laid out for
// the largest share, tile_rows(rows, C) stored rows.
__host__ __device__ inline int first_tile(int tiles, int cluster, int rank) { return rank * tiles / cluster; }
__host__ __device__ inline int tile_rows(int rows, int cluster) {
  return (rows / kTileK + cluster - 1) / cluster * kTileK;
}

// ---------------------------------------------------------------------------
// the two weight formats
// ---------------------------------------------------------------------------

// int8 (K, N): byte b of a word is column 4 i + b. (b ^ 0x80) placed in the
// low byte of 0x4B000000 is the float 2^23 + 128 + b, exactly.
struct Int8Weights {
  static constexpr int kPlanes = 1;
  __device__ static __forceinline__ void to_f32(const uint4& w, float (&v)[1][16]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = words[i] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[0][4 * i + e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + e)) - 8388736.f;
    }
  }
  // bf16 pairs (columns 2 i, 2 i + 1): the upper halves of the exact floats
  __device__ static __forceinline__ void to_bf16(const uint4& w, uint32_t (&v)[1][8]) {
    float f[1][16];
    to_f32(w, f);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[0][i] = __byte_perm(__float_as_uint(f[0][2 * i]), __float_as_uint(f[0][2 * i + 1]), 0x7632u);
  }
};

// Packed int4 (K/2, N): the low nibble of byte b of a word is plane 0 (row
// j), the high nibble plane 1 (row j + K/2), both signed. n ^ 8 is the
// nibble's value plus 8, in [0, 15]; placed in the mantissa of 2^23
// (0x4B000000) or of 128 in bf16 (0x4300) it is exact, and one subtraction
// takes the offset off.
struct Int4Weights {
  static constexpr int kPlanes = 2;
  __device__ static __forceinline__ void to_f32(const uint4& w, float (&v)[2][16]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = words[i] ^ 0x88888888u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[0][4 * i + e] = __uint_as_float(((u >> (8 * e)) & 0xFu) | 0x4B000000u) - 8388616.f;
        v[1][4 * i + e] = __uint_as_float(((u >> (8 * e + 4)) & 0xFu) | 0x4B000000u) - 8388616.f;
      }
    }
  }
  __device__ static __forceinline__ uint32_t minus8(uint32_t pair) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&pair);
    h = __hsub2(h, __float2bfloat162_rn(136.f));
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static __forceinline__ void to_bf16(const uint4& w, uint32_t (&v)[2][8]) {
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = words[i] ^ 0x88888888u;
      const uint32_t t01 = __byte_perm(u, 0u, 0x4140u);  // bytes 0, 1 in the two bf16 lanes
      const uint32_t t23 = __byte_perm(u, 0u, 0x4342u);
      v[0][2 * i] = minus8((t01 & 0x000F000Fu) | 0x43004300u);
      v[1][2 * i] = minus8(((t01 >> 4) & 0x000F000Fu) | 0x43004300u);
      v[0][2 * i + 1] = minus8((t23 & 0x000F000Fu) | 0x43004300u);
      v[1][2 * i + 1] = minus8(((t23 >> 4) & 0x000F000Fu) | 0x43004300u);
    }
  }
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity. A wait
// that never ends traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map at coordinates {c0 (inner), c1} into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Programmatic dependent launch: the launch may begin while the kernel
// before it on the stream drains; wait here for it to complete (and its
// writes to be visible) before any global memory is touched.
__device__ __forceinline__ void wait_prior_grid() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Barrier over the first `threads` threads of the block (id 0 is __syncthreads').
__device__ __forceinline__ void sync_threads(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory"); }

// Pin registers in place around the asynchronous products, so the compiler
// neither reads an accumulator before its wgmma completes nor moves it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, shared, K-major) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The cluster's combine. Each CTA finishes a slice of slice4() float4s of
// the rows x TN outputs; every CTA pushes each of its partial sums (`sets`
// of them) to the slice's CTA, into slot rank * sets + set of that CTA's
// receive buffer, through distributed shared memory. After one cluster
// barrier each CTA sums its slots in slot order (rank order, then set
// order), applies the scale and writes bf16; no CTA reads another's shared
// memory after the barrier, so none waits for the others to finish. The
// first barrier phase (arrived at, relaxed, at the start) guarantees every
// CTA of the cluster runs before anything is pushed to it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

// Pushes the float2 or float4 `v` at float index e of this CTA's partial
// `set` (of `sets`) of the rows x TN outputs to the CTA that finishes it.
template <typename V>
__device__ __forceinline__ void push(cg::cluster_group& cluster, float* recv, int chunk, int sets, int set, int e,
                                     const V& v) {
  const int e4 = e >> 2, owner = e4 / chunk, rank = static_cast<int>(cluster.block_rank());
  float* dst = cluster.map_shared_rank(recv, owner);
  *reinterpret_cast<V*>(dst + ((rank * sets + set) * chunk + e4 - owner * chunk) * 4 + (e & 3)) = v;
}

template <int TN>
__device__ __forceinline__ void finish(cg::cluster_group& cluster, const float* recv, int chunk, int sets, int rows,
                                       const float* sc, __nv_bfloat16* out, int N, int n0, int nthreads) {
  const int C = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int begin = rank * chunk, end = min(rows * TN / 4, begin + chunk), slots = C * sets;
  const float4* r4 = reinterpret_cast<const float4*>(recv);
  for (int e = begin + static_cast<int>(threadIdx.x); e < end; e += nthreads) {
    float4 s = r4[e - begin];
    for (int q = 1; q < slots; ++q) {
      const float4 v = r4[q * chunk + e - begin];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int r = 4 * e / TN, c = 4 * e % TN;
    const float4 f = *reinterpret_cast<const float4*>(sc + c);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * N + n0 + c);
    o[0] = __floats2bfloat162_rn(s.x * f.x, s.y * f.y);
    o[1] = __floats2bfloat162_rn(s.z * f.z, s.w * f.w);
  }
}

// ---------------------------------------------------------------------------
// regime 0: CUDA cores
// ---------------------------------------------------------------------------

template <class Fmt, int TN, int RB>
__global__ void __launch_bounds__(kGemvThreads, 1)
weight_only_gemv_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int B, int K, int N,
                        int S) {
  constexpr int P = Fmt::kPlanes;
  constexpr int LPR = TN / 16;                   // lanes per stored row: 16 bytes each
  constexpr int RPP = 32 * kGemvWarps / LPR;     // rows per pass of all consumers
  constexpr int PASSES = kTileK / RPP;
  constexpr int kConsumers = 32 * kGemvWarps;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x) / C * TN;
  const int kr = K / P, t0 = first_tile(kr / kTileK, C, rank);
  const int p0 = t0 * kTileK, T = first_tile(kr / kTileK, C, rank + 1) - t0, kc = T * kTileK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const Layout L = gemv_layout(TN, RB, P, tile_rows(kr, C), S, C);
  const uint32_t bars = smem_u32(base);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };
  const uint8_t* ring = base + L.ring;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + L.xs);
  float* red = reinterpret_cast<float*>(base + L.ring);  // the ring, once every stage is read
  float* recv = reinterpret_cast<float*>(base + L.recv);
  float* sc = reinterpret_cast<float*>(base + L.sc);
  const int chunk = slice4(RB, TN, C);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kGemvWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    prefetch_map(&wmap);
  }
  wait_prior_grid();
  __syncthreads();
  cluster_arrive_relaxed();

  if (warp == kGemvWarps) {  // producer warp: one thread issues every weight box
    if (lane == 0) {
      for (int t = 0; t < T; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty(s), ((t / S) + 1) & 1);
        mbar_expect_tx(full(s), kTileK * TN);
        tma_load_2d(smem_u32(ring) + s * kTileK * TN, &wmap, full(s), n0, p0 + t * kTileK);
      }
    }
    __syncwarp();
    cluster_wait();
  } else {
    // the CTA's x slice, rows past B zero: xs[p][r][j] = x[r][p * kr + p0 + j]
    const int vecs = kc / 8;
    for (int i = tid; i < P * RB * vecs; i += kConsumers) {
      const int pr = i / vecs, j = i - pr * vecs, p = pr / RB, r = pr - p * RB;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < B) v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * K + p * kr + p0 + 8 * j);
      reinterpret_cast<uint4*>(xs + static_cast<size_t>(pr) * kc)[j] = v;
    }
    for (int c = tid; c < TN; c += kConsumers) sc[c] = scale[n0 + c];
    sync_threads(1, kConsumers);

    float acc[RB][16];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
    }
    const int g = tid % LPR, rsub = tid / LPR;
    for (int t = 0; t < T; ++t) {
      const int s = t % S;
      mbar_wait(full(s), (t / S) & 1);
      const uint8_t* wt = ring + s * kTileK * TN;
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const int j = pass * RPP + rsub, kk = t * kTileK + j;
        const uint4 w = *reinterpret_cast<const uint4*>(wt + j * TN + 16 * g);
        float wv[P][16];
        Fmt::to_f32(w, wv);
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float xr = __bfloat162float(xs[(p * RB + r) * kc + kk]);
#pragma unroll
            for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(xr, wv[p][c], acc[r][c]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    // lanes LPR apart hold the same columns
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
      }
    }
    sync_threads(1, kConsumers);  // every warp is done with the ring before it holds the sums
    if (lane < LPR) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int c = 0; c < 16; c += 4)
          *reinterpret_cast<float4*>(red + (warp * RB + r) * TN + 16 * g + c) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
      }
    }
    sync_threads(1, kConsumers);
    cluster_wait();
    for (int e = 4 * tid; e < B * TN; e += 4 * kConsumers) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(red + w * RB * TN + e);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      push(cluster, recv, chunk, 1, 0, e, s);
    }
  }
  cluster.sync();
  finish<TN>(cluster, recv, chunk, 1, B, sc, out, N, n0, kGemvThreads);
}

// ---------------------------------------------------------------------------
// regime 1: tensor cores
// ---------------------------------------------------------------------------

template <class Fmt>
__global__ void __launch_bounds__(kTcThreads, 1)
weight_only_tc_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int B, int K, int N,
                      int S, int rows) {
  constexpr int P = Fmt::kPlanes;
  constexpr int TN = kTcTileN;
  constexpr int kStage = tc_stage_bytes(TN, P);
  constexpr int kWTile = kTileK * TN * 2;  // one bf16 weight tile of one plane
  constexpr int G = TN / 16;               // 16-column groups of a stored row
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x) / C * TN;
  const int kr = K / P, t0 = first_tile(kr / kTileK, C, rank);
  const int p0 = t0 * kTileK, T = first_tile(kr / kTileK, C, rank + 1) - t0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, wtid = tid & 127;  // consumer warpgroup (kTcGroups: the producer warp)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const Layout L = tc_layout(TN, P, S, rows, C);
  const uint32_t sbase = smem_u32(base);
  auto xbox = [&](int s, int p) { return sbase + static_cast<uint32_t>(s * kStage + p * kXBox); };
  auto raw = [&](int s) { return base + s * kStage + P * kXBox; };
  auto wtile = [&](int p) { return sbase + static_cast<uint32_t>(L.wb + (wg * P + p) * kWTile); };
  const uint32_t bars = sbase + L.bars;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };
  float* recv = reinterpret_cast<float*>(base + L.recv);
  float* sc = reinterpret_cast<float*>(base + L.sc);
  const int chunk = slice4(rows, TN, C);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // one arrival per warp of the warpgroup that read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    prefetch_map(&wmap);
    prefetch_map(&xmap);
  }
  wait_prior_grid();
  __syncthreads();
  cluster_arrive_relaxed();

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  if (wg == kTcGroups) {  // producer warp: one thread issues every box
    if (lane == 0) {
      for (int t = 0; t < T; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty(s), ((t / S) + 1) & 1);
        mbar_expect_tx(full(s), kStage);
        for (int p = 0; p < P; ++p) tma_load_2d(xbox(s, p), &xmap, full(s), p * kr + p0 + t * kTileK, 0);
        tma_load_2d(smem_u32(raw(s)), &wmap, full(s), n0, p0 + t * kTileK);
      }
    }
    for (int c = lane; c < TN; c += 32) sc[c] = scale[n0 + c];
    __syncwarp();
  } else {
    // warpgroup wg takes tiles wg, wg + kTcGroups, ...: while one converts
    // its tile, the other's products run; each sums into its own partial
    int held = -1;  // the stage this warpgroup's last products read
    for (int t = wg; t < T; t += kTcGroups) {
      const int s = t % S;
      wgmma_wait<0>();  // this warpgroup's last products are done: its buffer and stage are free
      fence_regs(acc);
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(held));
      }
      mbar_wait(full(s), (t / S) & 1);
      // the stage's weight box to bf16, in the 128-byte swizzled (K, N)
      // layout: 64-column boxes of 64 rows x 128 bytes, the 16-byte chunk c
      // of row j stored at chunk c ^ (j % 8)
      const uint8_t* wr = raw(s);
#pragma unroll
      for (int it = 0; it < kTileK * G / 128; ++it) {
        const int q = it * 128 + wtid, j = q / G, g = q % G;
        const uint4 w = *reinterpret_cast<const uint4*>(wr + j * TN + 16 * g);
        uint32_t v[P][8];
        Fmt::to_bf16(w, v);
        const uint32_t c0 = 2 * (g & 3), sw = j & 7;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const uint32_t row = wtile(p) + (g >> 2) * (kTileK * 128) + j * 128;
          st_shared_v4(row + ((c0 ^ sw) << 4), v[p][0], v[p][1], v[p][2], v[p][3]);
          st_shared_v4(row + (((c0 + 1) ^ sw) << 4), v[p][4], v[p][5], v[p][6], v[p][7]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the stores, visible to wgmma
      sync_threads(1 + wg, 128);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk)
          wgmma_n128(acc, sw128_desc(xbox(s, p) + kk * 32, 16, 1024),
                     sw128_desc(wtile(p) + kk * 16 * 128, kTileK * 128, 1024));
      }
      wgmma_commit();
      held = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }
  // the warpgroups' sums to shared memory (the ring: every product is done),
  // then pushed as whole float4s to the CTAs that finish them
  __syncthreads();
  float* sums = reinterpret_cast<float*>(base);
  if (wg < kTcGroups) {
    // accumulator layout: rows r and r + 8 (r = 16 * (warp % 4) + lane / 4),
    // in each 8-column chunk i the columns 8 i + 2 * (lane % 4) + {0, 1}
    float* mine = sums + wg * rows * TN;
    const int r0 = 16 * (warp & 3) + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      if (r0 < B) *reinterpret_cast<float2*>(mine + r0 * TN + 8 * i + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
      if (r0 + 8 < B)
        *reinterpret_cast<float2*>(mine + (r0 + 8) * TN + 8 * i + col) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
  __syncthreads();
  cluster_wait();
  for (int e = 4 * tid; e < B * TN; e += 4 * kTcThreads) {
#pragma unroll
    for (int set = 0; set < kTcGroups; ++set)
      push(cluster, recv, chunk, kTcGroups, set, e, *reinterpret_cast<const float4*>(sums + set * rows * TN + e));
  }
  cluster.sync();
  finish<TN>(cluster, recv, chunk, kTcGroups, B, sc, out, N, n0, kTcThreads);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major (rows, cols) matrix of `type` (esize bytes) as a 2-D tensor
// map {cols, rows} with boxes of box_cols x box_rows, zero fill past each edge.
inline bool matrix_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esize, int rows, int cols,
                       int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt the kernel in to `bytes` of dynamic shared memory once per device.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || bytes <= allowed[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int seen = allowed[dev].load(std::memory_order_relaxed);
  while (seen < bytes && !allowed[dev].compare_exchange_weak(seen, bytes)) {
  }
  return cudaSuccess;
}

template <auto Kernel, typename... Args>
int launch_cluster(const Plan& plan, int grid, int threads, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem<Kernel>(plan.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = plan.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Thread-block clusters of `cluster` CTAs of `bytes` dynamic shared memory
// that the card runs at once (cudaOccupancyMaxActiveClusters), or a negative
// cudaError_t.
template <auto Kernel>
int max_active_clusters(int cluster, int bytes, int threads) {
  cudaError_t err = allow_smem<Kernel>(bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, Kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <class Fmt, int TN>
int run_gemv_rows(const Plan& p, const CUtensorMap& wmap, const __nv_bfloat16* x, const float* scale,
                  __nv_bfloat16* out, int B, int K, int N, cudaStream_t st) {
  const int grid = N / TN * p.cluster;
  switch (p.rows) {
    case 1: return launch_cluster<weight_only_gemv_kernel<Fmt, TN, 1>>(p, grid, kGemvThreads, st, wmap, x, scale, out, B, K, N, p.stages);
    case 2: return launch_cluster<weight_only_gemv_kernel<Fmt, TN, 2>>(p, grid, kGemvThreads, st, wmap, x, scale, out, B, K, N, p.stages);
    case 4: return launch_cluster<weight_only_gemv_kernel<Fmt, TN, 4>>(p, grid, kGemvThreads, st, wmap, x, scale, out, B, K, N, p.stages);
    case 8: return launch_cluster<weight_only_gemv_kernel<Fmt, TN, 8>>(p, grid, kGemvThreads, st, wmap, x, scale, out, B, K, N, p.stages);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Checks the plan against the shapes and runs it. x (B, K) bf16, w (K / P,
// N) int8, scale (N,) f32, out (B, N) bf16, all contiguous; x and w 16-byte
// aligned (checked by the Python wrapper with the shapes). Returns the
// cudaError_t of the launch: cudaErrorInvalidValue for a plan that does not
// fit the shapes or whose bytes do not hold its layout, or a tensor map the
// CUDA driver refuses.
template <class Fmt>
int run(const void* x, const void* w, const void* scale, void* out, int B, int K, int N, const int* plan,
        cudaStream_t st) {
  constexpr int P = Fmt::kPlanes;
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const int C = p.cluster, tn = p.tile_n;
  if (B < 1 || B > 64 || K < 1 || N < 1 || K % P != 0 || (K / P) % kTileK != 0 || C < 1 || C > 8 ||
      C > K / P / kTileK || tn < 64 || N % tn != 0 || p.stages < 1 || p.stages > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = tile_rows(K / P, C);
  if (p.regime == 0) {
    if (B > p.rows || gemv_layout(tn, p.rows, P, kc, p.stages, C).bytes > p.bytes)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (p.regime == 1) {
    if (p.rows < B || p.rows > 64 || p.rows % 8 != 0 || tn != kTcTileN || tc_layout(tn, P, p.stages, p.rows, C).bytes > p.bytes)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap wmap;
  if (!matrix_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / P, N, tn, kTileK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sb = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (p.regime == 0) {
    switch (tn) {
      case 64: return run_gemv_rows<Fmt, 64>(p, wmap, xb, sb, ob, B, K, N, st);
      case 128: return run_gemv_rows<Fmt, 128>(p, wmap, xb, sb, ob, B, K, N, st);
      case 256: return run_gemv_rows<Fmt, 256>(p, wmap, xb, sb, ob, B, K, N, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  CUtensorMap xmap;
  if (!matrix_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, K, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster<weight_only_tc_kernel<Fmt>>(p, N / tn * C, kTcThreads, st, wmap, xmap, sb, ob, B, K, N,
                                                    p.stages, p.rows);
}

}  // namespace weight_only
