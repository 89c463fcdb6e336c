// W8A8 dynamic int8 matmul for decode-shaped linears on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/int8_matmul.py::int8_matmul_dyn
// (body `_kernel_dyn`, with the per-row activation quantize that runs in XLA
// before it): for x (B, K) bf16, q (K, N) int8 and wscale (N,) f32,
//   xscale[b] = max(max_k |x[b, k]| / 127, 1e-12)                  (IEEE division)
//   xq[b, k]  = clip(rint(x[b, k] / xscale[b]), -127, 127)          (IEEE division, half to even)
//   out[b, n] = bf16_rn((f32(sum_k xq[b, k] q[k, n]) * xscale[b]) * wscale[n])
// Every step is exact or correctly rounded in the plain version's order
// (the maxima and the integer sums are exact in any order; division by
// __fdiv_rn, never by a reciprocal; rounding by __float2int_rn; two f32
// multiplies; one rounding), so the output is bit-equal to
// int8_matmul_dyn_reference. The sums stay exact while 127^2 * K < 2^31:
// the entry point refuses K > kMaxK (133,144; `supports` admits K <= 32,768).
//
// Given row_amax (B f32 values, each row's max |x| over a K wider than this
// call's: a row-parallel shard of tensor-parallel serving, where the caller
// reduced the ranks' maxima), the kernel takes those maxima in place of the
// cluster's own: xscale[b] = max(row_amax[b] / 127, 1e-12), the rest as
// above, bit-equal to int8_matmul_dyn_reference given the same maxima. Then
// no CTA reads x for its absmax, pushes it or waits on the cluster before
// its products (every stage is issued at once); the first cluster barrier's
// wait moves to just before the combine's remote stores, which it still
// guards (every CTA of the cluster has started).
//
// What bounds it: B is 8-64 rows on the serving path (fewer take the W8A16
// route), so a call must read the K * N weight bytes once (5.0 us at 2048 x
// 8192 over 3.35 TB/s); x and the output are small beside them, and the int8
// operations (2 B K N) are far below the tensor cores' 1,979 TOP/s. At 1-4 MB
// layers a launch's fixed cost (about 4-5 us for csrc/weight_only_matmul.cuh's
// launches: the first box's round trip, the cluster barriers, the combine)
// weighs as much as the bytes. Fusing the quantize adds work the bound does
// not count: every column tile's CTAs read and quantize their K slice of x
// again (x is read N / 128 times from L2), and the cluster must agree on the
// rows' maxima before the first product.
//
// How the design answers that: one launch a call, csrc/weight_only_matmul.cuh's
// frame (its TMA, mbarrier, cluster and launch helpers; its plan from
// s2s_tpu_torch/ops/weight_only.py::launch_plan, regime 2). K is split over a
// thread-block cluster of C CTAs, each taking whole 128-row K tiles of one
// 128-column tile. A producer warp issues the stages' TMA boxes: the weight's
// (128 K rows x 128 columns) and x's (128 K columns x the padded rows, bf16);
// one stage goes out at once, the rest after the absmax (more stages issued
// first delayed the absmax's loads of x behind them, and the kernel, on the
// card). The consumers take the per-row absmax of the CTA's K slice of x,
// push it to every CTA of the cluster through distributed shared memory, and
// after one cluster barrier each CTA holds the rows' maxima and scales: xq
// and xscale never reach device memory. The quantize divides once per row
// and bf16 significand, not once per element: x = +-2^e (1 + f / 128), and
// fl(x / s) = 2^e fl((1 + f / 128) / s) wherever x / s is a normal float, so
// each CTA fills a table of the 128 quotients per row by IEEE division
// (__fdiv_rn) and an element costs a lookup and a product by an exact power
// of two (elsewhere both sides round to 0; see quantize below). The product
// runs on the int8 tensor cores as out^T = q^T xq^T (swap-AB):
// wgmma.mma_async m64nNk32 .s32.s8.s8, the weight's columns as M (two
// 64-column blocks), the rows of x as N (B rounded up to an s8 N of the PTX
// ISA: 8, 16, 24, 32, 48 or 64, so 8 rows do 8 columns of work), int32 sums
// in registers. Two consumer warpgroups take alternate tiles: each quantizes
// the stage's x box into its K-major B tile (padding rows are TMA's zero
// fill, so they quantize to 0), rewrites the weight box into its K-major A
// tile, releases the stage and issues its 8 products, which run while the
// other warpgroup converts. Each warpgroup's sums go to shared memory; they
// are added and pushed, slice by slice, to the CTA of the cluster that
// finishes the slice (all values loaded before the first remote store, which
// would hold up the loads behind it); after one more cluster barrier each CTA
// adds its C partials (int32, exact), applies the scales and writes bf16. No
// int32 workspace, no second kernel, no atomics; the wrapper allocates only
// the output.
//
// Why the weight is made K-major in shared memory: for 8-bit types wgmma has
// no transpose bit, so both operands must be K-major, and the stored weight
// (K, N) is N-contiguous. Storing it transposed in device memory would give
// the int8 weight a second layout (the W8A16 kernel and the JAX package's
// quantized trees read (K, N); a quantized tree stays bit-equal to the JAX
// package's). In shared memory the rewrite costs each weight byte one 4-byte
// load, half a byte permute and a quarter of a 16-byte store, on threads that
// otherwise wait on the stream: 4 x 4 byte tiles transposed with __byte_perm
// (as the earlier CUDA-core design did in registers), stored in the 128-byte swizzle
// a TMA box of a K-major tensor would have (16-byte chunk c of row n at c ^ (n
// % 8)), fenced for the async proxy (fence.proxy.async) before the products
// read it.

#include "weight_only_matmul.cuh"

namespace w8a8 {

namespace cg = cooperative_groups;
namespace wo = weight_only;

constexpr int kRegime = 2;               // the plan's regime field for this kernel
constexpr int kTileK = 128;              // K per stage: one 128-byte K-major row of int8
constexpr int kTileN = 128;              // weight columns per CTA: two 64-row wgmma M blocks
constexpr int kGroups = 2;               // consumer warpgroups, on alternate tiles
constexpr int kConsumers = 128 * kGroups;
constexpr int kThreads = kConsumers + 32;  // and a producer warp
constexpr int kMaxRows = 64;
constexpr int kMaxK = 133144;            // (2^31 - 1) / 127^2: the int32 sums stay exact
constexpr int kSumStride = kTileN + 4;   // int32 row stride of the summed tile (conflict-free stores)
constexpr int kATile = kTileN * kTileK;  // one K-major weight tile, bytes
constexpr int kSignificands = 128;       // the bf16 significands 1 + f / 128
constexpr int kEarlyStages = 1;          // stages issued before the absmax: more delay its loads of x

__host__ __device__ constexpr int stage_bytes(int rows) { return rows * kTileK * 2 + kTileK * kTileN; }
__host__ __device__ constexpr int round1024(int v) { return (v + 1023) / 1024 * 1024; }

// Byte offsets from a 1024-byte aligned base of dynamic shared memory: the
// ring of stages (an x box of rows x 128 bf16, then the weight box of 128 x
// 128 int8; reused for the warpgroups' int32 sums [kGroups][rows][kSumStride]
// once every stage is read); per warpgroup a K-major weight tile (A) and a K-major xq
// tile (B); the received partials of this CTA's slice of the outputs; the
// partial maxima [C][kMaxRows]; the row scales; the rows' quotient tables
// [rows][kSignificands]; the column scales; the mbarriers; and the total
// with 1024 bytes of alignment slack.
struct Layout {
  int a, b, recv, amax, xs, tab, sc, bars, bytes;
};

__host__ __device__ inline Layout layout(int rows, int stages, int cluster) {
  Layout l{};
  const int ring = stages * stage_bytes(rows), sums = kGroups * rows * kSumStride * 4;
  l.a = round1024(ring > sums ? ring : sums);
  l.b = l.a + kGroups * kATile;
  l.recv = l.b + kGroups * rows * kTileK;
  l.amax = l.recv + wo::recv_bytes(rows, kTileN, cluster, 1);
  l.xs = l.amax + cluster * kMaxRows * 4;
  l.tab = l.xs + kMaxRows * 4;
  l.sc = l.tab + rows * kSignificands * 4;
  l.bars = l.sc + kTileN * 4;
  l.bytes = l.bars + 16 * stages + 1024;
  return l;
}

__host__ __device__ constexpr bool wgmma_rows(int rows) {
  return rows == 8 || rows == 16 || rows == 24 || rows == 32 || rows == 48 || rows == 64;
}

// d (64 x N, s32) += A (64 x 32, s8, shared, K-major) * B (32 x N, s8, shared, K-major)
__device__ __forceinline__ void igmma(int (&d)[4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void igmma(int (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void igmma(int (&d)[12], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void igmma(int (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void igmma(int (&d)[24], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void igmma(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// clip(rint(x / s), -127, 127) for x given as its f32 bit pattern (a bf16
// in the upper half), from the row's table tab[f] = fl((1 + f / 128) / s):
// x = +-2^e (1 + f / 128), and where x / s is a normal float, fl(x / s) =
// 2^e fl((1 + f / 128) / s) exactly (rounding commutes with scaling by a
// power of two), a product by an exact power of two. Where x / s is below
// the normal range (and for zero and subnormal x, whose exponent field
// gives the factor 0) both sides round to 0, since |x / s| < 2^-126.
// |x| <= 127 s, so nothing overflows.
__device__ __forceinline__ int quantize(uint32_t fb, const float* tab) {
  const float v = __fmul_rn(__uint_as_float(fb & 0x7F800000u), tab[(fb >> 16) & 0x7Fu]);
  return min(max(__float2int_rn(__uint_as_float(__float_as_uint(v) ^ (fb & 0x80000000u))), -127), 127);
}

// Four int8 values (two's complement, in the low bytes of a, b, c, d) as one word.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u), 0x5410u);
}

// The maximum of the bf16 magnitudes in a word pair, as bf16 bit patterns
// (for magnitudes the patterns order as the values).
__device__ __forceinline__ uint32_t abs_max2(uint32_t m, uint32_t w) { return __vmaxu2(m, w & 0x7FFF7FFFu); }

template <int RN>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
            const __nv_bfloat16* __restrict__ x, const float* __restrict__ wscale,
            const float* __restrict__ row_amax, __nv_bfloat16* __restrict__ out, int B, int K, int N, int S) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x) / C * kTileN;
  const int t0 = wo::first_tile(K / kTileK, C, rank), T = wo::first_tile(K / kTileK, C, rank + 1) - t0;
  const int k0 = t0 * kTileK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7, wtid = tid & 127;  // consumer warpgroup (kGroups: the producer warp)

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wo::align1024(smem_raw);
  const Layout L = layout(RN, S, C);
  const uint32_t sbase = wo::smem_u32(base);
  auto xbox = [&](int s) { return base + s * stage_bytes(RN); };
  auto wbox = [&](int s) { return base + s * stage_bytes(RN) + RN * kTileK * 2; };
  const uint32_t bars = sbase + L.bars;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };
  const uint32_t atile = sbase + L.a + wg * kATile;
  const uint32_t btile = sbase + L.b + wg * RN * kTileK;
  int4* recv = reinterpret_cast<int4*>(base + L.recv);
  float* amax = reinterpret_cast<float*>(base + L.amax);
  float* xs = reinterpret_cast<float*>(base + L.xs);
  float* tab = reinterpret_cast<float*>(base + L.tab);
  float* sc = reinterpret_cast<float*>(base + L.sc);
  const int chunk = wo::slice4(RN, kTileN, C);
  const bool given = row_amax != nullptr;  // the rows' maxima come from the caller

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wo::mbar_init(full(s), 1);
      wo::mbar_init(empty(s), 4);  // one arrival per warp of the warpgroup that read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    wo::prefetch_map(&wmap);
    wo::prefetch_map(&xmap);
  }
  wo::wait_prior_grid();
  __syncthreads();
  wo::cluster_arrive_relaxed();  // this phase guarantees every CTA of the cluster runs before anything is pushed

  auto issue = [&](int t) {
    const int s = t % S;
    if (t >= S) wo::mbar_wait(empty(s), ((t / S) + 1) & 1);
    wo::mbar_expect_tx(full(s), stage_bytes(RN));
    wo::tma_load_2d(wo::smem_u32(xbox(s)), &xmap, full(s), k0 + t * kTileK, 0);
    wo::tma_load_2d(wo::smem_u32(wbox(s)), &wmap, full(s), n0, k0 + t * kTileK);
  };
  const int first = given ? min(T, S) : min(T, min(S, kEarlyStages));
  if (wg == kGroups) {  // producer warp: the first stages go out before the absmax
    if (lane == 0) {
      for (int t = 0; t < first; ++t) issue(t);
    }
    for (int c = lane; c < kTileN; c += 32) sc[c] = wscale[n0 + c];
    __syncwarp();
    if (!given) wo::cluster_wait();
  } else if (!given) {
    // the partial absmax of each row over this CTA's K slice: warp w takes
    // rows w, w + 8, ..., its lanes 512 contiguous bytes of each at a time,
    // every row's load in flight together (on the card faster than one row
    // at a time, and than threads of one row each taking a stretch)
    constexpr int kWarps = kConsumers / 32, kRowsPerWarp = (RN + kWarps - 1) / kWarps;
    const int vecs = T * kTileK / 8;
    uint32_t m[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) m[rr] = 0;
#pragma unroll 2
    for (int j = lane; j < vecs; j += 32) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp + rr * kWarps;
        if (r < B) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * K + k0) + j);
          m[rr] = abs_max2(abs_max2(m[rr], v.x), v.y);
          m[rr] = abs_max2(abs_max2(m[rr], v.z), v.w);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      uint32_t mr = max(m[rr] & 0xFFFFu, m[rr] >> 16);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mr = max(mr, __shfl_xor_sync(0xffffffffu, mr, off));
      if (lane == 0 && warp + rr * kWarps < B) xs[warp + rr * kWarps] = __uint_as_float(mr << 16);
    }
    wo::sync_threads(1, kConsumers);
    wo::cluster_wait();
    // every CTA of the cluster gets this CTA's maxima, in slot [rank][row]
    for (int i = tid; i < C * B; i += kConsumers) {
      const int q = i / B, r = i - q * B;
      *cluster.map_shared_rank(amax + rank * kMaxRows + r, q) = xs[r];
    }
  }
  if (!given) cluster.sync();  // the cluster's maxima have arrived (release / acquire)

  int acc[2][RN / 2];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
    for (int i = 0; i < RN / 2; ++i) acc[mb][i] = 0;
  }
  if (wg == kGroups) {
    if (lane == 0) {
      for (int t = first; t < T; ++t) issue(t);
    }
    __syncwarp();
  } else {
    for (int r = tid; r < RN; r += kConsumers) {
      float m = given && r < B ? row_amax[r] : 0.f;
      for (int q = 0; q < C && r < B && !given; ++q) m = fmaxf(m, amax[q * kMaxRows + r]);
      xs[r] = r < B ? fmaxf(__fdiv_rn(m, 127.0f), 1e-12f) : 1.0f;  // padding rows: zero in, zero out
    }
    wo::sync_threads(1, kConsumers);
    // each row's quotient table, by IEEE division: tab[r][f] = fl((1 + f / 128) / xs[r])
    // (0 for padding rows, whose x is 0)
    for (int i = tid; i < RN * kSignificands; i += kConsumers)
      tab[i] = i / kSignificands < B
                   ? __fdiv_rn(__uint_as_float(0x3F800000u | (static_cast<uint32_t>(i % kSignificands) << 16)),
                               xs[i / kSignificands])
                   : 0.0f;
    wo::sync_threads(1, kConsumers);

    const int w4 = warp & 3;
    for (int t = wg; t < T; t += kGroups) {
      const int s = t % S;
      wo::mbar_wait(full(s), (t / S) & 1);
      wo::wgmma_wait<0>();  // this warpgroup's last products are done: its A and B tiles are free
      wo::fence_regs(acc[0]);
      wo::fence_regs(acc[1]);
      // x box (rows x 128 bf16, row-major) -> xq, K-major B tile: 16-byte
      // chunk c (k 16 c ... 16 c + 15) of row r at chunk c ^ (r % 8)
      const uint8_t* xb = xbox(s);
#pragma unroll
      for (int it = 0; it < (RN * 8 + 127) / 128; ++it) {
        const int i = it * 128 + wtid;
        if (RN * 8 % 128 == 0 || i < RN * 8) {
          // the chunk's 32 bytes of x, the half at 16 * (c / 4 % 2) first, so
          // 8 lanes of a row hit 8 different 16-byte bank groups
          const int r = i >> 3, c = i & 7, h = (c >> 2) & 1;
          const uint4 va = *reinterpret_cast<const uint4*>(xb + r * 256 + c * 32 + 16 * h);
          const uint4 vb = *reinterpret_cast<const uint4*>(xb + r * 256 + c * 32 + 16 * (h ^ 1));
          const uint4 v0 = h ? vb : va, v1 = h ? va : vb;
          const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
          const float* tr = tab + r * kSignificands;
          uint32_t o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = pack4(quantize(w[2 * j] << 16, tr), quantize(w[2 * j] & 0xFFFF0000u, tr),
                         quantize(w[2 * j + 1] << 16, tr), quantize(w[2 * j + 1] & 0xFFFF0000u, tr));
          wo::st_shared_v4(btile + (r >> 3) * 1024 + (r & 7) * 128 + ((c ^ (r & 7)) << 4), o[0], o[1], o[2], o[3]);
        }
      }
      // weight box (128 k x 128 n, n-contiguous) -> K-major A tile: lane l
      // takes columns 4 l ... 4 l + 3, a 16-row chunk c at a time, and
      // transposes 4 x 4 byte tiles; chunks rotate with the lane so the
      // swizzled stores of 8 lanes hit 8 different 16-byte bank groups
      const uint8_t* wb = wbox(s);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = ((lane >> 1) + 2 * w4 + j) & 7;
        uint32_t rw[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) rw[i] = *reinterpret_cast<const uint32_t*>(wb + (16 * c + i) * kTileN + 4 * lane);
        uint32_t col[4][4];  // col[e][g]: column 4 l + e, k 16 c + 4 g ... + 3
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const uint32_t t0w = __byte_perm(rw[4 * g], rw[4 * g + 1], 0x5140u);
          const uint32_t t1w = __byte_perm(rw[4 * g + 2], rw[4 * g + 3], 0x5140u);
          const uint32_t t2w = __byte_perm(rw[4 * g], rw[4 * g + 1], 0x7362u);
          const uint32_t t3w = __byte_perm(rw[4 * g + 2], rw[4 * g + 3], 0x7362u);
          col[0][g] = __byte_perm(t0w, t1w, 0x5410u);
          col[1][g] = __byte_perm(t0w, t1w, 0x7632u);
          col[2][g] = __byte_perm(t2w, t3w, 0x5410u);
          col[3][g] = __byte_perm(t2w, t3w, 0x7632u);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * lane + e;
          wo::st_shared_v4(atile + (n >> 3) * 1024 + (n & 7) * 128 + ((c ^ (n & 7)) << 4), col[e][0], col[e][1],
                           col[e][2], col[e][3]);
        }
      }
      __syncwarp();
      if (lane == 0) wo::mbar_arrive(empty(s));  // the stage is read
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the tiles, visible to wgmma
      wo::sync_threads(2 + wg, 128);
      wo::fence_regs(acc[0]);
      wo::fence_regs(acc[1]);
      wo::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileK / 32; ++kk) {
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
          igmma(acc[mb], wo::sw128_desc(atile + mb * (kATile / 2) + kk * 32, 16, 1024),
                wo::sw128_desc(btile + kk * 32, 16, 1024));
      }
      wo::wgmma_commit();
    }
    wo::wgmma_wait<0>();
    wo::fence_regs(acc[0]);
    wo::fence_regs(acc[1]);
  }
  // the two warpgroups' sums to shared memory (the ring: every stage is
  // read), then added and pushed as int4s to the CTAs that finish them.
  // Accumulator layout: M rows (weight columns) m and m + 8 with m = 16 *
  // (warp % 4) + lane / 4 in each 64-column block; in each 8-column chunk i
  // of N (rows of x) the columns 8 i + 2 * (lane % 4) + {0, 1}.
  int* sums = reinterpret_cast<int*>(base);
  if (given) wo::cluster_wait();  // the first phase: every CTA of the cluster runs before anything is pushed
  __syncthreads();
  if (wg < kGroups) {
    int* mine = sums + wg * RN * kSumStride;
    const int m = 16 * (warp & 3) + (lane >> 2), b0 = 2 * (lane & 3);
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int i = 0; i < RN / 8; ++i) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int b = 8 * i + b0 + (h & 1);
          if (b < B) mine[b * kSumStride + 64 * mb + m + 8 * (h >> 1)] = acc[mb][4 * i + h];
        }
      }
    }
  }
  __syncthreads();
  // every value first, then every remote store: a store to another CTA's
  // shared memory would otherwise hold up the next local load
  constexpr int kPush = (RN * kTileN / 4 + kThreads - 1) / kThreads;
  int4 part[kPush];
#pragma unroll
  for (int j = 0; j < kPush; ++j) {
    const int e = tid + j * kThreads;
    if (e < B * kTileN / 4) {
      const int off = e / (kTileN / 4) * kSumStride + 4 * (e % (kTileN / 4));
      const int4 u = *reinterpret_cast<const int4*>(sums + off);
      const int4 v = *reinterpret_cast<const int4*>(sums + RN * kSumStride + off);
      part[j] = make_int4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
    }
  }
#pragma unroll
  for (int j = 0; j < kPush; ++j) {
    const int e = tid + j * kThreads;
    if (e < B * kTileN / 4) {
      const int owner = e / chunk;
      cluster.map_shared_rank(recv, owner)[rank * chunk + e - owner * chunk] = part[j];
    }
  }
  cluster.sync();
  // this CTA's slice: the C partials in rank order (int32, exact), then the scales and one rounding
  const int begin = rank * chunk, end = min(B * kTileN / 4, begin + chunk);
  for (int e = begin + tid; e < end; e += kThreads) {
    int4 s = recv[e - begin];
    for (int q = 1; q < C; ++q) {
      const int4 v = recv[q * chunk + e - begin];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int b = e / (kTileN / 4), c = 4 * (e % (kTileN / 4));
    const float xsb = xs[b];
    const float4 f = *reinterpret_cast<const float4*>(sc + c);
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(b) * N + n0 + c);
    o[0] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(__int2float_rn(s.x), xsb), f.x),
                                 __fmul_rn(__fmul_rn(__int2float_rn(s.y), xsb), f.y));
    o[1] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(__int2float_rn(s.z), xsb), f.z),
                                 __fmul_rn(__fmul_rn(__int2float_rn(s.w), xsb), f.w));
  }
}

}  // namespace w8a8

// C entry point, bound with ctypes. x (B, K) bf16, q (K, N) int8, wscale (N,)
// f32, row_amax (B,) f32 or null (the rows' maxima over the whole K of a
// row-parallel shard; null: this call's own), out (B, N) bf16, contiguous,
// 16-byte aligned; `plan` the wrapper's
// launch plan (weight_only::Plan, 6 ints: regime 2, tile_n 128, cluster C,
// stages, rows = B rounded up to an s8 wgmma N, shared bytes). Returns the
// cudaError_t of the launch: cudaErrorInvalidValue for shapes or a plan it
// does not take (1 <= B <= 64, K and N multiples of 128, K <= kMaxK, 1 <= C
// <= min(8, K / 128)), or a tensor map the CUDA driver refuses.
extern "C" int s2s_int8_matmul_dyn(const void* x, const void* q, const void* wscale, const void* row_amax, void* out,
                                   int B, int K, int N, const int* plan, void* stream) {
  using namespace w8a8;
  const wo::Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const int C = p.cluster;
  if (B < 1 || B > kMaxRows || K < kTileK || K % kTileK != 0 || K > kMaxK || N < kTileN || N % kTileN != 0 ||
      p.regime != kRegime || p.tile_n != kTileN || C < 1 || C > 8 || C > K / kTileK || p.stages < 1 ||
      p.stages > 64 || p.rows < B || !wgmma_rows(p.rows) || layout(p.rows, p.stages, C).bytes > p.bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap wmap, xmap;
  if (!wo::matrix_map(&wmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, kTileN, kTileK, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !wo::matrix_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, K, kTileK, p.rows,
                      CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* ws = static_cast<const float*>(wscale);
  const auto* ra = static_cast<const float*>(row_amax);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int grid = N / kTileN * C;
  switch (p.rows) {
    case 8: return wo::launch_cluster<w8a8_kernel<8>>(p, grid, kThreads, st, wmap, xmap, xb, ws, ra, ob, B, K, N, p.stages);
    case 16: return wo::launch_cluster<w8a8_kernel<16>>(p, grid, kThreads, st, wmap, xmap, xb, ws, ra, ob, B, K, N, p.stages);
    case 24: return wo::launch_cluster<w8a8_kernel<24>>(p, grid, kThreads, st, wmap, xmap, xb, ws, ra, ob, B, K, N, p.stages);
    case 32: return wo::launch_cluster<w8a8_kernel<32>>(p, grid, kThreads, st, wmap, xmap, xb, ws, ra, ob, B, K, N, p.stages);
    case 48: return wo::launch_cluster<w8a8_kernel<48>>(p, grid, kThreads, st, wmap, xmap, xb, ws, ra, ob, B, K, N, p.stages);
    default: return wo::launch_cluster<w8a8_kernel<64>>(p, grid, kThreads, st, wmap, xmap, xb, ws, ra, ob, B, K, N, p.stages);
  }
}
