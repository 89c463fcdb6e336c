// Flash attention forward on Hopper (sm_90a): softmax(q k^T * scale) v over
// (B, H) heads, unmasked or causal, without the (Tq x Tk) score matrix ever
// reaching device memory.
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/pallas_attention.py::flash_attention
// (body `_flash_kernel`): a running row max m and sum l, rescaled by
// exp(m_old - m_new) per key tile; out = acc / max(l, 1e-30), rounded once to
// the element type. The Pallas kernel needs Tq and Tk to be multiples of its
// 128-row tiles; both kernels here mask a ragged last tile themselves (keys >=
// Tk score -inf, query rows >= Tq are not written), so every Whisper duration
// bucket (50-1500 encoder positions) and Smart Turn's 400 run with no padding.
//
// What bounds it: 4 * Tq * Tk * D flops per head over 2 * (2 * Tq + 2 * Tk) * D
// bytes (bf16), hundreds of flops per byte at T >= 250, so the limit is the
// tensor cores' 989 TFLOP/s (bf16); at Smart Turn's 6 heads x 400 positions it
// is the latency of one block's chain of 7 key tiles.
//
// bf16 (every served encoder layer): tensor cores fed by TMA.
// - One block per (64 queries, head): one consumer warpgroup (128 threads)
//   and one producer warp. On an H100, variants in turns on the same inputs
//   (PERF.md): two consumer warpgroups per block (128-query tiles that
//   share each K/V tile) and 3 stages were slower or level at every encoder
//   shape, head dim 128 included; a 64-query block with 2 stages holds 40 KB
//   of shared memory at D 64, so several blocks share an SM.
// - The producer issues every copy as TMA (cp.async.bulk.tensor.4d) over the
//   head views' own strides (the encoder's (B, T, H, D) projections seen as
//   (B, H, T, D)), with 128-byte swizzle: the Q tile once, then K and V tiles
//   of 64 keys through a ring of 2 shared-memory stages, each completed on an
//   mbarrier ("full"); the consumer warps release a stage on another
//   ("empty"). A D = 128 row is two 64-column boxes. TMA zero-fills rows past
//   Tq and Tk. The tensor maps are encoded on the host for each call
//   (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint: no
//   -lcuda) and passed as __grid_constant__ parameters.
// - S = Q K^T by wgmma.mma_async m64n64k16 (bf16 in, f32 accumulate), both
//   operands read from shared memory through descriptors (K-major, 128-byte
//   swizzle). The online softmax runs on the accumulator fragment in
//   registers: a row's values sit in one quad of threads, so its max takes two
//   shuffles per key tile and its sum is reduced once at the end. l is summed
//   from the f32 p.
// - P is rounded to bf16 in registers and fed as the register A operand of the
//   PV wgmma (m64nDk16): the score accumulator's layout is the A fragment's.
//   V is the shared-memory B operand in its natural (keys, D) layout, read
//   with wgmma's transpose bit (MN-major), so V is never transposed in memory.
//   The output accumulator stays f32 in registers; one division at the end,
//   then bf16.
// - Causal blocks stop at their last visible key tile; only a tile that holds
//   the diagonal or the ragged edge is masked.
// - Numerics: p rounded to bf16 before PV (what the tensor cores take; the
//   JAX package's served attention rounds the normalised p to bf16,
//   s2s_tpu/models/common.py:106); the plain version keeps p in f32, and
//   the two agree within 2 bf16 ulps of max|out| at the encoder's shapes
//   (chip_smoke.py). Sums run in a fixed order with no atomics: the same
//   inputs give the same bits on every run.
// - Not done: the softmax of one tile overlapping the PV product of the one
//   before inside a warpgroup (tried with Q held as register fragments: more
//   registers, fewer blocks per SM, slower at every shape), and a split of
//   the keys over a cluster for Smart Turn's 42 blocks.
//
// f32 (the tiny parity programs on the card, rel 1e-4 against the CPU, which
// bf16 tensor cores cannot meet): the CUDA-core kernel below, unchanged: one
// 256-thread block per (64 or 32 queries, head), K^T and V staged through
// shared memory, f32 FMAs, p kept in f32.
//
// The earlier bf16 design was that CUDA-core kernel (H100 80GB HBM3, 700 W,
// PERF.md): 33.6 us at Smart Turn (SDPA 11.2), 472.3 us at 20 heads x 1500
// positions (SDPA 38.2), at most 24.4 TFLOP/s.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;       // keys per tile
constexpr int kLP = kBK + 4;  // row stride of p in shared memory: a warp's two row groups hit other banks
constexpr int kThreads = 256;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {
  long long b, h, t;
};

template <int R>
__device__ __forceinline__ void load_rows(const float* p, float* out);
template <>
__device__ __forceinline__ void load_rows<4>(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
template <>
__device__ __forceinline__ void load_rows<2>(const float* p, float* out) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  out[0] = f.x;
  out[1] = f.y;
}

template <typename T, int D, int RA>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int H, int Tq, int Tk, Strides qs_, Strides ks_,
                       Strides vs_, float scale, int causal) {
  constexpr int kBQ = 16 * RA;  // queries per block
  constexpr int V = Vec<T>::n;    // elements per 16-byte global load
  constexpr int CB = D / 64;      // float4 groups of output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;              // [D][kBQ] scaled queries, transposed
  float* kt = qt + D * kBQ;      // [D][kBK] keys, transposed
  float* vs = kt + D * kBK;      // [kBK][D] values
  float* ps = vs + kBK * D;      // [kBQ][kLP] p

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + h * ks_.h;
  const T* vb = v + b * vs_.b + h * vs_.h;

  for (int i = tid; i < kBQ * (D / V); i += kThreads) {
    const int r = i % kBQ, d0 = (i / kBQ) * V;
    float x[V];
    if (q0 + r < Tq) {
      Vec<T>::load(qb + (q0 + r) * qs_.t + d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) qt[(d0 + e) * kBQ + r] = x[e] * scale;
  }

  float acc[RA][CB][4];
  float m[RA], l[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.f;
    }
  }

  const int k_end = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and p are consumed (and Q is staged)
    for (int i = tid; i < kBK * (D / V); i += kThreads) {
      const int j = i % kBK, d0 = (i / kBK) * V;
      float x[V];
      if (k0 + j < Tk) {
        Vec<T>::load(kb + (k0 + j) * ks_.t + d0, x);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) kt[(d0 + e) * kBK + j] = x[e];
    }
    for (int i = tid; i < kBK * (D / V); i += kThreads) {
      const int j = i / (D / V), d0 = (i % (D / V)) * V;
      float x[V];
      if (k0 + j < Tk) {
        Vec<T>::load(vb + (k0 + j) * vs_.t + d0, x);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(vs + j * D + d0 + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
    __syncthreads();

    // scores: rows RA * ty + a, keys 4 * tx + c
    float s[RA][4];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RA];
      load_rows<RA>(qt + d * kBQ + RA * ty, qa);
      const float4 kv = *reinterpret_cast<const float4*>(kt + d * kBK + 4 * tx);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        s[a][0] = fmaf(qa[a], kv.x, s[a][0]);
        s[a][1] = fmaf(qa[a], kv.y, s[a][1]);
        s[a][2] = fmaf(qa[a], kv.z, s[a][2]);
        s[a][3] = fmaf(qa[a], kv.w, s[a][3]);
      }
    }

    // online softmax in registers: a row's 64 keys live in the 16 lanes of a
    // half warp (same ty)
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int qi = q0 + RA * ty + a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + 4 * tx + c;
        if (kj >= Tk || (causal && kj > qi)) s[a][c] = -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - m_use);
        sum += s[a][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[a] - m_use);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][c][e] *= corr;
      }
      *reinterpret_cast<float4*>(ps + (RA * ty + a) * kLP + 4 * tx) = make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    }
    __syncthreads();

    // acc += p v: rows RA * ty + a, dims 64 * c + 4 * tx + e
#pragma unroll 2
    for (int j0 = 0; j0 < kBK; j0 += 4) {
      float4 p4[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) p4[a] = *reinterpret_cast<const float4*>(ps + (RA * ty + a) * kLP + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + (j0 + jj) * D + 64 * c + 4 * tx);
#pragma unroll
          for (int a = 0; a < RA; ++a) {
            const float p = jj == 0 ? p4[a].x : jj == 1 ? p4[a].y : jj == 2 ? p4[a].z : p4[a].w;
            acc[a][c][0] = fmaf(p, vv.x, acc[a][c][0]);
            acc[a][c][1] = fmaf(p, vv.y, acc[a][c][1]);
            acc[a][c][2] = fmaf(p, vv.z, acc[a][c][2]);
            acc[a][c][3] = fmaf(p, vv.w, acc[a][c][3]);
          }
        }
      }
    }
  }

  T* ob = out + static_cast<long long>(bh) * Tq * D;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int qi = q0 + RA * ty + a;
    if (qi >= Tq) continue;
    const float lim = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[static_cast<long long>(qi) * D + 64 * c + 4 * tx + e] = from_f32<T>(acc[a][c][e] / lim);
    }
  }
}

constexpr size_t smem_bytes(int D, int bq) {
  return sizeof(float) * (static_cast<size_t>(D) * bq + static_cast<size_t>(D) * kBK +
                          static_cast<size_t>(kBK) * D + static_cast<size_t>(bq) * kLP);
}

template <typename T, int D, int RA>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Tq, int Tk,
           Strides qs, Strides ks, Strides vs, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D, RA>;
  constexpr int bq = 16 * RA;
  constexpr size_t smem = smem_bytes(D, bq);  // above the default 48 KB: opt in once
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Tq + bq - 1) / bq, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), H, Tq,
                                           Tk, qs, ks, vs, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// 32-query tiles (2 rows per thread) when 64-query tiles would give the card
// fewer than 1.5 blocks per SM: there one block's chain of key tiles sets the
// time and halving each block's rows pays; above it the 64-query tiles' reuse
// of every staged K/V tile wins.
bool short_tiles(int B, int H, int Tq) {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return n;
  }();
  return 2LL * B * H * ((Tq + 63) / 64) < 3LL * sms;
}

template <typename T, int D>
int dispatch_tiles(const void* q, const void* k, const void* v, void* out, int B, int H, int Tq, int Tk,
                   Strides qs, Strides ks, Strides vs, float scale, int causal, cudaStream_t st) {
  if (short_tiles(B, H, Tq)) return launch<T, D, 2>(q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
  return launch<T, D, 4>(q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
               int Tq, int Tk, Strides qs, Strides ks, Strides vs, float scale, int causal,
               cudaStream_t st) {
  if (D == 64) return dispatch_tiles<T, 64>(q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
  if (D == 128) return dispatch_tiles<T, 128>(q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// 16-byte loads: base 16-byte aligned, every stride a whole number of loads
bool aligned(const void* p, long long sb, long long sh, long long st, int vec) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % vec == 0 && sh % vec == 0 && st % vec == 0;
}

}  // namespace

namespace {
namespace tc {

constexpr int kBM = 64;     // queries per block: one consumer warpgroup
constexpr int kBN = 64;     // keys per tile
constexpr int kStages = 2;  // K/V ring depth

// Shared-memory layout of one block, offsets from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 8 rows of 128 bytes). A tile of R rows
// and D columns is D / 64 boxes of R rows x 128 bytes, one after the other.
template <int D>
struct Layout {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBytes = kBoxes * kBM * 128;
  static constexpr int kTileBytes = kBoxes * kBN * 128;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;     // K, then V
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // mbarriers: q_full, full[kStages], empty[kStages]
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Wait for the completion of the barrier's phase of the given parity.
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

// One box of a 4-D tensor map {d, t, h, b} into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d, int t, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(t), "r"(h), "r"(b)
      : "memory");
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

// d (64 x 64, f32) += A (64 x 16, shared) * B (16 x 64, shared), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n64_mn(o, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  wgmma_rs_n128_mn(o, a, desc_b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Online softmax of one 64 x 64 score tile in the wgmma accumulator layout
// (this thread: rows r (index 0) and r + 8 (index 1), in each 8-key chunk the
// keys col, col + 1): masks keys >= Tk and, when causal, keys after the row
// (only when `edge`); updates the running max m and this thread's share of
// the running sum l (f32 p); returns in corr the factors that rescale the
// output rows; packs p rounded to bf16 as the A fragments of the PV product
// (key step j holds score chunks 2j and 2j + 1).
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             uint32_t (&pa)[4][4], bool edge, int k0, int Tk, int causal,
                                             int row0, int col, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * i + col + e;
        if (kj >= Tk || (causal && kj > row0)) sc[4 * i + e] = -INFINITY;
        if (kj >= Tk || (causal && kj > row0 + 8)) sc[4 * i + 2 + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    mu[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
    corr[r] = exp2f(m[r] * scale_log2 - mu[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * i + e] = exp2f(fmaf(sc[4 * i + e], scale_log2, -mu[e >> 1]));
      sum[e >> 1] += sc[4 * i + e];
    }
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pa[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
    pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
    pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
    pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i] *= corr[0];
    o[4 * i + 1] *= corr[0];
    o[4 * i + 2] *= corr[1];
    o[4 * i + 3] *= corr[1];
  }
}

template <int D>
__global__ void __launch_bounds__(160, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out, int H,
                          int Tq, int Tk, float scale_log2, int causal) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;
  const uint32_t q_full = base + L::kBarOffset;
  auto full_bar = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto k_smem = [&](int s) { return base + L::kQBytes + static_cast<uint32_t>(s * L::kStageBytes); };

  const int q0 = blockIdx.x * kBM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k_end = causal ? min(Tk, q0 + kBM) : Tk;
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer warp: one thread issues every copy
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c) tma_load(q_smem + c * kBM * 128, &qmap, q_full, 64 * c, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar(s), ((t / kStages) + 1) & 1);
        mbar_expect_tx(full_bar(s), L::kStageBytes);
        const uint32_t ks = k_smem(s), vs = ks + L::kTileBytes;
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(ks + c * kBN * 128, &kmap, full_bar(s), 64 * c, t * kBN, h, b);
          tma_load(vs + c * kBN * 128, &vmap, full_bar(s), 64 * c, t * kBN, h, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: query rows q0 + [0, 64); this thread holds rows r
  // and r + 8 (r = 16 * warp + lane / 4), and in each 8-column chunk of an
  // accumulator the two columns 2 * (lane % 4) + {0, 1}
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + 16 * warp + (lane >> 2);
  const int col = 2 * (lane & 3);
  auto edge = [&](int t) { return t * kBN + kBN > Tk || (causal && t * kBN + kBN - 1 > q0); };
  auto k_desc = [&](uint32_t ks, int kk) {  // step kk of 16 columns: 32 bytes into a 128-byte row
    return sw128_desc(ks + (kk >> 2) * kBN * 128 + (kk & 3) * 32, 16, 1024);
  };
  // V (keys, D) is MN-major: 8 keys of 128 bytes per swizzle atom (stride
  // 1024), the second 64 columns one box further (leading offset)
  auto v_desc = [&](uint32_t vs, int j) { return sw128_desc(vs + j * 16 * 128, kBN * 128, 1024); };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[4][4];

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t ks = k_smem(s), vs = ks + L::kTileBytes;
    mbar_wait(full_bar(s), (t / kStages) & 1);
    // S = Q K^T over D in steps of 16 columns
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, sw128_desc(q_smem + (kk >> 2) * kBM * 128 + (kk & 3) * 32, 16, 1024), k_desc(ks, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m, l, corr, pa, edge(t), t * kBN, Tk, causal, row0, col, scale_log2);
    rescale<D>(o, corr);
    // O += P V over the tile's keys in steps of 16
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_pv<D>(o, pa[j], v_desc(vs, j));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty_bar(s));
  }

  float l0 = l[0], l1 = l[1];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float lim0 = fmaxf(l0, 1e-30f), lim1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + static_cast<long long>(bh) * Tq * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    if (row0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row0) * D + 8 * i + col) =
          __floats2bfloat162_rn(o[4 * i] / lim0, o[4 * i + 1] / lim0);
    if (row0 + 8 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row0 + 8) * D + 8 * i + col) =
          __floats2bfloat162_rn(o[4 * i + 2] / lim1, o[4 * i + 3] / lim1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
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

// Tensor map of a (B, H, T, D) bf16 head view with element strides (sb, sh,
// st, 1): dims {D, T, H, B}, boxes of 64 columns x `rows` rows, 128-byte swizzle,
// zero fill past each edge.
bool head_map(CUtensorMap* map, const void* ptr, int B, int H, int T, int D, long long sb, long long sh,
              long long st, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Tq, int Tk, Strides qs,
           Strides ks, Strides vs, float scale, int causal, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!head_map(&qmap, q, B, H, Tq, D, qs.b, qs.h, qs.t, kBM) ||
      !head_map(&kmap, k, B, H, Tk, D, ks.b, ks.h, ks.t, kBN) || !head_map(&vmap, v, B, H, Tk, D, vs.b, vs.h, vs.t, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_tc_kernel<D>;
  constexpr int smem = L::kBytes + 1024;  // + the slack to align the base to 1024 bytes
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Tq + kBM - 1) / kBM, B * H);
  kernel<<<grid, 160, smem, stream>>>(qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), H, Tq, Tk,
                                                scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int D, const void* q, const void* k, const void* v, void* out, int B, int H, int Tq, int Tk,
             Strides qs, Strides ks, Strides vs, float scale, int causal, cudaStream_t st) {
  if (D == 64) return launch<64>(q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
  if (D == 128) return launch<128>(q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc
}  // namespace

// C entry point, bound with ctypes. q (B, H, Tq, D), k and v (B, H, Tk, D) with
// the given element strides of their batch, head and time axes and a
// contiguous last axis; out (B, H, Tq, D) contiguous; one element type (dtype
// 0: bf16, the tensor-core kernel; 1: f32, the CUDA-core kernel).
// Shapes and alignment are checked by the Python wrapper
// (s2s_tpu_torch/ops/flash_attention.py): D in {64, 128}, Tq, Tk >= 1, base
// pointers 16-byte aligned and strides multiples of 16 bytes. Returns the
// cudaError_t of the launch (cudaErrorMisalignedAddress for a layout the
// 16-byte loads or the tensor maps cannot take, cudaErrorInvalidValue for a
// tensor map the driver refuses).
extern "C" int s2s_flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                                   int H, int Tq, int Tk, int D, long long qsb, long long qsh,
                                   long long qst, long long ksb, long long ksh, long long kst,
                                   long long vsb, long long vsh, long long vst, int dtype,
                                   int causal, float scale, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == 0 ? 8 : 4;
  if (!aligned(q, qsb, qsh, qst, vec) || !aligned(k, ksb, ksh, kst, vec) || !aligned(v, vsb, vsh, vst, vec))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tc::dispatch(D, q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
  return dispatch_d<float>(D, q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
}

// The tensor-core kernel's tiles, for the wrapper to report: queries per
// block, keys per K/V tile, K/V stages.
extern "C" void s2s_flash_attention_tiles(int* out) {
  out[0] = tc::kBM;
  out[1] = tc::kBN;
  out[2] = tc::kStages;
}
