// Flash attention forward on Hopper (sm_90a): softmax(q k^T * scale) v over
// (B, H) heads, unmasked or causal, without the (Tq x Tk) score matrix ever
// reaching device memory.
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/pallas_attention.py::flash_attention
// (body `_flash_kernel`), with its math:
//   q pre-scaled in f32;  s = q . k in f32 (keys after the query masked when
//   causal);  a running row max m and sum l, rescaled by exp(m_old - m_new) per
//   key tile;  acc += p v with p kept in f32;  out = acc / max(l, 1e-30), rounded
//   once to the element type.
// The Pallas kernel needs Tq and Tk to be multiples of its 128-row tiles. This
// one masks a ragged last tile itself (keys >= Tk score -inf, query rows >= Tq
// are computed from zeros and not written), so every Whisper duration bucket
// (50-1500 encoder positions) and Smart Turn's 400 run with no padding.
//
// What bounds it: at the encoder's shapes the work is 4 * Tq * Tk * D flops per
// head over 2 * (2 * Tq + 2 * Tk) * D bytes (bf16): hundreds of flops per byte
// at T >= 250, so it is bound by arithmetic, on the tensor cores' 989 TFLOP/s
// in the limit. This kernel does its arithmetic in f32 on the CUDA cores and
// is bound by their rate, by shared-memory loads and, at Smart Turn's few
// heads, by one block's chain of key tiles; a wgmma/TMA design is later work
// (ROADMAP).
//
// How the design answers that:
// - One block of 256 threads (16 x 16) per (tile of 64 or 32 queries, head).
//   It stages its Q tile (scaled, transposed) once, then streams K (transposed)
//   and V in tiles of 64 keys through shared memory with 16-byte global loads,
//   so each K and V row is read from device memory once per query tile.
// - Scores are register-tiled: thread (ty, tx) owns rows RA * ty + a (RA = 4
//   or 2) and keys 4 * tx + c, and reads its queries and keys as float4 from
//   shared memory (2 shared loads per 4 * RA FMAs).
// - The online softmax runs in registers: a row's 64 scores sit in the 16
//   lanes of a half warp, so its max and sum take 4 shuffles each; only p goes
//   through shared memory, row-major with a padded stride, for PV, where each
//   thread owns 4 (D = 64) or 8 (D = 128) output dims and reads p and V as
//   float4.
// - Tile size by shape: 32-query tiles when 64-query tiles would give the card
//   fewer than 1.5 blocks per SM (Smart Turn, the short Whisper buckets).
// - Causal blocks stop at the last key tile their queries can see.
// - Sums run in a fixed order and no atomics are used: the same inputs give the
//   same bits on every run.

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
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

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

// C entry point, bound with ctypes. q (B, H, Tq, D), k and v (B, H, Tk, D) with
// the given element strides of their batch, head and time axes and a
// contiguous last axis; out (B, H, Tq, D) contiguous; one element type (dtype
// 0: bf16, 1: f32). Shapes and alignment are checked by the Python wrapper
// (s2s_tpu_torch/ops/flash_attention.py): D in {64, 128}, Tq, Tk >= 1, base
// pointers 16-byte aligned and strides multiples of 16 bytes. Returns the
// cudaError_t of the launch (cudaErrorMisalignedAddress for a layout the
// 16-byte loads cannot take).
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
  if (dtype == 0) return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
  return dispatch_d<float>(D, q, k, v, out, B, H, Tq, Tk, qs, ks, vs, scale, causal, st);
}
