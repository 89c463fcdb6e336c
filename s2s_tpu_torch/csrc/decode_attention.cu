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
// What bounds it: at decode every row reads its valid K and V rows once
// (2 * keys * hd * 2 bytes per KV head in bf16) and does ~4 * G * hd flops per
// key, far below the card's ~295 flops per byte, so it is bound by the bytes
// of the valid keys and, at the serving path's small batches, by latency.
//
// How the design answers that:
// - One block per (row, KV head). The block keeps that group's G query vectors
//   in shared memory, so each K and V row is read from device memory once for
//   all G heads (no repeat of the cache per query head).
// - Only valid keys are read: the loop runs over cache_len + tail_len keys,
//   where the XLA version reads all T keys and masks them.
// - Warps stride over keys, lanes over hd: a warp reads whole K or V rows
//   (hd / 32 contiguous elements per lane, as 4- or 8-byte loads), coalesced.
//   A warp's row reads complete about one at a time, so the block runs 32
//   warps to keep 32 rows in flight: on an H100 that took 32 blocks over
//   518 SmolLM2 keys each from 65.5 us (8 warps) to 21.8 us (PERF.md).
// - The softmax is exact and two-pass inside the block (scores in shared
//   memory), so p is normalised before it is rounded, as the XLA version
//   does; the cross-warp sum of the PV products runs in a fixed order. No
//   atomics: the result is the same on every run, and rows with equal inputs
//   give bit-equal outputs (the gathered programs pad a width bucket with
//   duplicate rows and rely on that).
// - A row with no valid key writes zeros (the plain PyTorch version returns
//   the mean of all keys there, as JAX's masked softmax does); the serving
//   programs never make such a row, since every active step writes its own
//   key into the tail.
//
// Later work (ROADMAP): a split over the keys with a deterministic combine for
// small batches (at B = 1 the Qwen3-TTS talker launches only 8 blocks), and
// TMA / wgmma staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Load this lane's PER (2 or 4) contiguous elements of a K or V row as f32,
// in pairs (the wrapper checks 16-byte aligned tensors).
template <int PER>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ row, int lane,
                                         float (&out)[PER]) {
  const auto* p = reinterpret_cast<const __nv_bfloat162*>(row + lane * PER);
#pragma unroll
  for (int e = 0; e < PER / 2; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

template <int PER>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int lane, float (&out)[PER]) {
  const auto* p = reinterpret_cast<const float2*>(row + lane * PER);
#pragma unroll
  for (int e = 0; e < PER / 2; ++e) {
    const float2 f = p[e];
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                        const T* __restrict__ cv, const T* __restrict__ tk,
                        const T* __restrict__ tv, const int* __restrict__ cache_len,
                        const int* __restrict__ tail_len, T* __restrict__ out, int H, int KV,
                        int Tc, int n, float scale) {
  constexpr int PER = HD / 32;
  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride_s = Tc + n;  // one score row per query head of the group

  extern __shared__ float smem[];
  float* qs = smem;                     // [G][HD] queries, f32
  float* sc = qs + G * HD;              // [G][Tc + n] scores, then p
  float* red = sc + G * stride_s;       // [kWarps][G][HD] partial PV sums

  const int clen = min(max(cache_len[b], 0), Tc);
  const int tlen = min(max(tail_len[b], 0), n);
  const int nk = clen + tlen;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G;
  const T* ck_row0 = ck + (static_cast<size_t>(b) * KV + kv) * Tc * HD;
  const T* cv_row0 = cv + (static_cast<size_t>(b) * KV + kv) * Tc * HD;
  const T* tk_row0 = tk + (static_cast<size_t>(b) * KV + kv) * n * HD;
  const T* tv_row0 = tv + (static_cast<size_t>(b) * KV + kv) * n * HD;

  for (int i = threadIdx.x; i < G * HD; i += kThreads) qs[i] = to_f32(q[head0 * HD + i]);
  __syncthreads();

  // row j of the valid keys: cache rows first, then tail rows
  auto row_of = [&](const T* cache0, const T* tail0, int j) {
    return j < clen ? cache0 + static_cast<size_t>(j) * HD : tail0 + static_cast<size_t>(j - clen) * HD;
  };

  // pass 1: scores of every valid key for the G query heads
  for (int j = warp; j < nk; j += kWarps) {
    float kf[PER];
    load_row<PER>(row_of(ck_row0, tk_row0, j), lane, kf);
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) s = fmaf(qs[g * HD + lane * PER + e], kf[e], s);
      s = warp_sum(s);
      if (lane == 0) sc[g * stride_s + j] = s * scale;
    }
  }
  __syncthreads();

  // pass 2: softmax per query head (one warp per head), p rounded to T
  for (int g = warp; g < G; g += kWarps) {
    float* s = sc + g * stride_s;
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, s[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < nk; j += 32) s[j] = to_f32(from_f32<T>(s[j] / l));
  }
  __syncthreads();

  // pass 3: out = sum_j p_j * v_j, f32 accumulation, warps over keys
  float acc[kMaxGroup][PER];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
  }
  for (int j = warp; j < nk; j += kWarps) {
    float vf[PER];
    load_row<PER>(row_of(cv_row0, tv_row0, j), lane, vf);
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= G) break;
      const float p = sc[g * stride_s + j];
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < PER; ++e) red[(warp * G + g) * HD + lane * PER + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * G * HD + i];
    out[head0 * HD + i] = from_f32<T>(s);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
           const int* cache_len, const int* tail_len, void* out, int B, int H, int KV, int Tc,
           int n, float scale, size_t smem, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<const T*>(tk), static_cast<const T*>(tv), cache_len, tail_len,
      static_cast<T*>(out), H, KV, Tc, n, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* ck, const void* cv, const void* tk,
                const void* tv, const int* cl, const int* tl, void* out, int B, int H, int KV,
                int Tc, int n, float scale, size_t smem, cudaStream_t st) {
  if (hd == 64) return launch<T, 64>(q, ck, cv, tk, tv, cl, tl, out, B, H, KV, Tc, n, scale, smem, st);
  if (hd == 128) return launch<T, 128>(q, ck, cv, tk, tv, cl, tl, out, B, H, KV, Tc, n, scale, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block, in bytes. Above the card's per-block
// limit cudaFuncSetAttribute fails, and the launch returns that error.
size_t smem_bytes(int H, int KV, int T, int n, int hd) {
  const size_t G = H / KV;
  return 4 * (G * hd + G * (T + n) + static_cast<size_t>(kWarps) * G * hd);
}

}  // namespace

// C entry point, bound with ctypes. q (B, H, hd); ck/cv (B, KV, T, hd); tk/tv
// (B, KV, n, hd); out (B, H, hd), all contiguous and of one element type
// (dtype 0: bf16, 1: f32); cache_len / tail_len (B,) int32 on the device.
// Shapes are checked by the Python wrapper (s2s_tpu_torch/ops/decode_attention.py):
// hd in {64, 128}, H % KV == 0, H / KV <= 8. Returns the cudaError_t of the launch.
extern "C" int s2s_decode_attention(const void* q, const void* ck, const void* cv,
                                    const void* tk, const void* tv, const void* cache_len,
                                    const void* tail_len, void* out, int B, int H, int KV,
                                    int T, int n, int hd, int dtype, float scale,
                                    void* stream) {
  if (H % KV != 0 || H / KV > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H, KV, T, n, hd);
  const auto* cl = static_cast<const int*>(cache_len);
  const auto* tl = static_cast<const int*>(tail_len);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<__nv_bfloat16>(hd, q, ck, cv, tk, tv, cl, tl, out, B, H, KV, T, n, scale, smem, st);
  if (dtype == 1)
    return dispatch_hd<float>(hd, q, ck, cv, tk, tv, cl, tl, out, B, H, KV, T, n, scale, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
