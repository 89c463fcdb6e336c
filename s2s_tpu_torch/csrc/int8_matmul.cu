// W8A16 int8 weight-only matmul for decode-shaped linears on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/int8_matmul.py::int8_matmul
// (body `_kernel`): out (B, N) bf16 = (x (B, K) bf16 @ q (K, N) int8) * scale (N,)
// with the int8 -> float convert done in registers, f32 accumulation, the
// per-output-channel scale applied in f32 and one rounding to bf16.
//
// What bounds it: at the decode batch sizes of the serving path (B = 1..2 rows
// per call; at most 64 by contract) this is a GEMV. Each call must read the
// K * N int8 weight bytes once; the activations (B * K * 2 bytes) and outputs
// are small next to them, so the floor is K * N bytes / HBM bandwidth.
//
// How the design answers that:
// - Every weight byte is read from HBM exactly once per 8-row tile, as
//   coalesced 4-byte loads: a warp reads one 128-byte line of a weight row
//   (32 lanes x 4 columns), so a block owns a 128-column tile.
// - The TPU kernel walks N in 256-column tiles and loads the full K per grid
//   step. On a GPU that gives N / 256 blocks (8 for N = 2048) on 132 SMs, so
//   here the K dimension is split twice: across the 8 warps of a block
//   (reduced through shared memory) and across `splits` blocks (written as f32
//   partial sums and reduced by a second, deterministic kernel; no atomics).
// - x never has to fit in shared memory: each block reads only the x[:, k]
//   values of its own K range, and a warp reads each as a broadcast load.
// - Rows are processed RB at a time (RB = 1, 2, 4 or 8, picked from B), so a
//   1-row decode call keeps 4 accumulators per thread and a 64-row call 32.
//
// Later work (tensor cores through mma/wgmma for B >= 16, TMA-fed smem
// pipelines) is listed in ROADMAP.md; this kernel is the simple, exact first
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 128;  // 32 lanes x 4 int8 columns

template <int RB>
__global__ void __launch_bounds__(kThreads)
int8_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ partial, int B, int K, int N, int k_per_split) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kTileN;
  const int n0 = col0 + lane * 4;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * RB;
  const int rows = min(RB, B - b0);
  const int k_begin = split * k_per_split;
  const int k_end = k_begin + k_per_split;

  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

#pragma unroll 4
  for (int k = k_begin + warp; k < k_end; k += kWarps) {
    const char4 w = *reinterpret_cast<const char4*>(q + static_cast<size_t>(k) * N + n0);
    const float w0 = static_cast<float>(w.x);
    const float w1 = static_cast<float>(w.y);
    const float w2 = static_cast<float>(w.z);
    const float w3 = static_cast<float>(w.w);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float xv =
          r < rows ? __bfloat162float(x[static_cast<size_t>(b0 + r) * K + k]) : 0.f;
      acc[r][0] = fmaf(xv, w0, acc[r][0]);
      acc[r][1] = fmaf(xv, w1, acc[r][1]);
      acc[r][2] = fmaf(xv, w2, acc[r][2]);
      acc[r][3] = fmaf(xv, w3, acc[r][3]);
    }
  }

  __shared__ float red[kWarps][RB][kTileN];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < RB * kTileN; i += kThreads) {
    const int r = i / kTileN;
    const int c = i % kTileN;
    const int b = b0 + r;
    if (b >= B) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][r][c];
    const int n = col0 + c;
    if (partial == nullptr) {
      out[static_cast<size_t>(b) * N + n] = __float2bfloat16(s * scale[n]);
    } else {
      partial[(static_cast<size_t>(split) * B + b) * N + n] = s;
    }
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     __nv_bfloat16* __restrict__ out, int splits, int B,
                                     int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[static_cast<size_t>(sp) * B * N + i];
  out[i] = __float2bfloat16(s * scale[i % N]);
}

template <int RB>
void launch_gemv(const __nv_bfloat16* x, const int8_t* q, const float* scale,
                 __nv_bfloat16* out, float* partial, int B, int K, int N, int splits,
                 cudaStream_t stream) {
  const dim3 grid(N / kTileN, splits, (B + RB - 1) / RB);
  int8_gemv_kernel<RB><<<grid, kThreads, 0, stream>>>(x, q, scale, out, partial, B, K, N,
                                                      K / splits);
}

}  // namespace

// C entry point, bound with ctypes. Shapes and alignment are checked by the
// Python wrapper (s2s_tpu_torch/ops/int8_matmul.py): 1 <= B <= 64, K % 128 == 0,
// N % 128 == 0, (K / splits) % 8 == 0, 4-byte aligned q rows. `partial` is an
// f32 (splits, B, N) workspace when splits > 1 and null otherwise. Returns the
// cudaError_t of the launches.
extern "C" int s2s_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                               void* partial, int B, int K, int N, int splits,
                               void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* pb = splits > 1 ? static_cast<float*>(partial) : nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  if (B <= 1) {
    launch_gemv<1>(xb, qb, sb, ob, pb, B, K, N, splits, st);
  } else if (B <= 2) {
    launch_gemv<2>(xb, qb, sb, ob, pb, B, K, N, splits, st);
  } else if (B <= 4) {
    launch_gemv<4>(xb, qb, sb, ob, pb, B, K, N, splits, st);
  } else {
    launch_gemv<8>(xb, qb, sb, ob, pb, B, K, N, splits, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (B * N + threads - 1) / threads;
  splitk_reduce_kernel<<<blocks, threads, 0, st>>>(pb, sb, ob, splits, B, N);
  return static_cast<int>(cudaGetLastError());
}
