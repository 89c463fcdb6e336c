// W8A8 dynamic int8 matmul for decode-shaped linears on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/int8_matmul.py::int8_matmul_dyn
// (body `_kernel_dyn`, with the per-row activation quantization that runs in
// XLA before it): for x (B, K) bf16, q (K, N) int8 and wscale (N,) f32,
//   xscale[b] = max(max_k |x[b, k]| / 127, 1e-12)
//   xq[b, k]  = clip(rint(x[b, k] / xscale[b]), -127, 127)       (int8)
//   out[b, n] = bf16_rn((float(sum_k xq[b, k] * q[k, n]) * xscale[b]) * wscale[n])
// Every step is exact or correctly rounded in the same order as the plain
// version (IEEE division, round half to even, integer sums, two f32
// multiplies, one rounding), so the output is bit-equal to
// int8_matmul_dyn_reference. |sum| <= 127^2 * K < 2^31 for K <= 8192.
//
// What bounds it: on the serving path B is 8..64 rows (the W8A16 route takes
// fewer), so each call must read the K * N int8 weight bytes once; x, xq and
// the outputs are small next to them. The floor is K * N bytes / HBM
// bandwidth (the int8 operations, 2 * B * K * N, are far below the 1,979
// TOP/s int8 peak at these row counts).
//
// How the design answers that (a simple, exact first version):
// - Quantize: one block per row; the absmax is reduced through warp shuffles
//   and shared memory, then every thread writes its slice of xq.
// - Product: a block owns 128 columns (32 lanes x 4) and up to 8 rows; each
//   warp walks K four rows at a time, loads a 4 x 4 byte tile of q (four
//   coalesced 4-byte loads of one 128-byte line each), transposes it with
//   __byte_perm so each register holds
//   4 consecutive K of one column, and accumulates with __dp4a against 4
//   packed bytes of xq. Sums stay int32 through the cross-warp reduction and
//   the K split over blocks (int32 partials and a second pass: exact in any
//   order, no atomics), and only the epilogue touches floats.
// Tensor cores (mma/wgmma s8 from 16 rows) and TMA-fed staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 128;  // 32 lanes x 4 int8 columns
constexpr int kRows = 8;     // rows per block

__global__ void __launch_bounds__(kThreads)
w8a8_quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                          float* __restrict__ xscale, int K) {
  const int row = blockIdx.x;
  const __nv_bfloat16* xr = x + static_cast<size_t>(row) * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kWarps];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = fmaxf(amax / 127.0f, 1e-12f);
  if (threadIdx.x == 0) xscale[row] = s;
  int8_t* qr = xq + static_cast<size_t>(row) * K;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = rintf(__bfloat162float(xr[k]) / s);
    qr[k] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
}

__global__ void __launch_bounds__(kThreads)
w8a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xscale,
                 const int8_t* __restrict__ q, const float* __restrict__ wscale,
                 __nv_bfloat16* __restrict__ out, int* __restrict__ partial, int B, int K, int N,
                 int k_per_split) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kTileN;
  const int n0 = col0 + lane * 4;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * kRows;
  const int rows = min(kRows, B - b0);
  const int k_begin = split * k_per_split;
  const int k_end = k_begin + k_per_split;

  int acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
  }

#pragma unroll 2
  for (int k = k_begin + 4 * warp; k < k_end; k += 4 * kWarps) {
    const int8_t* qk = q + static_cast<size_t>(k) * N + n0;
    const int w0 = *reinterpret_cast<const int*>(qk);
    const int w1 = *reinterpret_cast<const int*>(qk + N);
    const int w2 = *reinterpret_cast<const int*>(qk + 2 * static_cast<size_t>(N));
    const int w3 = *reinterpret_cast<const int*>(qk + 3 * static_cast<size_t>(N));
    // transpose the 4 x 4 byte tile: col[c] = (w0.c, w1.c, w2.c, w3.c)
    const unsigned t0 = __byte_perm(w0, w1, 0x5140);
    const unsigned t1 = __byte_perm(w2, w3, 0x5140);
    const unsigned t2 = __byte_perm(w0, w1, 0x7362);
    const unsigned t3 = __byte_perm(w2, w3, 0x7362);
    const int col[4] = {static_cast<int>(__byte_perm(t0, t1, 0x5410)), static_cast<int>(__byte_perm(t0, t1, 0x7632)),
                        static_cast<int>(__byte_perm(t2, t3, 0x5410)), static_cast<int>(__byte_perm(t2, t3, 0x7632))};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int xv = r < rows ? *reinterpret_cast<const int*>(xq + static_cast<size_t>(b0 + r) * K + k) : 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(xv, col[c], acc[r][c]);
    }
  }

  __shared__ int red[kWarps][kRows][kTileN];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * kTileN; i += kThreads) {
    const int r = i / kTileN;
    const int c = i % kTileN;
    const int b = b0 + r;
    if (b >= B) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][r][c];
    const int n = col0 + c;
    if (partial == nullptr) {
      out[static_cast<size_t>(b) * N + n] = __float2bfloat16_rn((__int2float_rn(s) * xscale[b]) * wscale[n]);
    } else {
      partial[(static_cast<size_t>(split) * B + b) * N + n] = s;
    }
  }
}

__global__ void w8a8_splitk_reduce_kernel(const int* __restrict__ partial, const float* __restrict__ xscale,
                                          const float* __restrict__ wscale, __nv_bfloat16* __restrict__ out,
                                          int splits, int B, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  int s = 0;
  for (int sp = 0; sp < splits; ++sp) s += partial[static_cast<size_t>(sp) * B * N + i];
  out[i] = __float2bfloat16_rn((__int2float_rn(s) * xscale[i / N]) * wscale[i % N]);
}

}  // namespace

// C entry point, bound with ctypes. Shapes and alignment are checked by the
// Python wrapper (s2s_tpu_torch/ops/int8_matmul.py): 1 <= B <= 64, K % 128 == 0,
// N % 128 == 0, (K / splits) % 64 == 0, 16-byte aligned q. `xq` (B, K) int8 and
// `xscale` (B,) f32 are workspaces; `partial` is an int32 (splits, B, N)
// workspace when splits > 1 and null otherwise. Returns the cudaError_t of the
// launches.
extern "C" int s2s_int8_matmul_dyn(const void* x, const void* q, const void* wscale, void* out, void* xq,
                                   void* xscale, void* partial, int B, int K, int N, int splits,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* xqb = static_cast<int8_t*>(xq);
  auto* xsb = static_cast<float*>(xscale);
  const auto* ws = static_cast<const float*>(wscale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* pb = splits > 1 ? static_cast<int*>(partial) : nullptr;
  w8a8_quantize_rows_kernel<<<B, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(x), xqb, xsb, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / kTileN, splits, (B + kRows - 1) / kRows);
  w8a8_gemv_kernel<<<grid, kThreads, 0, st>>>(xqb, xsb, static_cast<const int8_t*>(q), ws, ob, pb, B, K, N,
                                              K / splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (B * N + threads - 1) / threads;
  w8a8_splitk_reduce_kernel<<<blocks, threads, 0, st>>>(pb, xsb, ws, ob, splits, B, N);
  return static_cast<int>(cudaGetLastError());
}
