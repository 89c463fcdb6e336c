// Packed int4 weight-only matmul for decode-shaped linears on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/int4_matmul.py::int4_matmul
// (body `_kernel`): for x (B, K) bf16, packed (K/2, N) int8 and scale (N,) f32,
//   out (B, N) bf16 = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale
// where byte packed[k, n] holds lo[k, n] = sext4(byte & 0xF) and
// hi[k, n] = byte >> 4 (an arithmetic shift of the sign-extended byte), the
// weights of rows k and k + K/2. The nibbles are unpacked in registers, the
// sums accumulate in f32, the per-channel scale is applied once in f32 and
// the result is rounded once to bf16.
//
// What bounds it: at the decode batch sizes of the serving path (the code
// predictor's 15 MTP steps per codec frame at 1..4 rows; at most 64 rows by
// contract) this is a GEMV. Each call must read the K * N / 2 packed bytes
// once; x (B * K * 2 bytes) and the outputs are small next to them, so the
// floor is K * N / 2 bytes / HBM bandwidth.
//
// How the design answers that: the shape of the W8A16 kernel
// (csrc/int8_matmul.cu). Every packed byte is read from HBM once per 8-row
// tile as coalesced 4-byte loads (a warp reads one 128-byte line of a packed
// row: 32 lanes x 4 columns, so a block owns 128 columns). The packed K/2 rows
// are split across the 8 warps of a block (reduced through shared memory) and
// across `splits` blocks (f32 partial sums reduced by a second, deterministic
// kernel; no atomics), so a 2048-column layer still fills the 132 SMs. Each
// block reads only the x[:, k] and x[:, k + K/2] values of its own range, as
// broadcast loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 128;  // 32 lanes x 4 packed columns

template <int RB>
__global__ void __launch_bounds__(kThreads)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ partial, int B, int K, int N, int k2_per_split) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kTileN;
  const int n0 = col0 + lane * 4;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * RB;
  const int rows = min(RB, B - b0);
  const int half = K / 2;
  const int k_begin = split * k2_per_split;
  const int k_end = k_begin + k2_per_split;

  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

#pragma unroll 4
  for (int k = k_begin + warp; k < k_end; k += kWarps) {
    const char4 w = *reinterpret_cast<const char4*>(packed + static_cast<size_t>(k) * N + n0);
    const int bytes[4] = {w.x, w.y, w.z, w.w};  // sign-extended
    float lo[4], hi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo[c] = static_cast<float>(static_cast<int>(static_cast<unsigned>(bytes[c]) << 28) >> 28);
      hi[c] = static_cast<float>(bytes[c] >> 4);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const __nv_bfloat16* xr = x + static_cast<size_t>(b0 + r) * K;
      const float xl = r < rows ? __bfloat162float(xr[k]) : 0.f;
      const float xh = r < rows ? __bfloat162float(xr[k + half]) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xh, hi[c], fmaf(xl, lo[c], acc[r][c]));
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
      out[static_cast<size_t>(b) * N + n] = __float2bfloat16_rn(s * scale[n]);
    } else {
      partial[(static_cast<size_t>(split) * B + b) * N + n] = s;
    }
  }
}

__global__ void int4_splitk_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                                          __nv_bfloat16* __restrict__ out, int splits, int B, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[static_cast<size_t>(sp) * B * N + i];
  out[i] = __float2bfloat16_rn(s * scale[i % N]);
}

template <int RB>
void launch_gemv(const __nv_bfloat16* x, const int8_t* packed, const float* scale, __nv_bfloat16* out,
                 float* partial, int B, int K, int N, int splits, cudaStream_t stream) {
  const dim3 grid(N / kTileN, splits, (B + RB - 1) / RB);
  int4_gemv_kernel<RB><<<grid, kThreads, 0, stream>>>(x, packed, scale, out, partial, B, K, N,
                                                      K / 2 / splits);
}

}  // namespace

// C entry point, bound with ctypes. Shapes and alignment are checked by the
// Python wrapper (s2s_tpu_torch/ops/int4_matmul.py): 1 <= B <= 64, K % 256 == 0,
// N % 128 == 0, (K / 2 / splits) % 64 == 0, 16-byte aligned packed rows.
// `partial` is an f32 (splits, B, N) workspace when splits > 1 and null
// otherwise. Returns the cudaError_t of the launches.
extern "C" int s2s_int4_matmul(const void* x, const void* packed, const void* scale, void* out, void* partial,
                               int B, int K, int N, int splits, void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pk = static_cast<const int8_t*>(packed);
  const auto* sb = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* pb = splits > 1 ? static_cast<float*>(partial) : nullptr;
  auto st = static_cast<cudaStream_t>(stream);
  if (B <= 1) {
    launch_gemv<1>(xb, pk, sb, ob, pb, B, K, N, splits, st);
  } else if (B <= 2) {
    launch_gemv<2>(xb, pk, sb, ob, pb, B, K, N, splits, st);
  } else if (B <= 4) {
    launch_gemv<4>(xb, pk, sb, ob, pb, B, K, N, splits, st);
  } else {
    launch_gemv<8>(xb, pk, sb, ob, pb, B, K, N, splits, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (B * N + threads - 1) / threads;
  int4_splitk_reduce_kernel<<<blocks, threads, 0, st>>>(pb, sb, ob, splits, B, N);
  return static_cast<int>(cudaGetLastError());
}
