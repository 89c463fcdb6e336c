// Packed int4 weight-only matmul for decode-shaped linears on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/int4_matmul.py::int4_matmul
// (body `_kernel`): for x (B, K) bf16, packed (K/2, N) int8 and scale (N,) f32,
//   out (B, N) bf16 = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale
// where byte packed[k, n] holds lo[k, n] = sext4(byte & 0xF) and
// hi[k, n] = byte >> 4 (an arithmetic shift of the sign-extended byte), the
// weights of rows k and k + K/2. The nibbles are unpacked on the chip, the
// sums accumulate in f32, the per-channel scale is applied once in f32 and
// the result is rounded once to bf16.
//
// The kernel is csrc/weight_only_matmul.cuh's template with two weight
// planes per stored row (Int4Weights): one packed box feeds rows k and
// k + K/2, paired with x[:, k] and x[:, K/2 + k]; that header says how each
// regime works.
//
// What bounds it, and what the design does about it:
// - 1 <= B < 3 (the code predictor's 15 MTP steps per codec frame at one
//   session, its 2-token prefill at 2; 3 is the crossover measured on an
//   H100, s2s_tpu_torch/ops/weight_only.py CUTOFF): the K * N / 2 packed bytes
//   over 3.35 TB/s (1.88 us at 2048 x 6144), and at its 1 MB layers (the
//   K/V projections, 2048 x 1024) a launch's fixed latency. One launch per
//   call (K split over a cluster, combined through distributed shared
//   memory; no reduce kernel, no workspace); about 48 KB of packed weight in
//   flight per SM in TMA boxes; both x slices read once per CTA; the unpack
//   is a shift, a lop3 and a subtraction per value.
// - From 3 to 64 rows (the 4-session MTP steps, their prefill at 8): the
//   packed bytes, then the bf16 tensor work (2.2 us at 64 x 2048 x 8192).
//   wgmma on tensor cores, each packed tile unpacked into two bf16 tiles
//   (the rows k and k + K/2) with lop3 on a magic exponent, every packed
//   byte read once for all rows, the unpack in two warpgroups on alternate
//   tiles.
//
// The earlier design (the first W8A16 kernel's shape reading packed bytes,
// with a split-K second kernel and an f32 workspace): 13.8 us at B 4,
// 2048 x 6144 (bound 1.90) and 162.3 us at 64 x 2048 x 8192 (H100 80GB HBM3,
// 700 W, PERF.md).

#include "weight_only_matmul.cuh"

// C entry point, bound with ctypes. x (B, K) bf16, packed (K/2, N) int8,
// scale (N,) f32, out (B, N) bf16, contiguous, x and packed 16-byte aligned;
// `plan` the wrapper's launch plan (weight_only::Plan, 6 ints). Shapes are
// checked by the Python wrapper (s2s_tpu_torch/ops/int4_matmul.py):
// 1 <= B <= 64, K % 256 == 0, N % 128 == 0. Returns the cudaError_t of the
// launch.
extern "C" int s2s_int4_matmul(const void* x, const void* packed, const void* scale, void* out, int B, int K, int N,
                               const int* plan, void* stream) {
  return weight_only::run<weight_only::Int4Weights>(x, packed, scale, out, B, K, N, plan,
                                                    static_cast<cudaStream_t>(stream));
}
