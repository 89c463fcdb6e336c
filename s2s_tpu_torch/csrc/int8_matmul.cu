// W8A16 int8 weight-only matmul for decode-shaped linears on Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/int8_matmul.py::int8_matmul
// (body `_kernel`): out (B, N) bf16 = (x (B, K) bf16 @ q (K, N) int8) * scale (N,)
// with the int8 -> bf16/f32 convert on the chip, f32 accumulation, the
// per-output-channel scale applied in f32 and one rounding to bf16.
//
// The kernel is csrc/weight_only_matmul.cuh's template with one weight plane
// per stored row (Int8Weights); that header says how each regime works.
//
// What bounds it, and what the design does about it:
// - 1 <= B < 5 (the served decode steps: B 1 and 4; 5 is the crossover
//   measured on an H100, s2s_tpu_torch/ops/weight_only.py CUTOFF): the
//   K * N weight bytes over 3.35 TB/s (3.75 us at 2048 x 6144), and at 2-4 MB
//   layers a launch's fixed latency. One launch per call, K split over a
//   cluster whose CTAs combine through distributed shared memory (no second
//   kernel, no workspace); about 48 KB of weight in flight per SM in TMA
//   boxes; x read once per CTA into shared memory; the int8 -> f32 convert
//   is a byte permute and a subtraction.
// - From 5 to 64 rows (the width buckets 8 and 16, the 16-64 token prompt
//   buckets): still the weight bytes (5.0 us at 64 x 2048 x 8192, where the
//   bf16 tensor work is 2.2 us), which the earlier kernel re-read once per
//   8-row tile and summed on the CUDA cores. Now wgmma on tensor cores,
//   every weight byte read once for all rows; the convert to bf16, which
//   sets the loop's time, runs in two warpgroups on alternate tiles, each
//   overlapping the other's products.
//
// The earlier design (one thread per 4 columns, 4-byte loads, a split-K
// second kernel with an f32 workspace): 17.8 us at B 1, 2048 x 6144 (bound
// 3.77) and 224.5 us at 64 x 2048 x 8192 (H100 80GB HBM3, 700 W, PERF.md).

#include "weight_only_matmul.cuh"

// C entry point, bound with ctypes. x (B, K) bf16, q (K, N) int8, scale (N,)
// f32, out (B, N) bf16, contiguous, x and q 16-byte aligned; `plan` the
// wrapper's launch plan (weight_only::Plan, 6 ints). Shapes are checked by
// the Python wrapper (s2s_tpu_torch/ops/int8_matmul.py): 1 <= B <= 64,
// K % 128 == 0, N % 128 == 0. Returns the cudaError_t of the launch.
extern "C" int s2s_int8_matmul(const void* x, const void* q, const void* scale, void* out, int B, int K, int N,
                               const int* plan, void* stream) {
  return weight_only::run<weight_only::Int8Weights>(x, q, scale, out, B, K, N, plan,
                                                    static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` CTAs with `bytes` of dynamic shared memory each that
// the card runs at once, or a negative cudaError_t: the wrapper plans one
// wave against it (at more than half an SM's shared memory a CTA, both
// regimes' kernels run one CTA an SM, so either one's count serves both).
extern "C" int s2s_weight_only_clusters(int cluster, int bytes) {
  namespace wo = weight_only;
  return wo::max_active_clusters<wo::weight_only_gemv_kernel<wo::Int8Weights, 128, 1>>(cluster, bytes,
                                                                                         wo::kGemvThreads);
}
