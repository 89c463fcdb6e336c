// Fused log-mel frontend on Hopper (sm_90a): reflect-padded framing, windowed
// DFT, power and mel projection in one kernel; out (T, n_mels) f32 mel power.
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/pallas_mel.py::log_mel_spectrogram_pallas
// (body `_mel_kernel`), with its math per frame t (samples t * hop - n_fft / 2
// onward, reflected at both ends of the audio):
//   re = frame @ cos_basis, im = frame @ sin_basis  (the hann window is in the
//   bases);  power = re^2 + im^2;  mel = power @ filterbank.
// log10, the global max, the clamp at max - 8 and (x + 4) / 4 stay torch ops,
// as they stay outside the Pallas kernel. The bases (n_fft, n_freqs) and the
// filterbank (n_freqs, n_mels) are arguments, so n_fft, hop and n_mels are
// parameters. Everything is f32 on the CUDA cores: no TF32, since the output
// feeds a log10 and a max - 8 clamp.
//
// What bounds it: the function itself needs a real FFT per frame, the power
// and the filterbank's nonzero weights (a few bins per mel): about 10 kFLOP
// per frame against 4 bytes read per hop of audio (640 per frame) and
// 4 * n_mels bytes written, so its floor is the bytes. This kernel computes
// the DFT directly (2 * n_fft * n_freqs multiply-adds per frame, about 30x
// an FFT's operations) and reads each frame tile's bases from L2; at the few
// hundred frames of a serving window its time is set by the latency of one
// block's chain of dependent loads and FMAs, not by the card's rates.
//
// How the design answers that:
// - One block per tile of 8 frames, 4 x 224 threads: 7 warps of bins (one bin
//   per lane, 201 used) times 4 groups, each summing a quarter of the n_fft
//   samples. Splitting the samples over more threads shortens each thread's
//   chain of loads and FMAs, which is what a short window waits on (one
//   group per bin was slower at every window tried on an H100).
// - The block loads the padded audio span its frames cover, 7 * hop + n_fft
//   samples, once into shared memory, reflecting indices at the ends:
//   overlapping frames share samples and no (T, n_fft) frame matrix is built.
//   Each thread reads 4 consecutive samples of a frame as one float4
//   broadcast, and its bin's basis values straight from the L2-resident
//   bases (consecutive across the warp).
// - The four groups' partial sums meet in shared memory in a fixed order;
//   the tile's power spectrum stays there, and the mel projection reads only
//   the rows of each mel's triangle (`band`: the filterbank is exactly zero
//   elsewhere, so the sum is the dense product's, bit for bit).
// - No atomics: the same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 8;        // frames per block
constexpr int kGroups = 4;   // sample groups: each sums n_fft / 4 samples
constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
log_mel_kernel(const float* __restrict__ audio, int n, const float* __restrict__ cosb,
               const float* __restrict__ sinb, const float* __restrict__ fb,
               const int* __restrict__ band, float* __restrict__ out, int n_frames, int n_fft,
               int hop, int n_freqs, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  const int span = (kF - 1) * hop + n_fft;
  const int nb = blockDim.x / kGroups;            // bins padded to whole warps
  float* xs = smem;                               // [span] padded audio of the tile
  float* part = xs + span;                        // [kGroups - 1][2][kF][nb] partial re, im
  float* pw = part + 2 * (kGroups - 1) * kF * nb;  // [kF][nb] power

  const int t0 = blockIdx.x * kF;
  const int tid = threadIdx.x;
  const long long pad = n_fft / 2;
  const long long padded_len = n + 2 * pad;
  const long long p0 = static_cast<long long>(t0) * hop;
  for (int i = tid; i < span; i += blockDim.x) {
    const long long p = p0 + i;
    float x = 0.f;
    if (p < padded_len) {
      long long idx = p - pad;
      if (idx < 0) idx = -idx;
      if (idx >= n) idx = 2 * (static_cast<long long>(n) - 1) - idx;
      x = audio[idx];
    }
    xs[i] = x;
  }
  __syncthreads();

  // thread (g, b): bin b (lanes past n_freqs repeat the last bin and are not
  // read), samples [g * n_fft / 4, (g + 1) * n_fft / 4) of all kF frames
  const int g = tid / nb, b = tid % nb;
  const int k = min(b, n_freqs - 1);
  const int r0 = g * (n_fft / kGroups), r1 = r0 + n_fft / kGroups;
  const float* cp = cosb + k;
  const float* sp = sinb + k;
  float re[kF], im[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) re[f] = im[f] = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; r += 4) {
    float c[4], s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c[u] = __ldg(cp + (r + u) * n_freqs);
      s[u] = __ldg(sp + (r + u) * n_freqs);
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const float4 x = *reinterpret_cast<const float4*>(xs + f * hop + r);
      re[f] = fmaf(x.x, c[0], re[f]);
      im[f] = fmaf(x.x, s[0], im[f]);
      re[f] = fmaf(x.y, c[1], re[f]);
      im[f] = fmaf(x.y, s[1], im[f]);
      re[f] = fmaf(x.z, c[2], re[f]);
      im[f] = fmaf(x.z, s[2], im[f]);
      re[f] = fmaf(x.w, c[3], re[f]);
      im[f] = fmaf(x.w, s[3], im[f]);
    }
  }
  if (g > 0) {
    float* pr = part + (g - 1) * 2 * kF * nb;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      pr[f * nb + b] = re[f];
      pr[(kF + f) * nb + b] = im[f];
    }
  }
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      float rs = re[f], is = im[f];
#pragma unroll
      for (int q = 1; q < kGroups; ++q) {
        const float* pr = part + (q - 1) * 2 * kF * nb;
        rs += pr[f * nb + b];
        is += pr[(kF + f) * nb + b];
      }
      pw[f * nb + b] = rs * rs + is * is;
    }
  }
  __syncthreads();

  for (int i = tid; i < kF * n_mels; i += blockDim.x) {
    const int f = i / n_mels, m = i % n_mels;
    const int t = t0 + f;
    if (t >= n_frames) continue;
    const int lo = band[2 * m], hi = band[2 * m + 1];
    const float* prow = pw + f * nb;
    float acc = 0.f;
#pragma unroll 8
    for (int kk = lo; kk < hi; ++kk) acc = fmaf(prow[kk], __ldg(fb + kk * n_mels + m), acc);
    out[static_cast<long long>(t) * n_mels + m] = acc;
  }
}

}  // namespace

// C entry point, bound with ctypes. audio (n,) f32; cos/sin bases (n_fft,
// n_freqs) and filterbank (n_freqs, n_mels) f32; band (n_mels, 2) int32, the
// [first, last + 1) filterbank row of each mel's nonzero weights; out
// (n_frames, n_mels) f32; all contiguous on the device. Frame t starts at
// padded sample t * hop of the audio reflect-padded by n_fft / 2 on each side.
// Needs n_freqs <= 256 (4 groups of up to 256 bins fill a 1024-thread block),
// hop % 4 == 0 and n_fft % 16 == 0 (float4 reads of each group's quarter), n >
// n_fft / 2; the Python wrapper (s2s_tpu_torch/ops/log_mel.py) checks the same.
// Returns the cudaError_t of the launch.
extern "C" int s2s_log_mel(const void* audio, int n, const void* cosb, const void* sinb,
                           const void* fb, const void* band, void* out, int n_frames, int n_fft,
                           int hop, int n_freqs, int n_mels, void* stream) {
  const int nb = 32 * ((n_freqs + 31) / 32);
  if (n_frames < 1 || n <= n_fft / 2 || hop < 1 || hop % 4 || n_fft % (4 * kGroups) || n_mels < 1 ||
      n_freqs < 1 || kGroups * nb > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(kF - 1) * hop + n_fft +
                                       static_cast<size_t>(2 * (kGroups - 1) + 1) * kF * nb);
  // 56 KB at 201 bins: above the default 48 KB, so allow up to the card's
  // per-block opt-in limit, once; a larger request fails at the launch
  static const cudaError_t attr = [] {
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    return err;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n_frames + kF - 1) / kF);
  log_mel_kernel<<<grid, kGroups * nb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), n, static_cast<const float*>(cosb), static_cast<const float*>(sinb),
      static_cast<const float*>(fb), static_cast<const int*>(band), static_cast<float*>(out), n_frames, n_fft,
      hop, n_freqs, n_mels);
  return static_cast<int>(cudaGetLastError());
}
