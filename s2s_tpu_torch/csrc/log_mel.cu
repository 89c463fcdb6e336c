// Log-mel features on Hopper (sm_90a) in one cooperative launch: framing, a
// mixed-radix FFT per frame, power, the mel projection, the log and the
// reduction-dependent epilogue.
//
// Replaces the TPU Pallas kernel s2s_tpu/ops/pallas_mel.py::log_mel_spectrogram_pallas
// (body `_mel_kernel`) and the log steps that the JAX package runs after it,
// in two forms:
// - Whisper (Whisper STT, Smart Turn, the voice-clone speaker): audio (N,),
//   frames of 400 at hop 160 from the audio reflect-padded by 200 (the last
//   frame dropped), periodic hann(400), power, the slaney filterbank,
//   log10(max(mel, 1e-10)), the clamp at the call's global max - 8, then
//   (x + 4) / 4; out (n_mels, N // 160).
// - Parakeet's frontend, which is XLA in the JAX package
//   (s2s_tpu/models/parakeet.py:134 `log_mel_frontend`, under `vmap` at :531)
//   and rides on this kernel in the port: audio (B, N) and n_valid (B,);
//   preemphasis 0.97 over the valid samples, zero padding by 256, a symmetric
//   hann(400) centred in 512 points, power over 257 bins, the filterbank,
//   log(mel + 2^-24), then per row and mel the mean and the std (divisor
//   n - 1) over the row's n_valid // 160 frames, (x - mean) / (std + 1e-5),
//   invalid frames zeroed; out (B, 1 + N // 160, n_mels).
//
// What bounds it: the function's bytes are the audio in and the features out
// (under 30 MB), and its operations a real FFT, the power and a few
// filterbank weights a mel per frame: the bytes bound it, well under a
// launch's latency for one row and a few microseconds for the largest
// batch (16 rows of 15 s). Above that sit the latency of one launch and, since both
// epilogues depend on a reduction over the whole call (Whisper's global max,
// Parakeet's per-row mean and then variance), the grid-wide barriers; a
// block's chain of dependent shared-memory steps per tile comes on top, and
// for Parakeet every block's reads of its rows' partial sums.
// s2s_tpu_torch/tools/log_mel_ablation.py times each part on a card.
//
// How the design answers that:
// - One cooperative launch (cudaLaunchCooperativeKernel; grid.sync needs no
//   -rdc) of persistent blocks, the grid sized by the occupancy API; each
//   block walks a contiguous run of frame tiles (frames_per_tile frames of
//   one row; the wrapper's launch_plan takes the fewest frames that give
//   each tile a block of its own at two blocks an SM, and for Parakeet at
//   most 32 tiles a row). A grid the card cannot hold at once is refused by
//   the launch, never run.
// - A block loads the audio span of a tile once into shared memory (reflected
//   for Whisper; for Parakeet preemphasised and masked to n_valid while
//   loading, zero outside), applies the window from a table, packs each real
//   frame as n_fft / 2 complex points and runs a Stockham autosort FFT of
//   radices 8, 5, 4, 2 (200 = 8 x 5 x 5, 256 = 8 x 8 x 4) in shared
//   memory, one thread per complex point (each thread's indices and
//   twiddles worked out once a stage); the real-FFT split then gives the
//   n_fft / 2 + 1 bins. Twiddles exp(-2 pi i k / n_fft) and the window are f32
//   tables built on the host in f64: the FFT's twiddles W_M^q are table
//   entries 2q, and the radix-5 and radix-8 constants are entries too.
// - The mel projection sums each mel's nonzero filterbank weights only (a
//   band of rows, packed in shared memory): the skipped terms are exact
//   zeros, so the sum is the dense sequential one bit for bit.
// - Everything is f32 on the CUDA cores: no TF32, since the output feeds a
//   log and a max - 8 clamp.
// - The tiles' log-mel stays in shared memory across the grid barriers where
//   it fits (else it waits at its place in the output, in L2), so the
//   epilogue reads no recomputed value. Whisper: one barrier after each
//   block's max; every block then reads all blocks' maxima. Parakeet: two
//   barriers, the mean, then the sum of squared deviations (not a one-pass
//   sum of squares), each summed per row over fixed segments (a row's first
//   tile and every block boundary inside it) in a fixed order.
// - No atomics: the same bits on every run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;  // one thread per complex point: n_fft / 2 <= 256
constexpr float kLogGuard = 5.9604644775390625e-08f;  // 2^-24
constexpr float kNormEps = 1e-5f;
constexpr int kInFlight = 16;  // loads a thread issues before it adds, in the row sums

struct Args {
  const float* audio;   // (rows, n)
  const int* n_valid;   // (rows,) valid samples (Parakeet)
  const float2* tw;     // (n_fft,) exp(-2 pi i k / n_fft)
  const float* window;  // (n_fft,)
  const int* band;      // (n_mels, 3): first filterbank row, end row, offset in wts
  const float* wts;     // (n_wts,) each mel's nonzero weights, band after band
  float* out;           // Whisper (n_mels, n_frames); Parakeet (rows, n_frames, n_mels)
  int* frames_out;      // Parakeet (rows,): n_valid // hop
  float* partial;       // Whisper (grid,) block maxima; Parakeet (2, tiles, n_mels) segment sums
  int rows, n, n_frames, n_fft, hop, n_mels, n_wts, radices, frames_per_tile, tiles_per_row, tiles_per_block,
      cache;
  float preemphasis;
};

// Shared-memory layout in floats, each region a multiple of 16 bytes; the
// host sizes the launch with the same function.
struct Layout {
  int tw, win, wts, band, xs, buf0, buf1, red, stats, cache, total;
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline Layout layout(bool parakeet, int n_fft, int hop, int n_mels, int n_wts, int frames,
                                         int tiles_per_block, bool cache) {
  Layout l;
  int o = 0;
  l.tw = o, o += 2 * n_fft;
  l.win = o, o += up4(n_fft);
  l.wts = o, o += up4(n_wts);
  l.band = o, o += up4(3 * n_mels);
  l.xs = o, o += up4((frames - 1) * hop + n_fft);
  l.buf0 = o, o += up4(frames * n_fft);  // frames x n_fft / 2 complex points
  l.buf1 = o, o += up4(frames * n_fft);
  l.red = o, o += kMaxThreads;
  l.stats = o, o += parakeet ? up4(2 * n_mels) : 0;
  l.cache = o, o += cache ? up4(tiles_per_block * frames * n_mels) : 0;
  l.total = o;
  return l;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// In-place DFT of R points, v'[q] = sum_r v[r] exp(-2 pi i r q / R).
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b), v[1] = csub(a, b);
}

__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 t0 = cadd(v0, v2), t1 = csub(v0, v2), t2 = cadd(v1, v3), t3 = mul_neg_i(csub(v1, v3));
  v0 = cadd(t0, t2), v2 = csub(t0, t2), v1 = cadd(t1, t3), v3 = csub(t1, t3);
}

// h = cos(pi / 4), from the table
__device__ __forceinline__ void dft8(float2* v, float h) {
  dft4(v[0], v[2], v[4], v[6]);
  dft4(v[1], v[3], v[5], v[7]);
  const float2 o1 = make_float2(h * (v[3].x + v[3].y), h * (v[3].y - v[3].x));  // * exp(-i pi / 4)
  const float2 o2 = mul_neg_i(v[5]);
  const float2 o3 = make_float2(h * (v[7].y - v[7].x), -h * (v[7].x + v[7].y));  // * exp(-3 i pi / 4)
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  v[0] = cadd(e0, o0), v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1), v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2), v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3), v[7] = csub(e3, o3);
}

// c1, s1 = cos, sin(2 pi / 5); c2, s2 = cos, sin(4 pi / 5), from the table
__device__ __forceinline__ void dft5(float2* v, float c1, float s1, float c2, float s2) {
  const float2 a1 = cadd(v[1], v[4]), d1 = csub(v[1], v[4]), a2 = cadd(v[2], v[3]), d2 = csub(v[2], v[3]);
  const float2 x0 = v[0];
  const float2 r1 = make_float2(x0.x + c1 * a1.x + c2 * a2.x, x0.y + c1 * a1.y + c2 * a2.y);
  const float2 i1 = mul_neg_i(make_float2(s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y));
  const float2 r2 = make_float2(x0.x + c2 * a1.x + c1 * a2.x, x0.y + c2 * a1.y + c1 * a2.y);
  const float2 i2 = mul_neg_i(make_float2(s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y));
  v[0] = cadd(x0, cadd(a1, a2));
  v[1] = cadd(r1, i1), v[4] = csub(r1, i1);
  v[2] = cadd(r2, i2), v[3] = csub(r2, i2);
}

// One Stockham stage of radix R over nf frames of m points: butterfly j of a
// frame reads points j + r m / R, twiddles them by W_{ns R}^{r (j mod ns)}
// (table entry r (j mod ns) n_fft / (ns R)), and writes its R outputs at
// (j / ns) ns R + (j mod ns) + r ns: the output is in natural order. The
// block has m threads: thread t takes butterfly t mod (m / R) of frames
// t / (m / R), + R, ..., so its indices and twiddles are worked out once a
// stage.
template <int R>
__device__ __forceinline__ void stage(const float2* __restrict__ src, float2* __restrict__ dst, const float2* tw,
                                      int m, int ns, int nf, int n_fft) {
  const int per = m / R, step = n_fft / (ns * R);
  const int f0 = threadIdx.x / per, j = threadIdx.x - f0 * per, k = j % ns, out = (j / ns) * ns * R + k;
  float2 w[R];
#pragma unroll
  for (int r = 1; r < R; ++r) w[r] = tw[r * k * step];
  for (int f = f0; f < nf; f += R) {
    const float2* s = src + f * m + j;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[r * per];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], w[r]);
    if constexpr (R == 2) {
      dft2(v);
    } else if constexpr (R == 4) {
      dft4(v[0], v[1], v[2], v[3]);
    } else if constexpr (R == 5) {
      const float2 w1 = tw[n_fft / 5], w2 = tw[2 * n_fft / 5];
      dft5(v, w1.x, -w1.y, w2.x, -w2.y);
    } else {
      dft8(v, tw[n_fft / 8].x);
    }
    float2* d = dst + f * m + out;
#pragma unroll
    for (int r = 0; r < R; ++r) d[r * ns] = v[r];
  }
}

// fn(o, i) for every pair of o < n_outer, i < n_inner, the pairs dealt out to
// the block's threads in order (pair q = o n_inner + i to thread q mod
// blockDim), each thread stepping its pair on without a division
template <typename Fn>
__device__ __forceinline__ void for_pairs(int n_outer, int n_inner, Fn fn) {
  const int d_outer = blockDim.x / n_inner, d_inner = blockDim.x - d_outer * n_inner;
  int o = threadIdx.x / n_inner, i = threadIdx.x - o * n_inner;
  while (o < n_outer) {
    fn(o, i);
    o += d_outer, i += d_inner;
    if (i >= n_inner) i -= n_inner, ++o;
  }
}

// max over the block (every thread gets it); red holds blockDim floats
__device__ float block_max(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kMaxThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s && threadIdx.x + s < blockDim.x)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ int valid_frames(const Args& a, int row) {
  return min(max(a.n_valid[row], 0), a.n) / a.hop;
}

// Each mel's sum of a row's segment partials in P planes (plane p at part +
// p * plane) into out[p * n_mels + m], by the whole block; red holds P x
// blockDim floats. A segment is a
// block's run of the row's tiles, summed at the run's first tile, so the
// row's segments start at its first tile and at every block boundary inside
// it; only segments that hold a valid frame were written. Thread (h, m)
// sums segments h, h + H, ... of mel m (H = blockDim / n_mels), kInFlight
// loads a plane at a time; the H partial sums then add up in order: a fixed
// order for a given block size, whichever block computes it.
template <int P>
__device__ void row_sum(const float* part, long long plane, const Args& a, int row, int valid_tiles, float* red,
                        float* out) {
  const int n_mels = a.n_mels, tpb = a.tiles_per_block, hh = blockDim.x / n_mels;
  const int h = threadIdx.x / n_mels, m = threadIdx.x - h * n_mels;
  const int begin = row * a.tiles_per_row, end = begin + valid_tiles, b1 = (begin / tpb + 1) * tpb;
  const int count = valid_tiles <= 0 ? 0 : 1 + (b1 < end ? (end - b1 + tpb - 1) / tpb : 0);
  __syncthreads();  // red is free
  if (h < hh) {
    float s[P];
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = 0.f;
    for (int i = h; i < count; i += kInFlight * hh) {
      float v[P][kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int seg = i + u * hh;
        const long long j = (seg ? b1 + (seg - 1) * tpb : begin) * static_cast<long long>(n_mels) + m;
#pragma unroll
        for (int p = 0; p < P; ++p) v[p][u] = seg < count ? __ldcg(part + p * plane + j) : 0.f;
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) s[p] += v[p][u];  // + 0 past the end leaves s as it is
    }
#pragma unroll
    for (int p = 0; p < P; ++p) red[(p * hh + h) * n_mels + m] = s[p];
  }
  __syncthreads();
  if (threadIdx.x < n_mels) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float s = red[p * hh * n_mels + threadIdx.x];
      for (int k = 1; k < hh; ++k) s += red[(p * hh + k) * n_mels + threadIdx.x];
      out[p * n_mels + threadIdx.x] = s;
    }
  }
  __syncthreads();
}

template <bool kParakeet>
__global__ void __launch_bounds__(kMaxThreads) log_mel_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int nt = blockDim.x, tid = threadIdx.x, ff = a.frames_per_tile, m_pts = a.n_fft / 2;
  const int n_mels = a.n_mels, T = a.n_frames;
  const Layout L = layout(kParakeet, a.n_fft, a.hop, n_mels, a.n_wts, ff, a.tiles_per_block, a.cache);
  float2* tw = reinterpret_cast<float2*>(smem + L.tw);
  float* win = smem + L.win;
  float* wts = smem + L.wts;
  int* band = reinterpret_cast<int*>(smem + L.band);
  float* xs = smem + L.xs;
  float2* buf0 = reinterpret_cast<float2*>(smem + L.buf0);
  float2* buf1 = reinterpret_cast<float2*>(smem + L.buf1);
  float* red = smem + L.red;
  float* stats = smem + L.stats;  // Parakeet: the current row's mean, then std + eps, per mel
  float* cache = smem + L.cache;

  for (int i = tid; i < a.n_fft; i += nt) tw[i] = a.tw[i], win[i] = a.window[i];
  for (int i = tid; i < a.n_wts; i += nt) wts[i] = a.wts[i];
  for (int i = tid; i < 3 * n_mels; i += nt) band[i] = a.band[i];
  if (kParakeet && blockIdx.x == 0)
    for (int r = tid; r < a.rows; r += nt) a.frames_out[r] = valid_frames(a, r);

  const int n_tiles = a.rows * a.tiles_per_row;
  const int first = blockIdx.x * a.tiles_per_block, last = min(first + a.tiles_per_block, n_tiles);
  const long long pad = a.n_fft / 2;
  float* part1 = a.partial;
  float* part2 = a.partial + static_cast<long long>(n_tiles) * n_mels;

  // where a tile's log-mel waits for the epilogue: shared memory, or its
  // place in the output
  auto stash = [&](int tile, int row, int t0, int f, int m) -> float* {
    const int t = t0 + f;
    if (a.cache) return cache + ((tile - first) * ff + f) * n_mels + m;
    if (kParakeet) return a.out + (static_cast<long long>(row) * T + t) * n_mels + m;
    return a.out + static_cast<long long>(m) * T + t;
  };

  // a segment's sum is written at its first tile, where that tile holds a
  // valid frame (the only segments row_sum reads)
  auto flush = [&](float* part, int row, int tile, float s) {
    if (row >= 0 && tid < n_mels && tile - row * a.tiles_per_row < (valid_frames(a, row) + ff - 1) / ff)
      part[static_cast<long long>(tile) * n_mels + tid] = s;
  };

  // ---- phase 1: per tile the log-mel; Whisper's block max, Parakeet's segment sums
  float vmax = -INFINITY;
  float seg = 0.f;
  int seg_row = -1, seg_tile = 0;
  for (int tile = first; tile < last; ++tile) {
    const int row = tile / a.tiles_per_row, t0 = (tile - row * a.tiles_per_row) * ff;
    if (kParakeet && row != seg_row) {
      flush(part1, seg_row, seg_tile, seg);
      seg = 0.f, seg_row = row, seg_tile = tile;
    }
    const int nf = min(ff, (kParakeet ? valid_frames(a, row) : T) - t0);
    if (nf <= 0) continue;  // the same for every thread of the block
    const float* x = a.audio + static_cast<long long>(row) * a.n;
    const long long s0 = static_cast<long long>(t0) * a.hop - pad;
    const int span = (nf - 1) * a.hop + a.n_fft;
    __syncthreads();  // the previous tile's reads of xs and the buffers are done
    if (kParakeet) {
      const long long nv = min(max(a.n_valid[row], 0), a.n);
      for (int i = tid; i < span; i += nt) {
        const long long s = s0 + i;
        float v = 0.f;
        // multiply, then subtract (no FMA), as the plain version rounds
        if (s >= 0 && s < nv) v = s == 0 ? x[0] : __fsub_rn(x[s], __fmul_rn(a.preemphasis, x[s - 1]));
        xs[i] = v;
      }
    } else {
      for (int i = tid; i < span; i += nt) {
        long long s = s0 + i;
        if (s < 0) s = -s;
        if (s >= a.n) s = 2 * (static_cast<long long>(a.n) - 1) - s;
        xs[i] = x[s];
      }
    }
    __syncthreads();
    {  // thread p packs point p of every frame
      const float w0 = win[2 * tid], w1 = win[2 * tid + 1];
      for (int f = 0; f < nf; ++f) {
        const float* s = xs + f * a.hop + 2 * tid;
        buf0[f * m_pts + tid] = make_float2(s[0] * w0, s[1] * w1);
      }
    }
    float2 *src = buf0, *dst = buf1;
    int ns = 1;
    for (int plan = a.radices; plan; plan >>= 4) {
      __syncthreads();
      const int r = plan & 15;
      if (r == 8) {
        stage<8>(src, dst, tw, m_pts, ns, nf, a.n_fft);
      } else if (r == 5) {
        stage<5>(src, dst, tw, m_pts, ns, nf, a.n_fft);
      } else if (r == 4) {
        stage<4>(src, dst, tw, m_pts, ns, nf, a.n_fft);
      } else {
        stage<2>(src, dst, tw, m_pts, ns, nf, a.n_fft);
      }
      ns *= r;
      float2* t = src;
      src = dst, dst = t;
    }
    __syncthreads();
    // the real-FFT split: X[k] = E[k] + W^k O[k], E and O the DFTs of the
    // even and odd samples, from Z[k] and conj(Z[m - k]); power into dst
    float* pw = reinterpret_cast<float*>(dst);
    const int n_bins = m_pts + 1;
    {  // thread k takes bin k of every frame (and thread 0 the Nyquist bin)
      const int k = tid, kb = k ? m_pts - k : 0;
      const float2 w = tw[k];
      for (int f = 0; f < nf; ++f) {
        const float2 za = src[f * m_pts + k], zb = src[f * m_pts + kb];
        const float er = 0.5f * (za.x + zb.x), ei = 0.5f * (za.y - zb.y);
        const float orr = 0.5f * (za.y + zb.y), oi = 0.5f * (zb.x - za.x);
        const float xr = er + (w.x * orr - w.y * oi), xi = ei + (w.x * oi + w.y * orr);
        pw[f * n_bins + k] = xr * xr + xi * xi;
        if (k == 0) {
          const float d = za.x - za.y;
          pw[f * n_bins + m_pts] = d * d;
        }
      }
    }
    __syncthreads();
    // mel projection over each mel's band, then the log, into lm (src's floats)
    float* lm = reinterpret_cast<float*>(src);
    for_pairs(nf, n_mels, [&](int f, int m) {
      const int lo = band[3 * m], hi = band[3 * m + 1], off = band[3 * m + 2] - lo;
      const float* prow = pw + f * n_bins;
      float acc = 0.f;
      for (int k = lo; k < hi; ++k) acc = fmaf(prow[k], wts[off + k], acc);
      float v;
      if (kParakeet) {
        v = logf(acc + kLogGuard);
      } else {
        v = log10f(fmaxf(acc, 1e-10f));
        vmax = fmaxf(vmax, v);
      }
      lm[f * n_mels + m] = v;
      *stash(tile, row, t0, f, m) = v;
    });
    if (kParakeet) {
      __syncthreads();
      if (tid < n_mels)
        for (int f = 0; f < nf; ++f) seg += lm[f * n_mels + tid];
    }
  }
  if (kParakeet) flush(part1, seg_row, seg_tile, seg);
  if (!kParakeet) {
    vmax = block_max(vmax, red);
    if (tid == 0) a.partial[blockIdx.x] = vmax;
  }

  cg::grid_group grid = cg::this_grid();
  grid.sync();

  if (!kParakeet) {
    // ---- Whisper's epilogue: the global max over every block's, the clamp
    // at max - 8 and (x + 4) / 4, written (n_mels, T)
    float g = -INFINITY;
    for (int i = tid; i < static_cast<int>(gridDim.x); i += nt) g = fmaxf(g, __ldcg(a.partial + i));
    const float floor_ = block_max(g, red) - 8.f;
    for (int tile = first; tile < last; ++tile) {
      const int t0 = tile * ff, nf = min(ff, T - t0);
      for_pairs(n_mels, nf, [&](int m, int f) {  // consecutive threads on consecutive frames of a mel
        float* s = stash(tile, 0, t0, f, m);
        const float v = a.cache ? *s : __ldcg(s);
        a.out[static_cast<long long>(m) * T + t0 + f] = (fmaxf(v, floor_) + 4.f) * 0.25f;
      });
    }
    return;
  }

  // ---- Parakeet, phase 2: each row's mean; per segment the sum of squared
  // deviations over its valid frames (xs, free now, holds the row sums'
  // P x blockDim partials: n_fft floats or more)
  float* sq = reinterpret_cast<float*>(buf0);  // a tile's squared deviations, f-major
  seg = 0.f, seg_row = -1;
  for (int tile = first; tile < last; ++tile) {
    const int row = tile / a.tiles_per_row, t0 = (tile - row * a.tiles_per_row) * ff;
    const int valid = valid_frames(a, row), nf = min(ff, valid - t0);
    if (row != seg_row) {
      flush(part2, seg_row, seg_tile, seg);
      seg = 0.f, seg_row = row, seg_tile = tile;
      row_sum<1>(part1, 0, a, row, (valid + ff - 1) / ff, xs, stats);
      if (tid < n_mels) stats[tid] = stats[tid] / fmaxf(static_cast<float>(valid), 1.f);
    }
    if (nf <= 0) continue;
    __syncthreads();  // the mean is in stats; the previous tile's sq is read
    for_pairs(nf, n_mels, [&](int f, int m) {
      float* s = stash(tile, row, t0, f, m);
      const float d = (a.cache ? *s : __ldcg(s)) - stats[m];
      sq[f * n_mels + m] = d * d;
    });
    __syncthreads();
    if (tid < n_mels)
      for (int f = 0; f < nf; ++f) seg += sq[f * n_mels + tid];
  }
  flush(part2, seg_row, seg_tile, seg);

  grid.sync();

  // ---- phase 3: (x - mean) / (std + eps) on the valid frames, zeros after
  seg_row = -1;
  for (int tile = first; tile < last; ++tile) {
    const int row = tile / a.tiles_per_row, t0 = (tile - row * a.tiles_per_row) * ff;
    const int valid = valid_frames(a, row), nf = min(ff, valid - t0), n_out = min(ff, T - t0);
    if (row != seg_row) {
      const int vt = (valid + ff - 1) / ff;
      const float denom = fmaxf(static_cast<float>(valid), 1.f);
      row_sum<2>(part1, part2 - part1, a, row, vt, xs, stats);  // the sums and the squared deviations
      if (tid < n_mels) {
        stats[tid] = stats[tid] / denom;
        stats[n_mels + tid] = sqrtf(stats[n_mels + tid] / fmaxf(denom - 1.f, 1.f)) + kNormEps;
      }
      seg_row = row;
      __syncthreads();
    }
    float* o = a.out + (static_cast<long long>(row) * T + t0) * n_mels;
    for_pairs(n_out, n_mels, [&](int f, int m) {
      float v = 0.f;
      if (f < nf) {
        float* s = stash(tile, row, t0, f, m);
        v = ((a.cache ? *s : __ldcg(s)) - stats[m]) / stats[n_mels + m];
      }
      o[f * n_mels + m] = v;
    });
  }
}

template <bool kParakeet>
cudaError_t allow_smem() {
  // above the default 48 KB a block needs the opt-in, once per kernel
  static const cudaError_t attr = [] {
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(log_mel_kernel<kParakeet>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    return err;
  }();
  return attr;
}

bool supported_radices(int radices, int m_pts) {
  int prod = 1, stages = 0;
  for (int p = radices; p; p >>= 4, ++stages) {
    const int r = p & 15;
    if (r != 2 && r != 4 && r != 5 && r != 8) return false;
    prod *= r;
  }
  return stages <= 7 && prod == m_pts;
}

}  // namespace

// Blocks of the kernel an SM holds at once for this shape and plan (a
// negative cudaError_t on failure); *smem_bytes gets the block's dynamic
// shared memory. parakeet: 0 for the Whisper form, 1 for Parakeet's.
extern "C" int s2s_log_mel_blocks_per_sm(int parakeet, int n_fft, int hop, int n_mels, int n_wts,
                                         int frames_per_tile, int tiles_per_block, int cache, int* smem_bytes) {
  const Layout l = layout(parakeet, n_fft, hop, n_mels, n_wts, frames_per_tile, tiles_per_block, cache);
  const size_t smem = sizeof(float) * static_cast<size_t>(l.total);
  *smem_bytes = static_cast<int>(smem);
  cudaError_t err = parakeet ? allow_smem<true>() : allow_smem<false>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = parakeet ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, log_mel_kernel<true>, n_fft / 2, smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, log_mel_kernel<false>, n_fft / 2, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// C entry point, bound with ctypes. audio (rows, n) f32; n_valid (rows,)
// int32 (Parakeet, else null); tw (n_fft, 2) f32; window (n_fft,) f32; band
// (n_mels, 3) int32; wts (n_wts,) f32; out f32, Whisper (n_mels, n_frames)
// with n_frames = n // hop, Parakeet (rows, n_frames, n_mels) with n_frames
// = 1 + n // hop; frames_out (rows,) int32 (Parakeet); partial f32 scratch,
// Whisper (grid,), Parakeet (2, rows * tiles_per_row, n_mels); all
// contiguous on the device. radices: the FFT's radices (2, 4, 5 or 8), 4 bits
// each, first stage lowest, their product n_fft / 2 <= 256; one block of
// n_fft / 2 threads per grid slot. The plan (frames_per_tile,
// tiles_per_block, grid, cache) comes from the Python wrapper
// (s2s_tpu_torch/ops/log_mel.py::launch_plan), which checks the rest.
// Returns the cudaError_t of the launch: a grid larger than the card holds
// at once fails with cudaErrorCooperativeLaunchTooLarge and does not run.
extern "C" int s2s_log_mel(int parakeet, const void* audio, const void* n_valid, const void* tw, const void* window,
                           const void* band, const void* wts, void* out, void* frames_out, void* partial, int rows,
                           int n, int n_frames, int n_fft, int hop, int n_mels, int n_wts, int radices,
                           int frames_per_tile, int tiles_per_row, int tiles_per_block, int grid, int cache,
                           float preemphasis, void* stream) {
  const int m_pts = n_fft / 2;
  if (rows < 1 || n_frames < 1 || n_fft % 2 || m_pts > kMaxThreads || m_pts < 32 || hop < 1 || n_mels < 1 ||
      n_mels > m_pts || frames_per_tile < 1 || tiles_per_row * frames_per_tile < n_frames || tiles_per_block < 1 ||
      grid < 1 || static_cast<long long>(grid) * tiles_per_block < static_cast<long long>(rows) * tiles_per_row ||
      !supported_radices(radices, m_pts) || (!parakeet && n <= n_fft / 2) || (parakeet && !n_valid))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(parakeet, n_fft, hop, n_mels, n_wts, frames_per_tile, tiles_per_block, cache);
  const size_t smem = sizeof(float) * static_cast<size_t>(l.total);
  const cudaError_t attr = parakeet ? allow_smem<true>() : allow_smem<false>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Args a{static_cast<const float*>(audio), static_cast<const int*>(n_valid), static_cast<const float2*>(tw),
         static_cast<const float*>(window), static_cast<const int*>(band), static_cast<const float*>(wts),
         static_cast<float*>(out), static_cast<int*>(frames_out), static_cast<float*>(partial), rows, n, n_frames,
         n_fft, hop, n_mels, n_wts, radices, frames_per_tile, tiles_per_row, tiles_per_block, cache != 0,
         preemphasis};
  void* params[] = {&a};
  const void* fn = parakeet ? reinterpret_cast<const void*>(log_mel_kernel<true>)
                            : reinterpret_cast<const void*>(log_mel_kernel<false>);
  return static_cast<int>(cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(m_pts), params, smem,
                                                      static_cast<cudaStream_t>(stream)));
}
