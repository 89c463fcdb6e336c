"""Fused log-mel frontend: framing, windowed DFT, power and mel projection.

The port of the TPU Pallas kernel ``s2s_tpu/ops/pallas_mel.py::log_mel_spectrogram_pallas``
as a hand-written CUDA kernel for Hopper (``csrc/log_mel.cu``, whose header
says what bounds it and how the design answers that).  The kernel reads the
reflect-padded audio of its frames straight from the samples, so no frame
matrix is built; the power spectrum stays in shared memory, and the mel
projection reads only each mel's band of nonzero filterbank rows
(:func:`bands`); it writes the (T, n_mels) f32 mel power.  log10, the global max, the clamp and the scaling
are torch ops (:func:`s2s_tpu_torch.ops.mel.log_scale`), as they stay
outside the Pallas kernel.  The DFT bases and the filterbank are tensor
arguments, so n_fft and n_mels are parameters of the kernel.

- A tensor on the CPU takes the plain PyTorch version
  (:func:`s2s_tpu_torch.ops.mel.mel_power`); a CUDA tensor launches the
  kernel or raises.  There is no fallback.
- ``mel_power.launches`` counts kernel launches.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from s2s_tpu_torch.ops import _build
from s2s_tpu_torch.ops import mel as mel_ref

#: the kernel's block is 4 sample groups x the bins padded to whole warps, at
#: most 1024 threads: up to 256 frequency bins per frame (n_fft <= 510)
MAX_FREQS = 256


@lru_cache(maxsize=8)
def bands(n_mels: int, device: torch.device) -> torch.Tensor:
    """(n_mels, 2) int32 on *device*: the [first, last + 1) row of each mel's
    nonzero weights in the filterbank of :func:`s2s_tpu_torch.ops.mel.tables`
    ((0, 0) for an all-zero column).  The slaney triangles cover a few bins
    each and the filterbank is exactly zero elsewhere, so a sum over the band
    is the dense product's, bit for bit."""
    nz = mel_ref.mel_filter_bank(n_mels) != 0
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, nz.shape[0] - nz[::-1].argmax(axis=0), 0)
    return torch.from_numpy(np.stack([lo, hi], axis=1).astype(np.int32)).to(device)


def _check(audio, cos_b, sin_b, fb, n_fft: int, hop: int) -> None:
    if audio.dim() != 1 or audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError(f"log-mel wants contiguous (N,) f32 audio; got {tuple(audio.shape)} {audio.dtype}")
    n_freqs, n_mels = fb.shape
    if tuple(cos_b.shape) != (n_fft, n_freqs) or tuple(sin_b.shape) != (n_fft, n_freqs):
        raise ValueError(f"log-mel bases {tuple(cos_b.shape)}, {tuple(sin_b.shape)} do not match the "
                         f"filterbank {tuple(fb.shape)}")
    if any(x.dtype != torch.float32 or not x.is_contiguous() or x.device != audio.device
           for x in (cos_b, sin_b, fb)):
        raise ValueError("log-mel wants contiguous f32 bases and filterbank on the audio's device")
    if n_freqs > MAX_FREQS or n_mels < 1 or hop < 1 or hop % 4 or n_fft % 16:
        raise ValueError(f"log-mel does not support {n_freqs} bins (max {MAX_FREQS}), {n_mels} mels, "
                         f"hop {hop} (a multiple of 4), n_fft {n_fft} (a multiple of 16)")
    if audio.shape[0] <= n_fft // 2 or audio.shape[0] < hop:
        raise ValueError(f"log-mel needs more than n_fft // 2 = {n_fft // 2} samples; got {audio.shape[0]}")


def mel_power(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(T, n_mels) f32 mel power of *audio* (N,) f32 at 16 kHz, T = N // hop
    (Whisper's n_fft 400, hop 160).  CPU tensors take
    :func:`s2s_tpu_torch.ops.mel.mel_power`; CUDA tensors launch
    ``csrc/log_mel.cu`` on the current stream (built at first use) and raise
    on any shape, type, layout or launch error."""
    if audio.device.type == "cpu":
        return mel_ref.mel_power(audio, n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"mel_power: unsupported device {audio.device}")
    cos_b, sin_b, fb = mel_ref.tables(n_mels, audio.device)
    n_fft, hop = mel_ref.N_FFT, mel_ref.HOP_LENGTH
    _check(audio, cos_b, sin_b, fb, n_fft, hop)
    n_frames = audio.shape[0] // hop
    lib = _build.load()
    with torch.cuda.device(audio.device):
        out = torch.empty((n_frames, n_mels), dtype=torch.float32, device=audio.device)
        err = lib.s2s_log_mel(
            audio.data_ptr(), audio.shape[0], cos_b.data_ptr(), sin_b.data_ptr(), fb.data_ptr(),
            bands(n_mels, audio.device).data_ptr(), out.data_ptr(), n_frames, n_fft, hop, fb.shape[0], n_mels,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: cudaError {err} "
                           f"(N={audio.shape[0]}, n_mels={n_mels})")
    _build.count_launch(mel_power)
    return out


mel_power.launches = 0


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel features (n_mels, N // hop) of *audio* (N,) f32 on its
    device: the mel power of :func:`mel_power`, then log10, the clamp at
    max - 8 and (x + 4) / 4.  The same contract as the plain
    :func:`s2s_tpu_torch.ops.mel.log_mel_spectrogram`."""
    return mel_ref.log_scale(mel_power(audio.float().contiguous(), n_mels))
