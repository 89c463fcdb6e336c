"""Inverse STFT / overlap-add for neural vocoders (port of
``s2s_tpu/ops/istft.py``; the JAX module holds no Pallas kernel).

The same math as the JAX package: the inverse DFT is a product with fixed
real and imaginary bases (Hermitian weighting folded in), the frames take
the periodic Hann window, overlap-add sums them, the sum is divided by the
window-square envelope floored at ``1e-6``, and the centre trim keeps
``(T - 1) * hop`` samples.  Overlap-add is ``F.fold``: each output sample
sums its frames in one pass, in the same order on every run (a scatter-add
with atomics would not).  ``torch.istft`` is not used: its NOLA check and
envelope floor differ from the JAX function's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _idft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag inverse-DFT bases mapping (n_fft//2+1) bins -> n_fft samples,
    with hermitian weighting folded in."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)
    n = np.arange(n_fft)
    ang = 2 * np.pi * np.outer(k, n) / n_fft
    # weight: 1 for DC/nyquist, 2 for interior bins (hermitian symmetry)
    w = np.full(n_bins, 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    cos_b = (np.cos(ang) * w[:, None] / n_fft).astype(np.float32)
    sin_b = (-np.sin(ang) * w[:, None] / n_fft).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=16)
def _tables(n_fft: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cos basis, sin basis, periodic Hann window) on *device*, made once."""
    cos_b, sin_b = _idft_basis(n_fft)
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    return tuple(torch.from_numpy(a.copy()).to(device) for a in (cos_b, sin_b, window))


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., T, n_fft) time frames -> (..., (T - 1) * hop + n_fft): frame t
    added at offset t * hop."""
    *lead, t, n_fft = frames.shape
    out_len = (t - 1) * hop + n_fft
    cols = frames.reshape(-1, t, n_fft).transpose(1, 2)  # (N, n_fft, T): fold's column layout
    out = F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop))
    return out.reshape(*lead, out_len)


def istft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Inverse STFT from magnitude and phase, each (..., T, n_fft//2+1), with
    the periodic Hann window.  Returns (..., (T - 1) * hop) audio,
    centre-trimmed."""
    cos_b, sin_b, window = _tables(n_fft, mag.device)
    re = mag * torch.cos(phase)
    im = mag * torch.sin(phase)
    frames = re @ cos_b + im @ sin_b  # (..., T, n_fft)
    t = mag.shape[-2]
    audio = overlap_add(frames * window, hop)
    # window envelope normalization
    env = overlap_add((window * window).expand(t, n_fft), hop)
    audio = audio / torch.clamp(env, min=1e-6)
    # center-trim: forward STFT reflect-padded n_fft//2; original signal had
    # (T-1)*hop samples
    pad = n_fft // 2
    return audio[..., pad: pad + (t - 1) * hop]
