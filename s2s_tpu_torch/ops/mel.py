"""Whisper-compatible log-mel spectrogram (port of ``s2s_tpu/ops/mel.py``).

The numpy half (the slaney filterbank and the hann-windowed DFT bases) is
the JAX package's, copied.  :func:`frame_audio` and
:func:`log_mel_spectrogram` are the same math in torch: hann(400), hop 160,
reflect-pad n_fft//2, the final frame dropped, the DFT as two products with
the bases, |.|^2, slaney mel (80 or 128 bins), log10 clamped to max-8,
scaled (x+4)/4.  :func:`log_mel_spectrogram` is the plain version of the
log-mel kernel (:mod:`s2s_tpu_torch.ops.log_mel`); Parakeet's frontend
takes its filterbank and DFT bases (:func:`stft_basis`) from here.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_FREQS = N_FFT // 2 + 1  # 201


def hertz_to_mel(freq):
    """Slaney-scale Hz->mel (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    mel = freq / f_sp
    above = freq >= min_log_hz
    mel = np.where(above, min_log_hz / f_sp + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hertz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    freq = mel * f_sp
    above = mel >= min_log_mel
    return np.where(above, 1000.0 * np.exp(logstep * (mel - min_log_mel)), freq)


@lru_cache(maxsize=8)
def mel_filter_bank(
    n_mels: int = 80, n_freqs: int = N_FREQS, sample_rate: int = SAMPLE_RATE, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_freqs, n_mels)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hertz_to_mel(0.0), hertz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hertz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]  # (n_freqs, n_mels+2)
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


@lru_cache(maxsize=4)
def _dft_basis() -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT bases including the hann window, shape (N_FFT, N_FREQS)."""
    n = np.arange(N_FFT)
    k = np.arange(N_FREQS)
    angle = -2.0 * np.pi * np.outer(n, k) / N_FFT
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float64)  # periodic hann
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def centred_window(n_fft: int, win_length: int) -> np.ndarray:
    """A symmetric hann(win_length) zero-padded to n_fft, centred (what
    ``torch.stft`` does with win_length < n_fft), f64."""
    window = np.zeros(n_fft, np.float64)
    off = (n_fft - win_length) // 2
    window[off : off + win_length] = np.hanning(win_length)
    return window


@lru_cache(maxsize=4)
def stft_basis(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases (n_fft, n_fft//2+1) of Parakeet's frontend:
    the :func:`centred_window` in the bases."""
    window = centred_window(n_fft, win_length)
    n = np.arange(n_fft)
    k = np.arange(n_fft // 2 + 1)
    angle = -2.0 * np.pi * np.outer(n, k) / n_fft
    return (
        (np.cos(angle) * window[:, None]).astype(np.float32),
        (np.sin(angle) * window[:, None]).astype(np.float32),
    )


@lru_cache(maxsize=8)
def tables(n_mels: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cos basis, sin basis, filterbank) as f32 tensors on *device*, built
    once per (n_mels, device)."""
    cos_b, sin_b = _dft_basis()
    return tuple(torch.from_numpy(a).to(device) for a in (cos_b, sin_b, mel_filter_bank(n_mels)))


def frame_audio(audio: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP_LENGTH) -> torch.Tensor:
    """Reflect-pad and slice into overlapping frames: (T, n_fft) with
    T = 1 + len // hop, as torch.stft(center=True); Whisper drops the final
    frame downstream."""
    pad = n_fft // 2
    padded = F.pad(audio[None, None], (pad, pad), mode="reflect")[0, 0]
    n_frames = 1 + audio.shape[0] // hop
    return padded.unfold(0, n_fft, hop)[:n_frames]


def mel_power(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(T, n_mels) f32 mel power of *audio* (N,) f32, T = N // hop: the frames
    (final one dropped) @ the windowed DFT bases -> re^2 + im^2 -> @ the
    filterbank.  What the log-mel kernel computes."""
    frames = frame_audio(audio.float())[:-1]
    cos_b, sin_b, fb = tables(n_mels, audio.device)
    re = frames @ cos_b
    im = frames @ sin_b
    return (re * re + im * im) @ fb


def log_scale(mel: torch.Tensor) -> torch.Tensor:
    """(T, n_mels) mel power -> (n_mels, T) Whisper log-mel: log10 clamped
    at 1e-10 and at max - 8, then (x + 4) / 4."""
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).T


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel features of *audio* (N,) f32 at 16 kHz, shape
    (n_mels, N // hop), on the audio's device; plain torch ops."""
    return log_scale(mel_power(audio, n_mels))
