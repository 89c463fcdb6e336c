"""Slaney mel filterbank in numpy (the host half of ``s2s_tpu/ops/mel.py``).

The port's Parakeet frontend (:mod:`s2s_tpu_torch.models.parakeet`) builds
its filterbank here, once per configuration; the log-mel itself runs in
torch.  The definitions are the JAX package's, copied.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

SAMPLE_RATE = 16_000
N_FFT = 400
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
