"""Polyphase resampling, the port of ``s2s_tpu/audio/resample.py``.

Two paths with one contract:

- :func:`resample_pcm16` — the CPU path, delegating to
  ``scipy.signal.resample_poly`` exactly like the reference
  (``api/openai_realtime/utils.py``) so PCM handling is **bit-exact** with
  it; :func:`resample_float` is its float-domain twin.
- :func:`torch_resample_poly` — the counterpart of the JAX package's jitted
  ``jax_resample_poly``: the same FIR (scipy's default, kaiser beta 5.0),
  computed on the input tensor's device as one f32 product of each output
  sample's window of the zero-stuffed signal with the taps, and scipy's
  output length.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import scipy.signal
import torch


def resample_pcm16(audio_int16: bytes | np.ndarray, from_rate: int, to_rate: int) -> bytes:
    """Resample int16 PCM bytes between rates (bit-exact with the reference)."""
    if isinstance(audio_int16, np.ndarray):
        audio_int16 = np.asarray(audio_int16, dtype=np.int16).tobytes()
    if from_rate == to_rate:
        return audio_int16
    samples = np.frombuffer(audio_int16, dtype=np.int16).astype(np.float32) / 32768.0
    g = gcd(to_rate, from_rate)
    out = scipy.signal.resample_poly(samples, up=to_rate // g, down=from_rate // g)
    return np.clip(out * 32768, -32768, 32767).astype(np.int16).tobytes()


def resample_float(audio: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
    """Float-domain polyphase resample (CPU, scipy)."""
    if from_rate == to_rate:
        return audio
    g = gcd(to_rate, from_rate)
    return scipy.signal.resample_poly(audio, up=to_rate // g, down=from_rate // g)


@lru_cache(maxsize=32)
def _poly_filter(up: int, down: int) -> np.ndarray:
    """The FIR scipy.resample_poly uses by default (kaiser, beta=5.0)."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    h = scipy.signal.firwin(2 * half_len + 1, f_c, window=("kaiser", 5.0))
    return (h * up).astype(np.float32)


@lru_cache(maxsize=32)
def _reversed_taps(up: int, down: int, device: torch.device) -> torch.Tensor:
    """:func:`_poly_filter` reversed, on *device* (copied there once)."""
    return torch.from_numpy(_poly_filter(up, down)[::-1].copy()).to(device)


def torch_resample_poly(audio: torch.Tensor, from_rate: int, to_rate: int) -> torch.Tensor:
    """Polyphase resample of a float32 1-D tensor on its own device.

    Output sample m is sum_j h[j] * u[m * down + half - j], u the input
    zero-stuffed by *up*: after padding u by ``half`` on the left, that is
    the product of the window of ``len(h)`` samples starting at m * down with
    the reversed taps."""
    if from_rate == to_rate:
        return audio
    g = gcd(to_rate, from_rate)
    up, down = to_rate // g, from_rate // g
    h = _reversed_taps(up, down, audio.device)
    n_taps, n_in = h.shape[0], audio.shape[-1]
    half = (n_taps - 1) // 2
    n_out = -(-n_in * up // down)
    stuffed = torch.zeros(n_in * up, dtype=torch.float32, device=audio.device)
    stuffed[::up] = audio.float()
    right = max(0, (n_out - 1) * down + n_taps - half - n_in * up)
    padded = torch.nn.functional.pad(stuffed, (half, right))
    return padded.unfold(0, n_taps, down)[:n_out] @ h
