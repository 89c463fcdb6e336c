"""Polyphase resampling: the CPU path of ``s2s_tpu/audio/resample.py``.

:func:`resample_pcm16` delegates to ``scipy.signal.resample_poly`` exactly
like the reference (``api/openai_realtime/utils.py``), so PCM handling is
bit-exact with it; :func:`resample_float` is its float-domain twin.  The JAX
package's jitted on-device polyphase (``jax_resample_poly``) is not ported
(ROADMAP queue 1 item 5): nothing on the port's path calls it.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import scipy.signal


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
