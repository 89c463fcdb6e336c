"""Fixed-size audio chunking with remainder carry.

Client audio arrives in arbitrary-size base64 appends; the pipeline consumes
512-sample frames (reference ``handlers/audio.py:66-95``).  ``Chunker``
carries the remainder between appends; ``RingBuffer`` backs speech-pad
prefixes in the VAD.
"""

from __future__ import annotations

import numpy as np

from s2s_tpu_torch.audio.pcm import CHUNK_SAMPLES


class Chunker:
    """Accumulate samples, emit fixed-size frames, keep the remainder."""

    def __init__(self, frame_samples: int = CHUNK_SAMPLES, dtype=np.int16) -> None:
        self.frame_samples = frame_samples
        self._rem = np.empty(0, dtype=dtype)

    def push(self, samples: np.ndarray) -> list[np.ndarray]:
        buf = np.concatenate([self._rem, samples]) if self._rem.size else samples
        n_frames = len(buf) // self.frame_samples
        frames = [
            buf[i * self.frame_samples : (i + 1) * self.frame_samples] for i in range(n_frames)
        ]
        self._rem = buf[n_frames * self.frame_samples :]
        return frames

    @property
    def remainder(self) -> np.ndarray:
        return self._rem

    def reset(self) -> None:
        self._rem = self._rem[:0]


class RingBuffer:
    """Bounded sample history (most recent ``capacity`` samples)."""

    def __init__(self, capacity: int, dtype=np.float32) -> None:
        self.capacity = capacity
        self._buf = np.zeros(capacity, dtype=dtype)
        self._filled = 0

    def push(self, samples: np.ndarray) -> None:
        n = len(samples)
        if n >= self.capacity:
            self._buf[:] = samples[-self.capacity :]
            self._filled = self.capacity
            return
        self._buf = np.roll(self._buf, -n)
        self._buf[-n:] = samples
        self._filled = min(self.capacity, self._filled + n)

    def read(self) -> np.ndarray:
        """Oldest-to-newest contents (only the filled part)."""
        if self._filled == 0:
            return self._buf[:0]
        return self._buf[self.capacity - self._filled :].copy()

    def reset(self) -> None:
        self._filled = 0
        self._buf[:] = 0
