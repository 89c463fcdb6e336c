"""Energy (RMS) voice-activity model — the checkpoint-free VAD backend.

The product default is the JAX Silero port (``models/silero_vad.py``),
which needs converted weights to be meaningful; ``--vad_backend energy``
swaps in this classic RMS detector with an adaptive noise floor so the
FULL endpointing stack (deferred start, hold/stitch, progressive release,
reopen lifecycle — ``vad/handler.py``) runs end-to-end in environments
without checkpoints: CI, the offline grading image, and the on-chip soak
harness (``scripts/run_soak.py``), which drives wire-to-wire voice turns
through the real server.  The reference has no equivalent (it downloads
silero weights unconditionally, reference ``VAD/vad_handler.py``); this
backend exists because the TPU deployment story separates weights from
code.

Drop-in for the Silero model's protocol: ``__call__(chunk, sr) -> float``
probability per 32 ms chunk + ``reset_states()``.
"""

from __future__ import annotations

import numpy as np


class EnergyVAD:
    """Speech probability from RMS energy over an adaptive noise floor.

    The floor tracks the quietest recent frames (exponential min-follower);
    probability saturates as the frame's RMS climbs decades above the
    floor.  Hysteresis comes from the VADIterator's threshold handling —
    this model only scores frames.
    """

    def __init__(self, floor_init: float = 1e-4, floor_decay: float = 0.995,
                 gain_db: float = 12.0) -> None:
        self._floor_init = float(floor_init)
        self._floor_decay = float(floor_decay)
        self._gain_db = float(gain_db)
        self._floor = self._floor_init

    def __call__(self, chunk: np.ndarray, sr: int = 16000) -> float:
        x = np.asarray(chunk, dtype=np.float32)
        rms = float(np.sqrt(np.mean(np.square(x)))) if x.size else 0.0
        # min-follower: fast to drop toward quiet frames, slow to rise
        if rms < self._floor:
            self._floor = max(rms, 1e-7)
        else:
            self._floor = self._floor / self._floor_decay
        headroom_db = 20.0 * np.log10(max(rms, 1e-7) / max(self._floor, 1e-7))
        # 0 dB over the floor -> 0.0; gain_db over the floor -> ~1.0
        return float(np.clip(headroom_db / self._gain_db, 0.0, 1.0))

    def reset_states(self) -> None:
        self._floor = self._floor_init
