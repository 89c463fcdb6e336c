"""Streaming VAD state machine (numpy; model-agnostic).

Behavioral parity with reference ``VAD/vad_iterator.py`` (itself adapted from
silero-vad): threshold trigger, a hysteresis band (prob >= threshold - 0.15
still counts as active speech), ``min_silence`` end-of-utterance detection,
and a pre-speech pad ring so up to ``speech_pad_ms`` of audio before the
trigger is prepended to the utterance.

The model is injected (``model(chunk, sr) -> prob``) — the JAX Silero port
in production, scripted fakes in tests (the reference test seam).
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np


class VADIterator:
    def __init__(
        self,
        model: Callable[[np.ndarray, int], float],
        threshold: float = 0.5,
        sampling_rate: int = 16000,
        min_silence_duration_ms: int = 300,
        speech_pad_ms: int = 30,
    ) -> None:
        if sampling_rate not in (8000, 16000):
            raise ValueError("VADIterator supports 8000/16000 Hz only")
        self.model = model
        self.threshold = threshold
        self.sampling_rate = sampling_rate
        self.min_silence_samples = int(sampling_rate * min_silence_duration_ms / 1000)
        self.speech_pad_samples = int(sampling_rate * speech_pad_ms / 1000)
        #: active-speech hysteresis: probs within this band below threshold
        #: still count as speech continuing (but cannot trigger a start).
        self.hysteresis = 0.15
        self.reset_states()

    def reset_states(self) -> None:
        if hasattr(self.model, "reset_states"):
            self.model.reset_states()
        self.triggered = False
        self.is_speaking = False
        self.temp_end = 0
        self.current_sample = 0
        self.buffer: list[np.ndarray] = []
        self.prefix_buffer: list[np.ndarray] = []
        self.active_speech_samples = 0
        self.last_utterance_active_speech_samples = 0
        self._pad_ring: deque[np.ndarray] = deque()
        self._pad_samples = 0

    # ── pre-speech pad ───────────────────────────────────────────────

    def _remember_pre_speech(self, chunk: np.ndarray) -> None:
        if self.speech_pad_samples <= 0:
            return
        self._pad_ring.append(chunk)
        self._pad_samples += len(chunk)
        while self._pad_ring and self._pad_samples > self.speech_pad_samples:
            excess = self._pad_samples - self.speech_pad_samples
            head = self._pad_ring[0]
            if excess >= len(head):
                self._pad_ring.popleft()
                self._pad_samples -= len(head)
            else:
                self._pad_ring[0] = head[excess:]
                self._pad_samples -= excess

    def speech_buffer(self) -> list[np.ndarray]:
        """Current utterance audio including the pre-speech pad prefix."""
        return [*self.prefix_buffer, *self.buffer]

    # ── streaming step ───────────────────────────────────────────────

    def __call__(self, chunk: np.ndarray) -> list[np.ndarray] | None:
        """Feed one chunk; returns the finished utterance (list of chunks) at
        end of speech, else None."""
        chunk = np.asarray(chunk)
        n = len(chunk)
        self.current_sample += n
        prob = float(self.model(chunk, self.sampling_rate))

        if not self.triggered:
            if prob >= self.threshold:
                # Speech start: adopt the pad ring as utterance prefix.
                self.triggered = True
                self.prefix_buffer = list(self._pad_ring)
                self._pad_ring.clear()
                self._pad_samples = 0
                self.buffer.append(chunk)
                self.active_speech_samples = n
                self.last_utterance_active_speech_samples = 0
            else:
                self._remember_pre_speech(chunk)
            return None

        self.buffer.append(chunk)
        if prob >= self.threshold - self.hysteresis:
            self.active_speech_samples += n
            self.temp_end = 0
            return None

        # Below the hysteresis band: candidate end of speech.
        if not self.temp_end:
            self.temp_end = self.current_sample
        if self.current_sample - self.temp_end < self.min_silence_samples:
            return None

        # End confirmed; the trailing low-confidence chunks stay in the segment.
        self.temp_end = 0
        self.triggered = False
        utterance = self.speech_buffer()
        self.last_utterance_active_speech_samples = self.active_speech_samples
        self.active_speech_samples = 0
        self.buffer = []
        self.prefix_buffer = []
        return utterance
