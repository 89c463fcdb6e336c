"""Progressive (live) transcription with a growing, sentence-fixing window.

Re-expresses reference ``STT/smart_progressive_streaming.py``: progressive
VAD audio accumulates into a decode window capped at ``max_window_s``
(15 s).  When the window overflows, sentences that end before
``window_end - fix_margin_s`` (2 s) are **frozen** — their text is fixed and
their audio excised — so every subsequent decode touches only the active
tail.  The final decode reuses the fixed prefix and transcribes just the
remainder.

TPU note: decode windows are padded to bucketed lengths upstream so the
encoder never recompiles; fixing keeps the active window short, bounding
per-tick latency regardless of utterance length.

The decoder is a seam: ``decode_fn(audio_f32) -> DecodeResult`` (JAX Whisper
or Parakeet in production, scripted fakes in tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass(frozen=True)
class SentenceSpan:
    text: str
    start_s: float
    end_s: float


@dataclass(frozen=True)
class DecodeResult:
    text: str
    sentences: tuple[SentenceSpan, ...] = ()
    language_code: str | None = None


DecodeFn = Callable[[np.ndarray], DecodeResult]


@dataclass
class ProgressiveStreamer:
    decode_fn: DecodeFn
    max_window_s: float = 15.0
    fix_margin_s: float = 2.0
    sample_rate: int = 16000

    fixed_texts: list[str] = field(default_factory=list)
    fixed_samples: int = 0  # audio prefix already excised
    language_code: str | None = None

    def reset(self) -> None:
        self.fixed_texts.clear()
        self.fixed_samples = 0
        self.language_code = None

    def _window(self, full_audio: np.ndarray) -> np.ndarray:
        return full_audio[self.fixed_samples :]

    def feed(self, full_audio: np.ndarray) -> DecodeResult:
        """Progressive tick: decode the active window, fix overflow sentences.
        Returns the combined (fixed + active) transcript."""
        window = self._window(full_audio)
        window_s = len(window) / self.sample_rate
        result = self.decode_fn(window)
        if result.language_code:
            self.language_code = result.language_code

        if window_s > self.max_window_s and result.sentences:
            cutoff = window_s - self.fix_margin_s
            fixed_until_s = 0.0
            active: list[str] = []
            for span in result.sentences:
                if not active and span.end_s <= cutoff:
                    self.fixed_texts.append(span.text)
                    fixed_until_s = span.end_s
                else:
                    active.append(span.text)
            self.fixed_samples += int(fixed_until_s * self.sample_rate)
            text = " ".join(active)
        else:
            text = result.text

        combined = " ".join([*self.fixed_texts, text]).strip()
        return DecodeResult(combined, result.sentences, self.language_code)

    def final(self, full_audio: np.ndarray) -> DecodeResult:
        """Final decode: transcribe only the unfixed remainder, reuse the
        fixed prefix, then reset for the next utterance."""
        window = self._window(full_audio)
        result = self.decode_fn(window) if len(window) else DecodeResult("")
        if result.language_code:
            self.language_code = result.language_code
        combined = " ".join([*self.fixed_texts, result.text]).strip()
        language = self.language_code
        self.reset()
        return DecodeResult(combined, result.sentences, language)
