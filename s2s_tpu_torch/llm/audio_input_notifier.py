"""Direct-audio (no STT) input path (reference ``LLM/audio_input_notifier.py``).

For ``--stt none`` sessions: final VAD audio bypasses transcription and
surfaces as an ``AudioInputCompletedEvent``; the realtime service forwards
the raw audio to an audio-capable LLM (WAV base64 over Chat Completions).
Honors the Smart-Turn stability window before releasing the audio.
"""

from __future__ import annotations

import logging
from time import perf_counter
from typing import Any, Iterator

import numpy as np

from s2s_tpu_torch.audio.pcm import int16_to_float32
from s2s_tpu_torch.pipeline.events import AudioInputCompletedEvent
from s2s_tpu_torch.pipeline.messages import VADAudio
from s2s_tpu_torch.runtime.base_handler import BaseHandler

logger = logging.getLogger(__name__)


class AudioInputNotifier(BaseHandler):
    def setup(self, text_output_queue=None, speculative_turns=None, sample_rate: int = 16000) -> None:
        self.text_output_queue = text_output_queue
        self.speculative_turns = speculative_turns
        self.sample_rate = sample_rate

    def process(self, item: VADAudio) -> Iterator[Any]:
        if item.mode == "progressive":
            return
        if self.speculative_turns is not None and item.turn_id is not None:
            age = max(0.0, perf_counter() - item.created_at_s)
            settle = max(0.0, item.processing_delay_s - age)
            if not self.speculative_turns.is_latest_after_stability_window(
                item.turn_id, item.turn_revision, settle
            ):
                logger.debug("AudioInputNotifier: dropping superseded audio turn=%s", item.turn_id)
                return
        audio = item.audio
        if audio.dtype == np.int16:
            audio = int16_to_float32(audio)
        if self.text_output_queue is not None:
            self.text_output_queue.put(
                AudioInputCompletedEvent(
                    audio=audio,
                    audio_sample_rate=self.sample_rate,
                    audio_duration_s=len(audio) / self.sample_rate,
                    turn_id=item.turn_id,
                    turn_revision=item.turn_revision,
                    speech_stopped_at_s=item.created_at_s,
                )
            )
        yield from ()
