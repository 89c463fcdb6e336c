"""Pocket TTS streaming handler (reference ``TTS/pocket_tts_handler.py`` —
Kyutai Pocket TTS: CPU-friendly delayed-streams TTS with voice cloning).

Drives the checkpoint-faithful JAX Pocket model
(:mod:`s2s_tpu_torch.models.pocket_tts`: Moshi-family backbone + depformer over
Mimi codec frames): true incremental emission in 640 ms codec chunks, a
named voice from the Kyutai ``tts-voices`` catalog (converted embedding
prefixes), and the base class's stateful re-chunking standing in for the
reference's hand-rolled resample-aware block sizing
(``pocket_tts_handler.py:131-227``)."""

from __future__ import annotations

import logging
from typing import Iterator, Optional

import numpy as np

from s2s_tpu_torch.tts.base import BaseTTSHandler

logger = logging.getLogger(__name__)


class PocketTTSHandler(BaseTTSHandler):
    def setup(
        self,
        cancel_scope=None,
        speculative_turns=None,
        device_scheduler=None,
        should_listen=None,
        blocksize: int = 512,
        speculative_synthesis: bool = True,
        voice: str | None = None,
        speed: float = 1.0,
        synthesize_fn=None,
        model=None,
        warmup: bool = False,
        voice_ref_audio: np.ndarray | None = None,
    ) -> None:
        self.setup_base(
            cancel_scope=cancel_scope,
            speculative_turns=speculative_turns,
            device_scheduler=device_scheduler,
            should_listen=should_listen,
            blocksize=blocksize,
            speculative_synthesis=speculative_synthesis,
        )
        self.speed = speed
        self._synthesize_fn = synthesize_fn
        self.voice = voice
        if synthesize_fn is None:
            if model is None:
                from s2s_tpu_torch.models.pocket_tts import PocketTTS

                logger.warning("PocketTTSHandler: random-init weights (no checkpoint provided)")
                model = PocketTTS()
            self.model = model
            if voice_ref_audio is not None:
                # cloning from raw audio needs the Mimi ENCODER (not part of
                # the decode path) — reference clones via the pocket_tts
                # package; here converted voice embeddings are the supported
                # route (scripts/convert_checkpoint.py --family pocket-voice)
                logger.warning(
                    "PocketTTSHandler: --tts_ref_audio cloning requires a converted "
                    "voice-embedding file (pocket-voice); using the default voice"
                )
            if self.voice is not None and self.voice not in self.model.voices:
                logger.warning("PocketTTSHandler: unknown voice %r (have %s); using default",
                               self.voice, sorted(self.model.voices) or "none")
                self.voice = None
            if warmup:
                for _ in self.model.stream("Warm up.", voice=self.voice):
                    break

    def _synthesize(self, text: str, language: Optional[str], runtime_config, response) -> Iterator:
        if self._synthesize_fn is not None:
            yield from self._synthesize_fn(text, language)
            return
        voice = self.voice
        session_voice = self._session_voice(runtime_config, response)
        if session_voice and session_voice in self.model.voices:
            voice = session_voice
        yield from self.model.stream(text, voice=voice)
