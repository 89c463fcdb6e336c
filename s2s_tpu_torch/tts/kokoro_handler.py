"""Kokoro TTS stage handler (reference ``TTS/kokoro_handler.py``)."""

from __future__ import annotations

import logging
from typing import Iterator, Optional

from s2s_tpu_torch.tts.base import BaseTTSHandler

logger = logging.getLogger(__name__)

# language code -> (lang family, default voice name) — mirrors the reference's
# language->voice defaults (kokoro_handler.py:32-73).
LANGUAGE_DEFAULT_VOICES = {
    "en": "af_heart", "fr": "ff_siwis", "es": "ef_dora", "it": "if_sara",
    "pt": "pf_dora", "hi": "hf_alpha", "ja": "jf_alpha", "zh": "zf_xiaobei",
}
_VOICE_IDS = {name: i for i, name in enumerate(sorted(set(LANGUAGE_DEFAULT_VOICES.values())))}


class KokoroTTSHandler(BaseTTSHandler):
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
    ) -> None:
        self.setup_base(
            cancel_scope=cancel_scope,
            speculative_turns=speculative_turns,
            device_scheduler=device_scheduler,
            should_listen=should_listen,
            blocksize=blocksize,
            speculative_synthesis=speculative_synthesis,
        )
        self.voice = voice
        self.speed = speed
        self._synthesize_fn = synthesize_fn
        if synthesize_fn is None:
            if model is None:
                from s2s_tpu_torch.models.kokoro import KokoroTTS

                logger.warning("KokoroTTSHandler: random-init weights (no checkpoint provided)")
                model = KokoroTTS()
            self.model = model
            if warmup:
                list(self.model.stream("Warm up.", voice_id=0))

    def _voice_id(self, voice_name: str | None, language: str | None) -> int:
        name = voice_name or self.voice or LANGUAGE_DEFAULT_VOICES.get(language or "en", "af_heart")
        return _VOICE_IDS.get(name, 0)

    def _synthesize(self, text: str, language: Optional[str], runtime_config, response) -> Iterator:
        if self._synthesize_fn is not None:
            yield from self._synthesize_fn(text, language)
            return
        voice = self._session_voice(runtime_config, response)
        yield from self.model.stream(text, voice_id=self._voice_id(voice, language), speed=self.speed)
