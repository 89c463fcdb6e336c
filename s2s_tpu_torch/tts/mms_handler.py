"""Facebook-MMS-style TTS stage handler (reference
``TTS/facebookmms_handler.py``): per-language VITS voices, non-streaming
synthesis then chunked emission.  The reference reloads a whole
``facebook/mms-tts-<lang>`` model on language change; here per-language
converted checkpoints register as parameter sets on one compiled program
(``VitsTTS.add_language``) so a switch is a weight swap, not a reload."""

from __future__ import annotations

import logging
from typing import Iterator, Optional

from s2s_tpu_torch.tts.base import BaseTTSHandler

logger = logging.getLogger(__name__)


class MMSTTSHandler(BaseTTSHandler):
    def setup(
        self,
        cancel_scope=None,
        speculative_turns=None,
        device_scheduler=None,
        should_listen=None,
        blocksize: int = 512,
        speculative_synthesis: bool = True,
        language: str | None = None,
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
        self.default_language = language
        self.speed = speed
        self._synthesize_fn = synthesize_fn
        if synthesize_fn is None:
            if model is None:
                from s2s_tpu_torch.models.vits import VitsTTS

                logger.warning("MMSTTSHandler: random-init weights (no checkpoint provided)")
                model = VitsTTS()
            self.model = model
            if warmup:
                list(self.model.stream("Warm up.", language="en"))

    def _synthesize(self, text: str, language: Optional[str], runtime_config, response) -> Iterator:
        if self._synthesize_fn is not None:
            yield from self._synthesize_fn(text, language)
            return
        lang = language or self.default_language or "en"
        yield from self.model.stream(text, language=lang, speed=self.speed)
