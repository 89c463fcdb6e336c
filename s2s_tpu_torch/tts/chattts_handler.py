"""ChatTTS handler (reference ``TTS/chatTTS_handler.py``): a random
speaker embedding drawn per session, stream-or-batch emission.

The port's copy of ``s2s_tpu/tts/chattts_handler.py``, trimmed: the JAX
module draws the speaker with ``jax.random``; here ``_resample_speaker``
draws it with the port's :func:`s2s_tpu_torch.models.chattts.sample_speaker`
on a ``torch.Generator`` seeded from the same ``random.Random(seed)``
stream, so a seed gives a different speaker from the JAX package's.
Everything else is copied; the model is the port's
:class:`~s2s_tpu_torch.models.chattts.ChatTTSModel`."""

from __future__ import annotations

import logging
import random
from typing import Iterator, Optional

from s2s_tpu_torch.tts.base import BaseTTSHandler

logger = logging.getLogger(__name__)


class ChatTTSHandler(BaseTTSHandler):
    def setup(
        self,
        cancel_scope=None,
        speculative_turns=None,
        device_scheduler=None,
        should_listen=None,
        blocksize: int = 512,
        speculative_synthesis: bool = True,
        stream: bool = True,
        seed: int | None = None,
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
        self.stream_mode = stream
        self._synthesize_fn = synthesize_fn
        if synthesize_fn is None:
            if model is None:
                from s2s_tpu_torch.models.chattts import ChatTTSModel

                logger.warning("ChatTTSHandler: random-init weights (no checkpoint provided)")
                model = ChatTTSModel()
            self.model = model
            # one speaker per session, resampled on SESSION_END (reference
            # draws rand_spk once per Chat instance)
            self._seed_rng = random.Random(seed)
            self._resample_speaker()
            if warmup:
                self.model.synthesize("Warm up.", speaker=self._speaker)

    def _resample_speaker(self) -> None:
        import torch

        from s2s_tpu_torch.models.chattts import sample_speaker

        self._speaker = sample_speaker(
            self.model.params, torch.Generator().manual_seed(self._seed_rng.randrange(2**31))
        )

    def on_session_end(self) -> None:
        super().on_session_end()
        if self._synthesize_fn is None:
            self._resample_speaker()

    def _synthesize(self, text: str, language: Optional[str], runtime_config, response) -> Iterator:
        if self._synthesize_fn is not None:
            yield from self._synthesize_fn(text, language)
            return
        if self.stream_mode:
            yield from self.model.stream(text, speaker=self._speaker)
        else:
            audio = self.model.synthesize(text, speaker=self._speaker)
            yield audio, 24000
