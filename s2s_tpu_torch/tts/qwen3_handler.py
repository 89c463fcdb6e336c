"""Qwen3-TTS stage on PyTorch: the JAX package's ``Qwen3TTSHandler`` over
the port's :class:`~s2s_tpu_torch.models.qwen3_tts.Qwen3TTS` (port of
``s2s_tpu/tts/qwen3_handler.py``).

Utterance planning, voice selection, token budgets, streaming and the
speculative-synthesis bookkeeping are inherited.  The two methods that
drive a cross-session batched engine (``shared_tts``,
:class:`s2s_tpu_torch.parallel.session_scheduler.BatchedTTSScheduler`) are
overridden only where the JAX handler looks speakers up with ``jnp``: here
a speaker is a row of the model's speaker table on its device, and the text
ids go to the engine as host arrays.  Voice cloning from reference audio
needs the log-mel port (ROADMAP queue 1 item 4) and is refused; a
precomputed speaker vector works.
"""

from __future__ import annotations

import logging
from typing import Any, Iterator, Optional

import torch

from s2s_tpu.tts.qwen3_handler import Qwen3TTSHandler as _JaxQwen3TTSHandler
from s2s_tpu_torch.models.qwen3_tts import Qwen3TTS, Qwen3TTSConfig

logger = logging.getLogger(__name__)


def config_for(model_size: str) -> Qwen3TTSConfig:
    return {"1.7b": Qwen3TTSConfig.qwen3_tts_12hz_1_7b, "tiny": Qwen3TTSConfig.tiny}[model_size]()


class Qwen3TTSHandler(_JaxQwen3TTSHandler):
    def setup(self, device: torch.device | str = "cpu", model: Any = None, model_size: str = "1.7b",
              streaming_chunk_size: int = 8, speaker_vec: Any = None, **kwargs: Any) -> None:
        if kwargs.get("ref_audio") is not None and speaker_vec is None:
            raise NotImplementedError(
                "voice cloning from --tts_ref_audio needs the log-mel port (ROADMAP queue 1 "
                "item 4); pass a precomputed --tts_ref_spk instead"
            )
        device = torch.device(device)
        if model is None and kwargs.get("synthesize_fn") is None:
            logger.warning("Qwen3TTSHandler: random-init weights (no checkpoint provided)")
            model = Qwen3TTS(cfg=config_for(model_size), chunk_frames=streaming_chunk_size, device=device)
        if speaker_vec is not None:
            speaker_vec = torch.as_tensor(speaker_vec, device=device)
        super().setup(model=model, model_size=model_size, streaming_chunk_size=streaming_chunk_size,
                      speaker_vec=speaker_vec, **kwargs)

    def _engine_inputs(self, text: str, speaker_vec, speaker_id: int):
        """(host text ids at the engine's bucket, (1, D) speaker on the device)."""
        tokens, _ = self.model.encode_text_host(text, bucket=self.shared_tts.text_bucket)
        if speaker_vec is None:
            speaker_vec = self.model.speaker(speaker_id)
        return tokens, speaker_vec

    def _begin_speculative_synthesis(self, item) -> None:
        """Start pre-synthesis of the speculation's first sentence batch in an
        ungated spare engine slot; nothing is emitted until adoption."""
        self._cancel_speculative_synthesis()
        if not self.speculative_synthesis or self._synthesize_fn is not None:
            return
        text = (item.text or "").strip()
        if not text:
            return
        final_text, speaker_vec, speaker_id, key, max_new = self._plan_utterance(text, item.runtime_config, None)
        tokens, speaker_vec = self._engine_inputs(final_text, speaker_vec, speaker_id)
        handle = self.shared_tts.start(tokens, speaker_vec, max_new, gated=False)
        if handle is not None:  # None: every slot busy, skip rather than queue
            self._spec_synth = (key, handle)
            self._spec_turn = item.turn_id

    def _synthesize(self, text: str, language: Optional[str], runtime_config, response) -> Iterator:
        if self.shared_tts is None or self._synthesize_fn is not None:
            yield from super()._synthesize(text, language, runtime_config, response)
            return
        cancel = None
        if self.cancel_scope is not None:
            gen = self.cancel_scope.generation
            cancel = lambda: self.cancel_scope.is_stale(gen)  # noqa: E731
        text, speaker_vec, speaker_id, key, max_new = self._plan_utterance(text, runtime_config, response)
        spec = self._spec_synth
        self._spec_synth = None
        self._spec_turn = None
        if spec is not None and spec[0] == key:
            # adoption: the engine has been synthesizing this exact utterance;
            # its remaining ramp now holds the cross-scheduler gate
            spec[1].promote()
            spec[1].bind_cancel(cancel)
            yield from spec[1].chunks()
            return
        if spec is not None:
            spec[1].cancel()
        tokens, speaker_vec = self._engine_inputs(text, speaker_vec, speaker_id)
        yield from self.shared_tts.stream(tokens, speaker_vec, max_new, cancel_check=cancel)
