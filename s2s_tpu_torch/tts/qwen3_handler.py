"""Qwen3-TTS stage on PyTorch: the JAX package's ``Qwen3TTSHandler`` over
the port's :class:`~s2s_tpu_torch.models.qwen3_tts.Qwen3TTS` (port of
``s2s_tpu/tts/qwen3_handler.py``).

Utterance planning, voice selection, token budgets and streaming are
inherited.  The handler's ``jnp`` speaker lookups live only on its batched
engine path (``shared_tts``), which is ROADMAP queue 1 item 1 and refused
here; the single-session path looks speakers up in the port's model.  Voice
cloning from reference audio needs the log-mel port (ROADMAP queue 1 item 4)
and is refused too; a precomputed speaker vector works.
"""

from __future__ import annotations

import logging
from typing import Any

import torch

from s2s_tpu.tts.qwen3_handler import Qwen3TTSHandler as _JaxQwen3TTSHandler
from s2s_tpu_torch.models.qwen3_tts import Qwen3TTS, Qwen3TTSConfig

logger = logging.getLogger(__name__)


def config_for(model_size: str) -> Qwen3TTSConfig:
    return {"1.7b": Qwen3TTSConfig.qwen3_tts_12hz_1_7b, "tiny": Qwen3TTSConfig.tiny}[model_size]()


class Qwen3TTSHandler(_JaxQwen3TTSHandler):
    def setup(self, device: torch.device | str = "cpu", model: Any = None, model_size: str = "1.7b",
              streaming_chunk_size: int = 8, speaker_vec: Any = None, **kwargs: Any) -> None:
        if kwargs.get("shared_tts") is not None:
            raise NotImplementedError(
                "the cross-session batched TTS engine is not ported to s2s_tpu_torch yet "
                "(ROADMAP queue 1 item 1: BatchedTTSScheduler)"
            )
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
