"""Parakeet-TDT STT stage on PyTorch: the JAX package's
``ParakeetSTTHandler`` with its transcriber replaced (port of
``s2s_tpu/stt/parakeet_handler.py``).

The gating, progressive streaming, duration buckets and language detection
are inherited unchanged.  With a cross-session batched service
(``batch_service``, :class:`s2s_tpu_torch.runtime.batcher.BatchedParakeetSTT`)
the handler uses the service's shared weights and submits its windows there,
where concurrent sessions' windows coalesce into one batch.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from s2s_tpu.stt.parakeet_handler import ParakeetSTTHandler as _JaxParakeetSTTHandler
from s2s_tpu.stt.progressive import DecodeResult
from s2s_tpu.stt.whisper_handler import bucket_duration
from s2s_tpu_torch.models import parakeet

logger = logging.getLogger(__name__)


def config_for(model_size: str) -> parakeet.ParakeetConfig:
    return {
        "0.6b": parakeet.ParakeetConfig.tdt_0_6b_v3,
        "0.6b-v3": parakeet.ParakeetConfig.tdt_0_6b_v3,
        "0.6b-v2": parakeet.ParakeetConfig.tdt_0_6b_v2,
        "tiny": parakeet.ParakeetConfig.test_tiny,
    }[model_size]()


class ParakeetSTTHandler(_JaxParakeetSTTHandler):
    """Same stage contract as the JAX handler; the port's conformer + TDT."""

    def setup(self, device: torch.device | str = "cpu", **kwargs: Any) -> None:
        self.device = torch.device(device)
        super().setup(**kwargs)

    def _build_jax_transcriber(self, model_size, params, tokenizer, max_new_tokens):
        service = self._batch_service
        cfg = service.cfg if service is not None else config_for(model_size)
        if service is not None:
            params = service.params  # one shared weight set across units
        elif params is None:
            logger.warning("ParakeetSTTHandler: random-init weights (no checkpoint provided)")
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = parakeet.init_params(cfg, gen, self.device)
        self._parakeet_cfg, self._parakeet_params, self._tokenizer = cfg, params, tokenizer

        def transcribe(audio: np.ndarray) -> DecodeResult:
            # mel -> encode -> TDT decode over a duration-bucketed window;
            # valid-length masking makes the padding invisible
            seconds = len(audio) / self.sample_rate
            target = int(bucket_duration(max(seconds, 0.5)) * self.sample_rate)
            padded = np.zeros(target, np.float32)
            n_valid = min(len(audio), target)
            padded[:n_valid] = audio[:target]
            if service is not None:
                tokens = service.transcribe(padded, n_valid)
            else:
                tokens = parakeet.transcribe_tokens(params, cfg, padded, n_valid, device=self.device)
            if self._tokenizer is not None:
                text = self._tokenizer.decode(tokens).strip()
            else:
                text = " ".join(str(t) for t in tokens)
            lang = self.language or self._detected_language
            if lang is None and self._language_detector is not None and text:
                lang = self._language_detector(text)
                self._detected_language = lang
            return DecodeResult(text, (), lang)

        return transcribe
