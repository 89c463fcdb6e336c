"""Parakeet-TDT STT stage on PyTorch (port of ``s2s_tpu/stt/parakeet_handler.py``).

As in the JAX package, it subclasses the Whisper stage
(:class:`s2s_tpu_torch.stt.whisper_handler.WhisperSTTHandler`) for its
skeleton: duration buckets, PROGRESSIVE-lane ticks with a 10 ms admission
timeout, INTERACTIVE finals and the growing-window progressive streamer.
The transcriber runs the port's conformer and TDT decode, with text-based
language detection.  With a cross-session batched service
(``batch_service``, :class:`s2s_tpu_torch.runtime.batcher.BatchedParakeetSTT`)
the handler uses the service's shared weights and submits its windows
there, where concurrent sessions' windows coalesce into one batch.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import numpy as np
import torch

from s2s_tpu_torch.models import parakeet
from s2s_tpu_torch.stt.progressive import DecodeResult
from s2s_tpu_torch.stt.whisper_handler import WhisperSTTHandler, bucket_duration

logger = logging.getLogger(__name__)

#: Languages Parakeet TDT v3 reports (reference ``parakeet_tdt_handler.py:41-67``).
SUPPORTED_LANGUAGES = (
    "en de fr es it pt nl pl ru uk cs sk hu ro bg hr sl sr da no sv fi et lv lt".split()
)


def config_for(model_size: str) -> parakeet.ParakeetConfig:
    return {
        "0.6b": parakeet.ParakeetConfig.tdt_0_6b_v3,
        "0.6b-v3": parakeet.ParakeetConfig.tdt_0_6b_v3,
        "0.6b-v2": parakeet.ParakeetConfig.tdt_0_6b_v2,
        "tiny": parakeet.ParakeetConfig.test_tiny,
    }[model_size]()


class ParakeetSTTHandler(WhisperSTTHandler):
    """Same stage contract as the Whisper handler; conformer + TDT compute."""

    def setup(
        self,
        device: torch.device | str = "cpu",
        speculative_turns=None,
        device_scheduler=None,
        transcribe_fn: Callable[[np.ndarray], DecodeResult] | None = None,
        model_size: str = "0.6b",
        params: Any | None = None,
        tokenizer: Any | None = None,
        language: str | None = None,
        sample_rate: int = 16000,
        warmup: bool = False,
        cancel_scope=None,
        language_detector: Callable[[str], str | None] | None = None,
        batch_service=None,
    ) -> None:
        self._language_detector = language_detector
        #: cross-session batched transcribe service (one weight set, one
        #: dispatch for concurrent windows) — wired by the registry when
        #: several pipeline units share the device
        self._batch_service = batch_service
        super().setup(
            device=device,
            speculative_turns=speculative_turns,
            device_scheduler=device_scheduler,
            transcribe_fn=transcribe_fn,
            model_size=model_size,
            params=params,
            tokenizer=tokenizer,
            language=language,
            sample_rate=sample_rate,
            warmup=warmup,
            cancel_scope=cancel_scope,
        )

    def _build_transcriber(self, model_size, params, tokenizer, max_new_tokens):
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
                # Parakeet detects language from the TEXT
                lang = self._language_detector(text)
                self._detected_language = lang
            return DecodeResult(text, (), lang)

        return transcribe
