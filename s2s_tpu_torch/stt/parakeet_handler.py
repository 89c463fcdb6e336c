"""Parakeet-TDT STT stage on PyTorch (port of ``s2s_tpu/stt/parakeet_handler.py``).

The JAX handler subclasses the Whisper handler for its stage skeleton; here
that host logic is folded into one class: duration buckets, PROGRESSIVE-lane
ticks with a 10 ms admission timeout, INTERACTIVE finals, the growing-window
progressive streamer and text-based language detection.  ``bucket_duration``,
``process`` and ``on_session_end`` are the JAX package's, copied.  The
transcriber runs the port's conformer and TDT decode.  With a cross-session
batched service (``batch_service``,
:class:`s2s_tpu_torch.runtime.batcher.BatchedParakeetSTT`) the handler uses
the service's shared weights and submits its windows there, where
concurrent sessions' windows coalesce into one batch.
"""

from __future__ import annotations

import logging
from time import perf_counter
from typing import Any, Callable, Iterator

import numpy as np
import torch

from s2s_tpu_torch.audio.pcm import int16_to_float32
from s2s_tpu_torch.models import parakeet
from s2s_tpu_torch.pipeline.messages import PartialTranscription, Transcription, VADAudio
from s2s_tpu_torch.runtime.device_scheduler import GLOBAL_SCHEDULER, DeviceScheduler, Lane
from s2s_tpu_torch.stt.base import BaseSTTHandler
from s2s_tpu_torch.stt.progressive import DecodeResult, ProgressiveStreamer

logger = logging.getLogger(__name__)

DURATION_BUCKETS_S = (1, 2, 3, 5, 8, 12, 15, 30)

PROGRESSIVE_ADMIT_TIMEOUT_S = 0.01
FINAL_ADMIT_TIMEOUT_S = 5.0

SUPPORTED_LANGUAGES = (
    "en de fr es it pt nl pl ru uk cs sk hu ro bg hr sl sr da no sv fi et lv lt".split()
)


def bucket_duration(seconds: float) -> float:
    for b in DURATION_BUCKETS_S:
        if seconds <= b:
            return float(b)
    return float(DURATION_BUCKETS_S[-1])


def config_for(model_size: str) -> parakeet.ParakeetConfig:
    return {
        "0.6b": parakeet.ParakeetConfig.tdt_0_6b_v3,
        "0.6b-v3": parakeet.ParakeetConfig.tdt_0_6b_v3,
        "0.6b-v2": parakeet.ParakeetConfig.tdt_0_6b_v2,
        "tiny": parakeet.ParakeetConfig.test_tiny,
    }[model_size]()


class ParakeetSTTHandler(BaseSTTHandler):
    """STT stage driving the port's Parakeet-TDT on an explicit device."""

    def setup(
        self,
        device: torch.device | str = "cpu",
        speculative_turns=None,
        device_scheduler: DeviceScheduler | None = None,
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
        self.device = torch.device(device)
        self._language_detector = language_detector
        #: cross-session batched transcribe service (one weight set, one
        #: dispatch for concurrent windows) — wired by the registry when
        #: several pipeline units share the device
        self._batch_service = batch_service
        self.speculative_turns = speculative_turns
        self.scheduler = device_scheduler or GLOBAL_SCHEDULER
        self.sample_rate = sample_rate
        self.language = None if language in (None, "auto") else language
        self._detected_language: str | None = None
        self.cancel_scope = cancel_scope

        if transcribe_fn is None:
            transcribe_fn = self._build_transcriber(model_size, params, tokenizer)
            if warmup:
                transcribe_fn(np.zeros(sample_rate, np.float32))
        self.transcribe_fn = transcribe_fn
        self.streamer = ProgressiveStreamer(decode_fn=self.transcribe_fn, sample_rate=sample_rate)

    def _build_transcriber(self, model_size, params, tokenizer):
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

    def process(self, item: VADAudio) -> Iterator[Any]:
        audio = item.audio
        if audio.dtype == np.int16:
            audio = int16_to_float32(audio)
        progressive = item.mode == "progressive"
        lane = Lane.PROGRESSIVE if progressive else Lane.INTERACTIVE
        timeout = PROGRESSIVE_ADMIT_TIMEOUT_S if progressive else FINAL_ADMIT_TIMEOUT_S
        t0 = perf_counter()
        with self.scheduler.slot(lane, timeout) as admitted:
            if not admitted:
                if progressive:
                    logger.debug("WhisperSTT: progressive tick skipped (device busy)")
                    return
                logger.warning("WhisperSTT: final admission timed out; decoding anyway")
                result = self.streamer.final(audio)
            elif progressive:
                result = self.streamer.feed(audio)
            else:
                result = self.streamer.final(audio)
        infer_s = perf_counter() - t0

        if progressive:
            if result.text:
                yield PartialTranscription(
                    text=result.text, turn_id=item.turn_id, turn_revision=item.turn_revision
                )
            return
        logger.info("WhisperSTT final: %.3fs infer, %.1fs audio", infer_s, len(audio) / self.sample_rate)
        yield Transcription(
            text=result.text,
            language_code=result.language_code,
            turn_id=item.turn_id,
            turn_revision=item.turn_revision,
            speech_stopped_at_s=item.created_at_s,
        )

    def on_session_end(self) -> None:
        super().on_session_end()
        self.streamer.reset()
        self._detected_language = None

    timing_log_level = logging.INFO
