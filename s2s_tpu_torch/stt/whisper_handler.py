"""Whisper STT stage on PyTorch (port of ``s2s_tpu/stt/whisper_handler.py``).

One stage for all Whisper-flavored backends, over the port's Whisper
(:mod:`s2s_tpu_torch.models.whisper`) on an explicit device.  The stage
skeleton is the JAX handler's, copied: audio padded to duration buckets
(the encoder's positional embeddings sliced per bucket), progressive decodes
on the PROGRESSIVE scheduler lane with a 10 ms admission timeout, finals on
INTERACTIVE with a 5 s timeout, and the growing-window sentence-fixing
streamer.  The transcriber is the port's: the log-mel kernel
(:mod:`s2s_tpu_torch.ops.log_mel`), the encoder (whose attention is the
flash kernel) and a greedy decode.  The Parakeet stage
(:mod:`s2s_tpu_torch.stt.parakeet_handler`) subclasses this one, as in the
JAX package.

Seams: ``transcribe_fn(audio) -> DecodeResult`` for tests; tokenizer and
params injectable (random init otherwise).
"""

from __future__ import annotations

import logging
from time import perf_counter
from typing import Any, Callable, Iterator

import numpy as np
import torch

from s2s_tpu_torch.audio.pcm import int16_to_float32
from s2s_tpu_torch.pipeline.messages import PartialTranscription, Transcription, VADAudio
from s2s_tpu_torch.runtime.device_scheduler import GLOBAL_SCHEDULER, DeviceScheduler, Lane
from s2s_tpu_torch.stt.base import BaseSTTHandler
from s2s_tpu_torch.stt.progressive import DecodeResult, ProgressiveStreamer, SentenceSpan
from s2s_tpu_torch.stt.tokenizer import whisper_language_code, whisper_language_token

logger = logging.getLogger(__name__)

#: Audio duration buckets (seconds): the encoder sees one shape per bucket.
DURATION_BUCKETS_S = (1, 2, 3, 5, 8, 12, 15, 30)

PROGRESSIVE_ADMIT_TIMEOUT_S = 0.01
FINAL_ADMIT_TIMEOUT_S = 5.0


def bucket_duration(seconds: float) -> float:
    for b in DURATION_BUCKETS_S:
        if seconds <= b:
            return float(b)
    return float(DURATION_BUCKETS_S[-1])


def parse_timestamped_tokens(
    tokens: list[int], decode_text: Callable[[list[int]], str], no_timestamps: int
) -> tuple[str, tuple[SentenceSpan, ...]]:
    """Split a whisper token stream on timestamp tokens into sentence spans.
    Timestamp token ``no_timestamps + 1 + k`` means ``k * 0.02`` seconds."""
    spans: list[SentenceSpan] = []
    text_tokens: list[int] = []
    seg_tokens: list[int] = []
    seg_start: float | None = None
    for t in tokens:
        if t > no_timestamps:
            ts = (t - no_timestamps - 1) * 0.02
            if seg_start is None:
                seg_start = ts
            else:
                txt = decode_text(seg_tokens).strip()
                if txt:
                    spans.append(SentenceSpan(txt, seg_start, ts))
                seg_tokens, seg_start = [], None
        else:
            seg_tokens.append(t)
            text_tokens.append(t)
    if seg_tokens and seg_start is not None:
        txt = decode_text(seg_tokens).strip()
        if txt:
            spans.append(SentenceSpan(txt, seg_start, seg_start))
    return decode_text(text_tokens).strip(), tuple(spans)


class WhisperSTTHandler(BaseSTTHandler):
    """STT stage driving the port's Whisper on an explicit device."""

    def setup(
        self,
        device: torch.device | str = "cpu",
        speculative_turns=None,
        device_scheduler: DeviceScheduler | None = None,
        transcribe_fn: Callable[[np.ndarray], DecodeResult] | None = None,
        model_size: str = "tiny",
        params: Any | None = None,
        tokenizer: Any | None = None,
        language: str | None = None,
        sample_rate: int = 16000,
        max_new_tokens: int = 128,
        warmup: bool = True,
        cancel_scope=None,
    ) -> None:
        self.device = torch.device(device)
        self.speculative_turns = speculative_turns
        self.scheduler = device_scheduler or GLOBAL_SCHEDULER
        self.sample_rate = sample_rate
        self.language = None if language in (None, "auto") else language
        self._detected_language: str | None = None
        self.cancel_scope = cancel_scope

        if transcribe_fn is None:
            transcribe_fn = self._build_transcriber(model_size, params, tokenizer, max_new_tokens)
            if warmup:
                transcribe_fn(np.zeros(sample_rate, np.float32))
        self.transcribe_fn = transcribe_fn
        self.streamer = ProgressiveStreamer(decode_fn=self.transcribe_fn, sample_rate=sample_rate)

    def cleanup(self) -> None:
        """At the end of the stage's thread: drop the transcriber, whose
        closure holds this handler (and its model or batched service) in a
        cycle that would otherwise last until a garbage collection."""
        self.streamer = self.transcribe_fn = None

    def _build_transcriber(self, model_size, params, tokenizer, max_new_tokens):
        from s2s_tpu_torch.models import whisper
        from s2s_tpu_torch.ops.log_mel import log_mel_spectrogram

        cfg = {
            "tiny": whisper.WhisperConfig.tiny,
            "base": whisper.WhisperConfig.base,
            "small": whisper.WhisperConfig.small,
            "large-v3": whisper.WhisperConfig.large_v3,
            "distil-large-v3": whisper.WhisperConfig.distil_large_v3,
        }[model_size]()
        if params is None:
            logger.warning("WhisperSTTHandler: random-init weights (no checkpoint provided)")
            params = whisper.init_params(cfg, torch.Generator(device=self.device).manual_seed(0), self.device)
        self._whisper_cfg, self._whisper_params, self._tokenizer = cfg, params, tokenizer

        def transcribe(audio: np.ndarray) -> DecodeResult:
            seconds = len(audio) / self.sample_rate
            target = int(bucket_duration(max(seconds, 0.5)) * self.sample_rate)
            padded = np.zeros(target, np.float32)
            padded[: min(len(audio), target)] = audio[:target]
            mel = log_mel_spectrogram(torch.from_numpy(padded).to(self.device), cfg.n_mels)[None]
            encoded = whisper.encode(params, cfg, mel)

            lang = self.language or self._detected_language
            if lang is None:
                logits = whisper.detect_language_logits(params, cfg, encoded)
                lang_id = int(torch.argmax(logits[0, whisper.LANG_BASE : whisper.LANG_BASE + 100]))
                lang = whisper_language_code(whisper.LANG_BASE + lang_id) or "en"
                self._detected_language = lang
            lang_token = whisper_language_token(lang) or whisper.LANG_BASE
            prompt = torch.tensor([[whisper.SOT, lang_token, whisper.TRANSCRIBE, whisper.NO_TIMESTAMPS]],
                                  dtype=torch.int32, device=self.device)
            buf, n = whisper.greedy_decode_device(params, cfg, encoded, prompt, max_new_tokens)
            tokens = buf[:n].tolist()
            if self._tokenizer is not None:
                text, spans = parse_timestamped_tokens(
                    tokens, lambda ids: self._tokenizer.decode(ids), whisper.NO_TIMESTAMPS
                )
            else:
                text, spans = " ".join(str(t) for t in tokens), ()
            return DecodeResult(text, spans, lang)

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
