"""Qwen3-TTS stage on PyTorch (port of ``s2s_tpu/tts/qwen3_handler.py``)
over the port's :class:`~s2s_tpu_torch.models.qwen3_tts.Qwen3TTS`.

Utterance planning, voice selection, token budgets and the speculative-
synthesis bookkeeping are the JAX handler's, copied.  Where the JAX handler
looks speakers up with ``jnp``, a speaker here is a row of the model's
speaker table on its device, and text ids go to a cross-session batched
engine (``shared_tts``,
:class:`s2s_tpu_torch.parallel.session_scheduler.BatchedTTSScheduler`) as
host arrays.  Voice cloning takes a precomputed speaker vector or reference
audio (``ref_audio``, 16 kHz f32), whose speaker vector
:func:`~s2s_tpu_torch.models.qwen3_tts.speaker_from_reference` computes on
the model's device through the log-mel kernel.
"""

from __future__ import annotations

import logging
import math
import re
import unicodedata
from typing import Any, Iterator, Optional

import torch

from s2s_tpu_torch.models.qwen3_tts import Qwen3TTS, Qwen3TTSConfig, speaker_from_reference
from s2s_tpu_torch.tts.base import BaseTTSHandler

logger = logging.getLogger(__name__)

TOKENS_PER_SECOND = 12.5
WORDS_PER_SECOND = 2.6
CHARS_PER_SECOND = 13.0
CJK_CHARS_PER_SECOND = 4.0
PUNCTUATION_PAUSE_S = 0.3
BASE_PROMPT_S = 0.6
TOKEN_SAFETY_MARGIN = 1.35
MIN_UTTERANCE_TOKENS = 16
DEFAULT_MAX_NEW_TOKENS = 1024

_CJK = re.compile(r"[぀-ヿ㐀-鿿豈-﫿]")

PRESET_SPEAKERS = ("vivian", "ryan", "serena", "dylan", "cherry", "ethan")
_SPEAKER_IDS = {name: i for i, name in enumerate(PRESET_SPEAKERS)}


def estimate_max_new_tokens(
    text: str | None, chunk_size: int = 8, cap: int = DEFAULT_MAX_NEW_TOKENS
) -> int:
    """Codec-token budget for an utterance (reference estimation formula)."""
    text = (text or "").strip()
    chunk_size = max(1, chunk_size)
    cap = max(1, cap)
    if not text:
        return min(cap, MIN_UTTERANCE_TOKENS)
    words = len(re.findall(r"\w+", text, flags=re.UNICODE))
    chars = len(re.sub(r"\s+", "", text))
    cjk = len(_CJK.findall(text))
    seconds = max(
        words / WORDS_PER_SECOND if words else 0.0,
        chars / CHARS_PER_SECOND if chars else 0.0,
        cjk / CJK_CHARS_PER_SECOND if cjk else 0.0,
    )
    seconds += sum(unicodedata.category(c).startswith("P") for c in text) * PUNCTUATION_PAUSE_S
    seconds += BASE_PROMPT_S
    tokens = math.ceil(seconds * TOKENS_PER_SECOND * TOKEN_SAFETY_MARGIN)
    aligned = max(chunk_size, math.ceil(tokens / chunk_size) * chunk_size)
    requested = max(MIN_UTTERANCE_TOKENS, aligned)
    if requested > cap:
        logger.warning(
            "Qwen3-TTS estimated %d codec tokens but max_new_tokens caps at %d; may truncate",
            requested, cap,
        )
    return min(cap, requested)


def config_for(model_size: str) -> Qwen3TTSConfig:
    return {"1.7b": Qwen3TTSConfig.qwen3_tts_12hz_1_7b, "tiny": Qwen3TTSConfig.tiny}[model_size]()


class Qwen3TTSHandler(BaseTTSHandler):
    def setup(
        self,
        device: torch.device | str = "cpu",
        cancel_scope=None,
        speculative_turns=None,
        device_scheduler=None,
        should_listen=None,
        blocksize: int = 512,
        voice: str | None = None,
        ref_audio: Any = None,
        speaker_vec=None,
        voice_instruct: str | None = None,
        streaming_chunk_size: int = 8,
        max_new_tokens: int = DEFAULT_MAX_NEW_TOKENS,
        synthesize_fn=None,
        model=None,
        model_size: str = "1.7b",
        shared_tts=None,
        speculative_synthesis: bool = True,
        warmup: bool = False,
    ) -> None:
        device = torch.device(device)
        self.setup_base(
            cancel_scope=cancel_scope,
            speculative_turns=speculative_turns,
            device_scheduler=device_scheduler,
            should_listen=should_listen,
            blocksize=blocksize,
        )
        self.voice = voice
        self.voice_instruct = voice_instruct
        self.streaming_chunk_size = streaming_chunk_size
        self.max_new_tokens = max_new_tokens
        self._synthesize_fn = synthesize_fn
        #: cross-session batched synthesis engine (one per weight set)
        self.shared_tts = shared_tts
        #: whole-chain speculation: pre-synthesize the LLM speculation's
        #: first sentence batch into a spare (ungated) engine slot; the real
        #: TTSInput adopts the buffered audio on exact (text, speaker,
        #: budget) match
        self.speculative_synthesis = bool(speculative_synthesis) and shared_tts is not None
        self._spec_synth: tuple[tuple, Any] | None = None  # (plan_key, handle)
        self._spec_turn: str | None = None  # turn the speculation belongs to
        # precomputed .spk embedding (cached-reference mode)
        self._speaker_vec = torch.as_tensor(speaker_vec, device=device) if speaker_vec is not None else None
        if synthesize_fn is None:
            if model is None:
                logger.warning("Qwen3TTSHandler: random-init weights (no checkpoint provided)")
                model = Qwen3TTS(cfg=config_for(model_size), chunk_frames=streaming_chunk_size, device=device)
            self.model = model
            if ref_audio is not None and self._speaker_vec is None:
                self._speaker_vec = speaker_from_reference(self.model.params, ref_audio)
            if warmup:
                list(self.model.stream("Warm up.", max_new_tokens=streaming_chunk_size))

    def _model_type(self) -> str:
        if self._speaker_vec is not None:
            return "voice_clone"
        if self.voice_instruct:
            return "voice_design"
        return "custom_voice"

    def _uses_shared_engine(self) -> bool:
        # batched-engine utterances must NOT hold the process-wide
        # INTERACTIVE slot for their whole stream: with N serving sessions
        # that serializes synthesis at the handler level even though the
        # engine batches all of them through one dispatch stream
        return self.shared_tts is not None

    def _plan_utterance(self, text: str, runtime_config, response):
        """Resolve everything device dispatch depends on for one utterance:
        (final_text, speaker_vec_or_None, plan_key, max_new).  ``plan_key``
        identifies the dispatch-identical plan — speculative synthesis is
        adopted only when the real input produces the same key."""
        max_new = estimate_max_new_tokens(text, self.streaming_chunk_size, self.max_new_tokens)
        mode = self._model_type()
        speaker_vec = None
        speaker_id = 0
        if mode == "voice_clone":
            speaker_vec = self._speaker_vec
        else:
            if mode == "voice_design":
                text = f"[{self.voice_instruct}] {text}"
            voice = self._session_voice(runtime_config, response) or self.voice or PRESET_SPEAKERS[0]
            speaker_id = _SPEAKER_IDS.get(str(voice).lower(), 0)
        key = (text, mode, speaker_id, max_new)
        return text, speaker_vec, speaker_id, key, max_new

    def _cancel_speculative_synthesis(self) -> None:
        spec = self._spec_synth
        self._spec_synth = None
        self._spec_turn = None
        if spec is not None:
            spec[1].cancel()

    def _discard_speculation_for(self, turn_id) -> None:
        if turn_id is not None and turn_id == self._spec_turn:
            self._cancel_speculative_synthesis()

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

    def on_session_end(self) -> None:
        self._cancel_speculative_synthesis()
        super().on_session_end()

    def _synthesize(self, text: str, language: Optional[str], runtime_config, response) -> Iterator:
        if self._synthesize_fn is not None:
            yield from self._synthesize_fn(text, language)
            return
        cancel = None
        if self.cancel_scope is not None:
            gen = self.cancel_scope.generation
            cancel = lambda: self.cancel_scope.is_stale(gen)  # noqa: E731
        text, speaker_vec, speaker_id, key, max_new = self._plan_utterance(text, runtime_config, response)
        if self.shared_tts is not None:
            # batched path: this utterance shares ONE dispatch stream with
            # every other session's synthesis
            spec = self._spec_synth
            self._spec_synth = None
            self._spec_turn = None
            if spec is not None and spec[0] == key:
                # adoption: the engine has been synthesizing this exact
                # utterance; its remaining ramp now holds the cross-scheduler gate
                spec[1].promote()
                spec[1].bind_cancel(cancel)
                yield from spec[1].chunks()
                return
            if spec is not None:
                spec[1].cancel()
            tokens, speaker_vec = self._engine_inputs(text, speaker_vec, speaker_id)
            yield from self.shared_tts.stream(tokens, speaker_vec, max_new, cancel_check=cancel)
            return
        if speaker_vec is not None:
            yield from self.model.stream(
                text, max_new_tokens=max_new, speaker_vec=speaker_vec, cancel_check=cancel
            )
            return
        yield from self.model.stream(
            text, max_new_tokens=max_new, speaker_id=speaker_id, cancel_check=cancel
        )
