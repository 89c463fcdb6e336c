"""Typed messages flowing between pipeline stages.

One pydantic model per hop of the dataflow spine (reference
``pipeline/messages.py``); every speculative message carries
``turn_id`` / ``turn_revision``, every post-LLM message carries the
``cancel_generation`` it was produced under, and the latency-critical chain
threads ``speech_stopped_at_s`` end-to-end so TTS can log
"last speech in -> first speech out".
"""

from __future__ import annotations

from time import perf_counter
from typing import Final, Literal, Optional, Union

import numpy as np
from pydantic import BaseModel, ConfigDict, Field

from s2s_tpu_torch.realtime.config import RuntimeConfig
from s2s_tpu_torch.realtime.types import FunctionToolCall, ResponseCreateParams


class PipelineMessage(BaseModel):
    """Base for typed stage-to-stage messages (``tag`` discriminates)."""

    model_config = ConfigDict(arbitrary_types_allowed=True)

    tag: str


# ── VAD -> STT ────────────────────────────────────────────────────────


class VADAudio(PipelineMessage):
    """Speech audio released by VAD: progressive ticks or the final segment."""

    tag: Literal["vad_audio"] = "vad_audio"
    audio: np.ndarray
    runtime_config: RuntimeConfig | None = None
    mode: Literal["progressive", "final"] | None = None
    turn_id: str | None = None
    turn_revision: int | None = None
    processing_delay_s: float = 0.0
    created_at_s: float = Field(default_factory=perf_counter)


# ── STT -> notifier ───────────────────────────────────────────────────


class PartialTranscription(PipelineMessage):
    tag: Literal["partial_transcription"] = "partial_transcription"
    text: str
    turn_id: str | None = None
    turn_revision: int | None = None


class Transcription(PipelineMessage):
    tag: Literal["transcription"] = "transcription"
    text: str
    language_code: Optional[str] = None
    turn_id: str | None = None
    turn_revision: int | None = None
    speech_stopped_at_s: float | None = None


# ── service -> LLM ────────────────────────────────────────────────────


class SpeculativeGenerateRequest(PipelineMessage):
    """Start generating on the PROGRESSIVE transcript before the STT final
    lands (local-JAX backend only).  The handler renders the prompt the
    final WOULD produce for this text, starts a slot in the batched engine,
    and adopts the already-decoding tokens iff the final request renders the
    identical prompt — extending the reference's speculative-turn trick
    (STT/LLM start before turn commit) one stage earlier.  A newer partial,
    a mismatching final, barge-in, or SESSION_END cancels it."""

    tag: Literal["speculative_generate"] = "speculative_generate"
    runtime_config: RuntimeConfig
    text: str
    turn_id: str | None = None
    turn_revision: int | None = None


class SpeculativeTTSText(PipelineMessage):
    """Pre-synthesize the speculative generation's FIRST sentence batch
    before the STT final lands (whole-chain speculation, stage three).  The
    LLM handler's speculation watcher emits this the moment the first
    sentence batch completes; the TTS handler starts an UNGATED engine slot
    and the real ``TTSInput`` adopts the buffered audio iff its coalesced
    text, speaker, and token budget are identical.  Wrong speculation costs
    one spare slot's synthesis and can never leak — nothing is emitted until
    the real input adopts."""

    tag: Literal["speculative_tts_text"] = "speculative_tts_text"
    runtime_config: RuntimeConfig
    text: str
    turn_id: str | None = None
    turn_revision: int | None = None


class GenerateResponseRequest(PipelineMessage):
    """Everything the LM handler needs: per-connection config+chat, per-response
    overrides, optional raw audio for direct-audio sessions."""

    tag: Literal["generate_response"] = "generate_response"
    runtime_config: RuntimeConfig
    response: ResponseCreateParams | None = None
    audio: np.ndarray | None = None
    audio_sample_rate: int = 16000
    language_code: Optional[str] = None
    turn_id: str | None = None
    turn_revision: int | None = None
    speech_stopped_at_s: float | None = None


# ── LLM -> output processor ──────────────────────────────────────────


class LLMResponseChunk(PipelineMessage):
    """One sentence batch of the streamed LLM response."""

    tag: Literal["llm_response_chunk"] = "llm_response_chunk"
    text: str
    language_code: Optional[str] = None
    tools: list[FunctionToolCall] = Field(default_factory=list)
    runtime_config: RuntimeConfig | None = None
    response: ResponseCreateParams | None = None
    turn_id: str | None = None
    turn_revision: int | None = None
    speech_stopped_at_s: float | None = None
    cancel_generation: int | None = None


class TokenUsage(PipelineMessage):
    tag: Literal["token_usage"] = "token_usage"
    input_tokens: int
    output_tokens: int
    turn_id: str | None = None
    turn_revision: int | None = None


class EndOfResponse(PipelineMessage):
    """Terminates a response. ``error`` set => response.done(status="failed")."""

    tag: Literal["end_of_response"] = "end_of_response"
    turn_id: str | None = None
    turn_revision: int | None = None
    cancel_generation: int | None = None
    error: str | None = None


# ── processor -> TTS ──────────────────────────────────────────────────


class TTSInput(PipelineMessage):
    tag: Literal["tts_input"] = "tts_input"
    text: str
    language_code: Optional[str] = None
    runtime_config: RuntimeConfig | None = None
    response: ResponseCreateParams | None = None
    turn_id: str | None = None
    turn_revision: int | None = None
    speech_stopped_at_s: float | None = None
    cancel_generation: int | None = None


class AudioOutput(PipelineMessage):
    """Synthesized audio tagged with its producing generation so the send loop
    can drop stale chunks after a barge-in."""

    tag: Literal["audio_output"] = "audio_output"
    audio: Union[bytes, np.ndarray]
    cancel_generation: int | None = None


# ── binary sentinels on the audio output queue ───────────────────────

AUDIO_RESPONSE_DONE: Final[bytes] = b"__RESPONSE_DONE__"
PIPELINE_END: Final[bytes] = b"END"
