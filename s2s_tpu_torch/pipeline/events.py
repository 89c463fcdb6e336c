"""Side-channel pipeline events (the ``text_output_queue`` of the reference).

Produced by VAD / transcription notifier / LM output processor; consumed by
the realtime send loop which maps them onto OpenAI Realtime wire events.
The ``type`` literal discriminates; every speculative event derives from
:class:`TurnScopedEvent` so staleness gates can treat them uniformly.
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np
from pydantic import BaseModel, ConfigDict, Field

from s2s_tpu_torch.realtime.types import FunctionToolCall


class PipelineEvent(BaseModel):
    type: str


class TurnScopedEvent(PipelineEvent):
    """Event carrying speculative-turn identity (gated on staleness)."""

    turn_id: str | None = None
    turn_revision: int | None = None


# ── VAD → send loop ───────────────────────────────────────────────────


class SpeechStartedEvent(TurnScopedEvent):
    """User speech confirmed; triggers barge-in when a response is active.
    ``interrupt_response`` is excluded from the wire (internal routing only);
    ``reopened`` marks a speculative-turn continuation."""

    type: Literal["speech_started"] = "speech_started"
    audio_start_ms: int = 0
    reopened: bool = False
    interrupt_response: bool = Field(default=True, exclude=True)


class SpeechStoppedEvent(TurnScopedEvent):
    type: Literal["speech_stopped"] = "speech_stopped"
    duration_s: float = 0.0
    audio_end_ms: int = 0


# ── transcription notifier → send loop ───────────────────────────────


class PartialTranscriptionEvent(TurnScopedEvent):
    type: Literal["partial_transcription"] = "partial_transcription"
    delta: str


class TranscriptionCompletedEvent(TurnScopedEvent):
    """Final STT result; the service writes the chat + queues the LLM.
    ``speech_stopped_at_s`` rides along (excluded from the wire) so latency
    can be measured end to end."""

    type: Literal["transcription_completed"] = "transcription_completed"
    transcript: str
    language_code: Optional[str] = None
    speech_stopped_at_s: float | None = Field(default=None, exclude=True)


class AudioInputCompletedEvent(TurnScopedEvent):
    """Direct-audio (no-STT) sessions: final VAD audio awaiting the LLM."""

    model_config = ConfigDict(arbitrary_types_allowed=True)

    type: Literal["audio_input_completed"] = "audio_input_completed"
    audio: np.ndarray = Field(exclude=True)
    audio_sample_rate: int = 16000
    audio_duration_s: float = 0.0
    speech_stopped_at_s: float | None = Field(default=None, exclude=True)


# ── LM output processor → send loop ──────────────────────────────────


class AssistantTextEvent(TurnScopedEvent):
    """Assistant sentence batch (and/or tool calls).  Tagged with the
    producing ``cancel_generation`` so the send loop discards stale text by
    the same generation rule as audio."""

    type: Literal["assistant_text"] = "assistant_text"
    text: str
    tools: list[FunctionToolCall] = Field(default_factory=list)
    cancel_generation: int | None = None


class TokenUsageEvent(TurnScopedEvent):
    type: Literal["token_usage"] = "token_usage"
    input_tokens: int = 0
    output_tokens: int = 0


class ResponseFailedEvent(TurnScopedEvent):
    """Generation failed; the service closes the response as ``failed``."""

    type: Literal["response_failed"] = "response_failed"
    message: str = ""
