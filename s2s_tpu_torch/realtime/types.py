"""Self-contained pydantic models for the OpenAI Realtime protocol surface.

The reference leans on the ``openai`` SDK for these types (e.g.
``openai.types.realtime.RealtimeSessionCreateRequest``,
``ResponseFunctionToolCall`` — see reference ``pipeline/messages.py`` and
``api/openai_realtime/runtime_config.py``).  We define the subset the
pipeline actually uses ourselves, so the framework has no SDK dependency
and the protocol surface is explicit and testable.

Field names/values follow the OpenAI Realtime API (GA, "type": "realtime").
"""

from __future__ import annotations

import secrets
from typing import Any, Literal, Optional, Union

from pydantic import BaseModel, ConfigDict, Field


def generate_id(prefix: str, nbytes: int = 12) -> str:
    """Generate an OpenAI-style opaque id, e.g. ``item_a1b2...``."""
    return f"{prefix}_{secrets.token_hex(nbytes)}"


class _Model(BaseModel):
    model_config = ConfigDict(extra="allow")


# ── Audio formats ─────────────────────────────────────────────────────


class AudioPCM(_Model):
    type: Literal["audio/pcm"] = "audio/pcm"
    rate: int = 24000


class AudioPCMU(_Model):
    type: Literal["audio/pcmu"] = "audio/pcmu"


class AudioPCMA(_Model):
    type: Literal["audio/pcma"] = "audio/pcma"


AudioFormat = Union[AudioPCM, AudioPCMU, AudioPCMA]


# ── Turn detection ────────────────────────────────────────────────────


class ServerVad(_Model):
    type: Literal["server_vad"] = "server_vad"
    threshold: Optional[float] = None
    prefix_padding_ms: Optional[int] = None
    silence_duration_ms: Optional[int] = None
    create_response: Optional[bool] = True
    interrupt_response: Optional[bool] = True
    idle_timeout_ms: Optional[int] = None


class SemanticVad(_Model):
    type: Literal["semantic_vad"] = "semantic_vad"
    eagerness: Optional[Literal["low", "medium", "high", "auto"]] = None
    create_response: Optional[bool] = True
    interrupt_response: Optional[bool] = True


TurnDetection = Union[ServerVad, SemanticVad]


# ── Session config (subset of RealtimeSessionCreateRequest) ───────────


class AudioInputTranscription(_Model):
    model: Optional[str] = None
    language: Optional[str] = None
    prompt: Optional[str] = None


class NoiseReduction(_Model):
    type: Optional[Literal["near_field", "far_field"]] = None


class AudioInputConfig(_Model):
    format: Optional[AudioFormat] = None
    noise_reduction: Optional[NoiseReduction] = None
    transcription: Optional[AudioInputTranscription] = None
    turn_detection: Optional[TurnDetection] = Field(
        default_factory=ServerVad,
    )


class AudioOutputConfig(_Model):
    format: Optional[AudioFormat] = None
    speed: Optional[float] = None
    voice: Optional[str] = None


class AudioConfig(_Model):
    input: Optional[AudioInputConfig] = None
    output: Optional[AudioOutputConfig] = None


class FunctionTool(_Model):
    type: Literal["function"] = "function"
    name: Optional[str] = None
    description: Optional[str] = None
    parameters: Optional[dict[str, Any]] = None


class SessionConfig(_Model):
    """The ``session`` object of ``session.update`` / ``session.created``."""

    type: Literal["realtime", "transcription"] = "realtime"
    model: Optional[str] = None
    instructions: Optional[str] = None
    output_modalities: Optional[list[Literal["text", "audio"]]] = None
    audio: Optional[AudioConfig] = None
    tools: Optional[list[FunctionTool]] = None
    tool_choice: Optional[Any] = None
    max_output_tokens: Optional[Union[int, Literal["inf"]]] = None
    tracing: Optional[Any] = None
    prompt: Optional[Any] = None


# ── Conversation items ────────────────────────────────────────────────


class InputTextContent(_Model):
    type: Literal["input_text"] = "input_text"
    text: Optional[str] = None


class InputAudioContent(_Model):
    type: Literal["input_audio"] = "input_audio"
    audio: Optional[str] = None  # base64
    transcript: Optional[str] = None


class InputImageContent(_Model):
    type: Literal["input_image"] = "input_image"
    image_url: Optional[str] = None
    detail: Optional[str] = None


class OutputTextContent(_Model):
    type: Literal["output_text"] = "output_text"
    text: Optional[str] = None


class OutputAudioContent(_Model):
    type: Literal["output_audio"] = "output_audio"
    audio: Optional[str] = None
    transcript: Optional[str] = None


ItemContent = Union[
    InputTextContent, InputAudioContent, InputImageContent, OutputTextContent, OutputAudioContent
]


class MessageItem(_Model):
    type: Literal["message"] = "message"
    id: Optional[str] = None
    role: Literal["user", "assistant", "system"] = "user"
    status: Optional[Literal["completed", "incomplete", "in_progress"]] = None
    content: list[ItemContent] = Field(default_factory=list)


class FunctionCallItem(_Model):
    type: Literal["function_call"] = "function_call"
    id: Optional[str] = None
    call_id: Optional[str] = None
    name: Optional[str] = None
    arguments: Optional[str] = None
    status: Optional[str] = None


class FunctionCallOutputItem(_Model):
    type: Literal["function_call_output"] = "function_call_output"
    id: Optional[str] = None
    call_id: Optional[str] = None
    output: Optional[str] = None
    status: Optional[str] = None


ConversationItem = Union[MessageItem, FunctionCallItem, FunctionCallOutputItem]


def parse_item(raw: dict[str, Any]) -> ConversationItem:
    t = raw.get("type")
    if t == "function_call":
        return FunctionCallItem.model_validate(raw)
    if t == "function_call_output":
        return FunctionCallOutputItem.model_validate(raw)
    return MessageItem.model_validate(raw)


# ── Function/tool calls emitted by the LLM ────────────────────────────


class FunctionToolCall(_Model):
    """Mirror of ``openai.types.responses.ResponseFunctionToolCall``."""

    type: Literal["function_call"] = "function_call"
    id: Optional[str] = None
    call_id: str = ""
    name: str = ""
    arguments: str = ""
    status: Optional[str] = None


# ── response.create params ────────────────────────────────────────────


class ResponseCreateParams(_Model):
    """The ``response`` object of a ``response.create`` client event."""

    conversation: Optional[Union[str, Literal["auto", "none"]]] = None
    input: Optional[list[dict[str, Any]]] = None
    instructions: Optional[str] = None
    metadata: Optional[dict[str, Any]] = None
    output_modalities: Optional[list[Literal["text", "audio"]]] = None
    audio: Optional[AudioConfig] = None
    tools: Optional[list[FunctionTool]] = None
    tool_choice: Optional[Any] = None
    max_output_tokens: Optional[Union[int, Literal["inf"]]] = None


# ── Usage ─────────────────────────────────────────────────────────────


class ResponseUsage(_Model):
    total_tokens: int = 0
    input_tokens: int = 0
    output_tokens: int = 0
    input_token_details: Optional[dict[str, Any]] = None
    output_token_details: Optional[dict[str, Any]] = None
