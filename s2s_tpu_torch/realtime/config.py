"""Shared per-connection runtime configuration.

Written by the realtime service on ``session.update``; read live by pipeline
handlers (VAD thresholds, TTS voice, LLM instructions/tools) — mirrors
reference ``api/openai_realtime/runtime_config.py``.  Primitive attribute
reads/writes are GIL-atomic so handlers read without locks.
"""

from __future__ import annotations

from pydantic import BaseModel, ConfigDict, Field, field_validator

from s2s_tpu_torch.llm.chat import Chat
from s2s_tpu_torch.realtime.types import (
    AudioConfig,
    AudioInputConfig,
    AudioOutputConfig,
    SessionConfig,
)


def merge_models(current: BaseModel, update: BaseModel) -> None:
    """Recursively apply *update*'s explicitly-set fields onto *current*.

    Only fields in ``model_fields_set`` (actually sent by the client) are
    applied; nested BaseModel children merge field-by-field so a partial
    nested update can't wipe sibling fields.
    """
    for name in update.model_fields_set:
        new_val = getattr(update, name)
        old_val = getattr(current, name, None)
        if isinstance(new_val, BaseModel) and isinstance(old_val, BaseModel):
            merge_models(old_val, new_val)
        else:
            setattr(current, name, new_val)


class RuntimeConfig(BaseModel):
    model_config = ConfigDict(validate_assignment=True, arbitrary_types_allowed=True)

    chat: Chat = Field(default_factory=lambda: Chat(10))
    session: SessionConfig = Field(
        default_factory=lambda: SessionConfig(type="realtime"), validate_default=True
    )

    @field_validator("session", mode="after")
    @classmethod
    def _ensure_audio(cls, v: SessionConfig) -> SessionConfig:
        """``session.audio.input`` / ``.output`` are never None."""
        if v.audio is None:
            v.audio = AudioConfig()
        if v.audio.input is None:
            v.audio.input = AudioInputConfig()
        if v.audio.output is None:
            v.audio.output = AudioOutputConfig()
        return v

    @property
    def interrupt_response_enabled(self) -> bool:
        """Whether barge-in cancels an active response (OpenAI default True)."""
        assert self.session.audio is not None and self.session.audio.input is not None
        td = self.session.audio.input.turn_detection
        if td is None:
            return True
        val = getattr(td, "interrupt_response", None) if not isinstance(td, dict) else td.get(
            "interrupt_response", True
        )
        return True if val is None else bool(val)

    def apply_session_update(self, update: SessionConfig) -> None:
        merge_models(self.session, update)
