"""Domain handlers for the realtime service (reference
``api/openai_realtime/handlers/``): session, audio, conversation, response.

Server events are plain dicts in the OpenAI Realtime wire shape — the
protocol surface is explicit here rather than delegated to SDK models.
"""

from __future__ import annotations

import base64
import logging
from typing import TYPE_CHECKING, Any, Optional

from s2s_tpu_torch.audio.resample import resample_pcm16
from s2s_tpu_torch.llm.chat import ChatItemError, add_supported_item
from s2s_tpu_torch.pipeline.events import (
    AssistantTextEvent,
    PartialTranscriptionEvent,
    SpeechStartedEvent,
    SpeechStoppedEvent,
    TranscriptionCompletedEvent,
)
from s2s_tpu_torch.pipeline.messages import GenerateResponseRequest
from s2s_tpu_torch.realtime.types import (
    ConversationItem,
    FunctionCallItem,
    ResponseCreateParams,
    SessionConfig,
    generate_id,
)
from s2s_tpu_torch.utils.common import is_out_of_band, response_wants_audio

if TYPE_CHECKING:
    from s2s_tpu_torch.realtime.service import ConnState, RealtimeService

logger = logging.getLogger(__name__)

PIPELINE_SAMPLE_RATE = 16_000
CHUNK_SIZE_BYTES = 512 * 2

ServerEvent = dict[str, Any]


class DomainHandler:
    def __init__(self, service: "RealtimeService") -> None:
        self._service = service

    def _state(self, conn_id: str) -> "ConnState":
        return self._service._state(conn_id)

    @staticmethod
    def _next_event_id() -> str:
        return generate_id("event")

    def make_error(self, message: str, _type: str) -> ServerEvent:
        return self._service.make_error(message, _type)

    def _input_item_id(self, conn_id: str) -> str:
        st = self._state(conn_id)
        return st.spec.input_item_id or self._service.response._current_item_id(conn_id)

    def _next_input_content_index(self, conn_id: str) -> int:
        st = self._state(conn_id)
        idx = st.mic.content_index
        st.mic.content_index += 1
        return idx


# ── session ──────────────────────────────────────────────────────────


class SessionHandler(DomainHandler):
    def handle_session_update(self, conn_id: str, session: dict[str, Any] | None) -> Optional[ServerEvent]:
        if session is None:
            return None
        if session.get("type") == "transcription":
            return self.make_error(
                "Only 'realtime' session type is supported; transcription sessions are not.",
                "invalid_session_type",
            )
        try:
            update = SessionConfig.model_validate(session)
        except Exception as exc:
            return self.make_error(f"Invalid session payload: {exc}", "invalid_session")
        cfg = self._state(conn_id).runtime_config
        cfg.apply_session_update(update)
        logger.info("Session configuration updated")
        return None

    def _session_payload(self, conn_id: str) -> dict[str, Any]:
        cfg = self._state(conn_id).runtime_config
        payload = cfg.session.model_dump(exclude_none=True)
        payload["id"] = conn_id  # GA protocol carries the session id
        return payload

    def build_session_created(self, conn_id: str) -> ServerEvent:
        return {
            "type": "session.created",
            "event_id": self._next_event_id(),
            "session": self._session_payload(conn_id),
        }

    def build_session_updated(self, conn_id: str) -> ServerEvent:
        return {
            "type": "session.updated",
            "event_id": self._next_event_id(),
            "session": self._session_payload(conn_id),
        }


# ── audio ────────────────────────────────────────────────────────────


class AudioHandler(DomainHandler):
    def _start_input_item(self, conn_id: str, *, preserve_active_response: bool = False) -> str:
        response = self._service.response
        st = self._state(conn_id)
        if not preserve_active_response:
            item_id = response._start_item(conn_id)
        else:
            saved_item, saved_index = st.rsp.item_id, st.rsp.content_index
            item_id = response._start_item(conn_id)
            st.rsp.item_id, st.rsp.content_index = saved_item, saved_index
        st.mic.content_index = 0
        return item_id

    def handle_audio_append(self, conn_id: str, audio_b64: str) -> list[bytes]:
        try:
            pcm = base64.b64decode(audio_b64)
        except Exception as exc:
            logger.error("Base64 decode error: %s", exc)
            return []
        st = self._state(conn_id)
        audio_cfg = st.runtime_config.session.audio
        rate = PIPELINE_SAMPLE_RATE
        if audio_cfg is not None and audio_cfg.input is not None and audio_cfg.input.format is not None:
            rate = getattr(audio_cfg.input.format, "rate", None) or PIPELINE_SAMPLE_RATE
        return self.append_pcm(conn_id, pcm, rate)

    def append_pcm(self, conn_id: str, pcm_bytes: bytes, src_rate: int) -> list[bytes]:
        """Resample to 16 kHz and cut into 512-sample chunks, carrying the
        remainder; shared by WS and WebRTC ingress."""
        st = self._state(conn_id)
        pcm_bytes = resample_pcm16(pcm_bytes, src_rate, PIPELINE_SAMPLE_RATE)
        pcm_bytes = st.mic.remainder + pcm_bytes
        chunks: list[bytes] = []
        for i in range(0, len(pcm_bytes), CHUNK_SIZE_BYTES):
            piece = pcm_bytes[i : i + CHUNK_SIZE_BYTES]
            if len(piece) == CHUNK_SIZE_BYTES:
                chunks.append(piece)
            else:
                st.mic.remainder = piece
                break
        else:
            st.mic.remainder = b""
        if chunks:
            st.mic.has_data = True
        return chunks

    def handle_audio_commit(self, conn_id: str) -> Optional[ServerEvent]:
        st = self._state(conn_id)
        if not st.mic.has_data:
            return self.make_error(
                "Input audio buffer is empty, nothing to commit.", "input_audio_buffer_commit_empty"
            )
        st.mic.has_data = False
        return None

    # ── pipeline events ──────────────────────────────────────────────

    def on_speech_started(self, conn_id: str, event: SpeechStartedEvent) -> list[ServerEvent]:
        """Barge-in cancellation + input item identity (reopen-aware reuse)."""
        response = self._service.response
        st = self._state(conn_id)
        events: list[ServerEvent] = []
        if st.rsp.active and event.interrupt_response and st.runtime_config.interrupt_response_enabled:
            # Terminal events must precede speech_started on the wire.
            events.extend(response.finish_response(conn_id, status="cancelled", reason="turn_detected"))
        is_reopen = bool(
            event.reopened and event.turn_id is not None and event.turn_id == st.spec.turn_id
        )
        preserve = st.rsp.active
        if is_reopen:
            input_item_id = st.spec.input_item_id
            if input_item_id is None:
                input_item_id = self._start_input_item(conn_id, preserve_active_response=preserve)
                st.spec.input_item_id = input_item_id
            elif not preserve:
                st.rsp.item_id = input_item_id
                st.rsp.content_index = 0
            st.mic.duration_s = 0.0
            st.mic.content_index = 0
        else:
            input_item_id = self._start_input_item(conn_id, preserve_active_response=preserve)
            st.spec.input_item_id = input_item_id
            st.usage.turns += 1
        st.spec.turn_id = event.turn_id
        st.spec.revision = event.turn_revision
        st.last_item_id = input_item_id
        events.append(
            {
                "type": "input_audio_buffer.speech_started",
                "event_id": self._next_event_id(),
                "audio_start_ms": event.audio_start_ms,
                "item_id": input_item_id,
            }
        )
        return events

    def on_speech_stopped(self, conn_id: str, event: SpeechStoppedEvent) -> list[ServerEvent]:
        if event.duration_s:
            self._state(conn_id).mic.duration_s = event.duration_s
        return [
            {
                "type": "input_audio_buffer.speech_stopped",
                "event_id": self._next_event_id(),
                "audio_end_ms": event.audio_end_ms,
                "item_id": self._input_item_id(conn_id),
            }
        ]

    # ── outbound audio ───────────────────────────────────────────────

    def begin_audio_response(self, conn_id: str) -> tuple[str, str, list[ServerEvent]]:
        """Implicit response.created on the first audio of a VAD-driven turn."""
        response = self._service.response
        st = self._state(conn_id)
        events: list[ServerEvent] = []
        need_created = st.rsp.id is None
        resp_id, item_id = response._ensure_response(conn_id)
        if need_created:
            events.append(
                {
                    "type": "response.created",
                    "event_id": self._next_event_id(),
                    "response": response._build_response(conn_id, "in_progress"),
                }
            )
        return resp_id, item_id, events

    def begin_audio_output(self, conn_id: str) -> tuple[str, str, int, list[ServerEvent]]:
        resp_id, item_id, events = self.begin_audio_response(conn_id)
        assistant_item_id, output_index = self._service.response._ensure_assistant_output_item(
            conn_id, item_id
        )
        return resp_id, assistant_item_id, output_index, events

    def client_output_rate(self, conn_id: str) -> int:
        st = self._state(conn_id)
        rp = st.rsp.params
        rate = None
        if rp and rp.audio and rp.audio.output and rp.audio.output.format:
            rate = getattr(rp.audio.output.format, "rate", None)
        if rate is None:
            audio_cfg = st.runtime_config.session.audio
            if audio_cfg is not None and audio_cfg.output is not None and audio_cfg.output.format is not None:
                rate = getattr(audio_cfg.output.format, "rate", None)
        return rate or PIPELINE_SAMPLE_RATE

    def encode_audio_chunk(self, conn_id: str, audio: bytes) -> list[ServerEvent]:
        response = self._service.response
        resp_id, assistant_item_id, output_index, events = self.begin_audio_output(conn_id)
        audio = resample_pcm16(audio, PIPELINE_SAMPLE_RATE, self.client_output_rate(conn_id))
        events.append(
            {
                "type": "response.output_audio.delta",
                "event_id": self._next_event_id(),
                "content_index": response._next_content_index(conn_id),
                "delta": base64.b64encode(audio).decode("ascii"),
                "item_id": assistant_item_id,
                "output_index": output_index,
                "response_id": resp_id,
            }
        )
        return events


# ── conversation ─────────────────────────────────────────────────────


class ConversationHandler(DomainHandler):
    def handle_conversation_item_create(self, conn_id: str, item: ConversationItem) -> list[ServerEvent]:
        """Inject an item into the LLM context. Deferred while a response is
        generating (applying now races the LLM write-back thread)."""
        st = self._state(conn_id)
        if st.rsp.active:
            st.deferred_items.append(item)
            return []
        return self._apply_item(conn_id, item)

    def _apply_item(self, conn_id: str, item: ConversationItem) -> list[ServerEvent]:
        try:
            add_supported_item(self._state(conn_id).runtime_config.chat, item)
        except ChatItemError as exc:
            return [self.make_error(str(exc), "invalid_conversation_item")]
        st = self._state(conn_id)
        event = {
            "type": "conversation.item.created",
            "event_id": self._next_event_id(),
            "previous_item_id": st.last_item_id,
            "item": item.model_dump(exclude_none=True),
        }
        st.last_item_id = item.id
        return [event]

    def flush_deferred_items(self, conn_id: str) -> list[ServerEvent]:
        """Apply mid-generation items in order, post write-back."""
        st = self._state(conn_id)
        if not st.deferred_items:
            return []
        items, st.deferred_items = st.deferred_items, []
        events: list[ServerEvent] = []
        for item in items:
            events.extend(self._apply_item(conn_id, item))
        return events

    # ── pipeline events ──────────────────────────────────────────────

    def on_partial_transcription(self, conn_id: str, event: PartialTranscriptionEvent) -> list[ServerEvent]:
        return [
            {
                "type": "conversation.item.input_audio_transcription.delta",
                "event_id": self._next_event_id(),
                "content_index": self._next_input_content_index(conn_id),
                "item_id": self._input_item_id(conn_id),
                "delta": event.delta,
            }
        ]

    def on_transcription_completed(self, conn_id: str, event: TranscriptionCompletedEvent) -> list[ServerEvent]:
        st = self._state(conn_id)
        st.usage.audio_duration_s += st.mic.duration_s
        return [
            {
                "type": "conversation.item.input_audio_transcription.completed",
                "event_id": self._next_event_id(),
                "content_index": 0,
                "item_id": self._input_item_id(conn_id),
                "transcript": event.transcript,
                "usage": {"type": "duration", "seconds": st.mic.duration_s},
            }
        ]


# ── response ─────────────────────────────────────────────────────────


class ResponseHandler(DomainHandler):
    # ── id/state management ──────────────────────────────────────────

    def _ensure_response(self, conn_id: str) -> tuple[str, str]:
        st = self._state(conn_id)
        if st.rsp.id is None:
            st.rsp.id = generate_id("resp")
            self._start_item(conn_id)
            st.rsp.active = True
        st.rsp.pending = False
        return st.rsp.id, self._current_item_id(conn_id)

    def _end_response(self, conn_id: str, status: str = "completed") -> None:
        st = self._state(conn_id)
        if status == "cancelled":
            st.usage.responses_cancelled += 1
        else:
            st.usage.responses_completed += 1
        self._service.total_usage.merge(st.usage)
        logger.info(
            "Response done (status=%s): input=%d output=%d audio=%.2fs",
            status, st.usage.input_tokens, st.usage.output_tokens,
            st.usage.audio_duration_s,
        )
        st.usage.reset()
        st.rsp.id = None
        st.rsp.item_id = None
        st.rsp.content_index = 0
        st.rsp.active = False
        st.rsp.pending = False
        st.rsp.params = None
        st.rsp.text_parts = []
        st.rsp.assistant_item_id = None
        st.rsp.assistant_output_index = None
        st.rsp.tool_calls = []

    def _start_item(self, conn_id: str) -> str:
        st = self._state(conn_id)
        item_id = generate_id("item")
        st.rsp.item_id = item_id
        st.rsp.content_index = 0
        st.mic.duration_s = 0.0
        return item_id

    def _current_item_id(self, conn_id: str) -> str:
        return self._state(conn_id).rsp.item_id or self._start_item(conn_id)

    def _ensure_assistant_output_item(self, conn_id: str, item_id: str) -> tuple[str, int]:
        st = self._state(conn_id)
        if st.rsp.assistant_item_id is None:
            st.rsp.assistant_item_id = item_id
            st.rsp.assistant_output_index = len(st.rsp.tool_calls)
            st.last_item_id = item_id
        assert st.rsp.assistant_output_index is not None
        return st.rsp.assistant_item_id, st.rsp.assistant_output_index

    def _next_content_index(self, conn_id: str) -> int:
        st = self._state(conn_id)
        idx = st.rsp.content_index
        st.rsp.content_index += 1
        return idx

    def _build_response(self, conn_id: str, status: str, reason: str | None = None) -> dict[str, Any]:
        st = self._state(conn_id)
        status_details = None
        if reason or status in ("completed", "cancelled", "incomplete", "failed"):
            status_details = {"type": status}
            if reason:
                status_details["reason"] = reason
        rp = st.rsp.params
        voice = None
        if rp and rp.audio and rp.audio.output and rp.audio.output.voice:
            voice = str(rp.audio.output.voice)
        if not voice:
            audio_cfg = st.runtime_config.session.audio
            out = audio_cfg.output if audio_cfg is not None else None
            voice = str(out.voice) if out is not None and out.voice else None
        return {
            "id": st.rsp.id,
            "object": "realtime.response",
            "status": status,
            "status_details": status_details,
            "audio": {"output": {"voice": voice}},
            # out-of-band responses report a null conversation id
            "conversation_id": None if is_out_of_band(rp) else st.conversation_id,
            "metadata": rp.metadata if rp and rp.metadata else None,
            "output": self._build_output_items(conn_id, status),
            "usage": {
                "input_tokens": st.usage.input_tokens,
                "output_tokens": st.usage.output_tokens,
                "total_tokens": st.usage.input_tokens + st.usage.output_tokens,
            },
        }

    def _build_output_items(self, conn_id: str, status: str) -> list[dict[str, Any]]:
        """response.done.output in streaming order: function calls, with the
        assistant message inserted at its reserved index."""
        st = self._state(conn_id)
        assistant_status = "completed" if status == "completed" else "incomplete"
        output: list[dict[str, Any]] = []
        for call in st.rsp.tool_calls:
            call_status = call.status if call.status in ("completed", "incomplete") else assistant_status
            entry = call.model_dump(exclude_none=True)
            entry.update({"object": "realtime.item", "status": call_status})
            output.append(entry)
        text = self._assistant_text(conn_id)
        if st.rsp.assistant_item_id is not None:
            if response_wants_audio(st.rsp.params):
                content = {"type": "output_audio", "transcript": text}
            else:
                content = {"type": "output_text", "text": text}
            message = {
                "type": "message",
                "role": "assistant",
                "id": st.rsp.assistant_item_id,
                "object": "realtime.item",
                "status": assistant_status,
                "content": [content],
            }
            output.insert(
                st.rsp.assistant_output_index if st.rsp.assistant_output_index is not None else 0,
                message,
            )
        return output

    def _assistant_text(self, conn_id: str) -> str:
        st = self._state(conn_id)
        if response_wants_audio(st.rsp.params):
            return " ".join(p.strip() for p in st.rsp.text_parts if p.strip())
        return "".join(st.rsp.text_parts)

    # ── public handlers ──────────────────────────────────────────────

    def handle_response_create(self, conn_id: str, response_raw: dict[str, Any] | None) -> ServerEvent | None:
        st = self._state(conn_id)
        response = ResponseCreateParams.model_validate(response_raw) if response_raw else None
        if response and response.tool_choice is not None and not isinstance(response.tool_choice, str):
            return self.make_error(
                "Only string tool_choice values are supported for now (auto, required, none).",
                "tool_choice_not_supported",
            )
        if st.rsp.active:
            return self.make_error(
                "Cannot create response while another response is in progress.",
                "conversation_already_has_active_response",
            )
        out_of_band = is_out_of_band(response)
        if not out_of_band and response and response.input:
            # In-band input items land in the default conversation history.
            from s2s_tpu_torch.realtime.types import parse_item

            for raw in response.input:
                try:
                    item = parse_item(raw) if isinstance(raw, dict) else raw
                    add_supported_item(st.runtime_config.chat, item)
                except ChatItemError as exc:
                    return self.make_error(str(exc), "invalid_input_item")

        st.rsp.active = True
        st.rsp.pending = False
        st.rsp.params = response
        st.rsp.id = generate_id("resp")
        self._start_item(conn_id)

        queue = self._service.text_prompt_queue
        if queue:
            # Out-of-band: null turn identity so staleness gates always pass.
            queue.put(
                GenerateResponseRequest(
                    runtime_config=st.runtime_config,
                    response=response,
                    turn_id=None if out_of_band else st.spec.user_turn_id,
                    turn_revision=None if out_of_band else st.spec.user_revision,
                    speech_stopped_at_s=None if out_of_band else st.spec.stopped_at_s,
                )
            )
        return {
            "type": "response.created",
            "event_id": self._next_event_id(),
            "response": self._build_response(conn_id, "in_progress"),
        }

    def handle_response_cancel(self, conn_id: str) -> list[ServerEvent]:
        events = self.finish_response(conn_id, status="cancelled", reason="client_cancelled")
        if self._service.should_listen:
            self._service.should_listen.set()
        return events

    def finish_response(
        self, conn_id: str, status: str = "completed", reason: str | None = None
    ) -> list[ServerEvent]:
        """Terminal events: audio done -> transcript done -> response.done
        (text-only: one output_text.done on completion); then deferred-item
        flush."""
        st = self._state(conn_id)
        events: list[ServerEvent] = []
        if st.rsp.active:
            resp_id, item_id = self._ensure_response(conn_id)
            assistant_item_id = st.rsp.assistant_item_id or item_id
            output_index = (
                st.rsp.assistant_output_index if st.rsp.assistant_output_index is not None else 0
            )
            function_call_only = bool(st.rsp.tool_calls) and st.rsp.assistant_item_id is None
            if response_wants_audio(st.rsp.params) and not function_call_only:
                events.append(
                    {
                        "type": "response.output_audio.done",
                        "event_id": self._next_event_id(),
                        "content_index": 0,
                        "item_id": assistant_item_id,
                        "output_index": output_index,
                        "response_id": resp_id,
                    }
                )
                if st.rsp.text_parts:
                    events.append(
                        {
                            "type": "response.output_audio_transcript.done",
                            "event_id": self._next_event_id(),
                            "content_index": 0,
                            "item_id": assistant_item_id,
                            "output_index": output_index,
                            "response_id": resp_id,
                            "transcript": self._assistant_text(conn_id),
                        }
                    )
            elif status == "completed" and st.rsp.text_parts:
                events.append(
                    {
                        "type": "response.output_text.done",
                        "event_id": self._next_event_id(),
                        "content_index": 0,
                        "item_id": assistant_item_id,
                        "output_index": output_index,
                        "response_id": resp_id,
                        "text": "".join(st.rsp.text_parts),
                    }
                )
            events.append(
                {
                    "type": "response.done",
                    "event_id": self._next_event_id(),
                    "response": self._build_response(conn_id, status, reason),
                }
            )
            self._end_response(conn_id, status)
        # Outside the in_response guard so a stray terminal call still drains.
        events.extend(self._service.conversation.flush_deferred_items(conn_id))
        return events

    # ── pipeline events ──────────────────────────────────────────────

    def on_assistant_text(
        self, conn_id: str, event: AssistantTextEvent, *, wait_for_pending_reopen: bool = True
    ) -> list[ServerEvent] | None:
        """Assistant text COMMITS the turn when it reaches the client."""
        tracker = self._service.speculative_turns
        if tracker:
            if wait_for_pending_reopen:
                commit = tracker.commit_if_latest_after_reopen_grace(event.turn_id, event.turn_revision)
            else:
                commit = tracker.try_commit_if_latest_after_reopen_grace(event.turn_id, event.turn_revision)
            if commit is None:
                return None
            if not commit:
                logger.debug("Dropping stale assistant text turn=%s rev=%s", event.turn_id, event.turn_revision)
                return []
        st = self._state(conn_id)
        events: list[ServerEvent] = []
        resp_id, item_id = self._ensure_response(conn_id)
        wants_audio = response_wants_audio(st.rsp.params)
        if event.text and (not wants_audio or event.text.strip()):
            assistant_item_id, output_index = self._ensure_assistant_output_item(conn_id, item_id)
            if wants_audio:
                part = event.text.strip()
                delta = (" " if st.rsp.text_parts else "") + part
                st.rsp.text_parts.append(part)
                events.append(
                    {
                        "type": "response.output_audio_transcript.delta",
                        "event_id": self._next_event_id(),
                        "content_index": 0,
                        "delta": delta,
                        "item_id": assistant_item_id,
                        "output_index": output_index,
                        "response_id": resp_id,
                    }
                )
            else:
                st.rsp.text_parts.append(event.text)
                events.append(
                    {
                        "type": "response.output_text.delta",
                        "event_id": self._next_event_id(),
                        "content_index": 0,
                        "item_id": assistant_item_id,
                        "output_index": output_index,
                        "response_id": resp_id,
                        "delta": event.text,
                    }
                )
        for tool in event.tools:
            st.usage.tool_calls += 1
            function_item_id = tool.id or generate_id("item")
            output_idx = len(st.rsp.tool_calls) + int(st.rsp.assistant_item_id is not None)
            events.append(
                {
                    "type": "response.function_call_arguments.done",
                    "event_id": self._next_event_id(),
                    "call_id": tool.call_id,
                    "name": tool.name,
                    "arguments": tool.arguments,
                    "item_id": function_item_id,
                    "output_index": output_idx,
                    "response_id": resp_id,
                }
            )
            st.rsp.tool_calls.append(
                FunctionCallItem(
                    id=function_item_id,
                    call_id=tool.call_id,
                    name=tool.name,
                    arguments=tool.arguments,
                    status=tool.status or "completed",
                )
            )
            st.last_item_id = function_item_id
        return events
