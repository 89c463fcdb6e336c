"""Realtime protocol service: translates between client events, pipeline
events, and OpenAI-Realtime server events.

Keeps protocol semantics of reference ``api/openai_realtime/service.py``
(per-connection state, staleness-gated pipeline dispatch with a non-blocking
variant for the send loop, the STT -> LLM bridge with revision-aware chat
edits, direct-audio bridge, usage rollup) in this repo's own structure:

- connection state is a plain dataclass composed of three sub-contexts —
  ``ResponseCtx`` (output lifecycle), ``InputCtx`` (mic buffer), ``SpecCtx``
  (speculative-turn bookkeeping) — instead of one flat record;
- all turn-staleness decisions live in :class:`TurnGate`, which resolves
  every pipeline event to ``fresh`` / ``stale`` / ``defer``;
- usage counters are one dataclass shared by the response, connection, and
  global rollup levels.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from queue import Queue
from threading import Event as ThreadingEvent
from typing import Any, Callable, Optional

from s2s_tpu_torch.llm.chat import Chat, make_user_message
from s2s_tpu_torch.pipeline.events import (
    AssistantTextEvent,
    AudioInputCompletedEvent,
    PartialTranscriptionEvent,
    PipelineEvent,
    ResponseFailedEvent,
    SpeechStartedEvent,
    SpeechStoppedEvent,
    TokenUsageEvent,
    TranscriptionCompletedEvent,
)
from s2s_tpu_torch.pipeline.messages import GenerateResponseRequest, SpeculativeGenerateRequest
from s2s_tpu_torch.pipeline.turns import SpeculativeTurnTracker
from s2s_tpu_torch.realtime.config import RuntimeConfig
from s2s_tpu_torch.realtime.handlers import (
    AudioHandler,
    ConversationHandler,
    ResponseHandler,
    ServerEvent,
    SessionHandler,
)
from s2s_tpu_torch.realtime.types import (
    ConversationItem,
    FunctionCallItem,
    ResponseCreateParams,
    SessionConfig,
    generate_id,
    parse_item,
)

logger = logging.getLogger(__name__)

PIPELINE_SAMPLE_RATE = 16_000
CHUNK_SAMPLES = 512
CHUNK_SIZE_BYTES = CHUNK_SAMPLES * 2

#: Client event types this server accepts (everything else is warned+dropped).
CLIENT_EVENT_TYPES = frozenset({
    "input_audio_buffer.append", "input_audio_buffer.commit",
    "output_audio_buffer.clear", "session.update",
    "conversation.item.create", "response.create", "response.cancel",
})

_USAGE_FIELDS = (
    "input_tokens", "output_tokens", "audio_duration_s",
    "responses_completed", "responses_cancelled", "tool_calls", "turns",
)


@dataclass
class Usage:
    """Flat usage counters; one instance per response/connection/global."""

    input_tokens: int = 0
    output_tokens: int = 0
    audio_duration_s: float = 0.0
    responses_completed: int = 0
    responses_cancelled: int = 0
    tool_calls: int = 0
    turns: int = 0

    def merge(self, other: "Usage") -> None:
        for name in _USAGE_FIELDS:
            setattr(self, name, getattr(self, name) + getattr(other, name))

    def reset(self) -> None:
        fresh = Usage()
        for name in _USAGE_FIELDS:
            setattr(self, name, getattr(fresh, name))

    def snapshot(self) -> dict[str, Any]:
        return {name: getattr(self, name) for name in _USAGE_FIELDS}


@dataclass
class GlobalUsage(Usage):
    """Server-wide rollup: connection count + error taxonomy on top."""

    connections: int = 0
    errors_by_type: dict[str, int] = field(default_factory=dict)

    def record_error(self, error_type: str) -> None:
        self.errors_by_type[error_type] = self.errors_by_type.get(error_type, 0) + 1

    @property
    def total_errors(self) -> int:
        return sum(self.errors_by_type.values())

    def snapshot(self) -> dict[str, Any]:
        data = super().snapshot()
        data["connections"] = self.connections
        data["errors_by_type"] = dict(self.errors_by_type)
        return data


# Back-compat aliases (tests and older call sites).
UsageMetrics = Usage
GlobalUsageMetrics = GlobalUsage


@dataclass
class ResponseCtx:
    """Lifecycle of the response currently being produced (if any)."""

    active: bool = False  # a response is open on the wire
    pending: bool = False  # LLM asked to generate, nothing on the wire yet
    id: Optional[str] = None
    item_id: Optional[str] = None
    content_index: int = 0
    params: ResponseCreateParams | None = None
    text_parts: list[str] = field(default_factory=list)
    assistant_item_id: Optional[str] = None
    assistant_output_index: Optional[int] = None
    tool_calls: list[FunctionCallItem] = field(default_factory=list)


@dataclass
class InputCtx:
    """Mic-side input buffer bookkeeping."""

    has_data: bool = False
    remainder: bytes = b""
    content_index: int = 0
    duration_s: float = 0.0


@dataclass
class SpecCtx:
    """Speculative-turn bookkeeping: which turn/revision the connection is
    currently attributing input and output to, and what it may need to roll
    back (user chat item, double-counted audio seconds) on a reopen."""

    turn_id: Optional[str] = None
    revision: Optional[int] = None
    user_turn_id: Optional[str] = None
    user_revision: Optional[int] = None
    stopped_at_s: Optional[float] = None
    user_item_id: Optional[str] = None
    input_item_id: Optional[str] = None
    audio_s: float = 0.0


@dataclass
class ConnState:
    """Per-connection protocol state (composed sub-contexts)."""

    runtime_config: RuntimeConfig
    session_id: str = field(default_factory=lambda: generate_id("session"))
    conversation_id: str = field(default_factory=lambda: generate_id("conv"))
    rsp: ResponseCtx = field(default_factory=ResponseCtx)
    mic: InputCtx = field(default_factory=InputCtx)
    spec: SpecCtx = field(default_factory=SpecCtx)
    usage: Usage = field(default_factory=Usage)
    last_item_id: Optional[str] = None
    # conversation.item.create arrivals buffered during a response (applying
    # mid-generation races the LLM write-back thread); flushed at close.
    deferred_items: list[ConversationItem] = field(default_factory=list)


class TurnGate:
    """All staleness decisions for pipeline events, in one place.

    Resolution values: ``"fresh"`` (dispatch), ``"stale"`` (drop),
    ``"defer"`` (non-blocking caller should requeue until the pending
    reopen window resolves).
    """

    #: events gated on plain turn latestness
    INPUT_EVENTS = (PartialTranscriptionEvent, TranscriptionCompletedEvent,
                    AudioInputCompletedEvent)
    #: events additionally held back through reopen grace
    OUTPUT_EVENTS = (AssistantTextEvent, TokenUsageEvent)

    def __init__(self, tracker: SpeculativeTurnTracker | None) -> None:
        self._tracker = tracker

    @staticmethod
    def _turn_of(event: PipelineEvent) -> tuple[Any, Any]:
        return getattr(event, "turn_id", None), getattr(event, "turn_revision", None)

    def resolve(self, event: PipelineEvent, *, block: bool) -> str:
        if self._tracker is None:
            return "fresh"
        turn, rev = self._turn_of(event)
        if isinstance(event, self.OUTPUT_EVENTS):
            if block:
                latest: bool | None = self._tracker.is_latest_after_reopen_grace(turn, rev)
            else:
                latest = self._tracker.try_is_latest_after_reopen_grace(turn, rev)
            if latest is None:
                return "defer"
            return "fresh" if latest else "stale"
        if isinstance(event, self.INPUT_EVENTS):
            return "fresh" if self._tracker.is_latest(turn, rev) else "stale"
        return "fresh"

    def note(self, event: PipelineEvent) -> None:
        if self._tracker is not None:
            self._tracker.observe(*self._turn_of(event))

    def would_defer(self, event: PipelineEvent) -> bool:
        if self._tracker is None or not isinstance(event, self.OUTPUT_EVENTS):
            return False
        return self._tracker.has_pending_reopen_or_grace(*self._turn_of(event))

    def is_latest(self, turn_id, revision) -> bool:
        return self._tracker is None or self._tracker.is_latest(turn_id, revision)


class RealtimeService:
    """One per PipelineUnit; serves whichever connection claims the unit."""

    def __init__(
        self,
        text_prompt_queue: "Queue[Any] | None" = None,
        should_listen: ThreadingEvent | None = None,
        chat_size: int = 10,
        speculative_turns: SpeculativeTurnTracker | None = None,
        default_instructions: str | None = None,
        speculative_prefill: bool = False,
    ) -> None:
        self.text_prompt_queue = text_prompt_queue
        self.should_listen = should_listen
        self.speculative_turns = speculative_turns
        #: forward progressive transcripts to the LLM so generation starts
        #: before the STT final (local-JAX batched backend only; wired by
        #: the builder from the backend's capability)
        self.speculative_prefill = speculative_prefill
        self.total_usage = GlobalUsage()
        self._chat_size = chat_size
        self._default_instructions = default_instructions
        self._conns: dict[str, ConnState] = {}
        self._gate = TurnGate(speculative_turns)

        # domain handlers own the wire-shape construction; the flat aliases
        # below keep router/tests call sites one hop away
        self.audio = AudioHandler(self)
        self.session = SessionHandler(self)
        self.response = ResponseHandler(self)
        self.conversation = ConversationHandler(self)
        self.build_session_created = self.session.build_session_created
        self.build_session_updated = self.session.build_session_updated
        self.handle_session_update = self.session.handle_session_update
        self.handle_audio_append = self.audio.handle_audio_append
        self.append_pcm = self.audio.append_pcm
        self.handle_audio_commit = self.audio.handle_audio_commit
        self.begin_audio_response = self.audio.begin_audio_response
        self.begin_audio_output = self.audio.begin_audio_output
        self.encode_audio_chunk = self.audio.encode_audio_chunk
        self.handle_response_create = self.response.handle_response_create
        self.handle_response_cancel = self.response.handle_response_cancel
        self.finish_response = self.response.finish_response

        # pipeline-event routing; AssistantTextEvent takes a special path
        # because the blocking/non-blocking distinction reaches into it
        self._routes: dict[type, Callable[[str, Any], list[ServerEvent]]] = {
            SpeechStartedEvent: lambda cid, ev: self.audio.on_speech_started(cid, ev),
            SpeechStoppedEvent: lambda cid, ev: self.audio.on_speech_stopped(cid, ev),
            PartialTranscriptionEvent: self._on_partial_transcription,
            TranscriptionCompletedEvent: self._bridge_transcription,
            AudioInputCompletedEvent: self._bridge_direct_audio,
            TokenUsageEvent: self._count_tokens,
            ResponseFailedEvent: self._close_failed_response,
        }

    # ── connection lifecycle ─────────────────────────────────────────

    def register(self) -> str:
        if self.speculative_turns:
            self.speculative_turns.reset()
        chat = Chat(self._chat_size)
        session = SessionConfig(type="realtime", instructions=self._default_instructions)
        st = ConnState(runtime_config=RuntimeConfig(chat=chat, session=session))
        self._conns[st.session_id] = st
        self.total_usage.connections += 1
        return st.session_id

    def unregister(self, conn_id: str) -> None:
        st = self._conns.pop(conn_id, None)
        if st is None:
            return
        # Void in-flight compaction so a daemon worker can't mutate a closed
        # session's chat (or bill LLM calls for it).
        st.runtime_config.chat.close()
        self.total_usage.merge(st.usage)
        logger.info("Session %s unregistered", conn_id)

    def _state(self, conn_id: str) -> ConnState:
        return self._conns[conn_id]

    @property
    def connection_ids(self) -> list[str]:
        return list(self._conns)

    # ── client events ────────────────────────────────────────────────

    def parse_client_event(self, raw: dict[str, Any]) -> Optional[dict[str, Any]]:
        kind = raw.get("type")
        if not isinstance(kind, str):
            logger.warning("Client event missing 'type'")
            return None
        if kind not in CLIENT_EVENT_TYPES:
            logger.warning("Unknown client event type: %s", kind)
            return None
        return raw

    def handle_conversation_item_create(
        self, conn_id: str, item_raw: dict[str, Any]
    ) -> list[ServerEvent]:
        return self.conversation.handle_conversation_item_create(conn_id, parse_item(item_raw))

    # ── pipeline event dispatch ──────────────────────────────────────

    def dispatch_pipeline_event(self, conn_id: str, event: PipelineEvent) -> list[ServerEvent]:
        return self._route(conn_id, event, block=True) or []

    def try_dispatch_pipeline_event(
        self, conn_id: str, event: PipelineEvent
    ) -> list[ServerEvent] | None:
        """Non-blocking for the send loop: ``None`` => requeue and retry
        after the pending reopen window resolves."""
        return self._route(conn_id, event, block=False)

    def should_defer_pipeline_event(self, event: PipelineEvent) -> bool:
        return self._gate.would_defer(event)

    def _route(self, conn_id: str, event: PipelineEvent, *, block: bool) -> list[ServerEvent] | None:
        verdict = self._gate.resolve(event, block=block)
        if verdict == "defer":
            return None
        if verdict == "stale":
            turn, rev = TurnGate._turn_of(event)
            logger.info("Ignoring stale %s for turn=%s rev=%s", event.type, turn, rev)
            return []
        self._gate.note(event)
        if isinstance(event, AssistantTextEvent):
            return self.response.on_assistant_text(conn_id, event, wait_for_pending_reopen=block)
        route = self._routes.get(type(event))
        if route is None:
            logger.debug("Unhandled pipeline event type: %s", type(event).__name__)
            return []
        return route(conn_id, event)

    # ── STT -> LLM bridge ────────────────────────────────────────────

    def _retract_double_counted_audio(self, st: ConnState, event) -> bool:
        """On a reopened turn the new final re-covers audio already billed;
        subtract the previous attribution.  Returns same-turn-ness."""
        same_turn = event.turn_id is not None and event.turn_id == st.spec.user_turn_id
        if same_turn:
            st.usage.audio_duration_s -= st.spec.audio_s
        else:
            st.spec.audio_s = 0.0
        return same_turn

    def _remember_user_turn(self, st: ConnState, event) -> None:
        if event.turn_id is None:
            return
        st.spec.user_turn_id = event.turn_id
        st.spec.user_revision = event.turn_revision
        st.spec.stopped_at_s = event.speech_stopped_at_s

    def _sync_user_chat(self, st: ConnState, transcript: str, same_turn: bool) -> None:
        """Write (or in-place replace, for a reopened revision of the same
        turn) the user message in the chat buffer."""
        chat = st.runtime_config.chat
        replaced = (
            same_turn
            and st.spec.user_item_id is not None
            and chat.replace_user_message_text(st.spec.user_item_id, transcript)
        )
        if not replaced:
            st.spec.user_item_id = chat.add_item(make_user_message(transcript)).id

    def _request_generation(self, st: ConnState, event, **extra: Any) -> None:
        if self.text_prompt_queue is None:
            return
        st.rsp.pending = True
        self.text_prompt_queue.put(GenerateResponseRequest(
            runtime_config=st.runtime_config,
            turn_id=event.turn_id,
            turn_revision=event.turn_revision,
            speech_stopped_at_s=event.speech_stopped_at_s,
            **extra,
        ))

    def _on_partial_transcription(
        self, conn_id: str, event: PartialTranscriptionEvent
    ) -> list[ServerEvent]:
        """Protocol delta, plus (when enabled) a speculative generate so the
        LLM starts on the progressive transcript before the STT final."""
        st = self._state(conn_id)
        if (self.speculative_prefill and self.text_prompt_queue is not None
                and event.delta and not st.rsp.active):
            self.text_prompt_queue.put(SpeculativeGenerateRequest(
                runtime_config=st.runtime_config,
                text=str(event.delta),
                turn_id=event.turn_id,
                turn_revision=event.turn_revision,
            ))
        return self.conversation.on_partial_transcription(conn_id, event)

    def _bridge_transcription(
        self, conn_id: str, event: TranscriptionCompletedEvent
    ) -> list[ServerEvent]:
        """Final transcription: protocol events, revision-aware chat write,
        then the LLM request."""
        st = self._state(conn_id)
        same_turn = self._retract_double_counted_audio(st, event)
        events = self.conversation.on_transcription_completed(conn_id, event)
        if event.turn_id is not None:
            st.spec.audio_s = st.mic.duration_s

        transcript = event.transcript
        if transcript:
            self._sync_user_chat(st, transcript, same_turn)
        elif same_turn and st.spec.user_item_id:
            st.runtime_config.chat.remove_user_message(st.spec.user_item_id)
            st.spec.user_item_id = None
        elif event.turn_id is not None and event.turn_id != st.spec.user_turn_id:
            st.spec.user_item_id = None

        self._remember_user_turn(st, event)
        if transcript:
            self._request_generation(st, event, language_code=event.language_code)
        return events

    def _bridge_direct_audio(
        self, conn_id: str, event: AudioInputCompletedEvent
    ) -> list[ServerEvent]:
        """``--stt none``: final VAD audio goes straight to the LLM."""
        st = self._state(conn_id)
        self._retract_double_counted_audio(st, event)
        st.mic.duration_s = event.audio_duration_s
        st.usage.audio_duration_s += event.audio_duration_s
        if event.turn_id is not None:
            st.spec.audio_s = event.audio_duration_s
        self._remember_user_turn(st, event)
        self._request_generation(
            st, event, audio=event.audio, audio_sample_rate=event.audio_sample_rate
        )
        return []

    # ── metrics / errors ─────────────────────────────────────────────

    def _count_tokens(self, conn_id: str, event: TokenUsageEvent) -> list[ServerEvent]:
        if not self._gate.is_latest(event.turn_id, event.turn_revision):
            return []
        usage = self._state(conn_id).usage
        usage.input_tokens += event.input_tokens
        usage.output_tokens += event.output_tokens
        return []

    def _close_failed_response(self, conn_id: str, event: ResponseFailedEvent) -> list[ServerEvent]:
        """Close the response as failed: error event (carrying the message —
        response.done.status_details has no message field) + terminal events.
        Idempotent; pending implicit responses are announced first."""
        logger.info("Response failed: %s", event.message)
        st = self._state(conn_id)
        if not (st.rsp.active or st.rsp.pending):
            return []
        events: list[ServerEvent] = []
        if st.rsp.pending:
            _, _, created = self.audio.begin_audio_response(conn_id)
            events.extend(created)
        events.append(self.make_error(event.message, "response_failed"))
        events.extend(self.response.finish_response(conn_id, status="failed"))
        return events

    def get_usage(self) -> dict[str, Any]:
        data = self.total_usage.snapshot()
        data["total_tokens"] = data["input_tokens"] + data["output_tokens"]
        data["total_errors"] = self.total_usage.total_errors
        return data

    def make_error(self, message: str, _type: str) -> ServerEvent:
        self.total_usage.record_error(_type)
        return build_error_event(message, _type)


def build_error_event(message: str, error_type: str) -> ServerEvent:
    """Error event without charging any unit's metrics (pool rejection path)."""
    return {
        "type": "error",
        "event_id": generate_id("event"),
        "error": {"type": error_type, "message": message},
    }
