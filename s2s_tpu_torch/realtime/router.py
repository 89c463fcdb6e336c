"""WebSocket router + per-unit async send loops + session pool.

Parity with reference ``api/openai_realtime/websocket_router.py`` on the
``websockets`` library: unit claim/release with SESSION_END drain +
quarantine, the send loop (text events first, barge-in cancellation with
surgical queue flushes, generation-discard filtering, <=6400 B audio
batching, AUDIO_RESPONSE_DONE -> finish_response + re-listen), and the
``/v1/usage`` / ``/v1/pool`` HTTP endpoints via the WS process_request hook.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from queue import Empty, Queue
from typing import Any, Callable, Optional

import numpy as np

from s2s_tpu_torch.pipeline.control import SESSION_END, PipelineControl, is_control
from s2s_tpu_torch.pipeline.events import (
    AssistantTextEvent,
    AudioInputCompletedEvent,
    PartialTranscriptionEvent,
    PipelineEvent,
    SpeechStartedEvent,
    SpeechStoppedEvent,
    TokenUsageEvent,
    TranscriptionCompletedEvent,
)
from s2s_tpu_torch.pipeline.log_context import pipeline_log_ctx
from s2s_tpu_torch.pipeline.messages import AUDIO_RESPONSE_DONE, PIPELINE_END, AudioOutput
from s2s_tpu_torch.realtime.pipeline_unit import PipelineUnit, SessionState
from s2s_tpu_torch.realtime.transports import SessionTransport, WebSocketTransport, send_ws_event

logger = logging.getLogger(__name__)

MAX_AUDIO_BATCH_BYTES = 6400
SESSION_END_DRAIN_TIMEOUT_S = 10.0
SESSION_END_QUARANTINE_TIMEOUT_S = 180.0


# ── queue helpers ────────────────────────────────────────────────────


def _keep_audio_sentinel(item: Any) -> bool:
    # SESSION_END must survive barge-in flushes; dropping it wedges release.
    return _is_audio_done(item) or is_control(item, SESSION_END.kind)


def _keep_user_text_event(item: Any) -> bool:
    return isinstance(
        item,
        (
            SpeechStoppedEvent,
            PartialTranscriptionEvent,
            TranscriptionCompletedEvent,
            AudioInputCompletedEvent,
            TokenUsageEvent,
        ),
    )


def _audio_payload(item: Any) -> Any:
    return item.audio if isinstance(item, AudioOutput) else item


def _audio_generation(item: Any) -> int | None:
    return item.cancel_generation if isinstance(item, AudioOutput) else None


def flush_queue(q: Queue, *, preserve: Callable[[Any], bool] | None = None) -> None:
    """Drain *q*; preserved items go back to the FRONT (under the mutex)."""
    preserved: list[Any] = []
    while True:
        try:
            item = q.get_nowait()
            if preserve and preserve(item):
                preserved.append(item)
        except Empty:
            break
    if preserved:
        with q.mutex:
            for item in reversed(preserved):
                q.queue.appendleft(item)
            q.not_empty.notify(len(preserved))


def clean_unit(unit: PipelineUnit, preserve: Callable[[Any], bool] | None = None) -> None:
    """Cancel in-flight work and flush all four queues so a released session's
    pending work can't leak into the next claim."""
    unit.cancel_scope.cancel()
    flush_queue(unit.input_queue)
    flush_queue(unit.text_prompt_queue)
    flush_queue(unit.output_queue, preserve=preserve)
    flush_queue(unit.text_output_queue, preserve=preserve)
    unit.response_playing.clear()
    unit.cancel_scope.reset()
    unit.should_listen.set()


def _to_audio_bytes(chunk: Any) -> bytes:
    chunk = _audio_payload(chunk)
    if isinstance(chunk, PipelineControl):
        raise TypeError(f"unexpected control message on audio queue: {chunk!r}")
    if isinstance(chunk, np.ndarray) or hasattr(chunk, "tobytes"):
        return chunk.tobytes()
    return chunk


def _is_audio_done(item: Any) -> bool:
    payload = _audio_payload(item)
    return isinstance(payload, bytes) and payload == AUDIO_RESPONSE_DONE


def _is_pipeline_end(item: Any) -> bool:
    payload = _audio_payload(item)
    return isinstance(payload, bytes) and payload == PIPELINE_END


def generation_is_discardable(unit: PipelineUnit, generation: int | None) -> bool:
    """Superseded generation, or post-cancel discard window and not the live
    generation (shared rule for audio AND assistant text)."""
    if generation is not None and unit.cancel_scope.is_stale(generation):
        return True
    return unit.cancel_scope.discarding and generation != unit.cancel_scope.generation


def _should_discard_audio(unit: PipelineUnit, item: Any) -> bool:
    return generation_is_discardable(unit, _audio_generation(item))


# ── release / drain ──────────────────────────────────────────────────


def _safe_unregister(unit: PipelineUnit, session_id: str) -> None:
    try:
        unit.service.unregister(session_id)
    except Exception:
        logger.exception("Pipeline %d: unregister failed for %s", unit.index, session_id)


async def _release_unit_after_drain(unit: PipelineUnit, session: SessionState, session_id: str) -> None:
    """Wait for SESSION_END to propagate, then release; quarantine a unit
    whose chain never drains (cross-session leak protection)."""
    elapsed = 0.0
    warned = False
    try:
        while not session.drained.is_set():
            await asyncio.sleep(0.05)
            elapsed += 0.05
            if not warned and elapsed >= SESSION_END_DRAIN_TIMEOUT_S:
                logger.warning(
                    "Pipeline %d: SESSION_END not drained after %.1fs (session %s)",
                    unit.index, elapsed, session_id,
                )
                warned = True
            if session.quarantined_at is None and elapsed >= SESSION_END_QUARANTINE_TIMEOUT_S:
                session.quarantined_at = time.monotonic()
                _safe_unregister(unit, session_id)
                logger.error(
                    "Pipeline %d: quarantined until the handler chain drains (session %s)",
                    unit.index, session_id,
                )
    finally:
        try:
            _safe_unregister(unit, session_id)
        finally:
            unit.session = None
        logger.info("Pipeline %d released (session %s ended)", unit.index, session_id)


_release_tasks: set[asyncio.Task] = set()


def release_session(unit: PipelineUnit, session_id: str) -> None:
    """Begin releasing a unit after disconnect: mark released, clean queues,
    enqueue a session-tagged SESSION_END, spawn the drain-and-release task."""
    old = unit.session
    if old is None:
        return
    old.released_at = time.monotonic()
    clean_unit(unit)
    unit.input_queue.put(PipelineControl(SESSION_END.kind, session_id=session_id))
    task = asyncio.get_event_loop().create_task(_release_unit_after_drain(unit, old, session_id))
    _release_tasks.add(task)
    task.add_done_callback(_release_tasks.discard)


# ── client event dispatch ────────────────────────────────────────────


async def dispatch_client_event(
    unit: PipelineUnit,
    session_id: str,
    raw: dict[str, Any],
    transport: SessionTransport,
    *,
    transport_kind: str = "websocket",
) -> None:
    service = unit.service
    event = service.parse_client_event(raw)
    if event is None:
        await transport.send_events(
            [service.make_error(f"Unknown or invalid event: {raw.get('type')}", "unknown_or_invalid_event")]
        )
        return
    etype = event["type"]

    if etype == "input_audio_buffer.append":
        if transport_kind == "webrtc":
            await transport.send_events(
                [
                    service.make_error(
                        "In WebRTC mode audio arrives via the media track; "
                        "input_audio_buffer.append is not supported.",
                        "invalid_event_for_transport",
                    )
                ]
            )
            return
        chunks = service.handle_audio_append(session_id, event.get("audio", ""))
        rt_cfg = service._state(session_id).runtime_config
        for chunk in chunks:
            unit.input_queue.put((chunk, rt_cfg))

    elif etype == "input_audio_buffer.commit":
        err = service.handle_audio_commit(session_id)
        if err:
            await transport.send_events([err])

    elif etype == "output_audio_buffer.clear":
        if transport_kind != "webrtc":
            await transport.send_events(
                [
                    service.make_error(
                        "output_audio_buffer.clear is only supported on the WebRTC transport.",
                        "invalid_event_for_transport",
                    )
                ]
            )
            return
        flush_queue(unit.output_queue, preserve=_keep_audio_sentinel)
        transport.discard_pending_audio()

    elif etype == "session.update":
        err = service.handle_session_update(session_id, event.get("session"))
        if err:
            await transport.send_events([err])
        else:
            await transport.send_events([service.build_session_updated(session_id)])

    elif etype == "conversation.item.create":
        events = service.handle_conversation_item_create(session_id, event.get("item") or {})
        if events:
            await transport.send_events(events)

    elif etype == "response.create":
        result = service.handle_response_create(session_id, event.get("response"))
        if result:
            if result.get("type") != "error":
                unit.cancel_scope.new_response()
            await transport.send_events([result])

    elif etype == "response.cancel":
        if service._state(session_id).rsp.active:
            unit.cancel_scope.cancel()
        flush_queue(unit.output_queue, preserve=_keep_audio_sentinel)
        flush_queue(unit.text_output_queue, preserve=_keep_user_text_event)
        transport.discard_pending_audio()
        events = service.handle_response_cancel(session_id)
        if events:
            await transport.send_events(events)
        unit.response_playing.clear()


# ── send loop ────────────────────────────────────────────────────────


async def _drain_pending_response_events(
    transport: SessionTransport | None, unit: PipelineUnit, session_id: str | None
) -> None:
    """Before finishing a response: flush queued usage (whole queue) and
    assistant events (up to the first non-response boundary)."""
    if session_id is None:
        return
    preserved: list[Any] = []
    drain_assistant = True
    try:
        while True:
            try:
                item = unit.text_output_queue.get_nowait()
            except Empty:
                break
            if isinstance(item, TokenUsageEvent):
                unit.service.dispatch_pipeline_event(session_id, item)
            elif drain_assistant and isinstance(item, AssistantTextEvent):
                if generation_is_discardable(unit, item.cancel_generation):
                    continue
                events = unit.service.dispatch_pipeline_event(session_id, item)
                if transport is not None and events:
                    await transport.send_events(events)
            else:
                preserved.append(item)
                drain_assistant = False
    finally:
        if preserved:
            with unit.text_output_queue.mutex:
                for item in reversed(preserved):
                    unit.text_output_queue.queue.appendleft(item)
                unit.text_output_queue.not_empty.notify(len(preserved))


async def send_loop_for(unit: PipelineUnit, stop_event) -> None:
    """Per-unit send loop: text events first, then audio with batching."""
    pipeline_log_ctx.set(f"[pipeline {unit.index}]")
    while not stop_event.is_set():
        try:
            session = unit.session
            transport = session.transport if session is not None else None
            session_id = session.session_id if session is not None else None

            # ── text events (speech_started cancels active response) ──
            try:
                text_msg = unit.text_output_queue.get_nowait()
                is_speech_start = isinstance(text_msg, SpeechStartedEvent)
                was_in_response = was_pending = False
                if is_speech_start and session_id:
                    st = unit.service._state(session_id)
                    was_in_response, was_pending = st.rsp.active, st.rsp.pending

                if isinstance(text_msg, AssistantTextEvent) and generation_is_discardable(
                    unit, text_msg.cancel_generation
                ):
                    pass
                elif transport is not None and isinstance(text_msg, PipelineEvent) and session_id:
                    # Non-blocking dispatch: a reopen-grace gate must not stall
                    # the shared event loop (all units' send loops live on it).
                    # None => the event is deferred; requeue at the FRONT and
                    # retry next iteration.
                    events = unit.service.try_dispatch_pipeline_event(session_id, text_msg)
                    if events is None:
                        with unit.text_output_queue.mutex:
                            unit.text_output_queue.queue.appendleft(text_msg)
                            unit.text_output_queue.not_empty.notify()
                    elif events:
                        await transport.send_events(events)

                if is_speech_start and session_id:
                    cfg = unit.service._state(session_id).runtime_config
                    interrupt = text_msg.interrupt_response and (
                        cfg is None or cfg.interrupt_response_enabled
                    )
                    if interrupt and transport is not None:
                        transport.discard_pending_audio()
                    if was_in_response or was_pending:
                        if interrupt:
                            unit.cancel_scope.cancel()
                            unit.service._state(session_id).rsp.pending = False
                            flush_queue(unit.output_queue, preserve=_keep_audio_sentinel)
                            flush_queue(unit.text_output_queue, preserve=_keep_user_text_event)
                            unit.response_playing.clear()
                            logger.info("Pipeline %d: barge-in, response cancelled", unit.index)
                        else:
                            logger.info("Pipeline %d: barge-in ignored (interrupts disabled)", unit.index)
            except Empty:
                pass

            # ── audio path ──
            try:
                if session is not None and session.pending_output_item is not None:
                    audio_chunk = session.pending_output_item
                    session.pending_output_item = None
                else:
                    audio_chunk = unit.output_queue.get_nowait()

                if _is_pipeline_end(audio_chunk):
                    await _drain_pending_response_events(transport, unit, session_id)
                    if transport is not None and session_id:
                        await transport.send_events(unit.service.finish_response(session_id))
                    break

                if _is_audio_done(audio_chunk):
                    gen = _audio_generation(audio_chunk)
                    if gen is not None and unit.cancel_scope.is_stale(gen):
                        if session_id:
                            unit.service._state(session_id).rsp.pending = False
                        unit.cancel_scope.response_done(gen)
                        unit.should_listen.set()
                        logger.info("Pipeline %d: stale response complete, re-listening", unit.index)
                        continue
                    await _drain_pending_response_events(transport, unit, session_id)
                    if transport is not None and session_id:
                        await transport.send_events(unit.service.finish_response(session_id))
                    if session_id:
                        unit.service._state(session_id).rsp.pending = False
                    unit.response_playing.clear()
                    unit.cancel_scope.response_done(gen)
                    unit.should_listen.set()
                    logger.info("Pipeline %d: response complete, re-listening", unit.index)
                    continue

                if is_control(audio_chunk, SESSION_END.kind):
                    # Chain fully reset; a tag from another session (force
                    # release) must not satisfy this session's drain.
                    chunk_sid = getattr(audio_chunk, "session_id", None)
                    if session is not None and chunk_sid in (None, session.session_id):
                        session.drained.set()
                    continue
                if is_control(audio_chunk):
                    continue
                if _should_discard_audio(unit, audio_chunk):
                    continue

                audio_bytes = _to_audio_bytes(audio_chunk)
                batch = bytearray(audio_bytes)
                while len(batch) < MAX_AUDIO_BATCH_BYTES:
                    try:
                        nxt = unit.output_queue.get_nowait()
                    except Empty:
                        break
                    if _is_pipeline_end(nxt) or _is_audio_done(nxt) or is_control(nxt, SESSION_END.kind):
                        if session is not None:
                            session.pending_output_item = nxt
                        break
                    if _should_discard_audio(unit, nxt):
                        continue
                    nxt_bytes = _to_audio_bytes(nxt)
                    if len(batch) + len(nxt_bytes) > MAX_AUDIO_BATCH_BYTES:
                        if session is not None:
                            session.pending_output_item = nxt
                        break
                    batch.extend(nxt_bytes)

                if not unit.response_playing.is_set():
                    unit.response_playing.set()
                    unit.should_listen.set()

                if transport is not None and session_id:
                    await transport.send_audio_chunk(unit.service, session_id, bytes(batch))
            except Empty:
                pass

            await asyncio.sleep(0.01)
        except asyncio.CancelledError:
            break
        except Exception as exc:  # noqa: BLE001
            logger.error("Pipeline %d send loop error: %s", unit.index, exc)
            await asyncio.sleep(0.1)


# ── HTTP endpoints + WS route ────────────────────────────────────────


def usage_payload(pool: list[PipelineUnit], llm_proxy_usage=None) -> dict[str, Any]:
    """Deep-merged usage across the pool (numeric leaves summed)."""

    def merge(into: dict[str, Any], src: dict[str, Any]) -> None:
        for k, v in src.items():
            if isinstance(v, (int, float)):
                into[k] = into.get(k, 0) + v
            elif isinstance(v, dict):
                sub = into.setdefault(k, {})
                if isinstance(sub, dict):
                    merge(sub, v)
            else:
                into.setdefault(k, v)

    total: dict[str, Any] = {}
    for unit in pool:
        merge(total, unit.service.get_usage())
    if llm_proxy_usage is not None:
        total["llm_proxy"] = llm_proxy_usage.model_dump()
    return total


def pool_payload(pool: list[PipelineUnit]) -> dict[str, Any]:
    now = time.monotonic()

    def state(u: PipelineUnit) -> dict[str, Any]:
        s = u.session
        if s is None:
            return {"index": u.index, "state": "idle", "session_id": None}
        if s.released_at is None:
            return {"index": u.index, "state": "active", "session_id": s.session_id}
        if s.quarantined_at is not None:
            return {
                "index": u.index,
                "state": "stuck",
                "session_id": s.session_id,
                "draining_for_s": round(now - s.released_at, 2),
                "stuck_for_s": round(now - s.quarantined_at, 2),
            }
        return {
            "index": u.index,
            "state": "draining",
            "session_id": s.session_id,
            "draining_for_s": round(now - s.released_at, 2),
        }

    return {
        "size": len(pool),
        "in_use": sum(1 for u in pool if u.session is not None),
        "units": [state(u) for u in pool],
    }


def claim_unit(pool: list[PipelineUnit], transport: SessionTransport | None) -> Optional[PipelineUnit]:
    """Reserve the first idle unit (atomic between asyncio yield points)."""
    for unit in pool:
        if unit.session is None:
            unit.session = SessionState(transport=transport)
            return unit
    return None


async def ws_session(ws, unit: PipelineUnit, stop_event) -> None:
    """Serve one claimed WebSocket session until disconnect/stop."""
    transport = unit.session.transport
    assert isinstance(transport, WebSocketTransport)
    pipeline_log_ctx.set(f"[pipeline {unit.index}]")
    session_id = ""
    try:
        session_id = unit.service.register()
        unit.session.session_id = session_id
        logger.info("Client connected to pipeline %d (session %s)", unit.index, session_id)
        clean_unit(unit)  # defensive: stale leftovers from a prior session
        await send_ws_event(ws, unit.service.build_session_created(session_id))

        while not stop_event.is_set():
            try:
                raw_msg = await asyncio.wait_for(ws.recv(), timeout=0.1)
            except asyncio.TimeoutError:
                continue
            try:
                raw = json.loads(raw_msg)
            except (TypeError, json.JSONDecodeError):
                await transport.send_events(
                    [unit.service.make_error("Malformed JSON frame", "invalid_json")]
                )
                continue
            await dispatch_client_event(unit, session_id, raw, transport)
    except Exception as exc:  # includes ConnectionClosed
        logger.info("Client %s on pipeline %d closed: %s", session_id, unit.index, type(exc).__name__)
    finally:
        release_session(unit, session_id)
