"""Pipeline unit + per-client session state (reference
``api/openai_realtime/pipeline_unit.py``)."""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from queue import Queue
from threading import Event
from typing import Any, Optional

from s2s_tpu_torch.pipeline.control import CancelScope
from s2s_tpu_torch.realtime.service import RealtimeService


@dataclass
class SessionState:
    """Per-client ephemeral state; lifecycle == the client connection.

    ``drained`` is set by the send loop when SESSION_END makes it through the
    handler chain back to the output queue; the release path awaits it before
    clearing ``PipelineUnit.session`` so a new client can't claim a unit with
    in-flight work from the previous session.
    """

    transport: Optional[Any] = None
    session_id: str = ""
    pending_output_item: Any = None
    drained: asyncio.Event = field(default_factory=asyncio.Event)
    released_at: Optional[float] = None  # client gone; draining
    quarantined_at: Optional[float] = None  # drain timed out; unit stuck


@dataclass
class PipelineUnit:
    """One isolated realtime pipeline: queues + events + service + handlers.

    NOTE (TPU design): unlike the reference, handlers across units share ONE
    set of model weights (the registry caches jitted models); the unit only
    isolates per-session state.
    """

    index: int
    service: RealtimeService
    cancel_scope: CancelScope
    should_listen: Event
    response_playing: Event
    input_queue: Queue
    output_queue: Queue
    text_output_queue: Queue
    text_prompt_queue: Queue
    handlers: list[Any] = field(default_factory=list)
    session: Optional[SessionState] = None
