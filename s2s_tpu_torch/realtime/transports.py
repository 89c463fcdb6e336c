"""Session transports (reference ``api/openai_realtime/transports.py``),
built on the ``websockets`` library (this build has no FastAPI/Starlette)."""

from __future__ import annotations

import json
import logging
from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from s2s_tpu_torch.realtime.service import RealtimeService

logger = logging.getLogger(__name__)

ServerEvent = dict[str, Any]


class SessionTransport(ABC):
    kind: str

    @abstractmethod
    async def send_events(self, events: list[ServerEvent]) -> None: ...

    @abstractmethod
    async def send_audio_chunk(self, service: "RealtimeService", session_id: str, pcm: bytes) -> None:
        """Deliver a pipeline-rate PCM16 chunk."""

    @abstractmethod
    def discard_pending_audio(self) -> None:
        """Drop transport-buffered unplayed audio (no-op over WebSocket:
        unplayed audio sits client-side)."""

    @abstractmethod
    async def close(self) -> None: ...


async def send_ws_event(ws, event: ServerEvent) -> None:
    """Best-effort send; tolerate a socket closing mid-shutdown."""
    try:
        await ws.send(json.dumps(event))
    except Exception as exc:  # noqa: BLE001
        logger.debug("Skipped event: ws send failed (%s)", exc)


class WebSocketTransport(SessionTransport):
    """JSON frames; audio as base64 delta events."""

    kind = "websocket"

    def __init__(self, websocket) -> None:
        self.websocket = websocket

    async def send_events(self, events: list[ServerEvent]) -> None:
        for event in events:
            await send_ws_event(self.websocket, event)

    async def send_audio_chunk(self, service, session_id: str, pcm: bytes) -> None:
        await self.send_events(service.encode_audio_chunk(session_id, pcm))

    def discard_pending_audio(self) -> None:
        pass

    async def close(self) -> None:
        try:
            await self.websocket.close()
        except Exception:  # noqa: BLE001
            pass
