"""Realtime server: websockets-based WS route + HTTP endpoints, runs in a
ThreadManager thread (reference ``api/openai_realtime/server.py`` +
``websocket_router.py:create_app``)."""

from __future__ import annotations

import asyncio
import http
import json
import logging
import threading
from typing import Any, Optional

from s2s_tpu_torch.realtime.pipeline_unit import PipelineUnit
from s2s_tpu_torch.realtime.router import (
    claim_unit,
    pool_payload,
    send_loop_for,
    usage_payload,
    ws_session,
)
from s2s_tpu_torch.realtime.service import build_error_event
from s2s_tpu_torch.realtime.transports import WebSocketTransport, send_ws_event

logger = logging.getLogger(__name__)


class RealtimeServer:
    """Owns the asyncio loop: WS route ``/v1/realtime``, HTTP ``/v1/usage``
    and ``/v1/pool``, one send-loop task per pool unit.

    The MAIN port is a small asyncio front-end that routes per-request —
    the reference serves WS and ``POST /v1/realtime/calls`` on one port
    (``websocket_router.py:459,579``), and the ``websockets`` library's
    HTTP parser rejects non-GET methods outright, so the front-end reads
    each request head itself: WebSocket upgrades and GET endpoints pipe to
    an internal ``websockets`` listener, WebRTC ``POST``/``DELETE`` calls
    are answered in-process, and LLM-proxy POSTs pipe to the proxy
    listener.  The sidecar HTTP ports remain as fallbacks.

    Run via ``run()`` inside a ThreadManager thread; ``stop_event`` shuts the
    loop down.  Appended to the handler list as the final "handler".
    """

    def __init__(
        self,
        stop_event: threading.Event,
        pool: list[PipelineUnit],
        host: str = "127.0.0.1",
        port: int = 8123,
        llm_proxy=None,
        webrtc_port: Optional[int] = None,
        webrtc_rtc=None,
        webrtc_ice_servers: Optional[list[str]] = None,
    ) -> None:
        self.stop_event = stop_event
        self.pool = pool
        self.host = host
        self.port = port
        self.llm_proxy = llm_proxy
        self.started = threading.Event()
        self.bound_port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # WebRTC call endpoint (side HTTP listener: the websockets
        # process_request hook cannot read POST bodies)
        self.webrtc_port = webrtc_port
        self.webrtc_bound_port: Optional[int] = None
        self._webrtc_rtc = webrtc_rtc
        self._webrtc_ice_servers = webrtc_ice_servers
        self._webrtc_http = None
        self.call_manager = None
        #: internal websockets listener the front-end pipes WS/GET traffic to
        self._internal_port: Optional[int] = None
        self._proxy_port: Optional[int] = None

    # ── HTTP endpoints over the websockets process_request hook ──────

    def _process_request(self, connection, request):
        path = request.path.split("?")[0]
        if path == "/v1/realtime":
            return None  # continue the WS handshake
        if self.llm_proxy is not None:
            handled = self.llm_proxy.maybe_handle(connection, request)
            if handled is not None:
                return handled
        if path == "/v1/usage":
            body = json.dumps(usage_payload(self.pool, getattr(self.llm_proxy, "usage", None)))
            return connection.respond(http.HTTPStatus.OK, body + "\n")
        if path == "/v1/pool":
            return connection.respond(http.HTTPStatus.OK, json.dumps(pool_payload(self.pool)) + "\n")
        if path == "/v1/realtime/calls":
            if self.call_manager is not None:
                return connection.respond(
                    http.HTTPStatus.METHOD_NOT_ALLOWED,
                    "POST an SDP offer to /v1/realtime/calls to start a call; "
                    "DELETE /v1/realtime/calls/{id} hangs up.\n",
                )
            return connection.respond(
                http.HTTPStatus.NOT_IMPLEMENTED,
                "WebRTC transport requires aiortc (pip install 's2s-tpu[webrtc]'); use the WebSocket "
                "transport at /v1/realtime.\n",
            )
        return connection.respond(http.HTTPStatus.NOT_FOUND, "Not found\n")

    # ── main-port front-end: per-request routing ─────────────────────

    async def _front_handler(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        """Route one inbound connection by its first request head."""
        try:
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout=15)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                asyncio.TimeoutError, ConnectionError):
            writer.close()
            return
        try:
            text = head.decode("latin-1", errors="replace")
            request_line, *header_lines = text.split("\r\n")
            parts = request_line.split(" ")
            method, raw_path = (parts[0], parts[1]) if len(parts) >= 2 else ("", "")
            path = raw_path.split("?")[0]
            headers = {}
            for line in header_lines:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            if method in ("POST", "DELETE") and path.startswith("/v1/realtime/calls"):
                await self._handle_calls_inline(reader, writer, method, path, headers)
                return
            if (
                method == "POST"
                and self._proxy_port is not None
                and path in ("/v1/chat/completions", "/v1/responses")
            ):
                await self._pipe_upstream(head, reader, writer, self._proxy_port)
                return
            await self._pipe_upstream(head, reader, writer, self._internal_port)
        except Exception:  # noqa: BLE001
            logger.exception("front-end connection failed")
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _pipe_upstream(self, head: bytes, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter, port: Optional[int]) -> None:
        """Replay the buffered head to an internal listener and splice the
        byte streams (transparent for WS upgrades and streaming bodies)."""
        if port is None:
            writer.write(b"HTTP/1.1 502 Bad Gateway\r\ncontent-length: 0\r\n\r\n")
            await writer.drain()
            writer.close()
            return
        try:
            up_reader, up_writer = await asyncio.open_connection("127.0.0.1", port)
        except OSError:
            writer.write(b"HTTP/1.1 502 Bad Gateway\r\ncontent-length: 0\r\n\r\n")
            await writer.drain()
            writer.close()
            return
        up_writer.write(head)
        await up_writer.drain()

        async def copy(src: asyncio.StreamReader, dst: asyncio.StreamWriter) -> None:
            try:
                while True:
                    data = await src.read(65536)
                    if not data:
                        break
                    dst.write(data)
                    await dst.drain()
            except Exception:  # noqa: BLE001  (peer reset mid-splice)
                pass
            finally:
                try:
                    dst.close()
                except Exception:  # noqa: BLE001
                    pass

        await asyncio.gather(copy(reader, up_writer), copy(up_reader, writer))

    async def _handle_calls_inline(self, reader: asyncio.StreamReader,
                                   writer: asyncio.StreamWriter, method: str,
                                   path: str, headers: dict) -> None:
        """Answer WebRTC call setup/hang-up on the MAIN port (reference
        ``websocket_router.py:579-720`` URL shape)."""
        _REASONS = {200: "OK", 201: "Created", 400: "Bad Request",
                    404: "Not Found", 500: "Internal Server Error",
                    501: "Not Implemented", 503: "Service Unavailable"}

        def respond(status: int, body: bytes = b"", extra: tuple = ()) -> None:
            lines = [f"HTTP/1.1 {status} {_REASONS.get(status, '')}".encode()]
            lines.extend(f"{k}: {v}".encode() for k, v in extra)
            lines.append(f"content-length: {len(body)}".encode())
            lines.append(b"connection: close")
            writer.write(b"\r\n".join(lines) + b"\r\n\r\n" + body)

        manager = self.call_manager
        if manager is None:
            respond(501, b"WebRTC transport requires aiortc (pip install 's2s-tpu[webrtc]'); use the "
                         b"WebSocket transport at /v1/realtime.\n")
        elif method == "POST" and path == "/v1/realtime/calls":
            length = int(headers.get("content-length") or 0)
            body = ""
            if length:
                body = (await reader.readexactly(length)).decode("utf-8", errors="replace")
            if "json" in headers.get("content-type", ""):
                try:
                    offer_sdp = json.loads(body).get("sdp", "")
                except json.JSONDecodeError:
                    offer_sdp = ""
            else:
                offer_sdp = body
            if not offer_sdp.strip():
                respond(400, b"Missing SDP offer\n")
            else:
                from s2s_tpu_torch.realtime.webrtc import PoolBusyError

                try:
                    call_id, answer = await asyncio.wait_for(
                        manager.handle_call(offer_sdp), timeout=30)
                except PoolBusyError as exc:
                    respond(503, f"{exc}\n".encode())
                except Exception as exc:  # noqa: BLE001
                    logger.exception("WebRTC negotiation failed")
                    respond(500, f"Negotiation failed: {exc}\n".encode())
                else:
                    respond(201, answer.encode(), extra=(
                        ("content-type", "application/sdp"),
                        ("location", f"/v1/realtime/calls/{call_id}"),
                    ))
        elif method == "DELETE" and path.startswith("/v1/realtime/calls/"):
            call_id = path[len("/v1/realtime/calls/"):]
            try:
                found = await asyncio.wait_for(manager.hangup(call_id), timeout=10)
            except Exception:  # noqa: BLE001
                logger.exception("WebRTC hangup failed")
                respond(500)
            else:
                respond(200 if found else 404)
        else:
            respond(404, b"Not found\n")
        try:
            await writer.drain()
            writer.close()
        except Exception:  # noqa: BLE001
            pass

    # ── WebRTC SDP endpoint (side HTTP listener) ─────────────────────

    def _start_webrtc_endpoint(self) -> None:
        from s2s_tpu_torch.realtime.webrtc import WEBRTC_AVAILABLE, WebRTCCallManager, load_rtc

        rtc = self._webrtc_rtc
        if rtc is None and WEBRTC_AVAILABLE:
            rtc = load_rtc()
        if rtc is None:
            return
        self.call_manager = WebRTCCallManager(
            self.pool, self.stop_event, rtc=rtc, ice_servers=self._webrtc_ice_servers
        )
        manager = self.call_manager
        loop = self._loop

        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class CallsHandler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                logger.debug("webrtc-http: " + fmt, *args)

            def do_POST(self) -> None:  # noqa: N802
                from s2s_tpu_torch.realtime.webrtc import PoolBusyError

                if self.path.split("?")[0] != "/v1/realtime/calls":
                    self.send_response(404)
                    self.end_headers()
                    return
                length = int(self.headers.get("content-length") or 0)
                body = self.rfile.read(length).decode("utf-8", errors="replace")
                if "json" in (self.headers.get("content-type") or ""):
                    try:
                        offer_sdp = json.loads(body).get("sdp", "")
                    except json.JSONDecodeError:
                        offer_sdp = ""
                else:
                    offer_sdp = body
                if not offer_sdp.strip():
                    self.send_response(400)
                    self.end_headers()
                    self.wfile.write(b"Missing SDP offer\n")
                    return
                future = asyncio.run_coroutine_threadsafe(manager.handle_call(offer_sdp), loop)
                try:
                    call_id, answer = future.result(timeout=30)
                except PoolBusyError as exc:
                    self.send_response(503)
                    self.end_headers()
                    self.wfile.write(f"{exc}\n".encode())
                    return
                except Exception as exc:  # noqa: BLE001
                    logger.exception("WebRTC negotiation failed")
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(f"Negotiation failed: {exc}\n".encode())
                    return
                data = answer.encode()
                self.send_response(201)
                self.send_header("content-type", "application/sdp")
                self.send_header("content-length", str(len(data)))
                # hang-up handle: DELETE this location ends the call
                self.send_header("location", f"/v1/realtime/calls/{call_id}")
                self.end_headers()
                self.wfile.write(data)

            def do_DELETE(self) -> None:  # noqa: N802
                path = self.path.split("?")[0]
                prefix = "/v1/realtime/calls/"
                if not path.startswith(prefix):
                    self.send_response(404)
                    self.end_headers()
                    return
                call_id = path[len(prefix):]
                future = asyncio.run_coroutine_threadsafe(manager.hangup(call_id), loop)
                try:
                    found = future.result(timeout=10)
                except Exception:  # noqa: BLE001
                    logger.exception("WebRTC hangup failed")
                    self.send_response(500)
                    self.end_headers()
                    return
                self.send_response(200 if found else 404)
                self.end_headers()

        port = self.webrtc_port if self.webrtc_port is not None else 0
        self._webrtc_http = ThreadingHTTPServer((self.host, port), CallsHandler)
        self.webrtc_bound_port = self._webrtc_http.server_address[1]
        threading.Thread(
            target=self._webrtc_http.serve_forever, daemon=True, name="webrtc-calls-http"
        ).start()
        logger.info(
            "WebRTC call endpoint on http://%s:%d/v1/realtime/calls",
            self.host, self.webrtc_bound_port,
        )

    async def _ws_handler(self, ws) -> None:
        transport = WebSocketTransport(ws)
        unit = claim_unit(self.pool, transport)
        if unit is None:
            logger.warning("Rejected connection: all %d pipeline slots in use", len(self.pool))
            await send_ws_event(
                ws,
                build_error_event(
                    f"All {len(self.pool)} session slots are in use. "
                    "Disconnect an existing client first.",
                    "session_limit_reached",
                ),
            )
            await ws.close(code=1008, reason="All session slots are in use")
            return
        await ws_session(ws, unit, self.stop_event)

    async def _main(self) -> None:
        import websockets.asyncio.server as ws_server

        send_tasks = [asyncio.create_task(send_loop_for(unit, self.stop_event)) for unit in self.pool]
        front = None
        async with ws_server.serve(
            self._ws_handler, "127.0.0.1", 0, process_request=self._process_request
        ) as server:
            self._internal_port = (
                server.sockets[0].getsockname()[1] if server.sockets else None
            )
            front = await asyncio.start_server(self._front_handler, self.host, self.port)
            self.bound_port = (
                front.sockets[0].getsockname()[1] if front.sockets else self.port
            )
            if self.llm_proxy is not None:
                self._proxy_port = self.llm_proxy.start(self.host, self.bound_port)
            self._start_webrtc_endpoint()
            self.started.set()
            logger.info("Realtime server on ws://%s:%d/v1/realtime", self.host, self.bound_port)
            try:
                while not self.stop_event.is_set():
                    await asyncio.sleep(0.1)
            finally:
                front.close()
                await front.wait_closed()
        from s2s_tpu_torch.realtime.router import _release_tasks

        for task in (*send_tasks, *_release_tasks):
            task.cancel()
        for task in (*send_tasks, *list(_release_tasks)):
            try:
                await task
            except asyncio.CancelledError:
                pass
        for unit in self.pool:
            sess = unit.session
            if sess is not None and sess.transport is not None:
                try:
                    await sess.transport.close()
                except Exception:  # noqa: BLE001
                    pass

    def run(self) -> None:
        """ThreadManager entry point."""
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._main())
        finally:
            if self._webrtc_http is not None:
                self._webrtc_http.shutdown()
            self._loop.close()
            logger.info("Realtime server stopped")

    # handler-protocol compatibility (ThreadManager.stop sets stop_event)
    @property
    def handlers(self) -> list[Any]:
        return []
