"""OpenAI-compatible LLM passthrough proxy (reference
``api/openai_realtime/llm_proxy.py``).

Lets clients reuse the server's configured upstream for plain
``/v1/chat/completions`` / ``/v1/responses`` calls next to the voice
session.  Forces the configured model, ``store=false`` on responses,
injects ``stream_options.include_usage``, streams SSE verbatim while
counting tokens on a copy.  No auth by design (the realtime server itself
is the trust boundary).

The websockets HTTP hook can't read POST bodies, so the proxy runs its own
stdlib HTTP server on ``port + 1``.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import httpx
from pydantic import BaseModel

logger = logging.getLogger(__name__)


class ProxyUsage(BaseModel):
    """Replica-local counters, surfaced as the ``llm_proxy`` section of
    ``GET /v1/usage``.  429 gets its own bucket (never double-counted under
    4xx) so a quota-melting client is visible at a glance (reference
    ``llm_proxy.py:43-104``)."""

    requests: int = 0
    streamed_requests: int = 0
    responses_2xx: int = 0
    responses_4xx: int = 0
    responses_429: int = 0
    responses_5xx: int = 0
    input_tokens: int = 0
    output_tokens: int = 0
    upstream_errors: int = 0

    def record_status(self, status: int) -> None:
        if status == 429:
            self.responses_429 += 1
        elif 200 <= status < 300:
            self.responses_2xx += 1
        elif 400 <= status < 500:
            self.responses_4xx += 1
        elif status >= 500:
            self.responses_5xx += 1


class LLMProxy:
    def __init__(
        self,
        base_url: Optional[str],
        api_key: Optional[str],
        model_name: str,
        shape: str = "chat",
        port: Optional[int] = None,
    ) -> None:
        self.base_url = (base_url or "https://api.openai.com/v1").rstrip("/")
        self.api_key = api_key
        self.model_name = model_name
        self.shape = shape  # which upstream path the backend itself uses
        self.usage = ProxyUsage()
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None

    @property
    def supported_path(self) -> str:
        return "/v1/responses" if self.shape == "responses" else "/v1/chat/completions"

    def maybe_handle(self, connection, request):
        """Hook for the WS server's process_request: report where the proxy
        lives (can't serve POST bodies through the WS handshake path)."""
        return None

    def start(self, host: str, ws_port: int) -> int:
        port = self.port if self.port is not None else ws_port + 1
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                logger.debug("proxy: " + fmt, *args)

            def do_POST(self) -> None:  # noqa: N802
                path = self.path.split("?")[0]
                if path != proxy.supported_path:
                    self.send_response(501)
                    self.end_headers()
                    reason = (
                        f"This server proxies only {proxy.supported_path} "
                        f"(configured backend: {proxy.shape})."
                    )
                    self.wfile.write(json.dumps({"error": reason}).encode())
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    body = None
                if not isinstance(body, dict):
                    # valid-but-non-object JSON (lists, strings) is as
                    # unforwardable as a parse error: 400, never upstream
                    self.send_response(400)
                    self.end_headers()
                    self.wfile.write(b'{"error": "request body must be a JSON object"}')
                    return
                proxy._forward(self, path, body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        port = self._server.server_address[1]  # resolve port=0 → bound port
        threading.Thread(target=self._server.serve_forever, daemon=True, name="llm-proxy").start()
        logger.info("LLM proxy on http://%s:%d%s", host, port, self.supported_path)
        return port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()

    def _forward(self, handler: BaseHTTPRequestHandler, path: str, body: dict) -> None:
        body["model"] = self.model_name  # force the configured model
        if path.endswith("/responses"):
            body["store"] = False
        stream = bool(body.get("stream"))
        if stream and path.endswith("/chat/completions"):
            body.setdefault("stream_options", {})["include_usage"] = True
        self.usage.requests += 1
        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        try:
            with httpx.Client(base_url=self.base_url, timeout=120.0) as client:
                if stream:
                    self.usage.streamed_requests += 1
                    with client.stream("POST", path.removeprefix("/v1"), json=body, headers=headers) as resp:
                        self.usage.record_status(resp.status_code)
                        handler.send_response(resp.status_code)
                        handler.send_header("Content-Type", "text/event-stream")
                        handler.end_headers()
                        for line in resp.iter_lines():
                            handler.wfile.write((line + "\n").encode())
                            self._count_sse(line)
                else:
                    resp = client.post(path.removeprefix("/v1"), json=body, headers=headers)
                    self.usage.record_status(resp.status_code)
                    handler.send_response(resp.status_code)
                    handler.send_header("Content-Type", "application/json")
                    handler.end_headers()
                    handler.wfile.write(resp.content)
                    self._count_json(resp)
        except Exception:
            self.usage.upstream_errors += 1
            self.usage.record_status(502)
            logger.exception("LLM proxy upstream failure")
            try:
                handler.send_response(502)
                handler.end_headers()
            except Exception:  # noqa: BLE001
                pass

    def _count_sse(self, line: str) -> None:
        if not line.startswith("data:"):
            return
        payload = line[5:].strip()
        if payload == "[DONE]":
            return
        try:
            data = json.loads(payload)
        except json.JSONDecodeError:
            return
        usage = data.get("usage") or (data.get("response") or {}).get("usage") or {}
        self.usage.input_tokens += usage.get("prompt_tokens", usage.get("input_tokens", 0)) or 0
        self.usage.output_tokens += usage.get("completion_tokens", usage.get("output_tokens", 0)) or 0

    def _count_json(self, resp: httpx.Response) -> None:
        try:
            usage = resp.json().get("usage") or {}
        except Exception:  # noqa: BLE001
            return
        self.usage.input_tokens += usage.get("prompt_tokens", usage.get("input_tokens", 0)) or 0
        self.usage.output_tokens += usage.get("completion_tokens", usage.get("output_tokens", 0)) or 0
