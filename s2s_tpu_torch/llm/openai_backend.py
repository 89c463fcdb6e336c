"""Remote OpenAI-compatible LLM backends (Responses API + Chat Completions).

Pure-httpx re-implementation of reference
``LLM/base_openai_compatible_language_model.py`` + ``responses_api_...`` +
``chat_completions_...`` (the reference default LLM path — no TPU involved):

- normalized **provider events** (text delta / assistant message / tool call
  / usage) emitted by shape-specific SSE parsers;
- streaming consumption with sentence batching and per-event staleness
  gates; **eager tool-call history recording** before forwarding;
- **transactional history**: the user-visible items a generation writes are
  rolled back if it fails;
- ``httpx.ReadTimeout`` -> canned spoken apology (response still terminates
  cleanly);
- provider ``extra_body`` to disable reasoning on non-official servers;
  ``api_key`` defaults to "none" for loopback base URLs;
- audio-input requests (``--stt none``) serialize the WAV as base64
  ``input_audio`` content through the Chat Completions shape on either
  backend.
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import struct
from typing import Any, Iterator, Optional
from urllib.parse import urlparse

import httpx
import numpy as np
from pydantic import BaseModel

from s2s_tpu_torch.llm.base_handler import BaseLLMHandler, StreamContext
from s2s_tpu_torch.llm.chat import Chat, make_user_audio_message
from s2s_tpu_torch.llm.compaction import build_compactor
from s2s_tpu_torch.pipeline.messages import EndOfResponse, GenerateResponseRequest
from s2s_tpu_torch.realtime.types import FunctionToolCall, generate_id

logger = logging.getLogger(__name__)

READ_TIMEOUT_APOLOGY = "Sorry, I could not reach my language model in time. Please try again."


# ── normalized provider events ───────────────────────────────────────


class TextDelta(BaseModel):
    text: str


class AssistantMessage(BaseModel):
    text: str


class ToolCall(BaseModel):
    call: FunctionToolCall


class Usage(BaseModel):
    input_tokens: int = 0
    output_tokens: int = 0


ProviderEvent = TextDelta | AssistantMessage | ToolCall | Usage


def _is_local_base_url(base_url: str) -> bool:
    host = urlparse(base_url).hostname
    return host in ("localhost", "127.0.0.1", "::1", "0.0.0.0")


def _is_official_openai(base_url: Optional[str]) -> bool:
    return base_url is None or base_url.rstrip("/") == "https://api.openai.com/v1"


def audio_to_wav_base64(audio: np.ndarray, sample_rate: int) -> str:
    """int16-PCM WAV container, base64 (stdlib only — no soundfile)."""
    pcm = np.clip(np.asarray(audio) * 32768, -32768, 32767).astype("<i2") if audio.dtype != np.int16 else audio.astype("<i2")
    data = pcm.tobytes()
    buf = io.BytesIO()
    buf.write(b"RIFF")
    buf.write(struct.pack("<I", 36 + len(data)))
    buf.write(b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
    buf.write(b"data")
    buf.write(struct.pack("<I", len(data)))
    buf.write(data)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def to_chat_content_part(part: dict[str, Any], audio_content_type: str = "input_audio") -> dict[str, Any]:
    """Convert one realtime content part to the Chat Completions wire shape
    (reference ``chat_completions_language_model.py:96-136``): ``input_text``
    -> ``text``, ``input_image`` -> ``image_url``, ``input_audio`` -> either
    the OpenAI ``input_audio`` object or a llama.cpp-style ``audio_url``
    base64 data URL, per *audio_content_type*."""
    ptype = part.get("type")
    if ptype == "input_text":
        return {"type": "text", "text": part.get("text") or ""}
    if ptype == "input_image":
        raw_url = part.get("image_url")
        if isinstance(raw_url, dict):
            image_url = raw_url
        else:
            image_url = {"url": raw_url}
            if part.get("detail") is not None:
                image_url["detail"] = part["detail"]
        return {"type": "image_url", "image_url": image_url}
    if ptype == "input_audio":
        audio_b64 = part.get("audio") or ""
        if audio_content_type == "audio_url":
            return {"type": "audio_url", "audio_url": {"url": f"data:audio/wav;base64,{audio_b64}"}}
        return {"type": "input_audio", "input_audio": {"data": audio_b64, "format": "wav"}}
    return part


def chat_wire_messages(chat: Chat, audio_content_type: str = "input_audio") -> list[dict[str, Any]]:
    """Serialize history for a real Chat Completions server (reference
    ``chat_completions_language_model.py:139-157``): tool-call arguments
    must be JSON *strings*, media content parts use the chat shapes, and
    ``tool`` role messages carry no ``name`` key."""
    messages = chat.to_chat_messages()
    for message in messages:
        for tool_call in message.get("tool_calls") or []:
            fn = tool_call.get("function")
            if fn is not None and not isinstance(fn.get("arguments"), str):
                fn["arguments"] = json.dumps(fn.get("arguments") or {}, ensure_ascii=False)
        content = message.get("content")
        if isinstance(content, list):
            message["content"] = [to_chat_content_part(p, audio_content_type) for p in content]
        if message.get("role") == "tool":
            message.pop("name", None)
    return messages


def iter_sse_data(response: httpx.Response) -> Iterator[dict[str, Any]]:
    """Yield parsed ``data:`` JSON payloads from an SSE byte stream."""
    for line in response.iter_lines():
        line = line.strip()
        if not line.startswith("data:"):
            continue
        payload = line[5:].strip()
        if payload == "[DONE]":
            return
        try:
            yield json.loads(payload)
        except json.JSONDecodeError:
            logger.warning("Skipping malformed SSE payload: %.120s", payload)


class RemoteLLMHandler(BaseLLMHandler):
    """Shared lifecycle for both remote API shapes."""

    api_shape = "chat"  # or "responses"

    def setup(
        self,
        cancel_scope=None,
        speculative_turns=None,
        model_name: str = "gpt-4o-mini",
        base_url: Optional[str] = None,
        api_key: Optional[str] = None,
        stream: bool = True,
        stream_batch_sentences: int = 3,
        enable_lang_prompt: bool = False,
        compact_history: bool = False,
        disable_thinking: bool = True,
        reasoning_effort: Optional[str] = None,
        gen_kwargs: dict[str, Any] | None = None,
        timeout_s: float = 60.0,
        client: httpx.Client | None = None,
        warmup: bool = False,
        audio_content_type: str = "input_audio",
        audio_max_tokens: int = 256,
        audio_history_turns: int = 2,
    ) -> None:
        self.cancel_scope = cancel_scope
        self.speculative_turns = speculative_turns
        self.model_name = model_name
        self.stream = stream
        self.stream_batch_sentences = max(1, stream_batch_sentences)
        self.enable_lang_prompt = enable_lang_prompt
        self.gen_kwargs = gen_kwargs or {}
        if audio_content_type not in ("input_audio", "audio_url"):
            raise ValueError("audio_content_type must be 'input_audio' or 'audio_url'")
        self.audio_content_type = audio_content_type
        self.audio_max_tokens = audio_max_tokens
        self.audio_history_turns = max(0, audio_history_turns)
        if api_key is None:
            # SDK convention: the environment key authenticates by default
            api_key = os.environ.get("OPENAI_API_KEY")
        if api_key is None and base_url is not None and _is_local_base_url(base_url):
            api_key = "none"
        self.base_url = (base_url or "https://api.openai.com/v1").rstrip("/")
        self.client = client or httpx.Client(
            base_url=self.base_url,
            headers={"Authorization": f"Bearer {api_key or 'none'}"},
            timeout=httpx.Timeout(timeout_s, connect=10.0),
        )
        self.extra_body = self._build_extra_body(base_url, disable_thinking, reasoning_effort)
        self.compactor = build_compactor(self._compaction_generate) if compact_history else None
        if warmup:
            try:
                self._compaction_generate("You are terse.", "Say ok.")
            except Exception:
                logger.warning("LLM warmup request failed (continuing)", exc_info=True)

    @staticmethod
    def _build_extra_body(base_url, disable_thinking, reasoning_effort) -> dict[str, Any]:
        """Provider-specific knobs to turn off reasoning; the official server
        rejects unknown keys, so only applied to non-official base URLs."""
        if _is_official_openai(base_url):
            return {}
        body: dict[str, Any] = {}
        if disable_thinking:
            body["chat_template_kwargs"] = {"enable_thinking": False}
        if reasoning_effort:
            body["reasoning_effort"] = reasoning_effort
        return body

    # ── request serialization (shape-specific) ───────────────────────

    def _request_events(self, chat: Chat, tools, tool_choice, max_tokens) -> Iterator[ProviderEvent]:
        if not chat.buffer and chat.system_message is None:
            # fail fast with a clear message instead of a provider 400 (the
            # base turns this into a failed EndOfResponse)
            raise RuntimeError(
                "Cannot generate a response from an empty context: the "
                "conversation has no messages and no instructions."
            )
        if self.api_shape == "responses":
            yield from self._responses_request(chat, tools, tool_choice, max_tokens)
        else:
            yield from self._chat_request(
                chat_wire_messages(chat, self.audio_content_type), tools, tool_choice, max_tokens
            )

    def _responses_request(self, chat: Chat, tools, tool_choice, max_tokens) -> Iterator[ProviderEvent]:
        body: dict[str, Any] = {
            "model": self.model_name,
            "input": chat.to_responses_input(),
            "stream": self.stream,
            "store": False,
            **self.extra_body,
            # sampling knobs apply on this shape too (the chat path merges
            # the same subset)
            **{k: v for k, v in self.gen_kwargs.items() if k in ("temperature", "top_p")},
        }
        if tools:
            body["tools"] = [
                {"type": "function", "name": t.name, "description": t.description, "parameters": t.parameters}
                for t in tools
            ]
        if tool_choice is not None:
            body["tool_choice"] = tool_choice
        if max_tokens:
            body["max_output_tokens"] = max_tokens
        if self.stream:
            with self.client.stream("POST", "/responses", json=body) as resp:
                resp.raise_for_status()
                for ev in iter_sse_data(resp):
                    et = ev.get("type", "")
                    if et == "response.output_text.delta":
                        yield TextDelta(text=ev.get("delta", ""))
                    elif et == "response.output_item.done":
                        item = ev.get("item", {})
                        if item.get("type") == "function_call":
                            yield ToolCall(
                                call=FunctionToolCall(
                                    name=item.get("name", ""),
                                    arguments=item.get("arguments", ""),
                                    # regenerate ids: provider ids may repeat across requests
                                    call_id=generate_id("call"),
                                    id=generate_id("fc"),
                                    status="in_progress",
                                )
                            )
                    elif et == "response.completed":
                        usage = (ev.get("response") or {}).get("usage") or {}
                        yield Usage(
                            input_tokens=usage.get("input_tokens", 0),
                            output_tokens=usage.get("output_tokens", 0),
                        )
        else:
            resp = self.client.post("/responses", json=body)
            resp.raise_for_status()
            data = resp.json()
            for item in data.get("output", []):
                if item.get("type") == "message":
                    text = "".join(
                        c.get("text", "") for c in item.get("content", []) if c.get("type") == "output_text"
                    )
                    if text:
                        yield AssistantMessage(text=text)
                elif item.get("type") == "function_call":
                    yield ToolCall(
                        call=FunctionToolCall(
                            name=item.get("name", ""), arguments=item.get("arguments", ""),
                            call_id=generate_id("call"), id=generate_id("fc"), status="in_progress",
                        )
                    )
            usage = data.get("usage") or {}
            yield Usage(
                input_tokens=usage.get("input_tokens", 0), output_tokens=usage.get("output_tokens", 0)
            )

    @staticmethod
    def _flush_tool_acc(tool_acc: dict[int, dict[str, str]]) -> Iterator[ToolCall]:
        """Accumulated tool deltas -> normalized events; nameless slots are
        provider noise and are skipped, empty arguments default to '{}'."""
        for idx in sorted(tool_acc):
            slot = tool_acc[idx]
            if not slot["name"]:
                continue
            yield ToolCall(
                call=FunctionToolCall(
                    name=slot["name"], arguments=slot["arguments"] or "{}",
                    call_id=generate_id("call"), id=generate_id("fc"),
                    status="in_progress",
                )
            )

    @staticmethod
    def _tools_to_chat_format(tools) -> list[dict[str, Any]]:
        return [
            {
                "type": "function",
                "function": {"name": t.name, "description": t.description, "parameters": t.parameters},
            }
            for t in tools
        ]

    def _chat_request(self, messages, tools, tool_choice, max_tokens) -> Iterator[ProviderEvent]:
        body: dict[str, Any] = {
            "model": self.model_name,
            "messages": messages,
            "stream": self.stream,
            **self.extra_body,
            **{k: v for k, v in self.gen_kwargs.items() if k in ("temperature", "top_p")},
        }
        if tools:
            body["tools"] = self._tools_to_chat_format(tools)
        if tool_choice is not None:
            # Responses tool_choice strings map 1:1; function objects nest.
            if isinstance(tool_choice, dict) and tool_choice.get("type") == "function":
                body["tool_choice"] = {
                    "type": "function", "function": {"name": tool_choice.get("name")}
                }
            else:
                body["tool_choice"] = tool_choice
        if max_tokens:
            body["max_tokens"] = max_tokens
        if self.stream:
            body["stream_options"] = {"include_usage": True}
            tool_acc: dict[int, dict[str, str]] = {}
            with self.client.stream("POST", "/chat/completions", json=body) as resp:
                resp.raise_for_status()
                for ev in iter_sse_data(resp):
                    for choice in ev.get("choices", []):
                        delta = choice.get("delta") or {}
                        # a refusal is spoken/stored exactly like content
                        piece = delta.get("content") or delta.get("refusal")
                        if piece:
                            yield TextDelta(text=piece)
                        for tc in delta.get("tool_calls") or []:
                            slot = tool_acc.setdefault(tc.get("index", 0), {"name": "", "arguments": ""})
                            fn = tc.get("function") or {}
                            if fn.get("name"):
                                slot["name"] += fn["name"]
                            if fn.get("arguments"):
                                slot["arguments"] += fn["arguments"]
                        if choice.get("finish_reason"):
                            # flush accumulated calls on ANY finish marker —
                            # providers that interleave text after a call
                            # finish with "stop", not "tool_calls"
                            yield from self._flush_tool_acc(tool_acc)
                            tool_acc.clear()
                    usage = ev.get("usage")
                    if usage:
                        yield Usage(
                            input_tokens=usage.get("prompt_tokens", 0),
                            output_tokens=usage.get("completion_tokens", 0),
                        )
                # stream ended without a finish marker: don't drop the calls
                yield from self._flush_tool_acc(tool_acc)
        else:
            resp = self.client.post("/chat/completions", json=body)
            resp.raise_for_status()
            data = resp.json()
            choices = data.get("choices") or []
            # some providers return no choices on filtered input: complete
            # cleanly instead of crashing the generation
            msg = (choices[0].get("message") or {}) if choices else {}
            raw = msg.get("content") or msg.get("refusal")
            if raw:
                yield AssistantMessage(text=raw)
            for tc in msg.get("tool_calls") or []:
                fn = tc.get("function") or {}
                if not fn.get("name"):
                    continue
                yield ToolCall(
                    call=FunctionToolCall(
                        name=fn["name"], arguments=fn.get("arguments") or "{}",
                        call_id=generate_id("call"), id=generate_id("fc"), status="in_progress",
                    )
                )
            usage = data.get("usage") or {}
            yield Usage(
                input_tokens=usage.get("prompt_tokens", 0),
                output_tokens=usage.get("completion_tokens", 0),
            )

    # ── BaseLLMHandler integration ───────────────────────────────────

    def _apply_instructions(self, chat, instructions, raw_tools, tool_choice, ctx, wants_audio) -> None:
        """Remote APIs do native tool calling: system prompt only (no <code>
        prompt section), tools go in the request body."""
        from s2s_tpu_torch.llm.chat import make_system_message
        from s2s_tpu_torch.llm.prompts import build_text_system_prompt, build_voice_system_prompt
        from s2s_tpu_torch.realtime.types import FunctionTool

        if instructions:
            builder = build_voice_system_prompt if wants_audio else build_text_system_prompt
            chat.add_item(make_system_message(builder(instructions)))
        ctx.function_tools = [
            t if isinstance(t, FunctionTool) else FunctionTool.model_validate(t)
            for t in (raw_tools or [])
            if getattr(t, "type", None) == "function" or (isinstance(t, dict) and t.get("type") == "function")
        ]

    def process(self, request) -> Iterator[Any]:
        """Wrap the shared lifecycle with transactional history + audio path."""
        if isinstance(request, GenerateResponseRequest) and request.audio is not None:
            yield from self._process_audio(request)
            return
        self._provisional_items: set[str] = set()
        self._provisional_calls: set[str] = set()
        self._had_error = False
        chat = request.runtime_config.chat if request.runtime_config else None
        for item in super().process(request):
            if (
                isinstance(item, EndOfResponse)
                and item.error
                and chat is not None
                and self._provisional_calls
            ):
                # transactional history: a failed generation must not leave
                # its eagerly-recorded function calls behind
                chat.rollback_generation(
                    "", item_ids=set(), call_ids=set(self._provisional_calls)
                )
                self._provisional_calls = set()
                logger.info("Rolled back provisional tool calls after failed generation")
            yield item

    def _resolve_max_tokens(self, response, runtime_config) -> Any:
        """Response cap wins, then the session's; ``"inf"`` means uncapped."""
        max_tokens = (
            response.max_output_tokens if response and response.max_output_tokens
            else (runtime_config.session.max_output_tokens if runtime_config else None)
        )
        return None if max_tokens == "inf" else max_tokens

    def _event_pieces(
        self, events: Iterator[ProviderEvent], ctx: StreamContext,
        record_chat: Chat | None, recorded_calls: set[str],
    ) -> Iterator[Any]:
        """Normalized provider events -> stream pieces (text / tool call) for
        the base ``_stream``.  Shared by the text and audio paths: eager
        tool-call history recording (a fast client may send the tool output
        before EndOfResponse; its FC must already exist), usage capture, and
        the ReadTimeout -> spoken-apology conversion."""
        try:
            for event in events:
                if isinstance(event, (TextDelta, AssistantMessage)):
                    yield event.text
                elif isinstance(event, ToolCall):
                    if record_chat is not None:
                        from s2s_tpu_torch.realtime.types import FunctionCallItem

                        record_chat.add_item(
                            FunctionCallItem(
                                id=event.call.id, call_id=event.call.call_id,
                                name=event.call.name, arguments=event.call.arguments,
                                status=event.call.status,
                            )
                        )
                        recorded_calls.add(event.call.call_id)
                    # forwarded through the stream so the base flushes lead-in
                    # text first and emits the tool chunk in order
                    yield event.call
                elif isinstance(event, Usage):
                    ctx.input_tokens = event.input_tokens
                    ctx.output_tokens = event.output_tokens
        except httpx.ReadTimeout:
            logger.warning("LLM API read timeout; speaking canned apology")
            yield READ_TIMEOUT_APOLOGY

    def _generate_stream(self, chat: Chat, ctx: StreamContext, runtime_config, response) -> Iterator[str]:
        tools = ctx.function_tools
        tool_choice = (
            response.tool_choice if response and response.tool_choice else runtime_config.session.tool_choice
        ) if runtime_config else None
        max_tokens = self._resolve_max_tokens(response, runtime_config)
        original_chat = runtime_config.chat if runtime_config else None
        events = self._request_events(chat, tools, tool_choice, max_tokens)
        yield from self._event_pieces(events, ctx, original_chat, self._provisional_calls)

    # Eager FCs are recorded during streaming; keep base write-back from
    # double-adding them.
    def _count_output_tokens(self, raw_text: str) -> int:
        return max(0, len(raw_text.split()))

    # ── audio-input turns (direct audio sessions) ────────────────────

    def _process_audio(self, request: GenerateResponseRequest) -> Iterator[Any]:
        """Audio turns route the WAV through the Chat Completions protocol on
        either backend with the FULL text-turn feature set (reference
        ``base_openai_compatible_language_model.py:684-764``): native tool
        calling, out-of-band responses, instructions, and a transactional
        user message + eagerly-recorded tool calls that roll back when the
        turn fails OR is interrupted before commit."""
        from s2s_tpu_torch.llm.chat import ChatItemError, build_active_chat, make_assistant_message
        from s2s_tpu_torch.pipeline.messages import EndOfResponse, TokenUsage
        from s2s_tpu_torch.utils.common import is_out_of_band

        runtime_config = request.runtime_config
        response = request.response
        original_chat = runtime_config.chat
        out_of_band = is_out_of_band(response)
        ctx = StreamContext(
            turn_id=request.turn_id,
            turn_revision=request.turn_revision,
            speech_stopped_at_s=request.speech_stopped_at_s,
            cancel_generation=self.cancel_scope.generation if self.cancel_scope else None,
        )
        if out_of_band:
            try:
                active = build_active_chat(original_chat, response)
            except ChatItemError as exc:
                yield EndOfResponse(turn_id=ctx.turn_id, turn_revision=ctx.turn_revision, error=str(exc))
                return
        else:
            active = original_chat.copy()

        wav_b64 = audio_to_wav_base64(request.audio, request.audio_sample_rate)
        audio_msg = active.add_item(make_user_audio_message(wav_b64))
        user_msg = None
        if not out_of_band:
            # same id in both chats so speculative revisions/rollback find it
            provisional = make_user_audio_message(wav_b64)
            provisional.id = audio_msg.id
            user_msg = original_chat.add_item(provisional)

        instructions = (
            response.instructions if response and response.instructions
            else runtime_config.session.instructions
        )
        tools = response.tools if response and response.tools else runtime_config.session.tools
        tool_choice = (
            response.tool_choice if response and response.tool_choice
            else runtime_config.session.tool_choice
        ) if runtime_config else None
        self._apply_instructions(active, instructions, tools, tool_choice, ctx, True)
        # response/session caps win (like text turns); otherwise audio replies
        # default to a bounded audio_max_tokens instead of running uncapped
        max_tokens = self._resolve_max_tokens(response, runtime_config) or self.audio_max_tokens
        # wire conversion handles every audio-carrying turn still in history
        # plus any image parts, honoring the configured audio payload shape
        messages = chat_wire_messages(active, self.audio_content_type)
        gen = ctx.cancel_generation
        consumed_image_ids = active.image_message_ids()
        recorded_calls: set[str] = set()

        def rollback() -> None:
            if out_of_band:
                return
            original_chat.rollback_generation(
                (user_msg.id if user_msg else None) or "", item_ids=set(), call_ids=recorded_calls
            )

        try:
            events = self._chat_request(messages, ctx.function_tools, tool_choice, max_tokens)
            pieces = self._event_pieces(
                events, ctx, None if out_of_band else original_chat, recorded_calls
            )
            yield from self._stream(pieces, gen, None, ctx, runtime_config, response)
            if ctx.stopped:
                # handler shutdown mid-generation: no commit, no trailing output
                return
            output_allowed = not ctx.cancelled and self._turn_output_allowed(ctx.turn_id, ctx.turn_revision)
            if output_allowed:
                if not out_of_band:
                    original_chat.add_item(make_assistant_message(ctx.clean_text))
                    original_chat.strip_images(consumed_image_ids)
                    original_chat.compact_audio_history(max_audio_turns=self.audio_history_turns)
                    original_chat.trim_if_needed(self.compactor)
                if ctx.printable.strip():
                    yield self._chunk(ctx.printable.strip(), ctx, None, runtime_config, response)
                if ctx.input_tokens or ctx.output_tokens:
                    yield TokenUsage(
                        input_tokens=ctx.input_tokens, output_tokens=ctx.output_tokens,
                        turn_id=ctx.turn_id, turn_revision=ctx.turn_revision,
                    )
            else:
                # interrupted/stale before commit: the audio turn never
                # happened — remove the user message and any eager tool calls
                rollback()
        except Exception as exc:
            rollback()
            logger.exception("Audio LLM turn failed; rolled back transactional items")
            yield EndOfResponse(
                turn_id=ctx.turn_id, turn_revision=ctx.turn_revision,
                cancel_generation=ctx.cancel_generation,
                error=f"Language model generation failed: {exc}",
            )
            return
        yield EndOfResponse(
            turn_id=ctx.turn_id, turn_revision=ctx.turn_revision, cancel_generation=ctx.cancel_generation
        )

    # ── compaction ───────────────────────────────────────────────────

    def _compaction_generate(self, system: str, user: str) -> str:
        messages = [{"role": "system", "content": system}, {"role": "user", "content": user}]
        body = {"model": self.model_name, "messages": messages, "stream": False, **self.extra_body}
        resp = self.client.post("/chat/completions", json=body)
        resp.raise_for_status()
        return resp.json()["choices"][0]["message"]["content"] or ""


class ResponsesAPIHandler(RemoteLLMHandler):
    """Default LLM backend: OpenAI ``/v1/responses`` (reference
    ``LLM/responses_api_language_model.py``)."""

    api_shape = "responses"


class ChatCompletionsHandler(RemoteLLMHandler):
    """OpenAI ``/v1/chat/completions`` backend (reference
    ``LLM/chat_completions_language_model.py``)."""

    api_shape = "chat"
