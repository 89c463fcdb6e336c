"""Base LLM stage handler: the shared generation lifecycle.

Behavioral parity with reference ``LLM/language_model.py:145-619``:

- builds the **active chat** (copy, or out-of-band throwaway seeded from
  ``response.input``);
- injects the channel system prompt (voice vs text) + prompted-tool section;
- streams text pieces from the backend, batching complete sentences into
  ``stream_batch_sentences``-sized chunks, extracting ``<code>`` tool-call
  blocks, filtering unspeechable characters (audio responses only);
- per-piece staleness checks: cancel generation, latest turn revision, stop
  event — abort by simply not consuming the next piece;
- end-of-turn write-back to the ORIGINAL chat (assistant text + tool calls),
  image stripping of consumed images, compaction trigger;
- ``TokenUsage`` then ``EndOfResponse`` — the latter ALWAYS, even on
  exceptions (a missing EndOfResponse would wedge the response slot).

Backends implement ``_generate_stream(active_chat, ctx, ...) -> Iterator[str]``
text pieces plus a token counter; see :mod:`s2s_tpu_torch.llm.local_backend`
(JAX decoder) and :mod:`s2s_tpu_torch.llm.openai_backend` (remote APIs).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from s2s_tpu_torch.llm.chat import (
    Chat,
    ChatItemError,
    build_active_chat,
    make_assistant_message,
    make_system_message,
    make_user_message,
)
from s2s_tpu_torch.llm.prompts import build_text_system_prompt, build_voice_system_prompt
from s2s_tpu_torch.llm.tool_call import (
    END_CODE,
    ENTER_CODE,
    build_block_regex,
    build_tool_system_prompt,
    extract_function_calls_from_text,
)
from s2s_tpu_torch.llm.utils import remove_unspeechable, resolve_auto_language
from s2s_tpu_torch.pipeline.control import CancelScope
from s2s_tpu_torch.pipeline.messages import (
    EndOfResponse,
    GenerateResponseRequest,
    LLMResponseChunk,
    TokenUsage,
)
from s2s_tpu_torch.pipeline.turns import SpeculativeTurnTracker
from s2s_tpu_torch.realtime.types import FunctionTool, FunctionToolCall, ResponseCreateParams
from s2s_tpu_torch.runtime.base_handler import BaseHandler
from s2s_tpu_torch.utils.common import is_out_of_band, response_wants_audio
from s2s_tpu_torch.utils.sentences import split_complete, split_sentences

logger = logging.getLogger(__name__)


@dataclass
class StreamContext:
    """Mutable accumulator threaded through one generation."""

    cancelled: bool = False
    stopped: bool = False
    raw_text: str = ""
    clean_text: str = ""
    printable: str = ""
    tools: list[FunctionToolCall] = field(default_factory=list)
    function_tools: list[FunctionTool] = field(default_factory=list)
    block_regex: Optional[str] = None
    enter_code: Optional[str] = None
    end_code: Optional[str] = None
    input_tokens: int = 0
    output_tokens: int = 0
    sentence_batch: list[str] = field(default_factory=list)
    turn_id: str | None = None
    turn_revision: int | None = None
    speech_stopped_at_s: float | None = None
    cancel_generation: int | None = None

    @property
    def interrupted(self) -> bool:
        return self.cancelled or self.stopped


class BaseLLMHandler(BaseHandler):
    """Abstract base; subclasses provide ``_generate_stream``."""

    cancel_scope: CancelScope | None = None
    speculative_turns: SpeculativeTurnTracker | None = None
    stream_batch_sentences: int = 3
    enable_lang_prompt: bool = False
    compactor = None

    # ── staleness ────────────────────────────────────────────────────

    def _turn_is_latest(self, turn_id, revision) -> bool:
        return self.speculative_turns is None or self.speculative_turns.is_latest(turn_id, revision)

    def _turn_output_allowed(self, turn_id, revision) -> bool:
        if self.speculative_turns is None:
            return True
        return self.speculative_turns.is_latest_after_reopen_grace(turn_id, revision)

    def _check_stop(self, gen: int | None, ctx: StreamContext) -> bool:
        if gen is not None and self.cancel_scope is not None and self.cancel_scope.is_stale(gen):
            ctx.cancelled = True
            logger.info("LLM generation cancelled (interruption)")
            return True
        if not self._turn_is_latest(ctx.turn_id, ctx.turn_revision):
            ctx.cancelled = True
            logger.info("LLM generation cancelled (stale speculative turn)")
            return True
        if self.stop_event.is_set():
            ctx.stopped = True
            return True
        return False

    # ── backend hook ─────────────────────────────────────────────────

    def _generate_stream(
        self,
        chat: Chat,
        ctx: StreamContext,
        runtime_config,
        response: ResponseCreateParams | None,
    ) -> Iterator[str]:
        """Yield raw text pieces; set ``ctx.input_tokens``/``output_tokens``."""
        raise NotImplementedError

    # ── prompt assembly ──────────────────────────────────────────────

    def _apply_instructions(
        self,
        chat: Chat,
        instructions: Optional[str],
        raw_tools: list[Any] | None,
        tool_choice: Optional[str],
        ctx: StreamContext,
        wants_audio: bool,
    ) -> None:
        # tools apply even WITHOUT instructions (a session.update can carry
        # tools alone — dropping them silently broke local tool calling)
        tools = [
            t if isinstance(t, FunctionTool) else FunctionTool.model_validate(t)
            for t in (raw_tools or [])
            if getattr(t, "type", None) == "function" or (isinstance(t, dict) and t.get("type") == "function")
        ]
        use_tools = bool(tools) and tool_choice != "none"
        if use_tools:
            ctx.block_regex = build_block_regex()
            ctx.enter_code, ctx.end_code = ENTER_CODE, END_CODE
            ctx.function_tools = tools
        if not instructions and not use_tools:
            return
        builder = build_voice_system_prompt if wants_audio else build_text_system_prompt
        if use_tools:
            section = build_tool_system_prompt(tools, text_only=not wants_audio)
            full = builder(instructions or "", tool_section=section)
        else:
            full = builder(instructions or "")
        chat.add_item(make_system_message(full))

    @staticmethod
    def _drop_unterminated_block(ctx: "StreamContext") -> None:
        """An opened ``<code>`` block that never closed (max_tokens cut the
        stream) must not be spoken verbatim — drop from the opener on."""
        if ctx.enter_code and ctx.enter_code in ctx.printable:
            kept = ctx.printable[: ctx.printable.index(ctx.enter_code)]
            logger.warning("Dropping unterminated tool block from LLM output")
            ctx.printable = kept

    # ── sentence batching / tool extraction ──────────────────────────

    def _chunk(self, text: str, ctx: StreamContext, language_code, runtime_config, response, tools=None):
        return LLMResponseChunk(
            text=text,
            language_code=language_code,
            tools=tools or [],
            runtime_config=runtime_config,
            response=response,
            turn_id=ctx.turn_id,
            turn_revision=ctx.turn_revision,
            speech_stopped_at_s=ctx.speech_stopped_at_s,
            cancel_generation=ctx.cancel_generation,
        )

    def _drain_printable(
        self, ctx: StreamContext, language_code, runtime_config, response
    ) -> tuple[list[LLMResponseChunk], str]:
        """Extract complete tool blocks + complete sentences from
        ``ctx.printable``; returns (chunks, remaining_printable)."""
        printable = ctx.printable
        chunks: list[LLMResponseChunk] = []

        if ctx.enter_code and ctx.enter_code in printable:
            idx = printable.index(ctx.enter_code)
            before, block_and_after = printable[:idx], printable[idx:]
            if before.strip():
                ctx.sentence_batch.extend(split_sentences(before))
            if ctx.sentence_batch:
                chunks.append(
                    self._chunk(" ".join(ctx.sentence_batch), ctx, language_code, runtime_config, response)
                )
                ctx.sentence_batch = []
            if ctx.block_regex and ctx.end_code and ctx.end_code in block_and_after:
                stripped, calls = extract_function_calls_from_text(block_and_after, ctx.block_regex)
                parsed: list[FunctionToolCall] = []
                for fc in calls:
                    if ctx.tools:
                        logger.warning(
                            "Skipping extra tool call '%s'; one tool call per response", fc.function_name
                        )
                        continue
                    try:
                        tc = fc.to_function_tool_call(ctx.function_tools)
                    except ValueError as e:
                        logger.warning("Skipping invalid tool call: %s", e)
                        continue
                    ctx.tools.append(tc)
                    parsed.append(tc)
                if parsed:
                    chunks.append(
                        self._chunk("", ctx, language_code, runtime_config, response, tools=parsed)
                    )
                printable = stripped
            else:
                printable = block_and_after  # block still streaming in
            return chunks, printable

        if printable and not response_wants_audio(response) and ctx.enter_code is None:
            # Text-only, no tool blocks: stream raw text immediately (no
            # sentence splitting — it would mangle markdown/newlines).
            chunks.append(self._chunk(printable, ctx, language_code, runtime_config, response))
            return chunks, ""

        if printable:
            complete, remainder = split_complete(printable)
            for s in complete:
                ctx.sentence_batch.append(s)
                if len(ctx.sentence_batch) >= self.stream_batch_sentences:
                    chunks.append(
                        self._chunk(
                            " ".join(ctx.sentence_batch), ctx, language_code, runtime_config, response
                        )
                    )
                    ctx.sentence_batch = []
            printable = remainder
        return chunks, printable

    def _stream(
        self, piece_iter: Iterator[str], gen, language_code, ctx: StreamContext, runtime_config, response
    ) -> Iterator[LLMResponseChunk]:
        wants_audio = response_wants_audio(response)
        for piece in piece_iter:
            if self._check_stop(gen, ctx):
                break
            if isinstance(piece, FunctionToolCall):
                # native provider tool call: flush any lead-in text FIRST so
                # TTS speaks it before the tool event, then forward the call
                lead_in = ctx.sentence_batch
                ctx.sentence_batch = []
                if ctx.printable.strip():
                    lead_in.append(ctx.printable.strip())
                    ctx.printable = ""
                if not self._turn_output_allowed(ctx.turn_id, ctx.turn_revision):
                    ctx.cancelled = True
                    break
                if lead_in:
                    yield self._chunk(" ".join(lead_in), ctx, language_code, runtime_config, response)
                ctx.tools.append(piece)
                yield self._chunk("", ctx, language_code, runtime_config, response, tools=[piece])
                continue
            ctx.raw_text += piece
            clean = piece if not wants_audio else remove_unspeechable(piece)
            ctx.clean_text += clean
            ctx.printable += clean
            chunks, ctx.printable = self._drain_printable(ctx, language_code, runtime_config, response)
            if chunks and not self._turn_output_allowed(ctx.turn_id, ctx.turn_revision):
                ctx.cancelled = True
                logger.info("LLM generation cancelled (stale speculative turn)")
                break
            yield from chunks

        if ctx.sentence_batch and not ctx.interrupted:
            self._drop_unterminated_block(ctx)
            if ctx.printable.strip():
                ctx.sentence_batch.append(ctx.printable.strip())
                ctx.printable = ""
            if not self._turn_output_allowed(ctx.turn_id, ctx.turn_revision):
                ctx.cancelled = True
                return
            yield self._chunk(" ".join(ctx.sentence_batch), ctx, language_code, runtime_config, response)
            ctx.sentence_batch = []

    # ── main entry ───────────────────────────────────────────────────

    def process(self, request) -> Iterator[Any]:
        if not isinstance(request, GenerateResponseRequest):
            raise TypeError(f"Unexpected request type: {type(request)}")
        ctx = StreamContext(
            turn_id=request.turn_id,
            turn_revision=request.turn_revision,
            speech_stopped_at_s=request.speech_stopped_at_s,
        )
        if not self._turn_is_latest(ctx.turn_id, ctx.turn_revision):
            logger.info("Skipping stale LLM request turn=%s rev=%s", ctx.turn_id, ctx.turn_revision)
            yield EndOfResponse(turn_id=ctx.turn_id, turn_revision=ctx.turn_revision)
            return

        runtime_config = request.runtime_config
        response = request.response
        original_chat = runtime_config.chat
        out_of_band = is_out_of_band(response)
        if out_of_band:
            try:
                active_chat = build_active_chat(original_chat, response)
            except ChatItemError as exc:
                logger.info("Out-of-band response rejected: %s", exc)
                yield EndOfResponse(
                    turn_id=ctx.turn_id, turn_revision=ctx.turn_revision, error=str(exc)
                )
                return
        else:
            active_chat = original_chat.copy()

        language_code = request.language_code
        instructions = (
            response.instructions if response and response.instructions else runtime_config.session.instructions
        )
        tools = response.tools if response and response.tools else runtime_config.session.tools
        tool_choice = (
            response.tool_choice if response and response.tool_choice else runtime_config.session.tool_choice
        )
        self._apply_instructions(
            active_chat, instructions, tools, str(tool_choice) if tool_choice else None, ctx,
            response_wants_audio(response),
        )
        language_code, lang_name = resolve_auto_language(language_code)
        if lang_name and self.enable_lang_prompt:
            active_chat.add_item(make_user_message(f"Please reply to my message in {lang_name}."))

        gen = self.cancel_scope.generation if self.cancel_scope else None
        ctx.cancel_generation = gen
        consumed_image_ids = active_chat.image_message_ids()

        try:
            piece_iter = self._generate_stream(active_chat, ctx, runtime_config, response)
            yield from self._stream(piece_iter, gen, language_code, ctx, runtime_config, response)

            if ctx.stopped:
                return

            output_allowed = not ctx.cancelled and self._turn_output_allowed(ctx.turn_id, ctx.turn_revision)
            commit_allowed = output_allowed and not out_of_band
            if commit_allowed:
                original_chat.add_item(make_assistant_message(ctx.clean_text))
                for t in ctx.tools:
                    from s2s_tpu_torch.realtime.types import FunctionCallItem

                    original_chat.add_item(
                        FunctionCallItem(
                            id=t.id, call_id=t.call_id, name=t.name, arguments=t.arguments, status=t.status
                        )
                    )
                original_chat.strip_images(consumed_image_ids)
                original_chat.trim_if_needed(self.compactor)

            self._drop_unterminated_block(ctx)
            if output_allowed and ctx.printable.strip():
                yield self._chunk(ctx.printable.strip(), ctx, language_code, runtime_config, response)

            output_tokens = ctx.output_tokens or self._count_output_tokens(ctx.raw_text)
            if output_allowed and (ctx.input_tokens or output_tokens):
                yield TokenUsage(
                    input_tokens=ctx.input_tokens,
                    output_tokens=output_tokens,
                    turn_id=ctx.turn_id,
                    turn_revision=ctx.turn_revision,
                )
        except Exception as exc:
            # Generation failures must still terminate the response; otherwise
            # st.rsp.active wedges and every later response blocks.
            logger.exception("LLM generation failed; ending the current response")
            yield EndOfResponse(
                turn_id=ctx.turn_id,
                turn_revision=ctx.turn_revision,
                cancel_generation=ctx.cancel_generation,
                error=f"Language model generation failed: {exc}",
            )
            return
        yield EndOfResponse(
            turn_id=ctx.turn_id,
            turn_revision=ctx.turn_revision,
            cancel_generation=ctx.cancel_generation,
        )

    def _count_output_tokens(self, raw_text: str) -> int:
        """Fallback token count when the backend didn't report usage."""
        return max(0, len(raw_text.split()))
