"""LLM -> TTS tee (reference ``LLM/lm_output_processor.py``).

Fans LLM output to the side channel (assistant text / tool calls / token
usage / failures) and forwards ``TTSInput`` downstream only for
audio-wanting responses.  All emissions are reopen-grace gated.
"""

from __future__ import annotations

import logging
from queue import Queue
from typing import Any, Iterator

from s2s_tpu_torch.pipeline.events import AssistantTextEvent, ResponseFailedEvent, TokenUsageEvent
from s2s_tpu_torch.pipeline.messages import (
    EndOfResponse,
    LLMResponseChunk,
    SpeculativeTTSText,
    TokenUsage,
    TTSInput,
)
from s2s_tpu_torch.pipeline.turns import SpeculativeTurnTracker
from s2s_tpu_torch.runtime.base_handler import BaseHandler
from s2s_tpu_torch.utils.common import response_wants_audio

logger = logging.getLogger(__name__)


class LMOutputProcessor(BaseHandler):
    def setup(
        self,
        text_output_queue: "Queue[Any] | None" = None,
        speculative_turns: SpeculativeTurnTracker | None = None,
    ) -> None:
        self.text_output_queue = text_output_queue
        self.speculative_turns = speculative_turns

    def _allowed(self, turn_id, revision) -> bool:
        if self.speculative_turns is None:
            return True
        return self.speculative_turns.is_latest_after_reopen_grace(turn_id, revision)

    def process(self, item) -> Iterator[Any]:
        if isinstance(item, SpeculativeTTSText):
            # whole-chain speculation: straight to TTS, never to the client;
            # a superseded turn's speculation is pointless — drop it
            if self.speculative_turns is None or self.speculative_turns.is_latest(
                item.turn_id, item.turn_revision
            ):
                yield item
            return

        if isinstance(item, TokenUsage):
            if not self._allowed(item.turn_id, item.turn_revision):
                return
            if self.text_output_queue is not None:
                self.text_output_queue.put(
                    TokenUsageEvent(
                        input_tokens=item.input_tokens or 0,
                        output_tokens=item.output_tokens or 0,
                        turn_id=item.turn_id,
                        turn_revision=item.turn_revision,
                    )
                )
            return

        if isinstance(item, EndOfResponse):
            if not self._allowed(item.turn_id, item.turn_revision):
                return
            # A failed generation closes the response as "failed" on the side
            # channel, then still emits the normal EndOfResponse so the audio
            # path re-enables listening / releases the slot.
            if item.error and self.text_output_queue is not None:
                self.text_output_queue.put(
                    ResponseFailedEvent(
                        message=item.error, turn_id=item.turn_id, turn_revision=item.turn_revision
                    )
                )
            yield EndOfResponse(
                turn_id=item.turn_id,
                turn_revision=item.turn_revision,
                cancel_generation=item.cancel_generation,
            )
            return

        if not isinstance(item, LLMResponseChunk):
            logger.warning("LMOutputProcessor: unexpected type %s", type(item))
            return

        if not self._allowed(item.turn_id, item.turn_revision):
            logger.debug("Dropping stale LLM chunk turn=%s rev=%s", item.turn_id, item.turn_revision)
            return

        if self.text_output_queue is not None:
            self.text_output_queue.put(
                AssistantTextEvent(
                    text=item.text,
                    tools=item.tools,
                    turn_id=item.turn_id,
                    turn_revision=item.turn_revision,
                    cancel_generation=item.cancel_generation,
                )
            )

        if item.text and response_wants_audio(item.response):
            yield TTSInput(
                text=item.text,
                language_code=item.language_code,
                runtime_config=item.runtime_config,
                response=item.response,
                turn_id=item.turn_id,
                turn_revision=item.turn_revision,
                speech_stopped_at_s=item.speech_stopped_at_s,
                cancel_generation=item.cancel_generation,
            )
