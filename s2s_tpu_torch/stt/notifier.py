"""STT -> service bridge (reference ``STT/transcription_notifier.py``).

Re-emits partial/final transcriptions as protocol-neutral events on the
side channel.  The notifier NEVER forwards to the LLM itself — the realtime
service owns the chat write and ``GenerateResponseRequest`` creation.
Empty finals re-enable listening and never trigger a response.
"""

from __future__ import annotations

import logging
from queue import Queue
from threading import Event
from typing import Any, Iterator

from s2s_tpu_torch.pipeline.events import PartialTranscriptionEvent, TranscriptionCompletedEvent
from s2s_tpu_torch.pipeline.messages import PartialTranscription, Transcription
from s2s_tpu_torch.runtime.base_handler import BaseHandler

logger = logging.getLogger(__name__)


class TranscriptionNotifier(BaseHandler):
    def setup(
        self,
        text_output_queue: "Queue[Any] | None" = None,
        should_listen: Event | None = None,
    ) -> None:
        self.text_output_queue = text_output_queue
        self.should_listen = should_listen

    def process(self, item) -> Iterator[Any]:
        if isinstance(item, PartialTranscription):
            if self.text_output_queue and item.text:
                self.text_output_queue.put(
                    PartialTranscriptionEvent(
                        delta=str(item.text),
                        turn_id=item.turn_id,
                        turn_revision=item.turn_revision,
                    )
                )
            return

        if isinstance(item, Transcription):
            text, language = item.text, item.language_code
            turn_id, revision = item.turn_id, item.turn_revision
            stopped_at = item.speech_stopped_at_s
        else:  # plain string from minimal backends
            text, language, turn_id, revision, stopped_at = item, None, None, None, None

        transcript = str(text)
        # Always close the client-visible transcription item — partial deltas
        # may already be on the wire even when the final is empty.
        if self.text_output_queue is not None:
            self.text_output_queue.put(
                TranscriptionCompletedEvent(
                    transcript=transcript,
                    language_code=language,
                    turn_id=turn_id,
                    turn_revision=revision,
                    speech_stopped_at_s=stopped_at,
                )
            )
        if not transcript:
            if self.should_listen is not None:
                self.should_listen.set()
                logger.debug("Empty transcription; listening re-enabled")
            return
        logger.info("Transcription completed%s: %s", f" ({language})" if language else "", transcript)
        yield from ()
