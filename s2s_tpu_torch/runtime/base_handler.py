"""Threaded stage handler base (semantics of reference ``baseHandler.py``).

Each stage runs one host thread: pull from ``queue_in`` (0.1 s poll so the
stop event is honored), route control messages, feed typed items through the
``process()`` generator, and push yielded outputs to ``queue_out``.  Model
weights do NOT live on the handler: handlers receive a shared jitted model /
step function via the fake-model seam so the whole pipeline is testable
modelless on CPU (reference test strategy, SURVEY §4).

Stage threads overlap naturally: jitted dispatch releases the GIL during XLA
execution, and on-device ordering is governed by
:mod:`s2s_tpu_torch.runtime.device_scheduler`, not by who holds the GIL.
"""

from __future__ import annotations

import logging
from queue import Empty, Queue
from threading import Event
from time import perf_counter
from typing import Any, Generic, Iterator, TypeVar, cast

import numpy as np

from s2s_tpu_torch.pipeline.control import SESSION_END, PipelineControl, is_control
from s2s_tpu_torch.pipeline.log_context import pipeline_log_ctx
from s2s_tpu_torch.pipeline.messages import PIPELINE_END, AudioOutput, EndOfResponse

logger = logging.getLogger(__name__)

InT = TypeVar("InT")
OutT = TypeVar("OutT")


class BaseHandler(Generic[InT, OutT]):
    """A pipeline stage: ``queue_in`` -> ``process()`` -> ``queue_out``.

    Lifecycle: ``setup()`` runs at construction (model/warmup happens at
    build time so first-turn latency is flat); ``PIPELINE_END`` in the input
    queue unblocks and stops the thread; ``SESSION_END`` soft-resets
    per-session state via :meth:`on_session_end` and is forwarded downstream.
    """

    def __init__(
        self,
        stop_event: Event,
        queue_in: "Queue[Any]",
        queue_out: "Queue[Any]",
        setup_args: tuple[Any, ...] = (),
        setup_kwargs: dict[str, Any] | None = None,
    ) -> None:
        self.stop_event = stop_event
        self.queue_in = queue_in
        self.queue_out = queue_out
        self.pipeline_index: int | None = None
        self._times: list[float] = []
        self.setup(*setup_args, **(setup_kwargs or {}))

    # ── overridables ─────────────────────────────────────────────────

    def setup(self, *args: Any, **kwargs: Any) -> None:
        pass

    def process(self, item: InT) -> Iterator[OutT]:
        raise NotImplementedError

    def cleanup(self) -> None:
        pass

    def on_session_end(self) -> None:
        pass

    def should_process_input(self, item: InT) -> bool:
        """Default stale-input gate: drop items tagged with a superseded
        cancel generation (EndOfResponse always passes for cleanup)."""
        cancel_scope = getattr(self, "cancel_scope", None)
        gen = getattr(item, "cancel_generation", None)
        if (
            cancel_scope is not None
            and gen is not None
            and not isinstance(item, EndOfResponse)
            and cancel_scope.is_stale(gen)
        ):
            logger.debug("%s: dropping stale input (gen %s)", type(self).__name__, gen)
            return False
        return True

    def should_emit_output(self, output: OutT) -> bool:
        return True

    def before_emit_output(self, output: OutT) -> None:
        pass

    def output_for_queue(self, output: OutT, source: InT) -> Any:
        """Wrap raw audio outputs with the generation that produced them."""
        gen = getattr(source, "cancel_generation", None)
        if gen is not None and (isinstance(output, bytes) or hasattr(output, "tobytes")):
            return AudioOutput(audio=cast("bytes | np.ndarray", output), cancel_generation=gen)
        return output

    # ── timing knobs (class attributes; stages override as needed) ───
    min_time_to_debug: float = 0.001
    timing_log_level: int = logging.DEBUG

    @property
    def last_time(self) -> float:
        return self._times[-1]

    def should_log_timing(self, output: OutT) -> bool:
        return self.last_time > self.min_time_to_debug

    # ── main loop ────────────────────────────────────────────────────

    def run(self) -> None:
        if self.pipeline_index is not None:
            pipeline_log_ctx.set(f"[pipeline {self.pipeline_index}]")
        logger.debug("%s: handler thread started", type(self).__name__)
        while not self.stop_event.is_set():
            try:
                item = self.queue_in.get(timeout=0.1)
            except Empty:
                continue

            if is_control(item, SESSION_END.kind):
                try:
                    self.on_session_end()
                except Exception:
                    logger.exception("%s: error in on_session_end()", type(self).__name__)
                self.queue_out.put(item)
                continue

            if isinstance(item, bytes) and item == PIPELINE_END:
                logger.debug("%s: stopping thread", type(self).__name__)
                break

            if isinstance(item, PipelineControl):
                logger.warning("%s: unexpected control message: %s", type(self).__name__, item.kind)
                continue

            typed = cast(InT, item)
            if not self.should_process_input(typed):
                continue

            start = perf_counter()
            try:
                for output in self.process(typed):
                    if not self.should_emit_output(output):
                        start = perf_counter()
                        continue
                    self._times.append(perf_counter() - start)
                    if self.should_log_timing(output):
                        logger.log(
                            self.timing_log_level, "%s: %.3f s", type(self).__name__, self.last_time
                        )
                    self.before_emit_output(output)
                    self.queue_out.put(self.output_for_queue(output, typed))
                    start = perf_counter()
            except Exception:
                # Keep the stage thread alive through any process() failure.
                logger.exception("%s: error in process()", type(self).__name__)

        self.cleanup()
        self.queue_out.put(PIPELINE_END)
