"""Lifecycle manager for stage handler threads.

One non-daemon thread per handler's ``run()`` loop; stopping sets every
handler's stop event (handlers also need ``PIPELINE_END`` in their input
queues to unblock promptly — the builder's shutdown path does that).
"""

from __future__ import annotations

import logging
import threading
from collections.abc import Sequence
from typing import Any

logger = logging.getLogger(__name__)

JOIN_TIMEOUT_S = 5.0


class ThreadManager:
    def __init__(self, handlers: Sequence[Any]) -> None:
        self._pairs: list[tuple[Any, threading.Thread]] = [
            (handler, threading.Thread(target=handler.run, name=type(handler).__name__, daemon=False))
            for handler in handlers
        ]

    @property
    def handlers(self) -> list[Any]:
        return [handler for handler, _ in self._pairs]

    @property
    def threads(self) -> list[threading.Thread]:
        return [thread for _, thread in self._pairs]

    def start(self) -> None:
        for _, thread in self._pairs:
            thread.start()

    def wait(self) -> None:
        for _, thread in self._pairs:
            thread.join()

    def stop(self, join_timeout_s: float = JOIN_TIMEOUT_S) -> None:
        for handler, _ in self._pairs:
            handler.stop_event.set()
        for _, thread in self._pairs:
            if not thread.is_alive():
                continue
            thread.join(timeout=join_timeout_s)
            if thread.is_alive():
                logger.warning("Thread %s did not terminate within %.1fs", thread.name, join_timeout_s)

    def __enter__(self) -> "ThreadManager":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()
