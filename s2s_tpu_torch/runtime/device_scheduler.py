"""Priority admission control for TPU compute dispatch.

The reference serializes accelerator access with ad-hoc locks (a global MLX
RLock, a transformers lock, Parakeet's ``compute_lock`` with a 0.01 s
progressive / 5 s final timeout — reference ``utils/mlx_lock.py``,
``parakeet_tdt_handler.py:129,266``).  On TPU the chip executes one program
at a time anyway (XLA streams are ordered), so what matters is *which work we
dispatch next*.  This scheduler makes the implicit priority explicit:

- ``REALTIME``  — the 32 ms VAD tick; must never wait behind bulk work.
- ``INTERACTIVE`` — final STT, LLM decode, TTS synthesis: the latency chain.
- ``PROGRESSIVE`` — live-transcription re-decodes; preemptible.
- ``BACKGROUND`` — chat compaction and other best-effort work.

Holders of low lanes should structure work as short steps and call
:meth:`should_yield` between steps (one jitted decode step each), releasing
when higher-priority work is waiting — the same drop-and-retry pattern the
reference expresses with its 0.01 s lock timeout.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from enum import IntEnum
from typing import Iterator


class Lane(IntEnum):
    BACKGROUND = 0
    PROGRESSIVE = 1
    INTERACTIVE = 2
    REALTIME = 3


class DeviceScheduler:
    """Mutual exclusion over compute dispatch with lane priorities."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._holder_lane: Lane | None = None
        self._holder_count = 0  # re-entrant for the same thread
        self._holder_thread: int | None = None
        self._waiting: list[int] = [0, 0, 0, 0]
        #: optional bridge to the batched engines' PriorityGate
        #: (``parallel.session_scheduler``): while an INTERACTIVE slot is
        #: held — final STT in the serving config; the batched LLM/TTS
        #: paths bypass their slots — the engines' steady full-batch
        #: chunks hold back so the latency chain's next dispatch finds a
        #: shallow device queue.  Wired by the registry when batched
        #: engines are built; REALTIME (the 32 ms VAD tick) is deliberately
        #: NOT bridged — it is near-continuous and would pin the gate shut.
        self.priority_gate = None
        self._gate_key: object | None = None

    def acquire(self, lane: Lane, timeout: float | None = None) -> bool:
        """Acquire the dispatch slot. Returns False on timeout.

        A waiter is admitted when the slot is free AND no higher-priority
        waiter is queued (higher lanes barge ahead of lower ones).
        """
        me = threading.get_ident()
        with self._cv:
            if self._holder_thread == me:
                self._holder_count += 1
                return True
            self._waiting[lane] += 1
            try:
                deadline = None if timeout is None else (threading.TIMEOUT_MAX if timeout < 0 else timeout)
                import time

                until = None if deadline is None else time.monotonic() + deadline
                while True:
                    higher_waiting = any(self._waiting[la] for la in Lane if la > lane)
                    if self._holder_lane is None and not higher_waiting:
                        self._holder_lane = lane
                        self._holder_count = 1
                        self._holder_thread = me
                        if lane == Lane.INTERACTIVE and self.priority_gate is not None:
                            self._gate_key = object()
                            self.priority_gate.enter(self._gate_key)
                        return True
                    if until is None:
                        self._cv.wait()
                    else:
                        remaining = until - time.monotonic()
                        if remaining <= 0:
                            return False
                        self._cv.wait(remaining)
            finally:
                self._waiting[lane] -= 1

    def release(self) -> None:
        with self._cv:
            if self._holder_thread != threading.get_ident():
                raise RuntimeError("release() by non-holder thread")
            self._holder_count -= 1
            if self._holder_count == 0:
                self._holder_lane = None
                self._holder_thread = None
                if self._gate_key is not None and self.priority_gate is not None:
                    self.priority_gate.exit(self._gate_key)
                self._gate_key = None
                self._cv.notify_all()

    def should_yield(self, lane: Lane) -> bool:
        """True when work above *lane* is waiting — release between steps."""
        return any(self._waiting[la] for la in Lane if la > lane)

    @contextmanager
    def slot(self, lane: Lane, timeout: float | None = None) -> Iterator[bool]:
        ok = self.acquire(lane, timeout)
        try:
            yield ok
        finally:
            if ok:
                self.release()


#: Process-wide default scheduler: all sessions share one chip's dispatch.
GLOBAL_SCHEDULER = DeviceScheduler()
