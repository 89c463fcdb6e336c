"""Cancellation + in-band control messages for the pipeline.

Semantics mirror the reference (``pipeline/cancel_scope.py``,
``pipeline/control.py``): a generation counter for barge-in cancellation
readable lock-free from every stage thread, and a ``SESSION_END`` control
message that travels the whole handler chain as a soft per-session reset.

Design note (TPU): cancellation of on-device work is achieved by *not
issuing the next step* — decode loops are one-step-at-a-time jitted calls,
so the per-token staleness check of the reference maps 1:1 onto "check
``is_stale`` before dispatching the next jitted step".
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

_GEN_MASK = 0xFFFFFFFF


class CancelScope:
    """Barge-in cancellation: generation counter + discard guard.

    One writer (the async send loop), many readers (stage threads).  Plain
    int/bool attribute access is GIL-atomic, so no lock is required — the
    same discipline the reference documents in ``cancel_scope.py:8-11``.
    """

    def __init__(self) -> None:
        self._gen = 0
        self._discarding = False
        self._cancelled_gen: int | None = None

    @property
    def generation(self) -> int:
        """Generation captured by stage threads at response start."""
        return self._gen

    def is_stale(self, gen: int | None) -> bool:
        """True when *gen* was superseded by :meth:`cancel`."""
        return gen is not None and gen != self._gen

    @property
    def discarding(self) -> bool:
        """Whether the send loop should silently drop stale output."""
        return self._discarding

    def cancel(self) -> None:
        """Supersede the current response: bump the generation and start
        discarding queued output produced under the old generation."""
        self._cancelled_gen = self._gen
        self._gen = (self._gen + 1) & _GEN_MASK
        self._discarding = True

    def response_done(self, generation: int | None = None) -> None:
        """A response finished draining; clear the discard guard.

        When *generation* is given and belongs neither to the cancelled nor
        the current generation, the ack is ignored (it is a leftover from an
        older response and must not clear the guard early).
        """
        if (
            generation is not None
            and self._cancelled_gen is not None
            and generation not in (self._cancelled_gen, self._gen)
        ):
            return
        self._discarding = False
        self._cancelled_gen = None

    def new_response(self) -> None:
        """An explicit ``response.create`` begins; stop discarding."""
        self._discarding = False
        self._cancelled_gen = None

    # Alias used on fresh session claim.
    reset = new_response


class ControlKind(str, Enum):
    SESSION_END = "session_end"


@dataclass(frozen=True)
class PipelineControl:
    """In-band control message traveling stage-to-stage through the queues."""

    kind: ControlKind
    # Originating session, when known: lets the pooled send loop ignore a
    # SESSION_END that belongs to a force-released previous session.
    session_id: str | None = None


SESSION_END = PipelineControl(ControlKind.SESSION_END)


def is_control(message: object, kind: ControlKind | None = None) -> bool:
    return isinstance(message, PipelineControl) and (kind is None or message.kind == kind)
