"""Speculative turn tracking.

The signature latency trick of the reference pipeline (reference
``pipeline/speculative_turns.py``, behavior spec'd by its
``tests/test_speculative_turns.py``): STT/LLM/TTS start working on a turn's
audio *immediately* at a soft end of speech, while the turn stays
*reopenable* — if the user resumes speaking, the turn is re-issued at a
higher **revision** and all in-flight work for older revisions is dropped at
well-defined gates.

A turn's lifecycle per revision:

- ``observe(turn, rev)`` — a stage saw this revision; the max becomes latest.
- *pending reopen candidate* — VAD saw speech probability fire again but has
  not yet confirmed a real continuation: downstream output must HOLD (gates
  return ``None``/block) until the candidate is confirmed (revision bump) or
  cancelled.
- *reopen grace* — a time window after a soft end during which the turn may
  be reopened; output-committing stages wait it out before going audible.
- ``commit`` — the first user-visible output commits the revision; a
  committed turn can no longer be reopened.

Everything is keyed on ``(turn_id, revision)``; ``None`` ids always pass the
gates (non-speculative messages flow untouched).

Implementation: one record per turn under a single condition variable —
functionally equivalent to the reference tracker but restructured (the
reference keeps four parallel dicts).
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from dataclasses import dataclass

logger = logging.getLogger(__name__)

from threading import Condition

#: How long a blocking gate waits for a pending reopen candidate to resolve
#: before force-clearing it (a stuck candidate must not wedge the pipeline).
PENDING_REOPEN_TIMEOUT_S = 2.0

DEFAULT_MAX_TRACKED_TURNS = 2048


@dataclass
class _Turn:
    """All speculative state for one turn id."""

    latest: int | None = None  # highest observed revision
    committed: int = -1  # highest committed revision
    pending_base: int | None = None  # reopen candidate: base revision
    pending_candidate: int | None = None  # reopen candidate: proposed revision
    grace_rev: int | None = None  # reopen-grace: guarded revision
    grace_deadline: float = 0.0  # reopen-grace: monotonic deadline

    def effective_latest(self, revision: int) -> int:
        return self.latest if self.latest is not None else revision

    def has_pending(self, revision: int) -> bool:
        return self.pending_base == revision


class SpeculativeTurnTracker:
    """Thread-safe ``turn_id -> revision`` tracker with reopen candidates,
    reopen grace windows and commit records."""

    def __init__(self, max_tracked_turns: int = DEFAULT_MAX_TRACKED_TURNS) -> None:
        self._cv = Condition()
        self._max_tracked = max_tracked_turns
        self._turns: OrderedDict[str, _Turn] = OrderedDict()

    # ── basic observation ────────────────────────────────────────────

    def observe(self, turn_id: str | None, revision: int | None) -> None:
        if turn_id is None or revision is None:
            return
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is None:
                rec = _Turn()
                self._turns[turn_id] = rec
            if rec.latest is None or revision > rec.latest:
                rec.latest = revision
                self._turns.move_to_end(turn_id)
                self._prune()
                self._cv.notify_all()

    def is_latest(self, turn_id: str | None, revision: int | None) -> bool:
        if turn_id is None or revision is None:
            return True
        with self._cv:
            return self._is_latest(turn_id, revision)

    # ── reopen candidates ────────────────────────────────────────────

    def begin_reopen_candidate(self, turn_id: str | None, revision: int | None) -> int | None:
        """Propose reopening *revision*; returns the candidate revision
        (``revision + 1``) or ``None`` when the turn cannot be reopened."""
        if turn_id is None or revision is None:
            return None
        with self._cv:
            rec = self._turns.setdefault(turn_id, _Turn())
            if rec.committed >= revision:
                return None
            if rec.effective_latest(revision) != revision:
                return None
            if rec.pending_base is not None:
                # Only one candidate at a time; re-request for same base is idempotent.
                return rec.pending_candidate if rec.pending_base == revision else None
            rec.pending_base = revision
            rec.pending_candidate = revision + 1
            logger.debug("reopen candidate %s: %d -> %d", turn_id, revision, revision + 1)
            self._cv.notify_all()
            return rec.pending_candidate

    def confirm_reopen_candidate(
        self, turn_id: str | None, base_revision: int | None, candidate_revision: int | None
    ) -> bool:
        """Real speech continuation confirmed: bump the turn to the candidate."""
        if turn_id is None or base_revision is None or candidate_revision is None:
            return False
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is None or rec.pending_base != base_revision or rec.pending_candidate != candidate_revision:
                return False
            rec.pending_base = rec.pending_candidate = None
            ok = rec.committed < base_revision and rec.effective_latest(base_revision) == base_revision
            if ok:
                rec.latest = candidate_revision
                self._turns.move_to_end(turn_id)
                logger.debug("reopen confirmed %s -> rev %d", turn_id, candidate_revision)
            self._prune()
            self._cv.notify_all()
            return ok

    def cancel_reopen_candidate(self, turn_id: str | None, candidate_revision: int | None = None) -> None:
        if turn_id is None:
            return
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is None or rec.pending_base is None:
                return
            if candidate_revision is not None and rec.pending_candidate != candidate_revision:
                return
            rec.pending_base = rec.pending_candidate = None
            self._prune()
            self._cv.notify_all()

    def has_pending_reopen(self, turn_id: str | None, revision: int | None) -> bool:
        if turn_id is None or revision is None:
            return False
        with self._cv:
            rec = self._turns.get(turn_id)
            return rec is not None and rec.has_pending(revision)

    def has_pending_reopen_or_grace(self, turn_id: str | None, revision: int | None) -> bool:
        if turn_id is None or revision is None:
            return False
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is None:
                return False
            return rec.has_pending(revision) or self._grace_remaining(turn_id, rec, revision) > 0

    # ── reopen grace windows ─────────────────────────────────────────

    def start_reopen_grace(self, turn_id: str | None, revision: int | None, grace_s: float) -> None:
        if turn_id is None or revision is None or grace_s <= 0:
            return
        with self._cv:
            rec = self._turns.setdefault(turn_id, _Turn())
            if rec.effective_latest(revision) != revision or rec.committed >= revision:
                return
            deadline = time.monotonic() + grace_s
            if rec.grace_rev != revision or deadline > rec.grace_deadline:
                rec.grace_rev, rec.grace_deadline = revision, deadline
                self._cv.notify_all()

    # ── gates (blocking + non-blocking) ──────────────────────────────

    def is_latest_after_pending_reopen(self, turn_id: str | None, revision: int | None) -> bool:
        if turn_id is None or revision is None:
            return True
        with self._cv:
            self._await_pending(turn_id, revision, PENDING_REOPEN_TIMEOUT_S)
            return self._is_latest(turn_id, revision)

    def try_is_latest_after_pending_reopen(self, turn_id: str | None, revision: int | None) -> bool | None:
        """Non-blocking: ``None`` means "a reopen candidate is pending, retry"."""
        if turn_id is None or revision is None:
            return True
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is not None and rec.has_pending(revision):
                return None
            return self._is_latest(turn_id, revision)

    def is_latest_after_reopen_grace(self, turn_id: str | None, revision: int | None) -> bool:
        if turn_id is None or revision is None:
            return True
        with self._cv:
            self._await_reopen_gate(turn_id, revision)
            return self._is_latest(turn_id, revision)

    def try_is_latest_after_reopen_grace(self, turn_id: str | None, revision: int | None) -> bool | None:
        if turn_id is None or revision is None:
            return True
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is not None and (
                rec.has_pending(revision) or self._grace_remaining(turn_id, rec, revision) > 0
            ):
                return None
            return self._is_latest(turn_id, revision)

    def is_latest_after_stability_window(
        self, turn_id: str | None, revision: int | None, settle_s: float
    ) -> bool:
        """Wait *settle_s* of wall clock while the revision stays latest (used
        by STT to honor Smart-Turn ``processing_delay_s``)."""
        if turn_id is None or revision is None:
            return True
        if settle_s <= 0:
            return self.is_latest_after_pending_reopen(turn_id, revision)
        with self._cv:
            deadline = time.monotonic() + settle_s
            while self._is_latest(turn_id, revision):
                rec = self._turns.get(turn_id)
                if rec is not None and rec.has_pending(revision):
                    self._await_pending(turn_id, revision, PENDING_REOPEN_TIMEOUT_S)
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            return self._is_latest(turn_id, revision)

    def wait_for_pending_reopen(
        self, turn_id: str | None, revision: int | None, timeout_s: float = PENDING_REOPEN_TIMEOUT_S
    ) -> None:
        if turn_id is None or revision is None:
            return
        with self._cv:
            self._await_pending(turn_id, revision, timeout_s)

    # ── commit ───────────────────────────────────────────────────────

    def commit(self, turn_id: str | None, revision: int | None) -> None:
        """Record *revision* as committed (deferred while its reopen candidate
        is pending — the candidate resolution decides the turn's fate)."""
        if turn_id is None or revision is None:
            return
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is not None and rec.has_pending(revision):
                return
            self._commit(turn_id, revision)

    def commit_if_latest_after_pending_reopen(self, turn_id: str | None, revision: int | None) -> bool:
        if turn_id is None or revision is None:
            return True
        with self._cv:
            self._await_pending(turn_id, revision, PENDING_REOPEN_TIMEOUT_S)
            return self._commit(turn_id, revision)

    def commit_if_latest_after_reopen_grace(self, turn_id: str | None, revision: int | None) -> bool:
        if turn_id is None or revision is None:
            return True
        with self._cv:
            self._await_reopen_gate(turn_id, revision)
            return self._commit(turn_id, revision)

    def try_commit_if_latest_after_pending_reopen(
        self, turn_id: str | None, revision: int | None
    ) -> bool | None:
        if turn_id is None or revision is None:
            return True
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is not None and rec.has_pending(revision):
                return None
            return self._commit(turn_id, revision)

    def try_commit_if_latest_after_reopen_grace(
        self, turn_id: str | None, revision: int | None
    ) -> bool | None:
        if turn_id is None or revision is None:
            return True
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is not None and (
                rec.has_pending(revision) or self._grace_remaining(turn_id, rec, revision) > 0
            ):
                return None
            return self._commit(turn_id, revision)

    def is_committed(self, turn_id: str | None, revision: int | None = None) -> bool:
        if turn_id is None:
            return False
        with self._cv:
            rec = self._turns.get(turn_id)
            if rec is None or rec.committed < 0:
                return False
            return revision is None or rec.committed >= revision

    def reset(self) -> None:
        with self._cv:
            self._turns.clear()
            self._cv.notify_all()

    # ── internals (all called with the condition held) ───────────────

    def _is_latest(self, turn_id: str, revision: int) -> bool:
        rec = self._turns.get(turn_id)
        return rec is None or rec.effective_latest(revision) == revision

    def _commit(self, turn_id: str, revision: int) -> bool:
        """Returns whether output for *revision* is still valid to emit.

        An untracked/unknown-latest turn deliberately commits as valid without
        recording — dropping output the tracker no longer knows about would be
        worse than emitting it, and recording it would leak records past the
        prune walk (reference ``speculative_turns.py::_commit_locked``)."""
        rec = self._turns.get(turn_id)
        if rec is None or rec.latest is None:
            return True
        if revision != rec.latest:
            return False
        rec.committed = max(rec.committed, revision)
        self._cv.notify_all()
        return True

    def _grace_remaining(self, turn_id: str, rec: _Turn, revision: int) -> float:
        if rec.grace_rev != revision:
            return 0.0
        if rec.effective_latest(revision) != revision:
            rec.grace_rev = None
            return 0.0
        remaining = rec.grace_deadline - time.monotonic()
        if remaining <= 0:
            rec.grace_rev = None
            self._prune()
            return 0.0
        return remaining

    def _await_reopen_gate(self, turn_id: str, revision: int) -> None:
        """Wait out pending reopen candidates AND any active grace window,
        as long as the revision is still the latest."""
        while self._is_latest(turn_id, revision):
            self._await_pending(turn_id, revision, PENDING_REOPEN_TIMEOUT_S)
            if not self._is_latest(turn_id, revision):
                return
            rec = self._turns.get(turn_id)
            remaining = 0.0 if rec is None else self._grace_remaining(turn_id, rec, revision)
            if remaining <= 0:
                return
            self._cv.wait(remaining)

    def _await_pending(self, turn_id: str, revision: int, timeout_s: float) -> None:
        rec = self._turns.get(turn_id)
        if rec is None or not rec.has_pending(revision):
            return
        deadline = time.monotonic() + timeout_s
        while rec.has_pending(revision):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                logger.warning("pending reopen timed out: turn=%s rev=%s", turn_id, revision)
                rec.pending_base = rec.pending_candidate = None
                self._prune()
                self._cv.notify_all()
                return
            self._cv.wait(remaining)
            rec = self._turns.get(turn_id)
            if rec is None:
                return

    def _prune(self) -> None:
        if self._max_tracked <= 0:
            return
        now = time.monotonic()
        for rec in self._turns.values():
            if rec.grace_rev is not None and (
                rec.grace_deadline <= now
                or (rec.latest is not None and rec.latest != rec.grace_rev)
            ):
                rec.grace_rev = None
        prunable = [
            tid
            for tid, rec in self._turns.items()
            if rec.latest is not None and rec.pending_base is None and rec.grace_rev is None
        ]
        excess = len(prunable) - self._max_tracked
        for tid in prunable[: max(0, excess)]:
            self._turns.pop(tid, None)
