"""STT handler base: speculative-turn input/output gating.

Behavioral parity with reference ``STT/base_stt_handler.py``:

- drop any input for a ``(turn, revision)`` whose final already completed
  (LRU of 2048 completed revisions), purging stale queued inputs with it;
- drop progressive input when a final for the same revision is already
  queued behind it;
- finals wait out a **stability window** (Smart-Turn ``processing_delay_s``
  minus time already spent in the queue) before decoding;
- every input/output passes the pending-reopen gate.
"""

from __future__ import annotations

import logging
from collections import Counter, OrderedDict
from time import perf_counter
from typing import Any

from s2s_tpu_torch.pipeline.messages import PartialTranscription, Transcription, VADAudio
from s2s_tpu_torch.pipeline.turns import SpeculativeTurnTracker
from s2s_tpu_torch.runtime.base_handler import BaseHandler

logger = logging.getLogger(__name__)

_MAX_COMPLETED_FINALS = 2048


def _revision_key(item: object) -> tuple[str, int] | None:
    turn_id = getattr(item, "turn_id", None)
    revision = getattr(item, "turn_revision", None)
    if isinstance(turn_id, str) and isinstance(revision, int):
        return (turn_id, revision)
    return None


class BaseSTTHandler(BaseHandler):
    """Shared speculative gating for every STT backend."""

    speculative_turns: SpeculativeTurnTracker | None = None
    final_revision_settle_s: float = 0.0

    # ── input gate ───────────────────────────────────────────────────

    def should_process_input(self, item) -> bool:
        mode = getattr(item, "mode", None)
        if self._final_already_completed(item):
            dropped = self._purge_stale_queued()
            self._log_drop(item, "input-after-final", queued=dropped)
            return False
        if mode == "progressive" and self._final_queued_for(item):
            self._log_drop(item, "progressive-before-final")
            return False

        gate_start = perf_counter()
        latest = self._gate(item, stability=(mode == "final"))
        waited = perf_counter() - gate_start
        if waited >= 0.05:
            logger.info(
                "%s: input gate waited %.3fs (turn=%s rev=%s mode=%s latest=%s)",
                type(self).__name__, waited, getattr(item, "turn_id", None),
                getattr(item, "turn_revision", None), mode, latest,
            )
        if not latest:
            dropped = self._purge_stale_queued()
            self._log_drop(item, "input", queued=dropped)
            return False
        return True

    def should_emit_output(self, output) -> bool:
        if isinstance(output, PartialTranscription) and self._final_already_completed(output):
            self._log_drop(output, "output-after-final")
            return False
        if not self._gate(output, stability=False):
            self._log_drop(output, "output")
            return False
        return True

    def before_emit_output(self, output) -> None:
        if isinstance(output, Transcription):
            key = _revision_key(output)
            if key is not None:
                completed = self._completed_finals()
                completed[key] = None
                completed.move_to_end(key)
                while len(completed) > _MAX_COMPLETED_FINALS:
                    completed.popitem(last=False)

    # ── gating internals ─────────────────────────────────────────────

    def _gate(self, item, *, stability: bool) -> bool:
        if self.speculative_turns is None:
            return True
        key = _revision_key(item)
        if key is None:
            return True
        turn_id, revision = key
        if stability:
            # Honor the remaining Smart-Turn delay (minus queue age).
            remaining = max(0.0, getattr(item, "processing_delay_s", 0.0) - self._age_s(item))
            return self.speculative_turns.is_latest_after_stability_window(
                turn_id, revision, max(self.final_revision_settle_s, remaining)
            )
        return self.speculative_turns.is_latest_after_pending_reopen(turn_id, revision)

    def _purge_stale_queued(self) -> int:
        q = self.queue_in
        if self.speculative_turns is None or not hasattr(q, "mutex") or not hasattr(q, "queue"):
            return 0
        dropped = 0
        with q.mutex:
            kept: list[Any] = []
            while q.queue:
                item = q.queue.popleft()
                stale = isinstance(item, VADAudio) and (
                    self._final_already_completed(item)
                    or (item.mode == "progressive" and self._final_queued_locked(item))
                    or (
                        _revision_key(item) is not None
                        and not self.speculative_turns.is_latest(item.turn_id, item.turn_revision)
                    )
                )
                if stale:
                    dropped += 1
                else:
                    kept.append(item)
            q.queue.extend(kept)
            if dropped:
                q.not_full.notify_all()
        return dropped

    def _final_queued_for(self, item) -> bool:
        q = self.queue_in
        if not hasattr(q, "mutex") or not hasattr(q, "queue"):
            return False
        with q.mutex:
            return self._final_queued_locked(item)

    def _final_queued_locked(self, item) -> bool:
        key = _revision_key(item)
        if key is None:
            return False
        return any(
            isinstance(x, VADAudio) and x.mode == "final" and _revision_key(x) == key
            for x in self.queue_in.queue
        )

    def _completed_finals(self) -> "OrderedDict[tuple[str, int], None]":
        if not hasattr(self, "_completed_final_keys"):
            self._completed_final_keys: OrderedDict[tuple[str, int], None] = OrderedDict()
        return self._completed_final_keys

    def _final_already_completed(self, item) -> bool:
        key = _revision_key(item)
        return key is not None and key in self._completed_finals()

    def _age_s(self, item) -> float:
        created = getattr(item, "created_at_s", None)
        if not isinstance(created, float):
            return 0.0
        return max(0.0, perf_counter() - created)

    def _log_drop(self, item, stage: str, *, queued: int = 0) -> None:
        key = _revision_key(item)
        if key is None:
            return
        if not hasattr(self, "_drop_counts"):
            self._drop_counts: Counter[tuple[str, str, int]] = Counter()
        ck = (stage, *key)
        self._drop_counts[ck] += 1
        level = logging.INFO if self._drop_counts[ck] == 1 else logging.DEBUG
        suffix = f" (+{queued} queued)" if queued else ""
        logger.log(
            level, "%s: dropping stale STT %s for turn=%s rev=%s%s",
            type(self).__name__, stage, key[0], key[1], suffix,
        )

    def on_session_end(self) -> None:
        if hasattr(self, "_completed_final_keys"):
            self._completed_final_keys.clear()
