"""The turn-taking brain: VAD stage handler.

Behavioral parity with reference ``VAD/vad_handler.py`` (845 lines — the
subtlest component in the cascade).  Responsibilities:

- stream 512-sample chunks through the (JAX) Silero model via the iterator;
- **deferred speech_started**: emitted only once >= ``min_speech_ms``
  (384 ms) of active speech accumulates, with a lower continuation
  hysteresis (192 ms) when speech resumes a reopenable turn;
- **progressive audio release** every ~0.5 s (interval grows with segment
  length) feeding live STT;
- **short-segment hold/stitch**: fragments with >= 100 ms active speech but
  below the start threshold are held and merged with the next fragment
  within the merge window (silence gap re-inserted);
- **speculative turn lifecycle**: new turn / pending reopen candidate on a
  start-candidate / confirm on actual start / reopen grace after soft end;
  accumulated audio prefix re-emitted on reopen;
- **Smart Turn** on each soft end deciding (reopen_grace_ms,
  processing_delay_ms);
- superseded-drop of queued progressive audio; live ``session.update``
  turn-detection changes; ``should_listen`` gate; once-per-second summary
  logging; optional injectable enhancement hook (DeepFilterNet equivalent).

Model seam: the iterator's model is injected (JAX Silero in production,
scripted fakes in tests).

The port's copy of ``s2s_tpu/vad/handler.py``, trimmed of one lazy
branch: the default Silero model when no ``model`` is given raises (Silero
is not ported, ROADMAP queue 1 item 3); the port's builder passes
``EnergyVAD``.  ``setup`` also takes the ``device`` the Smart Turn analyzer
it builds runs on.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from queue import Queue
from threading import Event
from typing import Any, Callable, Iterator

import numpy as np

from s2s_tpu_torch.audio.pcm import int16_to_float32
from s2s_tpu_torch.pipeline.events import SpeechStartedEvent, SpeechStoppedEvent
from s2s_tpu_torch.pipeline.messages import VADAudio
from s2s_tpu_torch.pipeline.turns import SpeculativeTurnTracker
from s2s_tpu_torch.realtime.config import RuntimeConfig
from s2s_tpu_torch.runtime.base_handler import BaseHandler
from s2s_tpu_torch.vad.iterator import VADIterator

logger = logging.getLogger(__name__)

#: Minimum active speech for a fragment to participate in hold/stitch at
#: all — keeps a string of sub-threshold noise bursts from accumulating
#: into a phantom speech start.
NOISE_FLOOR_MS = 100


@dataclass
class _HeldSegment:
    audio: np.ndarray
    active_ms: float
    start_ms: int
    end_ms: int


class TurnLedger:
    """Turn-id/revision bookkeeping for the VAD side of speculative turns."""

    def __init__(self, tracker: SpeculativeTurnTracker) -> None:
        self.tracker = tracker
        self.counter = 0
        self.turn_id: str | None = None
        self.revision: int | None = None
        self.pending: tuple[str, int, int] | None = None  # (turn, base, candidate)
        self.audio_prefix: np.ndarray | None = None  # enhanced, for STT
        self.raw_prefix: np.ndarray | None = None  # raw, for Smart Turn
        self.last_final_audio_ms: int | None = None

    def start_new(self) -> tuple[str, int]:
        self.cancel_pending()
        self.counter += 1
        self.turn_id = f"turn_{self.counter}"
        self.revision = 0
        self.audio_prefix = None
        self.raw_prefix = None
        self.last_final_audio_ms = None
        self.tracker.observe(self.turn_id, self.revision)
        return self.turn_id, self.revision

    def reopenable(self, audio_start_ms: int, window_ms: int) -> bool:
        """Uncommitted turns stay reopenable while the *audio clock* is within
        *window_ms* of the last final (gaps in client streaming freeze it)."""
        if self.turn_id is None or self.revision is None or self.last_final_audio_ms is None:
            return False
        if self.tracker.is_committed(self.turn_id, self.revision):
            return False
        return max(0, audio_start_ms - self.last_final_audio_ms) <= window_ms

    def begin_pending(self, audio_start_ms: int, window_ms: int) -> None:
        if self.pending is not None or not self.reopenable(audio_start_ms, window_ms):
            return
        cand = self.tracker.begin_reopen_candidate(self.turn_id, self.revision)
        if cand is None or self.turn_id is None or self.revision is None:
            return
        self.pending = (self.turn_id, self.revision, cand)
        logger.info("VAD: pending reopen candidate %s rev %d", self.turn_id, cand)

    def cancel_pending(self) -> None:
        if self.pending is None:
            return
        turn_id, _, cand = self.pending
        self.tracker.cancel_reopen_candidate(turn_id, cand)
        self.pending = None

    def confirm_pending(self) -> tuple[str, int, bool] | None:
        if self.pending is None:
            return None
        turn_id, base, cand = self.pending
        self.pending = None
        if not self.tracker.confirm_reopen_candidate(turn_id, base, cand):
            return None
        self.turn_id, self.revision = turn_id, cand
        logger.info("VAD: reopened turn %s rev %d", turn_id, cand)
        return turn_id, cand, True

    def reopen_now(self) -> tuple[str, int, bool] | None:
        """Begin+confirm in one motion (no pending phase)."""
        if self.turn_id is None or self.revision is None:
            return None
        cand = self.tracker.begin_reopen_candidate(self.turn_id, self.revision)
        if cand is None or not self.tracker.confirm_reopen_candidate(self.turn_id, self.revision, cand):
            return None
        self.turn_id, self.revision = self.turn_id, cand
        self.revision = cand
        logger.info("VAD: reopened turn %s rev %d", self.turn_id, cand)
        return self.turn_id, cand, True

    def with_prefix(self, segment: np.ndarray) -> np.ndarray:
        if self.audio_prefix is None:
            return segment
        return np.concatenate((self.audio_prefix, segment))

    def with_raw_prefix(self, segment: np.ndarray) -> np.ndarray:
        if self.raw_prefix is None:
            return segment.copy()
        return np.concatenate((self.raw_prefix, segment))

    def record_final(self, enhanced: np.ndarray, raw: np.ndarray, end_ms: int) -> None:
        self.audio_prefix = enhanced
        self.raw_prefix = raw
        self.last_final_audio_ms = end_ms

    def reset(self) -> None:
        self.counter = 0
        self.turn_id = None
        self.revision = None
        self.pending = None
        self.audio_prefix = None
        self.raw_prefix = None
        self.last_final_audio_ms = None
        self.tracker.reset()


class VADHandler(BaseHandler):
    """Voice activity detection + turn-taking stage."""

    def setup(
        self,
        should_listen: Event,
        speculative_turns: SpeculativeTurnTracker,
        thresh: float = 0.6,
        sample_rate: int = 16000,
        min_silence_ms: int = 64,
        min_speech_ms: int = 384,
        min_speech_continuation_ms: int = 192,
        max_speech_ms: float = float("inf"),
        speech_pad_ms: int = 30,
        enable_realtime_transcription: bool = False,
        realtime_processing_pause: float = 0.5,
        text_output_queue: "Queue[Any] | None" = None,
        speculative_reopen_ms: int = 800,
        unanswered_reopen_ms: int = 7000,
        short_segment_merge_ms: int = 0,
        smart_turn: bool = True,
        smart_turn_threshold: float = 0.5,
        smart_turn_max_wait_ms: int = 2000,
        smart_turn_incomplete_delay_ms: int = 600,
        model: Callable[..., float] | None = None,
        smart_turn_analyzer: Any | None = None,
        smart_turn_checkpoint: str | None = None,
        enhancer: Callable[[np.ndarray], np.ndarray] | None = None,
        device: Any = "cpu",
    ) -> None:
        self.should_listen = should_listen
        self.sample_rate = sample_rate
        self.min_speech_ms = min_speech_ms
        self.min_speech_continuation_ms = self._resolve_continuation_ms(
            min_speech_ms, min_speech_continuation_ms
        )
        self.max_speech_ms = max_speech_ms
        self.enable_realtime_transcription = enable_realtime_transcription
        self.realtime_processing_pause = realtime_processing_pause
        self.text_output_queue = text_output_queue
        self.speculative_reopen_ms = speculative_reopen_ms
        self.short_segment_merge_ms = max(0, short_segment_merge_ms)
        self.smart_turn_max_wait_ms = smart_turn_max_wait_ms
        self.smart_turn_incomplete_delay_ms = smart_turn_incomplete_delay_ms
        self.enhancer = enhancer

        if smart_turn and smart_turn_analyzer is None:
            if smart_turn_max_wait_ms <= 0:
                raise ValueError("smart_turn_max_wait_ms must be > 0")
            if smart_turn_incomplete_delay_ms < 0:
                raise ValueError("smart_turn_incomplete_delay_ms must be >= 0")
            from s2s_tpu_torch.vad.smart_turn import SmartTurnAnalyzer, load_checkpoint

            params = load_checkpoint(smart_turn_checkpoint) if smart_turn_checkpoint else None
            smart_turn_analyzer = SmartTurnAnalyzer(
                threshold=smart_turn_threshold, encoder_params=params, device=device
            )
        self.smart_turn_analyzer = smart_turn_analyzer if smart_turn else None

        self.unanswered_reopen_ms = max(
            speculative_reopen_ms, unanswered_reopen_ms, smart_turn_max_wait_ms if smart_turn else 0
        )

        if model is None:
            raise NotImplementedError("Silero VAD is not ported yet (ROADMAP queue 1 item 3); pass a model")
        self.iterator = VADIterator(
            model,
            threshold=thresh,
            sampling_rate=sample_rate,
            min_silence_duration_ms=min_silence_ms,
            speech_pad_ms=speech_pad_ms,
        )
        self.turns = TurnLedger(speculative_turns)
        self.speculative_turns = speculative_turns

        self._last_td_config: dict | None = None
        self.last_process_time = 0.0
        self._total_samples = 0
        self._speech_started_emitted = False
        self._held: _HeldSegment | None = None

        # once-per-second summary logging
        self._log_t0 = 0.0
        self._log = {"chunks": 0, "starts": 0, "ends": 0, "progressive": 0}

    # ── config plumbing ──────────────────────────────────────────────

    @staticmethod
    def _resolve_continuation_ms(min_speech_ms: int, continuation_ms: int) -> int:
        if continuation_ms <= 0:
            return min_speech_ms
        return min(min_speech_ms, max(NOISE_FLOOR_MS, continuation_ms))

    def _apply_runtime_turn_detection(self, runtime_config: RuntimeConfig | None) -> None:
        audio = runtime_config.session.audio if runtime_config else None
        audio_in = audio.input if audio is not None else None
        td_raw = audio_in.turn_detection if audio_in is not None else None
        if td_raw is None:
            return
        td = td_raw.model_dump(exclude_none=True) if hasattr(td_raw, "model_dump") else dict(td_raw)
        if td == self._last_td_config:
            return
        self._last_td_config = dict(td)
        if "threshold" in td:
            self.iterator.threshold = td["threshold"]
            logger.info("VAD threshold updated to %s", td["threshold"])
        if "silence_duration_ms" in td:
            self.iterator.min_silence_samples = self.sample_rate * td["silence_duration_ms"] / 1000
            logger.info("VAD silence duration updated to %sms", td["silence_duration_ms"])

    # ── clock / measurement helpers ──────────────────────────────────

    @property
    def _audio_ms(self) -> int:
        return int(self._total_samples / self.sample_rate * 1000)

    def _buffer_ms(self) -> float:
        return sum(len(c) for c in self.iterator.speech_buffer()) / self.sample_rate * 1000

    def _active_ms(self) -> float:
        return self.iterator.active_speech_samples / self.sample_rate * 1000

    def _segment_ms(self, segment: np.ndarray) -> float:
        return len(segment) / self.sample_rate * 1000

    def _segment_start_ms(self, segment: np.ndarray, end_ms: int) -> int:
        return max(0, end_ms - int(self._segment_ms(segment)))

    def _start_threshold_ms(self, start_ms: int) -> float:
        """Lower hysteresis when speech continues a reopenable turn."""
        if self.turns.pending is not None or self.turns.reopenable(start_ms, self.unanswered_reopen_ms):
            return self.min_speech_continuation_ms
        return self.min_speech_ms

    # ── short-segment hold / stitch ──────────────────────────────────

    def _held_gap_ms(self, start_ms: int) -> float:
        if self._held is None:
            return float("inf")
        return max(0, start_ms - self._held.end_ms)

    def _can_stitch(self, start_ms: int) -> bool:
        return (
            self._held is not None
            and self.short_segment_merge_ms > 0
            and self._held_gap_ms(start_ms) <= self.short_segment_merge_ms
        )

    def _effective_start_stats(self, start_ms: int, active_ms: float) -> tuple[int, float]:
        """Fold a held segment into the start-threshold accounting (live path)."""
        if active_ms < NOISE_FLOOR_MS or not self._can_stitch(start_ms):
            return start_ms, active_ms
        assert self._held is not None
        return self._held.start_ms, self._held.active_ms + active_ms

    def _stitch_held(
        self, segment: np.ndarray, active_ms: float, end_ms: int
    ) -> tuple[np.ndarray, float, int, bool]:
        start_ms = self._segment_start_ms(segment, end_ms)
        if not self._can_stitch(start_ms):
            self._expire_held(start_ms)
            return segment, active_ms, start_ms, False
        held = self._held
        assert held is not None
        self._held = None
        # Re-insert the silence between the fragments so stitched audio spans
        # the audio-clock gap acoustically.
        gap = int(self._held_gap_ms_for(held, start_ms) * self.sample_rate / 1000)
        parts = [held.audio] + ([np.zeros(gap, segment.dtype)] if gap > 0 else []) + [segment]
        return np.concatenate(parts), held.active_ms + active_ms, held.start_ms, True

    @staticmethod
    def _held_gap_ms_for(held: _HeldSegment, start_ms: int) -> float:
        return max(0, start_ms - held.end_ms)

    def _hold(self, segment: np.ndarray, active_ms: float, start_ms: int, end_ms: int) -> None:
        self._held = _HeldSegment(segment, active_ms, start_ms, end_ms)
        logger.info(
            "VAD: holding short segment=%.0fms active=%.0fms", self._segment_ms(segment), active_ms
        )

    def _expire_held(self, reference_ms: int | None = None) -> None:
        if self._held is None or self.short_segment_merge_ms <= 0:
            return
        ref = self._audio_ms if reference_ms is None else reference_ms
        if max(0, ref - self._held.end_ms) > self.short_segment_merge_ms:
            logger.info("VAD: discarding held short segment (merge window elapsed)")
            self._held = None

    # ── superseded-audio drop ────────────────────────────────────────

    def before_emit_output(self, output) -> None:
        if isinstance(output, VADAudio):
            self._drop_superseded(output)

    def _drop_superseded(self, latest: VADAudio) -> int:
        q = self.queue_out
        if not hasattr(q, "mutex") or not hasattr(q, "queue"):
            return 0
        dropped = 0
        with q.mutex:
            kept: list[Any] = []
            while q.queue:
                item = q.queue.popleft()
                if isinstance(item, VADAudio) and self._is_superseded(item, latest):
                    dropped += 1
                else:
                    kept.append(item)
            q.queue.extend(kept)
            if dropped:
                q.not_full.notify_all()
        if dropped:
            logger.debug("VAD: dropped %d superseded audio item(s)", dropped)
        return dropped

    def _is_superseded(self, queued: VADAudio, latest: VADAudio) -> bool:
        if queued.turn_id is None or queued.turn_revision is None:
            return False
        if not self.speculative_turns.is_latest(queued.turn_id, queued.turn_revision):
            return True
        return (
            queued.mode == "progressive"
            and queued.turn_id == latest.turn_id
            and queued.turn_revision == latest.turn_revision
        )

    # ── Smart Turn ───────────────────────────────────────────────────

    def _endpoint_timing_ms(self, audio: np.ndarray) -> tuple[int, int]:
        """(reopen_grace_ms, processing_delay_ms) for this soft end."""
        analyzer = self.smart_turn_analyzer
        if analyzer is None:
            return self.speculative_reopen_ms, 0
        try:
            result = analyzer.predict(audio, sample_rate=self.sample_rate)
        except Exception:
            logger.exception("Smart Turn inference failed; using default reopen grace")
            return self.speculative_reopen_ms, 0
        if result.complete:
            logger.info(
                "Smart Turn: complete (p=%.3f, %.1fms); grace=%dms",
                result.probability, result.inference_ms, self.speculative_reopen_ms,
            )
            return self.speculative_reopen_ms, 0
        delay = min(self.smart_turn_incomplete_delay_ms, self.smart_turn_max_wait_ms)
        logger.info(
            "Smart Turn: incomplete (p=%.3f, %.1fms); grace=%dms delay=%dms",
            result.probability, result.inference_ms, self.smart_turn_max_wait_ms, delay,
        )
        return self.smart_turn_max_wait_ms, delay

    # ── main chunk processing ────────────────────────────────────────

    def process(self, item) -> Iterator[Any]:
        runtime_config = None
        if isinstance(item, tuple):
            item, runtime_config = item
        self._apply_runtime_turn_detection(runtime_config)

        if not self.should_listen.is_set():
            return

        self._log["chunks"] += 1
        audio_int16 = np.frombuffer(item, dtype=np.int16) if isinstance(item, bytes) else item
        self._total_samples += len(audio_int16)
        audio_f32 = int16_to_float32(audio_int16) if audio_int16.dtype == np.int16 else audio_int16

        utterance = self.iterator(audio_f32)

        triggered = self.iterator.triggered
        if triggered and not self._speech_started_emitted:
            self._maybe_emit_speech_started()
        elif not triggered and utterance is None:
            self._expire_held()

        self._log_summary(triggered)
        yield from self._progressive_and_final(utterance, runtime_config)

    def _maybe_emit_speech_started(self) -> None:
        active_ms = self._active_ms()
        start_ms = max(0, self._audio_ms - int(self._buffer_ms()))
        eff_start_ms, eff_active_ms = self._effective_start_stats(start_ms, active_ms)
        self.turns.begin_pending(eff_start_ms, self.unanswered_reopen_ms)
        min_ms = self._start_threshold_ms(eff_start_ms)
        if eff_active_ms < min_ms:
            return
        turn_id, revision, reopened = self._turn_for_speech_start(eff_start_ms)
        self._speech_started_emitted = True
        self._log["starts"] += 1
        logger.info(
            "Speech started (active=%.0fms, min=%.0fms, turn=%s rev=%s)",
            eff_active_ms, min_ms, turn_id, revision,
        )
        if self.text_output_queue:
            self.text_output_queue.put(
                SpeechStartedEvent(
                    audio_start_ms=eff_start_ms,
                    turn_id=turn_id,
                    turn_revision=revision,
                    reopened=reopened,
                )
            )

    def _turn_for_speech_start(self, audio_start_ms: int) -> tuple[str, int, bool]:
        if (
            self._speech_started_emitted
            and self.turns.turn_id is not None
            and self.turns.revision is not None
        ):
            return self.turns.turn_id, self.turns.revision, False
        confirmed = self.turns.confirm_pending()
        if confirmed is not None:
            return confirmed
        if self.turns.reopenable(audio_start_ms, self.unanswered_reopen_ms):
            reopened = self.turns.reopen_now()
            if reopened is not None:
                return reopened
        self.turns.start_new()
        assert self.turns.turn_id is not None and self.turns.revision is not None
        return self.turns.turn_id, self.turns.revision, False

    def _log_summary(self, triggered: bool) -> None:
        now = time.time()
        if now - self._log_t0 < 1.0:
            return
        logger.debug(
            "VAD: %d chunks/s | %s | starts=%d ends=%d progressive=%d",
            self._log["chunks"], "SPEAKING" if triggered else "silent",
            self._log["starts"], self._log["ends"], self._log["progressive"],
        )
        self._log = {k: 0 for k in self._log}
        self._log_t0 = now

    # ── progressive + final emission ─────────────────────────────────

    def _progressive_pause(self, duration_ms: float) -> float:
        """Release interval grows with segment duration, capped at 2 s."""
        base = max(0.0, self.realtime_processing_pause)
        s = duration_ms / 1000.0
        mult = 1.0 if s < 8.0 else 2.0 if s < 15.0 else 4.0 if s < 30.0 else 6.0
        return min(base * mult, 2.0)

    def _progressive_and_final(self, utterance, runtime_config) -> Iterator[Any]:
        # progressive release while inside a speech segment
        if self.enable_realtime_transcription and len(self.iterator.buffer) > 0:
            now = time.time()
            pause = self._progressive_pause(self._buffer_ms())
            if now - self.last_process_time >= pause:
                array = np.concatenate(self.iterator.speech_buffer())
                start_ms = max(0, self._audio_ms - int(self._segment_ms(array)))
                if self._active_ms() >= self._start_threshold_ms(start_ms):
                    self._log["progressive"] += 1
                    yield VADAudio(
                        audio=self.turns.with_prefix(array),
                        runtime_config=runtime_config,
                        mode="progressive",
                        turn_id=self.turns.turn_id,
                        turn_revision=self.turns.revision,
                    )
                    self.last_process_time = now

        if utterance is None:
            return

        if len(utterance) == 0:
            # Phantom trigger: close the speech pair without audio.
            logger.info("VAD: phantom trigger, closing speech pair")
            if self._speech_started_emitted and self.text_output_queue:
                self.text_output_queue.put(
                    SpeechStoppedEvent(
                        audio_end_ms=self._audio_ms,
                        turn_id=self.turns.turn_id,
                        turn_revision=self.turns.revision,
                    )
                )
            if not self._speech_started_emitted:
                self.turns.cancel_pending()
            self._speech_started_emitted = False
            self._expire_held()
            return

        array = np.concatenate(utterance)
        end_ms = self._audio_ms
        raw_active_ms = (
            self.iterator.last_utterance_active_speech_samples / self.sample_rate * 1000
        )
        active_ms = raw_active_ms
        stitched = False
        if raw_active_ms >= NOISE_FLOOR_MS:
            array, active_ms, start_ms, stitched = self._stitch_held(array, active_ms, end_ms)
        else:
            start_ms = self._segment_start_ms(array, end_ms)
        duration_ms = self._segment_ms(array)
        min_active = 0.0 if self._speech_started_emitted else self._start_threshold_ms(start_ms)
        too_long = duration_ms > self.max_speech_ms

        if active_ms < min_active or too_long:
            if (
                self.short_segment_merge_ms > 0
                and raw_active_ms >= NOISE_FLOOR_MS
                and active_ms < min_active
                and not too_long
            ):
                self._hold(array, active_ms, start_ms, end_ms)
            else:
                logger.info(
                    "VAD: discarding segment=%.0fms active=%.0fms", duration_ms, active_ms
                )
            if self._speech_started_emitted and self.text_output_queue:
                self.text_output_queue.put(
                    SpeechStoppedEvent(
                        audio_end_ms=self._audio_ms,
                        turn_id=self.turns.turn_id,
                        turn_revision=self.turns.revision,
                    )
                )
            if not self._speech_started_emitted:
                self.turns.cancel_pending()
            self._speech_started_emitted = False
            return

        if stitched:
            logger.info("VAD: stitched short segment(s) into %.0fms", duration_ms)
        if not self._speech_started_emitted:
            turn_id, revision, reopened = self._turn_for_speech_start(start_ms)
            if self.text_output_queue:
                self.text_output_queue.put(
                    SpeechStartedEvent(
                        audio_start_ms=start_ms,
                        turn_id=turn_id,
                        turn_revision=revision,
                        reopened=reopened,
                        interrupt_response=False,
                    )
                )
        else:
            turn_id, revision = self.turns.turn_id, self.turns.revision
        self._log["ends"] += 1
        logger.info(
            "Speech soft-ended (segment=%.0fms, active=%.0fms, turn=%s rev=%s)",
            duration_ms, active_ms, turn_id, revision,
        )
        analysis_audio = self.turns.with_raw_prefix(array)
        reopen_grace_ms, processing_delay_ms = self._endpoint_timing_ms(analysis_audio)
        if self.enhancer is not None:
            array = self.enhancer(array)
        output_array = self.turns.with_prefix(array)
        if self.text_output_queue:
            self.text_output_queue.put(
                SpeechStoppedEvent(
                    duration_s=len(output_array) / self.sample_rate,
                    audio_end_ms=end_ms,
                    turn_id=turn_id,
                    turn_revision=revision,
                )
            )
        self.turns.record_final(output_array, analysis_audio, end_ms)
        # Grace only delays response commits; resumed speech goes through the
        # candidate/revision flow and stales this revision first.
        self.speculative_turns.start_reopen_grace(turn_id, revision, reopen_grace_ms / 1000.0)
        yield VADAudio(
            audio=output_array,
            runtime_config=runtime_config,
            mode="final",
            turn_id=turn_id,
            turn_revision=revision,
            processing_delay_s=processing_delay_ms / 1000.0,
        )
        self.last_process_time = 0.0
        self._speech_started_emitted = False

    # ── lifecycle ────────────────────────────────────────────────────

    def on_session_end(self) -> None:
        self.iterator.reset_states()
        self._held = None
        self.last_process_time = 0.0
        self._total_samples = 0
        self._speech_started_emitted = False
        self.turns.reset()
        self.should_listen.set()
        logger.debug("VAD session state reset")

    min_time_to_debug = 0.00001
