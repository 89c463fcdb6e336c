"""Shared TTS stage contract (reference TTS handlers, SURVEY §2.5).

Every backend: consume ``TTSInput | EndOfResponse``; gate on
``is_latest_after_reopen_grace`` then **commit** the turn (first audible
output makes it un-reopenable); coalesce queued same-turn sentence chunks
before synthesis; yield int16 PCM in 512-sample blocks at 16 kHz; yield
``AUDIO_RESPONSE_DONE`` on ``EndOfResponse``; check ``cancel_scope`` per
chunk; log TTFA/RTF and the end-to-end "last speech in -> first speech out"
metric.
"""

from __future__ import annotations

import logging
import threading
from contextlib import nullcontext
from time import perf_counter
from typing import Any, Iterator, Optional

import numpy as np

from s2s_tpu_torch.audio.resample import resample_float
from s2s_tpu_torch.pipeline.control import SESSION_END, is_control
from s2s_tpu_torch.pipeline.messages import (
    AUDIO_RESPONSE_DONE,
    PIPELINE_END,
    EndOfResponse,
    SpeculativeTTSText,
    TTSInput,
)
from s2s_tpu_torch.runtime.base_handler import BaseHandler
from s2s_tpu_torch.runtime.device_scheduler import GLOBAL_SCHEDULER, Lane

logger = logging.getLogger(__name__)

PIPELINE_SR = 16_000
BLOCKSIZE = 512
_PREROLL_S = 0.040
_SILENCE_THRESHOLD = int(32768 * 0.01)


class _BufferedSpeculation:
    """Side-thread speculative synthesis into a growing piece buffer
    (single-stream backends — the batched Qwen3 engine has its own slot
    path).  ``pieces()`` replays buffered pieces then follows the producer;
    ``cancel()`` stops the producer between pieces."""

    def __init__(self) -> None:
        self._pieces: list = []
        self._cond = threading.Condition()
        self._done = False
        self.cancelled = threading.Event()
        #: admission lane for per-piece slot acquisition; promote() raises
        #: it mid-flight (read per piece, so the next acquisition uses it)
        self._lane = None

    def promote(self, lane) -> None:
        """Raise the producer's admission lane mid-flight — called on
        adoption: the remaining pieces are now the latency chain (the user
        is listening), so they should no longer queue behind other
        sessions' INTERACTIVE work.  Single-stream counterpart of
        ``TTSGenerationHandle.promote``."""
        self._lane = lane

    def feed(self, piece_iter, scheduler=None, lane=None) -> None:
        """Drive *piece_iter* to exhaustion into the buffer.

        When *scheduler* is given, the device slot is acquired PER PIECE
        (around each ``next()``, where the generator's compute runs) rather
        than for the whole synthesis: lane priority is admission-only — a
        holder is never preempted — so a whole-utterance hold would block
        the REALTIME VAD tick and any real INTERACTIVE synthesis for
        seconds.  Per-piece acquisition bounds that to one piece and lets
        higher lanes barge in between pieces."""
        sentinel = object()
        it = iter(piece_iter)
        if self._lane is None:  # a promote() that raced ahead wins
            self._lane = lane
        try:
            while not self.cancelled.is_set():
                if scheduler is not None:
                    with scheduler.slot(self._lane):
                        piece = next(it, sentinel)
                else:
                    piece = next(it, sentinel)
                if piece is sentinel:
                    break
                with self._cond:
                    self._pieces.append(piece)
                    self._cond.notify_all()
        except Exception:  # noqa: BLE001 — speculation must never break serving
            logger.exception("speculative synthesis failed; buffer truncated")
            self.cancelled.set()  # a partial buffer must not be adopted
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()

    def pieces(self) -> Iterator:
        i = 0
        while True:
            with self._cond:
                while i >= len(self._pieces) and not self._done:
                    self._cond.wait(timeout=0.1)
                if i < len(self._pieces):
                    piece = self._pieces[i]
                    i += 1
                elif self._done:
                    return
                else:
                    continue
            yield piece

    def cancel(self) -> None:
        self.cancelled.set()


class BaseTTSHandler(BaseHandler):
    """Streaming synthesis base; subclasses implement ``_synthesize``."""

    blocksize = BLOCKSIZE

    def setup_base(
        self,
        cancel_scope=None,
        speculative_turns=None,
        device_scheduler=None,
        should_listen=None,
        blocksize: int = BLOCKSIZE,
        speculative_synthesis: bool = True,
    ) -> None:
        self.cancel_scope = cancel_scope
        self.speculative_turns = speculative_turns
        self.scheduler = device_scheduler or GLOBAL_SCHEDULER
        self.should_listen = should_listen
        self.blocksize = blocksize
        #: whole-chain speculation on single-stream backends: a BACKGROUND-
        #: lane side thread synthesizes the announced first sentence batch
        #: into a buffer; the real input adopts on (text, voice) match
        self.speculative_synthesis_fallback = bool(speculative_synthesis)
        self._spec_fallback: tuple[tuple, _BufferedSpeculation] | None = None
        self._spec_fallback_turn: str | None = None
        #: last real turn synthesized — a speculation announced late (its
        #: final already answered) must not strand an engine slot
        self._last_answered_turn: tuple | None = None

    def on_session_end(self) -> None:
        # turn ids restart per session: a stale marker would silently
        # disable speculation for the next session's matching turn
        self._last_answered_turn = None
        self._cancel_fallback_speculation()
        super().on_session_end()

    # ── subclass hooks ───────────────────────────────────────────────

    def _synthesize(
        self, text: str, language_code: Optional[str], runtime_config, response
    ) -> Iterator[tuple[np.ndarray, int]]:
        """Yield (float32 audio, sample_rate) pieces."""
        raise NotImplementedError

    def _uses_shared_engine(self) -> bool:
        """True when ``_synthesize`` routes through a shared batched engine
        (overridden by backends that attach one)."""
        return False

    def _device_slot(self):
        """Per-utterance INTERACTIVE dispatch slot — or a no-op when the
        backend synthesizes through a shared batched engine.  The engine's
        driver thread owns dispatch ordering for ALL sessions; holding the
        process-wide slot across the stream here would serialize every
        session's utterance at the handler level and defeat the batch
        (the LLM handler's batched path bypasses its slot the same way,
        ``llm/local_backend.py``)."""
        if self._uses_shared_engine():
            return nullcontext()
        return self.scheduler.slot(Lane.INTERACTIVE)

    def _session_voice(self, runtime_config, response) -> Optional[str]:
        """Voice override from session/response config (reference
        ``session.audio.output.voice`` handling)."""
        for source in (response, runtime_config.session if runtime_config else None):
            audio = getattr(source, "audio", None)
            out = getattr(audio, "output", None)
            voice = getattr(out, "voice", None)
            if voice:
                return voice
        return None

    # ── queued-text coalescing ───────────────────────────────────────

    def _coalesce(self, current: TTSInput) -> tuple[str, Optional[str]]:
        """Merge queued same-turn TTSInputs into one synthesis call."""
        q = self.queue_in
        if not hasattr(q, "mutex") or not hasattr(q, "queue"):
            return current.text, current.language_code
        text, language = current.text, current.language_code
        parts = [text.strip()] if text and text.strip() else []
        with q.mutex:
            while q.queue:
                nxt = q.queue[0]
                if is_control(nxt, SESSION_END.kind):
                    break
                if isinstance(nxt, bytes) and nxt == PIPELINE_END:
                    break
                if isinstance(nxt, EndOfResponse) or not isinstance(nxt, TTSInput):
                    break
                if nxt.turn_id != current.turn_id or nxt.turn_revision != current.turn_revision:
                    break
                if language is not None and nxt.language_code is not None and nxt.language_code != language:
                    break
                q.queue.popleft()
                if nxt.text.strip():
                    parts.append(nxt.text.strip())
                if language is None:
                    language = nxt.language_code
        return " ".join(parts).strip(), language

    # ── streaming loop ───────────────────────────────────────────────

    def _stream(self, piece_iter, label: str) -> Iterator[np.ndarray]:
        """TTFA/RTF logging, leading-silence trim with preroll, resample to
        16 kHz, fixed-block rechunking, per-chunk cancellation."""
        cancel_gen = self.cancel_scope.generation if self.cancel_scope else None
        start = perf_counter()
        total = 0
        first = True
        found_speech = False
        leftover = np.array([], dtype=np.int16)

        for piece in piece_iter:
            if (
                cancel_gen is not None
                and self.cancel_scope is not None
                and self.cancel_scope.is_stale(cancel_gen)
            ):
                logger.info("TTS generation cancelled (interruption)")
                return
            audio, sr = piece
            audio = np.asarray(audio, dtype=np.float32).squeeze()
            if audio.size == 0:
                continue
            if first:
                logger.info("TTS TTFA: %.2fs (%s)", perf_counter() - start, label)
                first = False
            if sr != PIPELINE_SR:
                audio = resample_float(audio, sr, PIPELINE_SR)
            pcm = np.clip(audio * 32768, -32768, 32767).astype(np.int16)

            if not found_speech:
                above = np.abs(pcm) > _SILENCE_THRESHOLD
                if not np.any(above):
                    continue
                start_idx = max(0, int(np.argmax(above)) - int(PIPELINE_SR * _PREROLL_S))
                pcm = pcm[start_idx:]
                found_speech = True

            pcm = np.concatenate([leftover, pcm])
            n = (len(pcm) // self.blocksize) * self.blocksize
            for i in range(0, n, self.blocksize):
                yield pcm[i : i + self.blocksize]
                total += self.blocksize
            leftover = pcm[n:]

        if len(leftover):
            yield np.pad(leftover, (0, self.blocksize - len(leftover)))
            total += len(leftover)

        dt = perf_counter() - start
        dur = total / PIPELINE_SR
        logger.info("TTS generated %.2fs audio in %.2fs (RTF: %.2f, %s)", dur, dt, dur / dt if dt else 0, label)

    # ── main entry ───────────────────────────────────────────────────

    def _utterance_key(self, text: str, runtime_config, response, language=None) -> tuple:
        """Identity of one synthesis request for speculation adoption —
        anything device output depends on beyond the handler's fixed setup.
        Speculations synthesize with ``language=None``, so a real input
        carrying a language code never adopts (safe fallback)."""
        return (text, self._session_voice(runtime_config, response), language)

    def _cancel_fallback_speculation(self) -> None:
        spec = self._spec_fallback
        self._spec_fallback = None
        self._spec_fallback_turn = None
        if spec is not None:
            spec[1].cancel()

    def _begin_speculative_synthesis(self, item: SpeculativeTTSText) -> None:
        """Whole-chain speculation hook.  The base implementation runs
        ``_synthesize`` on a BACKGROUND-lane side thread into a buffer;
        backends with a batched engine (Qwen3) override with a slot-based
        path.  Nothing is emitted until the real input adopts."""
        self._cancel_fallback_speculation()
        if not self.speculative_synthesis_fallback:
            return
        text = (item.text or "").strip()
        if not text:
            return
        key = self._utterance_key(text, item.runtime_config, None)
        spec = _BufferedSpeculation()
        runtime_config = item.runtime_config

        def run() -> None:
            # BACKGROUND lane, acquired per piece inside feed(): speculation
            # yields to every real utterance AND to the REALTIME VAD tick
            # between pieces (a whole-utterance hold would block them)
            spec.feed(
                self._synthesize(text, None, runtime_config, None),
                scheduler=self.scheduler, lane=Lane.BACKGROUND,
            )

        threading.Thread(target=run, daemon=True, name="tts-spec-fallback").start()
        self._spec_fallback = (key, spec)
        self._spec_fallback_turn = item.turn_id

    def _adopt_speculation_pieces(self, text: str, runtime_config, response, language=None):
        """Return the buffered speculative piece stream iff it matches this
        real utterance (and wasn't truncated by a failure); else cancel it."""
        spec = self._spec_fallback
        if spec is None:
            return None
        self._spec_fallback = None
        self._spec_fallback_turn = None
        key, buffered = spec
        if buffered.cancelled.is_set() or key != self._utterance_key(
            text, runtime_config, response, language
        ):
            buffered.cancel()
            return None
        # remaining pieces are now the latency chain — stop queueing them
        # behind other sessions' interactive work
        buffered.promote(Lane.INTERACTIVE)
        return buffered.pieces()

    def _discard_speculation_for(self, turn_id) -> None:
        """Drop a pending speculation for *turn_id* (any revision) — called
        when that turn can no longer adopt it (its response ended, or its
        input went stale on reopen/barge-in), so the slot/side thread frees
        instead of lingering until the next speculation."""
        if turn_id is not None and turn_id == self._spec_fallback_turn:
            self._cancel_fallback_speculation()

    def process(self, item) -> Iterator[Any]:
        tracker = self.speculative_turns
        if isinstance(item, SpeculativeTTSText):
            if item.turn_id is not None and (
                (item.turn_id, item.turn_revision) == self._last_answered_turn
            ):
                return  # the final for this (turn, rev) was already spoken
            if tracker is None or tracker.is_latest(item.turn_id, item.turn_revision):
                self._begin_speculative_synthesis(item)
            return

        if isinstance(item, EndOfResponse):
            # the turn is over either way: a speculation it never adopted
            # (failed/text-only/reopened response) must release its slot
            self._discard_speculation_for(item.turn_id)
            if tracker and not tracker.is_latest_after_reopen_grace(item.turn_id, item.turn_revision):
                return
            yield AUDIO_RESPONSE_DONE
            return

        if tracker and not tracker.is_latest_after_reopen_grace(item.turn_id, item.turn_revision):
            logger.debug("Dropping stale TTS input turn=%s rev=%s", item.turn_id, item.turn_revision)
            self._discard_speculation_for(item.turn_id)
            return
        if tracker:
            # First audible output commits the speculative turn.
            tracker.commit(item.turn_id, item.turn_revision)
        if item.turn_id is not None:
            self._last_answered_turn = (item.turn_id, item.turn_revision)

        text, language = self._coalesce(item)
        text = text or "Hello."
        logger.info("ASSISTANT: %s", text)

        adopted = self._adopt_speculation_pieces(text, item.runtime_config, item.response, language)
        try:
            # adopted pieces come from the speculation's own side thread /
            # engine slot — no device slot needed here
            with nullcontext() if adopted is not None else self._device_slot():
                piece_iter = (
                    adopted if adopted is not None
                    else self._synthesize(text, language, item.runtime_config, item.response)
                )
                first_audio = True
                for chunk in self._stream(piece_iter, type(self).__name__):
                    if first_audio:
                        self._log_first_audio_latency(item)
                        first_audio = False
                    yield chunk
        except Exception:
            logger.exception("TTS synthesis failed")

    def _log_first_audio_latency(self, item: TTSInput) -> None:
        if item.speech_stopped_at_s is None:
            return
        latency = perf_counter() - item.speech_stopped_at_s
        if latency >= 0:
            logger.info(
                "Last speech detected to first speech out: %.3fs (turn=%s rev=%s)",
                latency, item.turn_id, item.turn_revision,
            )

    min_time_to_debug = 0.0001
