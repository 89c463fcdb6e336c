"""Cross-session batched serving engines on PyTorch (port of the device side
of ``s2s_tpu/parallel/session_scheduler.py``).

:class:`BatchedLMScheduler` and :class:`BatchedTTSScheduler` subclass the JAX
package's schedulers and inherit all of their host logic unchanged: slots,
``_claim``/``_release``, the priority lane and its buckets, width buckets,
``_capacity_clamp``, ``prompt_capacity``, ``text_bucket``, the handles,
speculative start/promote and the cross-scheduler :class:`PriorityGate`.
What touches device tensors is overridden: construction, warm-up, the
driver (dispatch) and the fetcher (completion) threads.

Dispatch and completion stay split, as in the JAX engines.  The driver
thread issues each program on the current CUDA stream (all device work of
the process runs on one stream), then queues a non-blocking copy of the
program's small outputs (tokens, emitted masks, audio, EOS flags) to pinned
host memory and records a ``torch.cuda.Event``.  The fetcher waits on that
event alone, so it never waits for work dispatched after it.  Those outputs
are fresh tensors, never views of the engine state that the next in-place
dispatch rewrites.

Warm-up runs every program variant once: prompt buckets, priority buckets,
width buckets, and the TTS ramp and chunk sizes.  In eager PyTorch that
builds the CUDA kernels and warms the allocator and cuBLAS; capturing the
programs as CUDA graphs is later work (ROADMAP).
"""

from __future__ import annotations

import logging
import threading
from queue import Queue
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from s2s_tpu.parallel.session_scheduler import (
    _TTS_RAMP,
    GLOBAL_PRIORITY_GATE,
    PriorityGate,
    TTSGenerationHandle,
    _drain_completions,
    _TTSSlot,
)
from s2s_tpu.parallel.session_scheduler import BatchedLMScheduler as _JaxBatchedLMScheduler
from s2s_tpu.parallel.session_scheduler import BatchedTTSScheduler as _JaxBatchedTTSScheduler
from s2s_tpu_torch.models import qwen3_tts
from s2s_tpu_torch.parallel import batched_decode as bd

logger = logging.getLogger(__name__)

__all__ = ["BatchedLMScheduler", "BatchedTTSScheduler", "GLOBAL_PRIORITY_GATE", "PriorityGate"]


class _HostCopy:
    """Outputs of one dispatch on their way to the host: non-blocking copies
    into pinned memory, then an event the fetcher waits on (CUDA); on the
    CPU the tensors are already there."""

    def __init__(self, *tensors: torch.Tensor) -> None:
        if tensors[0].is_cuda:
            self._host = [t.to("cpu", non_blocking=True) for t in tensors]
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = list(tensors), None

    def wait(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]


def _fetch_loop(engine, trace=lambda event, tag=None: None) -> None:
    """Completion loop of both engines: wait for each dispatch's host copy,
    in order, and hand the host arrays to the record's deliver callback
    under the engine's lock.  A record is (trace tag, :class:`_HostCopy`,
    deliver)."""
    while True:
        batch = _drain_completions(engine._completions, lambda rec: ())
        if batch is None:
            return
        for tag, copy, deliver in batch:
            trace("fetch_start", tag)
            host = copy.wait()
            trace("fetch_end", tag)
            with engine._work:
                deliver(*host)
                engine._work.notify_all()


def _device_of(tree) -> torch.device:
    """The device of the first tensor of a parameter tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    return _device_of(next(iter(tree.values() if isinstance(tree, dict) else tree)))


class BatchedLMScheduler(_JaxBatchedLMScheduler):
    """Slot-based batched decode engine for the local decoder LM, on the
    port's tail programs (:mod:`s2s_tpu_torch.parallel.batched_decode`)."""

    def __init__(self, params, cfg, n_slots: int = 4, max_t: int | None = None, chunk_tokens: int = 8,
                 eos_id: int = 0, priority_tokens: int = 12, priority_chunk: int | None = None,
                 gate: PriorityGate | None = None) -> None:
        self.params = params
        self.cfg = cfg
        self.device = _device_of(params)
        self.n_slots = n_slots
        self.chunk_tokens = max(1, chunk_tokens)
        self.eos_id = eos_id
        self.priority_tokens = max(0, priority_tokens)
        self.priority_chunk = max(1, priority_chunk if priority_chunk is not None
                                  else max(self.priority_tokens, 1))
        # static priority-chunk buckets (see the JAX scheduler): powers of two
        # below the window, then the window
        buckets, v = [], 1
        while v < self.priority_chunk:
            buckets.append(v)
            v *= 2
        buckets.append(self.priority_chunk)
        self._prio_buckets = buckets
        self.gate = gate
        # KV capacity cannot exceed the rope table (cfg.max_seq_len)
        self._max_t = min(max_t or cfg.max_seq_len, cfg.max_seq_len)
        self._state = bd.init_multi_state(cfg, n_slots, self._max_t, self.device)
        self._tokens = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self._slots = {}
        self._free = list(range(n_slots))
        self._prefills = []
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._driver = None
        self._fetcher = None
        self._completions: Queue = Queue()
        self._steady_inflight = False
        self._stop = False
        self._steady_skips = 0
        self._width_buckets = sorted({min(w, n_slots) for w in (4, 8, 16, n_slots)})
        self._init_trace("lm")

    def warmup(self) -> None:
        """Run every program the driver can dispatch once (prompt buckets
        with and without the fused priority chunk, every width bucket, every
        priority bucket) before serving.  Runs before the driver thread
        exists and scribbles on slot 0, whose position is reset."""
        buckets, b = [], 16
        while b < self._max_t:
            buckets.append(b)
            b *= 2
        buckets.append(self._max_t)
        for pb in buckets:
            prompt = torch.zeros((1, pb), dtype=torch.int32, device=self.device)
            if self.priority_tokens > 0:
                bd.prefill_and_chunk_slot_tail(self.params, self.cfg, prompt, 1, self._state, 0,
                                               self._prio_buckets[-1], self.eos_id)
            bd.prefill_slot(self.params, self.cfg, prompt, 1, self._state, 0)
        for w in self._width_buckets:
            ids = torch.zeros((w,), dtype=torch.long, device=self.device)
            bd.decode_chunk_gathered_tail(self.params, self.cfg, self._tokens[ids], self._state,
                                          self.chunk_tokens, self.eos_id, ids)
        if self.priority_tokens > 0:
            for n in self._prio_buckets:
                bd.decode_chunk_slot_tail(self.params, self.cfg, self._tokens[0], self._state, n,
                                          self.eos_id, 0)
        self._state.pos[0] = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fetch(self) -> None:
        _fetch_loop(self, self._tr)

    def _slot_record(self, sid, slot, cap, toks, emitted) -> tuple:
        return sid, _HostCopy(toks, emitted), lambda t, e: self._deliver(sid, slot, t, e, cap)

    def _steady_record(self, members, toks, emitted) -> tuple:
        def deliver(t, e):  # (n, W)
            self._steady_inflight = False
            for i, (sid, slot, cap) in enumerate(members):
                self._deliver(sid, slot, t[:, i], e[:, i], cap)
        return "steady", _HostCopy(toks, emitted), deliver

    def _drive(self) -> None:
        """Dispatch loop, the JAX driver's policy on the port's programs:
        prefills (fused with the first priority chunk when the slot has a
        priority window), then priority-lane slot chunks, then at most one
        gathered steady chunk in flight, held back while priority work runs."""
        while True:
            with self._work:
                self._sweep_cancelled()
                while not self._stop and not self._prefills and not self._dispatchable():
                    self._work.wait(timeout=0.5)
                    self._sweep_cancelled()
                if self._stop:
                    return
                prefills, self._prefills = self._prefills, []
                running = self._dispatchable()

            did_priority = False
            for req in prefills:
                with self._work:
                    slot = self._slots.get(req.slot)
                    if slot is None or (req.slot_obj is not None and slot is not req.slot_obj):
                        continue  # owner changed: stale prefill, drop it
                    n_req = min(self.priority_chunk, slot.priority_remaining, slot.remaining)
                    cap = slot.remaining
                    fused = n_req > 0 and not slot.cancelled
                    if fused:
                        n_prio = self._prio_buckets[-1]
                        slot.inflight = True
                        slot.priority_remaining = max(0, slot.priority_remaining - n_prio)
                        slot.remaining = max(0, slot.remaining - n_prio)
                tokens = torch.from_numpy(req.tokens).to(self.device)
                if fused:
                    self._tr("prefill_dispatch", req.slot)
                    toks, emitted, tok, self._state = bd.prefill_and_chunk_slot_tail(
                        self.params, self.cfg, tokens, req.prompt_len, self._state, req.slot,
                        n_prio, self.eos_id)
                    self._tokens[req.slot] = tok
                    did_priority = True
                    self._completions.put(self._slot_record(req.slot, slot, cap, toks, emitted))
                else:
                    token, self._state = bd.prefill_slot(self.params, self.cfg, tokens, req.prompt_len,
                                                         self._state, req.slot)
                    self._tokens[req.slot] = token
                    running[req.slot] = slot

            with self._work:
                running = {sid: s for sid, s in running.items() if sid in self._slots}
            for sid, slot in list(running.items()):
                with self._work:
                    if (slot.priority_remaining <= 0 or slot.cancelled
                            or slot.eos_seen or slot.inflight):
                        continue
                    n_req = min(self.priority_chunk, slot.priority_remaining, slot.remaining)
                    if n_req <= 0:
                        continue
                    n = self._prio_bucket(n_req)
                    cap = slot.remaining
                    slot.inflight = True
                    slot.priority_remaining = max(0, slot.priority_remaining - n)
                    slot.remaining = max(0, slot.remaining - n)
                self._tr("prio_dispatch", sid)
                toks, emitted, tok, self._state = bd.decode_chunk_slot_tail(
                    self.params, self.cfg, self._tokens[sid], self._state, n, self.eos_id, sid)
                self._tokens[sid] = tok
                did_priority = True
                self._completions.put(self._slot_record(sid, slot, cap, toks, emitted))

            gate_busy = self.gate is not None and self.gate.busy()
            if (did_priority or gate_busy) and self._steady_skips < (20 if gate_busy else 2):
                self._steady_skips += 1
                if not did_priority:
                    with self._work:
                        self._work.wait(timeout=0.01)
                continue
            self._steady_skips = 0

            with self._work:
                if self._steady_inflight:
                    self._work.wait(timeout=0.05)
                    continue
                steady = {sid: s for sid, s in self._dispatchable().items() if s.priority_remaining <= 0}
                if not steady:
                    continue
                caps = {sid: s.remaining for sid, s in steady.items()}
                for s in steady.values():
                    s.inflight = True
                    s.remaining = max(0, s.remaining - self.chunk_tokens)
                self._steady_inflight = True
            sids = sorted(steady)
            self._tr("steady_dispatch", tuple(sids))
            slot_ids = torch.from_numpy(self._bucket_ids(sids).astype(np.int64)).to(self.device)
            toks, emitted, tok_out, self._state = bd.decode_chunk_gathered_tail(
                self.params, self.cfg, self._tokens[slot_ids], self._state, self.chunk_tokens,
                self.eos_id, slot_ids)
            self._tokens[slot_ids] = tok_out
            self._completions.put(self._steady_record([(sid, steady[sid], caps[sid]) for sid in sids],
                                                      toks, emitted))


class TorchTTSGenerationHandle(TTSGenerationHandle):
    """:class:`TTSGenerationHandle` whose ``chunks`` names the port's sample rate."""

    def chunks(self) -> Iterator[tuple[np.ndarray, int]]:
        for item in self._consume():
            yield item, qwen3_tts.SAMPLE_RATE


class BatchedTTSScheduler(_JaxBatchedTTSScheduler):
    """Slot-based batched Qwen3-TTS serving on the port's talker tail
    programs (:mod:`s2s_tpu_torch.models.qwen3_tts`)."""

    def __init__(self, params, cfg, n_slots: int = 4, max_t: int = 1024, context_frames: int = 25,
                 chunk_frames: int = 8, gate: PriorityGate | None = None) -> None:
        self.params = params
        self.cfg = cfg
        self.device = _device_of(params["talker"])
        self.n_slots = n_slots
        self.chunk_frames = chunk_frames
        self.context_frames = context_frames
        self.gate = gate
        # same rope-table clamp as the LM engine
        max_t = min(max_t, cfg.lm.max_seq_len)
        self._max_t = max_t
        # capacity-aware text bucket, as the JAX engine computes it
        overhang = max(chunk_frames, max(_TTS_RAMP))
        cap = min(256, max(16, max_t - overhang - 1))
        bucket = 16
        while bucket * 2 <= cap:
            bucket *= 2
        self.text_bucket = bucket
        self._state = bd.init_multi_state(cfg.lm, n_slots, max_t, self.device)
        self._embeds = torch.zeros((n_slots, cfg.lm.d_model), dtype=cfg.lm.dtype, device=self.device)
        self._contexts = torch.zeros((n_slots, context_frames, cfg.n_q), dtype=torch.int32,
                                     device=self.device)
        self._slots = {}
        self._free = list(range(n_slots))
        self._prefills = []
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._driver = None
        self._fetcher = None
        self._completions: Queue = Queue()
        self._steady_inflight = False
        self._stop = False
        self._steady_skips = 0
        self._width_buckets = sorted({min(w, n_slots) for w in (4, 8, 16, n_slots)})

    def warmup(self) -> None:
        """Run every dispatchable program once (fused prefill + first ramp
        chunk, plain prefill, every width bucket at the chunk size, every ramp
        size) before serving; resets slot 0 after."""
        text = torch.zeros((1, self.text_bucket), dtype=torch.int32, device=self.device)
        spk = self.params["speakers"][:1]
        qwen3_tts.prefill_and_first_chunk_slot_tail(self.params, self.cfg, text, spk, self._state,
                                                    self._contexts, _TTS_RAMP[0], 0)
        bos, self._state = qwen3_tts.prefill_tts_slot(self.params, self.cfg, text, spk, self._state, 0)
        self._embeds[0] = bos
        for w in self._width_buckets:
            ids = torch.zeros((w,), dtype=torch.long, device=self.device)
            qwen3_tts.decode_chunk_audio_gathered_tail(self.params, self.cfg, self._embeds, self._state,
                                                       self._contexts, self.chunk_frames, ids)
        for n in _TTS_RAMP:
            _, _, emb, self._state, ctx = qwen3_tts.decode_chunk_audio_slot_tail(
                self.params, self.cfg, self._embeds[0], self._state, self._contexts[0], n, 0)
            self._embeds[0] = emb
            self._contexts[0] = ctx
        self._state.pos[0] = 0
        self._contexts[0] = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # The JAX engine's stream/start build its own handle, whose chunks()
    # imports the JAX model for its sample rate; these build the port's.

    def stream(self, text_tokens: np.ndarray, speaker_vec, max_frames: int,
               cancel_check: Callable[[], bool] | None = None) -> Iterator[tuple[np.ndarray, int]]:
        """Yield (float32 audio chunk @ 24 kHz, sample_rate) for one utterance."""
        max_frames = self._capacity_clamp(text_tokens, max_frames)
        if max_frames <= 0:
            return
        slot_id, slot = self._claim()
        handle = TorchTTSGenerationHandle(self, slot_id, slot)
        self._submit(slot_id, slot, text_tokens, speaker_vec, max_frames, gated=True)
        handle.bind_cancel(cancel_check)
        yield from handle.chunks()

    def start(self, text_tokens: np.ndarray, speaker_vec, max_frames: int,
              gated: bool = True) -> Optional[TorchTTSGenerationHandle]:
        """Claim a slot and begin synthesis without blocking; None when every
        slot is busy."""
        max_frames = self._capacity_clamp(text_tokens, max_frames)
        if max_frames <= 0:
            return None
        with self._work:
            if not self._free:
                return None
            slot_id = self._free.pop()
            slot = _TTSSlot()
            self._slots[slot_id] = slot
        handle = TorchTTSGenerationHandle(self, slot_id, slot)
        self._submit(slot_id, slot, text_tokens, speaker_vec, max_frames, gated=gated)
        return handle

    def _fetch(self) -> None:
        _fetch_loop(self)

    def _slot_record(self, sid, slot, n, cap, audio, eos) -> tuple:
        return sid, _HostCopy(audio, eos), lambda a, e: self._deliver(sid, slot, a, e, n, cap)

    def _steady_record(self, members, n, audio, eos) -> tuple:
        def deliver(a, e):  # (W, T'), (n, W)
            self._steady_inflight = False
            for i, (sid, slot, cap) in enumerate(members):
                self._deliver(sid, slot, a[i], e[:, i], n, cap)
        return "steady", _HostCopy(audio, eos), deliver

    def _drive(self) -> None:
        """Dispatch loop, the JAX driver's policy: fused prefill + first ramp
        chunk, then ramp chunks in the priority lane, then one gathered
        steady chunk at a time."""
        cfg = self.cfg
        while True:
            with self._work:
                self._sweep_cancelled()
                while not self._stop and not self._prefills and not self._dispatchable():
                    self._work.wait(timeout=0.5)
                    self._sweep_cancelled()
                if self._stop:
                    return
                prefills, self._prefills = self._prefills, []
                running = self._dispatchable()

            did_priority = False
            for req in prefills:
                with self._work:
                    slot = self._slots.get(req.slot)
                    if slot is None or (req.slot_obj is not None and slot is not req.slot_obj):
                        continue  # owner changed: stale prefill, drop it
                    n0 = _TTS_RAMP[0]
                    cap = slot.remaining
                    fused = cap > 0 and not slot.cancelled
                    if fused:
                        slot.inflight = True
                        slot.chunks_done = 1
                        slot.remaining = max(0, slot.remaining - n0)
                text = torch.from_numpy(np.asarray(req.text_tokens, np.int32)).to(self.device)
                speaker = torch.as_tensor(req.speaker_vec).to(self.device)
                if fused:
                    audio, eos, emb, self._state, self._contexts = qwen3_tts.prefill_and_first_chunk_slot_tail(
                        self.params, cfg, text, speaker, self._state, self._contexts, n0, req.slot)
                    self._embeds[req.slot] = emb
                    did_priority = True
                    self._completions.put(self._slot_record(req.slot, slot, n0, cap, audio, eos))
                else:
                    bos, self._state = qwen3_tts.prefill_tts_slot(self.params, cfg, text, speaker,
                                                                  self._state, req.slot)
                    self._embeds[req.slot] = bos
                    self._contexts[req.slot] = 0
                    running[req.slot] = slot

            with self._work:
                running = {sid: s for sid, s in running.items() if sid in self._slots}
            for sid, slot in list(running.items()):
                with self._work:
                    if (slot.chunks_done >= len(_TTS_RAMP) or slot.cancelled
                            or slot.eos_seen or slot.inflight or slot.remaining <= 0):
                        continue
                    n = _TTS_RAMP[slot.chunks_done]
                    cap = slot.remaining
                    slot.inflight = True
                    slot.chunks_done += 1
                    slot.remaining = max(0, slot.remaining - n)
                audio, eos, emb, self._state, ctx = qwen3_tts.decode_chunk_audio_slot_tail(
                    self.params, cfg, self._embeds[sid], self._state, self._contexts[sid], n, sid)
                self._embeds[sid] = emb
                self._contexts[sid] = ctx
                did_priority = True
                self._completions.put(self._slot_record(sid, slot, n, cap, audio, eos))

            gate_busy = self.gate is not None and self.gate.busy()
            if (did_priority or gate_busy) and self._steady_skips < (20 if gate_busy else 2):
                self._steady_skips += 1
                if not did_priority:
                    with self._work:
                        self._work.wait(timeout=0.01)
                continue
            self._steady_skips = 0

            with self._work:
                if self._steady_inflight:
                    self._work.wait(timeout=0.05)
                    continue
                steady = {sid: s for sid, s in self._dispatchable().items()
                          if s.chunks_done >= len(_TTS_RAMP)}
                if not steady:
                    continue
                n = self.chunk_frames
                caps = {sid: s.remaining for sid, s in steady.items()}
                for s in steady.values():
                    s.inflight = True
                    s.chunks_done += 1
                    s.remaining = max(0, s.remaining - n)
                self._steady_inflight = True
            sids = sorted(steady)
            slot_ids = torch.from_numpy(self._bucket_ids(sids).astype(np.int64)).to(self.device)
            audio, eos, self._embeds, self._state, self._contexts = qwen3_tts.decode_chunk_audio_gathered_tail(
                self.params, cfg, self._embeds, self._state, self._contexts, n, slot_ids)
            self._completions.put(self._steady_record([(sid, steady[sid], caps[sid]) for sid in sids], n,
                                                      audio, eos))
