"""The system under test: the port's realtime serve, hosted in this process.

The serve is built by ``s2s_tpu_torch.cli.build_from_argv``, the builder and
registry that ``python -m s2s_tpu_torch.cli serve`` uses, from the
configuration file's flags.  Its weights are the benchmark's seeded trees
(:mod:`s2sbench.weights`): for the build only, the program's two
random-init hooks (``registry._random_init``, which the batched Parakeet
service and the LM engine call without a checkpoint, and
``models.qwen3_tts.init_params``, which ``Qwen3TTS`` calls) hand out those
trees instead of drawing their own.  The port quantizes them as it does
when it serves.

:class:`Recorder` keeps what the serve produced, for the comparison with
the reference after the window: it wraps the engines' entry points at
run time (no program file changes) and keeps the prompt and token ids of
every LM generation, the text, speaker and codec frames of every synthesis
with the audio the engine handed out, and the audio and token ids of every
transcription.  A frame's codes are read from the engine's vocoder context
after each chunk (one small copy on the device a chunk); nothing is read
to the host before the window has closed.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from s2sbench import tokenizer, weights

#: the encoder output of the transcription batch running on this thread
_ENCODED = threading.local()


def flag_values(flags: list[str]) -> dict:
    """``--name value`` pairs of a flag list as {name: value}."""
    return {flags[i][2:]: flags[i + 1] for i in range(0, len(flags) - 1) if flags[i].startswith("--")
            and not flags[i + 1].startswith("--")}


@contextlib.contextmanager
def seeded_init(trees: dict):
    """The program's random-init hooks hand out *trees* (by model) while
    the serve is built."""
    from s2s_tpu_torch import registry
    from s2s_tpu_torch.models import qwen3_tts

    old_random, old_tts = registry._random_init, qwen3_tts.init_params

    def random_init(init, cfg, device, what):
        module = init.__module__.rsplit(".", 1)[-1]
        model = {"parakeet": "parakeet", "decoder_lm": "lm"}[module]
        return trees.pop(model)

    def tts_init(cfg, gen, device):
        return trees.pop("tts")

    registry._random_init, qwen3_tts.init_params = random_init, tts_init
    try:
        yield
    finally:
        registry._random_init, qwen3_tts.init_params = old_random, old_tts


class Recorder:
    """The serve's outputs, keyed by request."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.lm: list[dict] = []
        self.tts: list[dict] = []
        self.stt: list[dict] = []
        self._by_slot: dict[int, dict] = {}
        self._lm_by_slot: dict[int, dict] = {}

    # ── LM ──
    def _lm_record(self, ids, max_new, via: str) -> dict:
        rec = {"ids": [int(i) for i in ids], "tokens": [], "max_new": int(max_new), "t": time.monotonic(),
               "finished": False, "via": via}
        with self._lock:
            self.lm.append(rec)
        return rec

    def install_lm(self, engine) -> None:
        from s2s_tpu_torch.parallel import session_scheduler as ss

        generate, start = engine.generate, engine.start
        rec_of = self._lm_by_slot

        @functools.wraps(generate)
        def wrapped_generate(prompt_ids, max_new, *args, **kwargs):
            rec = self._lm_record(prompt_ids, max_new, "generate")
            for tok in generate(prompt_ids, max_new, *args, **kwargs):
                rec["tokens"].append(int(tok))
                yield tok
            rec["finished"] = True

        @functools.wraps(start)
        def wrapped_start(prompt_ids, max_new, *args, **kwargs):
            handle = start(prompt_ids, max_new, *args, **kwargs)
            if handle is not None:
                priority = kwargs.get("priority", args[1] if len(args) > 1 else True)
                rec = self._lm_record(prompt_ids, max_new, "start" if priority else "start/speculative")
                with self._lock:
                    rec_of[id(handle._slot)] = rec
                rec["slot"], rec["slot_id"] = handle._slot, handle._slot_id
            return handle

        engine.generate, engine.start = wrapped_generate, wrapped_start
        engine.s2sbench_recorder = self
        if not getattr(ss.GenerationHandle.tokens, "_s2sbench", False):
            tokens = ss.GenerationHandle.tokens

            def wrapped_tokens(handle):
                recorder = getattr(handle._engine, "s2sbench_recorder", None)
                if recorder is None:
                    yield from tokens(handle)
                    return
                with recorder._lock:
                    rec = recorder._lm_by_slot.get(id(handle._slot))
                for tok in tokens(handle):
                    if rec is not None:
                        rec["tokens"].append(int(tok))
                    yield tok
                if rec is not None:
                    rec["finished"] = True

            wrapped_tokens._s2sbench = True
            ss.GenerationHandle.tokens = wrapped_tokens

    # ── TTS ──
    def _tts_record(self, slot) -> dict:
        with self._lock:
            rec = self._by_slot.get(id(slot))
            if rec is None or rec["slot"] is not slot:
                rec = {"slot": slot, "text": None, "speaker": None, "chunks": [], "audio": [],
                       "t": time.monotonic(), "finished": False}
                self._by_slot[id(slot)] = rec
                self.tts.append(rec)
            return rec

    def install_tts(self, engine) -> None:
        """Each program keeps the codes it made (its chunk's frames, read from
        the engine's vocoder context) for the record call that the driver
        makes right after it, which names the slots that own the rows."""
        from s2s_tpu_torch.parallel import session_scheduler as ss

        prefill, slot_chunk, steady = engine._op_prefill, engine._op_slot_chunk, engine._op_steady_chunk
        slot_record, steady_record = engine._slot_record, engine._steady_record
        pending: dict = {}

        @functools.wraps(prefill)
        def wrapped_prefill(text_tokens, speaker, slot, n0):
            out = prefill(text_tokens, speaker, slot, n0)
            if n0:
                pending.update(text=np.array(text_tokens, np.int32).reshape(-1),
                               speaker=torch.as_tensor(speaker).reshape(-1),
                               codes=engine._contexts[slot, -n0:].clone())
            return out

        @functools.wraps(slot_chunk)
        def wrapped_slot_chunk(sid, n):
            out = slot_chunk(sid, n)
            pending["codes"] = engine._contexts[sid, -n:].clone()
            return out

        @functools.wraps(steady)
        def wrapped_steady(sids, n):
            out = steady(sids, n)
            pending["codes"] = engine._contexts[:, -n:].clone()
            return out

        @functools.wraps(slot_record)
        def wrapped_slot_record(sid, slot, n, cap, audio, eos):
            rec = self._tts_record(slot)
            if "text" in pending:
                rec["text"], rec["speaker"] = pending.pop("text"), pending.pop("speaker")
            rec["chunks"].append((n, pending.pop("codes"), None))
            return slot_record(sid, slot, n, cap, audio, eos)

        @functools.wraps(steady_record)
        def wrapped_steady_record(members, n, audio, eos):
            codes = pending.pop("codes")
            for sid, slot, _ in members:
                self._tts_record(slot)["chunks"].append((n, codes, sid))
            return steady_record(members, n, audio, eos)

        for wrapper, program in ((wrapped_prefill, prefill), (wrapped_slot_chunk, slot_chunk),
                                 (wrapped_steady, steady)):
            wrapper.dynamic_args = getattr(program, "dynamic_args", ())
        engine._op_prefill, engine._op_slot_chunk, engine._op_steady_chunk = (
            wrapped_prefill, wrapped_slot_chunk, wrapped_steady)
        engine._slot_record, engine._steady_record = wrapped_slot_record, wrapped_steady_record
        engine.s2sbench_recorder = self
        if not getattr(ss.TTSGenerationHandle.chunks, "_s2sbench", False):
            chunks = ss.TTSGenerationHandle.chunks

            def wrapped_chunks(handle):
                recorder = getattr(handle._engine, "s2sbench_recorder", None)
                if recorder is None:
                    yield from chunks(handle)
                    return
                rec = recorder._tts_record(handle._slot)
                for item in chunks(handle):
                    rec["audio"].append(np.asarray(item[0], np.float32))
                    yield item
                slot = handle._slot
                rec["finished"] = bool(slot.eos_seen or slot.remaining <= 0)

            wrapped_chunks._s2sbench = True
            ss.TTSGenerationHandle.chunks = wrapped_chunks

    # ── STT ──
    def install_stt(self, service) -> None:
        """Every transcription batch's rows: the padded audio, its valid
        samples, the served token ids and the encoder's output for the row
        (kept on the device until the window has closed)."""
        from s2s_tpu_torch.models import parakeet

        transcribe = service._transcribe
        if not getattr(parakeet.encode, "_s2sbench", False):
            encode = parakeet.encode

            def wrapped_encode(*args, **kwargs):
                out = encode(*args, **kwargs)
                if getattr(_ENCODED, "keep", False):
                    _ENCODED.value = out
                return out

            wrapped_encode._s2sbench = True
            parakeet.encode = wrapped_encode

        @functools.wraps(transcribe)
        def wrapped(batch, n_valid):
            _ENCODED.keep, _ENCODED.value = True, None
            try:
                tokens = transcribe(batch, n_valid)
                encoded = _ENCODED.value
            finally:
                _ENCODED.keep, _ENCODED.value = False, None
            now = time.monotonic()
            with self._lock:
                for row, nv in enumerate(n_valid):
                    if nv > 0:
                        self.stt.append({"audio": np.array(batch[row], np.float32), "n_valid": int(nv),
                                         "tokens": [int(t) for t in tokens[row]], "t": now, "finished": True,
                                         "enc": None if encoded is None else encoded[0][row]})
            return tokens

        service._transcribe = wrapped

    def to_host(self) -> None:
        """Move what the device holds to the host (after the window)."""
        for rec in self.tts:
            frames = []
            for n, codes, sid in rec["chunks"]:
                block = codes if sid is None else codes[sid]
                frames.append(block.cpu().numpy().astype(np.int64))
            rec["chunk_sizes"] = [n for n, _, _ in rec["chunks"]]
            rec["codes"] = np.concatenate(frames) if frames else np.zeros((0, 0), np.int64)
            rec["chunks"] = []
            if rec["speaker"] is not None:
                rec["speaker"] = rec["speaker"].float().cpu()
            rec.pop("slot", None)
        for rec in self.lm:
            rec.pop("slot", None)
        for rec in self.stt:
            if rec["enc"] is not None:
                rec["enc"] = rec["enc"].float().cpu()
        self._by_slot.clear()
        self._lm_by_slot.clear()


def engines() -> dict[str, Any]:
    """The batched engines in the program's model cache, by kind."""
    from s2s_tpu_torch.parallel.session_scheduler import BatchedLMScheduler, BatchedTTSScheduler
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
    from s2s_tpu_torch.runtime.batcher import BatchedParakeetSTT

    found: dict[str, Any] = {}
    for value in list(GLOBAL_MODEL_CACHE._models.values()):
        for item in value if isinstance(value, tuple) else (value,):
            for kind, cls in (("lm", BatchedLMScheduler), ("tts", BatchedTTSScheduler), ("stt", BatchedParakeetSTT)):
                if isinstance(item, cls):
                    found[kind] = item
    return found


class Serve:
    """One serve of a configuration on *device* with the seeded weights."""

    def __init__(self, config: dict, seed: int, device: torch.device, root: Path) -> None:
        from s2s_tpu_torch import cli
        from s2s_tpu_torch.utils.compile_guard import CompileWatch

        self.device = device
        models = config["models"]
        weights.check_against_program(models, flag_values(config["serve_flags"]))
        self.watch = CompileWatch.install()
        trees = {m: weights.make(m, models, seed, device) for m in ("parakeet", "lm", "tts")}
        self.stop_event = threading.Event()
        argv = ["--device", str(device.type), "--host", "127.0.0.1", "--port", "0", *config["serve_flags"]]
        if "llm_tokenizer" in config:
            argv += ["--llm_tokenizer", str(tokenizer.path(root, config["llm_tokenizer"]["vocab_size"]))]
        with seeded_init(trees):
            self.manager, self.server, self.args = cli.build_from_argv(argv, self.stop_event)
        if trees:
            raise RuntimeError(f"the build left seeded trees unused: {sorted(trees)}")
        self.variants_after_warmup_base = self.watch.count
        self.recorder = Recorder()
        found = engines()
        if {"lm", "tts"} - set(found):
            raise RuntimeError(f"the serve has no batched engines to record: {sorted(found)}")
        self.recorder.install_lm(found["lm"])
        self.recorder.install_tts(found["tts"])
        if "stt" in found:
            self.recorder.install_stt(found["stt"])
        self.manager.start()
        if not self.server.started.wait(60):
            raise RuntimeError("the realtime server did not start")

    @property
    def url(self) -> str:
        return f"ws://127.0.0.1:{self.server.bound_port}/v1/realtime"

    def variants_after_warmup(self) -> int:
        return self.watch.count - self.variants_after_warmup_base

    def stop(self) -> None:
        """Stop the serve and free what it holds on the device."""
        import gc

        from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

        self.stop_event.set()
        self.manager.stop()
        GLOBAL_MODEL_CACHE.clear()
        self.manager = self.server = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
