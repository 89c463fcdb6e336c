"""Local LLM backend on PyTorch (port of ``s2s_tpu/llm/local_backend.py``).

The host side is the JAX handler's, copied: chat template, prompt fitting,
UTF-8-boundary streaming, cancellation, token caps and speculative
first-sentence generation (:class:`_Speculation`).  The device side runs the
port's decoder (:mod:`s2s_tpu_torch.models.decoder_lm`) on an explicit
device: a bucketed prefill, then greedy decode in chunks (one host read per
chunk) or temperature sampling from a seeded ``torch.Generator``.  With a
cross-session batched engine (``shared_lm``,
:class:`s2s_tpu_torch.parallel.session_scheduler.BatchedLMScheduler`) greedy
turns decode through it; under tensor parallelism sampled turns run on its
single-session programs over the ranks' shards (the handler keeps no
tree).  ``_jax_generate`` keeps the JAX handler's name for the generation
entry point, which the copied methods call.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from s2s_tpu_torch.llm.base_handler import BaseLLMHandler, StreamContext
from s2s_tpu_torch.llm.chat import make_user_message
from s2s_tpu_torch.llm.compaction import build_compactor
from s2s_tpu_torch.llm.utils import first_tts_chunk_text
from s2s_tpu_torch.models import decoder_lm
from s2s_tpu_torch.pipeline.messages import SpeculativeGenerateRequest, SpeculativeTTSText
from s2s_tpu_torch.runtime.device_scheduler import GLOBAL_SCHEDULER, Lane
from s2s_tpu_torch.utils.common import next_power_of_2, response_wants_audio

logger = logging.getLogger(__name__)


class _Speculation:
    """A speculative generation plus its watcher thread (whole-chain mode).

    The watcher is the slot queue's SOLE consumer: it buffers token ids (so a
    later adoption can replay them) and, once enough decoded text forms the
    first sentence batch, reports it via ``on_first_chunk`` — the handler
    turns that into a :class:`SpeculativeTTSText` so synthesis also starts
    before the STT final.  Without a watcher (``watch()`` never called) the
    class degrades to a thin wrapper over the engine handle."""

    def __init__(self, ids: list[int], handle, budget: int) -> None:
        self.ids = ids
        self.handle = handle
        #: token budget the engine slot was started with — adoption requires
        #: the real request to resolve the SAME budget (a capped response
        #: must not replay a longer speculative stream)
        self.budget = budget
        self._buffer: list[int] = []
        self._cond = threading.Condition()
        self._done = False
        self._watching = False

    def watch(self, decode_pieces, n_sentences: int, on_first_chunk) -> None:
        """Start the watcher thread.  *decode_pieces* maps an ``Iterator[int]``
        to decoded text pieces (the handler's UTF-8-boundary decoder)."""
        self._watching = True
        threading.Thread(
            target=self._feed, args=(decode_pieces, n_sentences, on_first_chunk),
            daemon=True, name="llm-spec-watch",
        ).start()

    def _feed(self, decode_pieces, n_sentences: int, on_first_chunk) -> None:
        # sole engine consumer; the strong local ref keeps the GC-close of
        # any abandoned wrapper generator below from retiring the slot
        token_iter = self.handle.tokens()

        def _buffer_token(tok: int) -> int:
            with self._cond:
                self._buffer.append(int(tok))
                self._cond.notify_all()
            return int(tok)

        try:
            try:
                text = first_tts_chunk_text(
                    decode_pieces(_buffer_token(t) for t in token_iter), n_sentences
                )
            except Exception:  # noqa: BLE001 — the announcement is optional;
                # the token BUFFER must stay intact for adoption
                logger.exception("speculation watcher decode failed; announcement skipped")
                text = None
            if text:
                try:
                    on_first_chunk(text)
                except Exception:  # noqa: BLE001 — speculation must never break serving
                    logger.exception("speculative TTS emit failed")
            # keep draining (and buffering) so adoption sees the full
            # generation; same engine stream, so nothing is double-consumed
            for tok in token_iter:
                _buffer_token(tok)
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()

    def tokens(self, cancel_check: Callable[[], bool] | None = None) -> Iterator[int]:
        """Adoption stream: replay buffered ids, then follow the watcher."""
        if not self._watching:
            self.handle.bind_cancel(cancel_check)
            yield from self.handle.tokens()
            return
        i = 0
        while True:
            if cancel_check is not None and cancel_check():
                self.handle.cancel()  # watcher drains _DONE and exits
            with self._cond:
                while i >= len(self._buffer) and not self._done:
                    self._cond.wait(timeout=0.1)
                    if cancel_check is not None and cancel_check():
                        self.handle.cancel()
                if i < len(self._buffer):
                    tok = self._buffer[i]
                    i += 1
                elif self._done:
                    return
                else:
                    continue
            yield tok

    def cancel(self) -> None:
        self.handle.cancel()

    def promote(self) -> None:
        """On adoption: any not-yet-decoded remainder is now the latency
        chain — move the slot into the engine's priority lane."""
        promote = getattr(self.handle, "promote", None)
        if promote is not None:
            promote()


class SimpleCharTokenizer:
    """Byte-level fallback tokenizer (random-weight demos and tests)."""

    vocab_size = 256
    eos_id = 0

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


def lm_config(model_size: str) -> decoder_lm.DecoderLMConfig:
    return {
        "tiny": decoder_lm.DecoderLMConfig.tiny,
        "smollm2-360m": decoder_lm.DecoderLMConfig.smollm2_360m,
        "smollm2-1.7b": decoder_lm.DecoderLMConfig.smollm2_1_7b,
        "qwen3-1.7b": decoder_lm.DecoderLMConfig.qwen3_1_7b,
    }[model_size]()


def render_chat_template(messages: list[dict[str, Any]]) -> str:
    """ChatML-style template (SmolLM2/Qwen convention)."""
    parts = []
    for m in messages:
        content = m.get("content", "")
        if isinstance(content, list):
            content = " ".join(
                c.get("text", "") for c in content if isinstance(c, dict) and c.get("text")
            )
        parts.append(f"<|im_start|>{m['role']}\n{content}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


class LocalTorchLLMHandler(BaseLLMHandler):
    """LLM stage running the port's decoder on an explicit device."""

    def setup(
        self,
        device: torch.device | str = "cpu",
        cancel_scope=None,
        speculative_turns=None,
        device_scheduler=None,
        generate_fn: Callable[..., Iterator[str]] | None = None,
        model_size: str = "tiny",
        params: Any | None = None,
        tokenizer: Any | None = None,
        gen_kwargs: dict[str, Any] | None = None,
        stream_batch_sentences: int = 3,
        enable_lang_prompt: bool = False,
        compact_history: bool = False,
        max_new_tokens: int = 256,
        shared_lm: Any | None = None,
        speculative_prefill: bool = False,
        speculative_tts: bool = False,
        warmup: bool = False,
    ) -> None:
        self.device = torch.device(device)
        self.cancel_scope = cancel_scope
        self.speculative_turns = speculative_turns
        self.scheduler = device_scheduler or GLOBAL_SCHEDULER
        self.stream_batch_sentences = max(1, stream_batch_sentences)
        self.enable_lang_prompt = enable_lang_prompt
        self.gen_kwargs = gen_kwargs or {}
        self.max_new_tokens = max_new_tokens
        #: cross-session batched decode engine (one per weight set); when
        #: present, greedy decode goes through its shared dispatch stream
        self.shared_lm = shared_lm
        #: start generating on the progressive transcript before the STT
        #: final lands; adopt iff the final renders the identical prompt
        self.speculative_prefill = bool(speculative_prefill) and shared_lm is not None
        #: whole-chain mode: a watcher thread reports the speculation's first
        #: sentence batch as SpeculativeTTSText so synthesis starts early too
        self.speculative_tts = bool(speculative_tts) and self.speculative_prefill
        self._spec: _Speculation | None = None
        self._last_real_turn: tuple[str, int | None] | None = None
        self._generate_fn = generate_fn
        if generate_fn is None:
            self._build_generator(model_size, params, tokenizer)
            if warmup:
                list(self._jax_generate([{"role": "user", "content": "hi"}], max_new=4))
        self.compactor = build_compactor(self._compaction_generate) if compact_history else None

    # ── device path ──────────────────────────────────────────────────

    def _build_generator(self, model_size, params, tokenizer):
        cfg = lm_config(model_size)
        if params is None and getattr(self.shared_lm, "tp", None) is not None:
            # tensor-parallel engine: every rank holds its shard only; the
            # single-session path (sampled decode) runs on the engine's
            # single-session programs over the ranks
            self.cfg, self.params, self.tokenizer = cfg, None, tokenizer or SimpleCharTokenizer()
            return
        if params is None:
            logger.warning("LocalTorchLLMHandler: random-init weights (no checkpoint provided)")
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = decoder_lm.init_params(cfg, gen, self.device)
        self.cfg, self.params = cfg, params
        self.tokenizer = tokenizer or SimpleCharTokenizer()

    def _jax_generate(self, messages, max_new=None, cancel_check=None, lane=Lane.INTERACTIVE) -> Iterator[str]:
        max_new = max_new or self.max_new_tokens
        prompt = render_chat_template(messages)
        ids = self._fit_prompt(self.tokenizer.encode(prompt), max_new)
        bucket = min(next_power_of_2(max(len(ids), 16)), self.cfg.max_seq_len)
        padded = np.zeros(bucket, np.int32)
        padded[: len(ids)] = ids
        temperature = float(self.gen_kwargs.get("temperature", 0.0))
        if self.shared_lm is not None and temperature <= 0:
            adopted = self._adopt_speculation(ids, max_new, cancel_check)
            if adopted is not None:
                # the speculative slot has been decoding this exact prompt
                yield from self._decode_token_stream(adopted)
                return
            # this turn shares the batched engine's dispatch stream
            yield from self._decode_token_stream(self.shared_lm.generate(ids, max_new, cancel_check=cancel_check))
            return
        with self.scheduler.slot(lane):
            max_t = min(bucket + max_new, self.cfg.max_seq_len)
            if self.params is None:
                # tensor parallelism (greedy turns took the engine above):
                # the engine's single-session programs on the ranks' shards
                logits = self.shared_lm.single_prefill(padded[None], len(ids), max_t)
                yield from self._sampled_decode(logits, None, max_new, temperature, cancel_check,
                                                lambda token, state: (self.shared_lm.single_step(token), state))
                return
            state = decoder_lm.init_decode_state(self.cfg, 1, max_t=max_t, device=self.device)
            tokens = torch.from_numpy(padded[None]).to(self.device)
            logits, state = decoder_lm.prefill(self.params, self.cfg, tokens, state, len(ids))
            if temperature > 0:
                yield from self._sampled_decode(logits, state, max_new, temperature, cancel_check)
                return
            yield from self._greedy_decode(torch.argmax(logits, dim=-1).to(torch.int32), state, max_new,
                                           cancel_check)

    def _greedy_decode(self, token, state, max_new, cancel_check) -> Iterator[str]:
        """Greedy decode from the first token (a (1,) tensor on the device)
        in chunks: one host read per ``decode_chunk_tokens`` tokens
        (cancellation polls between chunks), text emitted at UTF-8
        boundaries."""
        chunk = max(1, int(self.gen_kwargs.get("decode_chunk_tokens", 8)))
        emitted = 0
        pending: list[int] = []
        while emitted < max_new:
            n = min(chunk, max_new - emitted)
            toks_dev, _eos, token, state = decoder_lm.decode_chunk(
                self.params, self.cfg, token, state, n, self.tokenizer.eos_id
            )
            toks = toks_dev[:, 0].cpu().numpy()
            valid = n
            hit_eos = False
            nz = np.nonzero(toks == self.tokenizer.eos_id)[0]
            if len(nz):
                valid, hit_eos = int(nz[0]), True
            for t in toks[:valid]:
                pending.append(int(t))
                piece = self.tokenizer.decode(pending)
                if not piece.endswith("�"):  # only emit at UTF-8 boundaries
                    yield piece
                    pending = []
            emitted += valid
            if hit_eos:
                break
            if cancel_check is not None and cancel_check():
                break
        if pending:
            yield self.tokenizer.decode(pending)

    def _decode_step(self, token: int, state):
        return decoder_lm.decode_step(
            self.params, self.cfg, torch.tensor([token], dtype=torch.int32, device=self.device), state)

    def _sampled_decode(self, logits, state, max_new, temperature, cancel_check, step=None) -> Iterator[str]:
        """Temperature sampling with an explicit generator, seeded afresh for
        each generation so that a reply is reproducible.  *step* (token,
        state) -> (next logits, state) runs the model on a drawn token
        (default: this handler's weights)."""
        step = step or self._decode_step
        gen = torch.Generator(device=self.device).manual_seed(0)
        emitted = 0
        pending: list[int] = []
        token = int(torch.argmax(logits[0]))
        while emitted < max_new:
            if token == self.tokenizer.eos_id:
                break
            if cancel_check is not None and cancel_check():
                break
            pending.append(token)
            piece = self.tokenizer.decode(pending)
            if not piece.endswith("�"):
                yield piece
                pending = []
            emitted += 1
            step_logits, state = step(token, state)
            probs = torch.softmax(step_logits[0] / temperature, dim=-1)
            token = int(torch.multinomial(probs, 1, generator=gen))
        if pending:
            yield self.tokenizer.decode(pending)

    # ── speculative first-sentence generation (the JAX handler's) ────

    def process(self, request) -> Iterator[Any]:
        if isinstance(request, SpeculativeGenerateRequest):
            self._begin_speculation(request)
            return
        if getattr(request, "turn_id", None) is not None:
            # a spec request queued behind this real one is stale by
            # definition — remember the answered turn so it won't start
            self._last_real_turn = (request.turn_id, request.turn_revision)
        yield from super().process(request)

    def on_session_end(self) -> None:
        self.cancel_speculation()
        # turn ids restart per session; a stale answered-turn marker would
        # silently disable speculation for the next session's matching turn
        self._last_real_turn = None
        super().on_session_end()

    def cancel_speculation(self) -> None:
        spec = self._spec
        self._spec = None
        if spec is not None:
            spec.cancel()

    def _begin_speculation(self, req: SpeculativeGenerateRequest) -> None:
        # a newer partial supersedes any outstanding speculation
        self.cancel_speculation()
        if not self.speculative_prefill or self._generate_fn is not None:
            return
        if float(self.gen_kwargs.get("temperature", 0.0)) > 0:
            return  # sampled decode can't be reproduced by prompt equality
        start = getattr(self.shared_lm, "start", None)
        if start is None:
            return
        if (req.turn_id is not None
                and (req.turn_id, req.turn_revision) == getattr(self, "_last_real_turn", None)):
            return  # the final for this (turn, rev) was already answered
        if self.speculative_turns is not None and req.turn_id is not None:
            if not self.speculative_turns.is_latest(req.turn_id, req.turn_revision or 0):
                return  # superseded by a reopen while queued
        text = (req.text or "").strip()
        if not text:
            return
        ids = self._prompt_ids_for_user_text(req.runtime_config, text)
        if not ids:
            return
        # non-priority: the speculation decodes during STT dead time, so it
        # must not preempt other sessions' steady chunks on every partial
        budget = self._resolve_max_new(req.runtime_config, None)
        handle = start(ids, budget, priority=False)
        if handle is None:  # every slot busy — skip, don't queue
            return
        spec = _Speculation(ids, handle, budget)
        self._spec = spec
        # whole-chain mode: also pre-synthesize the first sentence batch —
        # skipped for tool sessions (a <code> block would make the real
        # first chunk unpredictable; mismatches are safe but pointless)
        if self.speculative_tts and not req.runtime_config.session.tools:
            runtime_config, turn_id, turn_revision = (
                req.runtime_config, req.turn_id, req.turn_revision,
            )

            def emit(chunk_text: str) -> None:
                if self._spec is not spec:
                    return  # superseded/cancelled while the sentence formed
                self.queue_out.put(
                    SpeculativeTTSText(
                        runtime_config=runtime_config, text=chunk_text,
                        turn_id=turn_id, turn_revision=turn_revision,
                    )
                )

            spec.watch(self._decode_token_stream, self.stream_batch_sentences, emit)

    def _fit_prompt(self, ids: list[int], max_new: int) -> list[int]:
        """Truncate prompt ids to the model's context AND, on the batched
        path, to the serving engine's per-slot KV capacity.  Without the
        engine fit, an over-capacity prompt reaches the scheduler's
        ``_capacity_clamp`` which (correctly, for cache integrity) zeroes
        the token budget — the turn silently produces no audio.  The engine
        fit keeps the TAIL: the rendered chat template puts the user turn
        (and the most recent context) last, so dropping the oldest tokens
        degrades style while dropping the newest would drop the question."""
        ids = ids[: self.cfg.max_seq_len - max_new - 1]
        cap_fn = getattr(self.shared_lm, "prompt_capacity", None)
        if cap_fn is not None:
            cap = cap_fn(max_new)
            if len(ids) > cap:
                logger.warning(
                    "prompt %d tokens exceeds engine capacity %d (max_new %d) "
                    "— keeping the tail; size --llm_batched_max_t for your "
                    "prompt budget", len(ids), cap, max_new,
                )
                ids = ids[-cap:] if cap > 0 else []
        return ids

    def _prompt_ids_for_user_text(self, runtime_config, text: str) -> list[int] | None:
        """Render the prompt ids the REAL request would produce if the final
        transcript equals *text* (VAD-triggered turn: response=None, session
        instructions/tools, user message appended by the service bridge)."""
        try:
            chat = runtime_config.chat.copy()
            chat.add_item(make_user_message(text))
            ctx = StreamContext()
            session = runtime_config.session
            tool_choice = session.tool_choice
            self._apply_instructions(
                chat, session.instructions, session.tools,
                str(tool_choice) if tool_choice else None, ctx,
                response_wants_audio(None),
            )
            messages = chat.to_chat_messages()
            prompt = render_chat_template(messages)
            # the REAL request truncates with ITS resolved budget; adoption
            # is exact-prompt-match, so the speculative render must fit the
            # same way or a capacity-truncated prompt would never adopt
            budget = self._resolve_max_new(runtime_config, None)
            return self._fit_prompt(self.tokenizer.encode(prompt), budget)
        except Exception:  # noqa: BLE001 — speculation must never break the turn
            logger.exception("speculative prompt render failed; skipping")
            return None

    def _adopt_speculation(self, ids: list[int], max_new: int, cancel_check):
        """Return the speculative token stream iff the real request renders
        the identical prompt (and budget); otherwise cancel it."""
        spec = self._spec
        if spec is None:
            return None
        self._spec = None
        if spec.ids != ids or max_new != spec.budget:
            spec.cancel()
            return None
        spec.promote()  # the undecoded remainder is now latency-critical
        return spec.tokens(cancel_check)

    def _decode_token_stream(self, token_ids) -> Iterator[str]:
        """Decode a stream of token ids to text at UTF-8 boundaries."""
        pending: list[int] = []
        for tok in token_ids:
            pending.append(int(tok))
            piece = self.tokenizer.decode(pending)
            if not piece.endswith("�"):
                yield piece
                pending = []
        if pending:
            yield self.tokenizer.decode(pending)

    # ── BaseLLMHandler hooks ─────────────────────────────────────────

    def _resolve_max_new(self, runtime_config, response) -> int:
        """Per-response token cap (remote-backend parity,
        ``openai_backend.py::_resolve_max_tokens``): ``response.max_output_tokens``
        wins, then the session's; ``"inf"``/absent means the CLI default.
        Always clamped to ``--llm_max_new_tokens`` — engine KV budgets and
        speculative prompt clipping are sized for it."""
        cap = (
            response.max_output_tokens if response and response.max_output_tokens
            else (runtime_config.session.max_output_tokens if runtime_config else None)
        )
        if cap in (None, "inf"):
            return self.max_new_tokens
        return max(1, min(int(cap), self.max_new_tokens))

    def _generate_stream(self, chat, ctx: StreamContext, runtime_config, response) -> Iterator[str]:
        messages = chat.to_chat_messages()
        gen = ctx.cancel_generation
        cancel = None
        if self.cancel_scope is not None and gen is not None:
            cancel = lambda: self.cancel_scope.is_stale(gen)  # noqa: E731
        if self._generate_fn is not None:
            yield from self._generate_fn(messages, self.gen_kwargs)
            return
        ctx.input_tokens = len(self.tokenizer.encode(render_chat_template(messages)))
        n_out = 0
        max_new = self._resolve_max_new(runtime_config, response)
        for piece in self._jax_generate(messages, max_new=max_new, cancel_check=cancel):
            n_out += len(self.tokenizer.encode(piece))
            yield piece
        ctx.output_tokens = n_out

    def _compaction_generate(self, system: str, user: str) -> str:
        messages = [{"role": "system", "content": system}, {"role": "user", "content": user}]
        if self._generate_fn is not None:
            return "".join(self._generate_fn(messages, self.gen_kwargs))
        # Background lane: compaction yields to interactive voice traffic.
        return "".join(self._jax_generate(messages, max_new=self.max_new_tokens, lane=Lane.BACKGROUND))
