"""Backend registry of the port (after ``s2s_tpu/registry.py``).

Reuses the JAX package's jax-free registry types (``BackendSpec``,
``HandlerContext``, ``ModelCache``) and checkpoint loader, and registers the
ported backends under the SAME names, so the JAX package's flags work
verbatim: ``parakeet-tdt``, ``local-jax`` and ``qwen3``.

With several pipeline units (``--num_pipelines``) or batched slots
(``--llm_batched_slots``, ``--tts_batched_slots``) above 1, every unit shares
one weight set and one engine per model through :data:`GLOBAL_MODEL_CACHE`:
the batched Parakeet service, the batched LM engine and the batched TTS
engine, as the JAX registry builds them.  The engines share the priority
gate, which the device scheduler also holds while a session's interactive
STT runs.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from s2s_tpu.arguments import LocalLLMArgs, ParakeetSTTArgs, Qwen3TTSArgs
from s2s_tpu.registry import BackendSpec, HandlerContext, ModelCache, _load_checkpoint, _load_llm_tokenizer
from s2s_tpu_torch import weights
from s2s_tpu_torch.ops.quant import check_mode, quantize_tree

logger = logging.getLogger(__name__)

GLOBAL_MODEL_CACHE = ModelCache()

@dataclass(frozen=True)
class TorchHandlerContext(HandlerContext):
    """HandlerContext plus the device every model of the port lives on."""

    device: torch.device = torch.device("cpu")


def _global_gate():
    """The engines' shared priority gate, bridged into the device scheduler
    (its INTERACTIVE slot holds the gate, so steady chunks yield to a
    session's final STT)."""
    from s2s_tpu.runtime.device_scheduler import GLOBAL_SCHEDULER
    from s2s_tpu_torch.parallel.session_scheduler import GLOBAL_PRIORITY_GATE

    GLOBAL_SCHEDULER.priority_gate = GLOBAL_PRIORITY_GATE
    return GLOBAL_PRIORITY_GATE


def _random_init(init, cfg, device: torch.device, what: str):
    logger.warning("%s: random-init shared weights (no checkpoint)", what)
    return init(cfg, torch.Generator(device=device).manual_seed(0), device)


# ── factories ────────────────────────────────────────────────────────


def _make_parakeet_stt(config, ctx: TorchHandlerContext):
    from s2s_tpu.stt.language_id import detect_language
    from s2s_tpu_torch.stt.parakeet_handler import ParakeetSTTHandler, config_for

    tokenizer = None
    if config.tokenizer:
        from s2s_tpu.stt.tokenizer import SentencePieceTokenizer

        tokenizer = SentencePieceTokenizer.from_file(config.tokenizer)
    params = service = None
    if ctx.n_units > 1:
        # N units share ONE weight set and ONE batched service
        def build():
            from s2s_tpu_torch.models import parakeet
            from s2s_tpu_torch.runtime.batcher import BatchedParakeetSTT

            cfg = config_for(config.model_size)
            tree = _load_checkpoint(config.checkpoint)
            p = (weights.parakeet_params(tree, ctx.device) if tree is not None
                 else _random_init(parakeet.init_params, cfg, ctx.device, "parakeet STT"))
            return BatchedParakeetSTT(p, cfg, device=ctx.device, max_batch=ctx.n_units)

        service = ctx.model_cache.get(
            ("parakeet-batched", config.model_size, config.checkpoint, ctx.n_units, str(ctx.device)), build)
    else:
        tree = _load_checkpoint(config.checkpoint)
        params = weights.parakeet_params(tree, ctx.device) if tree is not None else None
    return ParakeetSTTHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            device=ctx.device,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            cancel_scope=ctx.cancel_scope,
            model_size=config.model_size,
            language=config.language,
            tokenizer=tokenizer,
            params=params,
            language_detector=detect_language,
            batch_service=service,
        ),
    )


def _make_local_llm(config, ctx: TorchHandlerContext):
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler, lm_config

    check_mode(config.quantize)
    tokenizer = _load_llm_tokenizer(config.tokenizer)
    params = shared_lm = None
    if config.batched_slots > 1:
        # ONE weight set + ONE batched decode engine for every unit/session;
        # as in the JAX package, the batched LM quantizes random init too
        def build():
            from s2s_tpu_torch.models import decoder_lm
            from s2s_tpu_torch.parallel.session_scheduler import BatchedLMScheduler

            cfg = lm_config(config.model_size)
            tree = _load_checkpoint(config.checkpoint)
            p = (weights.tree_to_torch(tree, ctx.device) if tree is not None
                 else _random_init(decoder_lm.init_params, cfg, ctx.device, "local-jax LLM"))
            if config.quantize == "int8":
                p = quantize_tree(p)
            engine = BatchedLMScheduler(
                p, cfg, n_slots=config.batched_slots,
                max_t=config.batched_max_t or min(cfg.max_seq_len, 2048),
                eos_id=tokenizer.eos_id if tokenizer is not None else 0,
                chunk_tokens=config.chunk_tokens, priority_tokens=config.priority_tokens,
                gate=_global_gate(),
            )
            return p, engine

        params, shared_lm = ctx.model_cache.get(
            ("local-lm", config.model_size, config.checkpoint, config.batched_slots, config.priority_tokens,
             config.batched_max_t, config.chunk_tokens, config.quantize, str(ctx.device)), build)
    else:
        tree = _load_checkpoint(config.checkpoint)
        if tree is not None:
            params = weights.tree_to_torch(tree, ctx.device)
            # as in the JAX package, the single-session LLM quantizes only
            # checkpoint weights; random init stays in bf16 (ROADMAP queue 3)
            if config.quantize == "int8":
                params = quantize_tree(params)
    return LocalTorchLLMHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            device=ctx.device,
            cancel_scope=ctx.cancel_scope,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            model_size=config.model_size,
            params=params,
            tokenizer=tokenizer,
            shared_lm=shared_lm,
            speculative_prefill=config.speculative_prefill,
            speculative_tts=config.speculative_tts,
            max_new_tokens=config.max_new_tokens,
            stream_batch_sentences=config.stream_batch_sentences,
            compact_history=config.compact_history,
            enable_lang_prompt=config.enable_lang_prompt,
            gen_kwargs=config.gen_kwargs,
        ),
    )


def _make_qwen3_tts(config, ctx: TorchHandlerContext):
    from s2s_tpu_torch.models.qwen3_tts import Qwen3TTS, load_speaker_file
    from s2s_tpu_torch.tts.qwen3_handler import Qwen3TTSHandler, config_for

    check_mode(config.quantize)

    def build():
        tree = _load_checkpoint(config.checkpoint)
        tokenizer = _load_llm_tokenizer(config.tokenizer)
        return Qwen3TTS(
            params=weights.qwen3_tts_params(tree, ctx.device) if tree is not None else None,
            cfg=config_for(config.model_size), chunk_frames=config.streaming_chunk_size,
            int8=config.quantize or False, tokenizer=tokenizer, device=ctx.device,
        )

    model = ctx.model_cache.get(
        ("qwen3_tts", config.model_size, config.checkpoint, config.streaming_chunk_size,
         config.quantize, config.tokenizer, str(ctx.device)),
        build,
    )
    shared_tts = None
    if config.batched_slots > 1:
        from s2s_tpu_torch.parallel.session_scheduler import BatchedTTSScheduler

        shared_tts = ctx.model_cache.get(
            ("qwen3_tts_batched", config.model_size, config.checkpoint, config.batched_slots,
             config.batched_max_t, config.context_frames, config.streaming_chunk_size, config.quantize,
             str(ctx.device)),
            lambda: BatchedTTSScheduler(
                model.params, model.cfg, n_slots=config.batched_slots,
                max_t=config.batched_max_t or min(model.cfg.lm.max_seq_len, 2048),
                context_frames=config.context_frames, chunk_frames=config.streaming_chunk_size,
                gate=_global_gate(),
            ),
        )
    return Qwen3TTSHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            device=ctx.device,
            cancel_scope=ctx.cancel_scope,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            should_listen=ctx.should_listen,
            model=model,
            voice=config.voice,
            voice_instruct=config.voice_instruct,
            ref_audio=config.ref_audio,
            speaker_vec=load_speaker_file(config.ref_spk, ctx.device) if config.ref_spk else None,
            shared_tts=shared_tts,
            speculative_synthesis=config.speculative_synthesis,
            streaming_chunk_size=config.streaming_chunk_size,
            max_new_tokens=config.max_new_tokens,
            blocksize=config.blocksize,
        ),
    )


# ── registries ───────────────────────────────────────────────────────

STT_BACKENDS: dict[str, BackendSpec] = {
    "parakeet-tdt": BackendSpec("parakeet-tdt", "stt", ParakeetSTTArgs, _make_parakeet_stt),
}
LLM_BACKENDS: dict[str, BackendSpec] = {
    "local-jax": BackendSpec("local-jax", "llm", LocalLLMArgs, _make_local_llm),
}
TTS_BACKENDS: dict[str, BackendSpec] = {
    "qwen3": BackendSpec("qwen3", "tts", Qwen3TTSArgs, _make_qwen3_tts),
}


def get_backend(kind: str, name: str) -> BackendSpec:
    registry = {"stt": STT_BACKENDS, "llm": LLM_BACKENDS, "tts": TTS_BACKENDS}[kind]
    if name not in registry:
        raise NotImplementedError(
            f"{kind} backend {name!r} is not ported to s2s_tpu_torch yet (ROADMAP queue 1); "
            f"ported: {sorted(registry)}"
        )
    return registry[name]
