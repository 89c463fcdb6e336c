"""Backend registry of the port (after ``s2s_tpu/registry.py``).

Reuses the JAX package's jax-free registry types (``BackendSpec``,
``HandlerContext``, ``ModelCache``) and checkpoint loader, and registers the
ported backends under the SAME names, so the JAX package's flags work
verbatim: ``parakeet-tdt``, ``local-jax`` and ``qwen3``.  Only the
single-session serve is ported: :func:`refuse_batched` (called by the
builder) makes a cross-session batched engine (``--num_pipelines``,
``--llm_batched_slots`` or ``--tts_batched_slots`` above 1) raise at build
time instead of degrading.
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

_BATCHED_ITEM = "ROADMAP queue 1 item 1 (batched engine: batched_decode tail programs, BatchedLMScheduler, " \
                "BatchedTTSScheduler, BatchedParakeetSTT)"


@dataclass(frozen=True)
class TorchHandlerContext(HandlerContext):
    """HandlerContext plus the device every model of the port lives on."""

    device: torch.device = torch.device("cpu")


def refuse_batched(flag: str, value: int) -> None:
    if value > 1:
        raise NotImplementedError(
            f"{flag} {value}: s2s_tpu_torch serves one session per process so far; the "
            f"cross-session batched engine is {_BATCHED_ITEM}. Use {flag} 1."
        )


# ── factories ────────────────────────────────────────────────────────


def _make_parakeet_stt(config, ctx: TorchHandlerContext):
    from s2s_tpu.stt.language_id import detect_language
    from s2s_tpu_torch.stt.parakeet_handler import ParakeetSTTHandler

    tokenizer = None
    if config.tokenizer:
        from s2s_tpu.stt.tokenizer import SentencePieceTokenizer

        tokenizer = SentencePieceTokenizer.from_file(config.tokenizer)
    tree = _load_checkpoint(config.checkpoint)
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
            params=weights.parakeet_params(tree, ctx.device) if tree is not None else None,
            language_detector=detect_language,
        ),
    )


def _make_local_llm(config, ctx: TorchHandlerContext):
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler

    check_mode(config.quantize)
    params = None
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
            tokenizer=_load_llm_tokenizer(config.tokenizer),
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
