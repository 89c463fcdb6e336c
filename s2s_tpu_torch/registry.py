"""Backend registry of the port (after ``s2s_tpu/registry.py``).

The registry types (``BackendSpec``, ``HandlerContext``, ``ModelCache``),
the checkpoint loader and the backend aliases are the JAX package's, copied;
``HandlerContext`` also carries the device every model of the port lives on.
The ported backends register under the SAME names, so the JAX package's
flags work verbatim; every backend of the JAX registry is ported:
``whisper`` (and its ``faster-whisper``, ``whisper-mlx`` and
``mlx-audio-whisper`` aliases), ``parakeet-tdt``, ``paraformer``, ``none``
(audio straight to the LLM), ``responses-api`` and ``chat-completions`` (the
remote LLMs, host code copied from the JAX package), ``local-jax``,
``local-vlm`` (SmolVLM's tower before the local LM, single-session), and
every TTS family: ``qwen3``, ``kokoro`` (Kokoro-82M), ``facebookMMS``
(MMS/VITS), ``pocket`` (Pocket-TTS with Mimi) and ``chatTTS``.

With several pipeline units (``--num_pipelines``) or batched slots
(``--llm_batched_slots``, ``--tts_batched_slots``) above 1, every unit shares
one weight set and one engine per model through :data:`GLOBAL_MODEL_CACHE`:
the batched Parakeet service, the batched LM engine and the batched TTS
engine, as the JAX registry builds them.  The engines share the priority
gate, which the device scheduler also holds while a session's interactive
STT runs.

With ``--model_parallel N`` the batched LM engine and the batched Qwen3-TTS
engine's talker run over N ranks (:func:`tp_engines`; the single-session
paths never do, as in the JAX registry): each is built on the leader here
and on each follower by :func:`build_tp_engines`, from the same weights,
quantized whole and then split (:func:`_tp_shard_lm`).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from queue import Queue
from typing import Any, Callable, Type

import torch

from s2s_tpu_torch import weights
from s2s_tpu_torch.ops.quant import LLM_MODES, TTS_MODES, check_mode, quantize_mode

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class BackendCapabilities:
    bypasses_transcription_notifier: bool = False
    supports_audio_input: bool = False
    supports_llm_proxy: bool = False


@dataclass(frozen=True)
class HandlerContext:
    """Everything a handler factory may wire in."""

    stop_event: Any
    queue_in: Queue
    queue_out: Queue
    text_output_queue: Queue
    should_listen: Any
    cancel_scope: Any
    speculative_turns: Any
    device_scheduler: Any
    model_cache: "ModelCache"
    #: how many pipeline units share this process (the cross-session
    #: batched services engage only when > 1)
    n_units: int = 1
    #: tensor-parallel width (--model_parallel); > 1 splits the batched LM
    #: and the Qwen3-TTS talker over that many ranks (see _tp_shard_lm)
    model_parallel: int = 1
    #: the device every model of the port lives on
    device: torch.device = torch.device("cpu")
    #: the leader's tensor-parallel runtime (``parallel.mesh.TPRuntime``)
    #: when model_parallel > 1
    tp: Any = None


@dataclass(frozen=True)
class BackendSpec:
    name: str
    kind: str  # "stt" | "llm" | "tts"
    config_type: Type
    create_handler: Callable[[Any, HandlerContext], Any]
    capabilities: BackendCapabilities = field(default_factory=BackendCapabilities)


class ModelCache:
    """Process-wide jitted-model cache keyed by (factory, config-key)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._models: dict[tuple, Any] = {}

    def get(self, key: tuple, factory: Callable[[], Any]) -> Any:
        with self._lock:
            if key not in self._models:
                logger.info("Loading shared model %s", key)
                self._models[key] = factory()
            return self._models[key]

    def clear(self) -> None:
        """Drop every cached model/engine, shutting down engines that have a
        shutdown() (tests; a serve process keeps the cache for its lifetime)."""
        with self._lock:
            values, self._models = list(self._models.values()), {}
        for value in values:
            engines = value if isinstance(value, tuple) else (value,)
            for engine in engines:
                stop = getattr(engine, "shutdown", None) or getattr(engine, "close", None)
                if callable(stop):
                    try:
                        stop()
                    except Exception:  # noqa: BLE001
                        logger.exception("engine shutdown during cache clear failed")


GLOBAL_MODEL_CACHE = ModelCache()


def _global_gate():
    """The engines' shared priority gate, bridged into the device scheduler
    (its INTERACTIVE slot holds the gate, so steady chunks yield to a
    session's final STT)."""
    from s2s_tpu_torch.parallel.session_scheduler import GLOBAL_PRIORITY_GATE
    from s2s_tpu_torch.runtime.device_scheduler import GLOBAL_SCHEDULER

    GLOBAL_SCHEDULER.priority_gate = GLOBAL_PRIORITY_GATE
    return GLOBAL_PRIORITY_GATE


def _random_init(init, cfg, device: torch.device, what: str):
    logger.warning("%s: random-init shared weights (no checkpoint)", what)
    return init(cfg, torch.Generator(device=device).manual_seed(0), device)


# ── factories ────────────────────────────────────────────────────────


def _make_whisper_stt(config, ctx: HandlerContext):
    from s2s_tpu_torch.stt.whisper_handler import WhisperSTTHandler

    tokenizer = None
    if config.tokenizer:
        from s2s_tpu_torch.stt.tokenizer import ByteLevelTokenizer

        tokenizer = ByteLevelTokenizer.from_file(config.tokenizer)
    tree = _load_checkpoint(config.checkpoint)
    return WhisperSTTHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            device=ctx.device,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            cancel_scope=ctx.cancel_scope,
            model_size=config.model_size,
            language=config.language,
            tokenizer=tokenizer,
            params=weights.whisper_to_torch(tree, ctx.device) if tree is not None else None,
        ),
    )


def _make_parakeet_stt(config, ctx: HandlerContext):
    from s2s_tpu_torch.stt.language_id import detect_language
    from s2s_tpu_torch.stt.parakeet_handler import ParakeetSTTHandler, config_for

    tokenizer = None
    if config.tokenizer:
        from s2s_tpu_torch.stt.tokenizer import SentencePieceTokenizer

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


def _make_paraformer_stt(config, ctx: HandlerContext):
    from s2s_tpu_torch.stt.paraformer_handler import ParaformerSTTHandler

    tree = _load_checkpoint(config.checkpoint)
    return ParaformerSTTHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            device=ctx.device,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            cancel_scope=ctx.cancel_scope,
            model_size=config.model_size,
            language=config.language,
            params=weights.paraformer_params(tree, ctx.device) if tree is not None else None,
        ),
    )


def _make_none_stt(config, ctx: HandlerContext):
    from s2s_tpu_torch.llm.audio_input_notifier import AudioInputNotifier

    return AudioInputNotifier(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            text_output_queue=ctx.text_output_queue,
            speculative_turns=ctx.speculative_turns,
        ),
    )


def _make_remote_llm(shape: str):
    def make(config, ctx: HandlerContext):
        from s2s_tpu_torch.llm.openai_backend import ChatCompletionsHandler, ResponsesAPIHandler

        cls = ResponsesAPIHandler if shape == "responses" else ChatCompletionsHandler
        return cls(
            ctx.stop_event, ctx.queue_in, ctx.queue_out,
            setup_kwargs=dict(
                cancel_scope=ctx.cancel_scope,
                speculative_turns=ctx.speculative_turns,
                model_name=config.model_name,
                base_url=config.base_url,
                api_key=config.api_key,
                stream=config.stream,
                stream_batch_sentences=config.stream_batch_sentences,
                compact_history=config.compact_history,
                enable_lang_prompt=config.enable_lang_prompt,
                disable_thinking=config.disable_thinking,
                reasoning_effort=config.reasoning_effort,
                timeout_s=config.timeout_s,
                audio_content_type=config.audio_content_type,
                audio_max_tokens=config.audio_max_tokens,
                audio_history_turns=config.audio_history_turns,
                gen_kwargs=config.gen_kwargs,
            ),
        )

    return make


def _load_llm_tokenizer(path):
    if not path:
        return None
    from s2s_tpu_torch.llm.bpe_tokenizer import BPETokenizer

    return BPETokenizer(path)


def tp_engines(args) -> tuple[str, ...]:
    """The engines a ``--model_parallel`` serve runs over its ranks
    (``parallel.mesh.TP_ENGINES`` names): ``"lm"`` for the batched local LM,
    ``"tts"`` for the batched Qwen3-TTS engine."""
    names = []
    if (resolve_backend_alias("llm", args.module.llm_backend) == "local-jax"
            and args.llm_config.batched_slots > 1):
        names.append("lm")
    if args.module.tts == "qwen3" and args.tts_config.batched_slots > 1:
        names.append("tts")
    return tuple(names)


def _tp_group(ctx: HandlerContext, engine: str):
    """The leader's group for *engine* (None without tensor parallelism);
    raises, as the JAX registry does, when no runtime spans the ranks."""
    if ctx.model_parallel <= 1:
        return None
    if ctx.tp is None:
        from s2s_tpu_torch.parallel.mesh import tp_layout

        tp_layout(ctx.model_parallel, ctx.device)  # raises when too few devices are visible
        raise RuntimeError(f"--model_parallel {ctx.model_parallel}: no tensor-parallel runtime; the builder "
                           "starts one (builder.build_pipeline)")
    return ctx.tp.group(engine)


def check_tp_heads(cfg, n: int, what: str) -> None:
    """Raise when *n* ranks do not divide the query and kv heads of *cfg*
    (each rank holds whole heads and their kv heads)."""
    if cfg.n_heads % n or cfg.n_kv_heads % n:
        raise ValueError(f"--model_parallel {n}: {what} has {cfg.n_heads} query and {cfg.n_kv_heads} kv heads, "
                         f"which {n} ranks do not divide")


def _tp_shard_lm(params, cfg, tp, what: str, talker: bool = False):
    """One rank's shard of a decoder-LM tree for ``--model_parallel`` (the
    JAX registry's ``_tp_shard_lm``): the megatron specs of
    ``decoder_lm.param_shardings``, taken by ``mesh.local_shard``.  The
    Qwen3-TTS talker (*talker*) has no head of its own (its head is the
    separate ``codec_head``) and keeps its codec embedding whole.  Called on
    a quantized tree: the whole tree is quantized first, so a row-parallel
    shard keeps the scales of its whole input dim, as JAX's quantize of a
    sharded tree computes them."""
    from s2s_tpu_torch.models import decoder_lm
    from s2s_tpu_torch.models.common import P
    from s2s_tpu_torch.parallel.mesh import local_shard

    check_tp_heads(cfg, tp.size, what)
    specs = decoder_lm.param_shardings(cfg)
    if talker:
        specs.pop("lm_head", None)
        specs["embed"] = P()
    logger.info("TP-sharding %s: rank %d of %d", what, tp.rank, tp.size)
    return local_shard(params, specs, tp.rank, tp.size)


def _build_lm_engine(config, device: torch.device, tp=None):
    """The batched LM: (the whole tree the handler keeps, the engine).  As
    in the JAX package, the batched LM quantizes random init too; with *tp*
    the engine runs on this rank's shard of the quantized tree, and no rank
    keeps the whole tree (the handler gets None: its single-session path,
    sampled decode, is refused under tensor parallelism, see
    ``builder.check_supported``)."""
    from s2s_tpu_torch.llm.local_backend import lm_config
    from s2s_tpu_torch.models import decoder_lm
    from s2s_tpu_torch.parallel.session_scheduler import BatchedLMScheduler

    cfg = lm_config(config.model_size)
    tokenizer = _load_llm_tokenizer(config.tokenizer)
    tree = _load_checkpoint(config.checkpoint)
    p = (weights.tree_to_torch(tree, device) if tree is not None
         else _random_init(decoder_lm.init_params, cfg, device, "local-jax LLM"))
    p = quantize_mode(p, config.quantize)
    shard = p
    if tp is not None:
        shard, p = _tp_shard_lm(p, cfg, tp, f"--llm_model_size {config.model_size}"), None
    engine = BatchedLMScheduler(
        shard, cfg, n_slots=config.batched_slots,
        max_t=config.batched_max_t or min(cfg.max_seq_len, 2048),
        eos_id=tokenizer.eos_id if tokenizer is not None else 0,
        chunk_tokens=config.chunk_tokens, priority_tokens=config.priority_tokens,
        gate=_global_gate(), tp=tp,
    )
    return p, engine


def _make_local_llm(config, ctx: HandlerContext):
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler

    check_mode(config.quantize, LLM_MODES)
    tokenizer = _load_llm_tokenizer(config.tokenizer)
    params = shared_lm = None
    if config.batched_slots > 1:
        # ONE weight set + ONE batched decode engine for every unit/session
        params, shared_lm = ctx.model_cache.get(
            ("local-lm", config.model_size, config.checkpoint, config.batched_slots, config.priority_tokens,
             config.batched_max_t, config.chunk_tokens, config.quantize, str(ctx.device), ctx.model_parallel,
             ctx.tp),
            lambda: _build_lm_engine(config, ctx.device, _tp_group(ctx, "lm")))
        if ctx.tp is not None:
            ctx.tp.attach("lm", shared_lm)
    else:
        tree = _load_checkpoint(config.checkpoint)
        if tree is not None:
            # as in the JAX package, the single-session LLM quantizes only
            # checkpoint weights; random init stays in bf16 (ROADMAP queue 3)
            params = quantize_mode(weights.tree_to_torch(tree, ctx.device), config.quantize)
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


def _make_local_vlm(config, ctx: HandlerContext):
    from s2s_tpu_torch.llm.vlm_backend import VisionLocalTorchLLMHandler

    # single-session, as in the JAX package: no shared engine, no quantize mode
    tree = _load_checkpoint(config.checkpoint)
    return VisionLocalTorchLLMHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            device=ctx.device,
            cancel_scope=ctx.cancel_scope,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            model_size=config.model_size,
            params=weights.tree_to_torch(tree, ctx.device) if tree is not None else None,
            max_new_tokens=config.max_new_tokens,
            stream_batch_sentences=config.stream_batch_sentences,
            compact_history=config.compact_history,
            enable_lang_prompt=config.enable_lang_prompt,
            gen_kwargs=config.gen_kwargs,
        ),
    )


def _build_qwen3_model(config, device: torch.device):
    from s2s_tpu_torch.models.qwen3_tts import CONFIGS, Qwen3TTS

    tree = _load_checkpoint(config.checkpoint)
    tokenizer = _load_llm_tokenizer(config.tokenizer)
    return Qwen3TTS(
        params=weights.qwen3_tts_params(tree, device) if tree is not None else None,
        cfg=CONFIGS[config.model_size](), chunk_frames=config.streaming_chunk_size,
        int8=config.quantize or False, tokenizer=tokenizer, device=device,
    )


def _build_tts_engine(model, config, tp=None):
    """The batched Qwen3-TTS engine over *model*'s weights; with *tp*, on
    this rank's shard of the (already quantized) talker, the code predictor
    and Code2Wav replicated, as the JAX registry shards it."""
    from s2s_tpu_torch.parallel.session_scheduler import BatchedTTSScheduler

    params = model.params
    if tp is not None:
        params = dict(model.params)
        params["talker"] = _tp_shard_lm(model.params["talker"], model.cfg.lm, tp,
                                        f"the Qwen3-TTS talker (--tts_model_size {config.model_size})",
                                        talker=True)
    return BatchedTTSScheduler(
        params, model.cfg, n_slots=config.batched_slots,
        max_t=config.batched_max_t or min(model.cfg.lm.max_seq_len, 2048),
        context_frames=config.context_frames, chunk_frames=config.streaming_chunk_size,
        gate=_global_gate(), tp=tp,
    )


def build_tp_engines(args, runtime) -> dict[str, Any]:
    """A follower's engines (:func:`tp_engines`), each built as the leader's
    registry builds it, on this rank's shard, over *runtime*'s groups."""
    engines: dict[str, Any] = {}
    names = tp_engines(args)
    if "lm" in names:
        _, engines["lm"] = _build_lm_engine(args.llm_config, runtime.device, runtime.group("lm"))
    if "tts" in names:
        model = _build_qwen3_model(args.tts_config, runtime.device)
        engines["tts"] = _build_tts_engine(model, args.tts_config, runtime.group("tts"))
    return engines


def _make_qwen3_tts(config, ctx: HandlerContext):
    from s2s_tpu_torch.models.qwen3_tts import load_speaker_file
    from s2s_tpu_torch.tts.qwen3_handler import Qwen3TTSHandler

    check_mode(config.quantize, TTS_MODES)
    model = ctx.model_cache.get(
        ("qwen3_tts", config.model_size, config.checkpoint, config.streaming_chunk_size,
         config.quantize, config.tokenizer, str(ctx.device)),
        lambda: _build_qwen3_model(config, ctx.device),
    )
    shared_tts = None
    if config.batched_slots > 1:
        shared_tts = ctx.model_cache.get(
            ("qwen3_tts_batched", config.model_size, config.checkpoint, config.batched_slots,
             config.batched_max_t, config.context_frames, config.streaming_chunk_size, config.quantize,
             str(ctx.device), ctx.model_parallel, ctx.tp),
            lambda: _build_tts_engine(model, config, _tp_group(ctx, "tts")),
        )
        if ctx.tp is not None:
            ctx.tp.attach("tts", shared_tts)
    ref_audio = None
    if config.ref_audio:
        import wave

        import numpy as np

        with wave.open(config.ref_audio) as w:
            ref_audio = (
                np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32) / 32768.0
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
            ref_audio=ref_audio,
            speaker_vec=load_speaker_file(config.ref_spk, ctx.device) if config.ref_spk else None,
            shared_tts=shared_tts,
            speculative_synthesis=config.speculative_synthesis,
            streaming_chunk_size=config.streaming_chunk_size,
            max_new_tokens=config.max_new_tokens,
            blocksize=config.blocksize,
        ),
    )


def _make_kokoro_tts(config, ctx: HandlerContext):
    from s2s_tpu_torch.models.kokoro import KokoroTTS
    from s2s_tpu_torch.tts.kokoro_handler import KokoroTTSHandler

    def build():
        vocab = _load_vocab_sidecar(config.checkpoint)
        g2p = None
        if vocab is not None and not getattr(config, "phoneme_input", False):
            from s2s_tpu_torch.tts.g2p import resolve_phonemizer

            g2p = resolve_phonemizer(getattr(config, "lang", "en-us"))
        tree = _load_checkpoint(config.checkpoint)
        model = KokoroTTS(params=weights.kokoro_params(tree, ctx.device) if tree is not None else None,
                          vocab=vocab, g2p=g2p, device=ctx.device)
        if config.voicepack:
            pack = _load_checkpoint(config.voicepack)
            model.add_voice(config.voice or "default", pack["pack"])
        return model

    model = ctx.model_cache.get(
        ("kokoro", config.checkpoint, config.voicepack,
         getattr(config, "lang", "en-us"), getattr(config, "phoneme_input", False), str(ctx.device)),
        build,
    )
    return KokoroTTSHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            cancel_scope=ctx.cancel_scope,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            should_listen=ctx.should_listen,
            model=model,
            voice=config.voice,
            speed=config.speed,
            blocksize=config.blocksize,
            speculative_synthesis=getattr(config, "speculative_synthesis", True),
        ),
    )


def _make_mms_tts(config, ctx: HandlerContext):
    from s2s_tpu_torch.models.vits import VitsTTS
    from s2s_tpu_torch.tts.mms_handler import MMSTTSHandler

    def build():
        tree = _load_checkpoint(config.checkpoint)
        return VitsTTS(params=weights.vits_params(tree, ctx.device) if tree is not None else None,
                       vocab=_load_vocab_sidecar(config.checkpoint), device=ctx.device)

    model = ctx.model_cache.get(("mms_vits", config.checkpoint, str(ctx.device)), build)
    return MMSTTSHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            cancel_scope=ctx.cancel_scope,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            should_listen=ctx.should_listen,
            model=model,
            language=config.language,
            speed=config.speed,
            blocksize=config.blocksize,
            speculative_synthesis=getattr(config, "speculative_synthesis", True),
        ),
    )


def _make_pocket_tts(config, ctx: HandlerContext):
    from s2s_tpu_torch.models.pocket_tts import PocketTTS
    from s2s_tpu_torch.tts.pocket_handler import PocketTTSHandler

    def build():
        tokenizer = None
        if getattr(config, "tokenizer", None):
            from s2s_tpu_torch.stt.tokenizer import SentencePieceTokenizer

            tokenizer = SentencePieceTokenizer.from_file(config.tokenizer)
        tree = _load_checkpoint(config.checkpoint)
        model = PocketTTS(params=weights.pocket_params(tree, ctx.device) if tree is not None else None,
                          tokenizer=tokenizer, device=ctx.device)
        # named voice prefixes: --tts_ref_spk <converted pocket-voice .npz>
        # (one file -> voice name = file stem)
        if getattr(config, "ref_spk", None):
            import os

            tree = _load_checkpoint(config.ref_spk)
            voice = tree.get("voice") if isinstance(tree, dict) else tree
            model.add_voice(os.path.splitext(os.path.basename(config.ref_spk))[0], voice)
        return model

    model = ctx.model_cache.get(
        ("pocket-tts", config.checkpoint, getattr(config, "ref_spk", None), str(ctx.device)), build)
    ref = None
    if config.ref_audio:
        import wave

        import numpy as np

        with wave.open(config.ref_audio) as w:
            ref = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32) / 32768.0
    voice = getattr(config, "voice", None) or (sorted(model.voices)[0] if model.voices else None)
    return PocketTTSHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            cancel_scope=ctx.cancel_scope,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            should_listen=ctx.should_listen,
            model=model,
            voice=voice,
            voice_ref_audio=ref,
            speed=config.speed,
            blocksize=config.blocksize,
            speculative_synthesis=getattr(config, "speculative_synthesis", True),
        ),
    )


def _make_chattts(config, ctx: HandlerContext):
    from s2s_tpu_torch.models.chattts import ChatTTSModel
    from s2s_tpu_torch.tts.chattts_handler import ChatTTSHandler

    def build():
        tree = _load_checkpoint(config.checkpoint)
        return ChatTTSModel(params=weights.chattts_params(tree, ctx.device) if tree is not None else None,
                            device=ctx.device)

    model = ctx.model_cache.get(("chattts", config.checkpoint, str(ctx.device)), build)
    return ChatTTSHandler(
        ctx.stop_event, ctx.queue_in, ctx.queue_out,
        setup_kwargs=dict(
            cancel_scope=ctx.cancel_scope,
            speculative_turns=ctx.speculative_turns,
            device_scheduler=ctx.device_scheduler,
            should_listen=ctx.should_listen,
            model=model,
            stream=config.stream,
            seed=config.seed,
            blocksize=config.blocksize,
            speculative_synthesis=getattr(config, "speculative_synthesis", True),
        ),
    )


def _load_vocab_sidecar(path: str | None):
    """MMS per-language char vocab written by the converter next to the npz."""
    if not path:
        return None
    import json
    import os

    sidecar = path + ".vocab.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return None


def _load_checkpoint(path: str | None):
    """Load converted weights from an .npz/.msgpack file (None -> random init)."""
    if not path:
        return None
    import numpy as np

    if path.endswith(".npz"):
        flat = dict(np.load(path, allow_pickle=False))
        return unflatten_params(flat)
    raise ValueError(f"Unsupported checkpoint format: {path}")


def unflatten_params(flat: dict) -> dict:
    """'a/b/0/c' -> nested dict/list pytree."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for i, part in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            default: Any = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                idx = int(part)
                while len(node) <= idx:
                    node.append(None)
                if node[idx] is None:
                    node[idx] = default
                node = node[idx]
            else:
                node = node.setdefault(part, default)
        last = parts[-1]
        if isinstance(node, list):
            idx = int(last)
            while len(node) <= idx:
                node.append(None)
            node[idx] = value
        else:
            node[last] = value
    return root


# ── registries ───────────────────────────────────────────────────────

from s2s_tpu_torch.arguments import (  # noqa: E402
    ChatTTSArgs,
    KokoroTTSArgs,
    LocalLLMArgs,
    MMSTTSArgs,
    ParaformerArgs,
    ParakeetSTTArgs,
    PocketTTSArgs,
    Qwen3TTSArgs,
    RemoteLLMArgs,
    WhisperSTTArgs,
)

STT_BACKENDS: dict[str, BackendSpec] = {
    "whisper": BackendSpec("whisper", "stt", WhisperSTTArgs, _make_whisper_stt),
    "parakeet-tdt": BackendSpec("parakeet-tdt", "stt", ParakeetSTTArgs, _make_parakeet_stt),
    "paraformer": BackendSpec("paraformer", "stt", ParaformerArgs, _make_paraformer_stt),
    "none": BackendSpec(
        "none", "stt", WhisperSTTArgs, _make_none_stt,
        BackendCapabilities(bypasses_transcription_notifier=True),
    ),
}
LLM_BACKENDS: dict[str, BackendSpec] = {
    "responses-api": BackendSpec(
        "responses-api", "llm", RemoteLLMArgs, _make_remote_llm("responses"),
        BackendCapabilities(supports_audio_input=True, supports_llm_proxy=True),
    ),
    "chat-completions": BackendSpec(
        "chat-completions", "llm", RemoteLLMArgs, _make_remote_llm("chat"),
        BackendCapabilities(supports_audio_input=True, supports_llm_proxy=True),
    ),
    "local-jax": BackendSpec("local-jax", "llm", LocalLLMArgs, _make_local_llm),
    "local-vlm": BackendSpec("local-vlm", "llm", LocalLLMArgs, _make_local_vlm),
}
TTS_BACKENDS: dict[str, BackendSpec] = {
    "qwen3": BackendSpec("qwen3", "tts", Qwen3TTSArgs, _make_qwen3_tts),
    "kokoro": BackendSpec("kokoro", "tts", KokoroTTSArgs, _make_kokoro_tts),
    "facebookMMS": BackendSpec("facebookMMS", "tts", MMSTTSArgs, _make_mms_tts),
    "pocket": BackendSpec("pocket", "tts", PocketTTSArgs, _make_pocket_tts),
    "chatTTS": BackendSpec("chatTTS", "tts", ChatTTSArgs, _make_chattts),
}


BACKEND_ALIASES: dict[str, dict[str, str]] = {
    "stt": {
        "faster-whisper": "whisper",
        "whisper-mlx": "whisper",
        "mlx-audio-whisper": "whisper",
    },
    "llm": {
        "transformers": "local-jax",
        "mlx-lm": "local-jax",
    },
    "tts": {},
}


def resolve_backend_alias(kind: str, name: str) -> str:
    """Map a reference backend name onto the spec that serves its family."""
    canon = BACKEND_ALIASES.get(kind, {}).get(name)
    if canon is None:
        return name
    logger.info("%s backend %r is served by %r", kind.upper(), name, canon)
    return canon


def get_backend(kind: str, name: str) -> BackendSpec:
    name = resolve_backend_alias(kind, name)
    registry = {"stt": STT_BACKENDS, "llm": LLM_BACKENDS, "tts": TTS_BACKENDS}[kind]
    if name not in registry:
        raise ValueError(f"Unknown {kind} backend {name!r}; available: {sorted(registry)}")
    return registry[name]
