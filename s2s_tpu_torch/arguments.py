"""Dataclass-driven CLI argument system (reference ``arguments_classes/`` +
``s2s_pipeline.py:170-280``).

Three-phase parse: (1) selector pre-parse picks the active backends, (2) a
strict argparse over [module, server, VAD, selected backend configs], (3)
leftover flags matching an *inactive* backend's config are warned-then-
ignored; anything else errors.  Alternatively a single ``config.json`` path
supplies everything.  ``gen_*`` flags fold into each backend's
``gen_kwargs``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, Optional, Type

logger = logging.getLogger(__name__)


# ── config dataclasses ───────────────────────────────────────────────


@dataclass
class ModuleArgs:
    """Backend selectors + global switches."""

    stt: str = "whisper"  # whisper | parakeet-tdt | none
    llm_backend: str = "responses-api"  # responses-api | chat-completions | local-jax
    tts: str = "qwen3"  # qwen3 | kokoro
    enable_live_transcription: bool = True
    enable_llm_proxy: bool = False
    num_pipelines: int = 1
    log_level: str = "info"
    profile_dir: Optional[str] = None  # jax profiler trace output (TensorBoard)
    #: compile every batched-engine program variant at startup (slower boot,
    #: no multi-second cold-compile stall when the first sessions arrive)
    warmup_engines: bool = False
    #: tensor-parallel width for the on-device engines: shard the local-LLM
    #: and Qwen3-TTS talker weights megatron-style over a (1, N) device mesh
    #: (parallel/mesh.py; XLA inserts the all-reduces over ICI).  1 = single
    #: chip (default).  Requires N visible devices; sessions still batch
    #: along slots, so TP multiplies per-chip session capacity rather than
    #: splitting it.  The growth path SURVEY §2.10 reserves.
    model_parallel: int = 1


@dataclass
class RealtimeServerArgs:
    host: str = "127.0.0.1"
    port: int = 8123
    chat_size: int = 30
    default_instructions: Optional[str] = None
    webrtc_port: Optional[int] = None  # SDP endpoint port (default: ephemeral)
    webrtc_ice_servers: Optional[str] = None  # comma-separated stun/turn URLs


@dataclass
class VADArgs:
    """Every turn-taking knob (reference ``vad_arguments.py``)."""

    prefix = "vad"

    #: "silero" (JAX Silero port, needs a converted checkpoint to be
    #: meaningful) or "energy" (checkpoint-free RMS + adaptive noise floor,
    #: vad/energy.py — CI/soak/offline environments)
    backend: str = "silero"
    thresh: float = 0.6
    min_silence_ms: int = 64
    min_speech_ms: int = 384
    min_speech_continuation_ms: int = 192
    max_speech_ms: float = float("inf")
    speech_pad_ms: int = 30
    realtime_processing_pause: float = 0.5
    speculative_reopen_ms: int = 800
    unanswered_reopen_ms: int = 7000
    short_segment_merge_ms: int = 0
    smart_turn: bool = True
    smart_turn_threshold: float = 0.5
    smart_turn_checkpoint: Optional[str] = None  # converted whisper-encoder+head npz
    smart_turn_max_wait_ms: int = 2000
    smart_turn_incomplete_delay_ms: int = 600
    # optional DeepFilterNet-method enhancement of VAD-final audio
    # (converted checkpoint npz; absent = no enhancement, like the reference)
    enhancer_checkpoint: Optional[str] = None


@dataclass
class WhisperSTTArgs:
    prefix = "stt"

    model_size: str = "tiny"
    language: Optional[str] = None
    checkpoint: Optional[str] = None  # path to converted weights (msgpack/npz)
    tokenizer: Optional[str] = None  # path to tokenizer.json / vocab.json


@dataclass
class ParakeetSTTArgs:
    prefix = "stt"

    model_size: str = "0.6b"
    language: Optional[str] = None
    checkpoint: Optional[str] = None
    tokenizer: Optional[str] = None


@dataclass
class ParaformerArgs:
    prefix = "stt"

    model_size: str = "default"
    language: Optional[str] = "zh"
    checkpoint: Optional[str] = None
    tokenizer: Optional[str] = None


@dataclass
class RemoteLLMArgs:
    prefix = "llm"

    model_name: str = "gpt-4o-mini"
    base_url: Optional[str] = None
    api_key: Optional[str] = None
    stream: bool = True
    stream_batch_sentences: int = 3
    compact_history: bool = True
    enable_lang_prompt: bool = False
    disable_thinking: bool = True
    reasoning_effort: Optional[str] = None
    timeout_s: float = 60.0
    #: Chat Completions audio part shape: OpenAI "input_audio" object or a
    #: llama.cpp-style "audio_url" base64 data URL
    audio_content_type: str = "input_audio"
    #: default reply cap for audio turns when neither the response nor the
    #: session sets max_output_tokens
    audio_max_tokens: int = 256
    #: newest N user turns keep raw audio in history; older ones collapse to
    #: a text placeholder
    audio_history_turns: int = 2
    gen_kwargs: dict[str, Any] = field(default_factory=dict)


@dataclass
class LocalLLMArgs:
    prefix = "llm"

    model_size: str = "smollm2-1.7b"
    checkpoint: Optional[str] = None
    tokenizer: Optional[str] = None
    max_new_tokens: int = 256
    stream_batch_sentences: int = 3
    compact_history: bool = False
    enable_lang_prompt: bool = False
    #: cross-session batched decode slots over ONE weight set (the TPU
    #: replacement for the reference's N model copies); 0/1 = single-session
    batched_slots: int = 4
    #: first-sentence latency lane: a new turn's first N tokens decode as
    #: single-slot dispatches ahead of the full-batch steps (0 disables)
    priority_tokens: int = 12
    #: per-slot KV capacity (tokens) of the batched engine; 0 = auto
    #: (min(model max_seq_len, 2048)).  Sizing rule of thumb: KV bytes =
    #: n_layers*2*slots*n_kv_heads*max_t*head_dim*2 — SmolLM2-1.7B (full MHA)
    #: at 16 slots x 2048 is ~6.4 GB, so high-slot serving on a 16 GB chip
    #: must bound this (the recorded loaded bench uses 256)
    batched_max_t: int = 0
    #: steady-lane dispatch quantum (tokens per full-batch chunk) — balances
    #: throughput against the in-flight blocking a latency probe can queue
    #: behind (bench.py loaded run A/B'd 6)
    chunk_tokens: int = 6
    #: start generating on the PROGRESSIVE transcript before the STT final
    #: and adopt on exact prompt match (batched engine only; a mismatch
    #: falls back to the normal path and only cost a spare slot's decode)
    speculative_prefill: bool = True
    #: whole-chain mode: also announce the speculation's first sentence
    #: batch to the TTS stage so synthesis starts before the final too
    speculative_tts: bool = True
    # "int8" / "int4" weight-only; "int8-dyn" = W8A8 dynamic (native int8 MXU
    # dot).  int8-dyn numerics are lane-dependent by design: dispatches under
    # 8 rows (priority/slot lanes, B=1) fall back to the EXACT weight-only
    # kernel (ops/quant.py quantized_linear_dyn), so a stream mixes regimes
    # across priority->steady transitions; coherence is pinned by
    # tests/test_session_scheduler.py int8-dyn cases.
    quantize: Optional[str] = None
    gen_kwargs: dict[str, Any] = field(default_factory=dict)


@dataclass
class Qwen3TTSArgs:
    prefix = "tts"

    model_size: str = "1.7b"  # 1.7b | tiny
    voice: Optional[str] = None
    voice_instruct: Optional[str] = None
    ref_audio: Optional[str] = None  # wav path for voice cloning
    ref_spk: Optional[str] = None  # precomputed speaker embedding (.npy/.npz)
    streaming_chunk_size: int = 8
    max_new_tokens: int = 1024
    checkpoint: Optional[str] = None
    #: path to the checkpoint's ``tokenizer.json`` — real Qwen BPE text ids
    #: (the reference's GGML runtime bundles this; ``qwen3_tts_handler.py:206-242``)
    tokenizer: Optional[str] = None
    blocksize: int = 512
    #: cross-session batched synthesis slots over ONE weight set; 0/1 = single
    batched_slots: int = 0
    #: per-slot talker KV capacity (codec tokens) of the batched engine;
    #: 0 = auto (min(talker max_seq_len, 2048)).  192 covers ~15 s of audio
    #: at 12.5 tok/s and is what the recorded loaded bench provisions
    batched_max_t: int = 0
    #: talker context re-read per batched chunk (frames); the loaded bench
    #: runs 8 — smaller context shortens the steady chunk program
    context_frames: int = 25
    quantize: Optional[str] = None  # "int8" / "int8+cp4" (int4 code predictor) / "int4"
    #: whole-chain speculation: pre-synthesize the LLM speculation's first
    #: sentence batch in a spare ungated slot (batched engine only)
    speculative_synthesis: bool = True


@dataclass
class KokoroTTSArgs:
    prefix = "tts"

    voice: Optional[str] = None
    speed: float = 1.0
    checkpoint: Optional[str] = None
    voicepack: Optional[str] = None  # converted (N, 256) style table .npz
    #: G2P language (espeak-ng code; built-in English rules fall back)
    lang: str = "en-us"
    #: input text is already a phoneme string — skip G2P (test/power-user path)
    phoneme_input: bool = False
    blocksize: int = 512
    #: whole-chain speculation: pre-synthesize the announced first sentence
    #: batch on a background side thread; adopted on exact match
    speculative_synthesis: bool = True


@dataclass
class MMSTTSArgs:
    prefix = "tts"

    language: Optional[str] = None
    speed: float = 1.0
    checkpoint: Optional[str] = None
    blocksize: int = 512

    #: whole-chain speculation: pre-synthesize the announced first sentence
    #: batch on a background side thread; adopted on exact match
    speculative_synthesis: bool = True


@dataclass
class PocketTTSArgs:
    prefix = "tts"

    voice: Optional[str] = None  # named voice from the converted catalog
    ref_audio: Optional[str] = None
    ref_spk: Optional[str] = None  # converted pocket-voice embedding (.npz)
    tokenizer: Optional[str] = None  # sentencepiece vocab.txt (encode side)
    speed: float = 1.0
    checkpoint: Optional[str] = None
    blocksize: int = 512

    #: whole-chain speculation: pre-synthesize the announced first sentence
    #: batch on a background side thread; adopted on exact match
    speculative_synthesis: bool = True


@dataclass
class ChatTTSArgs:
    prefix = "tts"

    stream: bool = True
    seed: Optional[int] = None
    checkpoint: Optional[str] = None
    blocksize: int = 512

    #: whole-chain speculation: pre-synthesize the announced first sentence
    #: batch on a background side thread; adopted on exact match
    speculative_synthesis: bool = True


@dataclass
class ClientArgs:
    """``talk`` client options."""

    url: str = "ws://127.0.0.1:8123/v1/realtime"
    instructions: Optional[str] = None
    voice: Optional[str] = None
    input_wav: Optional[str] = None  # headless mode: read mic audio from file
    output_wav: Optional[str] = None  # headless mode: write playback to file
    sample_rate: int = 16000


@dataclass
class ParsedArguments:
    module: ModuleArgs
    server: RealtimeServerArgs
    vad: VADArgs
    stt_config: Any
    llm_config: Any
    tts_config: Any


# ── parser machinery ─────────────────────────────────────────────────


def _add_dataclass_args(parser: argparse.ArgumentParser, cls: Type, prefix: str | None = None) -> None:
    for f in fields(cls):
        if f.name == "prefix":
            continue
        name = f"{prefix}_{f.name}" if prefix else f.name
        flag = f"--{name}"
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            parser.add_argument(flag, type=_parse_bool, default=default, metavar="BOOL")
        elif f.type in ("dict[str, Any]",) or f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            parser.add_argument(flag, type=json.loads, default=None)
        elif f.type in ("int", int):
            parser.add_argument(flag, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(flag, type=float, default=default)
        else:
            parser.add_argument(flag, type=str, default=default)


def _parse_bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def _extract(cls: Type, ns: argparse.Namespace, prefix: str | None = None, extra_gen: dict | None = None):
    kwargs: dict[str, Any] = {}
    for f in fields(cls):
        if f.name == "prefix":
            continue
        name = f"{prefix}_{f.name}" if prefix else f.name
        val = getattr(ns, name, None)
        if val is not None:
            kwargs[f.name] = val
    if extra_gen and "gen_kwargs" in {f.name for f in fields(cls)}:
        merged = dict(kwargs.get("gen_kwargs") or {})
        merged.update(extra_gen)
        kwargs["gen_kwargs"] = merged
    return cls(**kwargs)


STT_CONFIGS: dict[str, Type] = {
    "whisper": WhisperSTTArgs,
    "parakeet-tdt": ParakeetSTTArgs,
    "paraformer": ParaformerArgs,
    "none": WhisperSTTArgs,  # unused fields; direct-audio path
}
LLM_CONFIGS: dict[str, Type] = {
    "responses-api": RemoteLLMArgs,
    "chat-completions": RemoteLLMArgs,
    "local-jax": LocalLLMArgs,
    "local-vlm": LocalLLMArgs,
}
TTS_CONFIGS: dict[str, Type] = {
    "qwen3": Qwen3TTSArgs,
    "kokoro": KokoroTTSArgs,
    "facebookMMS": MMSTTSArgs,
    "pocket": PocketTTSArgs,
    "chatTTS": ChatTTSArgs,
}


#: Preset applied as parser DEFAULTS only, so explicit flags always win
#: (the reference's --mac-optimal-settings semantics).
TPU_OPTIMAL_DEFAULTS = {
    "stt": "whisper",
    "llm_backend": "responses-api",
    "tts": "qwen3",
    "tts_streaming_chunk_size": 8,
    # measured serving optimum on v5e-1: batched decode is weight-bandwidth-
    # bound, so 16 slots ≈ 1.4x the aggregate throughput of 8 at modest
    # per-step latency cost (bench.py detail has the sweep)
    "tts_batched_slots": 16,
    "tts_quantize": "int8",
    "vad_realtime_processing_pause": 0.5,
    "warmup_engines": True,
}


def parse_arguments(argv: list[str] | None = None) -> ParsedArguments:
    argv = list(sys.argv[1:] if argv is None else argv)

    # single-JSON-file alternative
    if len(argv) == 1 and argv[0].endswith(".json"):
        return _parse_config_file(Path(argv[0]))

    use_preset = "--tpu-optimal-settings" in argv
    if use_preset:
        argv = [a for a in argv if a != "--tpu-optimal-settings"]

    # phase 1: selector pre-parse
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--stt", default=ModuleArgs.stt)
    pre.add_argument("--llm_backend", default=ModuleArgs.llm_backend)
    pre.add_argument("--tts", default=ModuleArgs.tts)
    sel, _ = pre.parse_known_args(argv)

    # reference-CLI aliases (faster-whisper -> whisper, transformers ->
    # local-jax, ...): canonicalize BOTH the selector and argv so the final
    # ModuleArgs carries the canonical name end-to-end
    from s2s_tpu_torch.registry import resolve_backend_alias

    for attr, kind in (("stt", "stt"), ("llm_backend", "llm"), ("tts", "tts")):
        name = getattr(sel, attr)
        canon = resolve_backend_alias(kind, name)
        if canon != name:
            setattr(sel, attr, canon)
            rewritten: list[str] = []
            i = 0
            while i < len(argv):
                tok = argv[i]
                if tok == f"--{attr}={name}":
                    rewritten.append(f"--{attr}={canon}")
                elif tok == f"--{attr}" and i + 1 < len(argv) and argv[i + 1] == name:
                    rewritten.extend([tok, canon])
                    i += 1
                else:
                    rewritten.append(tok)
                i += 1
            argv = rewritten

    stt_cls = STT_CONFIGS.get(sel.stt)
    llm_cls = LLM_CONFIGS.get(sel.llm_backend)
    tts_cls = TTS_CONFIGS.get(sel.tts)
    for kind, name, cls in (("stt", sel.stt, stt_cls), ("llm_backend", sel.llm_backend, llm_cls), ("tts", sel.tts, tts_cls)):
        if cls is None:
            raise SystemExit(f"Unknown --{kind} backend: {name!r}")

    # phase 2: strict parse over selected groups
    parser = argparse.ArgumentParser(prog="s2s-tpu")
    _add_dataclass_args(parser, ModuleArgs)
    _add_dataclass_args(parser, RealtimeServerArgs)
    _add_dataclass_args(parser, VADArgs, prefix="vad")
    _add_dataclass_args(parser, stt_cls, prefix="stt")
    _add_dataclass_args(parser, llm_cls, prefix="llm")
    _add_dataclass_args(parser, tts_cls, prefix="tts")
    if use_preset:
        known = {a.dest for a in parser._actions}
        parser.set_defaults(**{k: v for k, v in TPU_OPTIMAL_DEFAULTS.items() if k in known})
    ns, leftovers = parser.parse_known_args(argv)

    # gen_* folding: --llm_gen_temperature 0.7 -> gen_kwargs["temperature"]
    gen_extra: dict[str, Any] = {}
    remaining: list[str] = []
    i = 0
    while i < len(leftovers):
        tok = leftovers[i]
        if tok.startswith("--llm_gen_") and i + 1 < len(leftovers):
            key = tok[len("--llm_gen_"):]
            raw = leftovers[i + 1]
            try:
                gen_extra[key] = json.loads(raw)
            except json.JSONDecodeError:
                gen_extra[key] = raw
            i += 2
            continue
        remaining.append(tok)
        i += 1

    # phase 3: leftovers matching inactive backend configs warn; others error
    inactive_flags = set()
    for group, active in (
        (STT_CONFIGS, stt_cls),
        (LLM_CONFIGS, llm_cls),
        (TTS_CONFIGS, tts_cls),
    ):
        for cls in group.values():
            if cls is active:
                continue
            for f in fields(cls):
                if f.name != "prefix":
                    inactive_flags.add(f"--{cls.prefix}_{f.name}")
    unknown = []
    for tok in remaining:
        if tok.startswith("--"):
            base = tok.split("=")[0]
            if base in inactive_flags:
                logger.warning("Ignoring flag for inactive backend: %s", base)
            else:
                unknown.append(base)
    if unknown:
        raise SystemExit(f"Unknown arguments: {unknown}")

    _validate_capabilities(sel.stt, sel.llm_backend)

    return ParsedArguments(
        module=_extract(ModuleArgs, ns),
        server=_extract(RealtimeServerArgs, ns),
        vad=_extract(VADArgs, ns, prefix="vad"),
        stt_config=_extract(stt_cls, ns, prefix="stt"),
        llm_config=_extract(llm_cls, ns, prefix="llm", extra_gen=gen_extra),
        tts_config=_extract(tts_cls, ns, prefix="tts"),
    )


def _validate_capabilities(stt: str, llm_backend: str) -> None:
    """Capability validation at parse time (registry flags, not backend
    names): a direct-audio STT ('none') sends raw audio to the LLM, so the
    selected LLM backend must declare ``supports_audio_input``."""
    from s2s_tpu_torch.registry import get_backend

    stt_spec = get_backend("stt", stt)
    llm_spec = get_backend("llm", llm_backend)
    if stt_spec.capabilities.bypasses_transcription_notifier \
            and not llm_spec.capabilities.supports_audio_input:
        raise SystemExit(
            f"--stt {stt} sends audio directly to the LLM, but --llm_backend "
            f"{llm_backend} does not support audio input; use an audio-capable "
            "backend (responses-api, chat-completions)."
        )


def _parse_config_file(path: Path) -> ParsedArguments:
    from s2s_tpu_torch.registry import resolve_backend_alias

    data = json.loads(path.read_text())
    module = ModuleArgs(**data.get("module", {}))
    module.stt = resolve_backend_alias("stt", module.stt)
    module.llm_backend = resolve_backend_alias("llm", module.llm_backend)
    module.tts = resolve_backend_alias("tts", module.tts)
    stt_cls = STT_CONFIGS[module.stt]
    llm_cls = LLM_CONFIGS[module.llm_backend]
    tts_cls = TTS_CONFIGS[module.tts]
    return ParsedArguments(
        module=module,
        server=RealtimeServerArgs(**data.get("server", {})),
        vad=VADArgs(**data.get("vad", {})),
        stt_config=stt_cls(**data.get("stt", {})),
        llm_config=llm_cls(**data.get("llm", {})),
        tts_config=tts_cls(**data.get("tts", {})),
    )
