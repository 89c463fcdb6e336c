"""Pipeline builder of the port (after ``s2s_tpu/builder.py``).

Builds the port's units over its own copies of the host pieces
(``PipelineUnit``, ``RealtimeService``, ``RealtimeServer``, the VAD handler,
the transcription notifier, the LM output processor and the LLM proxy) and
the port's registry.  ``--num_pipelines N`` builds N units
behind one server; the registry shares one weight set and one batched engine
per model among them, and with Silero one batched VAD serves every unit's
ticks.  ``--profile_dir`` adds a ``torch.profiler`` trace for the life of
the serve; ``--vad_enhancer_checkpoint`` adds DeepFilter on every unit's
VAD-final audio.  ``--model_parallel`` above 1 (not ported) raises at build
time and names its ROADMAP item.
"""

from __future__ import annotations

import logging
import threading
from queue import Queue
from typing import Any

import torch

from s2s_tpu_torch.arguments import ParsedArguments
from s2s_tpu_torch.llm.output_processor import LMOutputProcessor
from s2s_tpu_torch.pipeline.control import CancelScope
from s2s_tpu_torch.pipeline.log_context import install_pipeline_log_filter
from s2s_tpu_torch.pipeline.turns import SpeculativeTurnTracker
from s2s_tpu_torch.realtime.pipeline_unit import PipelineUnit
from s2s_tpu_torch.realtime.server import RealtimeServer
from s2s_tpu_torch.realtime.service import RealtimeService
from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE, HandlerContext, get_backend
from s2s_tpu_torch.runtime.device_scheduler import GLOBAL_SCHEDULER
from s2s_tpu_torch.runtime.thread_manager import ThreadManager
from s2s_tpu_torch.stt.notifier import TranscriptionNotifier
from s2s_tpu_torch.vad.energy import EnergyVAD
from s2s_tpu_torch.vad.handler import VADHandler

logger = logging.getLogger(__name__)


def check_supported(args: ParsedArguments) -> None:
    """Raise for every option whose device code is not ported yet."""
    if args.module.model_parallel > 1:
        raise NotImplementedError("--model_parallel: tensor-parallel serving is ROADMAP queue 1 item 8")


def build_pipeline_unit(index: int, args: ParsedArguments, stop_event: threading.Event,
                        device: torch.device, vad_model=None) -> PipelineUnit:
    """One unit: queues, control plane, service, handler chain.  Without a
    *vad_model*, the energy backend gets its own ``EnergyVAD`` (host
    arithmetic with per-session state) and Silero is built by the VAD
    handler on *device*."""
    input_queue: Queue = Queue()
    spoken_prompt_queue: Queue = Queue()
    stt_output_queue: Queue = Queue()
    text_prompt_queue: Queue = Queue()
    lm_response_queue: Queue = Queue()
    lm_processed_queue: Queue = Queue()
    output_queue: Queue = Queue()
    text_output_queue: Queue = Queue()

    should_listen = threading.Event()
    should_listen.set()
    cancel_scope = CancelScope()
    tracker = SpeculativeTurnTracker()

    def ctx(queue_in: Queue, queue_out: Queue) -> HandlerContext:
        return HandlerContext(
            stop_event=stop_event, queue_in=queue_in, queue_out=queue_out,
            text_output_queue=text_output_queue, should_listen=should_listen,
            cancel_scope=cancel_scope, speculative_turns=tracker,
            device_scheduler=GLOBAL_SCHEDULER, model_cache=GLOBAL_MODEL_CACHE,
            n_units=args.module.num_pipelines, model_parallel=args.module.model_parallel,
            device=device,
        )

    if vad_model is None and args.vad.backend == "energy":
        vad_model = EnergyVAD()

    vad = VADHandler(
        stop_event, input_queue, spoken_prompt_queue,
        setup_kwargs=dict(
            model=vad_model,
            should_listen=should_listen,
            speculative_turns=tracker,
            thresh=args.vad.thresh,
            min_silence_ms=args.vad.min_silence_ms,
            min_speech_ms=args.vad.min_speech_ms,
            min_speech_continuation_ms=args.vad.min_speech_continuation_ms,
            max_speech_ms=args.vad.max_speech_ms,
            speech_pad_ms=args.vad.speech_pad_ms,
            enable_realtime_transcription=args.module.enable_live_transcription,
            realtime_processing_pause=args.vad.realtime_processing_pause,
            text_output_queue=text_output_queue,
            speculative_reopen_ms=args.vad.speculative_reopen_ms,
            unanswered_reopen_ms=args.vad.unanswered_reopen_ms,
            short_segment_merge_ms=args.vad.short_segment_merge_ms,
            smart_turn=args.vad.smart_turn,
            smart_turn_threshold=args.vad.smart_turn_threshold,
            smart_turn_checkpoint=args.vad.smart_turn_checkpoint,
            smart_turn_max_wait_ms=args.vad.smart_turn_max_wait_ms,
            smart_turn_incomplete_delay_ms=args.vad.smart_turn_incomplete_delay_ms,
            device=device,  # the Smart Turn analyzer's and the default Silero model's
            enhancer=_build_enhancer(args, device),
        ),
    )
    stt_spec = get_backend("stt", args.module.stt)
    stt = stt_spec.create_handler(args.stt_config, ctx(spoken_prompt_queue, stt_output_queue))
    handlers: list[Any] = [vad, stt]
    # with --stt none the STT stage is the AudioInputNotifier, whose audio the service bridges to the LLM,
    # and no transcription notifier follows it
    if not stt_spec.capabilities.bypasses_transcription_notifier:
        handlers.append(TranscriptionNotifier(
            stop_event, stt_output_queue, text_prompt_queue,
            setup_kwargs=dict(text_output_queue=text_output_queue, should_listen=should_listen),
        ))
    llm = get_backend("llm", args.module.llm_backend).create_handler(
        args.llm_config, ctx(text_prompt_queue, lm_response_queue))
    processor = LMOutputProcessor(
        stop_event, lm_response_queue, lm_processed_queue,
        setup_kwargs=dict(text_output_queue=text_output_queue, speculative_turns=tracker),
    )
    tts = get_backend("tts", args.module.tts).create_handler(
        args.tts_config, ctx(lm_processed_queue, output_queue))
    handlers.extend([llm, processor, tts])
    for handler in handlers:
        handler.pipeline_index = index

    # speculative first-sentence generation engages when the LLM handler
    # actually runs it: the local backend on the batched engine
    spec_prefill = bool(getattr(llm, "speculative_prefill", False) and getattr(llm, "shared_lm", None) is not None)
    service = RealtimeService(
        text_prompt_queue=text_prompt_queue,
        should_listen=should_listen,
        chat_size=args.server.chat_size,
        speculative_turns=tracker,
        default_instructions=args.server.default_instructions,
        speculative_prefill=spec_prefill,
    )
    return PipelineUnit(
        index=index, service=service, cancel_scope=cancel_scope, should_listen=should_listen,
        response_playing=threading.Event(), input_queue=input_queue, output_queue=output_queue,
        text_output_queue=text_output_queue, text_prompt_queue=text_prompt_queue, handlers=handlers,
    )


def warmup_engines() -> None:
    """Run every batched-engine program once before serving (a cold first
    dispatch would stall the first sessions); safe before the server starts:
    the engines' driver threads start on first use."""
    for value in list(GLOBAL_MODEL_CACHE._models.values()):
        for engine in value if isinstance(value, tuple) else (value,):
            warm = getattr(engine, "warmup", None)
            if callable(warm):
                logger.info("Warming batched engine %s", type(engine).__name__)
                warm()


def build_pipeline(args: ParsedArguments, stop_event: threading.Event,
                   device: torch.device) -> tuple[ThreadManager, RealtimeServer]:
    """Check the options, build the units (models load on *device* here),
    warm the batched engines if asked, and build the realtime server;
    returns (thread manager, server), not started."""
    check_supported(args)
    install_pipeline_log_filter()
    n = args.module.num_pipelines
    vad_models = [None] * n
    if n > 1 and args.vad.backend == "silero":
        # N sessions, ONE Silero: every unit's 32 ms ticks batch into one call on the device
        from s2s_tpu_torch.runtime.batcher import BatchedSileroVAD

        service = GLOBAL_MODEL_CACHE.get(("silero_batched", n, str(device)),
                                         lambda: BatchedSileroVAD(max_slots=n, device=device))
        vad_models = [service.view(i) for i in range(n)]
    pool = [build_pipeline_unit(i, args, stop_event, device, vad_model=vad_models[i]) for i in range(n)]
    ice = args.server.webrtc_ice_servers
    server = RealtimeServer(
        stop_event, pool, host=args.server.host, port=args.server.port,
        llm_proxy=_build_llm_proxy(args),
        webrtc_port=args.server.webrtc_port,
        webrtc_ice_servers=[u.strip() for u in ice.split(",")] if ice else None,
    )
    handlers: list[Any] = [h for unit in pool for h in unit.handlers]
    if args.module.profile_dir:
        from s2s_tpu_torch.runtime.profiler import ProfilerHandler

        handlers.append(ProfilerHandler(stop_event, args.module.profile_dir, device))
    if args.module.warmup_engines:
        warmup_engines()
    return ThreadManager([*handlers, server]), server


def _build_enhancer(args: ParsedArguments, device: torch.device):
    """Optional DeepFilterNet-method noise suppression on VAD-final audio
    (reference ``vad_handler.py:44-50,799-821``): built only when a
    converted checkpoint is given, on *device*; shared across units via the
    cache."""
    path = getattr(args.vad, "enhancer_checkpoint", None)
    if not path:
        return None
    from s2s_tpu_torch import weights
    from s2s_tpu_torch.models.deepfilter import DeepFilterEnhancer
    from s2s_tpu_torch.registry import _load_checkpoint

    return GLOBAL_MODEL_CACHE.get(
        ("deepfilter", path, str(device)),
        lambda: DeepFilterEnhancer(params=weights.deepfilter_params(_load_checkpoint(path), device), device=device),
    )


def _build_llm_proxy(args: ParsedArguments):
    if not args.module.enable_llm_proxy:
        return None
    from s2s_tpu_torch.realtime.llm_proxy import LLMProxy

    spec = get_backend("llm", args.module.llm_backend)
    if not spec.capabilities.supports_llm_proxy:
        logger.warning("LLM proxy requested but backend %s does not support it", spec.name)
        return None
    return LLMProxy(
        base_url=args.llm_config.base_url,
        api_key=args.llm_config.api_key,
        model_name=args.llm_config.model_name,
        shape="responses" if args.module.llm_backend == "responses-api" else "chat",
    )
