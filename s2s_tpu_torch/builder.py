"""Pipeline builder of the port (after ``s2s_tpu/builder.py``).

``s2s_tpu/builder.py`` binds to ``s2s_tpu.registry``'s JAX factories, so the
port builds its units here over the same host pieces: ``PipelineUnit``,
``RealtimeService``, ``RealtimeServer``, the VAD handler, the transcription
notifier and the LM output processor.  ``--num_pipelines N`` builds N units
behind one server; the registry shares one weight set and one batched engine
per model among them.  Options that need an unported piece raise at build
time and name their ROADMAP item.
"""

from __future__ import annotations

import logging
import threading
from queue import Queue
from typing import Any

import torch

from s2s_tpu.arguments import ParsedArguments
from s2s_tpu.llm.output_processor import LMOutputProcessor
from s2s_tpu.pipeline.control import CancelScope
from s2s_tpu.pipeline.log_context import install_pipeline_log_filter
from s2s_tpu.pipeline.turns import SpeculativeTurnTracker
from s2s_tpu.realtime.pipeline_unit import PipelineUnit
from s2s_tpu.realtime.server import RealtimeServer
from s2s_tpu.realtime.service import RealtimeService
from s2s_tpu.runtime.device_scheduler import GLOBAL_SCHEDULER
from s2s_tpu.runtime.thread_manager import ThreadManager
from s2s_tpu.stt.notifier import TranscriptionNotifier
from s2s_tpu.vad.energy import EnergyVAD
from s2s_tpu.vad.handler import VADHandler
from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE, TorchHandlerContext, get_backend

logger = logging.getLogger(__name__)


def check_supported(args: ParsedArguments) -> None:
    """Raise for every option whose device code is not ported yet."""
    if args.vad.backend != "energy":
        raise NotImplementedError(
            f"--vad_backend {args.vad.backend}: only the energy VAD runs in s2s_tpu_torch so far "
            "(Silero is ROADMAP queue 1 item 3)"
        )
    if args.vad.smart_turn:
        raise NotImplementedError(
            "--vad_smart_turn needs the Whisper-encoder port (ROADMAP queue 1 item 4); "
            "pass --vad_smart_turn false"
        )
    if args.vad.enhancer_checkpoint:
        raise NotImplementedError("--vad_enhancer_checkpoint: DeepFilter is ROADMAP queue 1 item 7")
    if args.module.profile_dir:
        raise NotImplementedError("--profile_dir drives the JAX profiler; not ported to s2s_tpu_torch")
    if args.module.model_parallel > 1:
        raise NotImplementedError("--model_parallel: tensor-parallel serving is ROADMAP queue 1 item 8")


def build_pipeline_unit(index: int, args: ParsedArguments, stop_event: threading.Event,
                        device: torch.device) -> PipelineUnit:
    """One unit: queues, control plane, service, handler chain."""
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

    def ctx(queue_in: Queue, queue_out: Queue) -> TorchHandlerContext:
        return TorchHandlerContext(
            stop_event=stop_event, queue_in=queue_in, queue_out=queue_out,
            text_output_queue=text_output_queue, should_listen=should_listen,
            cancel_scope=cancel_scope, speculative_turns=tracker,
            device_scheduler=GLOBAL_SCHEDULER, model_cache=GLOBAL_MODEL_CACHE,
            n_units=args.module.num_pipelines, model_parallel=args.module.model_parallel,
            device=device,
        )

    vad = VADHandler(
        stop_event, input_queue, spoken_prompt_queue,
        setup_kwargs=dict(
            model=EnergyVAD(),  # per unit: host arithmetic with per-session state
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
            smart_turn=False,
        ),
    )
    stt = get_backend("stt", args.module.stt).create_handler(
        args.stt_config, ctx(spoken_prompt_queue, stt_output_queue))
    notifier = TranscriptionNotifier(
        stop_event, stt_output_queue, text_prompt_queue,
        setup_kwargs=dict(text_output_queue=text_output_queue, should_listen=should_listen),
    )
    llm = get_backend("llm", args.module.llm_backend).create_handler(
        args.llm_config, ctx(text_prompt_queue, lm_response_queue))
    processor = LMOutputProcessor(
        stop_event, lm_response_queue, lm_processed_queue,
        setup_kwargs=dict(text_output_queue=text_output_queue, speculative_turns=tracker),
    )
    tts = get_backend("tts", args.module.tts).create_handler(
        args.tts_config, ctx(lm_processed_queue, output_queue))
    handlers: list[Any] = [vad, stt, notifier, llm, processor, tts]
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
    pool = [build_pipeline_unit(i, args, stop_event, device) for i in range(args.module.num_pipelines)]
    if args.module.enable_llm_proxy:
        logger.warning("LLM proxy requested but the local LLM backend does not support it")
    ice = args.server.webrtc_ice_servers
    server = RealtimeServer(
        stop_event, pool, host=args.server.host, port=args.server.port,
        webrtc_port=args.server.webrtc_port,
        webrtc_ice_servers=[u.strip() for u in ice.split(",")] if ice else None,
    )
    if args.module.warmup_engines:
        warmup_engines()
    return ThreadManager([*(h for unit in pool for h in unit.handlers), server]), server
