"""Pipeline builder of the port (after ``s2s_tpu/builder.py``).

Builds the port's units over its own copies of the host pieces
(``PipelineUnit``, ``RealtimeService``, ``RealtimeServer``, the VAD handler,
the transcription notifier, the LM output processor and the LLM proxy) and
the port's registry.  ``--num_pipelines N`` builds N units
behind one server; the registry shares one weight set and one batched engine
per model among them, and with Silero one batched VAD serves every unit's
ticks.  ``--profile_dir`` adds a ``torch.profiler`` trace for the life of
the serve; ``--vad_enhancer_checkpoint`` adds DeepFilter on every unit's
VAD-final audio.

``--model_parallel N`` above 1 splits the batched LM and the batched
Qwen3-TTS talker over N ranks (tensor parallelism; ``registry.tp_engines``).
This process is rank 0, the leader, and runs the whole pipeline;
:func:`launch_tp` starts ranks 1..N-1 as follower processes
(``python -m s2s_tpu_torch.cli tp-follower``, ``cli.run_follower``), which
build only their shards of the two engines and replay the leader's programs.
By default rank r runs on ``cuda:r`` over NCCL, and the build raises when
fewer than N cards are visible; a ``tp_layout`` (``parallel.mesh.TPLayout``)
names each rank's device and the transport instead, e.g. two ranks on
``cuda:0`` over gloo to rehearse on one card, or two on the CPU in tests.
The serve's stop closes the runtime: the engines, the followers, the groups.
"""

from __future__ import annotations

import logging
import os
import pickle
import subprocess
import sys
import threading
from datetime import timedelta
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
from s2s_tpu_torch.runtime.thread_manager import JOIN_TIMEOUT_S, ThreadManager
from s2s_tpu_torch.stt.notifier import TranscriptionNotifier
from s2s_tpu_torch.vad.energy import EnergyVAD
from s2s_tpu_torch.vad.handler import VADHandler

logger = logging.getLogger(__name__)


def check_supported(args: ParsedArguments) -> None:
    """Raise for what tensor-parallel serving does not take, before any rank
    starts: a split dim (the MLP's hidden width, the LM's vocabulary) that
    the ranks do not divide (``registry.check_tp_split``)."""
    n = args.module.model_parallel
    if n <= 1:
        return
    from s2s_tpu_torch.llm.local_backend import lm_config
    from s2s_tpu_torch.models.qwen3_tts import CONFIGS
    from s2s_tpu_torch.registry import check_tp_split, tp_engines

    engines = tp_engines(args)
    if "lm" in engines:
        check_tp_split(lm_config(args.llm_config.model_size), n, f"--llm_model_size {args.llm_config.model_size}")
    if "tts" in engines:
        check_tp_split(CONFIGS[args.tts_config.model_size]().lm, n,
                       f"the Qwen3-TTS talker (--tts_model_size {args.tts_config.model_size})", talker=True)


def build_pipeline_unit(index: int, args: ParsedArguments, stop_event: threading.Event,
                        device: torch.device, vad_model=None, tp=None) -> PipelineUnit:
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
            device=device, tp=tp,
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


def full_f32() -> None:
    """The serve's f32 numerics: cuDNN's f32 convolutions, and f32 matrix
    products (off by torch's default), in full f32 rather than TF32, as the
    CPU parity tests that vouch for the models compute them.  Process-wide,
    set once at the serve's device setup (and a follower's); no model module
    flips either flag."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def build_pipeline(args: ParsedArguments, stop_event: threading.Event,
                   device: torch.device, tp_layout=None) -> tuple[ThreadManager, RealtimeServer]:
    """Check the options, set the f32 numerics (:func:`full_f32`), start the
    tensor-parallel ranks (``--model_parallel`` above 1, on *tp_layout*: see
    :func:`launch_tp`), build the units (models load on *device* here), warm
    the batched engines if asked, and build the realtime server; returns
    (thread manager, server), not started."""
    check_supported(args)
    full_f32()
    install_pipeline_log_filter()
    tp = launch_tp(args, device, tp_layout) if args.module.model_parallel > 1 else None
    try:
        n = args.module.num_pipelines
        vad_models = [None] * n
        if n > 1 and args.vad.backend == "silero":
            # N sessions, ONE Silero: every unit's 32 ms ticks batch into one call on the device
            from s2s_tpu_torch.runtime.batcher import BatchedSileroVAD

            service = GLOBAL_MODEL_CACHE.get(("silero_batched", n, str(device)),
                                             lambda: BatchedSileroVAD(max_slots=n, device=device))
            vad_models = [service.view(i) for i in range(n)]
        pool = [build_pipeline_unit(i, args, stop_event, device, vad_model=vad_models[i], tp=tp) for i in range(n)]
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
        if tp is not None:
            handlers.append(TPServeHandler(stop_event, tp))
        if args.module.warmup_engines:
            warmup_engines()
    except BaseException:
        if tp is not None:
            tp.close(abort=True)
        raise
    return ServeManager([*handlers, server], server), server


class ServeManager(ThreadManager):
    """The serve's thread manager.  Its :meth:`stop` also unlinks the server
    from its units and each unit from its handlers: the websockets server
    and its connections' tasks hold the server in reference cycles (an
    asyncio server and its handler, a closed connection's exception and its
    frames), so without this the models and engines behind the handlers
    would stay allocated until a garbage collection, not until the caller
    lets go of the manager."""

    def __init__(self, handlers, server: RealtimeServer) -> None:
        super().__init__(handlers)
        self._server = server

    def stop(self, join_timeout_s: float = JOIN_TIMEOUT_S) -> None:
        super().stop(join_timeout_s)
        if any(thread.is_alive() for thread in self.threads):
            return  # a stage still runs: leave it its unit
        for unit in self._server.pool:
            unit.handlers = []
        self._server.pool = []


# ── tensor-parallel serving: the leader's launcher and the follower ──


class TPServeHandler:
    """ThreadManager 'handler' holding the tensor-parallel runtime for the
    life of the serve; when the serve stops it closes the runtime (the
    engines' drivers, the followers, the groups) and sets ``closed``."""

    def __init__(self, stop_event: threading.Event, runtime) -> None:
        self.stop_event = stop_event
        self.runtime = runtime
        self.closed = threading.Event()

    def run(self) -> None:
        self.stop_event.wait()
        self.close()

    def close(self) -> None:
        try:
            self.runtime.close()
        finally:
            self.closed.set()


def tp_handler_of(manager: ThreadManager):
    """The :class:`TPServeHandler` of a built pipeline (its ``runtime``,
    ``close()`` and ``closed``), or None."""
    return next((h for h in manager.handlers if isinstance(h, TPServeHandler)), None)


def launch_tp(args: ParsedArguments, device: torch.device, layout=None):
    """Start the ranks of ``--model_parallel N``: this process is rank 0;
    ranks 1..N-1 are follower processes (``cli.run_follower``) that read the
    parsed arguments and the layout from a ``TCPStore`` on 127.0.0.1.
    *layout* (a ``parallel.mesh.TPLayout``; default ``mesh.tp_layout``, one
    card a rank over NCCL, which raises when fewer than N are visible) puts
    rank 0 on *device*.  Returns rank 0's ``mesh.TPRuntime``, which holds the
    followers' processes and joins the groups when the first engine asks
    for one."""
    from s2s_tpu_torch.parallel.mesh import TP_TIMEOUT_S, TPRuntime, tp_layout

    import torch.distributed as dist

    n = args.module.model_parallel
    layout = layout or tp_layout(n, device)
    if layout.size != n or torch.device(layout.devices[0]) != device:
        raise ValueError(f"--model_parallel {n} on --device {device}: layout {layout} does not match")
    if device.type == "cuda":
        from s2s_tpu_torch.ops import _build

        _build.build()  # once, before the followers would each compile the kernels
    store = dist.TCPStore("127.0.0.1", 0, n, True, timeout=timedelta(seconds=TP_TIMEOUT_S), wait_for_workers=False)
    store.set("tp/args", pickle.dumps((args, layout, TP_TIMEOUT_S)))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    logger.info("--model_parallel %d: starting %d followers on %s over %s", n, n - 1, layout.devices[1:],
                layout.transport)
    procs = [subprocess.Popen([sys.executable, "-m", "s2s_tpu_torch.cli", "tp-follower", "--rank", str(rank),
                               "--store", f"127.0.0.1:{store.port}"], env=env)
             for rank in range(1, n)]
    runtime = TPRuntime(0, layout, store, TP_TIMEOUT_S, connect=False)  # joined when the first engine asks
    runtime.procs = procs
    return runtime


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
