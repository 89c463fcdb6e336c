"""What a stopped serve leaves behind, on the CPU.

A tiny two-session serve built through ``cli.build_from_argv`` (the batched
LM, Qwen3-TTS, Parakeet and Silero engines), one text turn over a real
WebSocket, then ``manager.stop()`` with the garbage collector disabled:

- once the caller lets go of the manager and the server, weak references to
  each engine are dead without a ``gc.collect()`` (no reference cycle holds
  a model or an engine: ``builder.ServeManager.stop`` unlinks the server,
  whose websockets objects sit in cycles, from its units; the batched
  services' micro-batchers reach them weakly; the STT handler drops its
  transcriber's closure when its thread ends);
- while it serves, f32 convolutions and products are not TF32
  (``builder.full_f32``), as the CPU parity tests compute them.

The client runs on a thread of its own: the websockets client keeps a
closed connection's exception, whose traceback holds the frames that were
on the stack, and this test's frame is not to be among them.
"""

import asyncio
import gc
import sys
import threading
import weakref
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_port_serve import BATCHED_FLAGS, _text_turn, _with  # noqa: E402

#: the engines a two-session serve with Silero builds, by class name
ENGINES = ("BatchedLMScheduler", "BatchedTTSScheduler", "BatchedParakeetSTT", "BatchedSileroVAD")


def _serve() -> tuple[dict, dict, list[dict]]:
    """Build, answer one text turn, stop.  Returns (weak references to the
    engines by class name, the TF32 flags while serving, the events)."""
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *_with(BATCHED_FLAGS, vad_backend="silero")], stop)
    refs = {}
    for value in GLOBAL_MODEL_CACHE._models.values():
        for obj in value if isinstance(value, tuple) else (value,):
            if type(obj).__name__ in ENGINES:
                refs[type(obj).__name__] = weakref.ref(obj)
    flags = {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}
    events: list[list[dict]] = []
    manager.start()
    try:
        assert server.started.wait(30)
        url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
        client = threading.Thread(target=lambda: events.append(asyncio.run(_text_turn(url, "Hello there", 120))))
        client.start()
        client.join()
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    return refs, flags, events[0] if events else []


@pytest.fixture(scope="module")
def stopped_serve():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    enabled = gc.isenabled()
    gc.disable()
    try:
        refs, tf32, events = _serve()
        alive = {name: ref() is not None for name, ref in refs.items()}
    finally:
        if enabled:
            gc.enable()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return {"alive": alive, "tf32": tf32, "events": events}


def test_the_serve_answered(stopped_serve):
    types = [e["type"] for e in stopped_serve["events"]]
    assert "response.output_audio.delta" in types and types[-1] == "response.done", types


def test_engines_are_freed_without_a_garbage_collection(stopped_serve):
    assert stopped_serve["alive"] == dict.fromkeys(ENGINES, False)


def test_the_serve_computes_f32_convolutions_without_tf32(stopped_serve):
    assert stopped_serve["tf32"] == {"matmul": False, "cudnn": False}
