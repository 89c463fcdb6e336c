"""The port's serve path end to end on the CPU at tiny size, and its hygiene.

- A tiny serve built by ``s2s_tpu_torch.cli`` with ``--device cpu`` answers
  one WebSocket text turn with audio deltas and ``response.done``.
- A tiny batched serve (two pipeline units sharing the batched LM, TTS and
  Parakeet engines, with a small TTS slot cache) answers two concurrent
  WebSocket text turns, each with audio deltas and ``response.done``.
- Every ``s2s_tpu_torch`` module imports, and both tiny pipelines build, in a
  process where importing ``jax`` fails.
- ``--model_parallel`` above 1 raises at build time instead of degrading.
- The slice's stages against the JAX package's handlers on the same tiny
  weights: the LLM streams the same text, the STT transcribes the same tokens
  (the TTS stream is held in ``test_torch_port_qwen3_tts.py``).
"""

import asyncio
import base64
import json
import os
import subprocess
import sys
import threading

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_FLAGS = [
    "--host", "127.0.0.1", "--port", "0",
    "--vad_backend", "energy", "--vad_smart_turn", "false",
    "--stt", "parakeet-tdt", "--stt_model_size", "tiny",
    "--llm_backend", "local-jax", "--llm_model_size", "tiny", "--llm_batched_slots", "1",
    "--llm_quantize", "int8", "--llm_max_new_tokens", "24",
    "--tts", "qwen3", "--tts_model_size", "tiny", "--tts_batched_slots", "1",
    "--tts_quantize", "int8", "--tts_streaming_chunk_size", "3",
    "--num_pipelines", "1",
]


def _with(flags: list[str], **values) -> list[str]:
    out = list(flags)
    for name, value in values.items():
        out[out.index(f"--{name}") + 1] = str(value)
    return out


BATCHED_FLAGS = _with(TINY_FLAGS, num_pipelines=2, llm_batched_slots=2, tts_batched_slots=2) + [
    "--tts_batched_max_t", "64", "--tts_context_frames", "8", "--warmup_engines", "true",
]


async def _text_turn(url: str, text: str, max_s: float = 60.0) -> list[dict]:
    import websockets.asyncio.client as ws_client

    events: list[dict] = []
    async with ws_client.connect(url, max_size=None) as ws:
        events.append(json.loads(await asyncio.wait_for(ws.recv(), 10)))
        await ws.send(json.dumps({"type": "conversation.item.create", "item": {
            "type": "message", "role": "user", "content": [{"type": "input_text", "text": text}]}}))
        await ws.send(json.dumps({"type": "response.create", "response": {}}))
        deadline = asyncio.get_running_loop().time() + max_s
        while asyncio.get_running_loop().time() < deadline:
            event = json.loads(await asyncio.wait_for(ws.recv(), max_s))
            events.append(event)
            if event.get("type") == "response.done":
                break
    return events


def test_tiny_cpu_serve_answers_a_text_turn_with_audio():
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *TINY_FLAGS], stop)
    manager.start()
    try:
        assert server.started.wait(30)
        events = asyncio.run(_text_turn(f"ws://127.0.0.1:{server.bound_port}/v1/realtime", "Hello there"))
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    types = [e["type"] for e in events]
    assert types[0] == "session.created"
    deltas = [e for e in events if e["type"] == "response.output_audio.delta"]
    assert deltas, types
    assert sum(len(base64.b64decode(e["delta"])) for e in deltas) > 0
    done = events[-1]
    assert done["type"] == "response.done" and done["response"]["status"] == "completed", done


def test_tiny_batched_cpu_serve_answers_two_concurrent_text_turns():
    """Two sessions at once through the registry-built batched engines."""
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *BATCHED_FLAGS], stop)
    manager.start()
    try:
        assert server.started.wait(30)
        url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"

        async def both():
            return await asyncio.gather(_text_turn(url, "Hello there", 120), _text_turn(url, "How are you", 120))

        results = asyncio.run(both())
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    for events in results:
        types = [e["type"] for e in events]
        assert types[0] == "session.created", types
        deltas = [e for e in events if e["type"] == "response.output_audio.delta"]
        assert deltas and sum(len(base64.b64decode(e["delta"])) for e in deltas) > 0, types
        assert events[-1]["type"] == "response.done" and events[-1]["response"]["status"] == "completed", types


_NO_JAX = """
import importlib, json, pkgutil, sys, threading
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import s2s_tpu_torch
names = [m.name for m in pkgutil.walk_packages(s2s_tpu_torch.__path__, "s2s_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from s2s_tpu_torch import cli
from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
for flags in json.loads(sys.argv[1]):
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *flags], threading.Event())
    GLOBAL_MODEL_CACHE.clear()
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print("OK", len(names))
"""


def test_port_imports_and_builds_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, json.dumps([TINY_FLAGS, BATCHED_FLAGS])], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def test_model_parallel_raises_at_build_time():
    from s2s_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        cli.build_from_argv(["--device", "cpu", *BATCHED_FLAGS, "--model_parallel", "2"], threading.Event())


def test_unported_options_raise():
    from s2s_tpu_torch import cli

    argv = list(TINY_FLAGS)
    argv[argv.index("--vad_smart_turn") + 1] = "true"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.build_from_argv(["--device", "cpu", *argv], threading.Event())
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.build_from_argv(["--device", "cpu", *TINY_FLAGS, "--stt", "whisper"], threading.Event())


def test_device_flag_is_stripped_and_cuda_needs_a_card():
    import torch

    from s2s_tpu_torch import cli

    assert cli.split_device(["--port", "0", "--device", "cpu", "--x"]) == ("cpu", ["--port", "0", "--x"])
    assert cli.split_device(["--device=cpu"]) == ("cpu", [])
    assert cli.split_device([]) == ("cuda", [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.resolve_device("cuda")


def _handler(cls, **setup):
    from queue import Queue

    return cls(threading.Event(), Queue(), Queue(), setup_kwargs=setup)


@pytest.fixture(scope="module")
def jax_cpu():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    return jax


def test_llm_handler_streams_the_same_text_as_the_jax_handler(jax_cpu):
    """The slice's LLM stage: same weights, same chat -> same text pieces."""
    from s2s_tpu.llm.local_backend import LocalJAXLLMHandler
    from s2s_tpu.models import decoder_lm as jdl
    from s2s_tpu_torch import weights
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler

    jp = jdl.init_params(jax_cpu.random.PRNGKey(4), jdl.DecoderLMConfig.tiny())
    common = dict(model_size="tiny", max_new_tokens=20, gen_kwargs={"decode_chunk_tokens": 6})
    jh = _handler(LocalJAXLLMHandler, params=jp, **common)
    th = _handler(LocalTorchLLMHandler, params=weights.tree_to_torch(jp, "cpu"), device="cpu", **common)
    chat = [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "What is the weather?"}]
    want = list(jh._jax_generate(chat))
    assert want and list(th._jax_generate(chat)) == want


def test_llm_handler_sampling_is_seeded(jax_cpu):
    """Temperature sampling draws from a generator with a fixed seed: two
    handlers, and two replies of one handler, give the same text."""
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler

    chat = [{"role": "user", "content": "hi"}]
    handlers = [_handler(LocalTorchLLMHandler, model_size="tiny", max_new_tokens=12, device="cpu",
                         gen_kwargs={"temperature": 0.8}) for _ in range(2)]
    first = "".join(handlers[0]._jax_generate(chat))
    assert first
    assert "".join(handlers[0]._jax_generate(chat)) == first
    assert "".join(handlers[1]._jax_generate(chat)) == first


def test_stt_handler_transcribes_the_same_tokens_as_the_jax_handler(jax_cpu):
    """The slice's STT stage: bucketed window, mel, encoder, TDT decode."""
    import numpy as np

    from s2s_tpu.models import parakeet as jpk
    from s2s_tpu.stt.parakeet_handler import ParakeetSTTHandler as JaxParakeet
    from s2s_tpu_torch import weights
    from s2s_tpu_torch.stt.parakeet_handler import ParakeetSTTHandler

    jp = jpk.init_params(jax_cpu.random.PRNGKey(5), jpk.ParakeetConfig.test_tiny())
    jh = _handler(JaxParakeet, model_size="tiny", params=jp, language="en")
    th = _handler(ParakeetSTTHandler, model_size="tiny", params=weights.parakeet_params(jp, "cpu"),
                  language="en", device="cpu")
    audio = (0.2 * np.random.default_rng(8).standard_normal(21_000)).astype(np.float32)
    want = jh.transcribe_fn(audio)
    got = th.transcribe_fn(audio)
    assert want.text and got.text == want.text and got.language_code == want.language_code
