"""The port's default CLI on the CPU at tiny size: Silero, the deployment
config, ``talk``/``local``, the remote LLM backends, ``--stt none``, the LLM
proxy and the profiler.

- A tiny serve with ``--vad_backend`` left unset (Silero) builds Silero on
  its device, one model per unit at 1 unit and one shared
  ``BatchedSileroVAD`` at 2, and answers a WebSocket text turn with audio
  and ``response.done``.
- With no flags at all the arguments parse (``--llm_backend`` defaults to
  ``responses-api``, the VAD to Silero, the STT to Whisper).
- ``examples/smollm2-qwen3tts-tpu/config.json``, with its checkpoints and
  tokenizers left out, the model sizes cut to tiny (and the reply to 24
  tokens, which the tiny LM's cache holds) and its server on 127.0.0.1 port
  0, builds through its JSON form and answers a text turn.
- ``--stt none``, ``--enable_llm_proxy`` and ``--profile_dir`` build the
  handlers, proxy and profiler the JAX package's builder builds for the same
  flags; the proxy forwards a request to a local upstream; the profiler
  writes a trace.
- ``local`` (server + loopback client) and ``talk`` (against a running tiny
  server) run headless: a WAV in, the reply's PCM out.

The LLM upstream is a local chat-completions mock on 127.0.0.1; the audio
is a tone made with numpy.
"""

import asyncio
import base64
import json
import os
import sys
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_serve import BATCHED_FLAGS, TINY_FLAGS, _text_turn, _with  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REPLY = "Hello there. Nice to meet you."


def _without(flags: list[str], *names: str) -> list[str]:
    out = list(flags)
    for name in names:
        i = out.index(f"--{name}")
        del out[i : i + 2]
    return out


#: the tiny serve with the remote chat-completions LLM and direct audio (no STT)
REMOTE_FLAGS = _with(_without(TINY_FLAGS, "llm_model_size", "llm_batched_slots", "llm_quantize",
                              "llm_max_new_tokens", "stt_model_size"), stt="none", llm_backend="chat-completions")


@pytest.fixture
def upstream():
    """An OpenAI-compatible /chat/completions SSE mock; records request bodies."""
    bodies: list[dict] = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):  # noqa: N802
            bodies.append(json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))) or b"{}"))
            events = [{"choices": [{"delta": {"content": REPLY}}]},
                      {"choices": [{"delta": {}, "finish_reason": "stop"}],
                       "usage": {"prompt_tokens": 5, "completion_tokens": 9}}]
            body = "".join(f"data: {json.dumps(e)}\n\n" for e in events) + "data: [DONE]\n\n"
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            self.wfile.write(body.encode())

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_port}/v1", bodies
    finally:
        server.shutdown()


def _tone_wav(path: Path) -> None:
    """0.25 s of silence, 2 s of a modulated 220 Hz tone, 0.4 s of silence:
    the stream ends soon after the VAD closes the segment, so the reply
    comes after the client has sent everything and ends the session."""
    rate = 16_000
    t = np.arange(2 * rate) / rate
    speech = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    pcm = np.concatenate([np.zeros(rate // 4), speech, np.zeros(rate * 2 // 5)])
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes())


def _pcm(path: Path) -> np.ndarray:
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _serve_text_turn(argv: list[str]):
    """Build *argv* on the CPU, answer one text turn; returns (events, manager)."""
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *argv], stop)
    manager.start()
    try:
        assert server.started.wait(30)
        events = asyncio.run(_text_turn(f"ws://127.0.0.1:{server.bound_port}/v1/realtime", "Hello there", 120))
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    return events, manager


def _answered(events: list[dict]) -> None:
    types = [e["type"] for e in events]
    deltas = [e for e in events if e["type"] == "response.output_audio.delta"]
    assert deltas and sum(len(base64.b64decode(e["delta"])) for e in deltas) > 0, types
    assert events[-1]["type"] == "response.done" and events[-1]["response"]["status"] == "completed", types


@pytest.mark.parametrize("units", [1, 2])
def test_tiny_serve_with_default_silero_answers_a_text_turn(units):
    from s2s_tpu_torch.models.silero_vad import SileroVAD
    from s2s_tpu_torch.runtime.batcher import BatchedSileroVAD, SileroSlotView
    from s2s_tpu_torch.vad.handler import VADHandler

    flags = _without(TINY_FLAGS if units == 1 else BATCHED_FLAGS, "vad_backend")
    events, manager = _serve_text_turn(flags)
    _answered(events)
    models = [h.iterator.model for h in manager.handlers if isinstance(h, VADHandler)]
    assert len(models) == units
    if units == 1:
        assert isinstance(models[0], SileroVAD) and models[0].device.type == "cpu"
    else:
        assert all(isinstance(m, SileroSlotView) for m in models)
        assert isinstance(models[0]._service, BatchedSileroVAD) and models[1]._service is models[0]._service
        assert [m.slot for m in models] == [0, 1] and models[0]._service.max_slots == 2


def test_bare_arguments_parse_with_the_default_backends():
    from s2s_tpu_torch.arguments import RemoteLLMArgs, parse_arguments
    from s2s_tpu_torch.registry import get_backend

    args = parse_arguments([])
    assert (args.module.stt, args.module.llm_backend, args.vad.backend) == ("whisper", "responses-api", "silero")
    assert isinstance(args.llm_config, RemoteLLMArgs)
    caps = get_backend("llm", "responses-api").capabilities
    assert caps.supports_audio_input and caps.supports_llm_proxy
    assert get_backend("stt", "none").capabilities.bypasses_transcription_notifier


def test_deployment_config_builds_from_its_json_form_and_answers_a_text_turn(tmp_path, monkeypatch):
    from s2s_tpu_torch.models.silero_vad import SileroVAD
    from s2s_tpu_torch.ops import quant
    from s2s_tpu_torch.vad.handler import VADHandler

    monkeypatch.setattr(quant, "_MIN_SIZE", 1)  # quantize the tiny matrices too, as the config's int8 asks
    config = json.loads((ROOT / "examples/smollm2-qwen3tts-tpu/config.json").read_text())
    for section in ("stt", "llm", "tts"):
        config[section] = {k: v for k, v in config[section].items() if k not in ("checkpoint", "tokenizer")}
        config[section]["model_size"] = "tiny"
    config["llm"]["max_new_tokens"] = 24  # the tiny LM's 128-position cache cannot hold the default 256
    config["server"] = {"host": "127.0.0.1", "port": 0}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))

    events, manager = _serve_text_turn([str(path)])
    _answered(events)
    vad = next(h for h in manager.handlers if isinstance(h, VADHandler))
    assert isinstance(vad.iterator.model, SileroVAD) and vad.smart_turn_analyzer is not None
    llm = next(h for h in manager.handlers if type(h).__name__ == "LocalTorchLLMHandler")
    tts = next(h for h in manager.handlers if type(h).__name__ == "Qwen3TTSHandler")
    assert llm.shared_lm is not None and llm.speculative_prefill and tts.shared_tts.n_slots == 16
    assert any(isinstance(leaf, quant.QuantWeight) for leaf in llm.shared_lm.params["layers"].values())


def test_stt_none_proxy_and_profiler_build_as_the_jax_package_builds_them(tmp_path, upstream):
    """The same flags through both builders: the same handler chain, the
    proxy of the same shape; then the port's proxy forwards a request (a
    serve built without ``--profile_dir``: the profiler runs in
    ``test_profile_dir_writes_a_trace``'s own process)."""
    import httpx

    from s2s_tpu.arguments import parse_arguments as jax_parse
    from s2s_tpu.builder import _build_llm_proxy as jax_proxy
    from s2s_tpu.builder import build_pipeline as jax_build
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.arguments import parse_arguments
    from s2s_tpu_torch.builder import _build_llm_proxy
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    url, bodies = upstream
    flags = [*REMOTE_FLAGS, "--llm_base_url", url, "--enable_llm_proxy", "true"]
    profiled = [*flags, "--profile_dir", str(tmp_path / "trace")]
    jax_manager, jax_server = jax_build(jax_parse(profiled), threading.Event())
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *profiled], threading.Event())
    assert [type(h).__name__ for h in manager.handlers] == [type(h).__name__ for h in jax_manager.handlers]
    assert [type(h).__name__ for h in manager.handlers[:3]] == ["VADHandler", "AudioInputNotifier",
                                                                "ChatCompletionsHandler"]
    assert "ProfilerHandler" in [type(h).__name__ for h in manager.handlers]
    assert (server.llm_proxy.shape, server.llm_proxy.base_url) == (jax_server.llm_proxy.shape,
                                                                    jax_server.llm_proxy.base_url)
    for backend in ("responses-api", "chat-completions", "local-jax"):
        argv = ["--llm_backend", backend, "--enable_llm_proxy", "true"]
        ours, theirs = _build_llm_proxy(parse_arguments(argv)), jax_proxy(jax_parse(argv))
        assert (ours is None) == (theirs is None) and getattr(ours, "shape", None) == getattr(theirs, "shape", None)
    GLOBAL_MODEL_CACHE.clear()
    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *flags], stop)
    manager.start()
    try:
        assert server.started.wait(30)
        reply = httpx.post(f"http://127.0.0.1:{server._proxy_port}/v1/chat/completions",
                           json={"messages": [{"role": "user", "content": "hi"}]}, timeout=30)
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    assert reply.status_code == 200 and REPLY in reply.text
    assert bodies[-1]["messages"][0]["content"] == "hi"


_PROFILED_SERVE = """
import asyncio, sys, threading
sys.path.insert(0, sys.argv[1])
import test_torch_port_serve as serve
from s2s_tpu_torch import cli

stop = threading.Event()
manager, server, _ = cli.build_from_argv(["--device", "cpu", *serve.TINY_FLAGS, "--profile_dir", sys.argv[2]], stop)
manager.start()
try:
    assert server.started.wait(30)
    events = asyncio.run(serve._text_turn(f"ws://127.0.0.1:{server.bound_port}/v1/realtime", "Hello there", 120))
finally:
    stop.set()
    manager.stop()
assert events[-1]["type"] == "response.done", [e["type"] for e in events]
print("OK")
"""


def test_profile_dir_writes_a_trace(tmp_path):
    """A serve with ``--profile_dir`` answers a text turn and leaves one
    trace with the serve's operations.  It runs in a process of its own: a
    profiler session is process-wide state, which a test worker that ran
    other tests before does not start from clean."""
    import subprocess

    trace_dir = tmp_path / "trace"
    proc = subprocess.run([sys.executable, "-c", _PROFILED_SERVE, str(ROOT / "tests"), str(trace_dir)],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1, list(trace_dir.iterdir())
    trace = json.loads(traces[0].read_text())
    assert any(e.get("ph") == "X" for e in trace["traceEvents"])


def test_local_runs_the_server_and_a_headless_client(tmp_path, upstream, capsys):
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    url, bodies = upstream
    _tone_wav(tmp_path / "in.wav")
    try:
        cli.run_local(["--device", "cpu", *REMOTE_FLAGS, "--llm_base_url", url, "--",
                       "--input_wav", str(tmp_path / "in.wav"), "--output_wav", str(tmp_path / "out.wav")])
    finally:
        GLOBAL_MODEL_CACHE.clear()
    assert f"ASSISTANT: {REPLY}" in capsys.readouterr().out
    assert any(part.get("type") == "input_audio" for m in bodies[-1]["messages"] if isinstance(m["content"], list)
               for part in m["content"])  # --stt none: the audio went to the LLM
    pcm = _pcm(tmp_path / "out.wav")
    assert pcm.size > 0 and np.abs(pcm.astype(np.int32)).max() > 0


def test_talk_runs_headless_against_a_running_server(tmp_path, upstream, capsys):
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    url, _ = upstream
    _tone_wav(tmp_path / "in.wav")
    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *REMOTE_FLAGS, "--llm_base_url", url], stop)
    manager.start()
    try:
        assert server.started.wait(30)
        cli.run_talk(["--url", f"ws://127.0.0.1:{server.bound_port}/v1/realtime",
                      "--input_wav", str(tmp_path / "in.wav"), "--output_wav", str(tmp_path / "out.wav")])
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    assert f"ASSISTANT: {REPLY}" in capsys.readouterr().out
    pcm = _pcm(tmp_path / "out.wav")
    assert pcm.size > 0 and np.abs(pcm.astype(np.int32)).max() > 0
