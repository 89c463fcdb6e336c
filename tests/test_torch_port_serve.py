"""The port's serve path end to end on the CPU at tiny size, and its hygiene.

- A tiny serve built by ``s2s_tpu_torch.cli`` with ``--device cpu`` answers
  one WebSocket text turn with audio deltas and ``response.done``.
- A tiny batched serve (two pipeline units sharing the batched LM, TTS and
  Parakeet engines, with a small TTS slot cache) answers two concurrent
  WebSocket text turns, each with audio deltas and ``response.done``.
- A tiny serve with Whisper tiny and Smart Turn on answers a WebSocket voice
  turn: a transcription, Smart Turn predictions with none failed, and (for a
  non-empty random-init transcript) a spoken reply with ``response.done``.
- Tiny batched serves with ``--tts kokoro``, ``--tts facebookMMS``, ``--tts
  pocket`` and ``--tts chatTTS`` (the models at their tiny configs, placed in
  the model cache under the factories' keys) answer two concurrent text
  turns each with audio deltas and ``response.done``.
- Every ``s2s_tpu_torch`` module imports, and both tiny pipelines build, in a
  process where importing ``jax`` or the JAX package ``s2s_tpu`` fails.
- Tiny serves with ``--stt paraformer``, ``--llm_backend local-vlm`` and
  ``--vad_enhancer_checkpoint`` (a converted ``DeepFilterConfig()``
  checkpoint) each answer a text turn and a voice turn; the enhancer takes
  every VAD-final segment, and turns without an image never run the tower
  (the image path is held in ``test_torch_port_vision.py``).
- ``--model_parallel 2`` with one device visible raises the device-count
  error at build time (``tests/test_torch_port_tp.py`` serves it).
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
import time

import pytest

from chip_smoke import tts_flags  # the card's serves' flags with another TTS
from s2s_tpu_torch.tools.convert_checkpoint import flatten  # a tree as an npz's arrays

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
#: Whisper tiny (the real tiny width, random weights) with Smart Turn on
WHISPER_FLAGS = _with(TINY_FLAGS, stt="whisper", vad_smart_turn="true")


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


def _serve_two_text_turns(flags: list[str]) -> list[list[dict]]:
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *flags], stop)
    manager.start()
    try:
        assert server.started.wait(30)
        url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"

        async def both():
            return await asyncio.gather(_text_turn(url, "Hello there", 120), _text_turn(url, "How are you", 120))

        return asyncio.run(both())
    finally:
        stop.set()
        manager.stop()


def _assert_spoken(results: list[list[dict]]) -> None:
    for events in results:
        types = [e["type"] for e in events]
        deltas = [e for e in events if e["type"] == "response.output_audio.delta"]
        assert deltas and sum(len(base64.b64decode(e["delta"])) for e in deltas) > 0, types
        assert events[-1]["type"] == "response.done" and events[-1]["response"]["status"] == "completed", types


def test_tiny_batched_cpu_serve_with_kokoro_answers_two_text_turns():
    """``--tts kokoro`` behind the batched LM: the registry's Kokoro factory and
    handler, with the model at ``KokoroConfig.test_tiny()`` in the cache."""
    from s2s_tpu_torch.models.kokoro import KokoroConfig, KokoroTTS
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    GLOBAL_MODEL_CACHE.clear()
    tiny = GLOBAL_MODEL_CACHE.get(("kokoro", None, None, "en-us", False, "cpu"),
                                  lambda: KokoroTTS(cfg=KokoroConfig.test_tiny()))
    assert tiny.cfg == KokoroConfig.test_tiny()
    try:
        results = _serve_two_text_turns(tts_flags(BATCHED_FLAGS, "kokoro"))
        assert GLOBAL_MODEL_CACHE.get(("kokoro", None, None, "en-us", False, "cpu"), KokoroTTS) is tiny
    finally:
        GLOBAL_MODEL_CACHE.clear()
    _assert_spoken(results)


def test_tiny_batched_cpu_serve_with_mms_answers_two_text_turns():
    """``--tts facebookMMS`` behind the batched LM, the model at
    ``VitsConfig.test_tiny()`` in the cache; its 16 kHz is the wire's rate."""
    from s2s_tpu_torch.models.vits import VitsConfig, VitsTTS
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    GLOBAL_MODEL_CACHE.clear()
    tiny = GLOBAL_MODEL_CACHE.get(("mms_vits", None, "cpu"), lambda: VitsTTS(cfg=VitsConfig.test_tiny()))
    assert tiny.cfg == VitsConfig.test_tiny()
    try:
        results = _serve_two_text_turns(tts_flags(BATCHED_FLAGS, "facebookMMS"))
        assert GLOBAL_MODEL_CACHE.get(("mms_vits", None, "cpu"), VitsTTS) is tiny
    finally:
        GLOBAL_MODEL_CACHE.clear()
    _assert_spoken(results)


def test_tiny_batched_cpu_serve_with_pocket_answers_two_text_turns():
    """``--tts pocket`` behind the batched LM, the model at
    ``PocketTTSConfig.tiny()`` in the cache, its Mimi output conv scaled by
    2000 as ``tests/test_tts.py`` scales it (random weights synthesize
    near-silence, which the handler trims)."""
    from s2s_tpu_torch.models.pocket_tts import PocketTTS, PocketTTSConfig
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    def tiny_model():
        model = PocketTTS(cfg=PocketTTSConfig.tiny())
        model.params["mimi"]["final_conv"]["w"] *= 2000.0
        return model

    GLOBAL_MODEL_CACHE.clear()
    tiny = GLOBAL_MODEL_CACHE.get(("pocket-tts", None, None, "cpu"), tiny_model)
    try:
        results = _serve_two_text_turns(tts_flags(BATCHED_FLAGS, "pocket"))
        assert GLOBAL_MODEL_CACHE.get(("pocket-tts", None, None, "cpu"), PocketTTS) is tiny
    finally:
        GLOBAL_MODEL_CACHE.clear()
    _assert_spoken(results)


def test_tiny_batched_cpu_serve_with_chattts_answers_two_text_turns():
    """``--tts chatTTS`` behind the batched LM, the model at
    ``ChatTTSConfig.tiny()`` in the cache, its Vocos head scaled by 50 as
    ``tests/test_chattts.py`` scales it."""
    from s2s_tpu_torch.models.chattts import ChatTTSConfig, ChatTTSModel
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    def tiny_model():
        model = ChatTTSModel(cfg=ChatTTSConfig.tiny())
        model.params["vocos"]["head"]["w"] *= 50.0
        return model

    GLOBAL_MODEL_CACHE.clear()
    tiny = GLOBAL_MODEL_CACHE.get(("chattts", None, "cpu"), tiny_model)
    try:
        results = _serve_two_text_turns(tts_flags(BATCHED_FLAGS, "chatTTS"))
        assert GLOBAL_MODEL_CACHE.get(("chattts", None, "cpu"), ChatTTSModel) is tiny
    finally:
        GLOBAL_MODEL_CACHE.clear()
    _assert_spoken(results)


def _voice_turn_events():
    """3.25 s of a modulated 220 Hz tone between silences as PCM16 appends,
    then a commit."""
    import numpy as np

    rate = 16_000
    t = np.arange(2 * rate) / rate
    speech = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    pcm = np.concatenate([np.zeros(rate // 4), speech, np.zeros(rate)])
    pcm16 = (np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes()
    step = rate // 10 * 2
    return [{"type": "input_audio_buffer.append", "audio": base64.b64encode(pcm16[i : i + step]).decode()}
            for i in range(0, len(pcm16), step)] + [{"type": "input_audio_buffer.commit"}]


async def _voice_turn(url: str, max_s: float) -> list[dict]:
    """Send the voice turn; collect events until the transcription and then
    ``response.done`` (or 5 s of quiet after an empty transcript)."""
    import websockets.asyncio.client as ws_client

    events: list[dict] = []
    loop = asyncio.get_running_loop()
    async with ws_client.connect(url, max_size=None) as ws:
        events.append(json.loads(await asyncio.wait_for(ws.recv(), 10)))
        for event in _voice_turn_events():
            await ws.send(json.dumps(event))
        deadline, quiet_until = loop.time() + max_s, None
        while loop.time() < deadline:
            if quiet_until is not None and loop.time() > quiet_until:
                break
            try:
                event = json.loads(await asyncio.wait_for(ws.recv(), 1.0))
            except asyncio.TimeoutError:
                continue
            events.append(event)
            if event["type"] == "conversation.item.input_audio_transcription.completed" and not event[
                    "transcript"].strip():
                quiet_until = loop.time() + 5.0
            if event["type"] == "response.done":
                break
    return events


def test_tiny_cpu_serve_with_whisper_and_smart_turn_answers_a_voice_turn(monkeypatch, caplog):
    """Energy VAD with Smart Turn on, Whisper tiny: the voice turn is
    transcribed and answered; Smart Turn ran at the soft end and none of its
    predictions failed (the VAD handler would log and carry on)."""
    import logging

    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
    from s2s_tpu_torch.vad import smart_turn

    predictions = []
    real = smart_turn.SmartTurnAnalyzer.predict

    def counted(self, audio, sample_rate=smart_turn.SAMPLE_RATE):
        result = real(self, audio, sample_rate)
        predictions.append(result)
        return result

    monkeypatch.setattr(smart_turn.SmartTurnAnalyzer, "predict", counted)
    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *WHISPER_FLAGS], stop)
    manager.start()
    try:
        assert server.started.wait(30)
        with caplog.at_level(logging.ERROR):
            events = asyncio.run(_voice_turn(f"ws://127.0.0.1:{server.bound_port}/v1/realtime", 240))
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    types = [e["type"] for e in events]
    transcripts = [e["transcript"] for e in events
                   if e["type"] == "conversation.item.input_audio_transcription.completed"]
    assert transcripts, types
    assert predictions and all(0.0 <= p.probability <= 1.0 for p in predictions)
    assert "Smart Turn inference failed" not in caplog.text
    if transcripts[0].strip():  # random weights may decode EOT first: then no reply
        assert "response.output_audio.delta" in types, types
        assert events[-1]["type"] == "response.done" and events[-1]["response"]["status"] == "completed", types


_NO_JAX = """
import importlib, json, pkgutil, sys, threading
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["s2s_tpu"] = None  # and so does any import of the JAX package
import s2s_tpu_torch
names = [m.name for m in pkgutil.walk_packages(s2s_tpu_torch.__path__, "s2s_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from s2s_tpu_torch import cli
from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
for flags in json.loads(sys.argv[1]):
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *flags], threading.Event())
    GLOBAL_MODEL_CACHE.clear()
assert not any(k in ("jax", "s2s_tpu") or k.startswith(("jax.", "s2s_tpu.")) for k, v in sys.modules.items()
               if v is not None)
print("OK", len(names))
"""


def test_port_imports_and_builds_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, json.dumps([TINY_FLAGS, BATCHED_FLAGS, WHISPER_FLAGS,
                                                                  _with(PARAFORMER_FLAGS, llm_backend="local-vlm")])],
                          cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def test_model_parallel_raises_at_build_time():
    """Without a layout of its ranks, ``--model_parallel 2`` on the CPU (one
    device) raises the device-count error before anything is built."""
    from s2s_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--model_parallel 2 needs 2 devices; 1 visible"):
        cli.build_from_argv(["--device", "cpu", *BATCHED_FLAGS, "--model_parallel", "2"], threading.Event())


#: the serves of the backends ported last: Paraformer tiny, the VLM stage
#: (SmolLM2 tiny behind the full SigLIP tower, random weights; a text turn
#: never runs the tower)
PARAFORMER_FLAGS = _with(TINY_FLAGS, stt="paraformer")
VLM_FLAGS = _with(TINY_FLAGS, llm_backend="local-vlm")


def _serve_text_and_voice_turns(flags: list[str]):
    """One text turn, then one voice turn (each its own session), on a tiny
    serve built by the CLI: (handlers, text events, voice events)."""
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    stop = threading.Event()
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *flags], stop)
    manager.start()
    try:
        assert server.started.wait(30)
        url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"
        text = asyncio.run(_text_turn(url, "Hello there", 120))
        deadline = time.monotonic() + 30
        while server.pool[0].session is not None and time.monotonic() < deadline:
            time.sleep(0.05)  # the one unit frees once the text session has drained
        voice = asyncio.run(_voice_turn(url, 240))
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    _assert_spoken([text])
    types = [e["type"] for e in voice]
    transcripts = [e["transcript"] for e in voice
                   if e["type"] == "conversation.item.input_audio_transcription.completed"]
    assert transcripts, types
    if transcripts[0].strip():  # a random-init reply may be empty: then no audio
        assert "response.output_audio.delta" in types and voice[-1]["type"] == "response.done", types
    return manager.handlers, text, voice, transcripts[0]


def test_tiny_cpu_serve_with_paraformer_answers_a_text_and_a_voice_turn():
    from s2s_tpu_torch.stt.paraformer_handler import ParaformerSTTHandler

    handlers, _, _, transcript = _serve_text_and_voice_turns(PARAFORMER_FLAGS)
    stt = next(h for h in handlers if isinstance(h, ParaformerSTTHandler))
    assert stt.language == "zh" and stt._paraformer_cfg.d_model == 16
    # random weights and no tokenizer: the transcript is the token ids
    assert transcript.strip() and all(t.isdigit() for t in transcript.split())


def test_tiny_cpu_serve_with_the_vlm_stage_answers_a_text_and_a_voice_turn(monkeypatch):
    from s2s_tpu_torch.llm.vlm_backend import VisionLocalTorchLLMHandler
    from s2s_tpu_torch.models import vision

    encodes = []
    monkeypatch.setattr(vision, "encode_image", lambda *a: encodes.append(a))
    handlers, _, _, _ = _serve_text_and_voice_turns(VLM_FLAGS)
    llm = next(h for h in handlers if isinstance(h, VisionLocalTorchLLMHandler))
    assert llm.vision_cfg == vision.VisionConfig(d_out=llm.cfg.d_model) and llm.shared_lm is None
    assert not encodes  # turns without an image never run the tower


def test_tiny_cpu_serve_with_the_enhancer_answers_a_text_and_a_voice_turn(monkeypatch, tmp_path):
    """``--vad_enhancer_checkpoint`` with a converted DeepFilterConfig()
    checkpoint from a seed: every VAD-final segment goes through it."""
    import numpy as np
    import torch

    from s2s_tpu_torch.models import deepfilter
    from s2s_tpu_torch.vad.handler import VADHandler

    tree = deepfilter.init_params(deepfilter.DeepFilterConfig(), torch.Generator().manual_seed(0))
    path = tmp_path / "deepfilter.npz"
    np.savez(path, **flatten(tree))
    calls = []
    real = deepfilter.DeepFilterEnhancer.__call__

    def counted(self, audio):
        out = real(self, audio)
        calls.append((audio.size, out.size, bool(np.isfinite(out).all())))
        return out

    monkeypatch.setattr(deepfilter.DeepFilterEnhancer, "__call__", counted)
    handlers, _, _, _ = _serve_text_and_voice_turns(TINY_FLAGS + ["--vad_enhancer_checkpoint", str(path)])
    vad = next(h for h in handlers if isinstance(h, VADHandler))
    assert isinstance(vad.enhancer, deepfilter.DeepFilterEnhancer)
    torch.testing.assert_close(vad.enhancer.params["gru"]["wh"], tree["gru"]["wh"], rtol=0, atol=0)
    assert calls and all(n_in == n_out and finite for n_in, n_out, finite in calls)


def test_whisper_aliases_and_voice_cloning_build(tmp_path):
    """The reference's Whisper backend names resolve to the port's Whisper
    stage, and ``--tts_ref_audio`` (a 16 kHz PCM16 WAV) builds a cloned
    speaker vector through the log-mel."""
    import wave

    import numpy as np

    from s2s_tpu_torch import cli
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE, get_backend
    from s2s_tpu_torch.stt.whisper_handler import WhisperSTTHandler

    for alias in ("faster-whisper", "whisper-mlx", "mlx-audio-whisper"):
        assert get_backend("stt", alias).name == "whisper"
    wav = tmp_path / "ref.wav"
    pcm = (0.2 * np.random.default_rng(2).standard_normal(12_000) * 32767).astype(np.int16)
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.tobytes())
    flags = _with(WHISPER_FLAGS, stt="faster-whisper") + ["--tts_ref_audio", str(wav)]
    manager, _, _ = cli.build_from_argv(["--device", "cpu", *flags], threading.Event())
    try:
        stt = next(h for h in manager.handlers if isinstance(h, WhisperSTTHandler))
        tts = next(h for h in manager.handlers if type(h).__name__ == "Qwen3TTSHandler")
        assert stt.device.type == "cpu"
        assert tts._speaker_vec.shape == (1, tts.model.cfg.lm.d_model) and tts._model_type() == "voice_clone"
    finally:
        GLOBAL_MODEL_CACHE.clear()


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
