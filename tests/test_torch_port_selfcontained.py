"""The port (``s2s_tpu_torch``) stands alone: it imports nothing of the JAX
package ``s2s_tpu`` and nothing of ``jax``, and its copies of the JAX
package's host code have not drifted from their originals.

- An AST scan of every ``.py`` under ``s2s_tpu_torch/`` and of
  ``chip_smoke.py``: no ``import``/``from`` names ``s2s_tpu`` (or a module
  under it) or ``jax``, at module level or inside a function, and no
  ``importlib``/``__import__`` call with such a name.
- In a subprocess where importing either name fails, every port module
  imports, the tiny two-session CPU serve of
  ``tests/test_torch_port_serve.py`` builds and answers two concurrent text
  turns with audio and ``response.done``, and the same serve builds with
  ``--tts kokoro`` and ``--tts facebookMMS`` (full width, random init) and
  with ``--tts pocket`` and ``--tts chatTTS`` (their tiny models in the
  model cache under the factories' keys).
- The drift guard: a verbatim copy equals its JAX module's text after the
  package-name substitution ``s2s_tpu.`` -> ``s2s_tpu_torch.``; in a trimmed
  or folded module, every definition it shares with its JAX module(s) equals
  the JAX definition's source after the substitution, except the port's own
  device-side definitions, listed with the reason.  Every port module whose
  path also exists in the JAX package is in exactly one of these lists or in
  the list of the port's own modules.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "s2s_tpu_torch"
JAX = ROOT / "s2s_tpu"

#: copied whole from s2s_tpu/<path>; host code that never imports jax
VERBATIM = """
arguments.py client.py
audio/framing.py audio/pcm.py
llm/audio_input_notifier.py llm/base_handler.py llm/bpe_tokenizer.py llm/chat.py llm/compaction.py
llm/openai_backend.py llm/output_processor.py llm/prompts.py llm/tool_call.py llm/utils.py
pipeline/control.py pipeline/events.py pipeline/log_context.py pipeline/messages.py pipeline/turns.py
realtime/config.py realtime/handlers.py realtime/llm_proxy.py realtime/pipeline_unit.py realtime/router.py
realtime/server.py realtime/service.py realtime/transports.py realtime/types.py realtime/webrtc.py
runtime/base_handler.py runtime/device_scheduler.py runtime/thread_manager.py
stt/base.py stt/language_id.py stt/notifier.py stt/progressive.py stt/tokenizer.py
tts/base.py tts/g2p.py tts/kokoro_handler.py tts/mms_handler.py tts/pocket_handler.py
utils/common.py utils/sentences.py
vad/energy.py vad/iterator.py
""".split()

#: port path -> (JAX paths it copies from, {port class: JAX classes}, the
#: port's own definitions that differ from the JAX ones, why)
SHARED = {
    "vad/handler.py": (
        ["vad/handler.py"], {}, {"VADHandler.setup"},
        "setup hands its device to the Smart Turn analyzer and the default Silero model it builds"),
    "vad/smart_turn.py": (
        ["vad/smart_turn.py"], {}, {"SmartTurnAnalyzer.__init__", "load_checkpoint"},
        "folded: the result type, the window and predict are copied; the analyzer runs the port's "
        "log-mel kernel and encoder on its device, the checkpoint loads through the port's registry"),
    "audio/resample.py": (
        ["audio/resample.py"], {}, set(),
        "folded: the scipy path and the polyphase filter are copied; the jitted on-device polyphase is "
        "the port's torch_resample_poly"),
    "registry.py": (
        ["registry.py"], {}, {"_make_whisper_stt", "_make_parakeet_stt", "_make_paraformer_stt", "_make_local_llm",
                              "_make_local_vlm", "_make_qwen3_tts", "_make_kokoro_tts", "_make_mms_tts",
                              "_make_pocket_tts", "_make_chattts", "STT_BACKENDS", "LLM_BACKENDS", "TTS_BACKENDS",
                              "resolve_backend_alias"},
        "folded: the registry types, loaders, aliases and lookup are copied; the factories and the registries "
        "are the port's (its devices, its models)"),
    "stt/paraformer_handler.py": (
        ["stt/paraformer_handler.py"], {}, set(),
        "folded: setup (Chinese by default) is copied; the transcriber (_build_transcriber, the port's name) "
        "runs the log-mel kernel, LFR + CMVN on the device and the port's Paraformer"),
    "llm/vlm_backend.py": (
        ["llm/vlm_backend.py"], {"VisionLocalTorchLLMHandler": ["VisionLocalJAXLLMHandler"]},
        {"VisionLocalTorchLLMHandler.setup", "VisionLocalTorchLLMHandler._jax_generate"},
        "folded: extract_image_urls is copied; setup draws the tower from a torch.Generator on the device, "
        "generation runs the port's tower, prefill_embeds and chunked greedy decode"),
    "models/paraformer.py": (
        ["models/paraformer.py"], {},
        {"ParaformerConfig.dtype", "lfr_cmvn", "_lin", "_fsmn", "_sanm_attention", "_enc_layer", "_sinusoid_positions",
         "encode", "cif_alphas", "cif_fire", "_cross_attention", "_dec_ff", "_dec_layer", "decode", "forward",
         "transcribe_tokens", "init_params"},
        "folded: the configuration is copied; the frontend (LFR + CMVN on the device, held bit-equal to the "
        "numpy function by tests/test_torch_port_paraformer.py) and the model are the port's"),
    "models/vision.py": (
        ["models/vision.py"], {},
        {"VisionConfig.dtype", "VisionConfig.test_tiny", "_lin", "encode_image", "init_params"},
        "folded: the configuration and the image preprocessing are copied; the tower is the port's"),
    "models/deepfilter.py": (
        ["models/deepfilter.py"], {},
        {"init_params", "init_state", "_causal_conv2d", "_stft", "enhance", "DeepFilterEnhancer.__init__",
         "DeepFilterEnhancer.__call__", *(f"DFState.{f}" for f in ("gru_h", "erb_mean", "mag_mean", "erb_prev",
                                                                  "erb_prev1", "df_prev", "df_prev1", "spec_hist"))},
        "folded: the configuration, the ERB filterbank and the enhancer's buckets are copied; the state holds "
        "tensors, the frames run through the port's filter_frames (loops only over the recurrences) on its "
        "device, the enhancer takes a device"),
    "ops/mel.py": (
        ["ops/mel.py"], {}, {"frame_audio", "log_mel_spectrogram"},
        "folded: the numpy filterbank and DFT bases are copied; framing and the log-mel run in torch "
        "(the plain version of the log-mel kernel in ops/log_mel.py)"),
    "stt/whisper_handler.py": (
        ["stt/whisper_handler.py"], {}, {"WhisperSTTHandler.setup"},
        "folded: buckets, token parsing and the stage skeleton are copied; setup takes a device and "
        "the transcriber runs the port's log-mel kernel and Whisper"),
    "stt/parakeet_handler.py": (
        ["stt/parakeet_handler.py"], {}, {"config_for", "ParakeetSTTHandler.setup"},
        "folded: it subclasses the port's Whisper handler as the JAX one does; setup passes the device "
        "and the transcriber is the port's"),
    "tts/qwen3_handler.py": (
        ["tts/qwen3_handler.py"], {}, {"Qwen3TTSHandler.setup", "Qwen3TTSHandler._begin_speculative_synthesis",
                                       "Qwen3TTSHandler._synthesize"},
        "folded: planning and speculation bookkeeping are copied; speakers and text ids go to the "
        "port's model and engine as tensors and host arrays"),
    "tts/chattts_handler.py": (
        ["tts/chattts_handler.py"], {}, {"ChatTTSHandler._resample_speaker"},
        "trimmed: the JAX module draws the speaker with jax.random; the port draws it with its own "
        "sample_speaker on a torch.Generator seeded from the same random.Random(seed) stream"),
    "llm/local_backend.py": (
        ["llm/local_backend.py"], {"LocalTorchLLMHandler": ["LocalJAXLLMHandler"]},
        {"lm_config", "LocalTorchLLMHandler.setup", "LocalTorchLLMHandler._jax_generate",
         "LocalTorchLLMHandler._sampled_decode"},
        "folded: the host side is copied; prefill, decode and sampling run the port's decoder"),
    "runtime/batcher.py": (
        ["runtime/batcher.py"], {},
        {"BatchedSileroVAD.__init__", "BatchedSileroVAD._run_batch", "BatchedSileroVAD.reset_slot",
         "BatchedParakeetSTT.__init__", "BatchedParakeetSTT._run_batch", "BatchedParakeetSTT.warmup"},
        "folded: the micro-batcher and the Silero slot view are copied; the Silero carry and its masked step, "
        "and the Parakeet batch, run the port's models on its device"),
    "parallel/session_scheduler.py": (
        ["parallel/session_scheduler.py"], {},
        {"BatchedLMScheduler.__init__", "BatchedLMScheduler.warmup", "BatchedLMScheduler._fetch",
         "BatchedLMScheduler._drive", "BatchedTTSScheduler.__init__", "BatchedTTSScheduler.warmup",
         "BatchedTTSScheduler._fetch", "BatchedTTSScheduler._drive"},
        "folded: slots, lanes, buckets, handles and the gate are copied; construction, warm-up and "
        "the driver and fetcher threads run the port's programs"),
}

#: the port's own modules at a path the JAX package also has
OWN = """
__init__.py audio/__init__.py llm/__init__.py models/__init__.py ops/__init__.py parallel/__init__.py
pipeline/__init__.py realtime/__init__.py runtime/__init__.py stt/__init__.py tts/__init__.py
utils/__init__.py vad/__init__.py
builder.py cli.py
models/chattts.py models/common.py models/decoder_lm.py models/kokoro.py models/mimi.py models/parakeet.py
models/pocket_tts.py models/qwen3_tts.py models/silero_vad.py models/vits.py models/whisper.py
ops/decode_attention.py ops/int4_matmul.py ops/int8_matmul.py ops/istft.py ops/quant.py
parallel/batched_decode.py parallel/mesh.py parallel/training.py
runtime/profiler.py
""".split()


def _port_text(path: str) -> str:
    return (PORT / path).read_text()


def _jax_text(path: str) -> str:
    return (JAX / path).read_text().replace("s2s_tpu.", "s2s_tpu_torch.")


def _python_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str | None) -> bool:
    if not name:
        return False
    top = name.split(".")[0]
    return top in ("s2s_tpu", "jax")


def test_no_module_of_the_port_imports_the_jax_package_or_jax():
    found = []
    for path in _python_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            elif isinstance(node, ast.Call):
                fn = node.func
                callee = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                if callee in ("import_module", "__import__") and node.args:
                    arg = node.args[0]
                    names = [arg.value] if isinstance(arg, ast.Constant) and isinstance(arg.value, str) else []
            found += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not found, found


_BLOCKED_SERVE = """
import asyncio, importlib, importlib.abc, pkgutil, sys, threading
sys.modules["s2s_tpu"] = None  # any import of the JAX package raises ImportError


class _NoJax(importlib.abc.MetaPathFinder):
    # jax is refused by a finder, not by a None entry in sys.modules: scipy
    # (the audio resampler) probes sys.modules["jax"] and fails on a None
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, sys.argv[1])
import s2s_tpu_torch
names = [m.name for m in pkgutil.walk_packages(s2s_tpu_torch.__path__, "s2s_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import test_torch_port_serve as serve
from s2s_tpu_torch import cli
from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

stop = threading.Event()
manager, server, _ = cli.build_from_argv(["--device", "cpu", *serve.BATCHED_FLAGS], stop)
manager.start()
try:
    assert server.started.wait(30)
    url = f"ws://127.0.0.1:{server.bound_port}/v1/realtime"

    async def both():
        return await asyncio.gather(serve._text_turn(url, "Hello there", 120), serve._text_turn(url, "Hi", 120))

    results = asyncio.run(both())
finally:
    stop.set()
    manager.stop()
    GLOBAL_MODEL_CACHE.clear()
for events in results:
    types = [e["type"] for e in events]
    assert "response.output_audio.delta" in types, types
    assert events[-1]["type"] == "response.done" and events[-1]["response"]["status"] == "completed", types
from s2s_tpu_torch.models.chattts import ChatTTSConfig, ChatTTSModel
from s2s_tpu_torch.models.pocket_tts import PocketTTS, PocketTTSConfig

tiny = {"pocket": (("pocket-tts", None, None, "cpu"), lambda: PocketTTS(cfg=PocketTTSConfig.tiny())),
        "chatTTS": (("chattts", None, "cpu"), lambda: ChatTTSModel(cfg=ChatTTSConfig.tiny()))}
for tts, model in (("kokoro", "KokoroTTS"), ("facebookMMS", "VitsTTS"), ("pocket", "PocketTTS"),
                   ("chatTTS", "ChatTTSModel")):
    if tts in tiny:
        GLOBAL_MODEL_CACHE.get(*tiny[tts])
    manager, _, _ = cli.build_from_argv(["--device", "cpu", *serve.tts_flags(serve.BATCHED_FLAGS, tts)],
                                        threading.Event())
    built = [type(h.model) for h in manager.handlers if type(getattr(h, "model", None)).__name__ == model]
    assert len(built) == 2 and built[0].__module__.startswith("s2s_tpu_torch.models."), built
    GLOBAL_MODEL_CACHE.clear()
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and (k in ("jax", "s2s_tpu") or k.startswith(("jax.", "s2s_tpu."))))
assert not leaked, leaked
print("OK", len(names))
"""


def test_port_serves_two_sessions_with_the_jax_package_and_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SERVE, str(ROOT / "tests")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def test_every_port_module_with_a_jax_counterpart_is_classified():
    classified = VERBATIM + list(SHARED) + OWN
    assert len(classified) == len(set(classified))
    both = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py") if (JAX / p.relative_to(PORT)).exists())
    assert sorted(classified) == both


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copy_equals_its_jax_module(path):
    assert _port_text(path) == _jax_text(path)


def _definitions(text: str) -> dict[str, str]:
    """Qualified name -> source of every top-level function and assignment
    and of every member (method, field, class attribute) of a top-level
    class."""
    lines = text.splitlines(keepends=True)
    out: dict[str, str] = {}

    def source(node) -> str:
        start = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])])
        return "".join(lines[start - 1: node.end_lineno])

    def names(node) -> list[str]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return [node.name]
        if isinstance(node, ast.Assign):
            return [t.id for t in node.targets if isinstance(t, ast.Name)]
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            return [node.target.id]
        return []

    for node in ast.parse(text).body:
        if isinstance(node, ast.ClassDef):  # a class is compared member by member
            for member in node.body:
                for name in names(member):
                    out[f"{node.name}.{name}"] = source(member)
            continue
        for name in names(node):
            out[name] = source(node)
    return out


@pytest.mark.parametrize("path", sorted(SHARED))
def test_shared_definitions_equal_their_jax_source(path):
    jax_paths, class_map, own, why = SHARED[path]
    assert why
    port_defs = _definitions(_port_text(path))
    jax_defs = [_definitions(_jax_text(p)) for p in jax_paths]
    assert own <= set(port_defs), sorted(own - set(port_defs))
    compared = 0
    for name, src in port_defs.items():
        if name in own:
            continue
        cls, _, member = name.rpartition(".")
        candidates = [f"{c}.{member}" for c in class_map.get(cls, [cls])] if cls else [name]
        matches = [defs[c] for defs in jax_defs for c in candidates if c in defs]
        if matches:
            assert src == matches[0], f"{path}: {name} drifted from the JAX package"
            compared += 1
    assert compared > 0
