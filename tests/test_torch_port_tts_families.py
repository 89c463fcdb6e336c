"""The JAX package's host tests of the Kokoro, MMS, Pocket and ChatTTS
families' host code, run against the port's copies.

``s2s_tpu_torch/tts/g2p.py``, ``tts/kokoro_handler.py`` and
``tts/pocket_handler.py`` are verbatim copies of the JAX package's modules
(the drift guard in ``tests/test_torch_port_selfcontained.py`` holds them
equal), ``tts/chattts_handler.py`` differs only in its speaker draw, and the
port's ``KokoroTTS``, ``PocketTTS``, ``ChatTTSModel`` and registry factories
take the JAX package's arguments.  This
file loads the named subset of each JAX test module below with the package
name substituted (``s2s_tpu.`` -> ``s2s_tpu_torch.``), as
``tests/test_torch_port_remote_llm.py`` does for whole modules, and collects
those cases here:

- ``tests/test_tts_frontend.py``: the English G2P cases and the Kokoro
  plain-text path (the G2P before the vocab map, the phoneme path, a tiny
  synthesis, the registry building G2P only with a vocab);
- ``tests/test_pocket_tts.py``: the Pocket wrapper (incremental chunks,
  stream against synthesize, a named voice, the chunked host path against
  ``synthesize_utterance``), the handler (a synthesis, an unknown voice) and
  the SentencePiece tokenizer;
- ``tests/test_chattts.py``: the handler's synthesis and its speaker
  redrawn at the end of a session;
- ``tests/test_tts.py``: the Pocket and ChatTTS handlers through
  ``process`` and the TTS registry's five families;
- ``tests/test_whole_chain_speculation.py``: the Kokoro handler's
  side-thread speculation (adoption, mismatch, a failed speculation, the
  end of a response, the slot between pieces, the promoted lane).

The other cases of those modules test code the port holds elsewhere (the
qwen3 frontend, ``tests/test_torch_port_qwen3_tts.py``; Mimi, the Pocket LM
and ChatTTS's numerics against their torch twins,
``tests/test_torch_port_{mimi,pocket,chattts}.py``) or stay JAX-only: the
cases that call ``jax.random`` for a speaker (``test_chattts.py``'s
``TestModelWrapper.test_stream_concat_equals_synthesize``), feed JAX arrays
to the op (``test_tts.py``'s iSTFT cases) or load a checkpoint through the
JAX converters by the JAX package's names (``test_chattts.py``'s
``test_config_inferred_from_converted_params``).  A subset's module keeps
the imports its definitions use.
"""

import ast
import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent

#: JAX test module -> the definitions whose cases run against the port here
SUBSETS = {
    "test_tts_frontend": ("TestEnglishG2P", "TestKokoroPlainTextPath"),
    "test_pocket_tts": ("TestPocketWrapper", "TestPocketHandler", "TestTokenizer"),
    "test_chattts": ("TestHandler",),
    "test_tts": (
        "tts_input", "test_pocket_handler_streams_through_real_model", "test_chattts_handler_random_speaker",
        "test_all_tts_backends_registered",
    ),
    "test_whole_chain_speculation": (
        "spec_text", "_kokoro_handler", "_wait_spec_done",
        "test_fallback_speculation_adopted_by_single_stream_backend",
        "test_fallback_mismatch_or_language_falls_back_to_real_synthesis",
        "test_fallback_failed_speculation_never_adopted",
        "test_fallback_discarded_on_end_of_response",
        "test_fallback_speculation_yields_slot_between_pieces",
        "test_fallback_adoption_promotes_side_thread_lane",
    ),
}


def _subset_module(name: str, keep: tuple[str, ...]) -> types.ModuleType:
    path = TESTS / f"{name}.py"
    source = path.read_text().replace("s2s_tpu.", "s2s_tpu_torch.")
    assert "s2s_tpu." not in source.replace("s2s_tpu_torch.", "")
    tree = ast.parse(source, str(path))
    defs = [node for node in tree.body if getattr(node, "name", None) in keep]
    assert sorted(node.name for node in defs) == sorted(keep), f"{name}: a named definition is missing"
    used = {n.id for d in defs for n in ast.walk(d) if isinstance(n, ast.Name)}
    imports = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            node.names = [a for a in node.names if (a.asname or a.name).split(".")[0] in used]
            if node.names:
                imports.append(node)
    module = types.ModuleType(f"{__name__}.{name}")
    module.__file__ = str(path)
    sys.modules[module.__name__] = module
    body = ast.Module(body=[n for n in tree.body if n in imports or n in defs], type_ignores=[])
    exec(compile(body, str(path), "exec"), module.__dict__)
    return module


def _collect() -> dict:
    found: dict = {}
    for name, keep in SUBSETS.items():
        module = _subset_module(name, keep)
        for attr in keep:
            if attr.startswith(("test_", "Test")):
                assert attr not in found, f"{name}.{attr} is defined twice"
                found[attr] = getattr(module, attr)
    return found


globals().update(_collect())
