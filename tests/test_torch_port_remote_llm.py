"""The JAX package's tests of the remote LLM backends, the LLM proxy and the
audio client, run against the port's copies of those modules.

``s2s_tpu_torch/llm/openai_backend.py``, ``realtime/llm_proxy.py`` and
``client.py`` are verbatim copies of the JAX package's modules (the drift
guard in ``tests/test_torch_port_selfcontained.py`` holds them equal).  This
file loads each JAX test module below with the package name substituted
(``s2s_tpu.`` -> ``s2s_tpu_torch.``) and collects its tests and fixtures
here, so the same cases drive the port's modules: ``httpx.MockTransport``
upstreams, local HTTP servers on 127.0.0.1 and a fake audio device, no
network.  A test here fails if the port's copy (or what it imports from
the port) behaves otherwise than the JAX package's.
"""

import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent

#: the JAX package's test modules whose cases run against the port here
MODULES = (
    "test_remote_llm_matrix",
    "test_remote_llm_matrix2",
    "test_remote_llm_spec",
    "test_remote_llm_audio_tools",
    "test_llm_proxy",
    "test_audio_client",
)


def _port_module(name: str) -> types.ModuleType:
    path = TESTS / f"{name}.py"
    source = path.read_text().replace("s2s_tpu.", "s2s_tpu_torch.")
    assert "s2s_tpu." not in source.replace("s2s_tpu_torch.", "")
    module = types.ModuleType(f"{__name__}.{name}")
    module.__file__ = str(path)
    sys.modules[module.__name__] = module
    exec(compile(source, str(path), "exec"), module.__dict__)
    return module


def _collect() -> dict:
    found: dict = {}
    for name in MODULES:
        module = _port_module(name)
        for attr, value in vars(module).items():
            fixture = hasattr(value, "_fixture_function_marker") or type(value).__name__ == "FixtureFunctionDefinition"
            if attr.startswith(("test_", "Test")) or fixture:
                assert attr not in found or found[attr] is value, f"{name}.{attr} is defined twice"
                found[attr] = value
    return found


globals().update(_collect())
