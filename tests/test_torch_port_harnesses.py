"""The port's per-handler benchmarks and weight microbenchmarks
(``s2s_tpu_torch/tools/{benchmark_stt,benchmark_tts,microbench_weights,microbench_bscale}.py``)
against the JAX scripts they port.

- Each mix function of the microbenchmarks against the JAX script's own at a
  tiny size (D 128, FF 256, 2 layers, 2 steps, 4 rows), the JAX kernel in
  interpret mode: bit-equal on ternary integer inputs whose every partial
  sum stays below 2**24 in any order (so every f32 product is exact and the
  comparison sees each cast), in bf16 and, for the plain mixes, in f32; and
  within 2 bf16 ulps of max|JAX| on seeded normal inputs, where the f32 sums'
  order may flip a rounding, which later layers carry on.
- Every tool prints every key of its JAX script, defaults to ``--device
  cuda`` (so without a card it refuses) and with ``--device cpu`` keeps
  every parameter on the CPU; the STT tool runs all three backends, the TTS
  tool Qwen3-TTS tiny with and without ``--quantize int8``.

The card's cases (a replay equal to the eager call, exact launch counts)
are in ``tests/test_torch_port_harnesses_cuda.py``, which imports no JAX.
"""

import ast
import contextlib
import functools
import importlib.util
import io
import json
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_tpu_torch.tools import benchmark_stt, benchmark_tts, microbench_bscale, microbench_weights as mbw

ROOT = Path(__file__).resolve().parents[1]
TINY = mbw.CONFIGS["tiny"]
#: the tolerance on seeded normal inputs, in bf16 ulps of max|JAX|
ULPS = 2


@pytest.fixture(scope="module")
def jax_scripts(tmp_path_factory):
    """``scripts/microbench_{weights,bscale}.py`` loaded with their cache in
    a temporary directory, their sizes patched to ``TINY`` and the int8
    kernel interpreted; the JAX settings their import changes restored after."""
    from s2s_tpu.ops import int8_matmul as jmm

    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {name: getattr(jax.config, name) for name in names}
    modules = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
        for name in ("microbench_weights", "microbench_bscale"):
            spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            module.B, module.D, module.FF, module.L, module.STEPS = (TINY.rows, TINY.d, TINY.ff, TINY.layers,
                                                                    TINY.steps)
            modules[name] = module
    modules["microbench_weights"].mm = types.SimpleNamespace(
        int8_matmul=functools.partial(jmm.int8_matmul, interpret=True))
    yield modules
    for name, value in saved.items():
        jax.config.update(name, value)


def _inputs(shapes, path: str, exact: bool, seed: int):
    """(x, the stacks as numpy arrays: ``(q0, s0, ...)``, or ``(w0, ...)``
    on the bf16 path) for a mix: ternary integers with unit scales where
    *exact*; else normal x, int8 weights in [-127, 127) (their spread about
    73) and normal bf16 weights, each scaled to about unit gain."""
    rng = np.random.default_rng(seed)
    layers = TINY.layers
    if exact:
        x = rng.integers(-1, 2, (TINY.rows, TINY.d)).astype(np.float32)
        ws = [rng.integers(-1, 2, (layers, k, n)).astype(np.int8) for k, n in shapes]
        scales = [np.ones((layers, n), np.float32) for _, n in shapes]
    else:
        x = rng.standard_normal((TINY.rows, TINY.d)).astype(np.float32)
        ws = [rng.integers(-127, 127, (layers, k, n)).astype(np.int8) for k, n in shapes]
        scales = [rng.uniform(0.5, 1.5, (layers, n)).astype(np.float32) / (73 * np.sqrt(k)) for k, n in shapes]
    if path != "bf16":
        return x, [v for w, s in zip(ws, scales) for v in (w, s)]
    if exact:
        return x, [w.astype(np.float32) for w in ws]
    return x, [(rng.standard_normal((layers, k, n)) / np.sqrt(k)).astype(np.float32) for k, n in shapes]


def _largest_partial_sum(x: np.ndarray, ws: list[np.ndarray], dtype: torch.dtype) -> float:
    """The largest sum of |terms| of any product along the mix's trajectory
    on integer inputs (each sum exact in float64, cast to *dtype* as the
    chunk casts it): below 2**24 every f32 sum of these integers is exact in
    any order."""
    h, d, worst = torch.from_numpy(x).to(dtype), x.shape[1], 0.0
    for _ in range(TINY.steps):
        for layer in range(TINY.layers):
            outs = []
            for w in ws:
                hi = h.double().repeat(1, w.shape[1] // d)
                q = torch.from_numpy(np.ascontiguousarray(w[layer])).double()
                worst = max(worst, float((hi.abs() @ q.abs()).max()))
                outs.append((hi @ q).to(dtype)[:, :d])
            h = sum(outs)
    return worst


def _mixes(jax_scripts, name: str, mix: str):
    """(the JAX function, the port's function, the path) of a mix by name."""
    jw, jb = jax_scripts["microbench_weights"], jax_scripts["microbench_bscale"]
    return {"kernel": (jw.kernel_mix_chunk, mbw.kernel_mix_chunk, "kernel"),
            "einsum_int8": (functools.partial(jw.einsum_mix_chunk, int8=True),
                            functools.partial(mbw.einsum_mix_chunk, int8=True), "int8"),
            "bf16": (functools.partial(jw.einsum_mix_chunk, int8=False),
                     functools.partial(mbw.einsum_mix_chunk, int8=False), "bf16"),
            "bscale": (jb.mix_chunk, microbench_bscale.mix_chunk, "bf16")}[name] + (mbw.layer_shapes(TINY)[mix],)


def _run_both(jax_scripts, name, mix, dtype, exact, seed):
    jfn, tfn, path, shapes = _mixes(jax_scripts, name, mix)
    x, flat = _inputs(shapes, path, exact, seed)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    wdtype = jdtype if path == "bf16" else None
    jflat = tuple(jnp.asarray(a, wdtype) if wdtype is not None else jnp.asarray(a) for a in flat)
    want = np.asarray(jfn(jnp.asarray(x, jdtype), jflat, tuple(shapes), TINY.steps).astype(jnp.float32))
    tflat = tuple(torch.from_numpy(a).to(dtype) if path == "bf16" else torch.from_numpy(a) for a in flat)
    got = tfn(torch.from_numpy(x).to(dtype), tflat, shapes, TINY.steps)
    assert got.dtype == dtype and got.shape == (TINY.rows, TINY.d)
    return got.float().numpy(), want, x, flat[::2] if path != "bf16" else flat


@pytest.mark.parametrize("name,mix,dtype", [
    ("kernel", "seven", torch.bfloat16), ("kernel", "four", torch.bfloat16), ("kernel", "two", torch.bfloat16),
    ("einsum_int8", "seven", torch.bfloat16), ("einsum_int8", "seven", torch.float32),
    ("bf16", "seven", torch.bfloat16), ("bf16", "four", torch.float32), ("bscale", "seven", torch.bfloat16)])
def test_mix_is_bit_equal_to_the_jax_scripts_on_exact_integer_inputs(jax_scripts, name, mix, dtype):
    got, want, x, ws = _run_both(jax_scripts, name, mix, dtype, exact=True, seed=0)
    assert _largest_partial_sum(x, [np.asarray(w, np.float32) for w in ws], dtype) < 2 ** 24
    assert np.abs(want).max() > 256  # past bf16's integers: a bf16 cast rounds
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,mix", [("kernel", "seven"), ("kernel", "two"), ("einsum_int8", "seven"),
                                      ("bf16", "seven"), ("bf16", "four"), ("bscale", "seven")])
def test_mix_is_within_two_bf16_ulps_of_the_jax_scripts_on_normal_inputs(jax_scripts, name, mix):
    got, want, _, _ = _run_both(jax_scripts, name, mix, torch.bfloat16, exact=False, seed=1)
    scale = float(np.abs(want).max())
    assert np.isfinite(got).all() and scale > 0
    assert np.abs(got - want).max() <= ULPS * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _jax_keys(tool: str) -> set[str]:
    """The JSON keys the JAX script prints: its rows' names and GB/s
    (weights), its f-strings at every row count (bscale), the string keys
    of its result dicts (STT, TTS)."""
    text = (ROOT / "scripts" / f"{tool}.py").read_text()
    if tool == "microbench_weights":
        return {k for name in re.findall(r'run_mix\("(\w+)"', text) for k in (name, f"{name}_gbps")}
    if tool == "microbench_bscale":
        batches = re.search(r"for b in \(([\d, ]+)\)", text).group(1).split(",")
        return {f"{key}{int(b)}" for key in re.findall(r'f"(\w+)\{b\}"', text) for b in batches}
    keys = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Dict) and len(node.keys) > 4 and all(isinstance(k, ast.Constant) for k in node.keys):
            keys |= {k.value for k in node.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


def _printed(main, argv: list[str]) -> list[dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_microbench_tools_print_every_key_of_their_jax_scripts():
    lines = _printed(mbw.main, ["--device", "cpu", "--config", "tiny"])
    assert [line["row"] for line in lines] == [name for name, *_ in mbw.ROWS]
    assert set(mbw.row_keys()) <= {k for line in lines for k in line}
    assert _jax_keys("microbench_weights") == set(mbw.row_keys())
    assert all(line["device"] == "cpu" and line["device_s"] is None for line in lines)

    sizes, batches = microbench_bscale.CONFIGS["tiny"]
    lines = _printed(microbench_bscale.main, ["--device", "cpu", "--config", "tiny"])
    assert {k for line in lines for k in line} >= set(microbench_bscale.row_keys(batches))
    want = _jax_keys("microbench_bscale")
    assert want and want == set(microbench_bscale.row_keys(microbench_bscale.CONFIGS["smollm2-1.7b"][1]))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dict__"):
        yield from _tensors(vars(tree))


@pytest.mark.parametrize("backend,attr", [("whisper", "_whisper_params"), ("parakeet-tdt", "_parakeet_params"),
                                          ("paraformer", "_paraformer_params")])
def test_benchmark_stt_runs_every_backend_on_the_cpu_with_the_jax_keys(backend, attr):
    handler = benchmark_stt.build_handler(backend, "tiny", "en", torch.device("cpu"))
    leaves = list(_tensors(getattr(handler, attr)))
    assert leaves and {t.device.type for t in leaves} == {"cpu"}
    (line,) = _printed(benchmark_stt.main, ["--stt", backend, "--model_size", "tiny", "--seconds", "1", "--runs", "1",
                                            "--device", "cpu"])
    assert _jax_keys("benchmark_stt") - {"progressive_tick_s"} <= set(line)
    assert line["backend"] == backend and line["audio_s"] == 1.0 and line["device"] == "cpu"
    assert line["transcriptions"] == 2 and len(line["run_launches"]) == 1
    assert line["launches"] == {"flash_attention": 0, "log_mel": 0, "parakeet_log_mel": 0}  # the plain versions


def test_benchmark_stt_progressive_tick_is_timed():
    line = benchmark_stt.run("paraformer", "tiny", "en", seconds=1.0, runs=1, progressive=True, device="cpu")
    assert _jax_keys("benchmark_stt") <= set(line) and line["transcriptions"] == 3


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_benchmark_tts_runs_qwen3_tiny_on_the_cpu_with_the_jax_keys(monkeypatch, quantize):
    from s2s_tpu_torch.models.common import QuantWeight
    from s2s_tpu_torch.ops import quant

    monkeypatch.setattr(quant, "_MIN_SIZE", 1)  # the tiny matrices quantize
    handler = benchmark_tts.build_handler("qwen3", "tiny", quantize, "cpu")
    leaves = list(_tensors(handler.model.params))
    assert leaves and {t.device.type for t in leaves} == {"cpu"}
    talker = handler.model.params["talker"]["layers"]["wq"]
    assert isinstance(talker, QuantWeight) == (quantize == "int8")
    argv = ["--tts", "qwen3", "--model_size", "tiny", "--runs", "1", "--device", "cpu"]
    (line,) = _printed(benchmark_tts.main, argv + (["--quantize", quantize] if quantize else []))
    assert _jax_keys("benchmark_tts") <= set(line)
    assert line["quantize"] == quantize and line["avg_audio_s"] > 0 and line["rtf"] > 0
    assert line["int8_matmul_launches"] == 0  # the plain version on the CPU


@pytest.mark.parametrize("module,argv", [(benchmark_stt, []), (benchmark_tts, []), (mbw, []),
                                         (microbench_bscale, [])])
def test_tools_default_to_the_card(monkeypatch, module, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(argv)
