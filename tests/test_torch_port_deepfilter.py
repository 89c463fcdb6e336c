"""Parity: the port's DeepFilter enhancer against the JAX package, on the CPU
(f32 and complex64 on both sides).

- ``tests/data/deepfilter_parity.npz`` (the DFN-layout torch twin) through
  the JAX converter: ``filter_frames`` within the JAX package's bound of the
  twin's frames and within ``REL`` x max|JAX| of the JAX package's scan of
  ``frame_step``, and its final state within the same of JAX's.
- A run split anywhere gives the frames of the whole run (the state carries
  every recurrence and every convolution's previous frame).
- ``enhance`` at ``DeepFilterConfig.tiny()`` and at ``DeepFilterConfig()``
  within ``REL`` x max|JAX| of the JAX package from an ``init_params`` tree
  carried across with ``weights.deepfilter_params``; above ``df_bins``
  only the gains apply, so no bin grows there.
- ``DeepFilterEnhancer``: the same length and the JAX enhancer's samples
  (within ``REL``) at lengths inside, at and past the duration buckets;
  empty input comes back empty.
- The VAD handler applies the enhancer to each final segment, and the
  builder's ``_build_enhancer`` loads a converted checkpoint through the
  model cache (none without one).
- ``init_params`` draws the JAX package's tree.
- ``tests/data/deepfilter_parity_converted.npz`` (what ``chip_smoke.py``
  loads) equals the JAX converter's output on the fixture; ``python
  tests/test_torch_port_deepfilter.py`` writes it.
"""

import os
import threading
from queue import Queue

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import deepfilter as jd  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import deepfilter as td  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: relative to max|JAX|: frames, states and waveforms
REL = 1e-5
#: the JAX package's bound against the twin (``tests/test_deepfilter.py``)
TWIN_ATOL = 2e-5
CONFIGS = {"tiny": (jd.DeepFilterConfig.tiny(), td.DeepFilterConfig.tiny()),
           "default": (jd.DeepFilterConfig(), td.DeepFilterConfig())}
CONVERTED = os.path.join(ROOT, "tests", "data", "deepfilter_parity_converted.npz")


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, atol=REL * float(np.abs(want).max()), rtol=0, err_msg=what)


def _fixture():
    fx = np.load(os.path.join(ROOT, "tests", "data", "deepfilter_parity.npz"))
    return fx, {k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}


def _jax_scan(tree, cfg, spec):
    p = jax.tree.map(jnp.asarray, tree)

    def body(st, frame):
        y, st = jd.frame_step(p, cfg, frame, st)
        return st, y

    state, out = jax.lax.scan(body, jd.init_state(cfg), jnp.asarray(spec))
    return np.asarray(out), jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def twin():
    fx, sd = _fixture()
    jcfg, tcfg = CONFIGS["tiny"]
    tree = jd.convert_state_dict(sd, jcfg)
    spec = (fx["spec_re"] + 1j * fx["spec_im"]).astype(np.complex64)
    return fx, tree, weights.deepfilter_params(tree, "cpu"), spec


def test_fixture_frames_and_state_match_the_twin_and_jax(twin):
    fx, tree, p, spec = twin
    cfg = CONFIGS["tiny"][1]
    y, state = td.filter_frames(p, cfg, torch.from_numpy(spec), td.init_state(cfg))
    np.testing.assert_allclose(y.numpy(), fx["out_re"] + 1j * fx["out_im"], atol=TWIN_ATOL)
    want, want_state = _jax_scan(tree, CONFIGS["tiny"][0], spec)
    _close(y.numpy(), want, "frames")
    for name in td.DFState._fields:
        _close(getattr(state, name).numpy(), getattr(want_state, name), name)


@pytest.mark.parametrize("splits", [[1], [5], [2, 3, 9], list(range(1, 12))])
def test_a_split_run_gives_the_frames_of_the_whole(twin, splits):
    _, _, p, spec = twin
    cfg = CONFIGS["tiny"][1]
    spec = torch.from_numpy(spec)
    whole, whole_state = td.filter_frames(p, cfg, spec, td.init_state(cfg))
    state, parts = td.init_state(cfg), []
    for lo, hi in zip([0, *splits], [*splits, spec.shape[0]]):
        y, state = td.filter_frames(p, cfg, spec[lo:hi], state)
        parts.append(y)
    _close(torch.cat(parts).numpy(), whole.numpy())
    _close(state.gru_h.numpy(), whole_state.gru_h.numpy())


def _trees(name, key=0):
    jcfg, _ = CONFIGS[name]
    tree = jax.tree_util.tree_map(np.asarray, jd.init_params(jax.random.PRNGKey(key), jcfg))
    return tree, weights.deepfilter_params(tree, "cpu")


@pytest.mark.parametrize("name,n", [("tiny", 3_777), ("tiny", 16_000), ("default", 4_960), ("default", 16_000)])
def test_enhance_matches_jax(name, n):
    jcfg, tcfg = CONFIGS[name]
    tree, p = _trees(name)
    x = np.random.default_rng(n).normal(0, 0.1, n).astype(np.float32)
    want = np.asarray(jd.enhance(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x)))
    got = td.enhance(p, tcfg, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    _close(got, want)


def test_gains_bound_the_high_bins():
    """Above df_bins only sigmoid gains apply: |Y| <= |X| there."""
    _, p = _trees("default", key=1)
    cfg = CONFIGS["default"][1]
    rng = np.random.default_rng(2)
    spec = torch.from_numpy((rng.standard_normal((7, cfg.n_bins))
                             + 1j * rng.standard_normal((7, cfg.n_bins))).astype(np.complex64))
    y, _ = td.filter_frames(p, cfg, spec, td.init_state(cfg))
    assert torch.all(torch.abs(y[:, cfg.df_bins:]) <= torch.abs(spec[:, cfg.df_bins:]) + 1e-6)


@pytest.mark.parametrize("n", [1_000, 15_999, 16_000, 16_001, 480_000 + 37])
def test_enhancer_keeps_the_length_and_the_jax_samples(n):
    jcfg, tcfg = CONFIGS["tiny"]
    tree, p = _trees("tiny", key=2)
    x = np.random.default_rng(n).normal(0, 0.1, n).astype(np.float32)
    got = td.DeepFilterEnhancer(params=p, cfg=tcfg)(x)
    want = jd.DeepFilterEnhancer(params=tree, cfg=jcfg)(x)
    assert got.shape == x.shape and got.dtype == np.float32 and np.isfinite(got).all()
    _close(got, want)


def test_empty_input_passthrough():
    e = td.DeepFilterEnhancer(cfg=CONFIGS["tiny"][1])
    assert len(e(np.zeros(0, np.float32))) == 0


def test_vad_handler_applies_the_enhancer_to_final_audio():
    from s2s_tpu_torch.pipeline.messages import VADAudio
    from s2s_tpu_torch.pipeline.turns import SpeculativeTurnTracker
    from s2s_tpu_torch.vad.handler import VADHandler

    enhancer = td.DeepFilterEnhancer(cfg=CONFIGS["tiny"][1])
    seen = []

    def counted(audio):
        out = enhancer(audio)
        seen.append(out)
        return out

    class EnergyVAD:
        def __call__(self, chunk, sr=16000):
            return 0.95 if float(np.abs(chunk).mean()) > 0.01 else 0.02

        def reset_states(self):
            pass

    h = VADHandler(threading.Event(), Queue(), Queue(), setup_kwargs=dict(
        should_listen=threading.Event(), speculative_turns=SpeculativeTurnTracker(), model=EnergyVAD(),
        smart_turn=False, enhancer=counted, min_speech_ms=64, min_silence_ms=64,
        enable_realtime_transcription=False))
    h.should_listen.set()
    tone = (0.5 * np.sin(2 * np.pi * 300 * np.arange(512) / 16000)).astype(np.float32)
    outs = []
    for chunk in [tone] * 12 + [np.zeros(512, np.float32)] * 12:
        outs.extend(h.process((chunk * 32767).astype(np.int16).tobytes()))
    finals = [o for o in outs if isinstance(o, VADAudio) and o.mode == "final"]
    assert finals and len(seen) == len(finals)
    assert all(np.isfinite(a).all() and a.size > 0 for a in seen)


def test_builder_loads_a_converted_checkpoint_through_the_cache(tmp_path):
    from s2s_tpu_torch.arguments import parse_arguments
    from s2s_tpu_torch.builder import _build_enhancer
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE
    from scripts.convert_checkpoint import flatten

    assert _build_enhancer(parse_arguments([]), torch.device("cpu")) is None
    tree, _ = _trees("default", key=3)
    path = tmp_path / "deepfilter.npz"
    np.savez(path, **flatten(tree))
    args = parse_arguments(["--vad_enhancer_checkpoint", str(path)])
    try:
        built = _build_enhancer(args, torch.device("cpu"))
        assert _build_enhancer(args, torch.device("cpu")) is built
        x = np.random.default_rng(3).normal(0, 0.1, 8_000).astype(np.float32)
        _close(built(x), jd.DeepFilterEnhancer(params=tree)(x))
    finally:
        GLOBAL_MODEL_CACHE.clear()


def test_init_params_draws_the_jax_tree():
    _, tcfg = CONFIGS["default"]
    p = td.init_params(tcfg, torch.Generator().manual_seed(0))
    _, ref = _trees("default")
    shapes = {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype) for k, v in jax.tree_util.tree_leaves_with_path(p)}
    assert shapes == {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype)
                      for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    np.testing.assert_array_equal(p["erb_fb"].numpy(), jd.erb_filterbank(CONFIGS["default"][0]))


def converted_fixture() -> dict[str, np.ndarray]:
    """The twin through the JAX converter (tiny config), flattened as a
    converted checkpoint under ``tree/``, beside the fixture's frames under
    ``fx/``."""
    from scripts.convert_checkpoint import flatten

    fx, sd = _fixture()
    out = flatten({"tree": jax.tree_util.tree_map(np.asarray, jd.convert_state_dict(sd, CONFIGS["tiny"][0]))})
    out.update({f"fx/{k}": fx[k] for k in ("spec_re", "spec_im", "out_re", "out_im")})
    return out


def test_converted_fixture_file_is_the_jax_converters_output():
    stored, want = np.load(CONVERTED), converted_fixture()
    assert sorted(stored.files) == sorted(want)
    for key, value in want.items():
        assert stored[key].dtype == value.dtype, key
        np.testing.assert_array_equal(stored[key], value, err_msg=key)


if __name__ == "__main__":
    np.savez(CONVERTED, **converted_fixture())
