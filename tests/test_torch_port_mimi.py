"""Parity: the port's Mimi decoder against the JAX package, on the CPU.

Both sides are f32, at ``MimiConfig.tiny()``; inputs are made from numpy
seeds, and trees are carried across with ``weights.mimi_params``.

- The weight bridge and each conv helper alone against the JAX function:
  ``_causal_conv`` (dilations 1 and 2), ``_causal_trans_conv`` (the
  converter's pre-flipped ``(K, I, O)`` kernel through
  ``weights.trans_conv_weight``, with and without a bias) and the depthwise
  ``_upsample``, each within 1e-6.
- ``dequantize`` and ``_transformer`` (half-split rope, the sliding window)
  within 1e-6; ``decode`` from an ``init_decoder_params`` tree within 1e-6
  of max|ref| (the random decoder's output is about 3e-4).
- ``tests/data/mimi_parity.npz`` (the moshi-layout torch twin) through the
  JAX converter ``mimi.convert_state_dict``: within 2e-6 of the fixture, the
  JAX package's own bound (``tests/test_pocket_tts.py``);
  ``mimi_hf_parity.npz`` (``transformers.MimiModel``) through
  ``convert_hf_state_dict``: within 2e-4, its bound.
- ``streaming_decode`` with ``decode_deficit`` frames of context equals
  ``decode`` within 1e-5 (the JAX package's bound for the same check).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import mimi as jm  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import mimi as tm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: one helper alone against the JAX function (f32 on both sides)
HELPER_ATOL = 1e-6
#: the fixtures: the JAX package's own bounds against the torch twin and transformers
TWIN_ATOL, HF_ATOL = 2e-6, 2e-4
#: streamed against one-shot: the JAX package's bound
STREAM_ATOL = 1e-5

JCFG, TCFG = jm.MimiConfig.tiny(), tm.MimiConfig.tiny()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _sd(name):
    fx = np.load(os.path.join(ROOT, "tests", "data", name))
    return fx, {k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}


@pytest.fixture(scope="module")
def params():
    tree = jax.tree_util.tree_map(np.asarray, jm.init_decoder_params(jax.random.PRNGKey(0), JCFG))
    return tree, weights.mimi_params(tree, "cpu")


def _codes(seed: int, b: int, t: int):
    return np.random.default_rng(seed).integers(0, JCFG.codebook_size, (b, t, JCFG.n_q)).astype(np.int32)


# ── the conv helpers alone ──────────────────────────────────────────


@pytest.mark.parametrize("dilation", [1, 2])
def test_causal_conv_matches_jax(dilation):
    rng = np.random.default_rng(dilation)
    p = {"w": rng.standard_normal((5, 6, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)}
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    want = jm._causal_conv(jnp.asarray(x), jax.tree.map(jnp.asarray, p), dilation=dilation)
    got = tm._causal_conv(_t(x), {"w": weights.conv_weight(_t(p["w"])), "b": _t(p["b"])}, dilation=dilation)
    _close(got.numpy(), want, HELPER_ATOL)


@pytest.mark.parametrize("stride,bias", [(2, True), (3, False), (4, True)])
def test_causal_trans_conv_through_trans_conv_weight_matches_jax(stride, bias):
    """The converter's kernel is torch's flipped to (K, I, O); JAX runs
    ``conv_transpose`` with ``transpose_kernel=False``: ``trans_conv_weight``
    gives ConvTranspose1d's (I, O, K), and the right-trim keeps T*stride."""
    rng = np.random.default_rng(stride)
    p = {"w": rng.standard_normal((2 * stride, 6, 3)).astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(3).astype(np.float32)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    want = jm._causal_trans_conv(jnp.asarray(x), jax.tree.map(jnp.asarray, p), stride)
    tp = {k: _t(v) for k, v in p.items()}
    tp["w"] = weights.trans_conv_weight(tp["w"])
    got = tm._causal_trans_conv(_t(x), tp, stride)
    assert got.shape == (2, 7 * stride, 3)
    _close(got.numpy(), want, HELPER_ATOL)


@pytest.mark.parametrize("stride", [2, 3])
def test_depthwise_upsample_matches_jax(stride):
    rng = np.random.default_rng(10 + stride)
    w = rng.standard_normal((2 * stride, 5)).astype(np.float32)  # (K, C)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    want = jm._upsample(jnp.asarray(x), jnp.asarray(w), stride)
    tree = weights.mimi_params({"upsample": {"w": w}, "init_conv": {"w": np.zeros((1, 1, 1), np.float32)},
                                "blocks": [], "final_conv": {"w": np.zeros((1, 1, 1), np.float32)}}, "cpu")
    assert tree["upsample"]["w"].shape == (5, 1, 2 * stride)
    got = tm._upsample(_t(x), tree["upsample"]["w"], stride)
    _close(got.numpy(), want, HELPER_ATOL)


def test_mimi_params_convert_the_layouts(params):
    tree, p = params
    np.testing.assert_array_equal(p["init_conv"]["w"].numpy(), tree["init_conv"]["w"].transpose(2, 1, 0))
    up = tree["blocks"][0]["up"]["w"]  # pre-flipped (K, I, O)
    np.testing.assert_array_equal(p["blocks"][0]["up"]["w"].numpy(), up[::-1].transpose(1, 2, 0))
    np.testing.assert_array_equal(p["tlayers"][1]["wq"].numpy(), tree["tlayers"][1]["wq"])


# ── the stages and the whole decoder ─────────────────────────────────


def test_dequantize_matches_jax(params):
    tree, p = params
    codes = _codes(1, 2, 9)
    want = jm.dequantize(tree, JCFG, jnp.asarray(codes))
    _close(tm.dequantize(p, TCFG, _t(codes)).numpy(), want, HELPER_ATOL)


def test_transformer_matches_jax_past_its_window(params):
    tree, p = params
    t = JCFG.t_context * 2 + 3  # longer than the sliding window
    x = np.random.default_rng(2).standard_normal((2, t, JCFG.dim)).astype(np.float32)
    want = jm._transformer(tree, JCFG, jnp.asarray(x))
    _close(tm._transformer(p, TCFG, _t(x)).numpy(), want, HELPER_ATOL)


@pytest.mark.parametrize("frames", [1, 7, 40])
def test_decode_matches_jax(params, frames):
    tree, p = params
    codes = _codes(frames, 2, frames)
    want = np.asarray(jm.decode(tree, JCFG, jnp.asarray(codes)))
    got = tm.decode(p, TCFG, _t(codes)).numpy()
    assert got.shape == (2, frames * TCFG.hop)
    _close(got, want, 1e-6 * np.abs(want).max())


def test_init_decoder_params_draws_the_jax_tree():
    p = tm.init_decoder_params(TCFG, torch.Generator().manual_seed(0))
    ref = weights.mimi_params(jax.tree_util.tree_map(np.asarray, jm.init_decoder_params(jax.random.PRNGKey(0), JCFG)),
                              "cpu")
    flat = dict(jax.tree_util.tree_leaves_with_path(p))
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    assert tm.decode(p, TCFG, _t(_codes(3, 1, 5))).shape == (1, 5 * TCFG.hop)


# ── the fixtures through the JAX converters ──────────────────────────


def test_twin_fixture_through_the_jax_converter():
    fx, sd = _sd("mimi_parity.npz")
    p = weights.mimi_params(jm.convert_state_dict(sd, JCFG), "cpu")
    _close(tm.decode(p, TCFG, _t(fx["codes"])).numpy(), fx["wav"], TWIN_ATOL)


def test_transformers_fixture_through_the_jax_hf_converter():
    fx, sd = _sd("mimi_hf_parity.npz")
    p = weights.mimi_params(jm.convert_hf_state_dict(sd, JCFG), "cpu")
    codes = fx["codes"].transpose(0, 2, 1)  # HF (B, n_q, T) -> (B, T, n_q)
    _close(tm.decode(p, TCFG, _t(codes)).numpy(), fx["wav"], HF_ATOL)


@pytest.mark.parametrize("context", ["deficit", 8])
def test_streaming_decode_matches_decode_and_jax(params, context):
    tree, p = params
    codes = _codes(4, 2, 45)
    ctx = tm.decode_deficit(TCFG) if context == "deficit" else context
    stream = tm.streaming_decode(p, TCFG, codes, context_frames=ctx)
    want = np.asarray(jm.streaming_decode(tree, JCFG, codes, context_frames=ctx))
    _close(stream, want, 1e-6 * np.abs(want).max())
    if context == "deficit":
        assert tm.decode_deficit(TCFG) == jm.decode_deficit(JCFG)
        _close(stream, tm.decode(p, TCFG, _t(codes)).numpy(), STREAM_ATOL)


def test_full_width_config_and_deficit_match_jax():
    cfg, ref = tm.MimiConfig(), jm.MimiConfig()
    assert (cfg.hop, cfg.head_dim, tm.decode_deficit(cfg)) == (ref.hop, ref.head_dim, jm.decode_deficit(ref))
    assert tm.MimiConfig.mimi_24khz() == cfg and tm.decode_deficit(cfg) == 252
