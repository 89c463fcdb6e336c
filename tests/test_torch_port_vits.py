"""Parity: the port's MMS/VITS against the JAX package, on the CPU.

The JAX package's ``init_params`` tree at ``VitsConfig.test_tiny()`` is
carried across with ``weights.vits_params``; inputs are made from numpy
seeds; both sides are f32.

- The weight bridge's layouts.
- Stage by stage: the relative-position skews (exact), ``text_encode`` with
  a padded row, the inverted rational-quadratic spline (inside and outside
  its tails), ``duration_log`` deterministic and with noise,
  ``flow_reverse`` and ``hifigan`` within 1e-5; ``hifigan`` exactly zero
  past the frame mask.
- ``synthesize``, two lengths in one bucket, deterministic and with noise:
  ``n_samples`` equal, the waveform within 2e-4 (the JAX package's bound
  against transformers' ``VitsModel``), exact zeros past each length, and
  each row equal to its run alone; ``VitsTTS.synthesize`` with the JAX
  wrapper's noise draw (``np.random.RandomState(noise_seed)``) against the
  JAX wrapper.
- ``duration_log``, ``flow_reverse``, ``hifigan`` and ``synthesize`` also
  with the zero-initialized flow projections drawn from a seed
  (``chip_smoke.vits_flow_weights``), so the couplings' WN and the
  duration flows' DDS stacks reach the output.
- ``tests/data/vits_parity.npz`` (transformers' ``VitsModel``) through the
  JAX converter ``vits.convert_hf_state_dict``: two lengths in one bucket,
  ``n_samples`` exact, atol 2e-4, zeros past each length
  (``tests/test_torch_parity.py``'s bounds).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from chip_smoke import vits_flow_weights  # noqa: E402
from s2s_tpu.models import vits as jv  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import vits as tv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: stages; both sides f32
STAGE_ATOL = 1e-5
#: the waveform: the JAX package's bound against transformers' VitsModel
WAV_ATOL = 2e-4

JCFG, TCFG = jv.VitsConfig.test_tiny(), tv.VitsConfig.test_tiny()


@pytest.fixture(scope="module")
def params():
    tree = jax.tree_util.tree_map(np.asarray, jv.init_params(jax.random.PRNGKey(0), JCFG))
    return tree, weights.vits_params(tree, "cpu")


@pytest.fixture(scope="module", params=["init", "drawn_flows"])
def stage_params(request, params):
    """The init tree, and the same with its zero-initialized flow
    projections drawn (``chip_smoke.vits_flow_weights``)."""
    if request.param == "init":
        return params
    tree = jax.tree_util.tree_map(np.copy, params[0])
    vits_flow_weights(tree, np.random.RandomState(8))
    return tree, weights.vits_params(tree, "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _tokens(seed: int, lengths, bucket: int = JCFG.max_tokens):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lengths), bucket), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(1, JCFG.vocab_size, n)
    return tokens


def _mask(lengths, t):
    return (np.arange(t)[None] < np.array(lengths)[:, None]).astype(np.float32)


def test_vits_params_convert_the_layouts(params):
    tree, p = params
    dw = tree["dp"]["dds"][0]["dw_w"]  # (k, 1, C) depthwise
    np.testing.assert_array_equal(p["dp"]["dds"][0]["dw_w"].numpy(), dw.transpose(2, 1, 0))
    up = tree["dec"]["ups_w"][0]  # pre-flipped (k, in, out)
    np.testing.assert_array_equal(p["dec"]["ups_w"][0].numpy(), up[::-1].transpose(1, 2, 0))
    assert p["dec"]["post_w"].shape == (1, tree["dec"]["post_w"].shape[1], 7)


@pytest.mark.parametrize("length", [3, 5, 9])
def test_relative_skews_equal_jax(length):
    x = np.random.default_rng(length).standard_normal((4, length, 2 * length - 1)).astype(np.float32)
    np.testing.assert_array_equal(tv._rel_to_abs(_t(x)).numpy(), np.asarray(jv._rel_to_abs(jnp.asarray(x))))
    y = np.random.default_rng(length + 1).standard_normal((4, length, length)).astype(np.float32)
    np.testing.assert_array_equal(tv._abs_to_rel(_t(y)).numpy(), np.asarray(jv._abs_to_rel(jnp.asarray(y))))
    rel = np.random.default_rng(0).standard_normal((2 * JCFG.window + 1, 4)).astype(np.float32)
    np.testing.assert_array_equal(tv._rel_embeds(_t(rel), length, JCFG.window).numpy(),
                                  np.asarray(jv._rel_embeds(jnp.asarray(rel), length, JCFG.window)))


def test_text_encode_matches_jax(params):
    tree, p = params
    tokens, mask = _tokens(1, [20, 7]), _mask([20, 7], JCFG.max_tokens)
    want = jv.text_encode(tree, JCFG, jnp.asarray(tokens), jnp.asarray(mask))
    got = tv.text_encode(p, TCFG, _t(tokens).long(), _t(mask))
    for g, w in zip(got, want):
        _close(g.numpy(), w, STAGE_ATOL)


def test_rq_spline_reverse_matches_jax():
    rng = np.random.default_rng(2)
    shape = (3, 40)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, :4] = [-7.0, 7.0, -5.0, 5.0]  # outside the tails: identity; on them: the end knots
    uw, uh = (rng.standard_normal(shape + (JCFG.dp_bins,)).astype(np.float32) for _ in range(2))
    ud = rng.standard_normal(shape + (JCFG.dp_bins - 1,)).astype(np.float32)
    want = jv._rq_spline_reverse(jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud), JCFG.dp_tail)
    got = tv._rq_spline_reverse(_t(x), _t(uw), _t(uh), _t(ud), TCFG.dp_tail)
    _close(got.numpy(), want, STAGE_ATOL)
    np.testing.assert_array_equal(got.numpy()[0, :2], x[0, :2])


@pytest.mark.parametrize("noisy", [False, True])
def test_duration_log_matches_jax(stage_params, noisy):
    tree, p = stage_params
    rng = np.random.default_rng(3)
    mask = _mask([32, 11], JCFG.max_tokens)
    hidden = (rng.standard_normal((2, JCFG.max_tokens, JCFG.d_model)) * mask[..., None]).astype(np.float32)
    noise = (rng.standard_normal((2, JCFG.max_tokens, 2)) * 0.8).astype(np.float32) if noisy else None
    want = jv.duration_log(tree, JCFG, jnp.asarray(hidden), jnp.asarray(mask),
                           None if noise is None else jnp.asarray(noise))
    got = tv.duration_log(p, TCFG, _t(hidden), _t(mask), None if noise is None else _t(noise))
    _close(got.numpy(), want, STAGE_ATOL)


def test_flow_reverse_and_hifigan_match_jax(stage_params):
    tree, p = stage_params
    rng = np.random.default_rng(4)
    mask = _mask([64, 23], JCFG.max_frames)[..., None]
    lat = (rng.standard_normal((2, JCFG.max_frames, JCFG.flow_size)) * mask).astype(np.float32)
    want = jv.flow_reverse(tree, JCFG, jnp.asarray(lat), jnp.asarray(mask))
    got = tv.flow_reverse(p, TCFG, _t(lat), _t(mask))
    _close(got.numpy(), want, STAGE_ATOL)
    wav_want = jv.hifigan(tree, JCFG, jnp.asarray(lat), jnp.asarray(mask))
    wav = tv.hifigan(p, TCFG, _t(lat), _t(mask))
    _close(wav.numpy(), wav_want, STAGE_ATOL)
    assert not wav[1, 23 * TCFG.total_upsample:].any()


def _synth_both(tree, p, tokens, lengths, dur_noise=None, frame_noise=None, speed=1.0):
    jw, jn = jv.synthesize(tree, JCFG, jnp.asarray(tokens), jnp.asarray(lengths, jnp.int32), jnp.asarray(speed),
                           None if dur_noise is None else jnp.asarray(dur_noise),
                           None if frame_noise is None else jnp.asarray(frame_noise))
    tw, tn = tv.synthesize(p, TCFG, _t(tokens).long(), torch.tensor(lengths), speed,
                           None if dur_noise is None else _t(dur_noise),
                           None if frame_noise is None else _t(frame_noise))
    return (np.asarray(jw), np.asarray(jn)), (tw.numpy(), tn.numpy())


@pytest.mark.parametrize("noisy", [False, True])
def test_synthesize_two_lengths_in_one_bucket_matches_jax(stage_params, noisy):
    tree, p = stage_params
    lengths = [24, 9]
    tokens = _tokens(5, lengths)
    rng = np.random.RandomState(6)
    dur_noise = frame_noise = None
    if noisy:
        dur_noise = rng.randn(2, JCFG.max_tokens, 2).astype(np.float32) * 0.8
        frame_noise = rng.randn(2, JCFG.max_frames, JCFG.flow_size).astype(np.float32) * 0.667
    (jw, jn), (wav, n) = _synth_both(tree, p, tokens, lengths, dur_noise, frame_noise)
    np.testing.assert_array_equal(n, jn)
    _close(wav, jw, WAV_ATOL)
    for row in range(2):
        assert not wav[row, n[row]:].any()  # exact zeros past each length
    # the second row alone gives the same samples: the bucket changes nothing
    (_, _), (alone, n_alone) = _synth_both(
        tree, p, tokens[1:], lengths[1:],
        None if dur_noise is None else dur_noise[1:], None if frame_noise is None else frame_noise[1:])
    assert n_alone[0] == n[1]
    _close(alone[0], wav[1], 1e-6)


def test_vits_tts_draws_the_jax_wrappers_noise(params):
    tree, p = params
    jtts, ttts = jv.VitsTTS(params=tree, cfg=JCFG), tv.VitsTTS(params=p, cfg=TCFG, device="cpu")
    for kwargs in ({}, {"noise_scale": 0.667, "noise_scale_duration": 0.8, "noise_seed": 7}):
        want = jtts.synthesize("Hello there.", speed=1.2, **kwargs)
        got = ttts.synthesize("Hello there.", speed=1.2, **kwargs)
        assert got.shape == want.shape and got.dtype == np.float32
        _close(got, want, WAV_ATOL)
    chunks = list(ttts.stream("Hello there.", chunk_s=0.01))
    assert all(sr == tv.SAMPLE_RATE for _, sr in chunks)
    np.testing.assert_array_equal(np.concatenate([c for c, _ in chunks]), ttts.synthesize("Hello there."))


def test_vits_tokenizer_matches_reference_behavior():
    vocab = {c: i for i, c in enumerate("_abcdefghijklmnopqrstuvwxyz ", start=0)}
    ids = tv.VitsTokenizer(vocab).encode("Hello, World!")
    assert ids == jv.VitsTokenizer(vocab).encode("Hello, World!")
    chars = "hello world"
    want = [0] * (2 * len(chars) + 1)
    want[1::2] = [vocab[c] for c in chars]
    assert ids == want


def test_vits_parity_fixture_through_the_jax_converter():
    data = np.load(os.path.join(ROOT, "tests/data/vits_parity.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files if k.startswith("sd__")}
    io = {k: data[k] for k in data.files if not k.startswith("sd__")}
    p = weights.vits_params(jv.convert_hf_state_dict(sd, JCFG), "cpu")
    lens = [io["ids_a"].shape[1], io["ids_b"].shape[1]]
    tokens = torch.zeros((2, TCFG.max_tokens), dtype=torch.long)
    tokens[0, : lens[0]] = _t(io["ids_a"][0]).long()
    tokens[1, : lens[1]] = _t(io["ids_b"][0]).long()
    wav, n_samples = tv.synthesize(p, TCFG, tokens, torch.tensor(lens), 1.0)
    wav, n_samples = wav.numpy(), n_samples.numpy()
    assert n_samples[0] == int(io["len_a"][0]) and n_samples[1] == int(io["len_b"][0])
    _close(wav[0, : n_samples[0]], io["wav_a"][0], WAV_ATOL)
    _close(wav[1, : n_samples[1]], io["wav_b"][0], WAV_ATOL)
    for row in range(2):
        assert not wav[row, n_samples[row]:].any()
