"""Parity: the port's Kokoro-82M against the JAX package, on the CPU.

The JAX package's ``init_params`` tree at ``KokoroConfig.test_tiny()`` is
carried across with ``weights.kokoro_params``; inputs are made from numpy
seeds.  Both sides are f32.  The tree's last generator conv (``post_w``) is
scaled by 0.1 on both sides, so that the random model's waveform has a
converted checkpoint's scale (|wav| under 1): unscaled, its exp head
reaches 2e6, where f32 rounding alone exceeds an absolute bound; one case
holds the unscaled tree's ``vocode`` within 1e-4 of max|ref|.

- The weight bridge: ``trans_conv_weight`` at groups 1, 2 and depthwise (the
  Kokoro pools' ``(K, 1, C)``) against the JAX ``_conv_transpose1d``; a
  BiLSTM tree as a ``torch.nn.LSTM``.
- Stage by stage: ``albert_forward`` with a padded row, ``_bilstm`` at a
  padded bucket (outputs past each length exactly zero, each row equal to
  its exact-length run), ``_cumsum`` bit-equal to ``jnp.cumsum`` (XLA's
  order on the CPU), the STFT features (the DC and Nyquist phase pinned to
  the JAX result), ``_istft``, the harmonic source, ``encode_text``,
  ``align`` (exact), ``vocode`` and ``KokoroTTS.synthesize``: durations
  equal, phase A within 1e-5 (the JAX package's own bound against its torch
  twin), the waveform within atol 2e-3 with a relative RMS under 1e-3 (its
  bound, ``tests/test_torch_parity.py``).
- ``tests/data/kokoro_parity.npz`` (the torch twin of the reference KModel)
  through the JAX converter ``kokoro.convert_state_dict``: ``pred_dur``
  exact, phase A within 1e-5 at the exact and a padded token bucket, the
  waveform within atol 2e-3 and relative RMS under 1e-3.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import kokoro as jk  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import kokoro as tk  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: phase A (durations' inputs, d, t_en): the JAX package's bound against its torch twin
PHASE_A_ATOL = 1e-5
#: the waveform: the JAX package's bounds against its torch twin
WAV_ATOL, WAV_REL_RMS = 2e-3, 1e-3

JCFG, TCFG = jk.KokoroConfig.test_tiny(), tk.KokoroConfig.test_tiny()


@pytest.fixture(scope="module")
def params():
    tree = jax.tree_util.tree_map(np.asarray, jk.init_params(jax.random.PRNGKey(0), JCFG))
    tree["decoder"]["generator"]["post_w"] = tree["decoder"]["generator"]["post_w"] * np.float32(0.1)
    return tree, weights.kokoro_params(tree, "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _wav_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=WAV_ATOL, rtol=0)
    rel_rms = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))
    assert rel_rms < WAV_REL_RMS, rel_rms


def _tokens(seed: int, lengths, bucket: int):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lengths), bucket), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(1, JCFG.n_token, n)
    return tokens


def _ref_s(seed: int, b: int = 1):
    return (np.random.default_rng(seed).standard_normal((b, 2 * JCFG.style_dim)) * 0.5).astype(np.float32)


# ── the weight bridge ────────────────────────────────────────────────


@pytest.mark.parametrize("channels,groups", [(6, 1), (6, 2), (6, 6)])
def test_trans_conv_weight_grouped_matches_the_jax_conv_transpose(channels, groups):
    rng = np.random.default_rng(groups)
    w = rng.standard_normal((3, channels // groups, channels)).astype(np.float32)  # pre-flipped (K, I/g, O)
    b = rng.standard_normal(channels).astype(np.float32)
    x = rng.standard_normal((2, 7, channels)).astype(np.float32)
    want = jk._conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2, kernel=3,
                                padding=1, output_padding=1, groups=groups)
    wt = weights.trans_conv_weight(_t(w), groups=groups)
    assert wt.shape == (channels, channels // groups, 3)
    got = tk._conv_transpose1d(_t(x), wt, _t(b), stride=2, padding=1, output_padding=1, groups=groups)
    _close(got.numpy(), want, 1e-5)


def test_trans_conv_weight_ungrouped_keeps_its_layout():
    w = np.random.default_rng(0).standard_normal((4, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(weights.trans_conv_weight(_t(w)).numpy(), w[::-1].transpose(1, 2, 0))


def test_kokoro_params_convert_the_layouts(params):
    tree, p = params
    pool = tree["predictor"]["F0"][1]["pool_w"]  # (3, 1, C) depthwise
    assert p["predictor"]["F0"][1]["pool_w"].shape == (pool.shape[2], 1, 3)
    conv = tree["text_encoder"]["cnn"][0]["conv_w"]
    np.testing.assert_array_equal(p["text_encoder"]["cnn"][0]["conv_w"].numpy(), conv.transpose(2, 1, 0))
    lstm = p["predictor"]["lstm"]
    assert isinstance(lstm, torch.nn.LSTM) and lstm.bidirectional and lstm.batch_first
    np.testing.assert_array_equal(lstm.weight_ih_l0_reverse.numpy(), tree["predictor"]["lstm"]["w_ih_b"].T)
    assert not lstm.bias_hh_l0.any() and not any(q.requires_grad for q in lstm.parameters())


# ── stage by stage ───────────────────────────────────────────────────


def test_albert_forward_matches_jax(params):
    tree, p = params
    tokens = _tokens(1, [12, 7], 12)
    mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.float32)
    want = jk.albert_forward(tree["bert"], JCFG.plbert, jnp.asarray(tokens), jnp.asarray(mask))
    got = tk.albert_forward(p["bert"], TCFG.plbert, _t(tokens).long(), _t(mask))
    _close(got.numpy(), want, PHASE_A_ATOL)


def test_bilstm_at_a_padded_bucket_matches_jax_and_each_exact_length(params):
    tree, p = params
    lengths = [12, 7, 1]
    i = tree["predictor"]["lstm"]["w_ih_f"].shape[0]
    x = np.random.default_rng(2).standard_normal((3, 12, i)).astype(np.float32)
    valid = np.arange(12)[None] < np.array(lengths)[:, None]
    want = jk._bilstm(tree["predictor"]["lstm"], jnp.asarray(x), jnp.asarray(valid))
    got = tk._bilstm(p["predictor"]["lstm"], _t(x), torch.tensor(lengths))
    _close(got.numpy(), want, PHASE_A_ATOL)
    assert not got[~_t(valid)].any()  # padded outputs are exact zeros
    for row, n in enumerate(lengths):  # the bucket does not change a row
        alone = tk._bilstm(p["predictor"]["lstm"], _t(x[row: row + 1, :n]), torch.tensor([n]))
        _close(got[row: row + 1, :n].numpy(), alone.numpy(), 1e-6)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 70, 300, 2048, 5000])
def test_cumsum_is_bit_equal_to_jnp_cumsum(n):
    x = np.random.default_rng(n).random((2, n, 9)).astype(np.float32) * 0.01
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(tk._cumsum(_t(x)).numpy(), want)


def test_stft_features_match_jax_and_pin_the_edge_phases():
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal((2, 400)) - 0.3).astype(np.float32)  # negative DC
    x[1] = -0.25  # a constant row: only the DC bin and its neighbour
    jm, jp = jk._stft_features(jnp.asarray(x), JCFG.gen_istft_n_fft, JCFG.gen_istft_hop)
    tm, tp = tk._stft_features(_t(x), TCFG.gen_istft_n_fft, TCFG.gen_istft_hop)
    _close(tm.numpy(), jm, 1e-5)
    _close(tp.numpy()[..., [0, -1]], np.asarray(jp)[..., [0, -1]], 0)
    np.testing.assert_array_equal(tp.numpy()[..., 0], np.float32(np.pi))
    strong = np.asarray(jm) > 1e-3  # elsewhere the phase of a near-zero bin is rounding noise
    _close(tp.numpy()[strong], np.asarray(jp)[strong], 1e-4)


def test_istft_matches_jax():
    rng = np.random.default_rng(4)
    mag = np.exp(rng.standard_normal((2, 40, 5))).astype(np.float32)
    phase = np.sin(rng.standard_normal((2, 40, 5))).astype(np.float32)
    want = jk._istft(jnp.asarray(mag), jnp.asarray(phase), 8, 2)
    got = tk._istft(_t(mag), _t(phase), 8, 2)
    _close(got.numpy(), want, 1e-5 * float(np.abs(np.asarray(want)).max()))


def test_sine_source_matches_jax(params):
    tree, p = params
    up = int(np.prod(JCFG.upsample_rates)) * JCFG.gen_istft_hop
    curve = np.concatenate([np.full(20, 5.0), 120 + 40 * np.sin(np.arange(44) / 5)]).astype(np.float32)
    f0 = np.repeat(curve[None, :, None], up, axis=1)
    want = jk._sine_source(tree["decoder"]["generator"]["source"], JCFG, jnp.asarray(f0))
    got = tk._sine_source(p["decoder"]["generator"]["source"], TCFG, _t(f0))
    _close(got.numpy(), want, 1e-5)


def _phase_a(tree, p, tokens, lengths, ref_s, speed=1.0):
    want = jk.encode_text(tree, JCFG, jnp.asarray(tokens), jnp.asarray(lengths, jnp.int32), jnp.asarray(ref_s),
                          jnp.asarray(speed))
    got = tk.encode_text(p, TCFG, _t(tokens).long(), torch.tensor(lengths), _t(ref_s), speed)
    return want, got


@pytest.mark.parametrize("speed", [1.0, 1.3])
def test_encode_text_matches_jax_and_the_padded_bucket(params, speed):
    tree, p = params
    ref_s = _ref_s(5, 2)
    tokens = _tokens(6, [16, 9], 16)
    (jdur, jd, jt), (dur, d, t_en) = _phase_a(tree, p, tokens, [16, 9], ref_s, speed)
    np.testing.assert_array_equal(dur.numpy(), np.asarray(jdur))
    _close(d.numpy(), jd, PHASE_A_ATOL)
    _close(t_en.numpy(), jt, PHASE_A_ATOL)
    # the second row alone at its exact length: the bucket changes nothing
    _, (dur9, d9, t9) = _phase_a(tree, p, tokens[1:, :9], [9], ref_s[1:], speed)
    np.testing.assert_array_equal(dur[1:, :9].numpy(), dur9.numpy())
    _close(d[1:, :9].numpy(), d9.numpy(), PHASE_A_ATOL)
    _close(t_en[1:, :9].numpy(), t9.numpy(), PHASE_A_ATOL)
    assert not dur[1, 9:].any()


def test_align_matches_jax_exactly():
    rng = np.random.default_rng(7)
    values = rng.standard_normal((2, 6, 5)).astype(np.float32)
    dur = np.array([[3, 1, 4, 1, 5, 0], [2, 2, 0, 0, 0, 0]], np.int32)
    for frames in (8, 20):
        want = jk.align(jnp.asarray(values), jnp.asarray(dur), frames)
        np.testing.assert_array_equal(tk.align(_t(values), _t(dur), frames).numpy(), np.asarray(want))


def test_vocode_matches_jax(params):
    tree, p = params
    rng = np.random.default_rng(8)
    en = rng.standard_normal((1, 32, JCFG.hidden_dim + JCFG.style_dim)).astype(np.float32)
    asr = rng.standard_normal((1, 32, JCFG.hidden_dim)).astype(np.float32)
    ref_s = _ref_s(9)
    want = jk.vocode(tree, JCFG, jnp.asarray(en), jnp.asarray(asr), jnp.asarray(ref_s))
    got = tk.vocode(p, TCFG, _t(en), _t(asr), _t(ref_s))
    assert got.shape == (1, 32 * TCFG.samples_per_frame)
    _wav_close(got.numpy(), want)


def test_vocode_at_unscaled_random_init_matches_jax_relatively():
    """The unscaled random tree, whose exp head reaches 2e6: within 1e-4 of max|ref|."""
    tree = jax.tree_util.tree_map(np.asarray, jk.init_params(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(10)
    en = rng.standard_normal((1, 32, JCFG.hidden_dim + JCFG.style_dim)).astype(np.float32)
    asr = rng.standard_normal((1, 32, JCFG.hidden_dim)).astype(np.float32)
    ref_s = _ref_s(11)
    want = np.asarray(jk.vocode(tree, JCFG, jnp.asarray(en), jnp.asarray(asr), jnp.asarray(ref_s)))
    got = tk.vocode(weights.kokoro_params(tree, "cpu"), TCFG, _t(en), _t(asr), _t(ref_s)).numpy()
    assert np.isfinite(want).all() and np.abs(want).max() > 1.0
    _close(got, want, 1e-4 * float(np.abs(want).max()))


def test_synthesize_matches_the_jax_wrapper(params):
    tree, p = params
    jtts = jk.KokoroTTS(params=tree, cfg=JCFG)
    ttts = tk.KokoroTTS(params=p, cfg=TCFG, device="cpu")
    for text, voice in (("Hello there.", 0), ("hi", 3)):
        want = jtts.synthesize(text, voice_id=voice)
        got = ttts.synthesize(text, voice_id=voice)
        assert got.dtype == np.float32
        _wav_close(got, want)
    chunks = list(ttts.stream("Hello there.", chunk_s=0.01))
    assert all(sr == tk.SAMPLE_RATE for _, sr in chunks)
    np.testing.assert_array_equal(np.concatenate([c for c, _ in chunks]), ttts.synthesize("Hello there."))


def test_voicepack_row_follows_the_input_length(params):
    _, p = params
    tts = tk.KokoroTTS(params=p, cfg=TCFG)
    pack = np.arange(5 * 2 * TCFG.style_dim, dtype=np.float32).reshape(5, -1)
    tts.add_voice("v", pack)
    np.testing.assert_array_equal(tts._ref_s("v", 2).numpy(), pack[1:2])
    np.testing.assert_array_equal(tts._ref_s("v", 99).numpy(), pack[4:5])
    np.testing.assert_array_equal(tts._ref_s(9, 3).numpy(), p["voices"][9 % 8][None].numpy())


# ── the repo's fixture through the JAX converter ─────────────────────


def test_kokoro_parity_fixture_through_the_jax_converter():
    data = np.load(os.path.join(ROOT, "tests/data/kokoro_parity.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files if k.startswith("sd__")}
    io = {k: data[k] for k in data.files if not k.startswith("sd__")}
    p = weights.kokoro_params(jk.convert_state_dict(sd, JCFG), "cpu")
    n = io["ids"].shape[1]
    ref_s = _t(io["ref_s"])

    def phase_a(bucket):
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n] = _t(io["ids"][0]).long()
        return tk.encode_text(p, TCFG, tokens, torch.tensor([n]), ref_s, 1.0)

    pred_dur, d, t_en = phase_a(n)
    np.testing.assert_array_equal(pred_dur[0].numpy(), io["pred_dur"])
    dur_p, d_p, t_en_p = phase_a(n + 5)
    np.testing.assert_array_equal(dur_p[0, :n].numpy(), pred_dur[0].numpy())
    _close(d_p[:, :n].numpy(), d.numpy(), PHASE_A_ATOL)
    _close(t_en_p[:, :n].numpy(), t_en.numpy(), PHASE_A_ATOL)

    total = int(np.sum(io["pred_dur"]))
    wav = tk.vocode(p, TCFG, tk.align(d, pred_dur, total), tk.align(t_en, pred_dur, total), ref_s)
    _wav_close(wav[0].numpy(), io["wav"].reshape(-1))
