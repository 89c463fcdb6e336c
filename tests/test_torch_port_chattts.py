"""Parity: the port's ChatTTS and iSTFT against the JAX package, on the CPU.

Both sides are f32, at ``ChatTTSConfig.tiny()``; trees are carried across
with ``weights.chattts_params``; inputs are made from numpy seeds.  Greedy
codes are compared token for token.

- ``istft`` against the JAX ``istft`` at four ``n_fft``/``hop`` pairs
  (16/4, 20/5, 64/16, 1024/256) with a batch of two, within 1e-6 of
  max|ref|; against ``torch.istft`` within rtol/atol 1e-4 (the bound of
  ``tests/test_tts.py::test_istft_matches_torch_istft``); ``overlap_add``
  against a plain loop and the JAX ``overlap_add``.
- ``tests/data/chattts_parity.npz`` (the GPT.pt / Decoder.pt / Vocos.pt
  torch twin) through the JAX converter ``chattts.convert_state_dict``: the
  GPT's 10 frames of codes equal the fixture's with and without the speaker;
  the DVAE's mel within 1e-5 (the JAX package's bound); Vocos's head
  spectrum against the fixture's within 1e-5.
- ``gfsq_dequantize`` within 1e-6 of JAX at random codes and at the two
  extreme codes (negatives of each other); ``_causal_pad_conv`` (dense and
  depthwise) within 1e-6.
- From an ``init_params`` tree (the Vocos head scaled by 50, as
  ``tests/test_chattts.py`` does, so the audio is not trimmed as silence):
  prefill + AR codes and EOS equal to JAX with a speaker, without one and
  with two rows; ``dvae_decode`` and ``vocos_decode`` within 1e-5 of
  max|ref|; ``ChatTTSModel.synthesize`` with an explicit speaker: the same
  length and the waveform within 1e-5 of max|ref|; ``stream`` equal to
  ``synthesize``; an EOS found early gives JAX's length.
- The speaker draw: a ``torch.Generator`` seed gives a speaker that differs
  from the JAX package's ``jax.random`` draw (the deliberate difference) and
  is the same on every call.
- A converted checkpoint ``.npz`` served through the registry's
  ``--tts chatTTS`` factory on the CPU.
- ``tests/data/chattts_parity_converted.npz`` (what ``chip_smoke.py``
  loads, as it imports nothing of the JAX package) equals the JAX
  converter's output on the fixture; ``python tests/test_torch_port_chattts.py``
  writes it.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import chattts as jc  # noqa: E402
from s2s_tpu.models import decoder_lm as jd  # noqa: E402
from s2s_tpu.ops import istft as jistft  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import chattts as tc  # noqa: E402
from s2s_tpu_torch.models import decoder_lm as td  # noqa: E402
from s2s_tpu_torch.ops import istft as tistft  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 on both sides, relative to the reference's peak
REL = 1e-6
#: the DVAE mel against the twin: the JAX package's bound
MEL_ATOL = 1e-5
#: a whole waveform through the exp head (|audio| in the thousands), relative to its peak
WAV_REL = 1e-5
#: against torch.istft: the JAX package's bound for its own op
TORCH_ISTFT_TOL = 1e-4

JCFG, TCFG = jc.ChatTTSConfig.tiny(), tc.ChatTTSConfig.tiny()


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


CONVERTED = os.path.join(ROOT, "tests", "data", "chattts_parity_converted.npz")


def converted_fixture() -> dict[str, np.ndarray]:
    """``chattts_parity.npz`` through the JAX converter, flattened as a
    converted checkpoint under ``tree/``, beside the fixture's inputs and
    outputs under ``fx/``."""
    from scripts.convert_checkpoint import flatten

    fx = np.load(os.path.join(ROOT, "tests", "data", "chattts_parity.npz"))
    sd = {k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}
    out = flatten({"tree": jax.tree_util.tree_map(np.asarray, jc.convert_state_dict(sd, JCFG))})
    out.update({f"fx/{k}": fx[k] for k in ("text", "spk", "codes", "codes_nospk", "mel", "spec")})
    return out


@pytest.fixture(scope="module")
def fixture():
    fx = np.load(os.path.join(ROOT, "tests", "data", "chattts_parity.npz"))
    sd = {k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}
    return fx, weights.chattts_params(jc.convert_state_dict(sd, JCFG), "cpu")


@pytest.fixture(scope="module")
def params():
    tree = jax.tree_util.tree_map(np.asarray, jc.init_params(jax.random.PRNGKey(0), JCFG))
    tree["vocos"]["head"]["w"] = tree["vocos"]["head"]["w"] * np.float32(50.0)
    return tree, weights.chattts_params(tree, "cpu")


def _speaker(seed: int):
    return np.random.default_rng(seed).standard_normal(JCFG.gpt.d_model).astype(np.float32)


def _port_codes(p, text, spk, n):
    state = td.init_decode_state(TCFG.gpt, text.shape[0], max_t=64)
    cstate, codes0, eos0 = tc.prefill(p, TCFG, _t(text), None if spk is None else _t(spk), state)
    rest, eos, _ = tc.generate_codes(p, TCFG, cstate, n - 1)
    return torch.cat([codes0[None], rest]).numpy(), torch.cat([eos0[None], eos]).numpy()


def _jax_codes(tree, text, spk, n):
    p = jax.tree.map(jnp.asarray, tree)
    state = jd.init_decode_state(JCFG.gpt, text.shape[0], max_t=64)
    cstate, codes0, eos0 = jc.prefill(p, JCFG, jnp.asarray(text), None if spk is None else jnp.asarray(spk), state)
    rest, eos, _ = jc.generate_codes(p, JCFG, cstate, n - 1)
    return (np.concatenate([np.asarray(codes0)[None], np.asarray(rest)]),
            np.concatenate([np.asarray(eos0)[None], np.asarray(eos)]))


# ── the iSTFT ────────────────────────────────────────────────────────


@pytest.mark.parametrize("n_fft,hop", [(16, 4), (20, 5), (64, 16), (1024, 256)])
def test_istft_matches_jax(n_fft, hop):
    rng = np.random.default_rng(n_fft)
    mag = rng.uniform(0.1, 1.0, (2, 30, n_fft // 2 + 1)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    want = np.stack([np.asarray(jistft.istft(jnp.asarray(m), jnp.asarray(p), n_fft, hop)) for m, p in zip(mag, phase)])
    got = tistft.istft(_t(mag), _t(phase), n_fft, hop).numpy()
    assert got.shape == (2, 29 * hop)
    _close(got, want, REL * np.abs(want).max())


def test_istft_matches_torch_istft():
    n_fft, hop, t_frames = 64, 16, 24
    rng = np.random.default_rng(0)
    mag = rng.uniform(0.1, 1.0, (t_frames, n_fft // 2 + 1)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (t_frames, n_fft // 2 + 1)).astype(np.float32)
    ours = tistft.istft(_t(mag), _t(phase), n_fft, hop).numpy()
    spec = torch.complex(_t(mag * np.cos(phase)), _t(mag * np.sin(phase))).transpose(0, 1)
    ref = torch.istft(spec, n_fft, hop_length=hop, window=torch.hann_window(n_fft, periodic=True),
                      center=True, length=(t_frames - 1) * hop).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=TORCH_ISTFT_TOL, atol=TORCH_ISTFT_TOL)


def test_overlap_add_matches_a_plain_loop():
    frames = np.random.default_rng(1).standard_normal((3, 7, 12)).astype(np.float32)
    want = np.zeros((3, 6 * 5 + 12), np.float32)
    for t in range(7):
        want[:, t * 5: t * 5 + 12] += frames[:, t]
    _close(tistft.overlap_add(_t(frames), 5).numpy(), want, 1e-6)
    want_jax = np.asarray(jistft.overlap_add(jnp.asarray(frames[1]), 5))  # one row: (T, n_fft) in JAX
    _close(tistft.overlap_add(_t(frames[1]), 5).numpy(), want_jax, 1e-6)


# ── the fixture through the JAX converter ────────────────────────────


@pytest.mark.parametrize("with_speaker", [True, False])
def test_gpt_codes_equal_the_fixture(fixture, with_speaker):
    fx, p = fixture
    codes, _ = _port_codes(p, fx["text"], fx["spk"] if with_speaker else None, 10)
    np.testing.assert_array_equal(codes, fx["codes" if with_speaker else "codes_nospk"])


def test_dvae_mel_and_vocos_spectrum_match_the_fixture(fixture):
    fx, p = fixture
    mel = tc.dvae_decode(p["dvae"], TCFG.dvae, _t(fx["codes"]).transpose(0, 1))
    _close(mel.numpy(), fx["mel"], MEL_ATOL)
    vc = p["vocos"]
    x = tc._causal_pad_conv(mel.transpose(1, 2), vc["embed"])
    x = tc.layer_norm(x, vc["norm_w"], vc["norm_b"])
    for lp in vc["layers"]:
        x = tc._convnext(x, lp)
    x = tc.layer_norm(x, vc["final_ln_w"], vc["final_ln_b"])
    spec = tc.linear(x, vc["head"]["w"], vc["head"]["b"])
    _close(spec.numpy(), fx["spec"], MEL_ATOL)


def test_gfsq_dequantize_matches_jax_and_its_extremes_are_negatives(fixture):
    fx, p = fixture
    dv = TCFG.dvae
    codes = np.random.default_rng(2).integers(0, dv.codebook_size, (2, 9, dv.num_vq)).astype(np.int32)
    tree = jc.convert_state_dict({k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}, JCFG)
    want = jc.gfsq_dequantize(jax.tree.map(jnp.asarray, tree["dvae"]), JCFG.dvae, jnp.asarray(codes))
    _close(tc.gfsq_dequantize(p["dvae"], dv, _t(codes)).numpy(), want, 1e-6)
    lo = tc.gfsq_dequantize(p["dvae"], dv, torch.zeros((1, 1, dv.num_vq), dtype=torch.long))
    hi = tc.gfsq_dequantize(p["dvae"], dv, torch.full((1, 1, dv.num_vq), dv.codebook_size - 1))
    _close(lo.numpy(), -hi.numpy(), 1e-6)


@pytest.mark.parametrize("depthwise", [False, True])
def test_same_padded_conv_matches_jax(depthwise):
    rng = np.random.default_rng(int(depthwise))
    c, k = 6, 7
    w = rng.standard_normal((k, 1 if depthwise else c, c)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    x = rng.standard_normal((2, 13, c)).astype(np.float32)
    want = jc._causal_pad_conv(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    got = tc._causal_pad_conv(_t(x), {"w": weights.conv_weight(_t(w)), "b": _t(b)})
    _close(got.numpy(), want, 1e-6)


# ── against JAX from init_params ─────────────────────────────────────


@pytest.mark.parametrize("case", ["speaker", "no_speaker", "two_rows"])
def test_prefill_and_ar_codes_equal_jax(params, case):
    tree, p = params
    rng = np.random.default_rng(3)
    text = rng.integers(6, JCFG.text_vocab, (2 if case == "two_rows" else 1, 9))
    text[:, 0] = JCFG.spk_emb_token
    if case == "two_rows":
        text[1, 6:] = 0  # a shorter row, right-padded
    spk = None if case == "no_speaker" else _speaker(4)
    got, got_eos = _port_codes(p, text, spk, 12)
    want, want_eos = _jax_codes(tree, text, spk, 12)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_eos, want_eos)


def test_dvae_and_vocos_match_jax(params):
    tree, p = params
    codes = np.random.default_rng(5).integers(0, TCFG.dvae.codebook_size, (2, 11, 4)).astype(np.int32)
    jtree = jax.tree.map(jnp.asarray, tree)
    want_mel = np.asarray(jc.dvae_decode(jtree["dvae"], JCFG.dvae, jnp.asarray(codes)))
    mel = tc.dvae_decode(p["dvae"], TCFG.dvae, _t(codes))
    _close(mel.numpy(), want_mel, MEL_ATOL * np.abs(want_mel).max())
    want = np.asarray(jc.vocos_decode(jtree["vocos"], JCFG.vocos, jnp.asarray(want_mel)))
    got = tc.vocos_decode(p["vocos"], TCFG.vocos, _t(want_mel)).numpy()
    _close(got, want, WAV_REL * np.abs(want).max())


@pytest.mark.parametrize("text,max_tokens", [("Hello there.", None),
                                             ("A longer sentence, with a clause or two in it.", 24)])
def test_synthesize_with_an_explicit_speaker_matches_jax(params, text, max_tokens):
    tree, p = params
    spk = _speaker(6)
    want = jc.ChatTTSModel(params=tree, cfg=JCFG).synthesize(text, speaker=jnp.asarray(spk), max_tokens=max_tokens)
    port = tc.ChatTTSModel(params=p, cfg=TCFG)
    got = port.synthesize(text, speaker=spk, max_tokens=max_tokens)
    assert got.dtype == np.float32 and got.shape == want.shape and got.size > 0
    _close(got, want, WAV_REL * np.abs(want).max())
    if max_tokens is None:  # stream synthesizes at the text's own budget
        np.testing.assert_array_equal(np.concatenate([a for a, _ in port.stream(text, speaker=spk)]), got)


@pytest.mark.parametrize("max_tokens", [1, 3])
def test_a_short_budget_matches_jax(params, max_tokens):
    """One token leaves the AR loop empty: the prefill's frame alone."""
    tree, p = params
    spk = _speaker(8)
    want = jc.ChatTTSModel(params=tree, cfg=JCFG).synthesize("Hi.", speaker=jnp.asarray(spk), max_tokens=max_tokens)
    got = tc.ChatTTSModel(params=p, cfg=TCFG).synthesize("Hi.", speaker=spk, max_tokens=max_tokens)
    assert got.shape == want.shape
    _close(got, want, WAV_REL * max(np.abs(want).max(), 1.0))


def test_an_early_eos_gives_the_jax_length(params):
    tree, p = params
    tree = jax.tree_util.tree_map(lambda x: x, tree)
    tree["head_code"] = tree["head_code"].copy()
    tree["head_code"][2, :, JCFG.audio_eos_id] *= 3.0  # EOS at frame 5 (10 unscaled)
    spk = _speaker(7)
    budget = 24
    want = jc.ChatTTSModel(params=tree, cfg=JCFG).synthesize("Hello there, friend.", speaker=jnp.asarray(spk),
                                                            max_tokens=budget)
    port = tc.ChatTTSModel(params=weights.chattts_params(tree, "cpu"), cfg=TCFG)
    got = port.synthesize("Hello there, friend.", speaker=spk, max_tokens=budget)
    full = budget * TCFG.dvae.frames_per_token * TCFG.vocos.hop
    assert got.shape == want.shape and got.size < full - TCFG.vocos.hop
    _close(got, want, WAV_REL * max(np.abs(want).max(), 1.0))


def test_speaker_draw_is_seeded_and_differs_from_jax(params):
    tree, p = params
    a = tc.sample_speaker(p, torch.Generator().manual_seed(3))
    assert torch.equal(a, tc.sample_speaker(p, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, tc.sample_speaker(p, torch.Generator().manual_seed(4)))
    ref = np.asarray(jc.sample_speaker(jax.tree.map(jnp.asarray, tree), jax.random.PRNGKey(3)))
    assert a.shape == ref.shape and not np.allclose(a.numpy(), ref)
    model = tc.ChatTTSModel(params=p, cfg=TCFG)
    seeded = model.synthesize("Same text.", seed=0, max_tokens=16)
    np.testing.assert_array_equal(seeded, model.synthesize("Same text.", max_tokens=16, speaker=tc.sample_speaker(
        p, torch.Generator().manual_seed(0))))
    assert not np.array_equal(seeded, model.synthesize("Same text.", seed=1, max_tokens=16))


def test_config_from_params_and_init_params_match_jax(params):
    tree, p = params
    cfg, ref = tc.config_from_params(p), jc.config_from_params(tree)
    assert (cfg.gpt.d_model, cfg.gpt.n_layers, cfg.gpt.n_heads, cfg.gpt.rope_theta, cfg.gpt.max_seq_len) == \
        (ref.gpt.d_model, ref.gpt.n_layers, ref.gpt.n_heads, ref.gpt.rope_theta, ref.gpt.max_seq_len)
    assert cfg.dvae.__dict__ == ref.dvae.__dict__ and cfg.vocos.__dict__ == ref.vocos.__dict__
    drawn = tc.init_params(TCFG, torch.Generator().manual_seed(0))
    def shapes(tree):  # the heads' f32 copies, made at first use, left out
        return {jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_leaves_with_path(tree)
                if "_f32" not in jax.tree_util.keystr(k)}

    assert shapes(drawn) == shapes(p)


def test_registry_serves_a_converted_checkpoint(tmp_path, fixture):
    import threading
    from queue import Queue

    from s2s_tpu_torch.arguments import parse_arguments
    from s2s_tpu_torch.registry import HandlerContext, ModelCache, get_backend
    from scripts.convert_checkpoint import flatten

    fx, _ = fixture
    sd = {k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}
    tree = jc.convert_state_dict(sd, JCFG)
    ckpt = tmp_path / "chattts_tiny.npz"
    np.savez(ckpt, **flatten(jax.tree_util.tree_map(np.asarray, tree)))
    args = parse_arguments(["serve", "--tts", "chatTTS", "--tts_checkpoint", str(ckpt), "--tts_seed", "3"])
    ctx = HandlerContext(stop_event=threading.Event(), queue_in=Queue(), queue_out=Queue(),
                         text_output_queue=Queue(), should_listen=threading.Event(), cancel_scope=None,
                         speculative_turns=None, device_scheduler=None, model_cache=ModelCache())
    handler = get_backend("tts", "chatTTS").create_handler(args.tts_config, ctx)
    p = handler.model.params
    np.testing.assert_array_equal(p["vocos"]["embed"]["w"].numpy(), tree["vocos"]["embed"]["w"].transpose(2, 1, 0))
    assert handler.model.cfg.dvae.__dict__ == TCFG.dvae.__dict__ and handler._speaker.shape == (32,)
    codes, _ = _port_codes(p, fx["text"], fx["spk"], 10)
    np.testing.assert_array_equal(codes, fx["codes"])


def test_converted_fixture_file_is_the_jax_converters_output():
    stored, want = np.load(CONVERTED), converted_fixture()
    assert sorted(stored.files) == sorted(want)
    for key, value in want.items():
        assert stored[key].dtype == value.dtype, key
        np.testing.assert_array_equal(stored[key], value, err_msg=key)


if __name__ == "__main__":
    np.savez(CONVERTED, **converted_fixture())
