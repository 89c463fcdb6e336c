"""Parity: the port's Whisper, Smart Turn and voice-clone speaker against the
JAX package, on the CPU.

- JAX ``init_params`` trees carried across with ``weights.whisper_to_torch``:
  ``encode`` within 1e-4 * max|ref| in f32 (sum order differs), at head dim
  16 (plain attention on both sides) and 64 (the port's flash route, its
  plain version here); greedy tokens of ``greedy_decode_device`` and
  ``greedy_decode`` exactly equal.
- The served precision: ``encode`` with bf16 weights (the dtype of every
  Whisper size and of Smart Turn) at the ragged 50 and 400 positions, within
  4 bf16 ulps of max|ref| and a mean |d| under half an ulp. The JAX package
  serves these shapes through its plain attention, which rounds p to bf16
  before PV; the port's flash route (head dim 64) keeps p in f32, as the
  Pallas kernel does. At head dim 16 both sides take the plain attention.
- ``tests/data/whisper_parity.npz`` (transformers' Whisper) through the JAX
  converter: the encoder within 2e-4 and the teacher-forced logits within
  3e-3 with equal argmax, the JAX package's own bounds against that golden.
- The STT stage: the port's ``WhisperSTTHandler`` against the JAX handler on
  the same f32 weights (the ``tiny`` size patched to a small f32 config in
  both packages): the same text and language, detected and given.
- Smart Turn: the analyzer's probability on 8 s of audio within 1e-5 of the
  JAX analyzer's on the same tree (with its head).
- ``speaker_from_reference`` within 1e-4 * max|ref| of the JAX function.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import qwen3_tts as jax_qwen3  # noqa: E402
from s2s_tpu.models import whisper as jw  # noqa: E402
from s2s_tpu.vad import smart_turn as jax_smart_turn  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import qwen3_tts  # noqa: E402
from s2s_tpu_torch.models import whisper as tw  # noqa: E402
from s2s_tpu_torch.vad import smart_turn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (d_model, n_heads): head dim 16 (plain attention) and 64 (the flash route)
WIDTHS = [(64, 4), (128, 2)]


def _configs(d_model: int, n_heads: int, **extra):
    jcfg = dataclasses.replace(jw.WhisperConfig.test_tiny(), d_model=d_model, n_heads=n_heads, **extra)
    tcfg = dataclasses.replace(tw.WhisperConfig.test_tiny(), d_model=d_model, n_heads=n_heads, **extra)
    return jcfg, tcfg


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("d_model,n_heads", WIDTHS)
def test_encode_and_greedy_tokens_match_jax(d_model, n_heads):
    jcfg, tcfg = _configs(d_model, n_heads)
    jp = jw.init_params(jax.random.PRNGKey(d_model), jcfg)
    tp = weights.whisper_to_torch(jp, "cpu")
    mel = np.random.default_rng(1).standard_normal((1, 80, 128)).astype(np.float32)
    want = jw.encode(jp, jcfg, jnp.asarray(mel))
    got = tw.encode(tp, tcfg, torch.from_numpy(mel))
    _close(got, want, 1e-4)

    prompt = [1, 2, 3]
    buf, n = jw.jit_greedy_decode_device(jp, jcfg, want, jnp.asarray([prompt], jnp.int32), 16, 0)
    want_tokens = [int(t) for t in np.asarray(buf[: int(n)])]
    tbuf, tn = tw.greedy_decode_device(tp, tcfg, got, torch.tensor([prompt], dtype=torch.int32), 16, 0)
    assert want_tokens and tbuf[:tn].tolist() == want_tokens
    assert tbuf[tn:].tolist() == [0] * (16 - tn)  # padded with the EOT id
    assert tw.greedy_decode(tp, tcfg, got, prompt, max_new=16, eot=0) == want_tokens


@pytest.mark.parametrize("positions", [50, 400])
@pytest.mark.parametrize("d_model,n_heads", WIDTHS)
def test_bf16_encode_matches_jax(d_model, n_heads, positions):
    jcfg, tcfg = _configs(d_model, n_heads, n_audio_ctx=400)
    jcfg, tcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16), dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jp = jw.init_params(jax.random.PRNGKey(5), jcfg)
    tp = weights.whisper_to_torch(jp, "cpu")
    assert tp["enc_blocks"]["attn"]["wq"].dtype == torch.bfloat16
    mel = np.random.default_rng(positions).standard_normal((1, 80, 2 * positions)).astype(np.float32)
    want = np.asarray(jw.encode(jp, jcfg, jnp.asarray(mel)).astype(jnp.float32))
    got = tw.encode(tp, tcfg, torch.from_numpy(mel))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (1, positions, d_model)
    diff = np.abs(got.float().numpy() - want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)  # one bf16 ulp at max|ref|
    assert diff.max() <= 4 * ulp and diff.mean() <= 0.5 * ulp, (diff.max(), diff.mean(), ulp)


def test_whisper_golden_through_the_jax_converter():
    data = np.load(os.path.join(ROOT, "tests", "data", "whisper_parity.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files if k.startswith("sd__")}
    jcfg, tcfg = _configs(64, 4)
    params = weights.whisper_to_torch(jw.convert_hf_state_dict(sd, jcfg), "cpu")
    enc = tw.encode(params, tcfg, torch.from_numpy(data["mel"]))
    np.testing.assert_allclose(enc.numpy(), data["enc_out"], atol=2e-4)
    state = tw.init_decode_state(params, tcfg, enc)
    logits, state = tw.decode_tokens(params, tcfg, torch.from_numpy(data["tokens"].astype(np.int32)), state)
    np.testing.assert_allclose(logits.numpy(), data["logits"], atol=3e-3)
    assert np.array_equal(logits.numpy().argmax(-1), data["logits"].argmax(-1))
    assert state.pos == data["tokens"].shape[1]


def _handler(cls, **setup):
    import threading
    from queue import Queue

    return cls(threading.Event(), Queue(), Queue(), setup_kwargs=setup)


def test_stt_handler_transcribes_like_the_jax_handler(monkeypatch):
    from s2s_tpu.stt.whisper_handler import WhisperSTTHandler as JaxWhisper
    from s2s_tpu_torch.stt.whisper_handler import WhisperSTTHandler

    small = dict(n_audio_ctx=1500, n_enc_layers=1, n_dec_layers=1, vocab_size=51866, n_text_ctx=448)
    jcfg, tcfg = _configs(128, 2, **small)
    monkeypatch.setattr(jw.WhisperConfig, "tiny", staticmethod(lambda: jcfg))
    monkeypatch.setattr(tw.WhisperConfig, "tiny", staticmethod(lambda: tcfg))
    jp = jw.init_params(jax.random.PRNGKey(3), jcfg)
    audio = (0.2 * np.random.default_rng(4).standard_normal(21_000)).astype(np.float32)
    for language in (None, "de"):
        common = dict(model_size="tiny", language=language, warmup=False, max_new_tokens=24)
        want = _handler(JaxWhisper, params=jp, **common).transcribe_fn(audio)
        got = _handler(WhisperSTTHandler, params=weights.whisper_to_torch(jp, "cpu"), device="cpu",
                       **common).transcribe_fn(audio)
        assert want.text and got.text == want.text
        assert got.language_code == want.language_code and got.sentences == want.sentences


@pytest.mark.parametrize("d_model,n_heads", WIDTHS)
def test_smart_turn_probability_matches_jax(d_model, n_heads):
    jcfg, tcfg = _configs(d_model, n_heads, n_audio_ctx=400)
    rng = np.random.default_rng(d_model)
    tree = jax.tree_util.tree_map(np.asarray, jw.init_params(jax.random.PRNGKey(7), jcfg))
    tree["head"] = {"w": (rng.standard_normal((d_model, 1)) * 0.3).astype(np.float32),
                    "b": np.asarray([0.1], np.float32)}
    t = np.arange(6 * 16_000) / 16_000
    audio = (0.1 * rng.standard_normal(t.size) + 0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    np.testing.assert_array_equal(smart_turn.prepare_audio(audio), jax_smart_turn.prepare_audio(audio))
    want = jax_smart_turn.SmartTurnAnalyzer(encoder_params=tree, config=jcfg).predict(audio)
    got = smart_turn.SmartTurnAnalyzer(encoder_params=tree, config=tcfg, device="cpu").predict(audio)
    assert abs(got.probability - want.probability) <= 1e-5
    assert got.complete == want.complete


def test_smart_turn_random_init_and_encoder_only_checkpoint():
    _, tcfg = _configs(128, 2, n_audio_ctx=400)
    audio = (0.1 * np.random.default_rng(9).standard_normal(20_000)).astype(np.float32)
    random = smart_turn.SmartTurnAnalyzer(config=tcfg, device="cpu", threshold=0.2).predict(audio)
    assert 0.0 < random.probability < 1.0 and random.complete == (random.probability > 0.2)
    jcfg, _ = _configs(128, 2, n_audio_ctx=400)
    enc = jax.tree_util.tree_map(np.asarray, jw.init_params(jax.random.PRNGKey(1), jcfg))
    headless = smart_turn.SmartTurnAnalyzer(encoder_params=enc, config=tcfg, device="cpu").predict(audio)
    assert 0.0 < headless.probability < 1.0
    scripted = smart_turn.SmartTurnAnalyzer(predict_fn=lambda a: 0.9).predict(audio)
    assert scripted.complete and scripted.probability == 0.9


def test_speaker_from_reference_matches_jax():
    rng = np.random.default_rng(11)
    spk_proj = (rng.standard_normal((80, 96)) * 80 ** -0.5).astype(np.float32)
    audio = (0.2 * rng.standard_normal(24_000)).astype(np.float32)
    want = np.asarray(jax_qwen3.speaker_from_reference({"spk_proj": jnp.asarray(spk_proj)}, audio))
    got = qwen3_tts.speaker_from_reference({"spk_proj": torch.from_numpy(spk_proj)}, audio)
    assert got.dtype == torch.float32
    _close(got, want, 1e-4)
