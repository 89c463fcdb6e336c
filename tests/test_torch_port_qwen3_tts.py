"""Parity: s2s_tpu_torch.models.qwen3_tts against the JAX Qwen3-TTS.

Weights come from the JAX ``init_params`` (``Qwen3TTSConfig.tiny``, f32) and
cross through ``s2s_tpu_torch.weights`` (which also converts the conv
layouts); inputs come from a numpy seed.  Audio agrees within
1e-4 * max|ref| (f32 sums in another order); codes are exact.  The int8
cases quantize the talker and code predictor on both sides (min_size=1, so
the tiny matrices are quantized too).  The transformers-generated fixture
``tests/data/qwen3tts_parity.npz`` is the second anchor for the vocoder.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import decoder_lm as jdl  # noqa: E402
from s2s_tpu.models import qwen3_tts as jq  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import decoder_lm as tdl  # noqa: E402
from s2s_tpu_torch.models import qwen3_tts as tq  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "qwen3tts_parity.npz")


def _close(ref, got, rel=1e-4):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jq.Qwen3TTSConfig.tiny(), tq.Qwen3TTSConfig.tiny()
    jp = jq.init_params(jax.random.PRNGKey(2), jcfg)
    return jcfg, jp, tcfg, weights.qwen3_tts_params(jp, "cpu")


def _models(tiny, quant):
    jcfg, jp, tcfg, tp = tiny
    if quant:
        jp = jq.quantize_params(jp, min_size=1)
        tp = tq.quantize_params(tp, min_size=1)
    return jcfg, jp, tcfg, tp


def test_code2wav_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    codes = np.random.default_rng(3).integers(0, jcfg.codebook_size, (1, jcfg.n_q, 9)).astype(np.int32)
    want = jq.jit_code2wav(jp["c2w"], jcfg.c2w, jnp.asarray(codes))
    got = tq.code2wav(tp["c2w"], tcfg.c2w, torch.from_numpy(codes))
    _close(want, got)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_cp_expand_frame_matches_jax(tiny, quant):
    jcfg, jp, tcfg, tp = _models(tiny, quant)
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((1, jcfg.lm.d_model)).astype(np.float32)
    code0 = np.array([rng.integers(0, jcfg.codebook_size)], np.int32)
    jcodes, jsum = jq._cp_expand_frame(jp, jcfg, jnp.asarray(hidden), jnp.asarray(code0))
    tcodes, tsum = tq._cp_expand_frame(tp, tcfg, torch.from_numpy(hidden), torch.from_numpy(code0))
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())
    _close(jsum, tsum)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_prefill_and_decode_chunk_audio_match_jax(tiny, quant):
    """Two streamed chunks after a talker prefill: codes (through the
    carried context), EOS flags and audio."""
    jcfg, jp, tcfg, tp = _models(tiny, quant)
    rng = np.random.default_rng(6)
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, :20] = rng.integers(1, jcfg.text_vocab, 20)
    jstate = jdl.init_decode_state(jcfg.lm, 1, max_t=64)
    tstate = tdl.init_decode_state(tcfg.lm, 1, max_t=64)
    jts = jq.jit_talker_prefill(jp, jcfg, jnp.asarray(tokens), jp["speakers"][:1], jstate)
    tts = tq.talker_prefill(tp, tcfg, torch.from_numpy(tokens), tp["speakers"][:1], tstate)
    _close(jts.next_embed, tts.next_embed)
    jctx = jnp.zeros((4, jcfg.n_q), jnp.int32)
    tctx = torch.zeros((4, tcfg.n_q), dtype=torch.int32)
    for n in (2, 3):
        jaudio, jeos, jts, jctx = jq.jit_decode_chunk_audio(jp, jcfg, jts, jctx, n)
        taudio, teos, tts, tctx = tq.decode_chunk_audio(tp, tcfg, tts, tctx, n)
        np.testing.assert_array_equal(np.asarray(jctx), tctx.numpy())
        np.testing.assert_array_equal(np.asarray(jeos), teos.numpy())
        _close(jaudio, taudio)
        assert tts.lm_state.pos == int(jts.lm_state.pos)


def test_stream_yields_chunks_matching_jax(tiny):
    """The host streaming loop (ramp chunks, EOS trim, sample counts)."""
    jcfg, jp, tcfg, tp = tiny
    jmodel = jq.Qwen3TTS(params=jp, cfg=jcfg, chunk_frames=3)
    tmodel = tq.Qwen3TTS(params=tp, cfg=tcfg, chunk_frames=3)
    want = list(jmodel.stream("Hello there.", max_new_tokens=8))
    got = list(tmodel.stream("Hello there.", max_new_tokens=8))
    assert [len(a) for a, _ in got] == [len(a) for a, _ in want]
    for (wa, wsr), (ga, gsr) in zip(want, got):
        assert gsr == wsr == tq.SAMPLE_RATE
        _close(wa, ga)


def test_code2wav_fixture_anchor():
    """Second anchor: transformers Qwen3OmniMoeCode2Wav, converted by the JAX
    converter and bridged, within the JAX test's 3e-4."""
    data = np.load(FIXTURE)
    sd = {k[len("sd__code2wav."):]: data[k] for k in data.files if k.startswith("sd__code2wav.")}
    kw = dict(codebook_size=64, num_quantizers=4, hidden=32, n_layers=1, n_heads=2, d_ff=64,
              sliding_window=8, upsampling_ratios=(2, 2), upsample_rates=(4, 3), decoder_dim=32)
    jparams = jq.convert_c2w_state_dict(sd, jq.Code2WavConfig(**kw, dtype=jnp.float32))
    tparams = weights.c2w_params(weights.tree_to_torch(jparams, "cpu"))
    wav = tq.code2wav(tparams, tq.Code2WavConfig(**kw, dtype=torch.float32),
                      torch.from_numpy(data["codes"].astype(np.int32)))
    np.testing.assert_allclose(wav.numpy(), data["wav"][:, 0, :], atol=3e-4)


def test_code_predictor_fixture_anchor():
    """Second anchor for the MTP code predictor: the fixture's 2-token prefill
    and greedy residual expansion, through the JAX converter and the bridge,
    reproduce the transformers logits (JAX test's 3e-4) and codes."""
    from s2s_tpu_torch.models.common import rms_norm

    data = np.load(FIXTURE)
    sd = {k[len("sd__"):]: data[k] for k in data.files if k.startswith("sd__")}
    kw = dict(vocab_size=1, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq_len=16,
              rope_theta=10000.0, rms_eps=1e-6, tie_embeddings=False, qk_norm=True, head_dim_override=16)
    jcfg = jdl.DecoderLMConfig(**kw, dtype=jnp.float32)
    tcfg = tdl.DecoderLMConfig(**kw, dtype=torch.float32)
    cp_sd = {"model." + k[len("talker.code_predictor.model."):]: v
             for k, v in sd.items() if k.startswith("talker.code_predictor.model.")}
    cp_sd["model.embed_tokens.weight"] = np.zeros((1, 32), np.float32)
    cp = weights.tree_to_torch(jdl.convert_hf_state_dict(cp_sd, jcfg), "cpu")
    heads = [torch.from_numpy(sd[f"talker.code_predictor.lm_head.{i}.weight"].T.copy()) for i in range(3)]
    embeds = [torch.from_numpy(sd[f"talker.code_predictor.model.codec_embedding.{i}.weight"]) for i in range(3)]
    state = tdl.init_decode_state(tcfg, 1, max_t=8)
    h, state = tdl._hidden_prefill(cp, tcfg, torch.from_numpy(data["cp_prompt"]), state, 2)
    h = rms_norm(h, cp["final_norm"], tcfg.rms_eps)
    logits_all, codes = [], []
    for step in range(3):
        logits = h @ heads[step]
        logits_all.append(logits.numpy())
        codes.append(int(logits.argmax(-1)[0]))
        if step < 2:
            x, state = tdl._hidden_step(cp, tcfg, embeds[step][[codes[-1]]][:, None, :], state)
            h = rms_norm(x[:, 0], cp["final_norm"], tcfg.rms_eps)
    np.testing.assert_allclose(np.concatenate(logits_all), data["cp_logits"], atol=3e-4)
    assert codes == list(data["cp_codes"])
