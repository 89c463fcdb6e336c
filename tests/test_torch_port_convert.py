"""The port's checkpoint converters and its conversion tool against the JAX
package's, on the CPU.  Tolerance is bit-equality throughout: keys, dtype,
shape and bytes.

- Every case of ``chip_smoke.convert_cases`` (each family's fixture at its
  tiny config, and bf16 configs of the decoder LM, Whisper, Qwen3-TTS and
  Parakeet): the port's converter, flattened by the tool, gives the JAX
  converter's arrays, flattened by ``scripts/convert_checkpoint.py``, and
  those arrays are the ones ``tests/data/converted_digests.json`` records
  (``python tests/test_torch_port_convert.py`` rewrites it; the card's
  ``convert_parity`` phase reads it).
- Each converted tree through the port's weight loader and forward, against
  the JAX forward on the JAX-converted tree, with each model's tolerance in
  its own parity test.
- A bf16 ``.npz`` written as the JAX script writes it loads into the port
  bit-equal (it failed before the port read ``|V2`` leaves as bf16 bits).
- The tool's safetensors reader against ``safetensors.torch.load_file``, its
  writer read back by ``safetensors``.
- The tool's CLI against ``scripts/convert_checkpoint.py``'s, in
  subprocesses, for the families whose published configs are small.
- The card's HF-layout generators (``chip_smoke.hf_decoder_lm_state_dict``,
  ``hf_whisper_state_dict``, ``smart_turn_state_dict``) at tiny configs,
  through both packages' converters from the files the card writes.
- A tiny CPU serve from a tool-converted LM checkpoint under
  ``--llm_quantize int8`` answers a text turn with the LM quantized.
"""

import asyncio
import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import test_torch_port_chattts as chattts_tests  # noqa: E402
import test_torch_port_deepfilter as deepfilter_tests  # noqa: E402
import test_torch_port_kokoro as kokoro_tests  # noqa: E402
import test_torch_port_paraformer as paraformer_tests  # noqa: E402
import test_torch_port_pocket as pocket_tests  # noqa: E402
import test_torch_port_vits as vits_tests  # noqa: E402
from scripts import convert_checkpoint as jax_script  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.tools import convert_checkpoint as cc  # noqa: E402

DIGESTS = os.path.join(ROOT, cs.CONVERTED_DIGESTS)
CASES = cs.convert_cases()


def _jax_converters() -> dict:
    """The JAX converter of each case in ``chip_smoke.convert_cases``, at the
    same config."""
    from s2s_tpu.models import chattts, decoder_lm, deepfilter, kokoro, mimi, paraformer, parakeet, pocket_tts
    from s2s_tpu.models import qwen3_tts, silero_vad, vision, vits, whisper
    from s2s_tpu.vad import smart_turn

    f32, bf16 = jnp.float32, jnp.bfloat16

    def lm(fields, dtype):
        return decoder_lm.DecoderLMConfig(**fields, dtype=dtype)

    def tts(dtype):
        return qwen3_tts.Qwen3TTSConfig(**cs.TTS_FIELDS, lm=lm(cs.TTS_LM_FIELDS, dtype), cp=lm(cs.TTS_CP_FIELDS, dtype),
                                        c2w=qwen3_tts.Code2WavConfig(**cs.C2W_FIELDS, dtype=dtype), dtype=dtype)

    def whisper_tiny(dtype):
        return dataclasses.replace(whisper.WhisperConfig.test_tiny(), dtype=dtype)

    out = {}
    for suffix, dt in (("", f32), ("-bf16", bf16)):
        out.update({
            f"llama{suffix}": lambda sd, dt=dt: decoder_lm.convert_hf_state_dict(sd, lm(cs.LLAMA_FIELDS, dt)),
            f"whisper{suffix}": lambda sd, dt=dt: whisper.convert_hf_state_dict(sd, whisper_tiny(dt)),
            f"qwen3-tts{suffix}": lambda sd, dt=dt: qwen3_tts.convert_state_dict(sd, tts(dt)),
            f"parakeet{suffix}": lambda sd, dt=dt: parakeet.convert_state_dict(
                sd, parakeet.ParakeetConfig(**cs.PARAKEET_FIELDS, dtype=dt)),
        })
    out.update({
        "qwen3": lambda sd: decoder_lm.convert_hf_state_dict(sd, lm(cs.QWEN3_FIELDS, f32)),
        "smart-turn": lambda sd: smart_turn.convert_state_dict(sd, whisper_tiny(f32)),
        "silero-vad": silero_vad.convert_silero_state_dict,
        "paraformer": lambda sd: paraformer.convert_state_dict(sd, paraformer.ParaformerConfig.test_tiny()),
        "smolvlm-vision": lambda sd: vision.convert_hf_state_dict(sd, vision.VisionConfig.test_tiny()),
        "mms-vits": lambda sd: vits.convert_hf_state_dict(sd, vits.VitsConfig.test_tiny()),
        "kokoro": lambda sd: kokoro.convert_state_dict(sd, kokoro.KokoroConfig.test_tiny()),
        "mimi": lambda sd: mimi.convert_state_dict(sd, mimi.MimiConfig.tiny()),
        "mimi-hf": lambda sd: mimi.convert_hf_state_dict(sd, mimi.MimiConfig.tiny()),
        "pocket-tts": lambda sd: pocket_tts.convert_state_dict(sd, pocket_tts.PocketTTSConfig.tiny()),
        "chattts": lambda sd: chattts.convert_state_dict(sd, chattts.ChatTTSConfig.tiny()),
        "deepfilter": lambda sd: deepfilter.convert_state_dict(sd, deepfilter.DeepFilterConfig.tiny()),
    })
    return out


JAX_CONVERTERS = _jax_converters()


def stored(flat: dict) -> dict[str, np.ndarray]:
    """The JAX script's flattened arrays as its ``.npz`` gives them back: a
    bf16 leaf as the ``|V2`` view of its bits."""
    return {k: v.view(np.dtype("V2")) if v.dtype.name == "bfloat16" else v for k, v in flat.items()}


@functools.lru_cache(maxsize=None)
def jax_converted(name: str):
    """(the JAX converter's tree as numpy arrays, its flattened arrays)."""
    tree = jax.tree_util.tree_map(np.asarray, JAX_CONVERTERS[name](CASES[name][0]()))
    return tree, stored(jax_script.flatten(tree))


@functools.lru_cache(maxsize=None)
def port_converted(name: str):
    make, convert = CASES[name]
    return convert(make(), "cpu")


def assert_same_arrays(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for key in want:
        a, b = got[key], want[key]
        assert (a.dtype.str, a.shape) == (b.dtype.str, b.shape), (key, a.dtype, a.shape, b.dtype, b.shape)
        assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes(), key


# ── the converters against JAX ───────────────────────────────────────


def test_every_jax_converter_has_a_case_and_every_family_reaches_one():
    assert sorted(JAX_CONVERTERS) == sorted(CASES)
    assert len(cc.FAMILIES) == 22
    src = open(os.path.join(ROOT, "scripts", "convert_checkpoint.py")).read()
    assert all(f'"{family}"' in src for family in cc.FAMILIES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_converter_gives_the_jax_converters_arrays(name):
    tree = port_converted(name)
    assert all(isinstance(leaf, torch.Tensor) for leaf in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert_same_arrays(cc.flatten(tree), jax_converted(name)[1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_digests_file_records_the_jax_converters_arrays(name):
    with open(DIGESTS) as f:
        digests = json.load(f)
    assert sorted(digests) == sorted(CASES)
    assert digests[name] == cs.array_digests(jax_converted(name)[1])


def test_converters_take_tensors_and_bf16_sources_unchanged():
    """A state dict of tensors, and one of bf16 tensors, convert as its numpy
    arrays (the bf16 ones widened exactly)."""
    make, convert = CASES["whisper-bf16"]
    sd = make()
    want = cc.flatten(convert(sd, "cpu"))
    assert_same_arrays(cc.flatten(convert({k: torch.from_numpy(v) for k, v in sd.items()}, "cpu")), want)
    sd16 = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    got = cc.flatten(convert(sd16, "cpu"))
    from s2s_tpu.models import whisper

    jcfg = dataclasses.replace(whisper.WhisperConfig.test_tiny(), dtype=jnp.bfloat16)
    bits = {k: v.view(torch.int16).numpy().view(ml_dtypes.bfloat16) for k, v in sd16.items()}
    assert_same_arrays(got, stored(jax_script.flatten(jax.tree_util.tree_map(
        np.asarray, whisper.convert_hf_state_dict(bits, jcfg)))))


# ── the converted trees through the port's forward ───────────────────


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _decoder_lm(name, fields):
    from s2s_tpu.models import decoder_lm as jdl
    from s2s_tpu_torch.models import decoder_lm as tdl

    tokens = np.random.default_rng(0).integers(0, fields["vocab_size"], (2, 12)).astype(np.int32)
    jtree, _ = jax_converted(name)
    want = jdl.forward(jax.tree.map(jnp.asarray, jtree), jdl.DecoderLMConfig(**fields, dtype=jnp.float32),
                       jnp.asarray(tokens))
    got = tdl.forward(weights.tree_to_torch(port_converted(name), "cpu"),
                      tdl.DecoderLMConfig(**fields, dtype=torch.float32), _t(tokens).long())
    _close(got.numpy(), want, 1e-4)


def _whisper():
    from s2s_tpu.models import whisper as jw
    from s2s_tpu_torch.models import whisper as tw

    data = np.load(os.path.join(ROOT, "tests", "data", "whisper_parity.npz"))
    jcfg, tcfg = jw.WhisperConfig.test_tiny(), tw.WhisperConfig.test_tiny()
    jtree = jax.tree.map(jnp.asarray, jax_converted("whisper")[0])
    p = weights.whisper_to_torch(port_converted("whisper"), "cpu")
    want = jw.encode(jtree, jcfg, jnp.asarray(data["mel"]))
    got = tw.encode(p, tcfg, _t(data["mel"]))
    _close(got.numpy(), want, 1e-4)
    tokens = data["tokens"].astype(np.int32)
    jlogits, _ = jw.decode_tokens(jtree, jcfg, jnp.asarray(tokens), jw.init_decode_state(jtree, jcfg, want))
    logits, _ = tw.decode_tokens(p, tcfg, _t(tokens), tw.init_decode_state(p, tcfg, got))
    _close(logits.numpy(), jlogits, 1e-4)
    assert np.array_equal(logits.numpy().argmax(-1), np.asarray(jlogits).argmax(-1))


def _smart_turn():
    from s2s_tpu.models import whisper as jw
    from s2s_tpu_torch.models import whisper as tw

    mel = np.load(os.path.join(ROOT, "tests", "data", "whisper_parity.npz"))["mel"]
    jtree = jax.tree.map(jnp.asarray, jax_converted("smart-turn")[0])
    p = weights.whisper_to_torch(port_converted("smart-turn"), "cpu")
    jpooled = np.asarray(jw.encode(jtree, jw.WhisperConfig.test_tiny(), jnp.asarray(mel))).mean(axis=1)
    pooled = tw.encode(p, tw.WhisperConfig.test_tiny(), _t(mel)).numpy().mean(axis=1)
    want = 1.0 / (1.0 + np.exp(-(jpooled @ np.asarray(jtree["head"]["w"]) + np.asarray(jtree["head"]["b"]))))
    got = 1.0 / (1.0 + np.exp(-(pooled @ p["head"]["w"].numpy() + p["head"]["b"].numpy())))
    np.testing.assert_allclose(got, want, atol=1e-4)


def _qwen3_tts():
    from s2s_tpu.models import decoder_lm as jdl
    from s2s_tpu.models import qwen3_tts as jq
    from s2s_tpu_torch.models import decoder_lm as tdl
    from s2s_tpu_torch.models import qwen3_tts as tq

    jcfg = jq.Qwen3TTSConfig(**cs.TTS_FIELDS, lm=jdl.DecoderLMConfig(**cs.TTS_LM_FIELDS, dtype=jnp.float32),
                             cp=jdl.DecoderLMConfig(**cs.TTS_CP_FIELDS, dtype=jnp.float32),
                             c2w=jq.Code2WavConfig(**cs.C2W_FIELDS, dtype=jnp.float32), dtype=jnp.float32)
    tcfg = tq.Qwen3TTSConfig(**cs.TTS_FIELDS, lm=tdl.DecoderLMConfig(**cs.TTS_LM_FIELDS, dtype=torch.float32),
                             cp=tdl.DecoderLMConfig(**cs.TTS_CP_FIELDS, dtype=torch.float32),
                             c2w=tq.Code2WavConfig(**cs.C2W_FIELDS, dtype=torch.float32), dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, jax_converted("qwen3-tts")[0])
    tp = weights.qwen3_tts_params(port_converted("qwen3-tts"), "cpu")
    rng = np.random.default_rng(6)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :10] = rng.integers(1, jcfg.text_vocab, 10)
    jts = jq.jit_talker_prefill(jp, jcfg, jnp.asarray(tokens), jp["speakers"][:1],
                                jdl.init_decode_state(jcfg.lm, 1, max_t=64))
    tts = tq.talker_prefill(tp, tcfg, _t(tokens), tp["speakers"][:1], tdl.init_decode_state(tcfg.lm, 1, max_t=64))
    _close(tts.next_embed.numpy(), jts.next_embed, 1e-4)
    jctx, tctx = jnp.zeros((4, jcfg.n_q), jnp.int32), torch.zeros((4, tcfg.n_q), dtype=torch.int32)
    for n in (2, 3):
        jaudio, jeos, jts, jctx = jq.jit_decode_chunk_audio(jp, jcfg, jts, jctx, n)
        taudio, teos, tts, tctx = tq.decode_chunk_audio(tp, tcfg, tts, tctx, n)
        np.testing.assert_array_equal(np.asarray(jctx), tctx.numpy())
        np.testing.assert_array_equal(np.asarray(jeos), teos.numpy())
        _close(taudio.numpy(), jaudio, 1e-4)


def _parakeet():
    from s2s_tpu.models import parakeet as jpk
    from s2s_tpu_torch.models import parakeet as tpk

    data = np.load(os.path.join(ROOT, "tests", "data", "parakeet_parity.npz"))
    jcfg = jpk.ParakeetConfig(**cs.PARAKEET_FIELDS, dtype=jnp.float32)
    tcfg = tpk.ParakeetConfig(**cs.PARAKEET_FIELDS, dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, jax_converted("parakeet")[0])
    tp = weights.parakeet_params(port_converted("parakeet"), "cpu")
    jenc, jlen = jpk.jit_encode(jp, jcfg, jnp.asarray(data["mel"]), jnp.asarray(data["mel_lens"]))
    enc, enc_len = tpk.encode(tp, tcfg, _t(data["mel"]), _t(data["mel_lens"]))
    np.testing.assert_array_equal(enc_len.numpy(), np.asarray(jlen))
    for b in range(2):
        n = int(enc_len[b])
        _close(enc[b, :n].numpy(), np.asarray(jenc)[b, :n], 1e-4)
    buf, n = jpk.tdt_greedy_decode(jp, jcfg, jenc[:1], jnp.asarray(int(jlen[0]), jnp.int32))
    assert tpk.tdt_greedy_decode(tp, tcfg, enc[:1], int(enc_len[0])) == [int(x) for x in np.asarray(buf[: int(n)])]


def _silero():
    from s2s_tpu.models import silero_vad as js
    from s2s_tpu_torch.models import silero_vad as ts

    jtree = jax.tree.map(jnp.asarray, jax_converted("silero-vad")[0])
    p = weights.silero_params(port_converted("silero-vad"), "cpu")
    rng = np.random.default_rng(0)
    jstate, state = js.SileroState.create(2), ts.SileroState.create(2)
    for _ in range(6):
        chunk = (rng.standard_normal((2, ts.CHUNK)) * 0.1).astype(np.float32)
        jprob, jstate = js.step(jtree, jstate, jnp.asarray(chunk))
        prob, state = ts.step(p, state, _t(chunk))
        np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=1e-5, rtol=0)


def _paraformer():
    tree, _ = jax_converted("paraformer")
    p = weights.paraformer_params(port_converted("paraformer"), "cpu")
    feats = paraformer_tests._feats(20)
    want = paraformer_tests._stages_jax(tree, feats, 20)
    got = paraformer_tests._stages_port(p, feats, 20, want)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, atol=paraformer_tests.ATOL, rtol=0)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[4], want[4], atol=paraformer_tests.ATOL, rtol=0)


def _vision():
    from s2s_tpu.models import vision as jv
    from s2s_tpu_torch.models import vision as tv

    jcfg, tcfg = jv.VisionConfig.test_tiny(), tv.VisionConfig.test_tiny()
    pixels = np.random.default_rng(0).uniform(-1, 1, (1, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    want = jv.encode_image(jax.tree.map(jnp.asarray, jax_converted("smolvlm-vision")[0]), jcfg, jnp.asarray(pixels))
    got = tv.encode_image(weights.vision_params(port_converted("smolvlm-vision"), "cpu"), tcfg, _t(pixels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _vits():
    tree, _ = jax_converted("mms-vits")
    p = weights.vits_params(port_converted("mms-vits"), "cpu")
    lengths = [24, 9]
    (jw, jn), (wav, n) = vits_tests._synth_both(tree, p, vits_tests._tokens(5, lengths), lengths)
    np.testing.assert_array_equal(n, jn)
    vits_tests._close(wav, jw, vits_tests.WAV_ATOL)


def _kokoro():
    tree, _ = jax_converted("kokoro")
    p = weights.kokoro_params(port_converted("kokoro"), "cpu")
    (jdur, jd, jt), (dur, d, t_en) = kokoro_tests._phase_a(
        tree, p, kokoro_tests._tokens(6, [16, 9], 16), [16, 9], kokoro_tests._ref_s(5, 2))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(jdur))
    kokoro_tests._close(d.numpy(), jd, kokoro_tests.PHASE_A_ATOL)
    kokoro_tests._close(t_en.numpy(), jt, kokoro_tests.PHASE_A_ATOL)


def _mimi(name):
    from s2s_tpu.models import mimi as jm
    from s2s_tpu_torch.models import mimi as tm

    jcfg, tcfg = jm.MimiConfig.tiny(), tm.MimiConfig.tiny()
    codes = np.random.default_rng(3).integers(0, jcfg.codebook_size, (2, 5, jcfg.n_q)).astype(np.int32)
    want = np.asarray(jm.decode(jax.tree.map(jnp.asarray, jax_converted(name)[0]), jcfg, jnp.asarray(codes)))
    got = tm.decode(weights.mimi_params(port_converted(name), "cpu"), tcfg, _t(codes)).numpy()
    _close(got, want, 1e-6)


def _pocket():
    tree, _ = jax_converted("pocket-tts")
    p = weights.pocket_params(port_converted("pocket-tts"), "cpu")
    want_codes, want_eos = pocket_tests._jax_frames(tree, pocket_tests.TEXT, 12)
    codes, eos, _ = pocket_tests.tp.generate_frames(p, pocket_tests.TCFG, _t(pocket_tests.TEXT),
                                                    pocket_tests._port_state(p), 12)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(eos.numpy(), want_eos)


def _chattts():
    tree, _ = jax_converted("chattts")
    p = weights.chattts_params(port_converted("chattts"), "cpu")
    text = np.load(os.path.join(ROOT, "tests", "data", "chattts_parity.npz"))["text"]
    want = chattts_tests._jax_codes(tree, text, None, 8)
    got = chattts_tests._port_codes(p, text, None, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _deepfilter():
    from s2s_tpu_torch.models import deepfilter as td

    tree, _ = jax_converted("deepfilter")
    jcfg, tcfg = deepfilter_tests.CONFIGS["tiny"]
    fx = np.load(os.path.join(ROOT, "tests", "data", "deepfilter_parity.npz"))
    spec = (fx["spec_re"] + 1j * fx["spec_im"]).astype(np.complex64)
    want, _ = deepfilter_tests._jax_scan(tree, jcfg, spec)
    got, _ = td.filter_frames(weights.deepfilter_params(port_converted("deepfilter"), "cpu"), tcfg,
                              torch.from_numpy(spec), td.init_state(tcfg))
    deepfilter_tests._close(got.numpy(), want, "frames")


FORWARDS = {
    "llama": lambda: _decoder_lm("llama", cs.LLAMA_FIELDS),
    "qwen3": lambda: _decoder_lm("qwen3", cs.QWEN3_FIELDS),
    "whisper": _whisper, "smart-turn": _smart_turn, "qwen3-tts": _qwen3_tts, "parakeet": _parakeet,
    "silero-vad": _silero, "paraformer": _paraformer, "smolvlm-vision": _vision, "mms-vits": _vits,
    "kokoro": _kokoro, "mimi": lambda: _mimi("mimi"), "mimi-hf": lambda: _mimi("mimi-hf"), "pocket-tts": _pocket,
    "chattts": _chattts, "deepfilter": _deepfilter,
}


def test_every_f32_case_has_a_forward():
    assert sorted(FORWARDS) == sorted(k for k in CASES if not k.endswith("-bf16"))


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_port_converted_tree_forward_matches_jax(name):
    FORWARDS[name]()


# ── the port loads bf16 checkpoints ──────────────────────────────────


def test_jax_written_bf16_npz_loads_into_the_port_bit_equal(tmp_path):
    """A tiny bf16 decoder LM through the JAX converter, saved as the JAX
    script saves it (its ``flatten``, ``np.savez_compressed``), through the
    port's registry loader and weight bridge."""
    from s2s_tpu.models import decoder_lm as jdl
    from s2s_tpu_torch.registry import _load_checkpoint

    tree = jdl.convert_hf_state_dict(cs.fixture_state_dict("llama"),
                                     jdl.DecoderLMConfig(**cs.LLAMA_FIELDS, dtype=jnp.bfloat16))
    flat = jax_script.flatten(tree)
    path = str(tmp_path / "lm.npz")
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in flat.items()})
    assert np.load(path)["embed"].dtype == np.dtype("V2")
    got = weights.tree_to_torch(_load_checkpoint(path), "cpu")
    want = jax.tree_util.tree_map(np.asarray, tree)
    for (path_, leaf), (_, ref) in zip(jax.tree_util.tree_leaves_with_path(got),
                                       jax.tree_util.tree_leaves_with_path(want)):
        assert leaf.dtype == torch.bfloat16, path_
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(), ref.view(np.int16), err_msg=str(path_))


# ── the safetensors reader and writer ────────────────────────────────


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64])
def test_safetensors_reader_equals_the_safetensors_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(1)
    tensors = {"a.weight": torch.randn((7, 3), generator=gen).to(dtype) if dtype.is_floating_point
               else torch.randint(-(1 << 40), 1 << 40, (7, 3), generator=gen),
               "b": torch.randn((5,), generator=gen).to(dtype) if dtype.is_floating_point
               else torch.arange(5, dtype=dtype), "mask": torch.rand((2, 2), generator=gen) > 0.5}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want, got = load_file(path), cc.SafetensorsFile(path)
    assert sorted(got) == sorted(want) and len(got) == 3 and "b" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    mine = str(tmp_path / "mine.safetensors")
    cc.save_safetensors(mine, tensors)
    back = load_file(mine)
    assert all(back[k].dtype == t.dtype and torch.equal(back[k], t) for k, t in tensors.items())


# ── the CLI against the JAX script ───────────────────────────────────


def _run(argv: list[str]) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def _cli_source(family: str, tmp_path) -> str:
    """A tiny source file of *family*, one whose published config is small."""
    from s2s_tpu_torch.models.whisper import WhisperConfig

    gen = torch.Generator().manual_seed(2)
    if family == "silero-vad":
        path = str(tmp_path / "silero.pt")
        torch.save({k: torch.from_numpy(v) for k, v in cs.silero_state_dict().items()}, path)
    elif family == "deepfilter":
        path = str(tmp_path / "deepfilter.pt")
        torch.save({k: torch.from_numpy(v) for k, v in cs.fixture_state_dict("deepfilter").items()}, path)
    elif family == "smart-turn":
        path = str(tmp_path / "smart_turn.pt")
        torch.save(cs.smart_turn_state_dict(WhisperConfig.tiny(), gen, torch.float32), path)
    elif family == "kokoro-voice":
        path = str(tmp_path / "af_voice.pt")
        torch.save(torch.randn((510, 1, 256), generator=gen), path)  # a bare voicepack tensor
    else:
        path = str(tmp_path / "voice.safetensors")
        cc.save_safetensors(path, {"audio_prompt": torch.randn((6, 32), generator=gen)})
    return path


@pytest.mark.parametrize("family", ["silero-vad", "deepfilter", "smart-turn", "kokoro-voice", "pocket-voice"])
def test_cli_writes_the_jax_scripts_arrays(tmp_path, family):
    src = _cli_source(family, tmp_path)
    mine, theirs = str(tmp_path / f"{family}.port.npz"), str(tmp_path / f"{family}.jax.npz")
    out = _run(["-m", "s2s_tpu_torch.tools.convert_checkpoint", "--family", family, "--src", src,
                "--out", mine, "--device", "cpu"]).stdout
    assert f"wrote {mine}: " in out and "peak RSS" in out, out
    _run(["scripts/convert_checkpoint.py", "--family", family, "--src", src, "--out", theirs])
    assert_same_arrays(dict(np.load(mine)), dict(np.load(theirs)))


def test_cli_device_defaults_to_cuda_with_no_fallback(tmp_path):
    src = str(tmp_path / "silero.pt")
    torch.save({k: torch.from_numpy(v) for k, v in cs.silero_state_dict().items()}, src)
    argv = ["--family", "silero-vad", "--src", src, "--out", str(tmp_path / "x.npz")]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cc.main(argv)
    assert not os.path.exists(tmp_path / "x.npz")
    cc.main([*argv, "--device", "cpu"])
    assert os.path.exists(tmp_path / "x.npz")


def test_npz_writer_is_np_savez_uncompressed(tmp_path):
    """The tool's file reads back as ``np.savez``'s, member for member, and
    stores its members uncompressed."""
    import zipfile

    arrays = {"a/b/0": np.arange(6, dtype=np.float32).reshape(2, 3), "c": np.ones(3, np.int64),
              "bf": np.arange(4, dtype=np.int16).view(np.dtype("V2"))}
    n_arrays, n_elements = cc.save_npz(str(tmp_path / "mine"), iter(arrays.items()))
    assert (n_arrays, n_elements) == (3, 13)
    np.savez(str(tmp_path / "theirs.npz"), **arrays)
    assert_same_arrays(dict(np.load(tmp_path / "mine.npz")), dict(np.load(tmp_path / "theirs.npz")))
    with zipfile.ZipFile(tmp_path / "mine.npz") as zf:
        assert {i.compress_type for i in zf.infolist()} == {zipfile.ZIP_STORED}


# ── the card's HF-layout generators through both converters ──────────


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def test_smollm2_generator_as_bf16_safetensors_through_both_converters(tmp_path):
    from s2s_tpu.models import decoder_lm as jdl
    from s2s_tpu_torch.models import decoder_lm as tdl

    fields = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, tie_embeddings=True)
    sd = cs.hf_decoder_lm_state_dict(tdl.DecoderLMConfig(**fields), torch.Generator().manual_seed(0), torch.bfloat16)
    assert "lm_head.weight" not in sd  # tied, as SmolLM2 publishes it
    path = str(tmp_path / "model.safetensors")
    cc.save_safetensors(path, sd)
    got = cc.flatten(tdl.convert_hf_state_dict(cc.SafetensorsFile(path), tdl.DecoderLMConfig(**fields), "cpu"))
    from safetensors.torch import load_file

    src = load_file(path)
    want = jdl.convert_hf_state_dict({k: _bf16_bits(v) for k, v in src.items()}, jdl.DecoderLMConfig(**fields))
    assert_same_arrays(got, stored(jax_script.flatten(want)))
    assert got["embed"].dtype == np.dtype("V2")


def test_distil_whisper_generator_as_f16_safetensors_through_both_converters(tmp_path):
    from s2s_tpu.models import whisper as jw
    from s2s_tpu_torch.models import whisper as tw

    tcfg = dataclasses.replace(tw.WhisperConfig.test_tiny(), n_mels=128, dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jw.WhisperConfig.test_tiny(), n_mels=128, dtype=jnp.bfloat16)
    sd = cs.hf_whisper_state_dict(tcfg, torch.Generator().manual_seed(1), torch.float16)
    path = str(tmp_path / "model.safetensors")
    cc.save_safetensors(path, sd)
    got = cc.flatten(tw.convert_hf_state_dict(cc.SafetensorsFile(path), tcfg, device="cpu"))
    from safetensors.numpy import load_file

    want = jw.convert_hf_state_dict(load_file(path), jcfg)
    assert_same_arrays(got, stored(jax_script.flatten(want)))


def test_smart_turn_generator_as_f32_pt_through_both_converters(tmp_path):
    from s2s_tpu.vad import smart_turn as jst
    from s2s_tpu_torch.models import whisper as tw

    sd = cs.smart_turn_state_dict(tw.WhisperConfig.tiny(), torch.Generator().manual_seed(2), torch.float32)
    assert all(k.startswith(("encoder.", "classifier.")) for k in sd)
    path = str(tmp_path / "smart_turn.pt")
    torch.save(sd, path)
    got = cc.flatten(cc.convert("smart-turn", cc.load_state_dict(path), torch.device("cpu")))
    want = jst.convert_state_dict(jax_script.load_state_dict(path))
    assert_same_arrays(got, stored(jax_script.flatten(want)))


# ── a tiny serve from a tool-converted checkpoint ────────────────────


def test_tiny_serve_from_a_tool_converted_lm_checkpoint_runs_int8(tmp_path, monkeypatch):
    """``--llm_checkpoint`` from the tool (a BF16 safetensors source at the
    tiny LM's shapes under the ``smollm2-1.7b`` family) with ``--llm_quantize
    int8``: the single-session LM's projections are int8 and a text turn is
    answered."""
    import test_torch_port_serve as serve
    from s2s_tpu_torch import cli
    from s2s_tpu_torch.models import decoder_lm as tdl
    from s2s_tpu_torch.ops import quant
    from s2s_tpu_torch.registry import GLOBAL_MODEL_CACHE

    tiny = tdl.DecoderLMConfig.tiny()
    monkeypatch.setattr(tdl.DecoderLMConfig, "smollm2_1_7b", staticmethod(lambda: tiny))
    monkeypatch.setattr(quant, "_MIN_SIZE", 1)  # the tiny matrices quantize too
    src, out = str(tmp_path / "model.safetensors"), str(tmp_path / "lm.npz")
    cc.save_safetensors(src, cs.hf_decoder_lm_state_dict(tiny, torch.Generator().manual_seed(4), torch.bfloat16))
    cc.main(["--family", "smollm2-1.7b", "--src", src, "--out", out, "--device", "cpu"])
    stop = threading.Event()
    flags = [*serve.TINY_FLAGS, "--llm_checkpoint", out]
    manager, server, _ = cli.build_from_argv(["--device", "cpu", *flags], stop)
    llm = next(h for h in manager.handlers if type(h).__name__ == "LocalTorchLLMHandler")
    assert isinstance(llm.params["layers"]["wq"], quant.QuantWeight)
    assert llm.params["embed"].dtype == tiny.dtype
    manager.start()
    try:
        assert server.started.wait(30)
        events = asyncio.run(serve._text_turn(f"ws://127.0.0.1:{server.bound_port}/v1/realtime", "Hello there"))
    finally:
        stop.set()
        manager.stop()
        GLOBAL_MODEL_CACHE.clear()
    assert events[-1]["type"] == "response.done" and events[-1]["response"]["status"] == "completed", events[-1]


def write_digests() -> None:
    """Rewrite ``tests/data/converted_digests.json`` from the JAX converters."""
    digests = {name: cs.array_digests(jax_converted(name)[1]) for name in sorted(CASES)}
    with open(DIGESTS, "w") as f:  # a case a line
        f.write("{\n" + ",\n".join(f"{json.dumps(name)}: {json.dumps(rows, separators=(',', ':'))}"
                                     for name, rows in digests.items()) + "\n}\n")
    print(f"wrote {DIGESTS}: {len(digests)} cases, {sum(map(len, digests.values()))} arrays")


if __name__ == "__main__":
    write_digests()
