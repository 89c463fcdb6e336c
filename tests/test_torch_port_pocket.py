"""Parity: the port's Pocket-TTS against the JAX package, on the CPU.

Both sides are f32, at ``PocketTTSConfig.tiny()``; trees are carried across
with ``weights.pocket_params`` (its Mimi subtree through
``weights.mimi_params``).  Greedy codes are compared token for token.

- ``tests/data/pocket_parity.npz`` (the moshi-layout torch twin) through
  the JAX converter ``pocket_tts.convert_state_dict``: the codes of 12
  frames equal the fixture's, without and with the voice prefix, and each
  frame's backbone hidden is within 1e-5 of the twin's.
- ``tests/data/pocket_hf_parity.npz`` (the ``transformers`` Moshi temporal
  transformer): the port's decoder blocks within 1e-4 of its hiddens, the
  JAX package's bound.
- From an ``init_params`` tree: ``generate_frames`` codes and EOS flags
  equal to JAX over 20 frames, with and without a voice prefix; chunked
  generation (4 + 6 and 1 + 3 + 6 frames) equal to one-shot; the depformer
  with its cache reused and zeroed per frame equal to a new cache per frame;
  ``_frame_input`` within 1e-6 at frames before and after the delayed
  streams start and past the text.
- ``synthesize_utterance``: waveform within 1e-6 of max|ref| and the same
  valid-frame count as JAX, for an EOS found early (a head row boosted) and
  for none; ``PocketTTS.stream``: the same chunk lengths as the JAX wrapper,
  audio within 1e-6 of max|ref|, and no more than one read back per chunk.
- A converted checkpoint ``.npz`` (the twin's LM and the Mimi fixture) served
  through the registry's ``--tts pocket`` factory on the CPU, with a named
  voice file.
- ``tests/data/pocket_parity_converted.npz`` (what ``chip_smoke.py`` loads,
  as it imports nothing of the JAX package) equals the JAX converters'
  output on the two fixtures; ``python tests/test_torch_port_pocket.py``
  writes it.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import mimi as jm  # noqa: E402
from s2s_tpu.models import pocket_tts as jp  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import decoder_lm as td  # noqa: E402
from s2s_tpu_torch.models import pocket_tts as tp  # noqa: E402
from s2s_tpu_torch.models.common import rms_norm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 on both sides: an embedding sum or the waveform, relative to its peak
EMBED_ATOL, WAV_REL = 1e-6, 1e-6
#: the backbone hidden against the twin (f32 eager torch on both sides)
TWIN_HIDDEN_ATOL = 1e-5
#: against the transformers Moshi backbone: the JAX package's bound
HF_HIDDEN_ATOL = 1e-4

JCFG, TCFG = jp.PocketTTSConfig.tiny(), tp.PocketTTSConfig.tiny()
TEXT = np.array([[5, 9, 17, 4]], np.int64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _fixture(name):
    fx = np.load(os.path.join(ROOT, "tests", "data", name))
    return fx, {k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}


@pytest.fixture(scope="module")
def twin():
    fx, sd = _fixture("pocket_parity.npz")
    tree = jp.convert_state_dict(sd, JCFG)
    return fx, weights.pocket_params(tree, "cpu")


@pytest.fixture(scope="module")
def params():
    tree = jax.tree_util.tree_map(np.asarray, jp.init_params(jax.random.PRNGKey(1), JCFG))
    return tree, weights.pocket_params(tree, "cpu")


def _jax_frames(tree, text, n, voice=None):
    p = jax.tree.map(jnp.asarray, tree)
    state = jp.init_state(JCFG, text.shape[0], cache_len=64)
    if voice is not None:
        state = state._replace(lm_state=jp.prefill_voice(p, JCFG, jnp.asarray(voice), state.lm_state))
    codes, eos, _ = jp.generate_frames(p, JCFG, jnp.asarray(text), state, n)
    return np.asarray(codes), np.asarray(eos)


CONVERTED = os.path.join(ROOT, "tests", "data", "pocket_parity_converted.npz")


def converted_fixture() -> dict[str, np.ndarray]:
    """The twin's LM (``pocket_parity.npz``) and Mimi decoder
    (``mimi_parity.npz``) through the JAX converters, flattened as a
    converted checkpoint under ``tree/``, beside the fixtures' inputs and
    outputs under ``fx/``."""
    from scripts.convert_checkpoint import flatten

    fx, sd = _fixture("pocket_parity.npz")
    mfx, msd = _fixture("mimi_parity.npz")
    tree = jp.convert_state_dict(sd, JCFG)
    tree["mimi"] = jm.convert_state_dict(msd, JCFG.mimi)
    out = flatten({"tree": jax.tree_util.tree_map(np.asarray, tree)})
    out.update({f"fx/{k}": fx[k] for k in ("text", "voice", "codes", "codes_v")})
    out.update({"fx/mimi_codes": mfx["codes"], "fx/mimi_wav": mfx["wav"]})
    return out


def _config_fields(cfg) -> dict:
    """A configuration of either package as plain values (dtypes by name)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _config_fields(v)
        elif f.name == "dtype":
            v = str(v).replace("torch.", "") if isinstance(v, torch.dtype) else np.dtype(v).name
        out[f.name] = v
    return out


def _port_state(p, batch=1, voice=None):
    state = tp.init_state(TCFG, batch, cache_len=64)
    if voice is not None:
        state = state._replace(lm_state=tp.prefill_voice(p, TCFG, _t(voice), state.lm_state))
    return state


# ── the fixtures ─────────────────────────────────────────────────────


@pytest.mark.parametrize("voice", [False, True])
def test_twin_codes_equal_the_fixture(twin, voice):
    fx, p = twin
    state = _port_state(p, voice=fx["voice"] if voice else None)
    codes, _, state = tp.generate_frames(p, TCFG, _t(fx["text"]), state, 12)
    np.testing.assert_array_equal(codes.numpy(), fx["codes_v" if voice else "codes"])
    assert state.frame == 12 and state.lm_state.pos == 12 + (3 if voice else 0)


def test_twin_backbone_hiddens_match_the_fixture(twin):
    """The twin's rope runs at theta 10000; ``tiny()`` (as the JAX package's)
    leaves the backbone at ``DecoderLMConfig``'s 130000, which moves the
    hiddens from frame 1 on (by about 6e-3) but not the greedy codes.  At the
    twin's theta every frame's hidden matches the fixture."""
    fx, p = twin
    cfg = dataclasses.replace(TCFG, backbone=dataclasses.replace(TCFG.backbone, rope_theta=10000.0))
    assert TCFG.backbone.rope_theta == JCFG.backbone.rope_theta == 130000.0
    state = tp.init_state(cfg, 1, cache_len=64)
    text = _t(fx["text"])
    hiddens = []
    for frame in range(12):
        emb = tp._frame_input(p, cfg, text, state.ring, frame)
        x, lm_state = td._hidden_step(p["backbone"], cfg.backbone, emb[:, None, :], state.lm_state)
        hiddens.append(rms_norm(x[:, 0], p["backbone"]["final_norm"], cfg.backbone.rms_eps))
        codes, _ = tp._depformer_frame(p, cfg, hiddens[-1], tp._dep_state(cfg, 1, "cpu"))
        state.ring[frame % (cfg.max_delay + 1)] = codes
        state = state._replace(lm_state=lm_state)
    np.testing.assert_allclose(torch.stack(hiddens).numpy(), fx["hiddens"], atol=TWIN_HIDDEN_ATOL, rtol=0)


def test_backbone_matches_the_transformers_moshi_fixture():
    """The port's decoder blocks over ``pocket_hf_parity.npz``'s embeddings,
    its q/k rows mapped back from half-split to interleaved rope as the JAX
    package's test maps them."""
    fx, sd = _fixture("pocket_hf_parity.npz")
    cfg = TCFG.backbone

    def reinterleave(w, n_heads):
        hd = w.shape[0] // n_heads
        w = w.reshape(n_heads, hd, -1)
        perm = np.empty(hd, np.int64)
        perm[0::2] = np.arange(hd // 2)
        perm[1::2] = np.arange(hd // 2) + hd // 2
        return w[:, perm, :].reshape(n_heads * hd, -1)

    layers = []
    for i in range(cfg.n_layers):
        lp = f"layers.{i}"
        w_gate, w_up = np.split(sd[f"{lp}.mlp.fc1.weight"], 2, axis=0)
        layers.append({
            "attn_norm": sd[f"{lp}.input_layernorm.weight"],
            "wq": reinterleave(sd[f"{lp}.self_attn.q_proj.linear.weight"], cfg.n_heads).T,
            "wk": reinterleave(sd[f"{lp}.self_attn.k_proj.linear.weight"], cfg.n_kv_heads).T,
            "wv": sd[f"{lp}.self_attn.v_proj.linear.weight"].T,
            "wo": sd[f"{lp}.self_attn.o_proj.linear.weight"].T,
            "mlp_norm": sd[f"{lp}.post_attention_layernorm.weight"],
            "w_gate": w_gate.T, "w_up": w_up.T, "w_down": sd[f"{lp}.mlp.fc2.weight"].T,
        })
    p = weights.tree_to_torch({"layers": {k: np.stack([layer[k] for layer in layers]) for k in layers[0]},
                               "final_norm": sd["norm.weight"]}, "cpu")
    embeds = _t(fx["embeds"].astype(np.float32))
    t = embeds.shape[1]
    cos, sin = td._rope(cfg, "cpu")
    x, _ = td._run_blocks(embeds, p, cfg, None, 0, cos[:t], sin[:t], td.causal_mask(t, t, 0))
    hidden = rms_norm(x, p["final_norm"], cfg.rms_eps)
    np.testing.assert_allclose(hidden.numpy(), fx["hidden"], atol=HF_HIDDEN_ATOL, rtol=0)


# ── generation against JAX ───────────────────────────────────────────


@pytest.mark.parametrize("voice", [False, True])
def test_generate_frames_equals_jax(params, voice):
    tree, p = params
    prefix = np.random.default_rng(5).normal(0, 0.3, (1, 3, JCFG.backbone.d_model)).astype(np.float32) \
        if voice else None
    want_codes, want_eos = _jax_frames(tree, TEXT, 20, prefix)
    codes, eos, _ = tp.generate_frames(p, TCFG, _t(TEXT), _port_state(p, voice=prefix), 20)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(eos.numpy(), want_eos)


def test_two_rows_generate_as_jax(params):
    tree, p = params
    text = np.array([[5, 9, 17, 4, 30], [7, 7, 3, 3, 3]], np.int64)
    want_codes, want_eos = _jax_frames(tree, text, 10)
    codes, eos, _ = tp.generate_frames(p, TCFG, _t(text), _port_state(p, batch=2), 10)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(eos.numpy(), want_eos)


@pytest.mark.parametrize("split", [(4, 6), (1, 3, 6)])
def test_chunked_generation_equals_one_shot(params, split):
    _, p = params
    one, _, _ = tp.generate_frames(p, TCFG, _t(TEXT), _port_state(p), sum(split))
    state, parts = _port_state(p), []
    for n in split:
        codes, _, state = tp.generate_frames(p, TCFG, _t(TEXT), state, n)
        parts.append(codes)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), one.numpy())


def test_reused_depformer_cache_gives_the_codes_of_a_new_one(params):
    _, p = params
    hiddens = torch.from_numpy(np.random.default_rng(6).standard_normal((5, 2, 32)).astype(np.float32))
    reused = tp._dep_state(TCFG, 2, "cpu")
    for h in hiddens:
        codes, eos = tp._depformer_frame(p, TCFG, h, reused)
        fresh_codes, fresh_eos = tp._depformer_frame(p, TCFG, h, tp._dep_state(TCFG, 2, "cpu"))
        assert torch.equal(codes, fresh_codes) and torch.equal(eos, fresh_eos)
    want = jp._depformer_frame(jax.tree.map(jnp.asarray, params[0]), JCFG, jnp.asarray(hiddens[-1].numpy()))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("frame", [0, 1, 2, 3, 4, 9])
def test_frame_input_matches_jax(params, frame):
    tree, p = params
    ring = np.random.default_rng(frame).integers(0, JCFG.codebook_size, (JCFG.max_delay + 1, 1, JCFG.n_q))
    want = jp._frame_input(tree, JCFG, jnp.asarray(TEXT), jnp.asarray(ring), jnp.asarray(frame))
    got = tp._frame_input(p, TCFG, _t(TEXT), _t(ring), frame)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EMBED_ATOL, rtol=0)


@pytest.mark.parametrize("eos_early", [False, True])
def test_synthesize_utterance_matches_jax(params, eos_early):
    tree, p = params
    if eos_early:  # make EOS the argmax of slot 0 from some frame on
        tree = jax.tree_util.tree_map(lambda x: x, tree)
        tree["dep_head0"] = tree["dep_head0"].copy()
        tree["dep_head0"][:, JCFG.audio_eos_id] *= 10.0  # EOS first at frame 10
        p = weights.pocket_params(tree, "cpu")
    want, want_n = jp.synthesize_utterance(jax.tree.map(jnp.asarray, tree), JCFG, jnp.asarray(TEXT), 16,
                                           cache_len=64)
    got, n = tp.synthesize_utterance(p, TCFG, _t(TEXT), 16, cache_len=64)
    want = np.asarray(want)
    assert int(n) == int(want_n)
    assert (int(n) < 16 - JCFG.max_delay) == eos_early
    np.testing.assert_allclose(got.numpy(), want, atol=WAV_REL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("voice", [None, "alba"])
def test_stream_matches_the_jax_wrapper(params, voice, monkeypatch):
    tree, p = params
    ref = jp.PocketTTS(params=tree, cfg=JCFG)
    port = tp.PocketTTS(params=p, cfg=TCFG)
    prefix = np.random.default_rng(0).normal(0, 0.3, (2, JCFG.backbone.d_model))
    for model in (ref, port):
        model.add_voice("alba", prefix)
    text = "Hello world, twice over."
    want = [a for a, _ in ref.stream(text, voice=voice)]
    reads = []
    real_cpu = torch.Tensor.cpu

    def counted_cpu(self, *args, **kwargs):
        reads.append(tuple(self.shape))
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    got = [a for a, _ in port.stream(text, voice=voice)]
    monkeypatch.undo()
    assert [len(a) for a in got] == [len(a) for a in want] and len(got) >= 2
    peak = max(np.abs(a).max() for a in want)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=WAV_REL * peak, rtol=0)
    chunks = -(-port._frame_budget(text) // port.CHUNK_FRAMES)
    code_reads = [s for s in reads if s == (min(port.CHUNK_FRAMES, s[0]), TCFG.n_q + 1)]
    assert len(code_reads) == chunks, reads  # codes and EOS together, once a chunk
    assert len(reads) == chunks + len(got)  # plus one read of each chunk's audio


def test_config_from_params_reads_the_port_tree_as_jax_reads_its_own(params, twin):
    tree, p = params
    assert _config_fields(tp.config_from_params(p)) == _config_fields(jp.config_from_params(tree))
    cfg = tp.config_from_params(twin[1])  # the LM converted without its Mimi
    assert cfg.mimi == TCFG.mimi and cfg.backbone.d_model == TCFG.backbone.d_model


def test_init_params_draws_the_jax_tree():
    p = tp.init_params(TCFG, torch.Generator().manual_seed(0))
    ref = weights.pocket_params(jax.tree_util.tree_map(np.asarray, jp.init_params(jax.random.PRNGKey(0), JCFG)),
                                "cpu")
    shapes = {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype) for k, v in jax.tree_util.tree_leaves_with_path(p)}
    assert shapes == {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype)
                      for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    full = tp.PocketTTSConfig()
    assert full.backbone.dtype == torch.bfloat16 and full.mimi == tp.mimi.MimiConfig()


def test_registry_serves_a_converted_checkpoint_with_a_named_voice(tmp_path):
    import threading
    from queue import Queue

    from s2s_tpu_torch.arguments import parse_arguments
    from s2s_tpu_torch.registry import HandlerContext, ModelCache, get_backend
    from scripts.convert_checkpoint import flatten

    fx, sd = _fixture("pocket_parity.npz")
    _, msd = _fixture("mimi_parity.npz")
    tree = jp.convert_state_dict(sd, JCFG)
    tree["mimi"] = jm.convert_state_dict(msd, JCFG.mimi)
    ckpt, voice = tmp_path / "pocket_tiny.npz", tmp_path / "alba.npz"
    np.savez(ckpt, **flatten(jax.tree_util.tree_map(np.asarray, tree)))
    np.savez(voice, voice=fx["voice"][0])
    args = parse_arguments(["serve", "--tts", "pocket", "--tts_checkpoint", str(ckpt), "--tts_ref_spk", str(voice)])
    ctx = HandlerContext(stop_event=threading.Event(), queue_in=Queue(), queue_out=Queue(),
                         text_output_queue=Queue(), should_listen=threading.Event(), cancel_scope=None,
                         speculative_turns=None, device_scheduler=None, model_cache=ModelCache())
    handler = get_backend("tts", "pocket").create_handler(args.tts_config, ctx)
    model = handler.model
    assert handler.voice == "alba" and str(model.device) == "cpu"
    assert _config_fields(model.cfg) == _config_fields(jp.config_from_params(tree))
    np.testing.assert_array_equal(model.params["mimi"]["init_conv"]["w"].numpy(),
                                  tree["mimi"]["init_conv"]["w"].transpose(2, 1, 0))
    state = _port_state(model.params, voice=fx["voice"])
    codes, _, _ = tp.generate_frames(model.params, TCFG, _t(fx["text"]), state, 12)
    np.testing.assert_array_equal(codes.numpy(), fx["codes_v"])
    assert next(iter(model.stream("Hi.", voice="alba")))[0].size > 0


def test_converted_fixture_file_is_the_jax_converters_output():
    stored, want = np.load(CONVERTED), converted_fixture()
    assert sorted(stored.files) == sorted(want)
    for key, value in want.items():
        assert stored[key].dtype == value.dtype, key
        np.testing.assert_array_equal(stored[key], value, err_msg=key)


if __name__ == "__main__":
    np.savez(CONVERTED, **converted_fixture())
