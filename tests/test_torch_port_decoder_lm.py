"""Parity: s2s_tpu_torch.models.decoder_lm against the JAX decoder LM.

Weights come from the JAX ``init_params`` (tiny f32 config) and cross
through ``s2s_tpu_torch.weights``; prompts come from a numpy seed.  Logits
agree within 1e-4 * max|ref| (f32 sums in another order); greedy tokens are
exact.  The int8 cases quantize on both sides (every matrix, min_size=1).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import decoder_lm as jdl  # noqa: E402
from s2s_tpu.ops.quant import quantize_tree as jax_quantize_tree  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import decoder_lm as tdl  # noqa: E402
from s2s_tpu_torch.ops.quant import quantize_tree  # noqa: E402

PROMPT_LEN, BUCKET, N_DECODE = 11, 16, 12


def _close(ref, got, rel=1e-4):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _models(quant: bool):
    jcfg, tcfg = jdl.DecoderLMConfig.tiny(), tdl.DecoderLMConfig.tiny()
    jp = jdl.init_params(jax.random.PRNGKey(3), jcfg)
    tp = weights.tree_to_torch(jp, "cpu")
    if quant:
        jp = jax_quantize_tree(jp, min_size=1)
        tp = quantize_tree(tp, min_size=1)
    return jcfg, jp, tcfg, tp


def _prompt():
    rng = np.random.default_rng(7)
    tokens = np.zeros((1, BUCKET), np.int32)
    tokens[0, :PROMPT_LEN] = rng.integers(1, 256, PROMPT_LEN)
    return tokens


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_prefill_and_decode_chunk_match_jax(quant):
    jcfg, jp, tcfg, tp = _models(quant)
    tokens = _prompt()
    jstate = jdl.init_decode_state(jcfg, 1, max_t=BUCKET + N_DECODE)
    jlogits, jstate = jdl.prefill(jp, jcfg, jnp.asarray(tokens), jstate, PROMPT_LEN)
    tstate = tdl.init_decode_state(tcfg, 1, max_t=BUCKET + N_DECODE)
    tlogits, tstate = tdl.prefill(tp, tcfg, torch.from_numpy(tokens), tstate, PROMPT_LEN)
    _close(jlogits, tlogits)
    assert tstate.pos == int(jstate.pos) == PROMPT_LEN

    jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tlogits, dim=-1).to(torch.int32)
    eos = int(jtok[0])  # an id the greedy stream may hit again
    jtoks, jeos, jnext, jstate = jdl.decode_chunk(jp, jcfg, jtok, jstate, N_DECODE, eos)
    ttoks, teos, tnext, tstate = tdl.decode_chunk(tp, tcfg, ttok, tstate, N_DECODE, eos)
    np.testing.assert_array_equal(np.asarray(jtoks), ttoks.numpy())
    np.testing.assert_array_equal(np.asarray(jeos), teos.numpy())
    assert int(jnext[0]) == int(tnext[0])
    assert tstate.pos == int(jstate.pos)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_step_logits_match_jax(quant):
    jcfg, jp, tcfg, tp = _models(quant)
    tokens = _prompt()
    jstate = jdl.init_decode_state(jcfg, 1, max_t=32)
    _, jstate = jdl.prefill(jp, jcfg, jnp.asarray(tokens), jstate, PROMPT_LEN)
    tstate = tdl.init_decode_state(tcfg, 1, max_t=32)
    _, tstate = tdl.prefill(tp, tcfg, torch.from_numpy(tokens), tstate, PROMPT_LEN)
    token = np.array([42], np.int32)
    jlogits, _ = jdl.decode_step(jp, jcfg, jnp.asarray(token), jstate)
    tlogits, _ = tdl.decode_step(tp, tcfg, torch.from_numpy(token), tstate)
    _close(jlogits, tlogits)


@pytest.mark.parametrize("family", ["llama", "qwen3"])
def test_hf_fixture_anchor(family):
    """Second anchor: the transformers-generated fixtures (the JAX package's
    ``tests/data/*_parity.npz``), converted by the JAX converter and bridged,
    reproduce the fixture's logits at every position through the port's
    prefill + per-token decode (cache path), within the JAX test's 3e-3."""
    data = np.load(os.path.join(os.path.dirname(__file__), "data", f"{family}_parity.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files if k.startswith("sd__")}
    qwen = family == "qwen3"
    common = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                  max_seq_len=128, rope_theta=10000.0, rms_eps=1e-6 if qwen else 1e-5,
                  tie_embeddings=True, qk_norm=qwen, head_dim_override=32 if qwen else None)
    jcfg = jdl.DecoderLMConfig(**common, dtype=jnp.float32)
    tcfg = tdl.DecoderLMConfig(**common, dtype=torch.float32)
    tp = weights.tree_to_torch(jdl.convert_hf_state_dict(sd, jcfg), "cpu")
    tokens = torch.from_numpy(data["tokens"].astype(np.int32))
    state = tdl.init_decode_state(tcfg, 1, max_t=16)
    logits, state = tdl.prefill(tp, tcfg, tokens[:, :1], state, 1)
    rows = [logits]
    for i in range(1, tokens.shape[1]):
        logits, state = tdl.decode_step(tp, tcfg, tokens[:, i], state)
        rows.append(logits)
    got = torch.stack(rows, dim=1).numpy()
    np.testing.assert_allclose(got, data["logits"], atol=3e-3)
    assert np.array_equal(got.argmax(-1), data["logits"].argmax(-1))
