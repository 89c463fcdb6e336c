"""Parity: s2s_tpu_torch.models.parakeet against the JAX Parakeet-TDT.

Weights come from the JAX ``init_params`` (``ParakeetConfig.test_tiny``, f32)
and cross through ``s2s_tpu_torch.weights``; audio comes from a numpy seed.
Mel and encoder outputs agree within 1e-4 * max|ref| (f32 sums in another
order); TDT tokens are exact.  The transformers-generated fixture
``tests/data/parakeet_parity.npz`` is the second anchor.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import parakeet as jpk  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import parakeet as tpk  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "parakeet_parity.npz")


def _close(ref, got, rel=1e-4):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jpk.ParakeetConfig.test_tiny(), tpk.ParakeetConfig.test_tiny()
    jp = jpk.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, jp, tcfg, weights.parakeet_params(jp, "cpu")


def _audio(seconds=1.0, n_valid=None):
    rng = np.random.default_rng(11)
    n = int(16000 * seconds)
    audio = (0.3 * rng.standard_normal(n)).astype(np.float32)
    if n_valid is not None:
        audio[n_valid:] = 0.0
    return audio, n if n_valid is None else n_valid


@pytest.mark.parametrize("n_valid", [None, 11_000], ids=["full", "padded"])
def test_mel_frontend_matches_jax(tiny, n_valid):
    jcfg, _, tcfg, _ = tiny
    audio, nv = _audio(n_valid=n_valid)
    jmel, jn = jpk.log_mel_frontend(jnp.asarray(audio), nv, jcfg)
    tmel, tn = tpk.log_mel_frontend(torch.from_numpy(audio), nv, tcfg)
    assert int(jn) == tn
    _close(jmel, tmel)


def test_encoder_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    audio, nv = _audio(n_valid=12_345)
    jmel, jn = jpk.log_mel_frontend(jnp.asarray(audio), nv, jcfg)
    jenc, jlen = jpk.encode(jp, jcfg, jmel[None], jn)
    tenc, tlen = tpk.encode(tp, tcfg, torch.from_numpy(np.array(jmel))[None], int(jn))
    assert int(jlen[0]) == int(tlen[0])
    _close(jenc, tenc)


@pytest.mark.parametrize("seconds", [1.0, 2.0])
def test_transcribe_tokens_match_jax(tiny, seconds):
    jcfg, jp, tcfg, tp = tiny
    audio, nv = _audio(seconds)
    jtoks = jpk.transcribe_tokens(jp, jcfg, audio, nv)
    ttoks = tpk.transcribe_tokens(tp, tcfg, audio, nv)
    assert ttoks == jtoks
    assert len(ttoks) > 0  # random weights still emit: the loop ran


def test_tdt_decode_matches_jax_on_a_shared_encoding(tiny):
    """The decode loop alone, from one encoder output fed to both sides."""
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((1, 20, jcfg.d_model)).astype(np.float32)
    buf, n = jpk.tdt_greedy_decode(jp, jcfg, jnp.asarray(enc), jnp.asarray(17, jnp.int32))
    want = [int(x) for x in np.asarray(buf[: int(n)])]
    assert tpk.tdt_greedy_decode(tp, tcfg, torch.from_numpy(enc), 17) == want


def _fixture_model():
    data = np.load(FIXTURE)
    sd = {k[len("sd__"):]: data[k] for k in data.files if k.startswith("sd__")}
    kw = dict(n_mels=32, d_model=64, n_layers=2, n_heads=4, d_ff=128, sub_channels=32,
              vocab_size=64, pred_hidden=32, pred_layers=1, joint_hidden=32, max_enc_frames=16)
    jcfg = jpk.ParakeetConfig(**kw, dtype=jnp.float32)
    tcfg = tpk.ParakeetConfig(**kw, dtype=torch.float32)
    return data, tcfg, weights.parakeet_params(jpk.convert_state_dict(sd, jcfg), "cpu")


def test_fixture_anchor_encoder_and_tdt():
    """Second anchor: transformers ParakeetEncoder outputs and the torch
    NeMo-semantics greedy tokens, through the JAX converter and the bridge."""
    data, tcfg, tp = _fixture_model()
    feats, n_valid = tpk.log_mel_frontend(torch.from_numpy(data["audio"][0]), data["audio"].shape[1], tcfg)
    np.testing.assert_allclose(feats.numpy(), data["feats"][0], atol=2e-4)
    enc, enc_len = tpk.encode(tp, tcfg, torch.from_numpy(data["mel"]), torch.from_numpy(data["mel_lens"]))
    for b in range(2):
        n = int(enc_len[b])
        np.testing.assert_allclose(enc[b, :n].numpy(), data["enc_out"][b, :n], atol=3e-4)
    encoded = torch.from_numpy(data["enc_out"][:1])
    assert tpk.tdt_greedy_decode(tp, tcfg, encoded, encoded.shape[1]) == list(data["greedy_tokens"])
