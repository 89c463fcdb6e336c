"""Parity: the port's Paraformer and its STT stage against the JAX package,
on the CPU, at ``ParaformerConfig.test_tiny()`` (f32 on both sides).

- From an ``init_params`` tree carried across with
  ``weights.paraformer_params``, each stage fed the JAX package's output of
  the stage before: ``encode``, ``cif_alphas``, the acoustic embeddings of
  ``cif_fire`` and ``decode``'s logits within ``ATOL`` of JAX (chained, the
  logits drift to about 1.1e-5); ``n_tokens`` and the token ids of the
  whole forward equal, at several lengths; the frames of a padded bucket
  change nothing.
- The CIF prefix sum (``common.xla_cumsum``) bit-equal to ``jnp.cumsum``;
  LFR + CMVN on the device (``lfr_cmvn``) bit-equal to the JAX package's
  numpy function.
- ``tests/data/paraformer_parity.npz`` (the FunASR-layout torch twin)
  through the JAX converter: the port within the JAX package's bounds of
  the twin, and within ``ATOL`` of the JAX package, with the twin's token
  count and ids.
- The stage: the JAX handler's transcriber and the port's give the same
  ids on the same audio.
- ``init_params`` draws the JAX package's tree (shapes and dtypes).
- ``tests/data/paraformer_parity_converted.npz`` (what ``chip_smoke.py``
  loads, as it imports nothing of the JAX package) equals the JAX
  converter's output on the fixture; ``python
  tests/test_torch_port_paraformer.py`` writes it.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from s2s_tpu.models import paraformer as jp  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import paraformer as tp  # noqa: E402
from s2s_tpu_torch.models.common import xla_cumsum  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 on both sides: encoder output, alphas, acoustic embeddings, logits
ATOL = 1e-5
JCFG, TCFG = jp.ParaformerConfig.test_tiny(), tp.ParaformerConfig.test_tiny()
CONVERTED = os.path.join(ROOT, "tests", "data", "paraformer_parity_converted.npz")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def params():
    tree = jax.tree_util.tree_map(np.asarray, jp.init_params(jax.random.PRNGKey(3), JCFG))
    return tree, weights.paraformer_params(tree, "cpu")


def _feats(t, seed=0):
    return np.random.default_rng(seed).standard_normal((1, t, JCFG.input_size)).astype(np.float32)


def _stages_jax(tree, feats, n):
    p = jax.tree.map(jnp.asarray, tree)
    t = feats.shape[1]
    mask = (jnp.arange(t)[None, :] < n).astype(jnp.float32)[..., None]
    enc = jp.encode(p, JCFG, jnp.asarray(feats), mask)
    alphas = jp.cif_alphas(p, JCFG, enc, mask)
    acoustic, n_tokens = jp.cif_fire(enc, alphas, JCFG)
    tgt = (jnp.arange(JCFG.max_tokens)[None, :] < n_tokens[:, None]).astype(jnp.float32)[..., None]
    logits = jp.decode(p, JCFG, acoustic * tgt, tgt, enc, mask)
    return [np.asarray(x) for x in (enc, alphas, acoustic, n_tokens, logits)]


def _stages_port(p, feats, n, want=None):
    """The port's stages chained, or, given *want* (the JAX stages'
    outputs), each stage on the JAX package's output of the stage before."""
    t = feats.shape[1]
    mask = (torch.arange(t)[None, :] < n).float()[..., None]
    enc = tp.encode(p, TCFG, _t(feats), mask)
    enc_in = enc if want is None else _t(want[0])
    alphas = tp.cif_alphas(p, TCFG, enc_in, mask)
    acoustic, n_tokens = tp.cif_fire(enc_in, alphas if want is None else _t(want[1]), TCFG)
    acoustic_in, n_in = (acoustic, n_tokens) if want is None else (_t(want[2]), _t(want[3]))
    tgt = (torch.arange(TCFG.max_tokens)[None, :] < n_in[:, None]).float()[..., None]
    logits = tp.decode(p, TCFG, acoustic_in * tgt, tgt, enc_in, mask)
    return [x.numpy() for x in (enc, alphas, acoustic, n_tokens, logits)]


@pytest.mark.parametrize("t,n", [(20, 20), (32, 32), (32, 13)])
def test_stages_match_jax(params, t, n):
    tree, p = params
    want = _stages_jax(tree, _feats(t), n)
    got = _stages_port(p, _feats(t), n, want)  # each stage on the JAX package's inputs to it
    for name, a, b in zip(("encode", "cif_alphas", "acoustic"), got[:3], want[:3]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[4], want[4], atol=ATOL, rtol=0, err_msg="decode logits")


@pytest.mark.parametrize("n", [6, 19, 32])
def test_forward_ids_and_count_equal_jax_and_padding_changes_nothing(params, n):
    tree, p = params
    feats = _feats(JCFG.max_frames, seed=n)
    ids, cnt = jp.forward(jax.tree.map(jnp.asarray, tree), JCFG, jnp.asarray(feats), jnp.asarray([n], jnp.int32))
    got_ids, got_n = tp.forward(p, TCFG, _t(feats), torch.tensor([n], dtype=torch.int32))
    assert int(got_n[0]) == int(cnt[0]) > 0
    k = int(cnt[0])
    np.testing.assert_array_equal(got_ids[0, :k].numpy(), np.asarray(ids[0, :k]))
    # what lies past the valid frames does not reach the result
    noisy = feats.copy()
    noisy[0, n:] = 1e3
    again, again_n = tp.forward(p, TCFG, _t(noisy), torch.tensor([n], dtype=torch.int32))
    assert int(again_n[0]) == k and torch.equal(again[0, :k], got_ids[0, :k])
    assert tp.transcribe_tokens(p, TCFG, _t(feats[0, :n]), n) == [int(x) for x in np.asarray(ids[0, :k])]


@pytest.mark.parametrize("n", [1, 16, 17, 33, 129, 513])
def test_cif_prefix_sum_is_the_jax_packages(n):
    x = np.random.default_rng(n).uniform(0, 1, (2, n)).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(xla_cumsum(_t(x)[..., None])[..., 0].numpy(), want)


@pytest.mark.parametrize("t", [1, 5, 6, 7, 100, 301])
def test_lfr_cmvn_on_the_device_equals_the_numpy_frontend(t):
    rng = np.random.default_rng(t)
    fbank = rng.standard_normal((t, 80)).astype(np.float32)
    mean = rng.standard_normal(560).astype(np.float32)
    scale = rng.uniform(0.5, 2, 560).astype(np.float32)
    np.testing.assert_array_equal(tp.lfr_cmvn(_t(fbank), _t(mean), _t(scale)).numpy(),
                                  jp.lfr_cmvn(fbank, mean, scale))
    np.testing.assert_array_equal(tp.lfr_cmvn(_t(fbank)).numpy(), jp.lfr_cmvn(fbank))


def _fixture():
    fx = np.load(os.path.join(ROOT, "tests", "data", "paraformer_parity.npz"))
    return fx, {k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}


def test_fixture_through_the_jax_converter():
    """The twin's bounds are the JAX package's own (``test_torch_parity``)."""
    fx, sd = _fixture()
    tree = jp.convert_state_dict(sd, JCFG)
    p = weights.paraformer_params(tree, "cpu")
    t = fx["feats"].shape[1]
    got = _stages_port(p, fx["feats"], t)
    want = _stages_jax(tree, fx["feats"], t)
    n_ref = fx["acoustic"].shape[1]
    assert int(got[3][0]) == int(want[3][0]) == n_ref
    np.testing.assert_allclose(got[0], fx["enc"], atol=3e-5)
    np.testing.assert_allclose(got[2][:, :n_ref], fx["acoustic"], atol=3e-5)
    np.testing.assert_allclose(got[4][:, :n_ref], fx["logits"], atol=2e-4)
    staged = _stages_port(p, fx["feats"], t, want)
    for a, b in zip(staged[:3] + staged[4:], want[:3] + want[4:]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    buf = np.zeros((1, TCFG.max_frames, TCFG.input_size), np.float32)
    buf[0, :t] = fx["feats"][0]
    ids, n = tp.forward(p, TCFG, _t(buf), torch.tensor([t], dtype=torch.int32))
    assert int(n[0]) == n_ref
    np.testing.assert_array_equal(ids[0, :n_ref].numpy(), np.argmax(fx["logits"], -1)[0])


def test_handler_transcribes_the_same_ids_as_the_jax_handler(params):
    import threading
    from queue import Queue

    from s2s_tpu.stt.paraformer_handler import ParaformerSTTHandler as JaxParaformer
    from s2s_tpu_torch.stt.paraformer_handler import ParaformerSTTHandler

    tree, p = params
    jh = JaxParaformer(threading.Event(), Queue(), Queue(),
                       setup_kwargs=dict(model_size="tiny", params=jax.tree.map(jnp.asarray, tree)))
    th = ParaformerSTTHandler(threading.Event(), Queue(), Queue(),
                              setup_kwargs=dict(model_size="tiny", params=p, device="cpu"))
    assert th.language == jh.language == "zh"
    for n, seed in ((21_000, 8), (5_000, 9)):
        audio = (0.2 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)
        want, got = jh.transcribe_fn(audio), th.transcribe_fn(audio)
        assert want.text and got.text == want.text and got.language_code == "zh"


def test_init_params_draws_the_jax_tree():
    p = tp.init_params(TCFG, torch.Generator().manual_seed(0))
    ref = weights.paraformer_params(
        jax.tree_util.tree_map(np.asarray, jp.init_params(jax.random.PRNGKey(0), JCFG)), "cpu")
    shapes = {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype) for k, v in jax.tree_util.tree_leaves_with_path(p)}
    assert shapes == {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype)
                      for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    assert tp.ParaformerConfig().d_model == 512 and tp.ParaformerConfig().n_enc == 50


def converted_fixture() -> dict[str, np.ndarray]:
    """The twin through the JAX converter, flattened as a converted
    checkpoint under ``tree/``, beside the fixture's inputs and outputs
    under ``fx/``."""
    from scripts.convert_checkpoint import flatten

    fx, sd = _fixture()
    out = flatten({"tree": jax.tree_util.tree_map(np.asarray, jp.convert_state_dict(sd, JCFG))})
    out.update({f"fx/{k}": fx[k] for k in ("feats", "enc", "acoustic", "logits")})
    return out


def test_converted_fixture_file_is_the_jax_converters_output():
    stored, want = np.load(CONVERTED), converted_fixture()
    assert sorted(stored.files) == sorted(want)
    for key, value in want.items():
        assert stored[key].dtype == value.dtype, key
        np.testing.assert_array_equal(stored[key], value, err_msg=key)


if __name__ == "__main__":
    np.savez(CONVERTED, **converted_fixture())
