"""Parity: the port's SigLIP tower and its vision-language LLM stage against
the JAX package, on the CPU.

- ``encode_image`` at ``VisionConfig.test_tiny()`` (f32 on both sides, so
  the flash path's plain version and the JAX einsum agree) within
  ``ATOL`` of JAX from an ``init_params`` tree carried across with
  ``weights.vision_params``; the full tower's NaViT position ids start
  ``[0, 0, 1, 2]`` per side, as the JAX package computes them.
- ``tests/data/smolvlm_parity.npz`` (transformers' SmolVLM) through the JAX
  converters: the tower within the JAX package's bound of transformers'
  image features and within ``ATOL`` of JAX, then the merged forward (the
  image features spliced at the image-token span) through
  ``decoder_lm.prefill_embeds`` at every prefix length
  (``chip_smoke.merged_logits``, which the card's parity phase runs): the
  logits within
  the JAX package's bound of transformers' and the same argmax.
- The stage at the tiny LM and tower (as ``tests/test_vlm.py`` sets them):
  with a PNG data URL the port's greedy text equals the JAX handler's; the
  consumed image is stripped from history; a turn without an image is the
  parent's generation and never runs the tower; an undecodable image is
  logged and skipped, as in the JAX package.
- ``chip_smoke.png_bytes`` (the PNGs the card's serve sends) decodes to its
  pixels through the port's ``image_url_to_pil``, and the port's
  ``preprocess_image`` gives the JAX package's pixels for them.
- ``tests/data/smolvlm_parity_converted.npz`` (what ``chip_smoke.py``
  loads) equals the JAX converters' output on the fixture; ``python
  tests/test_torch_port_vision.py`` writes it.
"""

import base64
import io
import logging
import os
import threading
from queue import Queue

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402  (the merged forward and the PNG the card's phases use)
from s2s_tpu.models import decoder_lm as jdl  # noqa: E402
from s2s_tpu.models import vision as jv  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.llm.utils import image_url_to_pil  # noqa: E402
from s2s_tpu_torch.models import vision as tv  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: f32 on both sides: the tower's output
ATOL = 1e-5
#: the JAX package's bounds against transformers (``tests/test_torch_parity.py``)
HF_FEATS_ATOL, HF_LOGITS_ATOL = 2e-4, 3e-3
JCFG, TCFG = jv.VisionConfig.test_tiny(), tv.VisionConfig.test_tiny()
CONVERTED = os.path.join(ROOT, "tests", "data", "smolvlm_parity_converted.npz")
#: the fixture's text model (``tests/test_torch_parity.py``'s), as the card's parity phase builds it
LM_FIELDS = chip_smoke.SMOLVLM_LM


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(key):
    return jax.tree_util.tree_map(np.asarray, jv.init_params(jax.random.PRNGKey(key), JCFG))


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_image_matches_jax(seed):
    tree = _tree(seed)
    pixels = np.random.default_rng(seed).uniform(-1, 1, (1, JCFG.image_size, JCFG.image_size, 3)).astype(np.float32)
    want = np.asarray(jv.encode_image(jax.tree.map(jnp.asarray, tree), JCFG, jnp.asarray(pixels)))
    got = tv.encode_image(weights.vision_params(tree, "cpu"), TCFG, _t(pixels)).numpy()
    assert got.shape == (1, TCFG.n_image_tokens, TCFG.d_out)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_full_tower_position_ids_are_navit_buckets():
    cfg = tv.VisionConfig()
    ids = tv.position_ids(cfg, cfg.image_size // cfg.patch).reshape(32, 32)
    assert list(ids[0, :4]) == [0, 0, 1, 2] and ids[1, 0] == 0 and ids[2, 0] == 32
    assert cfg.n_image_tokens == 64 and cfg.head_dim == 64 and cfg.dtype == torch.bfloat16


def test_init_params_draws_the_jax_tree():
    p = tv.init_params(TCFG, torch.Generator().manual_seed(0))
    ref = weights.vision_params(_tree(0), "cpu")
    shapes = {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype) for k, v in jax.tree_util.tree_leaves_with_path(p)}
    assert shapes == {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype)
                      for k, v in jax.tree_util.tree_leaves_with_path(ref)}


def _fixture():
    fx = np.load(os.path.join(ROOT, "tests", "data", "smolvlm_parity.npz"))
    return fx, {k[4:]: fx[k] for k in fx.files if k.startswith("sd__")}


def _converted_trees():
    fx, sd = _fixture()
    text_sd = {k.replace("model.text_model.", "model."): v for k, v in sd.items()
               if k.startswith("model.text_model.")}
    lm = jdl.convert_hf_state_dict(text_sd, jdl.DecoderLMConfig(**LM_FIELDS, dtype=jnp.float32))
    return fx, jv.convert_hf_state_dict(sd, JCFG), lm


def test_smolvlm_fixture_merged_forward_through_prefill_embeds():
    fx, vtree, lm = _converted_trees()
    want_feats = np.asarray(jv.encode_image(jax.tree.map(jnp.asarray, vtree), JCFG,
                                            jnp.asarray(fx["pixels"].transpose(0, 2, 3, 1))))
    feats, logits = chip_smoke.merged_logits(weights.vision_params(vtree, "cpu"), weights.tree_to_torch(lm, "cpu"),
                                             _t(fx["pixels"]), _t(fx["ids"]))
    np.testing.assert_allclose(feats.numpy(), fx["img_feats"], atol=HF_FEATS_ATOL)
    np.testing.assert_allclose(feats.numpy(), want_feats, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), fx["logits"][0], atol=HF_LOGITS_ATOL)
    np.testing.assert_array_equal(np.argmax(logits.numpy(), -1), np.argmax(fx["logits"][0], -1))


def png_data_url(color=(255, 0, 0), size=32):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (size, size), color).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _handlers(max_new=8):
    from s2s_tpu.llm.vlm_backend import VisionLocalJAXLLMHandler
    from s2s_tpu_torch.llm.vlm_backend import VisionLocalTorchLLMHandler

    lm = jdl.init_params(jax.random.PRNGKey(4), jdl.DecoderLMConfig.tiny())
    vtree = _tree(1)
    common = dict(model_size="tiny", max_new_tokens=max_new, gen_kwargs={"decode_chunk_tokens": 3})
    jh = VisionLocalJAXLLMHandler(threading.Event(), Queue(), Queue(), setup_kwargs=dict(
        params=lm, vision_config=JCFG, vision_params=jax.tree.map(jnp.asarray, vtree), **common))
    th = VisionLocalTorchLLMHandler(threading.Event(), Queue(), Queue(), setup_kwargs=dict(
        params=weights.tree_to_torch(lm, "cpu"), vision_config=TCFG, vision_params=weights.vision_params(vtree, "cpu"),
        device="cpu", **common))
    return jh, th


def _image_chat(*urls):
    return [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": [{"type": "input_text", "text": "what is in this image"},
                                         *({"type": "input_image", "image_url": u} for u in urls)]}]


@pytest.mark.parametrize("colors", [[(255, 0, 0)], [(0, 90, 200), (10, 250, 30)]])
def test_greedy_text_with_images_equals_the_jax_handler(colors):
    jh, th = _handlers()
    chat = _image_chat(*(png_data_url(c) for c in colors))
    want = list(jh._jax_generate(chat))
    assert want and list(th._jax_generate(chat)) == want


def test_consumed_image_is_stripped_from_history():
    from s2s_tpu_torch.pipeline.messages import EndOfResponse, GenerateResponseRequest
    from s2s_tpu_torch.realtime.config import RuntimeConfig
    from s2s_tpu_torch.realtime.types import InputImageContent, InputTextContent, MessageItem

    _, th = _handlers(max_new=6)
    rc = RuntimeConfig()
    rc.chat.add_item(MessageItem(role="user", content=[InputTextContent(text="what is in this image"),
                                                       InputImageContent(image_url=png_data_url())]))
    assert rc.chat.image_message_ids()
    outs = list(th.process(GenerateResponseRequest(runtime_config=rc)))
    assert isinstance(outs[-1], EndOfResponse) and outs[-1].error is None
    assert rc.chat.image_message_ids() == set()


def test_text_only_turn_is_the_parents_and_runs_no_tower(monkeypatch):
    from s2s_tpu_torch.llm.local_backend import LocalTorchLLMHandler

    _, th = _handlers()

    def no_tower(*args, **kwargs):
        raise AssertionError("the tower ran on a text-only turn")

    monkeypatch.setattr(tv, "encode_image", no_tower)
    chat = [{"role": "user", "content": "hello there"}]
    want = list(LocalTorchLLMHandler._jax_generate(th, chat))
    assert want and list(th._jax_generate(chat)) == want


def test_undecodable_image_is_logged_and_skipped(caplog):
    jh, th = _handlers()
    chat = _image_chat("data:image/png;base64,bm90IGEgcG5n")
    with caplog.at_level(logging.ERROR):
        got = list(th._jax_generate(chat))
    assert "Failed to decode input_image; skipping" in caplog.text
    assert got == list(jh._jax_generate(chat))


def test_chip_smoke_png_decodes_to_its_pixels():
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (40, 24, 3), dtype=np.uint8)
    url = "data:image/png;base64," + base64.b64encode(chip_smoke.png_bytes(rgb)).decode()
    np.testing.assert_array_equal(np.asarray(image_url_to_pil(url).convert("RGB")), rgb)
    for color in ("red", "green", "blue"):
        img = image_url_to_pil(chip_smoke.image_url(color=color))
        assert img.size == (chip_smoke.IMAGE_SIDE,) * 2
        np.testing.assert_array_equal(tv.preprocess_image(img, 32), jv.preprocess_image(img, 32))


def converted_fixture() -> dict[str, np.ndarray]:
    """The fixture's tower and text model through the JAX converters,
    flattened as converted checkpoints under ``vision/`` and ``lm/``, beside
    its inputs and outputs under ``fx/``."""
    from scripts.convert_checkpoint import flatten

    fx, vtree, lm = _converted_trees()
    out = flatten({"vision": jax.tree_util.tree_map(np.asarray, vtree), "lm": jax.tree_util.tree_map(np.asarray, lm)})
    out.update({f"fx/{k}": fx[k] for k in ("pixels", "ids", "img_feats", "logits")})
    return out


def test_converted_fixture_file_is_the_jax_converters_output():
    stored, want = np.load(CONVERTED), converted_fixture()
    assert sorted(stored.files) == sorted(want)
    for key, value in want.items():
        assert stored[key].dtype == value.dtype, key
        np.testing.assert_array_equal(stored[key], value, err_msg=key)


if __name__ == "__main__":
    np.savez(CONVERTED, **converted_fixture())
