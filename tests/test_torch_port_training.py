"""Parity: the decoder LM's training path in s2s_tpu_torch against the JAX package.

Weights come from the JAX ``init_params`` and cross through
``s2s_tpu_torch.weights``; tokens come from a numpy seed.  On
``DecoderLMConfig.tiny()`` (f32) and a tiny ``qk_norm`` variant:

- ``forward`` / ``forward_embeds`` logits within 1e-4 * max|ref| (the
  decoder LM parity's bound: f32 sums in another order);
- ``loss_fn`` within rtol 1e-5, with a mask holding zeros and an all-zero
  mask;
- the gradient of every leaf against ``jax.grad(loss_fn)`` within 1e-4 *
  max|ref| of that leaf, and three ``sgd_train_step``s likewise;
- three AdamW steps of ``make_sharded_train_step`` on a 1 x 1 gloo mesh
  against JAX's on a 1-device mesh: each step's loss (rtol 1e-5), the
  parameters, optax's ``mu`` and ``nu`` (1e-4 * max|ref| a leaf) and the
  count.  In bf16 the same steps hold within ``BF16_ULPS`` bf16 ulps of
  max|ref| a leaf (1 for the parameters, 4 for mu, 8 for nu);
- ``convert_hf_state_dict`` bit-equal to the JAX converter.
"""

import dataclasses
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from s2s_tpu.models import decoder_lm as jdl  # noqa: E402
from s2s_tpu.parallel import mesh as jmesh  # noqa: E402
from s2s_tpu.parallel import training as jtraining  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import decoder_lm as tdl  # noqa: E402
from s2s_tpu_torch.parallel import training  # noqa: E402
from s2s_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

B, T = 4, 16
REL = 1e-4
#: the bf16 AdamW bounds, in bf16 ulps of a leaf's max|ref|: the gradients
#: come from another bf16 backward (products rounded in another order), so
#: mu, which carries g, holds within 4; nu carries g^2, which doubles g's
#: relative error; the parameters move by lr-sized steps, under an ulp
BF16_ULPS = {"params": 1, "mu": 4, "nu": 8}
CONFIGS = ["tiny", "qk_norm"]


def _cfgs(name: str, dtype: str = "float32"):
    extra = {"qk_norm": True} if name == "qk_norm" else {}
    jcfg = dataclasses.replace(jdl.DecoderLMConfig.tiny(), dtype=getattr(jnp, dtype), **extra)
    tcfg = dataclasses.replace(tdl.DecoderLMConfig.tiny(), dtype=getattr(torch, dtype), **extra)
    return jcfg, tcfg


def _models(name: str, dtype: str = "float32"):
    jcfg, tcfg = _cfgs(name, dtype)
    jp = jdl.init_params(jax.random.PRNGKey(3), jcfg)
    if name == "qk_norm":  # norm weights off 1, so the q/k norms reach the gradients
        jp["layers"]["q_norm"] = jp["layers"]["q_norm"] * 1.5
        jp["layers"]["k_norm"] = jp["layers"]["k_norm"] * 0.5
    return jcfg, jp, tcfg, weights.tree_to_torch(jp, "cpu")


def _batch(mask_kind: str = "tail"):
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    if mask_kind == "tail":
        mask[:, -3:] = 0
        mask[1, :5] = 0
    elif mask_kind == "zeros":
        mask[:] = 0
    return tokens, np.roll(tokens, -1, axis=1), mask


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _flat(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if hasattr(tree, "full_tensor"):
        tree = tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _close_trees(ref, got, atol_of):
    ref, got = _flat(ref), _flat(got)
    assert ref.keys() == got.keys()
    for key in ref:
        assert ref[key].shape == got[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=atol_of(ref[key]), err_msg=key)


def _rel(x: np.ndarray) -> float:
    return REL * float(np.abs(x).max())


def _bf16_ulps(n: int):
    def atol(x: np.ndarray) -> float:
        top = float(np.abs(x).max())
        return n * (2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0 ** -133)

    return atol


@pytest.fixture(scope="module")
def cpu_mesh():
    """A 1 x 1 gloo mesh in this process (a process group of world size 1)."""
    started = not dist.is_initialized()
    yield make_mesh(device_type="cpu")
    if started and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_forward_embeds_match_jax(name):
    jcfg, jp, tcfg, tp = _models(name)
    tokens, _, _ = _batch()
    ref = np.asarray(jdl.forward(jp, jcfg, jnp.asarray(tokens)))
    got = tdl.forward(tp, tcfg, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (B, T, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_rel(ref))

    embeds = np.random.default_rng(5).standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    ref = np.asarray(jdl.forward_embeds(jp, jcfg, jnp.asarray(embeds)))
    got = tdl.forward_embeds(tp, tcfg, torch.from_numpy(embeds))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_rel(ref))


@pytest.mark.parametrize("mask_kind", ["ones", "tail", "zeros"])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_matches_jax(name, mask_kind):
    jcfg, jp, tcfg, tp = _models(name)
    batch = _batch(mask_kind)
    ref = float(jdl.loss_fn(jp, jcfg, *(jnp.asarray(a) for a in batch)))
    got = tdl.loss_fn(tp, tcfg, *_torch(*batch))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)
    if mask_kind == "zeros":
        assert float(got) == ref == 0.0


@pytest.mark.parametrize("name", CONFIGS)
def test_gradients_of_every_leaf_match_jax(name):
    jcfg, jp, tcfg, tp = _models(name)
    batch = _batch()
    ref = jax.grad(jdl.loss_fn)(jp, jcfg, *(jnp.asarray(a) for a in batch))
    before = _flat(tp)  # copies
    loss, got = tdl.value_and_grad(tp, tcfg, *_torch(*batch))
    _close_trees(ref, got, _rel)
    # the served tree is left as it was: no leaf turned to requires_grad, none written
    leaves = torch.utils._pytree.tree_leaves(tp)
    assert not any(p.requires_grad for p in leaves) and not loss.requires_grad
    assert all(np.array_equal(before[k], v) for k, v in _flat(tp).items())


@pytest.mark.parametrize("name", CONFIGS)
def test_three_sgd_steps_match_jax(name):
    jcfg, jp, tcfg, tp = _models(name)
    batch = _batch()
    for _ in range(3):
        jloss, jp = jdl.sgd_train_step(jp, jcfg, *(jnp.asarray(a) for a in batch), lr=1e-2)
        tloss, tp = tdl.sgd_train_step(tp, tcfg, *_torch(*batch), lr=1e-2)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _close_trees(jp, tp, _rel)


def _adamw_steps(name: str, dtype: str, mesh, steps: int = 3):
    """(JAX's states, the port's) after each of *steps* AdamW steps from the
    same parameters, and both sides' losses."""
    jcfg, jp, tcfg, tp = _models(name, dtype)
    batch = _batch()
    _, jstep = jtraining.make_sharded_train_step(jcfg, jmesh.make_mesh(jax.devices()[:1]))
    jstate = jtraining.TrainState(jp, jtraining.make_optimizer().init(jp), jnp.zeros((), jnp.int32))
    init_fn, tstep = training.make_sharded_train_step(tcfg, mesh)
    tstate = init_fn(params=tp)
    out = []
    for _ in range(steps):
        jloss, jstate = jstep(jstate, *(jnp.asarray(a) for a in batch))
        tloss, tstate = tstep(tstate, *_torch(*batch))
        # a host copy: the next JAX step donates this state
        out.append((float(jloss), float(tloss), jax.tree_util.tree_map(np.asarray, jstate), tstate))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_three_adamw_steps_match_jax(name, cpu_mesh):
    steps = _adamw_steps(name, "float32", cpu_mesh)
    for i, (jloss, tloss, jstate, tstate) in enumerate(steps, 1):
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        adam = jstate.opt_state[0]
        assert int(tstate.step) == int(jstate.step) == i
        assert tstate.opt_state.count.dtype == torch.int32 and int(tstate.opt_state.count) == int(adam.count) == i
        _close_trees(jstate.params, tstate.params, _rel)
        _close_trees(adam.mu, tstate.opt_state.mu, _rel)
        _close_trees(adam.nu, tstate.opt_state.nu, _rel)
    assert steps[-1][1] < steps[0][1]


def test_three_bf16_adamw_steps_match_jax(cpu_mesh):
    steps = _adamw_steps("tiny", "bfloat16", cpu_mesh)
    for jloss, tloss, jstate, tstate in steps:
        np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
        adam = jstate.opt_state[0]
        assert int(tstate.opt_state.count) == int(adam.count)
        assert all(leaf.dtype == torch.bfloat16 for leaf in torch.utils._pytree.tree_leaves(
            (tstate.params, tstate.opt_state.mu, tstate.opt_state.nu)))
        _close_trees(jstate.params, tstate.params, _bf16_ulps(BF16_ULPS["params"]))
        _close_trees(adam.mu, tstate.opt_state.mu, _bf16_ulps(BF16_ULPS["mu"]))
        _close_trees(adam.nu, tstate.opt_state.nu, _bf16_ulps(BF16_ULPS["nu"]))


def test_tree_to_torch_carries_an_optax_adam_state():
    jcfg, jp, _, _ = _models("tiny")
    jstate = jtraining.make_optimizer().init(jp)
    grads = jax.grad(jdl.loss_fn)(jp, jcfg, *(jnp.asarray(a) for a in _batch()))
    _, jstate = jtraining.make_optimizer().update(grads, jstate, jp)
    got = weights.tree_to_torch(jstate[0], "cpu")
    assert isinstance(got, training.ScaleByAdamState)
    assert got.count.dtype == torch.int32 and int(got.count) == 1
    for ref, leaf in ((jstate[0].mu, got.mu), (jstate[0].nu, got.nu)):
        ref, leaf = _flat(ref), _flat(leaf)
        assert ref.keys() == leaf.keys() and all(np.array_equal(ref[k], leaf[k]) for k in ref)


def test_scoring_agrees_with_prefill():
    """``forward(tokens)[:, p-1]`` is the served prefill's last logits."""
    _, _, tcfg, tp = _models("tiny")
    tokens, _, _ = _batch()
    p = 11
    full = tdl.forward(tp, tcfg, torch.from_numpy(tokens[:, :p]))
    state = tdl.init_decode_state(tcfg, B, max_t=T)
    served, _ = tdl.prefill(tp, tcfg, torch.from_numpy(tokens), state, p)
    np.testing.assert_allclose(full[:, p - 1].numpy(), served.numpy(), rtol=0, atol=_rel(served.numpy()))


def _hf_state_dict(cfg, rng: np.random.Generator) -> dict[str, np.ndarray]:
    hd, d = cfg.head_dim, cfg.d_model
    sd = {"model.embed_tokens.weight": rng.standard_normal((cfg.vocab_size, d)),
          "model.norm.weight": rng.standard_normal(d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": rng.standard_normal(d),
            p + "post_attention_layernorm.weight": rng.standard_normal(d),
            p + "self_attn.q_proj.weight": rng.standard_normal((cfg.n_heads * hd, d)),
            p + "self_attn.k_proj.weight": rng.standard_normal((cfg.n_kv_heads * hd, d)),
            p + "self_attn.v_proj.weight": rng.standard_normal((cfg.n_kv_heads * hd, d)),
            p + "self_attn.o_proj.weight": rng.standard_normal((d, cfg.n_heads * hd)),
            p + "mlp.gate_proj.weight": rng.standard_normal((cfg.d_ff, d)),
            p + "mlp.up_proj.weight": rng.standard_normal((cfg.d_ff, d)),
            p + "mlp.down_proj.weight": rng.standard_normal((d, cfg.d_ff)),
        })
        if cfg.qk_norm:
            sd[p + "self_attn.q_norm.weight"] = rng.standard_normal(hd)
            sd[p + "self_attn.k_norm.weight"] = rng.standard_normal(hd)
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = rng.standard_normal((cfg.vocab_size, d))
    return {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [*CONFIGS, "untied"])
def test_convert_hf_state_dict_is_bit_equal_to_jax(name, dtype):
    jcfg, tcfg = _cfgs("qk_norm" if name == "qk_norm" else "tiny", dtype)
    if name == "untied":
        jcfg, tcfg = (dataclasses.replace(c, tie_embeddings=False) for c in (jcfg, tcfg))
    sd = _hf_state_dict(jcfg, np.random.default_rng(2))
    ref = jdl.convert_hf_state_dict(sd, jcfg)
    got = tdl.convert_hf_state_dict(sd, tcfg)
    from_torch = tdl.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    ref_flat = {k: np.asarray(v) for k, v in _flat(ref).items()}
    for tree in (got, from_torch):
        flat = _flat(tree)
        assert flat.keys() == ref_flat.keys()
        assert all(leaf.dtype == tcfg.dtype for leaf in torch.utils._pytree.tree_leaves(tree))
        for key, value in ref_flat.items():
            np.testing.assert_array_equal(flat[key], value, err_msg=key)
    assert ("lm_head" in got) == (name == "untied")
    # the converted tree serves: the port's forward on it is the JAX forward on JAX's
    tokens, _, _ = _batch()
    if dtype == "float32":
        want = np.asarray(jdl.forward(ref, jcfg, jnp.asarray(tokens)))
        have = tdl.forward(got, tcfg, torch.from_numpy(tokens)).numpy()
        np.testing.assert_allclose(have, want, rtol=0, atol=_rel(want))
