"""s2s_tpu_torch.parallel.mesh on 2 x 2 and 1 x 4 ("data", "model") gloo meshes.

Four processes (``tests/torch_port_mesh_worker.py``) are spawned once for
the file, on a free port, with a time limit of their own; each holds the
tiny f32 tree (JAX ``init_params`` through ``weights.tree_to_torch``) and a
batch from a numpy seed.  The 2 x 2 mesh splits the tiny config's two kv
heads one a rank; on 1 x 4 the model axis outnumbers them.  Checked:

- the sharded loss equals the unsharded one and JAX's (rtol 1e-5, as
  ``tests/test_decoder_lm.py``'s virtual-mesh case), on both meshes;
- two sharded AdamW steps: ``loss2 <= loss1``, ``step == 2`` and the
  parameters of the one-process step (the port's AdamW on plain tensors)
  within 1e-4 * max|ref| a leaf;
- the same two steps against JAX's ``make_sharded_train_step`` on a
  virtual-device mesh of the same shape: the losses (rtol 1e-5), the
  parameters, optax's ``mu`` and ``nu`` (1e-4 * max|ref| a leaf) and the
  count;
- every leaf's placements follow ``decoder_lm.param_shardings``, before
  the steps and after them on both meshes, and a
  quantized tree's scales take ``_scale_spec``'s placements, which equal
  JAX's ``_scale_spec`` on the same specs;
- the shapes ``make_mesh`` derives, as JAX's.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from s2s_tpu.models import decoder_lm as jdl  # noqa: E402
from s2s_tpu.parallel import mesh as jmesh  # noqa: E402
from s2s_tpu.parallel import training as jtraining  # noqa: E402
from s2s_tpu_torch import weights  # noqa: E402
from s2s_tpu_torch.models import decoder_lm as tdl  # noqa: E402
from s2s_tpu_torch.ops.quant import QUANT_TYPES, quantize_tree  # noqa: E402
from s2s_tpu_torch.parallel import mesh, training  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_port_mesh_worker.py")
WORLD = 4
TIME_LIMIT_S = 120
B, T = 4, 16
#: mesh name -> (data, model)
MESHES = {"2x2": (2, 2), "1x4": (1, WORLD)}


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def model():
    cfg = jdl.DecoderLMConfig.tiny()
    jp = jdl.init_params(jax.random.PRNGKey(7), cfg)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[:, -2:] = 0
    return cfg, jp, (tokens, np.roll(tokens, -1, axis=1), mask)


@pytest.fixture(scope="module")
def mesh_run(model, tmp_path_factory):
    """The four ranks' results (rank 0's files), run once for the file."""
    cfg, jp, (tokens, targets, mask) = model
    out = tmp_path_factory.mktemp("mesh")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}
    tree = {k: v.numpy() for k, v in _flat(weights.tree_to_torch(jp, "cpu")).items()}
    np.savez(out / "inputs.npz", cfg=json.dumps({**fields, "dtype": "float32"}), tokens=tokens, targets=targets,
             mask=mask, **tree)
    port = _free_port()
    # one thread a rank: the four ranks share the host with the other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(out), str(rank), str(WORLD), str(port)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(WORLD)]
    deadline = time.monotonic() + TIME_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    result = json.loads((out / "outputs.json").read_text())
    result["arrays"] = dict(np.load(out / "outputs.npz"))
    return result


def _torch_batch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


@pytest.mark.parametrize("name", MESHES)
def test_sharded_loss_equals_unsharded_loss(model, mesh_run, name):
    cfg, jp, batch = model
    run = mesh_run["runs"][name]
    assert run["mesh"] == list(MESHES[name]) and mesh_run["dims"] == ["data", "model"]
    ref = float(jdl.loss_fn(jp, cfg, *(jnp.asarray(a) for a in batch)))
    plain = float(tdl.loss_fn(weights.tree_to_torch(jp, "cpu"), tdl.DecoderLMConfig.tiny(), *_torch_batch(batch)))
    np.testing.assert_allclose(run["loss"], plain, rtol=1e-5)
    np.testing.assert_allclose(run["loss"], ref, rtol=1e-5)


def _close(got: dict, ref: dict, prefix: str) -> None:
    """Every leaf of *ref* (flat, numpy) against ``got[prefix + key]``
    within 1e-4 * max|ref| of that leaf."""
    assert sorted(prefix + k for k in ref) == sorted(k for k in got if k.startswith(prefix))
    for key, value in ref.items():
        np.testing.assert_allclose(got[prefix + key], value, rtol=0, atol=1e-4 * np.abs(value).max(),
                                   err_msg=prefix + key)


def test_two_sharded_train_steps_equal_the_one_process_step(model, mesh_run):
    _, jp, batch = model
    cfg = tdl.DecoderLMConfig.tiny()
    run = mesh_run["runs"]["2x2"]
    loss1, loss2 = run["losses"]
    assert np.isfinite(loss1) and loss2 <= loss1
    assert run["step"] == 2 and run["count"] == 2
    tx = training.make_optimizer()
    params = weights.tree_to_torch(jp, "cpu")
    state = tx.init(params)
    losses = []
    for _ in range(2):
        loss, grads = tdl.value_and_grad(params, cfg, *_torch_batch(batch))
        with torch.no_grad():
            params, state = tx.update(grads, state, params)
        losses.append(float(loss))
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-5)
    _close(mesh_run["arrays"], {k: v.numpy() for k, v in _flat(params).items()}, "2x2/params/")


@pytest.mark.parametrize("name", MESHES)
def test_two_sharded_train_steps_match_the_jax_sharded_step(model, mesh_run, name):
    cfg, jp, batch = model
    data, model_axis = MESHES[name]
    jm = jmesh.make_mesh(jax.devices()[:WORLD], data=data, model=model_axis)
    # from host copies: the step donates the state, which must not take the fixture's arrays with it
    params = jmesh.shard_params(jax.tree_util.tree_map(np.asarray, jp), jdl.param_shardings(cfg), jm)
    state = jtraining.TrainState(params, jtraining.make_optimizer().init(params), jnp.zeros((), jnp.int32))
    _, run_step = jtraining.make_sharded_train_step(cfg, jm)
    losses = []
    for _ in range(2):
        loss, state = run_step(state, *(jnp.asarray(a) for a in batch))
        losses.append(float(loss))
    run = mesh_run["runs"][name]
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-5)
    adam = state.opt_state[0]
    assert run["step"] == int(state.step) == 2 and run["count"] == int(adam.count) == 2
    for part, tree in (("params", state.params), ("mu", adam.mu), ("nu", adam.nu)):
        _close(mesh_run["arrays"], {k: np.asarray(v) for k, v in _flat(tree).items()}, f"{name}/{part}/")


def _padded(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def test_every_leaf_is_placed_per_param_shardings(model, mesh_run):
    specs = _flat(tdl.param_shardings(tdl.DecoderLMConfig.tiny()))
    shapes = {k: v.shape for k, v in _flat(model[1]).items()}
    # as placed, and as the sharded steps leave them on each mesh
    for placed in (mesh_run["leaf_specs"], *(run["step_specs"] for run in mesh_run["runs"].values())):
        assert placed.keys() == specs.keys()
        for key, spec in specs.items():
            assert placed[key] == _padded(spec, len(shapes[key])), key


def test_quantized_leaves_take_the_scale_spec_of_jax(mesh_run):
    cfg = tdl.DecoderLMConfig.tiny()
    specs = _flat(tdl.param_shardings(cfg))
    quantized = mesh_run["quant_specs"]
    assert sorted(quantized) == sorted(k for k, v in _flat(quantize_tree(tdl.init_params(
        cfg, torch.Generator().manual_seed(0)), min_size=1)).items() if isinstance(v, QUANT_TYPES))
    for key, got in quantized.items():
        q_ndim = len(got["q"])
        assert got["q"] == _padded(specs[key], q_ndim), key
        want = jmesh._scale_spec(jax.sharding.PartitionSpec(*specs[key]), tuple(got["scale_shape"]), q_ndim)
        assert got["scale"] == _padded(want, len(got["scale_shape"])), key


def test_make_mesh_derives_shapes_as_jax(mesh_run):
    shapes = mesh_run["shapes"]
    assert shapes["default"] == [1, WORLD] and shapes["data2"] == [2, 2] and shapes["model4"] == [1, WORLD]
    assert shapes["3x2"] == f"mesh 3x2 != {WORLD} devices"


SPECS = [(), (None,), ("model",), (None, "model"), ("model", None), (None, None, "model"), (None, "model", None),
         ("data", None), ("data", "model")]
SCALES = [((64,), 2), ((2, 64), 3), ((2, 1, 64), 3), ((1, 64), 2), ((), 2)]


@pytest.mark.parametrize("spec,scale_shape,q_ndim", [(spec, shape, n) for spec in SPECS for shape, n in SCALES
                                                     if len(spec) <= n])
def test_scale_spec_equals_jax(spec, scale_shape, q_ndim):
    want = jmesh._scale_spec(jax.sharding.PartitionSpec(*spec), scale_shape, q_ndim)
    got = mesh._scale_spec(mesh.P(*spec), scale_shape, q_ndim)
    assert isinstance(got, mesh.PartitionSpec) and tuple(got) == tuple(want)


def test_placements_translate_specs():
    fake = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert mesh.placements(fake, mesh.P()) == [Replicate(), Replicate()]
    assert mesh.placements(fake, mesh.P("model", None)) == [Replicate(), Shard(0)]
    assert mesh.placements(fake, mesh.P(None, None, "model")) == [Replicate(), Shard(2)]
    assert mesh.placements(fake, mesh.P("data", None)) == [Shard(0), Replicate()]
    assert mesh.replicated(fake) == [Replicate(), Replicate()]
    assert mesh.data_sharded(fake, None) == [Shard(0), Replicate()]
    with pytest.raises(ValueError, match="'tensor' is not an axis"):
        mesh.placements(fake, mesh.P("tensor"))


def test_make_mesh_asks_for_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()


def test_serialize_programs_is_the_identity_seam():
    module = types.ModuleType("programs")
    assert mesh.serialize_programs_if_cpu_mesh(module, {"w": torch.zeros(2)}) is module
