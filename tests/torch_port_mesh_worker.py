"""One rank of the gloo meshes that ``tests/test_torch_port_mesh.py`` runs.

``python tests/torch_port_mesh_worker.py DIR RANK WORLD PORT``: joins the
process group at ``tcp://localhost:PORT``, reads the tiny tree, the batch
and the configuration from ``DIR/inputs.npz`` (written by the test), and
on ("data", "model") meshes of WORLD // 2 x 2 and 1 x WORLD takes the
sharded loss and two sharded AdamW steps, with the placements of the
parameters they leave; on the first also every leaf's placements and a
quantized tree's; and the shapes ``make_mesh`` derives.
Rank 0 writes ``DIR/outputs.npz`` (each mesh's parameters, mu and nu after
the steps, in full) and ``DIR/outputs.json``.  Imports no ``jax``.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard
from torch.utils import _pytree as pytree

from s2s_tpu_torch.models import decoder_lm
from s2s_tpu_torch.ops.quant import QUANT_TYPES, quantize_tree
from s2s_tpu_torch.parallel import training
from s2s_tpu_torch.parallel.mesh import make_mesh, shard_params


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = torch.from_numpy(value)
    return tree


def flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def spec_of(t) -> list:
    """The PartitionSpec a DTensor's placements stand for: per tensor dim the
    mesh axis it is split over, None elsewhere."""
    spec = [None] * t.ndim
    for axis, placement in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(placement, Shard):
            spec[placement.dim] = axis
    return spec


def main(out_dir: str, rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    inputs = dict(np.load(f"{out_dir}/inputs.npz"))
    fields = json.loads(str(inputs.pop("cfg")))
    cfg = decoder_lm.DecoderLMConfig(**{**fields, "dtype": getattr(torch, fields["dtype"])})
    batch = {k: torch.from_numpy(inputs.pop(k)) for k in ("tokens", "targets", "mask")}
    params = unflatten(inputs)
    shapes = {"default": make_mesh(device_type="cpu").mesh.shape,
              "data2": make_mesh(data=2, device_type="cpu").mesh.shape,
              "model4": make_mesh(model=world, device_type="cpu").mesh.shape}
    try:
        make_mesh(data=3, model=2, device_type="cpu")
        shapes["3x2"] = "built"
    except ValueError as e:
        shapes["3x2"] = str(e)
    mesh = make_mesh(data=world // 2, model=2, device_type="cpu")

    specs = decoder_lm.param_shardings(cfg)
    sharded = shard_params(params, specs, mesh)
    leaf_specs = {k: spec_of(v) for k, v in flat(sharded).items()}

    qtree = shard_params(quantize_tree(params, min_size=1), specs, mesh)
    quant_specs = {k: {"q": spec_of(v[0]), "scale": spec_of(v.scale), "scale_shape": list(v.scale.shape)}
                   for k, v in flat(qtree).items() if isinstance(v, QUANT_TYPES)}

    runs, arrays = {}, {}
    # the 2 x 2 mesh splits the kv heads evenly; on 1 x 4 the model axis
    # outnumbers them, so attention keeps its heads whole there
    grids = {f"{world // 2}x2": mesh, f"1x{world}": make_mesh(data=1, model=world, device_type="cpu")}
    for name, grid in grids.items():
        loss = decoder_lm.loss_fn(shard_params(params, specs, grid), cfg, batch["tokens"], batch["targets"],
                                  batch["mask"]).full_tensor()
        init_fn, run_step = training.make_sharded_train_step(cfg, grid)
        state = init_fn(params=params)
        losses = []
        for _ in range(2):
            step_loss, state = run_step(state, batch["tokens"], batch["targets"], batch["mask"])
            losses.append(float(step_loss))
        runs[name] = {"loss": float(loss), "losses": losses, "step": int(state.step),
                      "count": int(state.opt_state.count), "mesh": list(grid.mesh.shape),
                      "step_specs": {k: spec_of(v) for k, v in flat(state.params).items()}}
        for part, tree in (("params", state.params), ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
            full = pytree.tree_map(lambda t: t.full_tensor(), tree)
            arrays.update({f"{name}/{part}/{k}": v.numpy() for k, v in flat(full).items()})
    if rank == 0:
        np.savez(f"{out_dir}/outputs.npz", **arrays)
        with open(f"{out_dir}/outputs.json", "w") as f:
            json.dump({"runs": runs, "dims": mesh.mesh_dim_names,
                       "shapes": {k: v if isinstance(v, str) else list(v) for k, v in shapes.items()},
                       "leaf_specs": leaf_specs, "quant_specs": quant_specs}, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
