"""Mesh construction and parameter placement (port of ``s2s_tpu/parallel/mesh.py``).

One weight set sharded over a ``("data", "model")`` mesh: batches split
along ``data``, tensor-parallel layers along ``model``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` and parameters are DTensors;
a :class:`~s2s_tpu_torch.models.common.PartitionSpec` (``P``) names, per
tensor dim, the mesh axis it is split over, as JAX's does, and
:func:`placements` turns it into DTensor placements.  DTensor's operators
insert the collectives.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils import _pytree as pytree

from s2s_tpu_torch.models.common import P, PartitionSpec
from s2s_tpu_torch.ops.quant import QUANT_TYPES

AXES = ("data", "model")


def make_mesh(devices: Sequence[int] | None = None, data: int | None = None, model: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """Build a ("data", "model") mesh over *devices*, the global ranks of the
    process group (default: every rank).  Defaults: all of them on the model
    axis (latency-oriented inference), unless shapes are given.

    Without a process group one of world size 1 is started here: nccl for
    tensors on the card, gloo for tensors on the CPU (the only backend
    where there is no card), so that meshes of both kinds work in one
    process.  Several processes start theirs first.  There is no fallback:
    asking for the card without one raises."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' for a CPU mesh")
    if not dist.is_initialized():
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    devs = list(devices if devices is not None else range(dist.get_world_size()))
    n = len(devs)
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model  # type: ignore[operator]
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, np.asarray(devs).reshape(data, model).tolist(), mesh_dim_names=AXES)


def placements(mesh: DeviceMesh, spec: PartitionSpec) -> list:
    """DTensor placements of *spec* on *mesh*: per mesh axis, ``Shard(d)``
    for the tensor dim *d* that names it, else ``Replicate()``."""
    names = mesh.mesh_dim_names
    for part in spec:
        if part is not None and part not in names:
            raise ValueError(f"{spec}: {part!r} is not an axis of the mesh {names}")
    return [next((Shard(d) for d, part in enumerate(spec) if part == axis), Replicate()) for axis in names]


def _scale_spec(weight_spec, scale_shape: tuple, q_ndim: int) -> PartitionSpec:
    """PartitionSpec for a quantization scale, derived from its weight's
    spec: same-rank scales keep the weight's sharding except on size-1
    (reduced) axes; rank-1 scales (per-output-channel, 2-D weights) take
    the weight's LAST axis sharding."""
    parts = list(weight_spec) + [None] * (q_ndim - len(weight_spec))
    if len(scale_shape) == q_ndim:
        return P(*[None if scale_shape[i] == 1 else parts[i] for i in range(q_ndim)])
    if len(scale_shape) == 1:
        return P(parts[-1])
    return P()


def shard_params(params, specs, mesh: DeviceMesh):
    """Place a parameter tree onto *mesh* per the PartitionSpec tree, each
    leaf a DTensor (on the mesh's device).

    Quantized leaves (``ops/quant.py`` Quant*Weight) are placed as a unit:
    the int8/int4 payload takes the weight's spec, the scale a spec derived
    from it (see :func:`_scale_spec`)."""

    def place(p, s):
        if isinstance(p, QUANT_TYPES):
            q, scale = p
            scale_spec = _scale_spec(s, tuple(scale.shape), q.ndim)
            return type(p)(distribute_tensor(q, mesh, placements(mesh, s)),
                           distribute_tensor(scale, mesh, placements(mesh, scale_spec)))
        return distribute_tensor(p, mesh, placements(mesh, s))

    return pytree.tree_map(place, params, specs, is_leaf=lambda x: isinstance(x, QUANT_TYPES))


def replicated(mesh: DeviceMesh) -> list:
    return placements(mesh, P())


def data_sharded(mesh: DeviceMesh, *trailing: Any) -> list:
    """Batch-dim sharded along "data"."""
    return placements(mesh, P("data", *trailing))


def serialize_programs_if_cpu_mesh(module, params):
    """The scheduler-facing seam; returns *module* unchanged.

    The JAX package wraps *module* in a lock when *params* are sharded over
    XLA:CPU's virtual devices: its in-process collectives run each partition
    on a device thread with a FIFO queue, and two programs dispatched
    concurrently can enqueue in opposite orders and deadlock.  Here each
    rank is a process of its own whose collectives (gloo or nccl) are issued
    in its program order, so there is no shared queue to cross."""
    return module
