"""Mesh construction and parameter placement (port of ``s2s_tpu/parallel/mesh.py``).

One weight set sharded over a ``("data", "model")`` mesh: batches split
along ``data``, tensor-parallel layers along ``model``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` and parameters are DTensors;
a :class:`~s2s_tpu_torch.models.common.PartitionSpec` (``P``) names, per
tensor dim, the mesh axis it is split over, as JAX's does, and
:func:`placements` turns it into DTensor placements.  DTensor's operators
insert the collectives.  That is the training path.

Tensor-parallel serving (``--model_parallel N``) takes no DTensor: each
rank is a process holding its shard as plain tensors (:func:`local_shard`),
and the serving programs issue two collectives explicitly through a
:class:`TPGroup`: a sum (``all_reduce``, in f32) after the row-parallel
projections and to gather the vocabulary-split logits and embedding rows,
and a broadcast of the leader's commands.  :class:`TPRuntime` starts one
rank's groups; :class:`TPLayout` says where each rank runs.
"""

from __future__ import annotations

import datetime
import gc
import json
import logging
import pickle
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

from s2s_tpu_torch.models.common import P, PartitionSpec
from s2s_tpu_torch.ops.quant import QUANT_TYPES, Quant4Weight, slice_rows4

logger = logging.getLogger(__name__)

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
    from torch.distributed.device_mesh import DeviceMesh  # the DTensor path's, imported where it is used

    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, np.asarray(devs).reshape(data, model).tolist(), mesh_dim_names=AXES)


def placements(mesh: DeviceMesh, spec: PartitionSpec) -> list:
    """DTensor placements of *spec* on *mesh*: per mesh axis, ``Shard(d)``
    for the tensor dim *d* that names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

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
    from torch.distributed.tensor import distribute_tensor

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
    """The scheduler-facing seam of the JAX package; returns *module*
    unchanged, and no scheduler of the port calls it.

    The JAX package wraps *module* in a lock when *params* are sharded over
    XLA:CPU's virtual devices: its in-process collectives run each partition
    on a device thread with a FIFO queue, and two programs dispatched
    concurrently can enqueue in opposite orders and deadlock.  The port's
    tensor-parallel engines take its place with their mirror
    (``session_scheduler``'s ``_run`` and ``follow``): each rank is a
    process of its own, every program is dispatched from one engine thread
    on each rank in the leader's order, and each engine has its own groups
    (and, on the card, its own stream), so the two engines' collectives
    never share a queue."""
    return module


# ── tensor-parallel serving (--model_parallel) ───────────────────────


def _local_scale_spec(weight_spec, q_ndim: int) -> PartitionSpec:
    """A quantization scale's spec on one rank: the weight's spec without
    its input dim (the scale is per output channel, per layer when stacked).
    Unlike :func:`_scale_spec`, a stacked weight's (L, out) scale follows
    its columns: a rank's shard needs its own columns' scales, where JAX
    slices a replicated global scale."""
    parts = list(weight_spec) + [None] * (q_ndim - len(weight_spec))
    del parts[q_ndim - 2]
    return P(*parts)


def _shard_dims(t: torch.Tensor, spec, rank: int, n: int, payload4: bool = False) -> torch.Tensor:
    """Rank *rank*'s slice of *t* on every dim that *spec* names "model"; a
    dim that *n* does not divide stays whole.  A packed int4 payload
    (*payload4*) split on its input dim is unpacked, sliced on K and
    re-packed (:func:`~s2s_tpu_torch.ops.quant.slice_rows4`).  Returns *t*
    itself when nothing is split, else a contiguous copy."""
    out = t
    for dim, part in enumerate(spec):
        if part != "model":
            continue
        if payload4 and dim == t.dim() - 2:
            k = 2 * t.shape[dim]
            if k % n or (k // n) % 2:
                raise ValueError(f"packed int4 rows {k} do not split into {n} even shards")
            w = k // n
            out = slice_rows4(out, rank * w, (rank + 1) * w)
            continue
        size = out.shape[dim]
        if size % n:
            continue
        w = size // n
        out = out.narrow(dim, rank * w, w)
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def local_shard(params, specs, rank: int, n: int):
    """Rank *rank*'s slice of a parameter tree under a PartitionSpec tree,
    over *n* ranks on "model" (the serving counterpart of
    :func:`shard_params`): plain tensors, each split dim narrowed to its
    ``1/n`` block, a dim that *n* does not divide whole on every rank.
    Quantized leaves split as a unit: the payload by the weight's spec
    (packed int4 re-packed when its input dim splits), the scale by
    :func:`_local_scale_spec`."""

    def shard(p, s):
        if isinstance(p, QUANT_TYPES):
            q, scale = p
            return type(p)(_shard_dims(q, s, rank, n, payload4=isinstance(p, Quant4Weight)),
                           _shard_dims(scale, _local_scale_spec(s, q.dim()), rank, n))
        return _shard_dims(p, s, rank, n)

    return pytree.tree_map(shard, params, specs, is_leaf=lambda x: isinstance(x, QUANT_TYPES))


#: the engines that can run tensor-parallel, in the order every rank starts their groups
TP_ENGINES = ("lm", "tts")
#: the sums' transports: NCCL's all_reduce (one card a rank), or gloo through host memory (ranks may share a
#: card, or run on the CPU; see :meth:`TPGroup.all_reduce`)
TRANSPORTS = ("nccl", "gloo")


@dataclass(frozen=True)
class TPLayout:
    """Where the ranks of a tensor-parallel serve run: rank r on
    ``devices[r]``, its collectives over *transport* (:data:`TRANSPORTS`).
    The default is :func:`tp_layout`'s; two ranks on ``cuda:0`` over gloo
    rehearse the serve on one card, two on ``cpu`` test it."""

    devices: tuple[str, ...]
    transport: str = "nccl"

    def __post_init__(self) -> None:
        if self.transport not in TRANSPORTS:
            raise ValueError(f"TP transport {self.transport!r}; expected one of {TRANSPORTS}")
        if self.transport == "nccl" and len(set(self.devices)) < len(self.devices):
            raise ValueError(f"NCCL takes one card a rank: {self.devices}")

    @property
    def size(self) -> int:
        return len(self.devices)


def tp_layout(n: int, device: torch.device) -> TPLayout:
    """``--model_parallel n``'s layout: rank r on ``cuda:r`` over NCCL.
    Raises, as the JAX registry does, when fewer than *n* devices are
    visible (the CPU counts as one)."""
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    if visible < n:
        raise RuntimeError(f"--model_parallel {n} needs {n} devices; {visible} visible ({device.type}). "
                           f"Provision {n} cards, or drop --model_parallel.")
    return TPLayout(tuple(f"cuda:{r}" for r in range(n)), "nccl")


_HEARTBEAT = "__tp_heartbeat__"


class TPGroup:
    """One engine's tensor-parallel group on one rank: its collectives
    (``all_reduce``, ``gather_last``) on the layout's transport and its
    command channel (``broadcast``, gloo on the CPU).  ``collectives``
    counts the sums issued.

    Every sum runs in f32: a partial in the activations' dtype is widened,
    summed across ranks and cast back once.  So the row-parallel
    projections' outputs carry one more rounding than one device's (each
    rank's partial is rounded to the activations' dtype, then the sum is),
    and the embedding rows and the logits, whose other ranks add exact
    zeros, are exact.  Every rank ends with the same bits: both transports
    reduce each element once and send the result round."""

    def __init__(self, name: str, rank: int, size: int, device: torch.device, transport: str,
                 coll, cmd) -> None:
        self.name, self.rank, self.size, self.device, self.transport = name, rank, size, device, transport
        self._coll, self._cmd = coll, cmd
        self._send_lock = threading.Lock()
        self.last_send = time.monotonic()
        #: an engine runs on the group (it sets this); the heartbeat serves only such groups
        self.active = False
        self.closed = False
        self.collectives = 0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of *t* over the ranks (f32), in *t*'s dtype: the
        transport's allreduce (gloo's stages a tensor on the card through
        host memory)."""
        self.collectives += 1
        buf = t.float()
        self._coll.allreduce([buf], _sum_options()).wait()
        return buf.to(t.dtype)

    def gather_last(self, local: torch.Tensor, full: int) -> torch.Tensor:
        """Each rank's block of the last dim (rank r's at ``r * width``) in
        one zero-padded (..., full) buffer, summed: the whole of it on every
        rank, exact."""
        width = local.shape[-1]
        out = local.new_zeros(*local.shape[:-1], full)
        out[..., self.rank * width : (self.rank + 1) * width] = local
        return self.all_reduce(out)

    def broadcast(self, obj: Any = None) -> Any:
        """Rank 0 sends *obj* to every rank and returns it; another rank
        returns the next object rank 0 sent (heartbeats skipped)."""
        if self.rank == 0:
            self._send(obj)
            return obj
        while True:
            obj = self._recv()
            if not (isinstance(obj, str) and obj == _HEARTBEAT):
                return obj

    def heartbeat(self, idle_s: float) -> None:
        """Rank 0: send a heartbeat when nothing was sent for *idle_s*, so
        that an idle leader's followers do not reach their timeout."""
        if self.active and not self.closed and time.monotonic() - self.last_send >= idle_s:
            self._send(_HEARTBEAT)

    def _send(self, obj: Any) -> None:
        payload = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        with self._send_lock:
            if self.closed:
                raise RuntimeError(f"TP group {self.name!r} is closed")
            self._cmd.broadcast([torch.tensor([payload.numel()], dtype=torch.int64)], _root_options()).wait()
            self._cmd.broadcast([payload], _root_options()).wait()
            self.last_send = time.monotonic()
            if obj is None:
                self.closed = True

    def _recv(self) -> Any:
        size = torch.zeros(1, dtype=torch.int64)
        self._cmd.broadcast([size], _root_options()).wait()
        payload = torch.empty(int(size[0]), dtype=torch.uint8)
        self._cmd.broadcast([payload], _root_options()).wait()
        return pickle.loads(payload.numpy().tobytes())


def rank_report(device: torch.device) -> dict:
    """One rank's process-wide readings after a tensor-parallel run: the
    launches of the weight-only and attention kernels (their wrappers'
    counts) and the card's allocated bytes (now, after a garbage
    collection, and at peak)."""
    from s2s_tpu_torch.ops import decode_attention, int4_matmul, int8_matmul

    report = {"launches": {"int8_matmul": int8_matmul.int8_matmul.launches,
                           "int8_matmul_dyn": int8_matmul.int8_matmul_dyn.launches,
                           "int4_matmul": int4_matmul.int4_matmul.launches,
                           "decode_attention": decode_attention.concat_attention.launches}}
    if device.type == "cuda":
        gc.collect()
        torch.cuda.synchronize(device)
        report.update(allocated_bytes=torch.cuda.memory_allocated(device),
                      max_allocated_bytes=torch.cuda.max_memory_allocated(device))
    return report


def _sum_options():
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    return opts


def _root_options():
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    opts.rootTensor = 0
    return opts


#: a rank that waits this long in a collective or for a command fails (a
#: follower whose leader hung exits; an idle leader sends heartbeats sooner)
TP_TIMEOUT_S = 600.0


def _gloo(store, rank: int, size: int, timeout: datetime.timedelta):
    opts = dist.ProcessGroupGloo._Options()
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    opts._timeout = timeout
    return dist.ProcessGroupGloo(store, rank, size, opts)


class TPRuntime:
    """One rank's tensor-parallel groups: for each engine of
    :data:`TP_ENGINES`, in that order on every rank, a collective group on
    the layout's transport and a command group (gloo on the CPU), over a
    ``TCPStore`` on 127.0.0.1.  The groups are process groups of their own,
    outside ``torch.distributed``'s default group, so a serve's ranks never
    meet a process group the same process made for a mesh, and shutting
    them down leaves none behind.

    Rank 0 (the leader) sends a heartbeat on each open command group every
    ``timeout_s / 4`` seconds of silence; a follower whose leader is gone
    fails its next receive (the connection closes) or, if the leader hangs,
    after *timeout_s*.

    The groups are joined at the first :meth:`group` (or at once with
    *connect*): the leader builds what it needs alone while its followers
    start."""

    def __init__(self, rank: int, layout: TPLayout, store, timeout_s: float = TP_TIMEOUT_S,
                 connect: bool = True) -> None:
        self.rank, self.layout, self.size = rank, layout, layout.size
        self.device = torch.device(layout.devices[rank])
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.store = store
        self.timeout_s = timeout_s
        self.groups: dict[str, TPGroup] = {}
        self._connected = False
        self._close_lock = threading.Lock()
        self._closed = False
        #: the leader's engines (``attach``), its follower processes, and
        #: after ``close`` each follower's ``state_summary`` of each engine
        #: and its ``rank_report``
        self.engines: dict[str, Any] = {}
        self.procs: list = []
        self.follower_summaries: dict[str, dict[int, dict]] = {}
        self.follower_reports: dict[int, dict] = {}
        self._stop = threading.Event()
        self._beat = None
        if connect:
            self._connect()

    def _connect(self) -> None:
        if self._connected:
            return
        self._connected = True
        timeout = datetime.timedelta(seconds=self.timeout_s)
        for name in TP_ENGINES:
            prefix = f"tp/{name}"
            if self.layout.transport == "nccl":
                opts = dist.ProcessGroupNCCL.Options()
                opts._timeout = timeout
                coll = dist.ProcessGroupNCCL(dist.PrefixStore(prefix + "/coll", self.store), self.rank, self.size,
                                             opts)
            else:
                coll = _gloo(dist.PrefixStore(prefix + "/coll", self.store), self.rank, self.size, timeout)
            cmd = _gloo(dist.PrefixStore(prefix + "/cmd", self.store), self.rank, self.size, timeout)
            self.groups[name] = TPGroup(name, self.rank, self.size, self.device, self.layout.transport, coll, cmd)
        if self.rank == 0:
            self._beat = threading.Thread(target=self._heartbeats, daemon=True, name="tp-heartbeat")
            self._beat.start()

    def group(self, name: str) -> TPGroup:
        self._connect()
        return self.groups[name]

    def attach(self, name: str, engine) -> None:
        """The leader: *engine* runs on group *name* (``close`` stops it)."""
        self.engines[name] = engine

    def summary_key(self, name: str, rank: int) -> str:
        return f"tp/summary/{name}/{rank}"

    def report_key(self, rank: int) -> str:
        return f"tp/report/{rank}"

    def _read(self, key: str):
        return json.loads(self.store.get(key)) if self.store.check([key]) else None

    def close(self, join_timeout_s: float = 60.0, abort: bool = False) -> None:
        """The leader's shutdown: stop each engine's driver, end the
        followers' loops, wait for the follower processes (killed past
        *join_timeout_s*, or at once with *abort*), read each follower's
        ``state_summary`` of each engine from the store, and shut the
        groups down.  Idempotent."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._close(join_timeout_s, abort)

    def _close(self, join_timeout_s: float, abort: bool) -> None:
        if not abort:
            self._connect()  # followers wait for the groups before anything else
            for engine in self.engines.values():
                engine.shutdown()
                engine.stop_followers()
        deadline = time.monotonic() + (0.0 if abort else join_timeout_s)
        for proc in self.procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.01))
            except Exception:  # noqa: BLE001 - subprocess.TimeoutExpired: it is killed below
                pass
            if proc.poll() is None:
                logger.warning("TP follower %s did not exit; killing it", proc.pid)
                proc.kill()
                proc.wait()
        for rank in range(1, self.size):
            for name in self.engines:
                summary = self._read(self.summary_key(name, rank))
                if summary is not None:
                    self.follower_summaries.setdefault(name, {})[rank] = summary
            report = self._read(self.report_key(rank))
            if report is not None:
                self.follower_reports[rank] = report
        self.procs = []
        self.shutdown()

    def consistent(self) -> dict[str, bool]:
        """After ``close``: per engine, whether every follower reported the
        leader's replicated state (positions, tokens or embeddings and
        contexts) bit for bit."""
        out = {}
        for name, engine in self.engines.items():
            mine = engine.state_summary()["replicated"]
            theirs = self.follower_summaries.get(name, {})
            out[name] = len(theirs) == self.size - 1 and all(s["replicated"] == mine for s in theirs.values())
        return out

    def _heartbeats(self) -> None:
        idle = self.timeout_s / 4
        while not self._stop.wait(min(idle, 30.0)):
            for group in self.groups.values():
                try:
                    group.heartbeat(idle)
                except Exception:  # noqa: BLE001 - a closed or broken group: the engine's own sends report it
                    logger.debug("TP heartbeat on %s failed", group.name, exc_info=True)

    def shutdown(self) -> None:
        """Stop the heartbeats and shut every group down (idempotent).  An
        NCCL group is aborted, which each rank does alone: its graceful
        shutdown waits for the other ranks', and a follower shuts down while
        the leader waits for it to exit."""
        self._stop.set()
        if self._beat is not None:
            self._beat.join(timeout=5)
        for group in self.groups.values():
            group.closed = True
            for pg in (group._coll, group._cmd):
                stop = getattr(pg, "abort" if pg is group._coll and self.layout.transport == "nccl" else "shutdown",
                               None)
                if callable(stop):
                    try:
                        stop()
                    except Exception:  # noqa: BLE001
                        logger.debug("TP group %s shutdown failed", group.name, exc_info=True)
        self.groups = {}
