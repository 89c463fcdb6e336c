"""The launch plan and launch of the int8 and int4 matmul kernels.

``csrc/int8_matmul.cu`` (W8A16) and ``csrc/int4_matmul.cu`` (packed W4A16)
instantiate one template, ``csrc/weight_only_matmul.cuh``, whose header says
how it works; ``csrc/int8_matmul_dyn.cu`` (W8A8 dynamic) is built on its
helpers and planned here as a third regime.  A weight format has ``planes``
weight rows per stored row: 1 for int8 (K, N), 2 for packed int4 (K/2, N),
whose stored row j carries rows j and j + K/2.

:func:`launch_plan` picks, from the shapes and the card's limits alone:

- the regime: for the weight-only kernels the CUDA cores below
  :data:`CUTOFF` rows, the tensor cores (bf16 ``wgmma``, 64-row tiles) from
  it to 64 rows; the W8A8 kernel is always :data:`W8A8` (int8 ``wgmma``,
  128-row K tiles, the rows rounded up to an s8 ``wgmma`` N);
- the column tile (TN columns per CTA) and the cluster size C (the CTAs that
  split one column tile's K and combine their sums in the one launch), so
  that the grid fills the card in one wave;
- the stages of weight in flight, and the shared bytes of a CTA.

:func:`split_ranges` gives each CTA of a cluster its stored rows, and
:func:`launch` runs a plan (the wrappers in ``int8_matmul`` and
``int4_matmul`` check the operands and count launches).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import torch

from s2s_tpu_torch.ops import _build

#: rows from which the tensor-core regime runs, by weight planes (fewer
#: rows take the CUDA cores): the crossover measured on an H100, where at 4
#: rows the CUDA cores win at most int8 shapes and lose at every int4 one,
#: and 3 rows take the 4-row tile (chip_smoke.py times the other regime at
#: every row up to 8, its ``other_regime``)
CUTOFF = {1: 5, 2: 3}
REGIMES = ("cuda-cores", "tensor-cores", "w8a8-tensor-cores")
#: the W8A8 kernel's regime (``w8a8::kRegime`` in ``csrc/int8_matmul_dyn.cu``)
W8A8 = 2
CLUSTER_SIZES = tuple(range(1, 9))
#: column tiles of each regime, widest first
TILES_N = {"cuda-cores": (256, 128, 64), "tensor-cores": (128,), "w8a8-tensor-cores": (128,)}
#: row tiles of the CUDA-core regime (a thread keeps RB x 16 f32 sums)
ROW_TILES = (1, 2, 4, 8)
#: the W8A8 kernel's rows: the N widths of s8 ``wgmma`` (PTX ISA) up to 64
W8A8_ROWS = (8, 16, 24, 32, 48, 64)
TILE_K = 64  # stored weight rows per stage of the weight-only regimes
#: K per stage of each regime: the W8A8 tiles are one 128-byte K-major row of int8
TILES_K = (TILE_K, TILE_K, 128)
#: weight bytes a CTA aims to keep in flight (one CTA per SM: about 3.35
#: TB/s x 0.7 us of latency / 132 SMs is 18 KB; this is more than twice that)
IN_FLIGHT = 48 * 1024
_GEMV_WARPS = 8
#: consumer warpgroups of the tensor-core regime, on alternate tiles, each
#: holding one stage while it converts and multiplies its tile
TC_GROUPS = 2
_X_BOX = TILE_K * 64 * 2  # one 64 x 64 bf16 box of x
#: int32 row stride of the W8A8 kernel's summed tile (``w8a8::kSumStride``)
_W8A8_SUM_STRIDE = 128 + 4


@dataclass(frozen=True)
class Plan:
    """One launch: ``regime`` (0 CUDA cores, 1 tensor cores, 2 W8A8),
    ``tile_n`` columns per CTA, ``cluster`` CTAs per column tile, ``stages``
    weight boxes in flight, ``rows`` (the row tile RB of regime 0, B rounded
    up to 8 in regime 1, to an s8 ``wgmma`` N in regime 2) and the dynamic
    shared ``bytes`` of a CTA:
    ``weight_only::Plan`` in ``csrc/weight_only_matmul.cuh``, field for
    field."""
    regime: int
    tile_n: int
    cluster: int
    stages: int
    rows: int
    bytes: int

    def grid(self, n: int) -> int:
        """CTAs of the launch for N columns."""
        return n // self.tile_n * self.cluster

    def describe(self) -> dict:
        return {"regime": REGIMES[self.regime], **dataclasses.asdict(self)}


def recv_bytes(rows: int, tile_n: int, cluster: int, sets: int) -> int:
    """The partial sums a CTA receives for its slice of the rows x tile_n
    outputs: ``sets`` from each of the ``cluster`` CTAs, a slice of
    ceil(rows * tile_n / 4 / cluster) float4s each."""
    return sets * cluster * -(-(rows * tile_n // 4) // cluster) * 16


def shared_bytes(regime: int, tile_n: int, rows: int, planes: int, kc: int, stages: int, cluster: int) -> int:
    """A CTA's dynamic shared memory, as the kernel lays it out
    (``gemv_layout`` / ``tc_layout``), with 1024 bytes of alignment slack.
    Regime 0: mbarriers (1 KB), the ring or the per-warp sums if larger, the
    bf16 x slice [planes][rows][kc], the received partials, the tile's
    scales.  Regime 1: per stage ``planes`` x boxes and the weight box (the
    ring then holds the warpgroups' f32 sums [rows][tile_n]); per
    consumer warpgroup (:data:`TC_GROUPS`) a bf16 weight buffer of
    ``planes`` tiles; the received partials (one per warpgroup of each
    CTA); the tile's scales; the mbarriers.  Regime 2 (``w8a8::layout``):
    per stage an x box (rows x 128 bf16) and the weight box (128 x tile_n
    int8), the ring then holding the warpgroups' int32 sums; per warpgroup a
    K-major weight tile and a K-major xq tile; the received partials (one
    per CTA); the partial maxima of 64 rows per CTA; 64 row scales; the
    rows' quotient tables (128 f32 each); the tile's scales; the
    mbarriers."""
    if regime == 0:
        ring = max(stages * TILE_K * tile_n, _GEMV_WARPS * rows * tile_n * 4)
        return 1024 + ring + planes * rows * kc * 2 + recv_bytes(rows, tile_n, cluster, 1) + tile_n * 4 + 1024
    if regime == W8A8:
        tk = TILES_K[W8A8]
        ring = -(-max(stages * (rows * tk * 2 + tk * tile_n), TC_GROUPS * rows * _W8A8_SUM_STRIDE * 4) // 1024) * 1024
        return (ring + TC_GROUPS * (tile_n + rows) * tk + recv_bytes(rows, tile_n, cluster, 1)
                + cluster * 64 * 4 + 64 * 4 + rows * 128 * 4 + tile_n * 4 + 16 * stages + 1024)
    ring = max(stages * (planes * _X_BOX + TILE_K * tile_n), TC_GROUPS * rows * tile_n * 4)
    return (ring + TC_GROUPS * planes * TILE_K * tile_n * 2 + recv_bytes(rows, tile_n, cluster, TC_GROUPS)
            + tile_n * 4 + 16 * stages + 1024)


def one_per_sm(smem_limit: int) -> int:
    """Shared bytes that leave room for one CTA per SM: more than half of
    what a block may use (an SM holds *smem_limit* plus 1 KB a block)."""
    return smem_limit // 2 + 1


def launch_plan(b: int, k: int, n: int, sms: int, smem_limit: int, planes: int = 1,
                regime: int | None = None, clusters: dict[int, int] | None = None) -> Plan:
    """The kernel's launch for x (b, k) against a (k / planes, n) weight on
    a card of *sms* SMs whose blocks may use *smem_limit* shared bytes
    (*regime* :data:`W8A8`: the W8A8 kernel's, int8 weights only).

    Every CTA takes at least :func:`one_per_sm` bytes, so one CTA holds an
    SM and *clusters* (cluster size C -> clusters of C such CTAs the card
    runs at once; by default ``sms // C``; an H100 runs fewer, 15 of 8)
    bounds a wave.  The regime is the tensor cores from :data:`CUTOFF` rows
    (*regime* forces one, to time the crossover).  Column tile and cluster:
    the largest grid (``n / tile_n * C`` CTAs) that runs in one wave, at the
    widest tile among equal grids; where even the smallest grid is larger,
    the smallest; only tiles whose shared memory fits count.  C is 1-8 and
    splits K into whole tiles of the regime's :data:`TILES_K` rows
    (:func:`split_ranges`), at least one a CTA.  Stages: enough
    for :data:`IN_FLIGHT` weight bytes (plus the stages the tensor-core
    warpgroups hold), at most the CTA's tiles, at least two where it has
    two; fewer where the shared memory does not hold them.  Reads shapes and
    limits only.  Raises where no plan fits."""
    clusters = clusters or {c: sms // c for c in CLUSTER_SIZES}
    if not (1 <= b <= 64 and k % planes == 0 and n % 64 == 0):
        raise ValueError(f"weight-only matmul: no plan for B={b}, K={k}, N={n}, planes={planes}")
    if regime is None:
        regime = int(b >= CUTOFF[planes])
    if regime == W8A8 and planes != 1:
        raise ValueError(f"weight-only matmul: the W8A8 kernel takes int8 weights, not {planes} planes")
    kr = k // planes
    tk = TILES_K[regime]
    if regime == W8A8:
        rows = next(r for r in W8A8_ROWS if r >= b)
    elif regime == 1:
        rows = -(-b // 8) * 8
    elif b <= ROW_TILES[-1]:
        rows = next(r for r in ROW_TILES if r >= b)
    else:
        raise ValueError(f"weight-only matmul: the CUDA-core regime takes at most {ROW_TILES[-1]} rows, not {b}")
    floor = 1 if regime == 0 else 2

    def fits(tn: int, c: int) -> bool:
        kc = tile_rows(kr, c, tk)
        return shared_bytes(regime, tn, rows, planes, kc, min(kc // tk, floor), c) <= smem_limit

    shapes = [(tn, c) for tn in TILES_N[REGIMES[regime]] if n % tn == 0
              for c in CLUSTER_SIZES if c <= kr // tk and fits(tn, c)]
    if not shapes:
        raise ValueError(f"weight-only matmul: B={b}, K={k}, N={n} (planes {planes}) fits no tile in "
                         f"{smem_limit} shared bytes a CTA")
    one_wave = [(tn, c) for tn, c in shapes if n // tn * c <= clusters[c] * c]
    if one_wave:
        tn, c = max(one_wave, key=lambda s: (n // s[0] * s[1], s[0]))
    else:
        tn, c = min(shapes, key=lambda s: (n // s[0] * s[1], -s[0]))
    kc = tile_rows(kr, c, tk)
    tiles = kc // tk
    held = 0 if regime == 0 else TC_GROUPS
    stages = min(tiles, max(floor, -(-IN_FLIGHT // (tk * tn)) + held))
    while stages > min(tiles, floor) and shared_bytes(regime, tn, rows, planes, kc, stages, c) > smem_limit:
        stages -= 1
    nbytes = max(shared_bytes(regime, tn, rows, planes, kc, stages, c), one_per_sm(smem_limit))
    return Plan(regime, tn, c, stages, rows, nbytes)


def tile_rows(stored_rows: int, c: int, tile_k: int = TILE_K) -> int:
    """The stored rows of the largest share of a cluster of *c* CTAs: whole
    *tile_k*-row tiles (``tile_rows`` in the kernel)."""
    return -(-(stored_rows // tile_k) // c) * tile_k


def split_ranges(k: int, planes: int, c: int, tile_k: int = TILE_K) -> list[tuple[int, int]]:
    """The stored weight rows [start, stop) of each CTA of a cluster, in rank
    order: CTA r takes the tiles ``[r * T // c, (r + 1) * T // c)`` of the
    T = k / planes / *tile_k* tiles (``first_tile`` in the kernels)."""
    tiles = k // planes // tile_k
    return [(r * tiles // c * tile_k, (r + 1) * tiles // c * tile_k) for r in range(c)]


@functools.lru_cache(maxsize=1024)
def _launch_args(b: int, k: int, n: int, planes: int, regime: int | None, sms: int, smem_limit: int,
                 clusters: tuple[tuple[int, int], ...]) -> tuple[Plan, ctypes.Array]:
    plan = launch_plan(b, k, n, sms, smem_limit, planes, regime, clusters=dict(clusters))
    return plan, (ctypes.c_int * 6)(*dataclasses.astuple(plan))


_capacity: dict[int, tuple[tuple[int, int], ...]] = {}


def device_limits(device: torch.device) -> tuple[int, int, tuple[tuple[int, int], ...]]:
    """(SM count, shared bytes a block may use, ((C, clusters of C CTAs of
    one per SM the card runs at once), ...)) of a CUDA device."""
    sms, smem = _build.device_limits(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _capacity:
        lib = _build.load()
        with torch.cuda.device(index):
            counts = tuple((c, lib.s2s_weight_only_clusters(c, one_per_sm(smem))) for c in CLUSTER_SIZES)
        if any(n <= 0 for _, n in counts):
            raise RuntimeError(f"weight-only matmul: cluster occupancy query of cuda:{index} failed: {counts}")
        _capacity[index] = counts
    return sms, smem, _capacity[index]


def device_plan(b: int, k: int, n: int, planes: int, device: torch.device, regime: int | None = None) -> Plan:
    """:func:`launch_plan` for a CUDA device's SMs, shared memory and
    cluster occupancy."""
    return _launch_args(b, k, n, planes, regime, *device_limits(device))[0]


def launch(entry: str, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, planes: int,
           plan: Plan | None = None, regime: int | None = None,
           row_amax: torch.Tensor | None = None) -> torch.Tensor:
    """Run the kernel *entry* (``s2s_int8_matmul``, ``s2s_int4_matmul`` or,
    with *regime* :data:`W8A8`, ``s2s_int8_matmul_dyn``, which also takes
    the rows' maxima *row_amax* or None) on checked CUDA operands as *plan*
    (default :func:`device_plan`) plans it, on the current stream; allocates
    only the output.  Raises on a launch error.  Counts nothing: the
    wrappers count their launches."""
    b, k = x.shape
    n = w.shape[1]
    if plan is None:
        plan, args = _launch_args(b, k, n, planes, regime, *device_limits(x.device))
    else:
        args = (ctypes.c_int * 6)(*dataclasses.astuple(plan))
    lib = _build.load()
    with torch.cuda.device(x.device):
        out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
        operands = [x.data_ptr(), w.data_ptr(), scale.data_ptr()]
        if regime == W8A8:
            operands.append(row_amax.data_ptr() if row_amax is not None else None)
        err = getattr(lib, entry)(*operands, out.data_ptr(), b, k, n, args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {err} (B={b}, K={k}, N={n}, {plan})")
    return out
