"""Attribution of the decode weight-read floor at full SmolLM2-1.7B width.

The port of ``scripts/microbench_weights.py``: per step and layer, the
linears of SmolLM2-1.7B (16 rows, 24 layers, 8 steps; the 8192-wide input
tiled from the 2048-wide one) as seven calls, as four (q/k/v fused, gate/up
fused) and as two (every product of the layer's input as one wide product,
then the down projection), each through the W8A16 kernel
(:func:`s2s_tpu_torch.ops.int8_matmul.int8_matmul`); the seven through the
plain dequantized product (the int8 weight cast to bf16, the product
accumulated in f32, times the scale, one cast to bf16: the JAX script's XLA
path); and the seven and the four in bf16 through ``torch.matmul``.  Run
from the repository root on one NVIDIA GPU:

    python -m s2s_tpu_torch.tools.microbench_weights [--device cuda] [--config smollm2-1.7b]

``--device cpu --config tiny`` runs the same rows on the CPU at a tiny size,
eagerly (no device numbers).  The weights are random, drawn from a
``torch.Generator`` with a fixed seed a row; one row's weights are allocated
at a time (the largest, the seven bf16 stacks, hold 3.2 GB).

One JSON line a row, under the JAX script's keys: the least wall of a replay
of the chunk captured as one CUDA graph (after a warm eager call), each
ending in a host read of its output, as the JAX script times one compiled
program and its fetch, and the weight bytes read over it in GB/s; then
``device_s``, the least span of a replay between CUDA events, ``eager_s``,
the least wall of the chunk run eagerly (host dispatch's share is the
difference), and ``int8_matmul_launches``, the W8A16 kernel's launches in
one eager call.  Then the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import torch

from s2s_tpu_torch.models.common import f32_product
from s2s_tpu_torch.ops import int8_matmul as mm
from s2s_tpu_torch.tools.microbench_decode import card


@dataclass(frozen=True)
class Sizes:
    """A chunk's rows, the model and MLP widths, the layers and the steps."""
    rows: int = 16
    d: int = 2048
    ff: int = 8192
    layers: int = 24
    steps: int = 8


CONFIGS = {"smollm2-1.7b": Sizes(), "tiny": Sizes(rows=4, d=128, ff=256, layers=2, steps=2)}
#: timed calls of a row after its warm one (the JAX script's ``timeit``)
REPEATS = 3
#: the rows in the JAX script's order: (key, the layer's calls, the path, the seed of its weights)
ROWS = (("seven_calls_kernel", "seven", "kernel", 0), ("four_calls_kernel", "four", "kernel", 100),
        ("two_calls_kernel", "two", "kernel", 200), ("seven_einsum_int8", "seven", "einsum", 300),
        ("seven_bf16", "seven", "bf16", 400), ("four_bf16", "four", "bf16", 500))


def layer_shapes(s: Sizes) -> dict[str, list[tuple[int, int]]]:
    """The (K, N) of each call a layer: seven, four (q/k/v and gate/up
    fused) and two (q/k/v, o's input, gate and up as one wide product)."""
    d, ff = s.d, s.ff
    return {"seven": [(d, d), (d, d), (d, d), (d, d), (d, ff), (d, ff), (ff, d)],
            "four": [(d, 3 * d), (d, d), (d, 2 * ff), (ff, d)],
            "two": [(d, 2 * ff + 3 * d + d), (ff, d)]}


def row_keys() -> tuple[str, ...]:
    return tuple(k for name, *_ in ROWS for k in (name, f"{name}_gbps"))


def _tiled(h: torch.Tensor, k: int) -> torch.Tensor:
    """*h* widened to *k* columns by tiling (the JAX script's ``jnp.tile``)."""
    d = h.shape[1]
    return h if k == d else h.repeat(1, k // d)


def kernel_mix_chunk(x: torch.Tensor, flat: tuple, shapes, steps: int) -> torch.Tensor:
    """*steps* x (over the layers of the stacks in *flat*, ``(q0, s0, q1, s1,
    ...)``, one W8A16 call a shape, the outputs' first D columns summed)."""
    d, h = x.shape[1], x
    for _ in range(steps):
        for layer in range(flat[0].shape[0]):
            h = sum(mm.int8_matmul(_tiled(h, flat[2 * i].shape[1]), flat[2 * i][layer], flat[2 * i + 1][layer])[:, :d]
                    for i in range(len(shapes)))
    return h


def einsum_mix_chunk(x: torch.Tensor, flat: tuple, shapes, steps: int, int8: bool) -> torch.Tensor:
    """The same chunk through the plain products: with *int8*, the int8
    stacks cast to x's dtype, the product in f32, times the scale, one cast
    (``(q0, s0, ...)``); else bf16 stacks ``(w0, w1, ...)`` through
    ``torch.matmul``."""
    d, h = x.shape[1], x
    for _ in range(steps):
        for layer in range(flat[0].shape[0]):
            outs = []
            for i in range(len(shapes)):
                if int8:
                    q, s = flat[2 * i][layer], flat[2 * i + 1][layer]
                    out = (f32_product(_tiled(h, q.shape[0]), q) * s).to(h.dtype)
                else:
                    w = flat[i][layer]
                    out = torch.matmul(_tiled(h, w.shape[0]), w)
                outs.append(out[:, :d])
            h = sum(outs)
    return h


def int8_stacks(shapes, layers: int, gen: torch.Generator, device: torch.device) -> tuple:
    """``(q0, s0, q1, s1, ...)``: int8 (layers, K, N) stacks in [-127, 127)
    with unit scales, as the JAX script's ``make_stack``."""
    flat = []
    for k, n in shapes:
        q = torch.randint(-127, 127, (layers, k, n), generator=gen, device=device, dtype=torch.int16).to(torch.int8)
        flat += [q, torch.ones((layers, n), device=device)]
    return tuple(flat)


def bf16_stacks(shapes, layers: int, gen: torch.Generator, device: torch.device) -> tuple:
    """``(w0, w1, ...)``: standard normal bf16 (layers, K, N) stacks."""
    return tuple(torch.randn((layers, k, n), generator=gen, device=device, dtype=torch.bfloat16) for k, n in shapes)


def captured(fn):
    """*fn* (a chunk returning its output) captured as one CUDA graph after
    a warm call on a side stream: (replay, the graph's output tensor).  The
    W8A16 calls made while capturing launch nothing, so they are taken back
    from the kernel's count; the replays are not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = mm.int8_matmul.launches
    with torch.cuda.graph(graph):
        out = fn()
    mm.int8_matmul.launches = launches
    return graph.replay, out


def time_chunk(name: str, fn, nbytes: int, device: torch.device, repeats: int = REPEATS) -> dict:
    """One row: *fn* (a chunk returning its output) once eagerly, warm,
    counting the W8A16 launches; *repeats* eager calls; on the card the
    chunk's CUDA graph replayed once warm and *repeats* times, each replay
    between CUDA events and ending in a host read.  The row's key holds the
    least replay wall (the least eager wall on the CPU)."""
    before = mm.int8_matmul.launches
    fn().cpu()
    launches = mm.int8_matmul.launches - before
    eager = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn().cpu()
        eager.append(time.perf_counter() - t0)
    wall, span = min(eager), None
    if device.type == "cuda":
        replay, out = captured(fn)
        replay()
        out.cpu()
        walls, spans = [], []
        for _ in range(repeats):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            replay()
            end.record()
            out.cpu()
            walls.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end) / 1e3)
        wall, span = min(walls), min(spans)
    return {name: wall, f"{name}_gbps": nbytes / wall / 1e9, "row": name, "wall_s": wall, "device_s": span,
            "eager_s": min(eager), "int8_matmul_launches": launches, "weight_bytes": nbytes, "device": device.type}


def mix_row(name: str, shapes, path: str, seed: int, x: torch.Tensor, s: Sizes, device: torch.device,
            repeats: int = REPEATS) -> dict:
    """One row of :data:`ROWS`: its weights drawn, timed, then dropped."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nbytes = sum(k * n for k, n in shapes) * s.layers * s.steps
    if path == "bf16":
        flat = bf16_stacks(shapes, s.layers, gen, device)
        return time_chunk(name, lambda: einsum_mix_chunk(x, flat, shapes, s.steps, False), 2 * nbytes, device,
                          repeats)
    flat = int8_stacks(shapes, s.layers, gen, device)
    if path == "kernel":
        return time_chunk(name, lambda: kernel_mix_chunk(x, flat, shapes, s.steps), nbytes, device, repeats)
    return time_chunk(name, lambda: einsum_mix_chunk(x, flat, shapes, s.steps, True), nbytes, device, repeats)


def run(sizes: Sizes, device: torch.device, repeats: int = REPEATS) -> list[dict]:
    """Every row of :data:`ROWS` at *sizes*, one at a time, from ones."""
    shapes = layer_shapes(sizes)
    x = torch.ones((sizes.rows, sizes.d), dtype=torch.bfloat16, device=device)
    rows = []
    for name, mix, path, seed in ROWS:
        rows.append(mix_row(name, shapes[mix], path, seed, x, sizes, device, repeats))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--config", default="smollm2-1.7b", choices=sorted(CONFIGS))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("microbench_weights: no CUDA device (pass --device cpu for a CPU run)")
    for line in run(CONFIGS[args.config], device):
        print(json.dumps(line), flush=True)
    if device.type == "cuda":
        print(json.dumps({"card": card(), "device_name": torch.cuda.get_device_name(device)}))


if __name__ == "__main__":
    main()
