"""Batch scaling of the decode weight read at full SmolLM2-1.7B width.

The port of ``scripts/microbench_bscale.py``: the seven-call bf16 layer mix
of :mod:`s2s_tpu_torch.tools.microbench_weights` (SmolLM2-1.7B's linears,
24 layers, 8 steps, ``torch.matmul``) at 8 to 256 rows.  Where the products
are bound by their weight read, the wall stays flat as the rows grow and
batch width is nearly free.  Run from the repository root on one NVIDIA GPU:

    python -m s2s_tpu_torch.tools.microbench_bscale [--device cuda] [--config smollm2-1.7b]

``--device cpu --config tiny`` runs the same rows on the CPU at a tiny
size, eagerly.  The weights are random, drawn once from a
``torch.Generator`` seeded with 0.  One JSON line a row count, under the
JAX script's keys: the least wall of a replay of the chunk's CUDA graph
ending in a host read, and that wall per step and row in microseconds;
beside them :func:`~s2s_tpu_torch.tools.microbench_weights.time_chunk`'s
device span and eager wall.  Then the card's ``nvidia-smi`` name and power
limit.  No kernel of the port is on this path: it times ``torch.matmul``.
"""

from __future__ import annotations

import argparse
import json

import torch

from s2s_tpu_torch.tools import microbench_weights as mbw
from s2s_tpu_torch.tools.microbench_decode import card

CONFIGS = {"smollm2-1.7b": (mbw.CONFIGS["smollm2-1.7b"], (8, 16, 32, 64, 128, 256)),
           "tiny": (mbw.CONFIGS["tiny"], (2, 4))}


def row_keys(batches) -> tuple[str, ...]:
    return tuple(k for b in batches for k in (f"bf16_mix_b{b}", f"per_row_us_b{b}"))


def mix_chunk(x: torch.Tensor, flat: tuple, shapes, steps: int) -> torch.Tensor:
    """The JAX script's ``mix_chunk``: the bf16 layer mix."""
    return mbw.einsum_mix_chunk(x, flat, shapes, steps, int8=False)


def run(sizes: mbw.Sizes, batches, device: torch.device, repeats: int = mbw.REPEATS) -> list[dict]:
    """One row for each row count in *batches*, over one set of weights."""
    shapes = mbw.layer_shapes(sizes)["seven"]
    flat = mbw.bf16_stacks(shapes, sizes.layers, torch.Generator(device=device).manual_seed(0), device)
    nbytes = 2 * sum(k * n for k, n in shapes) * sizes.layers * sizes.steps
    rows = []
    for b in batches:
        x = torch.ones((b, sizes.d), dtype=torch.bfloat16, device=device)
        name = f"bf16_mix_b{b}"
        row = mbw.time_chunk(name, lambda x=x: mix_chunk(x, flat, shapes, sizes.steps), nbytes, device, repeats)
        rows.append({**row, f"per_row_us_b{b}": row[name] / sizes.steps / b * 1e6})
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--config", default="smollm2-1.7b", choices=sorted(CONFIGS))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("microbench_bscale: no CUDA device (pass --device cpu for a CPU run)")
    sizes, batches = CONFIGS[args.config]
    for line in run(sizes, batches, device):
        print(json.dumps(line), flush=True)
    if device.type == "cuda":
        print(json.dumps({"card": card(), "device_name": torch.cuda.get_device_name(device)}))


if __name__ == "__main__":
    main()
