"""The weight microbenchmarks' chunks on the card
(``s2s_tpu_torch/tools/microbench_{weights,bscale}.py``; ``cuda`` marker,
skipped without a card; this file imports no JAX).

- Each W8A16 layer mix (seven, four and two calls a layer) at 16 rows of
  256 and 1024 wide layers, 2 layers, 2 steps: one eager call launches the
  kernel exactly calls x layers x steps times, the chunk's CUDA graph
  replays to the eager call's output bit for bit (its capture and replay
  leave the count as the warm call left it), and the tool's row counts the
  same launches.
- The bf16 mix of the batch-scaling tool at 8 and 64 rows: no kernel of the
  port launches, and the replay equals the eager call's output.
"""

import numpy as np
import pytest
import torch

from s2s_tpu_torch.ops import int8_matmul as mm
from s2s_tpu_torch.tools import microbench_bscale, microbench_weights as mbw

SIZES = mbw.Sizes(rows=16, d=256, ff=1024, layers=2, steps=2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _int8_stacks(shapes, device):
    """int8 stacks with scales that keep the chunk's values near unit gain."""
    rng = np.random.default_rng(0)
    flat = []
    for k, n in shapes:
        flat.append(torch.from_numpy(rng.integers(-127, 127, (SIZES.layers, k, n)).astype(np.int8)).to(device))
        flat.append(torch.full((SIZES.layers, n), 1 / (73 * k ** 0.5), device=device))
    return tuple(flat)


def _replayed(fn) -> torch.Tensor:
    replay, out = mbw.captured(fn)
    replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["seven", "four", "two"])
def test_kernel_mix_replay_equals_the_eager_call_and_launches_are_exact(cuda_device, mix):
    shapes = mbw.layer_shapes(SIZES)[mix]
    flat = _int8_stacks(shapes, cuda_device)
    x = torch.randn((SIZES.rows, SIZES.d), generator=torch.Generator().manual_seed(1)).to(cuda_device, torch.bfloat16)

    def fn():
        return mbw.kernel_mix_chunk(x, flat, shapes, SIZES.steps)

    before = mm.int8_matmul.launches
    eager = fn()
    torch.cuda.synchronize()
    calls = len(shapes) * SIZES.layers * SIZES.steps
    assert mm.int8_matmul.launches - before == calls
    assert torch.isfinite(eager).all() and eager.abs().max() > 0
    before = mm.int8_matmul.launches
    replayed = _replayed(fn)
    assert mm.int8_matmul.launches - before == calls  # the warm call; the capture and the replay count none
    assert torch.equal(replayed, eager)
    row = mbw.time_chunk(mix, fn, 1, cuda_device, repeats=1)
    assert row["int8_matmul_launches"] == calls and row["device_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 64])
def test_bscale_mix_replay_equals_the_eager_call_and_launches_no_port_kernel(cuda_device, rows):
    shapes = mbw.layer_shapes(SIZES)["seven"]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    flat = tuple(w / w.shape[1] ** 0.5 for w in mbw.bf16_stacks(shapes, SIZES.layers, gen, cuda_device))
    x = torch.randn((rows, SIZES.d), generator=gen, device=cuda_device).to(torch.bfloat16)

    def fn():
        return microbench_bscale.mix_chunk(x, flat, shapes, SIZES.steps)

    before = mm.int8_matmul.launches
    eager = fn()
    torch.cuda.synchronize()
    assert mm.int8_matmul.launches == before
    assert torch.isfinite(eager).all() and eager.abs().max() > 0
    assert torch.equal(_replayed(fn), eager)
