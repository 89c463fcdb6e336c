"""int8 weight-only (W8A16) matmul for decode-shaped linears.

The port of the TPU Pallas kernel ``s2s_tpu/ops/int8_matmul.py::int8_matmul``
as a hand-written CUDA kernel for Hopper (``csrc/int8_matmul.cu``, whose
header says what bounds it and how the design answers that).

- :func:`int8_matmul` is the wrapper: a tensor on the CPU takes the plain
  PyTorch version (:func:`int8_matmul_reference`); a CUDA tensor launches the
  kernel or raises.  There is no fallback between the two.
- :func:`supports` is the JAX package's routing contract, unchanged, so the
  same calls take the kernel on both sides.
- ``int8_matmul.launches`` counts kernel launches (the plain version does not
  count), so a run can show that the main path went through the kernel.
"""

from __future__ import annotations

import functools

import torch

from s2s_tpu_torch.ops import _build

TILE_N = 128  # columns per block (csrc/int8_matmul.cu kTileN)
MAX_ROWS = 64
_MIN_K_PER_SPLIT = 64


def supports(b: int, k: int, n: int) -> bool:
    """Kernel applicability, identical to the JAX package's ``supports``:
    aligned dims, a decode-sized batch, and K * min(256, N) <= 4M."""
    return k % 128 == 0 and n % 128 == 0 and 1 <= b <= MAX_ROWS and k * min(256, n) <= (1 << 22)


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (x @ q) accumulated in f32, times the
    per-channel scale in f32, cast once to x's dtype."""
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _row_tile(b: int) -> int:
    return 1 if b <= 1 else 2 if b <= 2 else 4 if b <= 4 else 8


def split_count(b: int, k: int, n: int, sms: int) -> int:
    """Blocks along K: enough (N/128 x row-tiles x splits) blocks for about
    four per SM, each split at least 64 rows of K and dividing K evenly."""
    tiles = (n // TILE_N) * -(-b // _row_tile(b))
    target = -(-4 * sms // tiles)
    splits = 1
    while splits * 2 <= target and k % (splits * 2 * _MIN_K_PER_SPLIT) == 0:
        splits *= 2
    return splits


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"int8_matmul wants x (B, K), q (K, N), scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(scale.shape)}")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul wants bf16/int8/f32; got {x.dtype}/{q.dtype}/{scale.dtype}")
    if not (q.device == x.device and scale.device == x.device):
        raise ValueError(f"int8_matmul operands on different devices: {x.device}, {q.device}, {scale.device}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul wants contiguous operands")
    b, k = x.shape
    if q.shape[0] != k or scale.shape[0] != q.shape[1]:
        raise ValueError(f"int8_matmul shape mismatch: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not supports(b, k, q.shape[1]):
        raise ValueError(f"int8_matmul does not support B={b}, K={k}, N={q.shape[1]} "
                         "(needs 1 <= B <= 64, K % 128 == 0, N % 128 == 0)")
    if q.data_ptr() % 16 or x.data_ptr() % 4:
        raise ValueError("int8_matmul wants 16-byte aligned q and 4-byte aligned x")


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) bf16 @ q (K, N) int8 * scale (N,) f32 -> (B, N) bf16.

    CPU tensors take :func:`int8_matmul_reference`.  CUDA tensors launch
    ``csrc/int8_matmul.cu`` on the current stream (built at first use) and
    raise on any shape, type, layout or launch error."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    _check(x, q, scale)
    b, k = x.shape
    n = q.shape[1]
    lib = _build.load()
    with torch.cuda.device(x.device):
        splits = split_count(b, k, n, _sm_count(x.device.index or 0))
        out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
        partial = (torch.empty((splits, b, n), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        err = lib.s2s_int8_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            b, k, n, splits, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: cudaError {err} "
                           f"(B={b}, K={k}, N={n}, splits={splits})")
    _build.count_launch(int8_matmul)
    return out


int8_matmul.launches = 0
