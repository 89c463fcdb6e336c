"""Packed int4 weight-only matmul for decode-shaped linears.

The port of the TPU Pallas kernel ``s2s_tpu/ops/int4_matmul.py::int4_matmul``
as a hand-written CUDA kernel for Hopper (``csrc/int4_matmul.cu``, whose
header says what bounds it and how the design answers that).

Packing (``s2s_tpu_torch.ops.quant``): row k of the packed (K/2, N) int8
buffer holds original row k in its low nibble and row k + K/2 in its high
nibble, both sign-extended, so out = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) *
scale.

- :func:`int4_matmul` is the wrapper: a tensor on the CPU takes the plain
  PyTorch version (:func:`int4_matmul_reference`); a CUDA tensor launches the
  kernel or raises.  There is no fallback between the two.
- :func:`supports` is the JAX package's routing contract, unchanged.
- ``int4_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from s2s_tpu_torch.ops import _build
from s2s_tpu_torch.ops.int8_matmul import MAX_ROWS, _sm_count, split_count


def supports(b: int, k: int, n: int) -> bool:
    """Kernel applicability, identical to the JAX package's ``supports``:
    K % 256 == 0, N % 128 == 0, a decode-sized batch, and a packed
    K/2 x min(256, N) block of at most 4 MB."""
    return k % 256 == 0 and n % 128 == 0 and 1 <= b <= MAX_ROWS and (k // 2) * min(256, n) <= (1 << 22)


def unpack_nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K/2, N) int8 -> (lo, hi) int32 nibble planes, sign-extended (the
    JAX package's arithmetic: hi by an arithmetic shift of the sign-extended
    byte, lo as the two's complement of the low four bits)."""
    p = packed.to(torch.int32)
    hi = p >> 4
    lo_u = p & 15
    lo = lo_u - (lo_u >> 3) * 16
    return lo, hi


def int4_matmul_reference(x: torch.Tensor, q_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack to the (K, N) int4 values, (x @ w)
    accumulated in f32, times the per-channel scale in f32, cast once to
    x's dtype."""
    lo, hi = unpack_nibbles(q_packed)
    w = torch.cat([lo, hi], dim=-2)
    return ((x.float() @ w.float()) * scale.float()).to(x.dtype)


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"int4_matmul wants x (B, K), q_packed (K/2, N), scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(scale.shape)}")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int4_matmul wants bf16/int8/f32; got {x.dtype}/{q.dtype}/{scale.dtype}")
    if not (q.device == x.device and scale.device == x.device):
        raise ValueError(f"int4_matmul operands on different devices: {x.device}, {q.device}, {scale.device}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int4_matmul wants contiguous operands")
    b, k = x.shape
    if 2 * q.shape[0] != k or scale.shape[0] != q.shape[1]:
        raise ValueError(f"int4_matmul shape mismatch: x {tuple(x.shape)}, q_packed {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not supports(b, k, q.shape[1]):
        raise ValueError(f"int4_matmul does not support B={b}, K={k}, N={q.shape[1]} "
                         "(needs 1 <= B <= 64, K % 256 == 0, N % 128 == 0)")
    if q.data_ptr() % 16 or x.data_ptr() % 4:
        raise ValueError("int4_matmul wants 16-byte aligned q_packed and 4-byte aligned x")


def int4_matmul(x: torch.Tensor, q_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) bf16 @ unpack(q_packed (K/2, N) int8) * scale (N,) f32 ->
    (B, N) bf16.

    CPU tensors take :func:`int4_matmul_reference`.  CUDA tensors launch
    ``csrc/int4_matmul.cu`` on the current stream and raise on any shape,
    type, layout or launch error."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q_packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    _check(x, q_packed, scale)
    b, k = x.shape
    n = q_packed.shape[1]
    lib = _build.load()
    with torch.cuda.device(x.device):
        # the K split runs over the packed rows (each carries two K rows)
        splits = split_count(b, k // 2, n, _sm_count(x.device.index or 0))
        out = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
        partial = (torch.empty((splits, b, n), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        err = lib.s2s_int4_matmul(
            x.data_ptr(), q_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            b, k, n, splits, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: cudaError {err} "
                           f"(B={b}, K={k}, N={n}, splits={splits})")
    _build.count_launch(int4_matmul)
    return out


int4_matmul.launches = 0
