"""int8 matmuls for decode-shaped linears: W8A16 and W8A8 dynamic.

The ports of the TPU Pallas kernels ``s2s_tpu/ops/int8_matmul.py::int8_matmul``
and ``::int8_matmul_dyn`` as hand-written CUDA kernels for Hopper
(``csrc/int8_matmul.cu`` and ``csrc/int8_matmul_dyn.cu``, whose headers say
what bounds each and how the design answers that).  The W8A16 kernel is the
weight-only template (``csrc/weight_only_matmul.cuh``) with one weight plane;
the W8A8 kernel (int8 tensor cores, the activation quantize in the same
launch) is built on that template's helpers.  ``weight_only.launch_plan``
plans both (:mod:`s2s_tpu_torch.ops.weight_only`; regime
``weight_only.W8A8`` for W8A8).

- :func:`int8_matmul` and :func:`int8_matmul_dyn` are the wrappers: a tensor
  on the CPU takes the plain PyTorch version (:func:`int8_matmul_reference`,
  :func:`int8_matmul_dyn_reference`); a CUDA tensor launches the kernel or
  raises.  There is no fallback between the two.
- :func:`supports` is the JAX package's routing contract, unchanged, so the
  same calls take the kernels on both sides.
- ``int8_matmul.launches`` and ``int8_matmul_dyn.launches`` count kernel
  launches (the plain versions do not count), so a run can show that the main
  path went through the kernels; ``int8_matmul.rows`` and
  ``int8_matmul_dyn.rows`` count them by rows.
"""

from __future__ import annotations

import collections

import torch

from s2s_tpu_torch.ops import _build, weight_only

MAX_ROWS = 64


def supports(b: int, k: int, n: int) -> bool:
    """Kernel applicability, identical to the JAX package's ``supports``:
    aligned dims, a decode-sized batch, and K * min(256, N) <= 4M."""
    return k % 128 == 0 and n % 128 == 0 and 1 <= b <= MAX_ROWS and k * min(256, n) <= (1 << 22)


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (x @ q) accumulated in f32, times the
    per-channel scale in f32, cast once to x's dtype."""
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


def int8_matmul_dyn_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                              row_amax: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of W8A8 dynamic, the JAX package's
    ``int8_matmul_dyn_reference`` math: per-row absmax of x in f32 (or the
    given *row_amax* (B,) f32: each row's over a wider K, a row-parallel
    shard's whole input dim), ``xscale = max(amax / 127, 1e-12)`` (divided
    by a tensor: PyTorch multiplies by the reciprocal of a scalar divisor,
    which is not IEEE division), ``xq = clip(round(x / xscale), +-127)``
    (round half to even), the integer product, then
    ``(f32(acc) * xscale) * scale`` rounded once to x's dtype.  The integer
    product runs in float64, exact on every device (|acc| <= 127^2 K < 2^53;
    cuBLAS has no int32 ``mm``)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=1, keepdim=True) if row_amax is None else row_amax.float().reshape(-1, 1)
    xscale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    xq = torch.clamp(torch.round(x32 / xscale), -127, 127)
    acc = (xq.double() @ q.double()).float()
    return ((acc * xscale) * scale.float()).to(x.dtype)


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, name: str = "int8_matmul") -> None:
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"{name} wants x (B, K), q (K, N), scale (N,); got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(scale.shape)}")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name} wants bf16/int8/f32; got {x.dtype}/{q.dtype}/{scale.dtype}")
    if not (q.device == x.device and scale.device == x.device):
        raise ValueError(f"{name} operands on different devices: {x.device}, {q.device}, {scale.device}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name} wants contiguous operands")
    b, k = x.shape
    if q.shape[0] != k or scale.shape[0] != q.shape[1]:
        raise ValueError(f"{name} shape mismatch: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    if not supports(b, k, q.shape[1]):
        raise ValueError(f"{name} does not support B={b}, K={k}, N={q.shape[1]} "
                         "(needs 1 <= B <= 64, K % 128 == 0, N % 128 == 0)")
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name} wants 16-byte aligned q and x")


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (B, K) bf16 @ q (K, N) int8 * scale (N,) f32 -> (B, N) bf16.

    CPU tensors take :func:`int8_matmul_reference`.  CUDA tensors launch
    ``csrc/int8_matmul.cu`` once on the current stream (built at first use)
    as ``weight_only.launch_plan`` plans it, allocate only the output, and raise on
    any shape, type, layout or launch error."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    _check(x, q, scale)
    out = weight_only.launch("s2s_int8_matmul", x, q, scale, planes=1)
    _build.count_launch(int8_matmul, x.shape[0])
    return out


int8_matmul.launches = 0
int8_matmul.rows = collections.Counter()


def int8_matmul_dyn(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    row_amax: torch.Tensor | None = None) -> torch.Tensor:
    """W8A8 dynamic: x (B, K) bf16, q (K, N) int8, scale (N,) f32 -> (B, N)
    bf16, bit-equal to :func:`int8_matmul_dyn_reference` (with the same
    *row_amax*: (B,) f32, each row's max |x| over the whole input dim of a
    row-parallel shard, reduced across the ranks by the caller; None: the
    rows' own over K).

    CPU tensors take the plain version.  CUDA tensors launch
    ``csrc/int8_matmul_dyn.cu`` once on the current stream (built at first
    use) as ``weight_only.launch_plan`` plans it (regime
    ``weight_only.W8A8``): the per-row quantize, the int8 product and the
    epilogue in one launch, allocating only the output; raise on any shape,
    type, layout or launch error."""
    if x.device.type == "cpu":
        return int8_matmul_dyn_reference(x, q, scale, row_amax)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_dyn: unsupported device {x.device}")
    _check(x, q, scale, "int8_matmul_dyn")
    if row_amax is not None and (row_amax.shape != (x.shape[0],) or row_amax.dtype != torch.float32
                                 or row_amax.device != x.device or not row_amax.is_contiguous()):
        raise ValueError(f"int8_matmul_dyn wants row_amax ({x.shape[0]},) f32, contiguous, on {x.device}; got "
                         f"{tuple(row_amax.shape)} {row_amax.dtype} on {row_amax.device}")
    out = weight_only.launch("s2s_int8_matmul_dyn", x, q, scale, planes=1, regime=weight_only.W8A8,
                             row_amax=row_amax)
    _build.count_launch(int8_matmul_dyn, x.shape[0])
    return out


int8_matmul_dyn.launches = 0
int8_matmul_dyn.rows = collections.Counter()
