"""The least time a kernel could take on one H100, for roofline shares.

A frozen copy of ``chip_smoke.py``'s bound arithmetic (``bound`` and
``gemv_bound``) and its table of peaks: NVIDIA's H100 SXM data sheet,
dense rates without sparsity, at the full power limit of 700 W.  No
metric reads it yet: a kernel's roofline share needs the (rows, K, N) of
each launch, which the program does not count per call.
"""

from __future__ import annotations

#: HBM bytes a second
HBM_BPS = 3.35e12
#: dense bf16 tensor-core FLOP a second
BF16_FLOPS = 989e12
#: dense int8 tensor-core operations a second
INT8_OPS = 1979e12
#: dense fp8 tensor-core FLOP a second
FP8_FLOPS = 1979e12
#: f32 on the CUDA cores, outside the tensor cores
F32_FLOPS = 67e12
#: the card's memory
HBM_BYTES = 80e9


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(least time in ms the card could take, what bounds it): the larger of
    the bytes moved over the HBM rate and the operations over *peak_ops*."""
    by_bytes, by_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gemv_bound(b: int, k: int, n: int, weight_bytes: float, peak_ops: float) -> tuple[float, str]:
    """The bound of one decode-shaped linear: the weight, x (bf16), the
    scale (f32) and the output (bf16) each moved once; 2*B*K*N operations."""
    return bound(weight_bytes + b * k * 2 + n * 4 + b * n * 2, 2 * b * k * n, peak_ops)
