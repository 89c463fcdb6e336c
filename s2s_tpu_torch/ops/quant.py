"""Weight-only int8 quantization (port of ``s2s_tpu/ops/quant.py``).

Same formula as the JAX package (per-output-channel symmetric int8,
``scale = max(amax / 127, 1e-12)``, round half to even, clip to +-127), so a
quantized tree is equal bit for bit on both sides.  ``linear`` in
:mod:`s2s_tpu_torch.models.common` dispatches on :class:`QuantWeight`.

Only the int8 weight-only mode is ported; the other modes raise and name
their ROADMAP item instead of falling back.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from s2s_tpu_torch.ops import int8_matmul as _mm


class QuantWeight(NamedTuple):
    """Per-output-channel symmetric int8 weight: w ~= q * scale.  Stacked
    layers keep a leading layer axis: q (L, in, out), scale (L, out)."""

    q: torch.Tensor  # (in, out) int8
    scale: torch.Tensor  # (out,) f32


def _quantize(w32: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    amax = w32.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """Symmetric per-output-channel int8 quantization of a 2-D (in, out) weight."""
    q, scale = _quantize(w.float(), 0)
    return QuantWeight(q, scale[0])


def quantized_linear(x: torch.Tensor, qw: QuantWeight, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ dequant(qw).  On CUDA, decode-shaped bf16 calls (at most 64 rows,
    aligned dims) launch the int8 kernel; everything else (CPU tensors,
    prefill-sized batches, f32 activations) takes the plain version, which
    converts the int8 weight and runs ``torch.matmul`` with f32 accumulation,
    as the JAX package leaves those calls to XLA's einsum."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = qw.q.shape[1]
    bsz = math.prod(lead)
    if x.is_cuda and x.dtype == torch.bfloat16 and qw.q.dim() == 2 and _mm.supports(bsz, k, n):
        out = _mm.int8_matmul(x.reshape(bsz, k).contiguous(), qw.q, qw.scale).reshape(*lead, n)
    else:
        out = _mm.int8_matmul_reference(x, qw.q, qw.scale)
    return out + b if b is not None else out


#: minimum elements for a weight to be worth quantizing (norms, biases and
#: tiny heads stay exact)
_MIN_SIZE = 1 << 16

_NOT_PORTED = {
    "int8-dyn": "ROADMAP queue 2 item 3 (int8_matmul_dyn, W8A8 dynamic)",
    "int4": "ROADMAP queue 2 item 4 (int4_matmul, packed int4)",
    "int8+cp4": "ROADMAP queue 2 item 4 (int4_matmul, packed int4 code predictor)",
}


def check_mode(mode: str | None) -> None:
    """Raise for a ``--*_quantize`` mode the port does not have yet."""
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"--*_quantize {mode} is not ported to s2s_tpu_torch yet: {_NOT_PORTED[mode]}"
        )
    if mode not in (None, "", "int8"):
        raise ValueError(f"unknown quantize mode {mode!r}")


def quantize_tree(params: Any, min_size: int = _MIN_SIZE) -> Any:
    """Quantize every big floating 2-D or stacked 3-D matrix of a parameter
    tree (nested dicts/lists of tensors) to int8, with the JAX package's
    skip rules: leaves whose path mentions ``embed``, ``norm`` or ``scale``,
    integer leaves, leaves under *min_size* elements, other ranks, and
    existing :class:`QuantWeight` pass through.  Stacked (L, in, out) leaves
    quantize per layer and channel.  Other modes are refused by
    :func:`check_mode` before a tree gets here."""

    def convert(path: str, leaf):
        if isinstance(leaf, QuantWeight) or not isinstance(leaf, torch.Tensor):
            return leaf
        if "embed" in path or "norm" in path or "scale" in path:
            return leaf
        if not leaf.is_floating_point() or leaf.numel() < min_size:
            return leaf
        if leaf.dim() == 2:
            return quantize_weight(leaf)
        if leaf.dim() == 3:
            q, scale = _quantize(leaf.float(), 1)
            return QuantWeight(q, scale[:, 0, :])
        return leaf

    def walk(node, path: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, QuantWeight):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(node))
        return convert(path, node)

    return walk(params, "")
