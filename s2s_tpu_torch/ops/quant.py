"""Weight quantization for decode-shaped linears (port of ``s2s_tpu/ops/quant.py``).

Three weight types, with the JAX package's formulas, so a quantized tree is
equal bit for bit on both sides:

- :class:`QuantWeight`: per-output-channel symmetric int8,
  ``scale = max(amax / 127, 1e-12)``, round half to even, clip to +-127;
  served W8A16 (:func:`quantized_linear`).
- :class:`DynQuantWeight`: the same storage, served W8A8 dynamic
  (:func:`quantized_linear_dyn`): activations quantize per row at run time
  and the product runs on int8.  Under 8 rows it takes the W8A16 route.
- :class:`Quant4Weight`: per-output-channel symmetric int4,
  ``scale = max(amax / 7, 1e-12)``, two values per byte along the input dim:
  packed row ``k`` holds row ``k`` in its low nibble and row ``k + K/2`` in
  its high nibble (:func:`quantized_linear4`).

``linear`` in :mod:`s2s_tpu_torch.models.common` dispatches on the three
types.  :func:`quantize_tree` maps a ``--*_quantize`` mode onto them.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from s2s_tpu_torch.ops import int4_matmul as _mm4
from s2s_tpu_torch.ops import int8_matmul as _mm


class QuantWeight(NamedTuple):
    """Per-output-channel symmetric int8 weight: w ~= q * scale.  Stacked
    layers keep a leading layer axis: q (L, in, out), scale (L, out)."""

    q: torch.Tensor  # (in, out) int8
    scale: torch.Tensor  # (out,) f32


class DynQuantWeight(NamedTuple):
    """:class:`QuantWeight`'s storage, served through the W8A8 dynamic path
    (``--*_quantize int8-dyn``); a distinct type so ``linear`` dispatch stays
    explicit."""

    q: torch.Tensor  # (in, out) int8
    scale: torch.Tensor  # (out,) f32


class Quant4Weight(NamedTuple):
    """Per-output-channel symmetric int4 weight, two values per byte:
    w ~= unpack(q_packed) * scale (layout in the module docstring)."""

    q_packed: torch.Tensor  # (in/2, out) int8 nibble pairs
    scale: torch.Tensor  # (out,) f32


QUANT_TYPES = (QuantWeight, DynQuantWeight, Quant4Weight)


def _quantize(w32: torch.Tensor, dim: int, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    amax = w32.abs().amax(dim=dim, keepdim=True)
    # divided by a tensor: PyTorch multiplies by the reciprocal of a scalar
    # divisor, which can differ from IEEE division (JAX's) in the last bit
    scale = torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-12)
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """Symmetric per-output-channel int8 quantization of a 2-D (in, out) weight."""
    q, scale = _quantize(w.float(), 0, 127.0)
    return QuantWeight(q, scale[0])


def _pack_nibbles(q4: torch.Tensor, dim: int) -> torch.Tensor:
    """Pack int4 values (held in int8) pairwise along *dim* (even length):
    low nibble = first half, high nibble = second half.  The byte value
    ``(lo & 0xF) | ((hi & 0xF) << 4)`` is mapped into [-128, 127] before the
    cast, the bit pattern the JAX package's wrapping int8 cast stores."""
    lo, hi = torch.chunk(q4.to(torch.int32), 2, dim=dim)
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


def quantize_weight4(w: torch.Tensor) -> Quant4Weight:
    """Symmetric per-output-channel int4 quantization of a 2-D (in, out)
    weight with an even input dim."""
    q4, scale = _quantize(w.float(), 0, 7.0)
    return Quant4Weight(_pack_nibbles(q4, 0), scale[0])


def slice_rows4(q_packed: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Input rows [start, stop) of a packed int4 payload (..., K/2, N),
    re-packed in the same layout over ``stop - start`` rows (even): a packed
    row holds rows k and k + K/2, so a contiguous slice of the bytes is not
    a contiguous slice of K."""
    lo, hi = _mm4.unpack_nibbles(q_packed)
    rows = torch.cat([lo, hi], dim=-2)[..., start:stop, :]
    return _pack_nibbles(rows, rows.dim() - 2)


def dequantize4(qw: Quant4Weight, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    lo, hi = _mm4.unpack_nibbles(qw.q_packed)
    w4 = torch.cat([lo, hi], dim=-2)
    return (w4.float() * qw.scale.unsqueeze(-2)).to(dtype)


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


def quantized_linear_dyn(x: torch.Tensor, qw: DynQuantWeight, b: torch.Tensor | None = None,
                         group=None) -> torch.Tensor:
    """x @ dequant(qw) through W8A8 dynamic, routed as the JAX package routes
    it: under 8 rows the exact W8A16 path (:func:`quantized_linear`); bf16
    CUDA calls of up to 64 rows with aligned dims launch the W8A8 kernel;
    the rest take the plain version, the same integer math.

    *group* (a ``parallel.mesh.TPGroup``) marks *qw* as a row-parallel
    shard of tensor-parallel serving: each row's absmax is taken over the
    rank's block of x in f32, as the JAX package takes it outside its
    kernel, and the ranks' maxima are reduced (``group.all_max``), so every
    row quantizes by its absmax over the whole input dim, as one device's
    does; the kernel or the plain version takes those maxima."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = qw.q.shape[1]
    bsz = math.prod(lead)
    if bsz < 8:
        return quantized_linear(x, QuantWeight(qw.q, qw.scale), b)
    x2 = x.reshape(bsz, k)
    row_amax = group.all_max(x2.float().abs().amax(dim=1)) if group is not None else None
    if x.is_cuda and x.dtype == torch.bfloat16 and _mm.supports(bsz, k, n):
        out = _mm.int8_matmul_dyn(x2.contiguous(), qw.q, qw.scale, row_amax)
    else:
        out = _mm.int8_matmul_dyn_reference(x2, qw.q, qw.scale, row_amax)
    out = out.reshape(*lead, n)
    return out + b if b is not None else out


def quantized_linear4(x: torch.Tensor, qw: Quant4Weight, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ dequant(qw).  On CUDA, decode-shaped bf16 calls (at most 64 rows,
    K % 256 == 0, N % 128 == 0) launch the int4 kernel; the rest unpack and
    take the plain version (f32 accumulation, the scale once), as the JAX
    package's einsum path computes them."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = qw.q_packed.shape[-1]
    bsz = math.prod(lead)
    if x.is_cuda and x.dtype == torch.bfloat16 and qw.q_packed.dim() == 2 and _mm4.supports(bsz, k, n):
        out = _mm4.int4_matmul(x.reshape(bsz, k).contiguous(), qw.q_packed, qw.scale).reshape(*lead, n)
    else:
        out = _mm4.int4_matmul_reference(x, qw.q_packed, qw.scale)
    return out + b if b is not None else out


#: minimum elements for a weight to be worth quantizing (norms, biases and
#: tiny heads stay exact)
_MIN_SIZE = 1 << 16

#: the ``--llm_quantize`` modes the JAX registry quantizes with, and the
#: ``--tts_quantize`` modes of its Qwen3-TTS mode table
LLM_MODES = ("int8", "int4", "int8-dyn")
TTS_MODES = (*LLM_MODES, "int8+cp4")


def check_mode(mode: str | None, modes: tuple[str, ...]) -> None:
    """Raise for a ``--*_quantize`` mode outside *modes* (None or "" is off)."""
    if mode and mode not in modes:
        raise ValueError(f"unknown quantize mode {mode!r}; expected one of {modes}")


def quantize_mode(params: Any, mode: str | None) -> Any:
    """Quantize a decoder-LM tree for ``--llm_quantize`` *mode*, as the JAX
    registry does: ``int4`` packs int4, ``int8-dyn`` marks the int8 leaves
    W8A8, off leaves the tree as it is."""
    if not mode:
        return params
    return quantize_tree(params, bits=4 if mode == "int4" else 8, act_quant=mode == "int8-dyn")


def quantize_tree(params: Any, min_size: int | None = None, bits: int = 8, act_quant: bool = False) -> Any:
    """Quantize every big floating 2-D or stacked 3-D matrix of a parameter
    tree (nested dicts/lists of tensors) to int8 (``bits=8``) or packed int4
    (``bits=4``); ``act_quant=True`` makes the int8 leaves
    :class:`DynQuantWeight`.  The JAX package's skip rules: leaves whose path
    mentions ``embed``, ``norm`` or ``scale``, integer leaves, leaves under
    *min_size* elements, other ranks, and already quantized leaves pass
    through.  Stacked (L, in, out) leaves quantize per layer and channel (and
    pack to (L, in/2, out)).  int4 needs an even input dim; an odd one falls
    back to int8.  *min_size* defaults to ``_MIN_SIZE``."""
    min_size = _MIN_SIZE if min_size is None else min_size
    int8_cls = DynQuantWeight if act_quant else QuantWeight

    def convert(path: str, leaf):
        if isinstance(leaf, QUANT_TYPES) or not isinstance(leaf, torch.Tensor):
            return leaf
        if "embed" in path or "norm" in path or "scale" in path:
            return leaf
        if not leaf.is_floating_point() or leaf.numel() < min_size:
            return leaf
        if leaf.dim() not in (2, 3):
            return leaf
        dim = leaf.dim() - 2  # the input dim
        if bits == 4 and leaf.shape[dim] % 2 == 0:
            q4, scale = _quantize(leaf.float(), dim, 7.0)
            return Quant4Weight(_pack_nibbles(q4, dim), scale.squeeze(dim))
        q, scale = _quantize(leaf.float(), dim, 127.0)
        return int8_cls(q, scale.squeeze(dim))

    def walk(node, path: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, QUANT_TYPES):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(node))
        return convert(path, node)

    return walk(params, "")
