"""Shared transformer building blocks (port of ``s2s_tpu/models/common.py``).

Plain functions on tensors, with the JAX package's layouts and numerics:

- activations keep their dtype; every product accumulates in f32 and norms,
  rope, softmax and logits run in f32;
- rope rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])``, the JAX
  layout, not Hugging Face's half split;
- weights are (in, out) matrices; ``linear`` dispatches on the quantized
  weight types of :mod:`s2s_tpu_torch.ops.quant`.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch.ops.flash_attention import flash_attention, use_flash_for
from s2s_tpu_torch.ops.quant import (
    QUANT_TYPES,
    DynQuantWeight,
    Quant4Weight,
    QuantWeight,
    quantized_linear,
    quantized_linear4,
    quantized_linear_dyn,
)

Params = dict[str, Any]


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axis it is split over (None: not split);
    dims past its length are not split.  ``P("model", None)``.  The port's
    own counterpart of JAX's, for :mod:`s2s_tpu_torch.parallel.mesh`."""

    def __new__(cls, *parts: str | None) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * weight).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(x.dtype)


@functools.lru_cache(maxsize=32)
def rope_frequencies(head_dim: int, max_t: int, theta: float, device: torch.device | str = "cpu"):
    """Cached cos/sin tables, shape (max_t, head_dim // 2), float32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_t, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., ::2], x[..., 1::2]).  x: (B, H, T, D); cos/sin:
    (T, D/2) already gathered for these positions; computed in f32."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


class KVCache(NamedTuple):
    """Per-layer (or layer-stacked) KV cache: (..., B, n_kv_heads, max_t, head_dim)."""

    k: torch.Tensor
    v: torch.Tensor

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> "KVCache":
        """Write (B, n_kv, t_new, d) at time offset *pos*.  Unlike the JAX
        version this writes IN PLACE into the existing buffers (no copy of
        the cache per step) and returns the same cache."""
        t = k_new.shape[2]
        self.k[:, :, pos : pos + t] = k_new.to(self.k.dtype)
        self.v[:, :, pos : pos + t] = v_new.to(self.v.dtype)
        return self


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Masked attention with f32 logits.  q: (B,H,Tq,D); k,v: (B,Hkv,Tk,D)
    (GQA repeats kv heads); mask broadcastable to (B,1,Tq,Tk), True = keep.

    Unmasked attention of at least 16 queries with head dim 64 or 128 (the
    Whisper and Smart Turn encoders) goes to
    :func:`s2s_tpu_torch.ops.flash_attention.flash_attention`: the CUDA
    kernel on the card, its plain version on the CPU (p unrounded).  The JAX
    package sends only tile-aligned shapes (Tq, Tk multiples of 128) to its
    Pallas kernel; the CUDA kernel takes a ragged edge, so the rule here
    needs no alignment (:func:`~s2s_tpu_torch.ops.flash_attention.use_flash_for`).
    Everything else takes the plain path, with p rounded to v's dtype as in
    the JAX package."""
    h, d = q.shape[1], q.shape[3]
    hkv = k.shape[1]
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=1)
        v = torch.repeat_interleave(v, h // hkv, dim=1)
    scale = scale if scale is not None else d ** -0.5
    if mask is None and use_flash_for(q.shape[2], d):
        return flash_attention(q, k, v, scale=scale)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(x, axis=1)`` of (B, T, C) in the JAX package's order of
    summation on the CPU (XLA's blocked rewrite): a left fold within blocks
    of 16 steps, plus the blocks' exclusive prefix, itself summed so.  Where
    a result hangs on the last ulps of a prefix sum (Kokoro's harmonic
    phase, times up to 2*pi*300; Paraformer's token count, its floor),
    another order gives another result."""
    b, n, c = x.shape
    nb = -(-n // 16)
    xb = F.pad(x, (0, 0, 0, nb * 16 - n)).reshape(b, nb, 16, c)
    acc, parts = xb[:, :, 0], [xb[:, :, 0]]
    for k in range(1, 16):
        acc = acc + xb[:, :, k]
        parts.append(acc)
    within = torch.stack(parts, dim=2)
    if nb > 1:
        offset = F.pad(xla_cumsum(within[:, :, -1])[:, :-1], (0, 0, 1, 0))
        within = within + offset[:, :, None]
    return within.reshape(b, nb * 16, c)[:, :n]


def causal_mask(tq: int, tk: int, offset: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(1,1,tq,tk) mask: query at absolute pos offset+i attends keys <= that pos."""
    qpos = torch.arange(tq, device=device)[:, None] + offset
    kpos = torch.arange(tk, device=device)[None, :]
    return (kpos <= qpos)[None, None, :, :]


def length_mask(tk: int, valid_len: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(1,1,1,tk) mask keeping keys < valid_len."""
    return torch.arange(tk, device=device)[None, None, None, :] < valid_len


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None, group=None) -> torch.Tensor:
    """x @ w (+ b) with f32 accumulation, output in x's dtype.  A quantized
    weight goes through its path: :class:`QuantWeight` W8A16,
    :class:`DynQuantWeight` W8A8 dynamic, :class:`Quant4Weight` packed int4.
    *group*: *w* is a row-parallel shard over that tensor-parallel group (a
    W8A8 weight then quantizes x by its rows' absmax across the ranks)."""
    if isinstance(w, QuantWeight):
        return quantized_linear(x, w, b)
    if isinstance(w, DynQuantWeight):
        return quantized_linear_dyn(x, w, b, group)
    if isinstance(w, Quant4Weight):
        return quantized_linear4(x, w, b)
    out = torch.matmul(x, w.to(x.dtype))
    return out + b if b is not None else out


def layer_slice(layers: Params, i: int) -> Params:
    """Layer *i* of a stacked layer tree: every tensor indexed on its leading
    axis, a stacked quantized weight sliced to its 2-D form."""
    out: Params = {}
    for name, leaf in layers.items():
        if isinstance(leaf, QUANT_TYPES):
            out[name] = type(leaf)(*(part[i] for part in leaf))
        elif isinstance(leaf, dict):
            out[name] = layer_slice(leaf, i)
        else:
            out[name] = leaf[i]
    return out


def unstack_layers(layers: Params) -> list[Params]:
    """Every layer of a stacked layer tree, as :func:`layer_slice` gives
    them, from one ``unbind`` a tensor: its backward is one stack, where a
    slice a layer writes a whole stacked gradient for each."""
    n = n_stacked(layers)

    def split(leaf) -> list:
        if isinstance(leaf, QUANT_TYPES):
            return [type(leaf)(*parts) for parts in zip(*(part.unbind(0) for part in leaf))]
        if isinstance(leaf, dict):
            subs = {name: split(sub) for name, sub in leaf.items()}
            return [{name: sub[i] for name, sub in subs.items()} for i in range(n)]
        return list(leaf.unbind(0))

    return split(layers)


def n_stacked(layers: Params) -> int:
    """Number of layers in a stacked layer tree."""
    for leaf in layers.values():
        if isinstance(leaf, QUANT_TYPES):
            return leaf.scale.shape[0]
        if isinstance(leaf, dict):
            return n_stacked(leaf)
        return leaf.shape[0]
    raise ValueError("empty layer tree")


def f32_weight(params: Params, name: str) -> torch.Tensor:
    """``params[name]`` in f32, made once and kept in *params* under
    ``name + "_f32"``: a head's logits are an f32 product, as the JAX
    package's dot with f32 output, and a cast at every call would copy the
    whole weight each decode step."""
    key = f"{name}_f32"
    w = params.get(key)
    if w is None:
        w = params[key] = params[name].float()
    return w


# ── checkpoint conversion ────────────────────────────────────────────
#
# The converters (``convert_*`` in each model module) take a state dict of
# numpy arrays or tensors, do their arithmetic with the JAX package's numpy
# calls on the host, and cast each result to its dtype on the device they
# are given: the trees they return are the JAX converters', leaf for leaf and
# bit for bit.


def host_array(value: Any) -> np.ndarray:
    """A state-dict entry (a numpy array or a tensor) as a numpy array on the
    host.  bf16, torch's or ``ml_dtypes``' in numpy, widens to f32 exactly:
    numpy has no bf16 of its own, and a cast back to bf16 on the device then
    gives the source's bits."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    arr = np.asarray(value)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


class HostStateDict(Mapping):
    """A read-only view of a state dict whose entries read as
    :func:`host_array`, one at a time, so a converter's numpy code runs on
    tensors and on bf16 sources unchanged."""

    def __init__(self, sd: Mapping) -> None:
        self._sd = sd

    def __getitem__(self, key: str) -> np.ndarray:
        return host_array(self._sd[key])

    def __contains__(self, key: object) -> bool:
        return key in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self) -> int:
        return len(self._sd)


def weight_norm(sd, prefix: str) -> np.ndarray:
    """A weight-normed convolution's weight in f32: ``<prefix>.weight`` as
    it is, or fused from ``weight_g``/``weight_v`` (or the parametrizations
    form) in f64, as the JAX package's Kokoro, ChatTTS and Mimi converters
    fuse it."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"], np.float32)
    if f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    else:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    g, v = np.asarray(g, np.float64), np.asarray(v, np.float64)
    norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1).reshape((-1,) + (1,) * (v.ndim - 1))
    return (g * v / norm).astype(np.float32)


def device_tensor(arr: np.ndarray, dtype: torch.dtype | None, device: torch.device | str) -> torch.Tensor:
    """*arr* on *device*, cast there to *dtype* (None keeps the array's), as
    ``jnp.asarray(arr, dtype)`` casts on JAX's default device."""
    t = torch.from_numpy(np.require(arr, requirements=("C", "W"))).to(device)
    return t if dtype is None else t.to(dtype)


def tree_to_device(tree: Any, device: torch.device | str) -> Any:
    """Every numpy leaf of a nested dict/list tree -> a tensor of its dtype on
    *device*."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_device(v, device) for v in tree)
    return device_tensor(np.asarray(tree), None, device)


def stack_layers(layers: list[Params]) -> Params:
    """Per-layer trees -> one tree whose leaves stack on a leading layer
    axis (the JAX package's ``stack_layers``)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([layer[k] for layer in layers]) for k in first}
    return torch.stack(layers)
