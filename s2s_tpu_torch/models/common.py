"""Shared transformer building blocks (port of ``s2s_tpu/models/common.py``).

Plain functions on tensors, with the JAX package's layouts and numerics:

- activations keep their dtype; every product accumulates in f32 and norms,
  rope, softmax and logits run in f32;
- rope rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])``, the JAX
  layout, not Hugging Face's half split;
- weights are (in, out) matrices; ``linear`` dispatches on
  :class:`~s2s_tpu_torch.ops.quant.QuantWeight`.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from s2s_tpu_torch.ops.quant import QuantWeight, quantized_linear

Params = dict[str, Any]


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
    (GQA repeats kv heads); mask broadcastable to (B,1,Tq,Tk), True = keep."""
    h, d = q.shape[1], q.shape[3]
    hkv = k.shape[1]
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=1)
        v = torch.repeat_interleave(v, h // hkv, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def causal_mask(tq: int, tk: int, offset: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(1,1,tq,tk) mask: query at absolute pos offset+i attends keys <= that pos."""
    qpos = torch.arange(tq, device=device)[:, None] + offset
    kpos = torch.arange(tk, device=device)[None, :]
    return (kpos <= qpos)[None, None, :, :]


def length_mask(tk: int, valid_len: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(1,1,1,tk) mask keeping keys < valid_len."""
    return torch.arange(tk, device=device)[None, None, None, :] < valid_len


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b) with f32 accumulation, output in x's dtype.  An int8
    :class:`QuantWeight` goes through :func:`quantized_linear`."""
    if isinstance(w, QuantWeight):
        return quantized_linear(x, w, b)
    out = torch.matmul(x, w.to(x.dtype))
    return out + b if b is not None else out


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return linear(torch.nn.functional.silu(linear(x, w_gate)) * linear(x, w_up), w_down)


def layer_slice(layers: Params, i: int) -> Params:
    """Layer *i* of a stacked layer tree: every tensor indexed on its leading
    axis, a stacked QuantWeight sliced to its 2-D (in, out) form."""
    out: Params = {}
    for name, leaf in layers.items():
        if isinstance(leaf, QuantWeight):
            out[name] = QuantWeight(leaf.q[i], leaf.scale[i])
        elif isinstance(leaf, dict):
            out[name] = layer_slice(leaf, i)
        else:
            out[name] = leaf[i]
    return out


def n_stacked(layers: Params) -> int:
    """Number of layers in a stacked layer tree."""
    for leaf in layers.values():
        if isinstance(leaf, QuantWeight):
            return leaf.q.shape[0]
        if isinstance(leaf, dict):
            return n_stacked(leaf)
        return leaf.shape[0]
    raise ValueError("empty layer tree")
