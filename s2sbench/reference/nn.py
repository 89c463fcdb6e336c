"""Plain f32 building blocks of the reference, and its precisions.

The reference is plain PyTorch: it imports nothing of the program and
nothing of JAX.  Every product runs in f32 with TF32 off
(:func:`f32_numerics`); a weight enters a product as the configuration
states it (:func:`weight`):

- ``"bf16"``: the bf16 value, exactly, in f32;
- ``"int8"`` / ``"int4"``: per-output-channel symmetric quantization of the
  bf16 weight along its input dim, ``scale = max(amax / qmax, 1e-12)``,
  round half to even, clip to +-qmax (qmax 127 or 7), dequantized in f32;
- ``"fp8"``: the weight rounded to float8 e4m3 under a per-output-channel
  scale ``amax / 448``, in f32 (and, where a model computes in fp8, each
  product's input rounded so too: :func:`activation`).

The control runs the same code one step down (:data:`BELOW`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: the nearest precision below each stated one, for the control
BELOW = {"bf16": "fp8", "int8": "int4", "int4": "int4"}
QMAX = {"int8": 127.0, "int4": 7.0}


def f32_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def weight(w: torch.Tensor, precision: str, in_dim: int = -2) -> torch.Tensor:
    """*w* (a 2-D (in, out) or conv weight) in f32 at *precision*; the
    per-channel scale runs over every dim but the output's, which is the
    last for a matrix (``in_dim`` -2) and the first for a conv weight."""
    w32 = w.float()
    if precision == "bf16":
        return w32
    if w32.dim() == 2 and in_dim == -2:
        reduce = (0,)
    else:
        reduce = tuple(range(1, w32.dim()))
    amax = w32.abs().amax(dim=reduce, keepdim=True)
    if precision in QMAX:
        qmax = QMAX[precision]
        scale = torch.clamp_min(amax / torch.full_like(amax, qmax), 1e-12)
        return torch.clamp(torch.round(w32 / scale), -qmax, qmax) * scale
    if precision == "fp8":
        scale = torch.clamp_min(amax / 448.0, 1e-12)
        return (w32 / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


def activation(x: torch.Tensor, precision: str) -> torch.Tensor:
    """*x* as a product's input at *precision*: rounded to float8 e4m3 under
    a scale of each row's amax / 448 for ``"fp8"``, unchanged otherwise."""
    if precision != "fp8":
        return x
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 448.0, 1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def quantized_leaf(path: str, w: torch.Tensor, min_size: int = 1 << 16) -> bool:
    """Whether the configuration's int8 or int4 mode quantizes the leaf at
    *path* (a layer's slice of a stacked matrix counts by the whole
    stacked leaf's size): floating matrices of at least *min_size*
    elements whose name mentions neither ``embed``, ``norm`` nor ``scale``."""
    if "embed" in path or "norm" in path or "scale" in path:
        return False
    return w.is_floating_point() and w.dim() in (2, 3) and w.numel() >= min_size


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).pow(2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w.float() + b.float()


def rope(head_dim: int, t: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim))
    freqs = torch.outer(torch.arange(t, dtype=torch.float64, device=device), inv)
    return torch.cos(freqs).float(), torch.sin(freqs).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[..., 2i], x[..., 2i+1]); x (B, H, T, D)."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


def attention(q, k, v, mask) -> torch.Tensor:
    """q (B, H, Tq, D), k and v (B, Hkv, Tk, D), mask (Tq, Tk) True = keep."""
    if k.shape[1] != q.shape[1]:
        k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
        v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def causal(t: int, device, window: int | None = None) -> torch.Tensor:
    q = torch.arange(t, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    keep = kpos <= q
    if window is not None:
        keep &= kpos > q - window
    return keep


def silu(x):
    return F.silu(x)
