"""Flash attention forward (unmasked, optionally causal).

The port of the TPU Pallas kernel ``s2s_tpu/ops/pallas_attention.py::flash_attention``
as a hand-written CUDA kernel for Hopper (``csrc/flash_attention.cu``, whose
header says what bounds it and how the design answers that).  It computes
``softmax(q k^T * scale) v`` with f32 logits, a running max and sum per query
row, and one division at the end; the output is in q's dtype.

- bf16 takes the tensor-core kernel: one block per query tile of a head,
  TMA copies of Q and of K/V tiles through a ring of shared-memory stages
  (:func:`tensor_core_tiles`), both products by ``wgmma``, p rounded to
  bf16 before PV (l summed from the f32 p).  f32 takes the CUDA-core
  kernel, p in f32.
- q (B, H, Tq, D); k, v (B, H, Tk, D); GQA callers repeat KV heads first.
- The Pallas kernel needs Tq and Tk to be multiples of its 128-row tiles;
  the CUDA kernels mask a ragged last tile themselves (keys >= Tk score
  -inf, query rows >= Tq are not written), so any Tq, Tk >= 1 is taken.  Head
  dims 64 and 128; the last axis must be contiguous (other strides are passed
  to the kernel, so the encoder's transposed head views need no copy), and
  the operands must be 16-byte aligned with strides in whole multiples of 16
  bytes (as every projection's head view is): what the 16-byte loads and
  the TMA tensor maps take.
- A tensor on the CPU takes the plain PyTorch version
  (:func:`flash_attention_reference`, p in f32 as the Pallas kernel); a CUDA
  tensor launches the kernel or raises.  There is no fallback.
- ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from s2s_tpu_torch.ops import _build

HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def tensor_core_tiles() -> dict[str, int]:
    """The bf16 kernel's tiles as ``csrc/flash_attention.cu`` defines them
    (this builds the library): ``query_tile`` queries per block (one consumer
    warpgroup), K/V tiles of ``key_tile`` keys through ``stages`` stages."""
    out = (ctypes.c_int * 3)()
    _build.load().s2s_flash_attention_tiles(out)
    return dict(zip(("query_tile", "key_tile", "stages"), out))


def use_flash_for(tq: int, d: int) -> bool:
    """Whether unmasked attention of *tq* queries with head dim *d* goes to
    :func:`flash_attention`.  Unlike the JAX package's rule (Tq and Tk
    multiples of 128, Tq >= 256, a TPU backend), tile alignment is not needed:
    the CUDA kernel takes a ragged edge.  So every Whisper duration bucket
    (50-1500 encoder positions) and Smart Turn's 400 take it; single-token
    and short prompts (the Whisper decoder's cross-attention, Tq 1-4) stay
    on the plain path.  The rule reads only the shape."""
    return tq >= 16 and d in HEAD_DIMS


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                              scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the Pallas kernel's math: (q * scale) k^T in
    f32, masked to keys <= the query position when *causal*, exp against the
    row max, p @ v in f32 with p unrounded, divided once by the row sum."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = torch.arange(tk, device=q.device)[None, :] <= torch.arange(tq, device=q.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p, v.float()) / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return out.to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash attention wants q (B, H, Tq, D), k and v (B, H, Tk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tuple(k.shape) != (b, h, tk, d) or tuple(v.shape) != (b, h, tk, d) or tq < 1 or tk < 1:
        raise ValueError(f"flash attention shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention wants one dtype of bf16/f32; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention operands on different devices")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention does not support head dim {d} (needs one of {HEAD_DIMS})")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash attention wants the head dim contiguous (stride 1)")
    vec = 16 // q.element_size()  # the 16-byte loads and the tensor maps' 16-byte strides
    if any(x.data_ptr() % 16 or any(st % vec for st in x.stride()[:3]) for x in (q, k, v)):
        raise ValueError(f"flash attention wants 16-byte aligned q, k, v with strides in multiples of {vec} "
                         f"elements; got strides {q.stride()}, {k.stride()}, {v.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """(B, H, Tq, D) attention, contiguous, in q's dtype.  CPU tensors take
    :func:`flash_attention_reference`; CUDA tensors launch
    ``csrc/flash_attention.cu`` on the current stream (built at first use):
    the tensor-core kernel for bf16, the CUDA-core kernel for f32; any
    shape, type, layout or launch error raises."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    lib = _build.load()
    with torch.cuda.device(q.device):
        out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
        err = lib.s2s_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, tq, tk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            _DTYPES[q.dtype], int(causal), ctypes.c_float(scale), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err} "
                           f"(B={b}, H={h}, Tq={tq}, Tk={tk}, D={d})")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
