"""Decode attention over a frozen KV cache plus a tail (two key segments).

The port of the TPU Pallas kernel ``s2s_tpu/ops/decode_attention.py::decode_attention``
as a hand-written CUDA kernel for Hopper (``csrc/decode_attention.cu``, whose
header says what bounds it and how the design answers that).  The same kernel
carries the serving programs' attention, which the JAX package runs in XLA
(``s2s_tpu/parallel/batched_decode.py::_concat_attention``).

- :func:`concat_attention` is the tail form: one query per row against
  ``[cache keys < cache_len | tail keys < tail_len]`` in one softmax.
- :func:`decode_attention` is the Pallas contract: it writes the new K/V slot
  in place at ``pos`` and attends keys ``<= pos``, i.e. the tail form with
  ``cache_len = pos`` and a one-key tail.
- A tensor on the CPU takes the plain PyTorch version
  (:func:`concat_attention_reference`, a transcription of ``_concat_attention``);
  a CUDA tensor launches the kernel or raises.  There is no fallback.
- ``concat_attention.launches`` counts kernel launches (the plain version does
  not count), so a run can show that the main path went through the kernel.

Lengths are (B,) int32 tensors on the tensors' device, never host ints, so a
call needs no host sync.
"""

from __future__ import annotations

import ctypes

import torch

from s2s_tpu_torch.ops import _build

HEAD_DIMS = (64, 128)
MAX_GROUP = 8
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_CUDA_ERROR_INVALID_VALUE = 1


def concat_attention_reference(q, ck, cv, tk, tv, cache_len, tail_len) -> torch.Tensor:
    """Plain PyTorch version, line by line ``_concat_attention``.  q (B, H, hd);
    ck/cv (B, KV, T, hd); tk/tv (B, KV, n, hd); cache_len/tail_len (B,).
    f32 scores and softmax, p rounded to the cache dtype, f32 PV sums, one
    rounding to q's dtype.  Returns (B, H, hd).  A row with no valid key
    gets the mean of all keys' values (the masked softmax is uniform)."""
    b, h, hd = q.shape
    hkv = ck.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, hd).float()
    scale = hd ** -0.5
    cache_mask = (torch.arange(ck.shape[2], device=q.device)[None, :] < cache_len[:, None])[:, None, None, :]
    tail_mask = (torch.arange(tk.shape[2], device=q.device)[None, :] < tail_len[:, None])[:, None, None, :]
    s_c = torch.einsum("bkgd,bktd->bkgt", qg, ck.float()) * scale
    s_t = torch.einsum("bkgd,bktd->bkgt", qg, tk.float()) * scale
    s_c = s_c.masked_fill(~cache_mask, -1e30)
    s_t = s_t.masked_fill(~tail_mask, -1e30)
    p = torch.softmax(torch.cat([s_c, s_t], dim=-1), dim=-1)
    t_cache = ck.shape[2]
    p_c = p[..., :t_cache].to(cv.dtype)
    p_t = p[..., t_cache:].to(tv.dtype)
    out = (torch.einsum("bkgt,bktd->bkgd", p_c.float(), cv.float())
           + torch.einsum("bkgt,bktd->bkgd", p_t.float(), tv.float()))
    return out.reshape(b, h, hd).to(q.dtype)


def _check(q, ck, cv, tk, tv, cache_len, tail_len) -> None:
    if q.dim() != 3 or ck.dim() != 4 or tk.dim() != 4:
        raise ValueError(f"decode attention wants q (B, H, hd), caches (B, KV, T, hd), tails "
                         f"(B, KV, n, hd); got {tuple(q.shape)}, {tuple(ck.shape)}, {tuple(tk.shape)}")
    b, h, hd = q.shape
    _, kv, t, _ = ck.shape
    n = tk.shape[2]
    if tuple(cv.shape) != (b, kv, t, hd) or tuple(ck.shape) != (b, kv, t, hd) \
            or tuple(tk.shape) != (b, kv, n, hd) or tuple(tv.shape) != (b, kv, n, hd):
        raise ValueError(f"decode attention shape mismatch: q {tuple(q.shape)}, ck {tuple(ck.shape)}, "
                         f"cv {tuple(cv.shape)}, tk {tuple(tk.shape)}, tv {tuple(tv.shape)}")
    if tuple(cache_len.shape) != (b,) or tuple(tail_len.shape) != (b,):
        raise ValueError(f"decode attention lengths must be ({b},); got {tuple(cache_len.shape)}, "
                         f"{tuple(tail_len.shape)}")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in (ck, cv, tk, tv)):
        raise TypeError(f"decode attention wants one dtype of bf16/f32; got "
                        f"{[x.dtype for x in (q, ck, cv, tk, tv)]}")
    if cache_len.dtype != torch.int32 or tail_len.dtype != torch.int32:
        raise TypeError(f"decode attention lengths must be int32; got {cache_len.dtype}, {tail_len.dtype}")
    if any(x.device != q.device for x in (ck, cv, tk, tv, cache_len, tail_len)):
        raise ValueError("decode attention operands on different devices")
    if not all(x.is_contiguous() for x in (q, ck, cv, tk, tv, cache_len, tail_len)):
        raise ValueError("decode attention wants contiguous operands")
    if any(x.data_ptr() % 16 for x in (ck, cv, tk, tv)):
        raise ValueError("decode attention wants 16-byte aligned K/V tensors")
    if hd not in HEAD_DIMS or h % kv or h // kv > MAX_GROUP:
        raise ValueError(f"decode attention does not support hd={hd}, H={h}, KV={kv} "
                         f"(needs hd in {HEAD_DIMS}, H % KV == 0, H / KV <= {MAX_GROUP})")


def concat_attention(q, ck, cv, tk, tv, cache_len, tail_len) -> torch.Tensor:
    """(B, H, hd) attention of each row's query over its valid cache and tail
    keys.  CPU tensors take :func:`concat_attention_reference`; CUDA tensors
    launch ``csrc/decode_attention.cu`` on the current stream (built at first
    use) and raise on any shape, type, layout or launch error."""
    if q.device.type == "cpu":
        return concat_attention_reference(q, ck, cv, tk, tv, cache_len, tail_len)
    if q.device.type != "cuda":
        raise ValueError(f"concat_attention: unsupported device {q.device}")
    _check(q, ck, cv, tk, tv, cache_len, tail_len)
    b, h, hd = q.shape
    kv, t, n = ck.shape[1], ck.shape[2], tk.shape[2]
    lib = _build.load()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        err = lib.s2s_decode_attention(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), tk.data_ptr(), tv.data_ptr(),
            cache_len.data_ptr(), tail_len.data_ptr(), out.data_ptr(),
            b, h, kv, t, n, hd, _DTYPES[q.dtype], ctypes.c_float(hd ** -0.5),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        hint = ("; a block holds G*(T + n + 33*hd) f32 of shared memory, which may pass the "
                "card's limit" if err == _CUDA_ERROR_INVALID_VALUE else "")
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {err} "
                           f"(B={b}, H={h}, KV={kv}, T={t}, n={n}, hd={hd}){hint}")
    _build.count_launch(concat_attention)
    return out


concat_attention.launches = 0


def _write_slot(k_new, v_new, k_cache, v_cache, pos) -> None:
    """Each row's new (KV, hd) slot into its cache at its own ``pos``, in place."""
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[rows, :, pos.long()] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[rows, :, pos.long()] = v_new[:, :, 0].to(v_cache.dtype)


def decode_attention_reference(q, k_new, v_new, k_cache, v_cache, pos):
    """Plain version of :func:`decode_attention` (slot write + plain tail form)."""
    _write_slot(k_new, v_new, k_cache, v_cache, pos)
    ones = torch.ones_like(pos)
    return concat_attention_reference(q, k_cache, v_cache, k_new, v_new, pos, ones), k_cache, v_cache


def decode_attention(q, k_new, v_new, k_cache, v_cache, pos):
    """The Pallas kernel's contract: q (B, H, hd); k_new/v_new (B, KV, 1, hd);
    caches (B, KV, T, hd); pos (B,) int32.  Writes the new slots IN PLACE at
    each row's ``pos`` and returns (attn (B, H, hd), k_cache, v_cache), the
    attention over keys ``<= pos``: the tail form with ``cache_len = pos`` and
    the new slot as a one-key tail."""
    _write_slot(k_new, v_new, k_cache, v_cache, pos)
    ones = torch.ones_like(pos)
    return concat_attention(q, k_cache, v_cache, k_new, v_new, pos, ones), k_cache, v_cache
