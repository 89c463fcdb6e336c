"""Weight bridge: the JAX package's parameter trees -> the port's tensors.

Accepts what the JAX side produces or stores: nested dicts/lists of numpy
arrays (or anything ``np.asarray`` reads, bf16 included), the JAX
``QuantWeight`` named tuple, or an ``unflatten_params`` tree loaded from a
converted ``.npz`` checkpoint.  Returns the same tree as torch tensors on a
given device, with the two layout changes the port makes:

- convolution weights stored by the JAX package as NTC/TIO ``(k, in/g, out)``
  become PyTorch's Conv1d ``(out, in/g, k)``;
- transposed-convolution weights, stored pre-flipped as ``(k, in, out)``,
  become PyTorch's ConvTranspose1d ``(in, out, k)``.

Those are the inverses of the transforms in the JAX package's checkpoint
converters (``convert_c2w_state_dict``, parakeet ``convert_state_dict``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from s2s_tpu_torch.ops.quant import QuantWeight


def to_tensor(value: Any, device: torch.device | str) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def tree_to_torch(tree: Any, device: torch.device | str) -> Any:
    """Every array or tensor leaf -> tensor on *device*; a ``QuantWeight``
    (the JAX package's or the port's) -> the port's :class:`QuantWeight`.
    The other quantized types are not ported."""
    kind = type(tree).__name__
    if kind == "QuantWeight":
        return QuantWeight(to_tensor(tree.q, device), to_tensor(tree.scale, device))
    if kind in ("DynQuantWeight", "Quant4Weight"):
        raise NotImplementedError(f"{kind} is not ported to s2s_tpu_torch (ROADMAP queue 2)")
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    return to_tensor(tree, device)


def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(..., k, in/g, out) TIO -> (..., out, in/g, k) Conv1d layout."""
    return w.transpose(-1, -3).contiguous()


def trans_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """Pre-flipped (k, in, out) -> ConvTranspose1d (in, out, k)."""
    return w.flip(0).permute(1, 2, 0).contiguous()


def parakeet_params(tree: Any, device: torch.device | str) -> Any:
    p = tree_to_torch(tree, device)
    conv = p["blocks"]["conv"]
    conv["dw_w"] = conv_weight(conv["dw_w"])  # stacked (L, k, 1, d) -> (L, d, 1, k)
    return p


def c2w_params(c2w: Any) -> Any:
    """Convert the conv leaves of a Code2Wav tree already on torch."""
    for blk in c2w["upsample"]:
        blk["tconv"]["w"] = trans_conv_weight(blk["tconv"]["w"])
        blk["convnext"]["dw_w"] = conv_weight(blk["convnext"]["dw_w"])
    c2w["dec_in"]["w"] = conv_weight(c2w["dec_in"]["w"])
    for blk in c2w["dec_blocks"]:
        blk["tconv"]["w"] = trans_conv_weight(blk["tconv"]["w"])
        for unit in blk["units"]:
            unit["conv1"]["w"] = conv_weight(unit["conv1"]["w"])
            unit["conv2"]["w"] = conv_weight(unit["conv2"]["w"])
    c2w["dec_out"]["w"] = conv_weight(c2w["dec_out"]["w"])
    return c2w


def qwen3_tts_params(tree: Any, device: torch.device | str) -> Any:
    p = tree_to_torch(tree, device)
    c2w_params(p["c2w"])
    return p
