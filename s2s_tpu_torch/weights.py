"""Weight bridge: the JAX package's parameter trees -> the port's tensors.

Accepts what the JAX side produces or stores: nested dicts/lists of numpy
arrays (or anything ``np.asarray`` reads, bf16 included), the JAX
package's quantized weights (``QuantWeight``, ``DynQuantWeight``,
``Quant4Weight``), or an ``unflatten_params`` tree loaded from a converted
``.npz`` checkpoint, where a bf16 leaf reads back as the two-byte void
array of its bits (``|V2``: numpy has no bf16 of its own; float16 is
stored as ``<f2``).  Returns the same tree as torch tensors on a given
device, with the layout changes the port makes:

- convolution weights stored by the JAX package as NTC/TIO ``(k, in/g, out)``
  become PyTorch's Conv1d ``(out, in/g, k)``;
- transposed-convolution weights, stored pre-flipped as ``(k, in/g, out)``,
  become PyTorch's ConvTranspose1d ``(in, out/g, k)``;
- a BiLSTM's ``(in, 4H)`` matrices in gate order i, f, g, o with one folded
  bias per direction become a ``torch.nn.LSTM`` (the bias as ``bias_ih``,
  ``bias_hh`` zero).

Those are the inverses of the transforms in the checkpoint converters
(``convert_c2w_state_dict``, parakeet ``convert_state_dict``, whisper and
vits ``convert_hf_state_dict``, the kokoro, mimi and chattts
``convert_state_dict``): the port's, in each model module, which give the
JAX package's trees bit for bit, and the JAX package's.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from s2s_tpu_torch.ops.quant import QUANT_TYPES

_QUANT_BY_NAME = {cls.__name__: cls for cls in QUANT_TYPES}


def to_tensor(value: Any, device: torch.device | str) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    # ml_dtypes bf16, or its bits as an .npz stores them (|V2): reinterpret
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def tree_to_torch(tree: Any, device: torch.device | str) -> Any:
    """Every array or tensor leaf -> tensor on *device*; a quantized weight
    (the JAX package's or the port's, matched by type name) -> the port's
    type of that name, field by field; optax's ``ScaleByAdamState`` (the
    Adam part of an ``optax.adamw`` state) -> the port's
    :class:`~s2s_tpu_torch.parallel.training.ScaleByAdamState`, its mu and
    nu as parameter trees; a module (the port's BiLSTMs) -> a copy on
    *device*."""
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device)
    cls = _QUANT_BY_NAME.get(type(tree).__name__)
    if cls is not None:
        return cls(*(to_tensor(part, device) for part in tree))
    if type(tree).__name__ == "ScaleByAdamState":  # optax's Adam state (count, mu, nu)
        from s2s_tpu_torch.parallel.training import ScaleByAdamState

        return ScaleByAdamState(*(tree_to_torch(part, device) for part in tree))
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    return to_tensor(tree, device)


def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(..., k, in/g, out) TIO -> (..., out, in/g, k) Conv1d layout."""
    return w.transpose(-1, -3).contiguous()


def trans_conv_weight(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Pre-flipped (k, in/g, out) -> ConvTranspose1d (in, out/g, k): group j
    maps inputs j*in/g.. to outputs j*out/g.. (a depthwise (k, 1, C) weight
    -> (C, 1, k))."""
    k, in_g, out = w.shape
    w = w.flip(0).reshape(k, in_g, groups, out // groups)
    return w.permute(2, 1, 3, 0).reshape(groups * in_g, out // groups, k).contiguous()


def lstm_module(p: Any, device: torch.device | str) -> torch.nn.LSTM:
    """A BiLSTM tree ``{w_ih_f, w_hh_f, b_f, w_ih_b, w_hh_b, b_b}`` ((in, 4H),
    (H, 4H), (4H,) each direction) -> a bidirectional batch-first
    ``torch.nn.LSTM`` on *device* holding the same weights, no gradients."""
    w_ih = to_tensor(p["w_ih_f"], device).float()
    lstm = torch.nn.LSTM(w_ih.shape[0], w_ih.shape[1] // 4, batch_first=True, bidirectional=True,
                         device="meta").to_empty(device=device)
    with torch.no_grad():
        for suffix, d in (("", "f"), ("_reverse", "b")):
            getattr(lstm, f"weight_ih_l0{suffix}").copy_(to_tensor(p[f"w_ih_{d}"], device).T)
            getattr(lstm, f"weight_hh_l0{suffix}").copy_(to_tensor(p[f"w_hh_{d}"], device).T)
            getattr(lstm, f"bias_ih_l0{suffix}").copy_(to_tensor(p[f"b_{d}"], device))
            getattr(lstm, f"bias_hh_l0{suffix}").zero_()
    lstm.requires_grad_(False)
    lstm.flatten_parameters()
    return lstm


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


def whisper_to_torch(tree: Any, device: torch.device | str) -> Any:
    """A Whisper or Smart Turn tree (encoder only or whole, Smart Turn's
    ``head`` kept as it is) -> tensors on *device*, the two encoder
    convolutions from ``(3, C_in, d)`` to Conv1d's ``(d, C_in, 3)``."""
    p = tree_to_torch(tree, device)
    p["conv1_w"] = conv_weight(p["conv1_w"])
    p["conv2_w"] = conv_weight(p["conv2_w"])
    return p


def silero_params(tree: Any, device: torch.device | str) -> Any:
    """A Silero VAD tree -> tensors on *device*, each convolution from
    ``(3, C_in, C_out)`` to Conv1d's ``(C_out, C_in, 3)``."""
    p = tree_to_torch(tree, device)
    for conv in p["convs"]:
        conv["w"] = conv_weight(conv["w"])
    return p


def kokoro_params(tree: Any, device: torch.device | str) -> Any:
    """A Kokoro tree (``s2s_tpu/models/kokoro.py`` layout: from its
    ``init_params`` or ``convert_state_dict``) -> the port's: tensors on
    *device*, convolutions in Conv1d layout, the transposed convolutions
    (the generator's upsamples and the depthwise pools) in ConvTranspose1d
    layout, each BiLSTM a ``torch.nn.LSTM``."""
    p = tree_to_torch(tree, device)

    def res_blk(blk):
        blk["conv1_w"] = conv_weight(blk["conv1_w"])
        blk["conv2_w"] = conv_weight(blk["conv2_w"])
        if "pool_w" in blk:
            blk["pool_w"] = trans_conv_weight(blk["pool_w"], groups=blk["pool_w"].shape[-1])

    def snake_blk(blk):
        blk["c1_w"] = [conv_weight(w) for w in blk["c1_w"]]
        blk["c2_w"] = [conv_weight(w) for w in blk["c2_w"]]

    pr = p["predictor"]
    for layer in pr["text_encoder"]["layers"]:
        layer["lstm"] = lstm_module(layer["lstm"], device)
    pr["lstm"] = lstm_module(pr["lstm"], device)
    pr["shared"] = lstm_module(pr["shared"], device)
    for blk in pr["F0"] + pr["N"]:
        res_blk(blk)
    te = p["text_encoder"]
    for c in te["cnn"]:
        c["conv_w"] = conv_weight(c["conv_w"])
    te["lstm"] = lstm_module(te["lstm"], device)
    dec = p["decoder"]
    for blk in [dec["encode"], *dec["decode"]]:
        res_blk(blk)
    dec["f0_conv_w"] = conv_weight(dec["f0_conv_w"])
    dec["n_conv_w"] = conv_weight(dec["n_conv_w"])
    g = dec["generator"]
    g["ups_w"] = [trans_conv_weight(w) for w in g["ups_w"]]
    g["noise_conv_w"] = [conv_weight(w) for w in g["noise_conv_w"]]
    for blk in g["res"] + g["noise_res"]:
        snake_blk(blk)
    g["post_w"] = conv_weight(g["post_w"])
    return p


def vits_params(tree: Any, device: torch.device | str) -> Any:
    """An MMS/VITS tree (``s2s_tpu/models/vits.py`` layout: from its
    ``init_params`` or ``convert_hf_state_dict``) -> the port's: tensors on
    *device*, every convolution in Conv1d layout (the depthwise ``(k, 1, C)``
    ones -> ``(C, 1, k)``), the HiFi-GAN upsamples in ConvTranspose1d layout."""
    p = tree_to_torch(tree, device)
    for layer in p["text_encoder"]["layers"]:
        layer["ffn_w1"] = conv_weight(layer["ffn_w1"])
        layer["ffn_w2"] = conv_weight(layer["ffn_w2"])
    dp = p["dp"]
    for dds in [dp["dds"], *(cf["dds"] for cf in dp["conv_flows"])]:
        for layer in dds:
            layer["dw_w"] = conv_weight(layer["dw_w"])
    for coupling in p["flow"]:
        coupling["wn"]["in_w"] = [conv_weight(w) for w in coupling["wn"]["in_w"]]
    dec = p["dec"]
    dec["pre_w"] = conv_weight(dec["pre_w"])
    dec["ups_w"] = [trans_conv_weight(w) for w in dec["ups_w"]]
    for blk in dec["res"]:
        blk["c1_w"] = [conv_weight(w) for w in blk["c1_w"]]
        blk["c2_w"] = [conv_weight(w) for w in blk["c2_w"]]
    dec["post_w"] = conv_weight(dec["post_w"])
    return p


def mimi_params(tree: Any, device: torch.device | str) -> Any:
    """A Mimi decoder tree (``s2s_tpu/models/mimi.py`` layout: from its
    ``init_decoder_params`` or ``convert_state_dict``/``convert_hf_state_dict``)
    -> the port's: tensors on *device*, the SEANet convolutions in Conv1d
    layout, its transposed convolutions in ConvTranspose1d layout, and the
    depthwise upsample's ``(k, C)`` kernel (the JAX side flips it itself) as
    ConvTranspose1d's ``(C, 1, k)``."""
    p = tree_to_torch(tree, device)
    p["upsample"]["w"] = p["upsample"]["w"].T[:, None, :].contiguous()
    p["init_conv"]["w"] = conv_weight(p["init_conv"]["w"])
    for blk in p["blocks"]:
        blk["up"]["w"] = trans_conv_weight(blk["up"]["w"])
        for unit in blk["units"]:
            unit["c1"]["w"] = conv_weight(unit["c1"]["w"])
            unit["c2"]["w"] = conv_weight(unit["c2"]["w"])
    p["final_conv"]["w"] = conv_weight(p["final_conv"]["w"])
    return p


def pocket_params(tree: Any, device: torch.device | str) -> Any:
    """A Pocket-TTS tree (``s2s_tpu/models/pocket_tts.py`` layout: from its
    ``init_params`` or ``convert_state_dict``, with or without its ``mimi``
    subtree) -> the port's: tensors on *device*; the LM side has no
    convolution and keeps its layout, ``mimi`` goes through
    :func:`mimi_params`."""
    p = tree_to_torch({k: v for k, v in tree.items() if k != "mimi"}, device)
    if "mimi" in tree:
        p["mimi"] = mimi_params(tree["mimi"], device)
    return p


def chattts_params(tree: Any, device: torch.device | str) -> Any:
    """A ChatTTS tree (``s2s_tpu/models/chattts.py`` layout: from its
    ``init_params`` or ``convert_state_dict``) -> the port's: tensors on
    *device*, the DVAE's and Vocos's convolutions (the depthwise ``(k, 1, C)``
    ones -> ``(C, 1, k)``) in Conv1d layout; the GPT and the linear layers
    keep theirs."""
    p = tree_to_torch(tree, device)
    dv, vc = p["dvae"], p["vocos"]
    for conv in [*dv["conv_in"], dv["out_conv"], vc["embed"],
                 *(blk["dw"] for blk in dv["blocks"]), *(layer["dw"] for layer in vc["layers"])]:
        conv["w"] = conv_weight(conv["w"])
    return p


def paraformer_params(tree: Any, device: torch.device | str) -> Any:
    """A Paraformer tree (``s2s_tpu/models/paraformer.py`` layout: from its
    ``init_params`` or ``convert_state_dict``) -> the port's: tensors on
    *device*, the FSMN blocks' depthwise ``(K, 1, D)`` weights as Conv1d's
    ``(D, 1, K)`` and the predictor's ``(3, d, d)`` convolution as
    ``(d, d, 3)``; the linear layers keep their ``(in, out)`` layout."""
    p = tree_to_torch(tree, device)
    for layer in [p["enc0"], *p["enc"], *p["dec"]]:
        layer["fsmn_w"] = conv_weight(layer["fsmn_w"])
    p["predictor"]["conv_w"] = conv_weight(p["predictor"]["conv_w"])
    return p


def vision_params(tree: Any, device: torch.device | str) -> Any:
    """A SigLIP tower + connector tree (``s2s_tpu/models/vision.py`` layout:
    from its ``init_params`` or ``convert_hf_state_dict``) -> tensors on
    *device*; the layout is kept (the patch weight HWIO ``(p, p, 3, d)``,
    which the port applies as a product over flattened patches)."""
    return tree_to_torch(tree, device)


def deepfilter_params(tree: Any, device: torch.device | str) -> Any:
    """A DeepFilter tree (``s2s_tpu/models/deepfilter.py`` layout: from its
    ``init_params`` or ``convert_state_dict``) -> tensors on *device*; the
    layout is kept (the convolutions' ``(kT, kF, Cin, Cout)`` weights, which
    the port applies as products over their windows)."""
    return tree_to_torch(tree, device)
