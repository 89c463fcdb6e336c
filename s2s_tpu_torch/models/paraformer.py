"""Paraformer non-autoregressive ASR in PyTorch, the port of
``s2s_tpu/models/paraformer.py`` (FunASR's ``speech_paraformer-large``).

The same architecture, tree and numerics (f32) as the JAX package:

- **SAN-M encoder** — joint QKV projection with a depthwise FSMN memory
  block on the value path added to the attention output; the first layer
  maps the 560-dim LFR features into the model width (no residual there);
  sinusoidal positions (starting at 1, sin and cos halves) added after the
  sqrt(d) scaling.
- **CIF v2 predictor** — a k=3 convolution, sigmoid alphas, a 0.45-alpha
  tail frame, then integrate-and-fire as one dense frame->token overlap
  product (with threshold 1 and per-frame alpha < 1 it is the sequential
  fire loop).
- **SAN-M decoder (NAR)** — per layer a feed-forward with inner LayerNorm,
  a depthwise FSMN self block and cross attention over the encoder; one
  feed-forward-only layer (``decoders3``), the after-norm and the vocab
  head.  Every CIF token decodes in one bidirectional pass.

Both attentions are masked with the JAX package's additive mask
(``(1 - mask) * finfo(f32).min``), so padded frames give the same numbers;
they stay on the plain path (no kernel).  The FSMN blocks are depthwise
``F.conv1d``; the predictor's k=3 convolution is a product over 3-tap
windows, so it stays in full f32 under cuDNN's TF32 default.  The CIF
prefix sum runs in XLA-on-CPU's order
(:func:`~s2s_tpu_torch.models.common.xla_cumsum`): ``n_tokens`` is
its floor, and another order can flip it by one.

:func:`forward` is one device program per utterance; the caller reads back
only the token ids and ``n_tokens``.  :func:`lfr_cmvn` (LFR stack 7 /
stride 6, then CMVN) runs on the device: edge-replicated padding and a
window view, exact against the JAX package's numpy version.

Layouts: the JAX package's tree, with the FSMN weights in depthwise
Conv1d layout ``(D, 1, K)`` and the predictor's convolution in Conv1d
layout ``(d, d, 3)`` (:func:`s2s_tpu_torch.weights.paraformer_params`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch import weights
from s2s_tpu_torch.models.common import HostStateDict, Params, layer_norm, tree_to_device, xla_cumsum
from s2s_tpu_torch.models.decoder_lm import normal

LFR_M = 7  # stacked frames
LFR_N = 6  # stride


@dataclass(frozen=True)
class ParaformerConfig:
    input_size: int = 560  # 80 fbank x LFR_M
    d_model: int = 512
    n_heads: int = 4
    d_ff: int = 2048
    n_enc: int = 50  # encoders0 (1) + encoders (49)
    n_dec: int = 16
    vocab_size: int = 8404
    enc_kernel: int = 11
    dec_kernel: int = 11
    threshold: float = 1.0
    tail_threshold: float = 0.45
    max_frames: int = 512  # LFR frames bucket (~30 s)
    max_tokens: int = 128
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def test_tiny() -> "ParaformerConfig":
        return ParaformerConfig(
            input_size=28, d_model=16, n_heads=2, d_ff=32, n_enc=2, n_dec=2,
            vocab_size=40, max_frames=32, max_tokens=16)


# ---------------------------------------------------------------------------
# frontend: LFR + CMVN on the device
# ---------------------------------------------------------------------------


def lfr_cmvn(fbank: torch.Tensor, cmvn_mean: torch.Tensor | None = None,
             cmvn_scale: torch.Tensor | None = None) -> torch.Tensor:
    """fbank (T, 80) -> LFR-stacked (ceil(T/6), 560) with CMVN applied:
    ``LFR_M // 2`` first rows and ``LFR_M`` last rows repeated at the
    edges, then row i stacks padded rows ``6i .. 6i+6``."""
    t = fbank.shape[0]
    n_out = -(-t // LFR_N)
    padded = F.pad(fbank.T[None], (LFR_M // 2, LFR_M), mode="replicate")[0].T  # (T + 10, 80)
    out = padded.unfold(0, LFR_M, LFR_N)[:n_out]  # (n_out, 80, LFR_M)
    out = out.transpose(1, 2).reshape(n_out, -1)
    if cmvn_mean is not None:
        out = (out + cmvn_mean) * cmvn_scale
    return out.float()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _lin(x, w, b=None):
    out = x.float() @ w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def _fsmn(x, w, mask, kernel: int):
    """Depthwise FSMN memory: pad (k-1)//2 left and the rest right, conv,
    +residual, mask.  x: (B, T, D); w: (D, 1, K)."""
    xm = x * mask
    left = (kernel - 1) // 2
    h = F.conv1d(F.pad(xm.transpose(1, 2), (left, kernel - 1 - left)), w.to(x.dtype), groups=x.shape[-1])
    return (h.transpose(1, 2) + xm) * mask


def _masked_attention(q, k, v, mask, dtype):
    """Softmax attention over (B, H, T, hd) with the JAX package's additive
    key mask: mask (B, Tk, 1), 1 = keep."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    neg = torch.finfo(torch.float32).min
    scores = scores + (1.0 - mask[:, None, :, 0][:, :, None, :]) * neg
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def _heads(x, nh):
    b, t, d = x.shape
    return x.reshape(b, t, nh, d // nh).transpose(1, 2)


def _merge(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _sanm_attention(p, cfg: ParaformerConfig, x, mask):
    """SAN-M: joint QKV + FSMN memory on V, added to the attention output."""
    qkv = _lin(x, p["qkv_w"], p["qkv_b"])
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    fsmn_memory = _fsmn(v, p["fsmn_w"], mask, cfg.enc_kernel)
    ctx = _masked_attention(_heads(q, cfg.n_heads), _heads(k, cfg.n_heads), _heads(v, cfg.n_heads), mask, x.dtype)
    return _lin(_merge(ctx), p["out_w"], p["out_b"]) + fsmn_memory


def _enc_layer(p, cfg: ParaformerConfig, x, mask, first: bool):
    h = layer_norm(x, p["norm1_w"], p["norm1_b"])
    h = _sanm_attention(p, cfg, h, mask)
    x = h if first else x + h
    h = layer_norm(x, p["norm2_w"], p["norm2_b"])
    h = _lin(torch.relu(_lin(h, p["ff_w1"], p["ff_b1"])), p["ff_w2"], p["ff_b2"])
    return x + h


def _sinusoid_positions(t: int, dim: int, device):
    positions = torch.arange(1, t + 1, dtype=torch.float32, device=device)
    log_inc = math.log(10000.0) / (dim / 2 - 1)
    inv = torch.exp(torch.arange(dim // 2, dtype=torch.float32, device=device) * -log_inc)
    scaled = positions[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def encode(params: Params, cfg: ParaformerConfig, feats, mask):
    """feats: (B, T, input_size) LFR features; mask: (B, T, 1)."""
    x = feats.to(cfg.dtype) * (cfg.d_model ** 0.5)
    x = x + _sinusoid_positions(x.shape[1], cfg.input_size, x.device)[None].to(cfg.dtype)
    x = x * mask
    x = _enc_layer(params["enc0"], cfg, x, mask, first=True)
    for p in params["enc"]:
        x = _enc_layer(p, cfg, x, mask, first=False)
    return layer_norm(x, params["enc_norm_w"], params["enc_norm_b"]) * mask


# ---------------------------------------------------------------------------
# CIF v2: alphas + dense integrate-and-fire
# ---------------------------------------------------------------------------


def cif_alphas(params: Params, cfg: ParaformerConfig, enc, mask):
    p = params["predictor"]
    # k=3, padding 1: a product of each 3-tap window with the (d, d, 3) weight
    windows = F.pad(enc * mask, (0, 0, 1, 1)).unfold(1, 3, 1)  # (B, T, d, 3)
    h = (windows.flatten(2).float() @ p["conv_w"].flatten(1).T.float()).to(enc.dtype) + p["conv_b"]
    h = torch.relu(h + enc)
    alphas = torch.sigmoid(_lin(h, p["out_w"], p["out_b"]))[..., 0]
    return alphas * mask[..., 0]


def cif_fire(enc, alphas, cfg: ParaformerConfig):
    """Dense integrate-and-fire (threshold 1): token j's acoustic embed is
    sum_t overlap([cum[t-1], cum[t]], [j, j+1]) * enc[t] — one product.
    Appends the 0.45-alpha zero-vector tail frame.  Returns
    (acoustic (B, max_tokens, D), n_tokens (B,) int32)."""
    b, t, d = enc.shape
    tail = torch.full((b, 1), cfg.tail_threshold, dtype=alphas.dtype, device=alphas.device)
    alphas = torch.cat([alphas, tail], dim=1)  # (B, T+1)
    enc = torch.cat([enc, torch.zeros((b, 1, d), dtype=enc.dtype, device=enc.device)], dim=1)
    cum = xla_cumsum(alphas.float()[..., None])[..., 0]
    lo = torch.cat([torch.zeros((b, 1), dtype=torch.float32, device=cum.device), cum[:, :-1]], dim=1)
    j = torch.arange(cfg.max_tokens, dtype=torch.float32, device=cum.device)
    # overlap of frame interval [lo, cum) with token interval [j, j+1)
    w = torch.clamp(torch.minimum(cum[:, None, :], j[None, :, None] + 1.0)
                    - torch.maximum(lo[:, None, :], j[None, :, None]), 0.0, 1.0)
    acoustic = torch.matmul(w, enc.float()).to(enc.dtype)
    n_tokens = torch.clamp(torch.floor(cum[:, -1]).to(torch.int32), max=cfg.max_tokens)
    return acoustic, n_tokens


# ---------------------------------------------------------------------------
# SAN-M NAR decoder
# ---------------------------------------------------------------------------


def _cross_attention(p, cfg: ParaformerConfig, x, memory, memory_mask):
    q = _heads(_lin(x, p["q_w"], p["q_b"]), cfg.n_heads)
    k, v = torch.chunk(_lin(memory, p["kv_w"], p["kv_b"]), 2, dim=-1)
    ctx = _masked_attention(q, _heads(k, cfg.n_heads), _heads(v, cfg.n_heads), memory_mask, x.dtype)
    return _lin(_merge(ctx), p["out_w"], p["out_b"])


def _dec_ff(p, x):
    h = torch.relu(_lin(x, p["ff_w1"], p["ff_b1"]))
    h = layer_norm(h, p["ff_norm_w"], p["ff_norm_b"])
    return _lin(h, p["ff_w2"])  # no bias (PositionwiseFeedForwardDecoderSANM)


def _dec_layer(p, cfg: ParaformerConfig, x, tgt_mask, memory, memory_mask):
    x = x + _dec_ff(p, layer_norm(x, p["norm1_w"], p["norm1_b"]))
    # the FSMN block already adds its input internally; the layer adds its
    # own residual around it (matches DecoderLayerSANM)
    h = layer_norm(x, p["norm2_w"], p["norm2_b"])
    x = x + _fsmn(h, p["fsmn_w"], tgt_mask, cfg.dec_kernel)
    h = layer_norm(x, p["norm3_w"], p["norm3_b"])
    return x + _cross_attention(p, cfg, h, memory, memory_mask)


def decode(params: Params, cfg: ParaformerConfig, acoustic, tgt_mask, enc, enc_mask):
    x = acoustic
    for p in params["dec"]:
        x = _dec_layer(p, cfg, x, tgt_mask, enc, enc_mask)
    p3 = params["dec3"]
    x = x + _dec_ff(p3, layer_norm(x, p3["norm1_w"], p3["norm1_b"]))
    x = layer_norm(x, params["dec_norm_w"], params["dec_norm_b"])
    return _lin(x, params["head_w"], params["head_b"]).float()


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------


@torch.inference_mode()
def forward(params: Params, cfg: ParaformerConfig, feats, n_frames):
    """feats: (B, max_frames, input_size); n_frames: (B,) int tensor.
    Returns (token ids (B, max_tokens) int32, n_tokens (B,) int32), on the
    device."""
    b, t, _ = feats.shape
    mask = (torch.arange(t, device=feats.device)[None, :] < n_frames[:, None]).to(cfg.dtype)[..., None]
    enc = encode(params, cfg, feats, mask)
    alphas = cif_alphas(params, cfg, enc, mask)
    acoustic, n_tokens = cif_fire(enc, alphas, cfg)
    tgt_mask = (torch.arange(cfg.max_tokens, device=feats.device)[None, :]
                < n_tokens[:, None]).to(cfg.dtype)[..., None]
    logits = decode(params, cfg, acoustic * tgt_mask, tgt_mask, enc, mask)
    return torch.argmax(logits, dim=-1).to(torch.int32), n_tokens


def transcribe_tokens(params: Params, cfg: ParaformerConfig, feats: torch.Tensor, n_frames: int) -> list[int]:
    """LFR features (T, input_size) on the device -> token id list: one
    forward, then one read back of the ids and the count."""
    t = min(feats.shape[0], cfg.max_frames)
    buf = torch.zeros((1, cfg.max_frames, cfg.input_size), dtype=torch.float32, device=feats.device)
    buf[0, :t] = feats[:t]
    n_valid = torch.tensor([min(n_frames, t)], dtype=torch.int32, device=feats.device)
    ids, n = forward(params, cfg, buf, n_valid)
    out = torch.cat([n, ids[0]]).tolist()
    return out[1: 1 + out[0]]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ParaformerConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*: the JAX package's
    distributions and tree (its layouts, then
    :func:`s2s_tpu_torch.weights.paraformer_params`), not its numbers."""
    d, dt = cfg.d_model, cfg.dtype

    def rnd(shape, scale):
        return normal(gen, shape, scale, dt, device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def enc_layer(in_size):
        return {
            "norm1_w": ones(in_size), "norm1_b": zeros(in_size),
            "qkv_w": rnd((in_size, 3 * d), in_size ** -0.5), "qkv_b": zeros(3 * d),
            "fsmn_w": rnd((cfg.enc_kernel, 1, d), cfg.enc_kernel ** -0.5),
            "out_w": rnd((d, d), d ** -0.5), "out_b": zeros(d),
            "norm2_w": ones(d), "norm2_b": zeros(d),
            "ff_w1": rnd((d, cfg.d_ff), d ** -0.5), "ff_b1": zeros(cfg.d_ff),
            "ff_w2": rnd((cfg.d_ff, d), cfg.d_ff ** -0.5), "ff_b2": zeros(d),
        }

    def dec_layer(with_self=True, with_src=True):
        p = {
            "norm1_w": ones(d), "norm1_b": zeros(d),
            "ff_w1": rnd((d, cfg.d_ff), d ** -0.5), "ff_b1": zeros(cfg.d_ff),
            "ff_norm_w": ones(cfg.d_ff), "ff_norm_b": zeros(cfg.d_ff),
            "ff_w2": rnd((cfg.d_ff, d), cfg.d_ff ** -0.5),
        }
        if with_self:
            p.update(norm2_w=ones(d), norm2_b=zeros(d),
                     fsmn_w=rnd((cfg.dec_kernel, 1, d), cfg.dec_kernel ** -0.5))
        if with_src:
            p.update(norm3_w=ones(d), norm3_b=zeros(d),
                     q_w=rnd((d, d), d ** -0.5), q_b=zeros(d),
                     kv_w=rnd((d, 2 * d), d ** -0.5), kv_b=zeros(2 * d),
                     out_w=rnd((d, d), d ** -0.5), out_b=zeros(d))
        return p

    tree = {
        "enc0": enc_layer(cfg.input_size),
        "enc": [enc_layer(d) for _ in range(cfg.n_enc - 1)],
        "enc_norm_w": ones(d), "enc_norm_b": zeros(d),
        "predictor": {
            "conv_w": rnd((3, d, d), (3 * d) ** -0.5), "conv_b": zeros(d),
            "out_w": rnd((d, 1), d ** -0.5), "out_b": zeros(1),
        },
        "dec": [dec_layer() for _ in range(cfg.n_dec)],
        "dec3": dec_layer(with_self=False, with_src=False),
        "dec_norm_w": ones(d), "dec_norm_b": zeros(d),
        "head_w": rnd((d, cfg.vocab_size), d ** -0.5),
        "head_b": zeros(cfg.vocab_size),
        "cmvn_mean": torch.zeros((cfg.input_size,), dtype=torch.float32, device=device),
        "cmvn_scale": torch.ones((cfg.input_size,), dtype=torch.float32, device=device),
    }
    return weights.paraformer_params(tree, device)


# ---------------------------------------------------------------------------
# checkpoint conversion: the JAX package's numpy converter, its tree on a device
# ---------------------------------------------------------------------------


def convert_state_dict(sd: dict, cfg: ParaformerConfig = ParaformerConfig(), device: torch.device | str = "cpu") -> Params:
    """FunASR paraformer checkpoint -> the JAX package's tree on *device* (twin layout, see
    scripts/_paraformer_torch_twin.py)."""
    sd = HostStateDict(sd)

    def t(name):
        return np.asarray(sd[name], np.float32)

    def lin_t(name):
        return t(name).T

    def enc_layer(prefix):
        return {
            "norm1_w": t(f"{prefix}.norm1.weight"), "norm1_b": t(f"{prefix}.norm1.bias"),
            "qkv_w": lin_t(f"{prefix}.self_attn.linear_q_k_v.weight"),
            "qkv_b": t(f"{prefix}.self_attn.linear_q_k_v.bias"),
            # torch depthwise conv (D, 1, K) -> (K, 1, D)
            "fsmn_w": t(f"{prefix}.self_attn.fsmn_block.weight").transpose(2, 1, 0),
            "out_w": lin_t(f"{prefix}.self_attn.linear_out.weight"),
            "out_b": t(f"{prefix}.self_attn.linear_out.bias"),
            "norm2_w": t(f"{prefix}.norm2.weight"), "norm2_b": t(f"{prefix}.norm2.bias"),
            "ff_w1": lin_t(f"{prefix}.feed_forward.w_1.weight"),
            "ff_b1": t(f"{prefix}.feed_forward.w_1.bias"),
            "ff_w2": lin_t(f"{prefix}.feed_forward.w_2.weight"),
            "ff_b2": t(f"{prefix}.feed_forward.w_2.bias"),
        }

    def dec_layer(prefix, with_self=True, with_src=True):
        p = {
            "norm1_w": t(f"{prefix}.norm1.weight"), "norm1_b": t(f"{prefix}.norm1.bias"),
            "ff_w1": lin_t(f"{prefix}.feed_forward.w_1.weight"),
            "ff_b1": t(f"{prefix}.feed_forward.w_1.bias"),
            "ff_norm_w": t(f"{prefix}.feed_forward.norm.weight"),
            "ff_norm_b": t(f"{prefix}.feed_forward.norm.bias"),
            "ff_w2": lin_t(f"{prefix}.feed_forward.w_2.weight"),
        }
        if with_self:
            p["norm2_w"] = t(f"{prefix}.norm2.weight")
            p["norm2_b"] = t(f"{prefix}.norm2.bias")
            p["fsmn_w"] = t(f"{prefix}.self_attn.fsmn_block.weight").transpose(2, 1, 0)
        if with_src:
            p["norm3_w"] = t(f"{prefix}.norm3.weight")
            p["norm3_b"] = t(f"{prefix}.norm3.bias")
            p["q_w"] = lin_t(f"{prefix}.src_attn.linear_q.weight")
            p["q_b"] = t(f"{prefix}.src_attn.linear_q.bias")
            p["kv_w"] = lin_t(f"{prefix}.src_attn.linear_k_v.weight")
            p["kv_b"] = t(f"{prefix}.src_attn.linear_k_v.bias")
            p["out_w"] = lin_t(f"{prefix}.src_attn.linear_out.weight")
            p["out_b"] = t(f"{prefix}.src_attn.linear_out.bias")
        return p

    params: Params = {
        "enc0": enc_layer("encoder.encoders0.0"),
        "enc": [enc_layer(f"encoder.encoders.{i}") for i in range(cfg.n_enc - 1)],
        "enc_norm_w": t("encoder.after_norm.weight"),
        "enc_norm_b": t("encoder.after_norm.bias"),
        "predictor": {
            "conv_w": t("predictor.cif_conv1d.weight").transpose(2, 1, 0),
            "conv_b": t("predictor.cif_conv1d.bias"),
            "out_w": lin_t("predictor.cif_output.weight"),
            "out_b": t("predictor.cif_output.bias"),
        },
        "dec": [dec_layer(f"decoder.decoders.{i}") for i in range(cfg.n_dec)],
        "dec3": dec_layer("decoder.decoders3.0", with_self=False, with_src=False),
        "dec_norm_w": t("decoder.after_norm.weight"),
        "dec_norm_b": t("decoder.after_norm.bias"),
        "head_w": lin_t("decoder.output_layer.weight"),
        "head_b": t("decoder.output_layer.bias"),
        "cmvn_mean": np.zeros((cfg.input_size,), np.float32),
        "cmvn_scale": np.ones((cfg.input_size,), np.float32),
    }
    if "cmvn_mean" in sd:
        params["cmvn_mean"] = t("cmvn_mean")
        params["cmvn_scale"] = t("cmvn_scale")
    return tree_to_device(params, device)
