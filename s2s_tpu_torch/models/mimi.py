"""Mimi neural audio codec, decoder side, in PyTorch: the port of
``s2s_tpu/models/mimi.py`` (Défossez et al. 2024, arXiv:2410.00037; the
audio backend of Kyutai's Pocket TTS).

The same token -> waveform path, numerics (f32) and names as the JAX
package:

- **split RVQ dequantize**: 1 semantic codebook + (n_q - 1) acoustic
  codebooks, each group projected back to the latent dim and summed;
- **learnt upsample**: a depthwise transposed conv x2, 12.5 Hz -> 25 Hz,
  BEFORE the decoder transformer (``transformers.MimiModel``'s order);
- **decoder transformer**: causal layers over a sliding window of
  ``t_context`` frames (logits outside it filled with ``-1e9``), rope on
  concatenated halves (not ``decoder_lm``'s interleaved pairs), layer
  norms, exact GELU, LayerScale on both residual branches;
- **SEANet decoder**: a causal conv, then per stride ratio ELU ->
  transposed conv halving the channels (right-trimmed to ``T * stride``)
  -> residual units, then ELU + a conv to mono PCM at 24 kHz.

Layouts: activations (B, T, C); convolution weights are PyTorch's Conv1d
``(out, in, k)``, transposed convolutions' ConvTranspose1d ``(in, out, k)``
and the depthwise upsample's ``(C, 1, k)``.
:func:`s2s_tpu_torch.weights.mimi_params` carries the JAX package's trees
(``init_decoder_params``, the converters) across;
:func:`convert_state_dict` and :func:`convert_hf_state_dict` are the port's
own converters, giving those trees from a checkpoint.

Streaming re-decodes ``decode_deficit`` frames of left context per chunk,
as the JAX package does, so a streamed chunk equals the one-shot decode.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch import weights
from s2s_tpu_torch.models.common import HostStateDict, Params, layer_norm, linear, tree_to_device
from s2s_tpu_torch.models.common import weight_norm as _wn
from s2s_tpu_torch.models.decoder_lm import normal

SAMPLE_RATE = 24_000


@dataclass(frozen=True)
class MimiConfig:
    n_q: int = 8                  # codebooks in use (1 semantic + 7 acoustic)
    codebook_size: int = 2048
    codebook_dim: int = 256       # quantizer latent dim (projected to dim)
    dim: int = 512                # transformer / seanet latent dim
    # decoder transformer (12.5 Hz stream)
    t_layers: int = 8
    t_heads: int = 8
    t_ff: int = 2048
    t_context: int = 250          # causal sliding attention window (frames)
    rope_theta: float = 10000.0
    # seanet decoder
    n_filters: int = 64
    ratios: tuple = (8, 6, 5, 4)  # 25 Hz -> 24 kHz (x960)
    kernel: int = 7
    last_kernel: int = 3
    residual_kernel: int = 3
    dilations: tuple = (1,)       # dilation of each residual unit's first conv
    compress: int = 2             # residual-unit bottleneck divisor
    upsample_stride: int = 2      # learnt 12.5 -> 25 Hz depthwise resample
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.t_heads

    @property
    def hop(self) -> int:
        """Samples of audio per 12.5 Hz frame."""
        return int(np.prod(self.ratios)) * self.upsample_stride

    @staticmethod
    def mimi_24khz() -> "MimiConfig":
        return MimiConfig()

    @staticmethod
    def tiny() -> "MimiConfig":
        return MimiConfig(
            n_q=4, codebook_size=64, codebook_dim=16, dim=32, t_layers=2,
            t_heads=4, t_ff=64, t_context=16, n_filters=4, ratios=(4, 3),
            kernel=5, last_kernel=3,
        )


# ---------------------------------------------------------------------------
# init (random weights; real checkpoints come through the converters below)
# ---------------------------------------------------------------------------


def init_decoder_params(cfg: MimiConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init decoder weights drawn from *gen* on *device*: the JAX
    package's distributions and tree (its layouts, then
    :func:`s2s_tpu_torch.weights.mimi_params`), not its numbers."""

    def rnd(shape, scale=0.02):
        return normal(gen, shape, scale, torch.float32, device)

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    def conv(cin, cout, k):  # causal conv kernel stored (k, cin, cout) + bias
        return {"w": rnd((k, cin, cout), (cin * k) ** -0.5), "b": full(cout, 0.0)}

    d = cfg.dim

    def tlayer():
        return {
            "norm1_w": full(d, 1.0), "norm1_b": full(d, 0.0),
            "wq": rnd((d, d)), "wk": rnd((d, d)), "wv": rnd((d, d)), "wo": rnd((d, d)),
            "ls1": full(d, 0.01),  # LayerScale
            "norm2_w": full(d, 1.0), "norm2_b": full(d, 0.0),
            "w1": rnd((d, cfg.t_ff)), "w2": rnd((cfg.t_ff, d)),
            "ls2": full(d, 0.01),
        }

    p: Params = {
        # split RVQ: semantic (codebook 0) + acoustic (1..n_q-1)
        "sem_codebook": rnd((cfg.codebook_size, cfg.codebook_dim)),
        "sem_out_proj": rnd((cfg.codebook_dim, d)),
        "ac_codebooks": rnd((cfg.n_q - 1, cfg.codebook_size, cfg.codebook_dim)),
        "ac_out_proj": rnd((cfg.codebook_dim, d)),
        "tlayers": [tlayer() for _ in range(cfg.t_layers)],
        # depthwise transposed conv 12.5 -> 25 Hz: (k=2*stride, dim)
        "upsample": {"w": rnd((2 * cfg.upsample_stride, d))},
    }
    ch = cfg.n_filters * 2 ** len(cfg.ratios)
    p["init_conv"] = conv(d, ch, cfg.kernel)
    blocks = []
    for r in cfg.ratios:
        blk: Params = {"up": conv(ch, ch // 2, 2 * r)}
        ch //= 2
        blk["units"] = [{"c1": conv(ch, ch // cfg.compress, cfg.residual_kernel),
                         "c2": conv(ch // cfg.compress, ch, 1)} for _ in cfg.dilations]
        blocks.append(blk)
    p["blocks"] = blocks
    p["final_conv"] = conv(ch, 1, cfg.last_kernel)
    return weights.mimi_params(p, device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _causal_conv(x, p, dilation: int = 1, stride: int = 1):
    """x: (B, T, C); kernel (cout, cin, k); left-pad for causality."""
    pad = dilation * (p["w"].shape[-1] - 1)
    x = F.pad(x.transpose(1, 2), (pad, 0))
    return F.conv1d(x, p["w"], p["b"], stride, 0, dilation).transpose(1, 2)


def _causal_trans_conv(x, p, stride: int):
    """Causal transposed conv: (B, T, Cin) -> (B, T*stride, Cout), kernel
    (cin, cout, k), k = 2*stride: the full output's first T*stride samples
    (right-trim, matching streaming SEANet)."""
    out = F.conv_transpose1d(x.transpose(1, 2), p["w"], p.get("b"), stride)
    return out[..., : x.shape[1] * stride].transpose(1, 2)


def _upsample(x, w, stride: int):
    """Learnt depthwise transposed conv, kernel (C, 1, k): each channel's
    samples spread by its own kernel, the first T*stride outputs kept
    (causal right-trim of k - stride)."""
    b, t, c = x.shape
    out = F.conv_transpose1d(x.transpose(1, 2), w, None, stride, groups=c)
    return out[..., : t * stride].transpose(1, 2)


def dequantize(params: Params, cfg: MimiConfig, codes):
    """codes: (B, T, n_q) int -> latent (B, T, dim)."""
    codes = codes.long()
    sem = params["sem_codebook"][codes[..., 0]]  # (B, T, cd)
    latent = linear(sem.to(cfg.dtype), params["sem_out_proj"].to(cfg.dtype))
    ac = torch.zeros_like(sem)
    for q in range(cfg.n_q - 1):
        ac = ac + params["ac_codebooks"][q][codes[..., q + 1]]
    return latent + linear(ac.to(cfg.dtype), params["ac_out_proj"].to(cfg.dtype))


def _transformer(params: Params, cfg: MimiConfig, x):
    """Causal sliding-window rope transformer over (B, T, dim) frames."""
    b, t, d = x.shape
    h, hd = cfg.t_heads, cfg.head_dim
    pos = torch.arange(t, device=x.device)
    half = torch.arange(hd // 2, device=x.device, dtype=torch.float32)
    freqs = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32, device=x.device), -2.0 * half / hd)
    ang = pos[:, None].float() * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    rel = pos[:, None] - pos[None, :]  # tq - tk: how far BEHIND the key is
    mask = ((rel >= 0) & (rel < cfg.t_context))[None, None]  # causal sliding window
    # IEEE division by a tensor, as JAX divides (a host scalar may become a reciprocal product)
    scale = torch.tensor(math.sqrt(hd), dtype=x.dtype, device=x.device)

    def rope(v):  # (B, H, T, hd), halves concatenated
        v1, v2 = v[..., : hd // 2], v[..., hd // 2:]
        return torch.cat([v1 * cos - v2 * sin, v1 * sin + v2 * cos], dim=-1)

    def heads(y):
        return y.reshape(b, t, h, hd).transpose(1, 2)

    for lp in params["tlayers"]:
        hx = layer_norm(x, lp["norm1_w"], lp["norm1_b"])
        q, k, v = heads(linear(hx, lp["wq"])), heads(linear(hx, lp["wk"])), heads(linear(hx, lp["wv"]))
        q, k = rope(q), rope(k)
        logits = torch.matmul(q, k.transpose(-1, -2)) / scale
        logits = logits.masked_fill(~mask, -1e9)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
        x = x + linear(out, lp["wo"]) * lp["ls1"]
        hx = layer_norm(x, lp["norm2_w"], lp["norm2_b"])
        hx = linear(F.gelu(linear(hx, lp["w1"])), lp["w2"])
        x = x + hx * lp["ls2"]
    return x


def _seanet_decode(params: Params, cfg: MimiConfig, x):
    """(B, T25, dim) 25 Hz latents -> (B, T25 * prod(ratios)) waveform."""
    x = _causal_conv(x, params["init_conv"])
    for blk, r in zip(params["blocks"], cfg.ratios):
        x = F.elu(x)
        x = _causal_trans_conv(x, blk["up"], r)
        for unit, dil in zip(blk["units"], cfg.dilations):
            y = F.elu(x)
            y = _causal_conv(y, unit["c1"], dilation=dil)
            y = F.elu(y)
            y = _causal_conv(y, unit["c2"])
            x = x + y
    x = F.elu(x)
    return _causal_conv(x, params["final_conv"])[..., 0]


def decode(params: Params, cfg: MimiConfig, codes):
    """codes (B, T, n_q) int -> waveform (B, T * hop) float32 at 24 kHz:
    dequantize -> upsample 12.5 -> 25 Hz -> decoder transformer -> SEANet."""
    latent = dequantize(params, cfg, codes).to(cfg.dtype)
    latent = _upsample(latent, params["upsample"]["w"].to(cfg.dtype), cfg.upsample_stride)
    latent = _transformer(params, cfg, latent)
    return _seanet_decode(params, cfg, latent).float()


def decode_deficit(cfg: MimiConfig) -> int:
    """Frames of left context that fully cover the decoder's receptive
    field (transformer window dominates; convs add a few frames)."""
    conv_rf = cfg.kernel + sum(cfg.residual_kernel * max(cfg.dilations) for _ in cfg.ratios)
    conv_frames = int(np.ceil(conv_rf / np.prod(cfg.ratios))) + 1
    return int(cfg.t_context + conv_frames)


@torch.inference_mode()
def streaming_decode(params: Params, cfg: MimiConfig, codes, context_frames: int = 32) -> np.ndarray:
    """Chunked decode with re-vocoded left context.  Returns the waveform
    (B, T * hop) as numpy, each chunk aligned to its input frames."""
    codes = torch.as_tensor(codes, device=params["sem_codebook"].device)
    t = codes.shape[1]
    out = []
    step = max(1, context_frames)
    for start in range(0, t, step):
        lo = max(0, start - context_frames)
        audio = decode(params, cfg, codes[:, lo: start + step])
        out.append(audio[:, (start - lo) * cfg.hop:].cpu().numpy())
    return np.concatenate(out, axis=1)[:, : t * cfg.hop]


# ---------------------------------------------------------------------------
# checkpoint conversion: the JAX package's numpy converter, its tree on a device
# ---------------------------------------------------------------------------


def _codebooks(sd: dict, group: str, n: int, stacked_key: str) -> np.ndarray:
    """RVQ codebooks under *group*: either a stacked (n, cs, cd) tensor (the
    twin) or per-layer ``vq.layers.{k}._codebook.{embedding|embed|
    embedding_sum+cluster_usage}`` (moshi checkpoints)."""
    if stacked_key in sd:
        return np.asarray(sd[stacked_key], np.float32)
    books = []
    for k in range(n):
        base = f"{group}.vq.layers.{k}._codebook"
        if f"{base}.embedding" in sd:
            books.append(np.asarray(sd[f"{base}.embedding"], np.float32))
        elif f"{base}.embed" in sd:
            books.append(np.asarray(sd[f"{base}.embed"], np.float32))
        else:  # EMA form: embedding = sum / usage
            s = np.asarray(sd[f"{base}.embedding_sum"], np.float64)
            u = np.asarray(sd[f"{base}.cluster_usage"], np.float64)
            books.append((s / np.maximum(u[:, None], 1e-8)).astype(np.float32))
    return np.stack(books)


def convert_state_dict(sd: dict, cfg: MimiConfig = MimiConfig(), device: torch.device | str = "cpu") -> Params:
    """moshi-style ``MimiModel`` decoder-side layout -> the JAX package's tree on *device*.

    Expected keys (mirrored by ``scripts/_mimi_torch_twin.py``, which is
    the authoritative documentation): ``quantizer.rvq_first/rvq_rest``
    (codebooks + 1x1 ``output_proj``), ``decoder_transformer.layers.{i}``
    (optionally with a ``.transformer`` infix), ``upsample.convtr``,
    ``decoder.model.{idx}`` (SEANet Sequential).
    """
    sd = HostStateDict(sd)

    def conv_t(w):  # torch conv (O, I, K) -> (K, I, O)
        return np.asarray(w, np.float32).transpose(2, 1, 0)

    def convT_t(w):  # torch convtr (I, O, K) -> flip -> (K, I, O)
        w = np.asarray(w, np.float32)
        return w[:, :, ::-1].transpose(2, 0, 1).copy()

    def bias(prefix):
        key = f"{prefix}.bias"
        return np.asarray(sd[key], np.float32) if key in sd else None

    p: Params = {}
    # ── quantizer ────────────────────────────────────────────────────
    sem = _codebooks(sd, "quantizer.rvq_first", 1, "quantizer.rvq_first.codebooks")
    p["sem_codebook"] = sem[0]
    p["sem_out_proj"] = np.asarray(
        sd["quantizer.rvq_first.output_proj.weight"], np.float32
    )[:, :, 0].T  # conv1x1 (dim, cd, 1) -> (cd, dim)
    ac = _codebooks(sd, "quantizer.rvq_rest", cfg.n_q - 1, "quantizer.rvq_rest.codebooks")
    p["ac_codebooks"] = ac
    p["ac_out_proj"] = np.asarray(
        sd["quantizer.rvq_rest.output_proj.weight"], np.float32
    )[:, :, 0].T

    # ── decoder transformer ──────────────────────────────────────────
    tp = "decoder_transformer.transformer.layers" \
        if any(k.startswith("decoder_transformer.transformer.") for k in sd) \
        else "decoder_transformer.layers"
    tlayers = []
    for i in range(cfg.t_layers):
        lpfx = f"{tp}.{i}"
        if f"{lpfx}.self_attn.in_proj_weight" in sd:
            w_in = np.asarray(sd[f"{lpfx}.self_attn.in_proj_weight"], np.float32)
            wq, wk, wv = np.split(w_in, 3, axis=0)
        else:  # separate projections
            wq = np.asarray(sd[f"{lpfx}.self_attn.q_proj.weight"], np.float32)
            wk = np.asarray(sd[f"{lpfx}.self_attn.k_proj.weight"], np.float32)
            wv = np.asarray(sd[f"{lpfx}.self_attn.v_proj.weight"], np.float32)
        tlayers.append({
            "norm1_w": np.asarray(sd[f"{lpfx}.norm1.weight"], np.float32),
            "norm1_b": np.asarray(sd[f"{lpfx}.norm1.bias"], np.float32),
            "wq": wq.T, "wk": wk.T, "wv": wv.T,
            "wo": np.asarray(sd[f"{lpfx}.self_attn.out_proj.weight"], np.float32).T,
            "ls1": np.asarray(sd[f"{lpfx}.layer_scale_1.scale"], np.float32),
            "norm2_w": np.asarray(sd[f"{lpfx}.norm2.weight"], np.float32),
            "norm2_b": np.asarray(sd[f"{lpfx}.norm2.bias"], np.float32),
            "w1": np.asarray(sd[f"{lpfx}.linear1.weight"], np.float32).T,
            "w2": np.asarray(sd[f"{lpfx}.linear2.weight"], np.float32).T,
            "ls2": np.asarray(sd[f"{lpfx}.layer_scale_2.scale"], np.float32),
        })
    p["tlayers"] = tlayers

    # ── learnt upsample (depthwise, no weight norm, no bias) ─────────
    up = _wn(sd, "upsample.convtr")  # (C, 1, K) grouped
    p["upsample"] = {"w": up[:, 0, :].T.copy()}  # -> (K, C); _upsample flips

    # ── seanet decoder ───────────────────────────────────────────────
    def conv_at(idx, dilation=1):
        w = _wn(sd, f"decoder.model.{idx}.conv")
        b = bias(f"decoder.model.{idx}.conv")
        out = {"w": conv_t(w)}
        out["b"] = b if b is not None else np.zeros(w.shape[0], np.float32)
        return out

    p["init_conv"] = conv_at(0)
    idx = 1
    blocks = []
    for _r in cfg.ratios:
        idx += 1  # skip ELU
        w = _wn(sd, f"decoder.model.{idx}.convtr")
        b = bias(f"decoder.model.{idx}.convtr")
        blk: Params = {"up": {"w": convT_t(w)}}
        if b is not None:
            blk["up"]["b"] = b
        idx += 1
        units = []
        for _d in cfg.dilations:
            base = f"decoder.model.{idx}.block"
            units.append({
                "c1": {"w": conv_t(_wn(sd, f"{base}.1.conv")),
                       "b": np.asarray(sd.get(f"{base}.1.conv.bias",
                                              np.zeros(1)), np.float32)},
                "c2": {"w": conv_t(_wn(sd, f"{base}.3.conv")),
                       "b": np.asarray(sd.get(f"{base}.3.conv.bias",
                                              np.zeros(1)), np.float32)},
            })
            idx += 1
        # fix zero-bias shapes
        for u in units:
            for c in ("c1", "c2"):
                cout = u[c]["w"].shape[2]
                if u[c]["b"].shape != (cout,):
                    u[c]["b"] = np.zeros(cout, np.float32)
        blk["units"] = units
        blocks.append(blk)
    p["blocks"] = blocks
    idx += 1  # final ELU
    p["final_conv"] = conv_at(idx)
    return tree_to_device(p, device)


def hf_to_moshi_names(sd: dict, cfg: MimiConfig = MimiConfig()) -> dict:
    """Rename a ``transformers.MimiModel`` state dict (the layout real HF
    Mimi checkpoints like ``kyutai/mimi`` ship in) to the moshi-style keys
    :func:`convert_state_dict` consumes.

    Decoder-side only; encoder keys are dropped.  Key families:
    ``decoder_transformer.layers.{i}.self_attn.{q,k,v,o}_proj`` /
    ``input_layernorm`` / ``post_attention_layernorm`` / ``mlp.fc{1,2}`` /
    ``{self_attn,mlp}_layer_scale.scale``;
    ``quantizer.{semantic,acoustic}_residual_vector_quantizer.layers.{k}.
    codebook.{embed_sum,cluster_usage}`` + ``output_proj``;
    ``upsample.conv``; ``decoder.layers.{idx}.(conv|block.N.conv)`` with
    the transposed-conv positions derived from ``cfg.ratios``.
    """
    out: dict = {}
    # positions of transposed convs in the flat SEANet Sequential
    trans_idx = set()
    idx = 1
    for _r in cfg.ratios:
        trans_idx.add(idx + 1)  # after the ELU
        idx += 2 + len(cfg.dilations)
    for key, val in sd.items():
        if key.startswith(("encoder", "downsample")):
            continue
        new = key
        if key.startswith("decoder_transformer.layers."):
            new = (key
                   .replace(".self_attn.o_proj.", ".self_attn.out_proj.")
                   .replace(".input_layernorm.", ".norm1.")
                   .replace(".post_attention_layernorm.", ".norm2.")
                   .replace(".mlp.fc1.", ".linear1.")
                   .replace(".mlp.fc2.", ".linear2.")
                   .replace(".self_attn_layer_scale.scale", ".layer_scale_1.scale")
                   .replace(".mlp_layer_scale.scale", ".layer_scale_2.scale"))
        elif key.startswith("quantizer."):
            new = (key
                   .replace("quantizer.semantic_residual_vector_quantizer.",
                            "quantizer.rvq_first.")
                   .replace("quantizer.acoustic_residual_vector_quantizer.",
                            "quantizer.rvq_rest."))
            new = re.sub(r"\.layers\.(\d+)\.codebook\.", r".vq.layers.\1._codebook.", new)
            new = new.replace("._codebook.embed_sum", "._codebook.embedding_sum")
            if new.endswith(".initialized") or ".input_proj." in new:
                continue
        elif key.startswith("upsample.conv."):
            new = key.replace("upsample.conv.", "upsample.convtr.")
        elif key.startswith("decoder.layers."):
            m = re.match(r"decoder\.layers\.(\d+)\.(.*)", key)
            pos, rest = int(m.group(1)), m.group(2)
            if pos in trans_idx:
                rest = rest.replace("conv.", "convtr.", 1)
            new = f"decoder.model.{pos}.{rest}"
        out[new] = val
    return out


def convert_hf_state_dict(sd: dict, cfg: MimiConfig = MimiConfig(), device: torch.device | str = "cpu") -> Params:
    """``transformers.MimiModel`` state dict -> the JAX package's tree on *device*."""
    return convert_state_dict(hf_to_moshi_names(sd, cfg), cfg, device)
