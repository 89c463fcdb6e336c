"""MMS/VITS TTS in PyTorch, the port of ``s2s_tpu/models/vits.py``
(transformers' ``VitsModel``, ``facebook/mms-tts-<lang>``).

The same architecture, numerics (f32) and names as the JAX package:

- **text encoder** — relative-window attention (window 4, learned rel-k/v
  embeddings), conv feed-forward, post-layernorm; projects to prior
  means/log-variances;
- **stochastic duration predictor in reverse** — dilated depth-separable
  convs conditioning a rational-quadratic spline flow; with zero noise the
  reverse flow yields log durations;
- **residual coupling flow in reverse** — mean-only coupling layers with
  WaveNet conditioners;
- **HiFi-GAN decoder** — transposed-conv upsampling (x256 at 16 kHz) with
  multi-kernel residual blocks.

One static program per call, as in the JAX package: ``max_tokens`` text
positions and ``max_frames`` latent frames.  Every stage propagates a
validity mask and re-zeroes the padding before each conv, so the bucketed
output equals the exact-length one and is exactly zero past each row's
length.  The alignment is a dense one-hot product.

Layouts: activations (B, T, C); convolution weights PyTorch's
``(out, in/g, k)``, transposed convolutions' ``(in, out, k)``;
:func:`s2s_tpu_torch.weights.vits_params` carries the JAX package's trees
across.  Noise for the stochastic path is drawn on the host exactly as the
JAX wrapper draws it, so both packages sample the same latents.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch import weights
from s2s_tpu_torch.models.common import HostStateDict, layer_norm, tree_to_device
from s2s_tpu_torch.models.decoder_lm import normal

Params = dict[str, Any]

SAMPLE_RATE = 16_000

#: languages the reference's MMS map covers (subset; extend via converter)
MMS_LANGUAGES = (
    "en fr es de it pt nl pl ru uk ro hu bg el tr vi id th ko ar hi bn swh yor hau".split()
)
LANGUAGE_IDS = {lang: i for i, lang in enumerate(MMS_LANGUAGES)}


@dataclass(frozen=True)
class VitsConfig:
    """Field defaults = facebook/mms-tts-* (all MMS languages share them;
    only ``vocab_size`` differs per language)."""

    vocab_size: int = 38
    d_model: int = 192  # hidden_size
    n_layers: int = 6
    n_heads: int = 2
    window: int = 4
    ffn_dim: int = 768
    ffn_kernel: int = 3
    flow_size: int = 192
    layer_norm_eps: float = 1e-5
    # stochastic duration predictor (reverse/serving path)
    dp_flows: int = 4
    dp_bins: int = 10
    dp_tail: float = 5.0
    dp_kernel: int = 3
    ds_layers: int = 3
    # prior coupling flow
    prior_flows: int = 4
    wn_layers: int = 4
    wn_kernel: int = 5
    wn_dilation: int = 1
    # HiFi-GAN decoder
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernels: tuple = (16, 16, 4, 4)
    upsample_initial: int = 512
    resblock_kernels: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_slope: float = 0.1
    sample_rate: int = 16_000
    # serving shape buckets
    max_tokens: int = 256
    max_frames: int = 1024
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates))

    @staticmethod
    def test_tiny() -> "VitsConfig":
        return VitsConfig(
            vocab_size=40, d_model=32, n_layers=2, n_heads=2, ffn_dim=64, flow_size=8,
            ds_layers=2, dp_flows=2, prior_flows=2, wn_layers=2,
            upsample_rates=(4, 2), upsample_kernels=(8, 4), upsample_initial=32,
            resblock_kernels=(3, 7), resblock_dilations=((1, 3), (1, 3)),
            max_tokens=32, max_frames=64,
        )


# ---------------------------------------------------------------------------
# conv primitives ((B, T, C) data; torch-symmetric padding)
# ---------------------------------------------------------------------------


def _conv1d(x, w, b=None, dilation: int = 1, groups: int = 1):
    """nn.Conv1d with w (out, in/g, k) and padding (k*d - d)//2 each side (odd kernels)."""
    pad = (w.shape[-1] * dilation - dilation) // 2
    return F.conv1d(x.transpose(1, 2), w, b, 1, pad, dilation, groups).transpose(1, 2)


def _conv_transpose1d(x, w, b, stride: int, kernel: int):
    """ConvTranspose1d(k, s, padding=(k-s)//2) with w (in, out, k).  Output
    length = T*s + (k - s) % 2 (== T*s for even k-s)."""
    return F.conv_transpose1d(x.transpose(1, 2), w, b, stride, (kernel - stride) // 2).transpose(1, 2)


def _lin(x, w, b=None):
    out = x @ w
    return out if b is None else out + b


# ---------------------------------------------------------------------------
# text encoder: relative-window attention + conv FFN
# ---------------------------------------------------------------------------


def _rel_embeds(rel, length: int, window: int):
    """(2w+1, hd) -> (2L-1, hd) (modeling_vits.py:971-978)."""
    pad = max(length - (window + 1), 0)
    if pad > 0:
        rel = F.pad(rel, (0, 0, pad, pad))
    start = max((window + 1) - length, 0)
    return rel[start: start + 2 * length - 1]


def _rel_to_abs(x):
    """(N, L, 2L-1) -> (N, L, L) skewing (modeling_vits.py:980-993)."""
    n, length, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(n, length * 2 * length)
    x = F.pad(x, (0, length - 1)).reshape(n, length + 1, 2 * length - 1)
    return x[:, :length, length - 1:]


def _abs_to_rel(x):
    """(N, L, L) -> (N, L, 2L-1) skewing (modeling_vits.py:995-1005)."""
    n, length, _ = x.shape
    x = F.pad(x, (0, length - 1)).reshape(n, length * (2 * length - 1))
    x = F.pad(x, (length, 0)).reshape(n, length, 2 * length)
    return x[:, :, 1:]


def _enc_attention(p, cfg: VitsConfig, x, key_mask):
    b, length, h = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim

    def heads(t):
        return t.reshape(b, length, nh, hd).transpose(1, 2).reshape(b * nh, length, hd)

    q = heads(_lin(x, p["q_w"], p["q_b"]) * hd ** -0.5)
    k = heads(_lin(x, p["k_w"], p["k_b"]))
    v = heads(_lin(x, p["v_w"], p["v_b"]))
    scores = torch.einsum("nqd,nkd->nqk", q, k)
    rel_k = _rel_embeds(p["rel_k"], length, cfg.window)
    scores = scores + _rel_to_abs(torch.einsum("nqd,rd->nqr", q, rel_k))
    neg = torch.finfo(torch.float32).min
    scores = scores.reshape(b, nh, length, length) + (1.0 - key_mask[:, None, None, :]) * neg
    probs = torch.softmax(scores, dim=-1).reshape(b * nh, length, length)
    out = torch.einsum("nqk,nkd->nqd", probs, v)
    rel_v = _rel_embeds(p["rel_v"], length, cfg.window)
    out = out + torch.einsum("nqr,rd->nqd", _abs_to_rel(probs), rel_v)
    out = out.reshape(b, nh, length, hd).transpose(1, 2).reshape(b, length, h)
    return _lin(out, p["o_w"], p["o_b"])


def _enc_ffn(p, x, mask):
    h = _conv1d(x * mask, p["ffn_w1"], p["ffn_b1"])
    h = torch.relu(h)
    h = _conv1d(h * mask, p["ffn_w2"], p["ffn_b2"])
    return h * mask


def text_encode(params: Params, cfg: VitsConfig, tokens, t_mask):
    """tokens: (B, T) int; t_mask: (B, T) float validity.
    Returns (hidden (B,T,H), prior_means (B,T,F), prior_log_vars (B,T,F))."""
    p = params["text_encoder"]
    x = p["embed"][tokens].to(cfg.dtype) * math.sqrt(cfg.d_model)
    mask3 = t_mask[..., None].to(cfg.dtype)
    x = x * mask3
    for lp in p["layers"]:
        a = _enc_attention(lp, cfg, x, t_mask.float())
        x = layer_norm(x + a, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        f = _enc_ffn(lp, x, mask3)
        x = layer_norm(x + f, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
    x = x * mask3
    stats = _lin(x, p["proj_w"], p["proj_b"]) * mask3
    means, log_vars = torch.chunk(stats, 2, dim=-1)
    return x, means, log_vars


# ---------------------------------------------------------------------------
# dilated depth-separable conv stack (duration predictor conditioner)
# ---------------------------------------------------------------------------


def _dds(p_list, cfg: VitsConfig, x, mask, cond=None):
    if cond is not None:
        x = x + cond
    channels = x.shape[-1]
    for i, p in enumerate(p_list):
        h = _conv1d(x * mask, p["dw_w"], p["dw_b"], dilation=cfg.dp_kernel ** i, groups=channels)
        h = layer_norm(h, p["ln1_w"], p["ln1_b"], 1e-5)
        h = F.gelu(h)
        h = _lin(h, p["pw_w"], p["pw_b"])
        h = layer_norm(h, p["ln2_w"], p["ln2_b"], 1e-5)
        h = F.gelu(h)
        x = x + h
    return x * mask


# ---------------------------------------------------------------------------
# rational-quadratic spline flow (reverse) — modeling_vits.py:64-300
# ---------------------------------------------------------------------------


def _knots(u, tail: float, min_size: float):
    """Softmax bin sizes -> (knots (..., bins+1) from -tail to tail, sizes)."""
    num_bins = u.shape[-1]
    sizes = min_size + (1 - min_size * num_bins) * torch.softmax(u, dim=-1)
    knots = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    knots = 2 * tail * knots - tail
    knots = torch.cat([torch.full_like(knots[..., :1], -tail), knots[..., 1:-1],
                       torch.full_like(knots[..., :1], tail)], dim=-1)
    return knots, knots[..., 1:] - knots[..., :-1]


def _rq_spline_reverse(inputs, uw, uh, ud, tail: float,
                       min_w: float = 1e-3, min_h: float = 1e-3, min_d: float = 1e-3):
    """inputs (...,); uw/uh (..., bins); ud (..., bins-1). Identity outside
    [-tail, tail]."""
    num_bins = uw.shape[-1]
    inside = (inputs >= -tail) & (inputs <= tail)
    x = torch.clamp(inputs, -tail, tail)

    constant = float(np.log(np.exp(1 - min_d) - 1))
    ud = F.pad(ud, (1, 1), value=constant)

    cumw, widths = _knots(uw, tail, min_w)
    derivs = min_d + F.softplus(ud)
    cumh, heights = _knots(uh, tail, min_h)

    bin_loc = torch.cat([cumh[..., :-1], cumh[..., -1:] + 1e-6], dim=-1)  # reverse: locate by heights
    idx = torch.sum((x[..., None] >= bin_loc).to(torch.int64), dim=-1) - 1
    idx = torch.clamp(idx, 0, num_bins - 1)[..., None]

    def take(t):
        return torch.gather(t, -1, idx)[..., 0]

    icw, ibw, ich = take(cumw), take(widths), take(cumh)
    idelta = take(heights / widths)
    id0, id1 = take(derivs), take(derivs[..., 1:])
    ih = take(heights)

    inter1 = id0 + id1 - 2 * idelta
    i2 = x - ich
    i3 = i2 * inter1
    a = ih * (idelta - id0) + i3
    b = ih * id0 - i3
    c = -idelta * i2
    disc = torch.clamp(b * b - 4 * a * c, min=0.0)
    root = (2 * c) / (-b - torch.sqrt(disc))
    out = root * ibw + icw
    return torch.where(inside, out, inputs)


def _conv_flow_reverse(p, cfg: VitsConfig, lat, mask, cond):
    """lat: (B, T, 2) — first channel conditions the spline on the second."""
    first, second = lat[..., :1], lat[..., 1]
    h = _lin(first, p["pre_w"], p["pre_b"])
    h = _dds(p["dds"], cfg, h, mask, cond=cond)
    h = _lin(h, p["proj_w"], p["proj_b"]) * mask  # (B, T, 3*bins - 1)
    uw = h[..., : cfg.dp_bins] / math.sqrt(cfg.d_model)
    uh = h[..., cfg.dp_bins: 2 * cfg.dp_bins] / math.sqrt(cfg.d_model)
    ud = h[..., 2 * cfg.dp_bins:]
    second = _rq_spline_reverse(second, uw, uh, ud, cfg.dp_tail)
    return torch.cat([first, second[..., None]], dim=-1) * mask


def duration_log(params: Params, cfg: VitsConfig, hidden, t_mask, dur_noise=None):
    """Stochastic duration predictor, reverse -> (B, T) log durations
    (modeling_vits.py:789-802, incl. the skipped first conv flow).
    ``dur_noise``: (B, T, 2) pre-scaled latent noise (None -> deterministic)."""
    p = params["dp"]
    mask = t_mask[..., None].to(cfg.dtype)
    h = _lin(hidden, p["pre_w"], p["pre_b"])
    h = _dds(p["dds"], cfg, h, mask)
    cond = _lin(h, p["proj_w"], p["proj_b"]) * mask

    b, t, _ = hidden.shape
    lat = (torch.zeros((b, t, 2), dtype=cfg.dtype, device=hidden.device) if dur_noise is None
           else dur_noise.to(cfg.dtype))
    # flows = [EA, CF_0..CF_{n-1}]; reverse skips CF_0 ("useless vflow")
    for cf in reversed(p["conv_flows"][1:]):
        lat = torch.flip(lat, [-1])
        lat = _conv_flow_reverse(cf, cfg, lat, mask, cond)
    lat = torch.flip(lat, [-1])
    lat = (lat - p["ea_translate"]) * torch.exp(-p["ea_log_scale"]) * mask
    return lat[..., 0]


# ---------------------------------------------------------------------------
# residual coupling flow (reverse) + WaveNet
# ---------------------------------------------------------------------------


def _wavenet(p, cfg: VitsConfig, x, mask):
    hidden = x.shape[-1]
    out = torch.zeros_like(x)
    n = len(p["in_w"])
    for i in range(n):
        h = _conv1d(x, p["in_w"][i], p["in_b"][i], dilation=cfg.wn_dilation ** i)
        acts = torch.tanh(h[..., :hidden]) * torch.sigmoid(h[..., hidden:])
        rs = _lin(acts, p["rs_w"][i], p["rs_b"][i])
        if i < n - 1:
            x = (x + rs[..., :hidden]) * mask
            out = out + rs[..., hidden:]
        else:
            out = out + rs
    return out * mask


def flow_reverse(params: Params, cfg: VitsConfig, lat, mask):
    """Coupling layers reversed, channel flip before each
    (modeling_vits.py:586-595)."""
    half = cfg.flow_size // 2
    for p in reversed(params["flow"]):
        lat = torch.flip(lat, [-1])
        first, second = lat[..., :half], lat[..., half:]
        h = _lin(first, p["pre_w"], p["pre_b"]) * mask
        h = _wavenet(p["wn"], cfg, h, mask)
        mean = _lin(h, p["post_w"], p["post_b"]) * mask
        second = (second - mean) * mask
        lat = torch.cat([first, second], dim=-1)
    return lat


# ---------------------------------------------------------------------------
# HiFi-GAN decoder with mask propagation (bucket == exact-length outputs)
# ---------------------------------------------------------------------------


def _resblock(p, x, mask, dilations, slope: float):
    for j, d in enumerate(dilations):
        h = F.leaky_relu(x, slope)
        h = _conv1d(h * mask, p["c1_w"][j], p["c1_b"][j], dilation=d)
        h = F.leaky_relu(h, slope)
        h = _conv1d(h * mask, p["c2_w"][j], p["c2_b"][j])
        x = x + h
    return x


def hifigan(params: Params, cfg: VitsConfig, spec, frame_mask):
    """spec: (B, F, flow); frame_mask: (B, F, 1). Returns (B, F*up) f32."""
    p = params["dec"]
    nk = len(cfg.resblock_kernels)
    x = _conv1d(spec * frame_mask, p["pre_w"], p["pre_b"])
    mask = frame_mask
    for i, (rate, ksz) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        x = F.leaky_relu(x, cfg.leaky_slope)
        x = _conv_transpose1d(x * mask, p["ups_w"][i], p["ups_b"][i], rate, ksz)
        mask = torch.repeat_interleave(mask, rate, dim=1)
        x = x * mask
        acc = None
        for j in range(nk):
            r = _resblock(p["res"][i * nk + j], x, mask, cfg.resblock_dilations[j], cfg.leaky_slope)
            acc = r if acc is None else acc + r
        x = acc / nk
    x = F.leaky_relu(x, 0.01)  # torch F.leaky_relu default slope
    x = _conv1d(x * mask, p["post_w"])  # no bias
    return torch.tanh(x)[..., 0] * mask[..., 0]


# ---------------------------------------------------------------------------
# full synthesis
# ---------------------------------------------------------------------------


def synthesize(params: Params, cfg: VitsConfig, tokens, n_valid, speed, dur_noise=None, frame_noise=None):
    """tokens: (B, max_tokens) int right-padded; n_valid: (B,) int; speed:
    a float or a 0-d tensor.  ``dur_noise`` (B,T,2) / ``frame_noise``
    (B,F,flow) are pre-scaled latent samples (torch uses
    noise_scale_duration=0.8 and noise_scale=0.667 by default); None -> the
    deterministic serving path.  Returns (waveform (B, max_frames*up) f32,
    n_samples (B,) int32), both on the device of *tokens*."""
    b, t = tokens.shape
    device = tokens.device
    t_mask = (torch.arange(t, device=device)[None, :] < n_valid.to(device)[:, None]).float()

    hidden, prior_means, prior_log_vars = text_encode(params, cfg, tokens, t_mask)
    log_dur = duration_log(params, cfg, hidden, t_mask, dur_noise)

    speed = torch.as_tensor(speed, dtype=torch.float32, device=device)  # IEEE division, as JAX
    dur = torch.ceil(torch.exp(log_dur) * t_mask / torch.clamp(speed, min=0.1))
    total = torch.clamp(torch.sum(dur, dim=-1), 1, cfg.max_frames)
    cum = torch.cumsum(dur, dim=-1)  # (B, T); whole numbers, exact in any order

    frames = torch.arange(cfg.max_frames, device=device, dtype=torch.float32)
    o_mask = (frames[None, :] < total[:, None]).to(cfg.dtype)[..., None]  # (B,F,1)
    # frame f belongs to the first token whose cumulative duration exceeds f
    tok_idx = torch.sum(frames[None, :, None] >= cum[:, None, :], dim=-1)
    tok_idx = torch.clamp(tok_idx, 0, t - 1)
    attn = F.one_hot(tok_idx, t).float()  # (B, F, T)
    attn = attn * o_mask * t_mask[:, None, :]

    means_f = torch.einsum("bft,btc->bfc", attn, prior_means.float()).to(cfg.dtype)
    if frame_noise is not None:
        log_vars_f = torch.einsum("bft,btc->bfc", attn, prior_log_vars.float())
        means_f = means_f + (frame_noise * torch.exp(log_vars_f)).to(cfg.dtype)
    lat = flow_reverse(params, cfg, means_f * o_mask, o_mask)
    wav = hifigan(params, cfg, lat * o_mask, o_mask)
    n_samples = (total * cfg.total_upsample).to(torch.int32)
    return wav, n_samples


# ---------------------------------------------------------------------------
# init (random weights for tests / no-checkpoint serving)
# ---------------------------------------------------------------------------


def init_params(cfg: VitsConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*: the JAX package's
    distributions and tree (its layouts, then
    :func:`s2s_tpu_torch.weights.vits_params`), not its numbers."""
    h, dt = cfg.d_model, cfg.dtype

    def rnd(shape, scale):
        return normal(gen, shape, scale, dt, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def lin(i, o, scale=None):
        return rnd((i, o), scale if scale is not None else i ** -0.5), zeros(o)

    def conv(k, i, o, scale=None):
        return rnd((k, i, o), scale if scale is not None else (k * i) ** -0.5), zeros(o)

    def enc_layer():
        layer = {}
        for name in ("q", "k", "v", "o"):
            layer[f"{name}_w"], layer[f"{name}_b"] = lin(h, h)
        layer["ffn_w1"], layer["ffn_b1"] = conv(cfg.ffn_kernel, h, cfg.ffn_dim)
        layer["ffn_w2"], layer["ffn_b2"] = conv(cfg.ffn_kernel, cfg.ffn_dim, h)
        layer["rel_k"] = rnd((2 * cfg.window + 1, cfg.head_dim), cfg.head_dim ** -0.5)
        layer["rel_v"] = rnd((2 * cfg.window + 1, cfg.head_dim), cfg.head_dim ** -0.5)
        layer.update(ln1_w=ones(h), ln1_b=zeros(h), ln2_w=ones(h), ln2_b=zeros(h))
        return layer

    def dds_layer(channels):
        dw_w, dw_b = conv(cfg.dp_kernel, 1, channels, scale=cfg.dp_kernel ** -0.5)
        pw_w, pw_b = lin(channels, channels)
        return {"dw_w": dw_w, "dw_b": dw_b, "pw_w": pw_w, "pw_b": pw_b,
                "ln1_w": ones(channels), "ln1_b": zeros(channels),
                "ln2_w": ones(channels), "ln2_b": zeros(channels)}

    def conv_flow():
        pre_w, pre_b = lin(1, h)
        proj_w, proj_b = lin(h, 3 * cfg.dp_bins - 1, scale=0.0)
        return {"pre_w": pre_w, "pre_b": pre_b, "dds": [dds_layer(h) for _ in range(cfg.ds_layers)],
                "proj_w": proj_w, "proj_b": proj_b}

    def coupling():
        half = cfg.flow_size // 2
        pre_w, pre_b = lin(half, h)
        post_w, post_b = lin(h, half, scale=0.0)  # VITS zero-init convention
        wn = {"in_w": [], "in_b": [], "rs_w": [], "rs_b": []}
        for i in range(cfg.wn_layers):
            w, b = conv(cfg.wn_kernel, h, 2 * h)
            wn["in_w"].append(w)
            wn["in_b"].append(b)
            w, b = lin(h, 2 * h if i < cfg.wn_layers - 1 else h)
            wn["rs_w"].append(w)
            wn["rs_b"].append(b)
        return {"pre_w": pre_w, "pre_b": pre_b, "post_w": post_w, "post_b": post_b, "wn": wn}

    ch0 = cfg.upsample_initial
    ups_w, ups_b, res = [], [], []
    ch = ch0
    for i, (rate, ksz) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        out_ch = ch0 // (2 ** (i + 1))
        w, b = conv(ksz, ch, out_ch)
        ups_w.append(w)
        ups_b.append(b)
        for kern, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations):
            blk = {"c1_w": [], "c1_b": [], "c2_w": [], "c2_b": []}
            for _ in dils:
                for name in ("c1", "c2"):
                    w, b = conv(kern, out_ch, out_ch)
                    blk[f"{name}_w"].append(w)
                    blk[f"{name}_b"].append(b)
            res.append(blk)
        ch = out_ch

    pre_w, pre_b = conv(7, cfg.flow_size, ch0)
    proj_w, proj_b = lin(h, 2 * cfg.flow_size)
    dp_pre_w, dp_pre_b = lin(h, h)
    dp_proj_w, dp_proj_b = lin(h, h)
    tree = {
        "text_encoder": {
            "embed": rnd((cfg.vocab_size, h), 0.02),
            "layers": [enc_layer() for _ in range(cfg.n_layers)],
            "proj_w": proj_w, "proj_b": proj_b,
        },
        "dp": {
            "pre_w": dp_pre_w, "pre_b": dp_pre_b,
            "dds": [dds_layer(h) for _ in range(cfg.ds_layers)],
            "proj_w": dp_proj_w, "proj_b": dp_proj_b,
            "ea_translate": torch.zeros((2,), dtype=dt, device=device),
            "ea_log_scale": torch.zeros((2,), dtype=dt, device=device),
            "conv_flows": [conv_flow() for _ in range(cfg.dp_flows)],
        },
        "flow": [coupling() for _ in range(cfg.prior_flows)],
        "dec": {
            "pre_w": pre_w, "pre_b": pre_b,
            "ups_w": ups_w, "ups_b": ups_b,
            "res": res,
            "post_w": rnd((7, ch, 1), (7 * ch) ** -0.5),
        },
    }
    return weights.vits_params(tree, device)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


class VitsTokenizer:
    """Faithful VitsTokenizer behavior (transformers tokenization_vits.py):
    lowercase, strip chars outside the vocab, intersperse blank id 0."""

    def __init__(self, vocab: dict[str, int], add_blank: bool = True):
        self.vocab = vocab
        self.add_blank = add_blank

    def encode(self, text: str) -> list[int]:
        text = "".join(c for c in text.lower() if c in self.vocab).strip()
        ids = [self.vocab[c] for c in text]
        if self.add_blank:
            interspersed = [0] * (len(ids) * 2 + 1)
            interspersed[1::2] = ids
            ids = interspersed
        return ids


class VitsTTS:
    """Host wrapper: text -> chunked float32 @16 kHz on *device* (MMS is
    non-streaming; the handler chunks the finished waveform like the
    reference)."""

    def __init__(self, params: Params | None = None, cfg: VitsConfig = VitsConfig(),
                 seed: int = 0, vocab: dict[str, int] | None = None,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            params = init_params(cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
        self.params = params
        self.tokenizer = VitsTokenizer(vocab) if vocab else None
        #: per-language override sets: lang -> (params, tokenizer, cfg)
        self.languages: dict[str, tuple] = {}

    def add_language(self, language: str, params: Params, vocab: dict[str, int] | None = None,
                     cfg: VitsConfig | None = None) -> None:
        """*params*: the port's tensors (:func:`s2s_tpu_torch.weights.vits_params`)."""
        self.languages[language] = (params, VitsTokenizer(vocab) if vocab else None, cfg or self.cfg)

    def _encode(self, text: str, tokenizer) -> list[int]:
        if tokenizer is not None:
            return tokenizer.encode(text)
        # byte-level fallback for random-init mode (no vocab available)
        return [1 + (b % (self.cfg.vocab_size - 1)) for b in text.encode("utf-8")]

    @torch.inference_mode()
    def synthesize(self, text: str, language: str | None = None, speed: float = 1.0,
                   noise_scale: float = 0.0, noise_scale_duration: float = 0.0,
                   noise_seed: int | None = None) -> np.ndarray:
        """Deterministic by default; pass the torch defaults
        (noise_scale=0.667, noise_scale_duration=0.8) + a seed for the
        stochastic sampling the reference model performs."""
        params, tokenizer, cfg = self.params, self.tokenizer, self.cfg
        if language in self.languages:
            params, tokenizer, cfg = self.languages[language]
        ids = self._encode(text, tokenizer)[: cfg.max_tokens]
        tokens = torch.zeros((1, cfg.max_tokens), dtype=torch.long)
        tokens[0, : len(ids)] = torch.tensor(ids, dtype=torch.long)
        dur_noise = frame_noise = None
        if noise_scale or noise_scale_duration:
            rng = np.random.RandomState(noise_seed)
            dur_noise = torch.from_numpy(
                rng.randn(1, cfg.max_tokens, 2).astype(np.float32) * noise_scale_duration).to(self.device)
            frame_noise = torch.from_numpy(
                rng.randn(1, cfg.max_frames, cfg.flow_size).astype(np.float32) * noise_scale).to(self.device)
        wav, n_samples = synthesize(params, cfg, tokens.to(self.device), torch.tensor([len(ids)]),
                                    float(speed), dur_noise, frame_noise)
        return wav[0, : int(n_samples[0])].float().cpu().numpy()

    def stream(self, text: str, language: str | None = None, speed: float = 1.0,
               chunk_s: float = 0.5, **noise_kwargs):
        audio = self.synthesize(text, language, speed, **noise_kwargs)
        step = int(chunk_s * self.cfg.sample_rate)
        for i in range(0, max(len(audio), 1), step):
            yield audio[i: i + step], self.cfg.sample_rate


# ---------------------------------------------------------------------------
# checkpoint conversion: the JAX package's numpy converter, its tree on a device
# ---------------------------------------------------------------------------


def _wn_weight(sd, prefix: str) -> np.ndarray:
    """Fuse torch weight-norm (weight_g/weight_v or parametrizations form)."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"])
    if f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    else:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    g, v = np.asarray(g, np.float64), np.asarray(v, np.float64)
    norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1).reshape((-1,) + (1,) * (v.ndim - 1))
    return (g * v / norm).astype(np.float32)


def convert_hf_state_dict(sd: dict, cfg: VitsConfig = VitsConfig(), device: torch.device | str = "cpu") -> Params:
    """transformers VitsModel (facebook/mms-tts-*) -> the JAX package's tree on *device*.
    Reference layout: transformers models/vits/modeling_vits.py."""
    sd = HostStateDict(sd)

    def t(name):  # torch tensor -> np
        return np.asarray(sd[name], np.float32)

    def lin_t(name):  # conv1x1 / Linear (O, I[, 1]) -> (I, O)
        w = t(name)
        if w.ndim == 3:
            w = w[:, :, 0]
        return w.T

    def conv_t(name):  # (O, I, K) -> (K, I, O)
        return t(name).transpose(2, 1, 0)

    def dds_list(prefix, n):
        out = []
        for i in range(n):
            out.append({
                "dw_w": conv_t(f"{prefix}.convs_dilated.{i}.weight"),
                "dw_b": t(f"{prefix}.convs_dilated.{i}.bias"),
                "pw_w": lin_t(f"{prefix}.convs_pointwise.{i}.weight"),
                "pw_b": t(f"{prefix}.convs_pointwise.{i}.bias"),
                "ln1_w": t(f"{prefix}.norms_1.{i}.weight"),
                "ln1_b": t(f"{prefix}.norms_1.{i}.bias"),
                "ln2_w": t(f"{prefix}.norms_2.{i}.weight"),
                "ln2_b": t(f"{prefix}.norms_2.{i}.bias"),
            })
        return out

    layers = []
    for i in range(cfg.n_layers):
        pre = f"text_encoder.encoder.layers.{i}"
        layers.append({
            "q_w": lin_t(f"{pre}.attention.q_proj.weight"), "q_b": t(f"{pre}.attention.q_proj.bias"),
            "k_w": lin_t(f"{pre}.attention.k_proj.weight"), "k_b": t(f"{pre}.attention.k_proj.bias"),
            "v_w": lin_t(f"{pre}.attention.v_proj.weight"), "v_b": t(f"{pre}.attention.v_proj.bias"),
            "o_w": lin_t(f"{pre}.attention.out_proj.weight"), "o_b": t(f"{pre}.attention.out_proj.bias"),
            "rel_k": t(f"{pre}.attention.emb_rel_k")[0],
            "rel_v": t(f"{pre}.attention.emb_rel_v")[0],
            "ln1_w": t(f"{pre}.layer_norm.weight"), "ln1_b": t(f"{pre}.layer_norm.bias"),
            "ffn_w1": conv_t(f"{pre}.feed_forward.conv_1.weight"),
            "ffn_b1": t(f"{pre}.feed_forward.conv_1.bias"),
            "ffn_w2": conv_t(f"{pre}.feed_forward.conv_2.weight"),
            "ffn_b2": t(f"{pre}.feed_forward.conv_2.bias"),
            "ln2_w": t(f"{pre}.final_layer_norm.weight"), "ln2_b": t(f"{pre}.final_layer_norm.bias"),
        })

    conv_flows = []
    for j in range(1, cfg.dp_flows + 1):
        pre = f"duration_predictor.flows.{j}"
        conv_flows.append({
            "pre_w": lin_t(f"{pre}.conv_pre.weight"), "pre_b": t(f"{pre}.conv_pre.bias"),
            "dds": dds_list(f"{pre}.conv_dds", cfg.ds_layers),
            "proj_w": lin_t(f"{pre}.conv_proj.weight"), "proj_b": t(f"{pre}.conv_proj.bias"),
        })

    flow = []
    for i in range(cfg.prior_flows):
        pre = f"flow.flows.{i}"
        wn = {"in_w": [], "in_b": [], "rs_w": [], "rs_b": []}
        for j in range(cfg.wn_layers):
            wn["in_w"].append(_wn_weight(sd, f"{pre}.wavenet.in_layers.{j}").transpose(2, 1, 0))
            wn["in_b"].append(t(f"{pre}.wavenet.in_layers.{j}.bias"))
            rs = _wn_weight(sd, f"{pre}.wavenet.res_skip_layers.{j}")[:, :, 0].T
            wn["rs_w"].append(rs)
            wn["rs_b"].append(t(f"{pre}.wavenet.res_skip_layers.{j}.bias"))
        flow.append({
            "pre_w": lin_t(f"{pre}.conv_pre.weight"), "pre_b": t(f"{pre}.conv_pre.bias"),
            "post_w": lin_t(f"{pre}.conv_post.weight"), "post_b": t(f"{pre}.conv_post.bias"),
            "wn": wn,
        })

    nk = len(cfg.resblock_kernels)
    ups_w, ups_b, res = [], [], []
    for i in range(len(cfg.upsample_rates)):
        w = t(f"decoder.upsampler.{i}.weight")  # (I, O, K)
        ups_w.append(w[:, :, ::-1].transpose(2, 0, 1).copy())  # flip -> (K, I, O)
        ups_b.append(t(f"decoder.upsampler.{i}.bias"))
        for j in range(nk):
            pre = f"decoder.resblocks.{i * nk + j}"
            blk = {"c1_w": [], "c1_b": [], "c2_w": [], "c2_b": []}
            for d in range(len(cfg.resblock_dilations[j])):
                blk["c1_w"].append(conv_t(f"{pre}.convs1.{d}.weight"))
                blk["c1_b"].append(t(f"{pre}.convs1.{d}.bias"))
                blk["c2_w"].append(conv_t(f"{pre}.convs2.{d}.weight"))
                blk["c2_b"].append(t(f"{pre}.convs2.{d}.bias"))
            res.append(blk)

    return tree_to_device({
        "text_encoder": {
            "embed": t("text_encoder.embed_tokens.weight"),
            "layers": layers,
            "proj_w": lin_t("text_encoder.project.weight"),
            "proj_b": t("text_encoder.project.bias"),
        },
        "dp": {
            "pre_w": lin_t("duration_predictor.conv_pre.weight"),
            "pre_b": t("duration_predictor.conv_pre.bias"),
            "dds": dds_list("duration_predictor.conv_dds", cfg.ds_layers),
            "proj_w": lin_t("duration_predictor.conv_proj.weight"),
            "proj_b": t("duration_predictor.conv_proj.bias"),
            "ea_translate": t("duration_predictor.flows.0.translate")[:, 0],
            "ea_log_scale": t("duration_predictor.flows.0.log_scale")[:, 0],
            "conv_flows": conv_flows,
        },
        "flow": flow,
        "dec": {
            "pre_w": conv_t("decoder.conv_pre.weight"),
            "pre_b": t("decoder.conv_pre.bias"),
            "ups_w": ups_w, "ups_b": ups_b, "res": res,
            "post_w": conv_t("decoder.conv_post.weight"),
        },
    }, device)
