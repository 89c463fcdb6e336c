"""Kokoro-82M TTS in PyTorch, the port of ``s2s_tpu/models/kokoro.py``.

The same StyleTTS2-derived architecture, numerics (f32 throughout) and
names as the JAX package:

- **bert** — PL-BERT: an ALBERT encoder (one shared layer applied
  ``n_layers`` times) over phoneme ids; **bert_encoder** — 768 -> 512;
- **predictor** — the duration encoder (BiLSTM / style AdaLayerNorm), the
  duration head, and the shared BiLSTM + AdaIN residual F0/N branches;
- **text_encoder** — embedding + convs with channel LayerNorm + BiLSTM;
- **decoder** — the iSTFTNet: AdaIN residual blocks over [asr, F0, N], the
  harmonic source, noise convs and AdaIN-Snake resblocks over two
  transposed-conv upsamples, an exp/sin iSTFT head.

The same two-phase design at the same static buckets: phase A
(:func:`encode_text`) at a token bucket of 64/128/256/512, one host read of
the frame total, then :func:`align` and phase B (:func:`vocode`) at a
frame bucket of ``cfg.frame_buckets``.

Layouts: activations are (B, T, C) as in the JAX package; convolution
weights are PyTorch's ``(out, in/g, k)``, transposed convolutions'
``(in, out/g, k)``, and each BiLSTM is a ``torch.nn.LSTM`` (gates i, f, g,
o; the JAX package's folded bias as ``bias_ih``, ``bias_hh`` zero).
:func:`s2s_tpu_torch.weights.kokoro_params` carries the JAX package's
trees across.  The token-level BiLSTMs run over ``pack_padded_sequence``,
which is what the JAX package's masked carries compute: past a row's
length the reverse carry stays at zeros and the outputs are zero.  The
STFT phase at the DC and Nyquist bins is pinned to ``atan2(+0, re)``, the
JAX package's result, whatever sign of zero the FFT gives there.

Deterministic: the harmonic source's random initial phase and additive
noise are zero, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch import weights
from s2s_tpu_torch.models.common import HostStateDict, layer_norm, tree_to_device
from s2s_tpu_torch.models.common import weight_norm as _wn
from s2s_tpu_torch.models.common import xla_cumsum as _cumsum
from s2s_tpu_torch.models.decoder_lm import normal

Params = dict[str, Any]

SAMPLE_RATE = 24_000

#: phase A's token buckets (the JAX package's ``KokoroTTS.synthesize``)
TOKEN_BUCKETS = (64, 128, 256, 512)


@dataclass(frozen=True)
class AlbertConfig:
    vocab_size: int = 178
    embedding_size: int = 128
    hidden_size: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 2048
    max_positions: int = 512
    layer_norm_eps: float = 1e-12


@dataclass(frozen=True)
class KokoroConfig:
    n_token: int = 178
    hidden_dim: int = 512
    style_dim: int = 128
    n_layer: int = 3          # duration-encoder layers AND text-encoder convs
    max_dur: int = 50
    plbert: AlbertConfig = field(default_factory=AlbertConfig)
    # istftnet block
    upsample_rates: tuple = (10, 6)
    upsample_kernels: tuple = (20, 12)
    upsample_initial: int = 512
    resblock_kernels: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    gen_istft_n_fft: int = 20
    gen_istft_hop: int = 5
    sample_rate: int = 24_000
    # serving buckets
    max_tokens: int = 512
    frame_buckets: tuple = (64, 128, 256, 384, 512, 768, 1024)
    dtype: Any = torch.float32

    @property
    def bottleneck(self) -> int:
        return 2 * self.hidden_dim

    @property
    def samples_per_frame(self) -> int:
        # decoder upsamples frames x2, generator x prod(rates), istft x hop
        return 2 * int(np.prod(self.upsample_rates)) * self.gen_istft_hop

    @staticmethod
    def test_tiny() -> "KokoroConfig":
        return KokoroConfig(
            n_token=20, hidden_dim=32, style_dim=16, n_layer=2, max_dur=10,
            plbert=AlbertConfig(vocab_size=20, embedding_size=16, hidden_size=32,
                                n_layers=2, n_heads=2, d_ff=64, max_positions=64),
            upsample_rates=(4, 2), upsample_kernels=(8, 4), upsample_initial=32,
            resblock_kernels=(3, 7), resblock_dilations=((1, 3), (1, 3)),
            gen_istft_n_fft=8, gen_istft_hop=2,
            max_tokens=16, frame_buckets=(8, 16, 32, 64),
        )


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _conv1d(x, w, b=None, dilation: int = 1, groups: int = 1, stride: int = 1):
    """(B, T, C) conv with w (out, in/g, k), torch symmetric padding (k*d - d)//2."""
    pad = (w.shape[-1] * dilation - dilation) // 2
    return F.conv1d(x.transpose(1, 2), w, b, stride, pad, dilation, groups).transpose(1, 2)


def _conv_transpose1d(x, w, b, stride: int, padding: int, output_padding: int = 0, groups: int = 1):
    """(B, T, C) ConvTranspose1d with w (in, out/g, k)."""
    return F.conv_transpose1d(x.transpose(1, 2), w, b, stride, padding, output_padding, groups).transpose(1, 2)


def _lin(x, w, b=None):
    out = x @ w
    return out if b is None else out + b


def _leaky(x, slope=0.2):
    return F.leaky_relu(x, slope)


def _instance_norm(x, eps=1e-5):
    """InstanceNorm1d(affine=False) on (B, T, C): normalize over T."""
    mean = torch.mean(x, dim=1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _adain(p, x, s):
    """AdaIN1d: instance-norm + style scale/shift. x: (B,T,C), s: (B,sty)."""
    h = _lin(s, p["fc_w"], p["fc_b"])  # (B, 2C)
    c = x.shape[-1]
    gamma, beta = h[:, :c], h[:, c:]
    return (1 + gamma[:, None, :]) * _instance_norm(x) + beta[:, None, :]


def _ada_layer_norm(p, x, s, eps=1e-5):
    """AdaLayerNorm: plain LN over channels + style scale/shift. x: (B,T,C)."""
    h = _lin(s, p["fc_w"], p["fc_b"])
    c = x.shape[-1]
    gamma, beta = h[:, :c], h[:, c:]
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    normed = (x - mean) * torch.rsqrt(var + eps)
    return (1 + gamma[:, None, :]) * normed + beta[:, None, :]


def _snake(x, alpha):
    """Snake1d: x + (1/a) sin^2(a x); alpha (C,)."""
    a = alpha[None, None, :]
    return x + (1.0 / a) * torch.square(torch.sin(a * x))


def _bilstm(lstm: torch.nn.LSTM, x, lengths: torch.Tensor | None = None):
    """Bidirectional LSTM over x (B, T, I) -> (B, T, 2H). With *lengths*
    (B,) int64 on the host, rows run packed to their own length (outputs
    past it are zero); without, every step of every row is valid."""
    if lengths is None:
        return lstm(x)[0]
    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
    out, _ = torch.nn.utils.rnn.pad_packed_sequence(lstm(packed)[0], batch_first=True, total_length=x.shape[1])
    return out


# ---------------------------------------------------------------------------
# PL-BERT (ALBERT)
# ---------------------------------------------------------------------------


def albert_forward(p, cfg: AlbertConfig, tokens, t_mask):
    """tokens (B,T) -> last hidden (B,T,hidden). Shared-layer transformer."""
    t = tokens.shape[1]
    x = p["word_emb"][tokens] + p["pos_emb"][:t][None] + p["type_emb"][0][None, None]
    x = layer_norm(x, p["emb_ln_w"], p["emb_ln_b"], cfg.layer_norm_eps)
    x = _lin(x, p["map_w"], p["map_b"])  # embedding_size -> hidden
    nh, hd = cfg.n_heads, cfg.hidden_size // cfg.n_heads
    neg = torch.finfo(torch.float32).min
    bias = (1.0 - t_mask[:, None, None, :].float()) * neg
    lp = p["layer"]  # ONE shared layer applied n_layers times
    bsz = x.shape[0]
    for _ in range(cfg.n_layers):
        q = _lin(x, lp["q_w"], lp["q_b"]).reshape(bsz, t, nh, hd).transpose(1, 2)
        k = _lin(x, lp["k_w"], lp["k_b"]).reshape(bsz, t, nh, hd).transpose(1, 2)
        v = _lin(x, lp["v_w"], lp["v_b"]).reshape(bsz, t, nh, hd).transpose(1, 2)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1)
        ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        ctx = ctx.transpose(1, 2).reshape(bsz, t, cfg.hidden_size)
        attn_out = _lin(ctx, lp["o_w"], lp["o_b"])
        x = layer_norm(x + attn_out, lp["attn_ln_w"], lp["attn_ln_b"], cfg.layer_norm_eps)
        h = F.gelu(_lin(x, lp["ffn_w"], lp["ffn_b"]), approximate="tanh")  # gelu_new
        h = _lin(h, lp["ffn_out_w"], lp["ffn_out_b"])
        x = layer_norm(x + h, lp["full_ln_w"], lp["full_ln_b"], cfg.layer_norm_eps)
    return x


# ---------------------------------------------------------------------------
# AdaIN residual block (StyleTTS2 AdainResBlk1d)
# ---------------------------------------------------------------------------


def _adain_res_blk(p, x, s, upsample: bool = False):
    """x: (B,T,Cin) -> (B,T[*2],Cout)."""
    h = _adain(p["norm1"], x, s)
    h = _leaky(h, 0.2)
    if upsample:
        h = _conv_transpose1d(h, p["pool_w"], p["pool_b"], stride=2, padding=1, output_padding=1,
                              groups=h.shape[-1])
    h = _conv1d(h, p["conv1_w"], p["conv1_b"])
    h = _adain(p["norm2"], h, s)
    h = _leaky(h, 0.2)
    h = _conv1d(h, p["conv2_w"], p["conv2_b"])
    sc = torch.repeat_interleave(x, 2, dim=1) if upsample else x
    if "sc_w" in p:
        sc = _lin(sc, p["sc_w"])  # 1x1, no bias
    return (h + sc) / math.sqrt(2)


def _adain_snake_res_blk(p, x, s, dilations):
    """Generator AdaINResBlock1 with Snake activations."""
    for j, d in enumerate(dilations):
        h = _adain(p["adain1"][j], x, s)
        h = _snake(h, p["alpha1"][j])
        h = _conv1d(h, p["c1_w"][j], p["c1_b"][j], dilation=d)
        h = _adain(p["adain2"][j], h, s)
        h = _snake(h, p["alpha2"][j])
        h = _conv1d(h, p["c2_w"][j], p["c2_b"][j])
        x = x + h
    return x


# ---------------------------------------------------------------------------
# STFT helpers (torch center=True, hann periodic)
# ---------------------------------------------------------------------------


def _hann(n_fft: int, device) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n_fft, device=device, dtype=torch.float32) / n_fft)


def _stft_features(x, n_fft: int, hop: int):
    """x: (B, L) -> (mag, angle) each (B, L/hop + 1, n_fft/2+1)."""
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)  # (B, L/hop + 1, n_fft)
    spec = torch.fft.rfft(frames * _hann(n_fft, x.device), dim=-1)
    phase = torch.angle(spec)
    # the DC and Nyquist bins are real: their phase is atan2(+0, re), as the
    # JAX package's FFT gives it, whatever sign of zero this FFT gives there
    edge = torch.where(spec.real[..., [0, -1]] < 0, math.pi, 0.0)
    phase = torch.cat([edge[..., :1], phase[..., 1:-1], edge[..., 1:]], dim=-1)
    return torch.abs(spec), phase


def _istft(mag, phase, n_fft: int, hop: int):
    """torch.istft(center=True) of (B, F, n_fft/2+1) -> (B, (F-1)*hop)."""
    spec = torch.polar(mag, phase).transpose(1, 2)  # (B, bins, F)
    return torch.istft(spec, n_fft, hop, n_fft, window=_hann(n_fft, mag.device), center=True,
                       length=(mag.shape[1] - 1) * hop)


# ---------------------------------------------------------------------------
# harmonic source (SineGen, deterministic)
# ---------------------------------------------------------------------------


def _interp_linear(x, out_len: int):
    """F.interpolate(mode='linear', align_corners=False) on (B, T, C)."""
    t = x.shape[1]
    scale = t / out_len
    pos = (torch.arange(out_len, device=x.device, dtype=torch.float32) + 0.5) * scale - 0.5
    pos = torch.clamp(pos, 0.0, t - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    w = (pos - lo)[None, :, None]
    return x[:, lo] * (1 - w) + x[:, hi] * w


def _sine_source(p, cfg: KokoroConfig, f0):
    """f0: (B, L, 1) already upsampled to sample rate. Returns (B, L) the
    tanh-merged harmonic source (zero init phase / zero noise)."""
    upsample_scale = int(np.prod(cfg.upsample_rates)) * cfg.gen_istft_hop
    harmonics = torch.arange(1, 10, device=f0.device, dtype=torch.float32)  # harmonic_num=8 -> dim 9
    fn = f0 * harmonics[None, None, :]
    # IEEE division by a device tensor (a host scalar may become a reciprocal product)
    rad = torch.remainder(fn / torch.full((), float(cfg.sample_rate), device=fn.device), 1.0)
    down = _interp_linear(rad, fn.shape[1] // upsample_scale)
    phase = _cumsum(down) * 2 * np.pi
    phase = _interp_linear(phase * upsample_scale, fn.shape[1])
    sines = torch.sin(phase) * 0.1  # sine_amp
    uv = (f0 > 10.0).float()  # voiced_threshold=10
    merged = torch.tanh(_lin(sines * uv, p["lin_w"], p["lin_b"]))  # (B, L, 1)
    return merged[..., 0]


# ---------------------------------------------------------------------------
# phase A: text -> durations + encodings
# ---------------------------------------------------------------------------


def _duration_encoder(p, x, s, valid, lengths):
    """x: (B,T,512) bert-encoded; s: (B,sty). Returns d (B,T,640)."""
    mask3 = valid[..., None].to(x.dtype)
    sty = s[:, None, :].expand(x.shape[0], x.shape[1], s.shape[-1]).to(x.dtype)
    h = torch.cat([x, sty], dim=-1) * mask3
    for layer in p["layers"]:
        h = _bilstm(layer["lstm"], h, lengths)
        h = _ada_layer_norm(layer["ada_ln"], h, s)
        h = torch.cat([h, sty], dim=-1) * mask3
    return h


def encode_text(params: Params, cfg: KokoroConfig, tokens, n_valid, ref_s, speed):
    """Phase A. tokens: (B, T) int; n_valid: (B,) int, on the host or the
    device; ref_s: (B, 2*style); speed: a float or a 0-d tensor.
    Returns (pred_dur (B,T) int32, d (B,T,640), t_en (B,T,512))."""
    t = tokens.shape[1]
    lengths = torch.as_tensor(n_valid).to("cpu", torch.int64)
    valid = torch.arange(t, device=tokens.device)[None, :] < lengths.to(tokens.device)[:, None]
    t_mask = valid.float()
    s_pred = ref_s[:, cfg.style_dim:]

    bert_out = albert_forward(params["bert"], cfg.plbert, tokens, t_mask)
    d_en = _lin(bert_out, params["bert_encoder"]["w"], params["bert_encoder"]["b"])
    d = _duration_encoder(params["predictor"]["text_encoder"], d_en, s_pred, valid, lengths)

    x = _bilstm(params["predictor"]["lstm"], d, lengths)
    dur_logits = _lin(x, params["predictor"]["duration_proj"]["w"], params["predictor"]["duration_proj"]["b"])
    speed = torch.as_tensor(speed, dtype=torch.float32, device=tokens.device)  # IEEE division, as JAX
    duration = torch.sum(torch.sigmoid(dur_logits), dim=-1) / speed
    pred_dur = torch.clamp(torch.round(duration), min=1.0).to(torch.int32)
    pred_dur = pred_dur * valid.to(torch.int32)

    # text encoder (phonemes -> acoustic features)
    te = params["text_encoder"]
    h = te["embed"][tokens].to(cfg.dtype) * t_mask[..., None]
    for c in te["cnn"]:
        h = _conv1d(h * t_mask[..., None], c["conv_w"], c["conv_b"])
        h = layer_norm(h, c["ln_w"], c["ln_b"], 1e-5)
        h = _leaky(h, 0.2)
        h = h * t_mask[..., None]
    t_en = _bilstm(te["lstm"], h, lengths) * t_mask[..., None]
    return pred_dur, d, t_en


# ---------------------------------------------------------------------------
# phase B: aligned frames -> audio
# ---------------------------------------------------------------------------


def _f0n_branch(p_blocks, proj, x, s):
    """Three AdainResBlk1d (middle upsamples x2) + 1x1 proj -> (B, 2F)."""
    h = _adain_res_blk(p_blocks[0], x, s)
    h = _adain_res_blk(p_blocks[1], h, s, upsample=True)
    h = _adain_res_blk(p_blocks[2], h, s)
    return _lin(h, proj["w"], proj["b"])[..., 0]


def vocode(params: Params, cfg: KokoroConfig, en, asr, ref_s):
    """Phase B. en: (B, F, 640) aligned duration encodings; asr: (B, F, 512)
    aligned text encodings; ref_s: (B, 2*style). Returns (B, F*spf) audio."""
    s_pred = ref_s[:, cfg.style_dim:]
    s_dec = ref_s[:, : cfg.style_dim]
    pr = params["predictor"]

    shared = _bilstm(pr["shared"], en)  # every frame of the bucket is valid
    f0_curve = _f0n_branch(pr["F0"], pr["F0_proj"], shared, s_pred)  # (B, 2F)
    n_curve = _f0n_branch(pr["N"], pr["N_proj"], shared, s_pred)

    dec = params["decoder"]
    f0 = _conv1d(f0_curve[..., None], dec["f0_conv_w"], dec["f0_conv_b"], stride=2)
    n = _conv1d(n_curve[..., None], dec["n_conv_w"], dec["n_conv_b"], stride=2)
    x = torch.cat([asr, f0, n], dim=-1)
    x = _adain_res_blk(dec["encode"], x, s_dec)
    asr_res = _lin(asr, dec["asr_res_w"], dec["asr_res_b"])
    for i, blk in enumerate(dec["decode"]):
        last = i == len(dec["decode"]) - 1
        x = torch.cat([x, asr_res, f0, n], dim=-1)
        x = _adain_res_blk(blk, x, s_dec, upsample=last)

    # generator
    g = dec["generator"]
    upsample_scale = int(np.prod(cfg.upsample_rates)) * cfg.gen_istft_hop
    f0_up = torch.repeat_interleave(f0_curve[..., None], upsample_scale, dim=1)  # nn.Upsample
    har = _sine_source(g["source"], cfg, f0_up)
    har_mag, har_phase = _stft_features(har, cfg.gen_istft_n_fft, cfg.gen_istft_hop)
    har_feat = torch.cat([har_mag, har_phase], dim=-1).to(cfg.dtype)

    nk = len(cfg.resblock_kernels)
    for i, (rate, ksz) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        x = _leaky(x, 0.1)
        if i + 1 < len(cfg.upsample_rates):
            stride_f0 = int(np.prod(cfg.upsample_rates[i + 1:]))
            # torch Conv1d output length floor((L + 2p - k)/s) + 1, as the JAX slice
            xs_src = F.conv1d(har_feat.transpose(1, 2), g["noise_conv_w"][i], g["noise_conv_b"][i],
                              stride=stride_f0, padding=(stride_f0 + 1) // 2).transpose(1, 2)
        else:
            xs_src = _lin(har_feat, g["noise_conv_w"][i][:, :, 0].T, g["noise_conv_b"][i])
        xs_src = _adain_snake_res_blk(g["noise_res"][i], xs_src, s_dec, (1, 3, 5))
        x = _conv_transpose1d(x, g["ups_w"][i], g["ups_b"][i], stride=rate, padding=(ksz - rate) // 2)
        if i == len(cfg.upsample_rates) - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)  # ReflectionPad1d((1, 0))
        x = x + xs_src
        acc = None
        for j in range(nk):
            r = _adain_snake_res_blk(g["res"][i * nk + j], x, s_dec, cfg.resblock_dilations[j])
            acc = r if acc is None else acc + r
        x = acc / nk
    x = _leaky(x, 0.01)
    x = _conv1d(x, g["post_w"], g["post_b"])
    half = cfg.gen_istft_n_fft // 2 + 1
    mag = torch.exp(x[..., :half])
    phase = torch.sin(x[..., half:])
    return _istft(mag, phase, cfg.gen_istft_n_fft, cfg.gen_istft_hop)


def align(values, pred_dur, max_frames: int):
    """Monotonic length regulation as a dense one-hot product.
    values: (B, T, C); pred_dur: (B, T) int. Returns (B, max_frames, C)."""
    cum = torch.cumsum(pred_dur.long(), dim=-1)
    frames = torch.arange(max_frames, device=values.device)
    tok = torch.sum(frames[None, :, None] >= cum[:, None, :], dim=-1)
    tok = torch.clamp(tok, 0, values.shape[1] - 1)
    onehot = F.one_hot(tok, values.shape[1]).float()
    o_mask = (frames[None, :] < cum[:, -1][:, None]).float()
    onehot = onehot * o_mask[..., None]
    return torch.einsum("bft,btc->bfc", onehot, values.float()).to(values.dtype)


# ---------------------------------------------------------------------------
# init (random weights for tests / no-checkpoint serving)
# ---------------------------------------------------------------------------


def init_params(cfg: KokoroConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*: the JAX package's
    distributions and tree (its layouts, then
    :func:`s2s_tpu_torch.weights.kokoro_params`), not its numbers."""
    dt = cfg.dtype

    def rnd(shape, scale=0.02):
        return normal(gen, shape, scale, dt, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def lin(i, o):
        return {"w": rnd((i, o), i ** -0.5), "b": zeros(o)}

    def conv(k, i, o):
        return rnd((k, i, o), (k * i) ** -0.5), zeros(o)

    ac = cfg.plbert
    hs = ac.hidden_size
    layer = {"attn_ln_w": ones(hs), "attn_ln_b": zeros(hs), "full_ln_w": ones(hs), "full_ln_b": zeros(hs)}
    for name, (i, o) in {"q": (hs, hs), "k": (hs, hs), "v": (hs, hs), "o": (hs, hs),
                         "ffn": (hs, ac.d_ff), "ffn_out": (ac.d_ff, hs)}.items():
        layer[f"{name}_w"], layer[f"{name}_b"] = rnd((i, o), i ** -0.5), zeros(o)
    albert = {
        "word_emb": rnd((ac.vocab_size, ac.embedding_size)),
        "pos_emb": rnd((ac.max_positions, ac.embedding_size)),
        "type_emb": rnd((2, ac.embedding_size)),
        "emb_ln_w": ones(ac.embedding_size),
        "emb_ln_b": zeros(ac.embedding_size),
        "map_w": rnd((ac.embedding_size, hs), ac.embedding_size ** -0.5),
        "map_b": zeros(hs),
        "layer": layer,
    }

    def lstm(i, h):
        return {
            "w_ih_f": rnd((i, 4 * h), i ** -0.5), "w_hh_f": rnd((h, 4 * h), h ** -0.5), "b_f": zeros(4 * h),
            "w_ih_b": rnd((i, 4 * h), i ** -0.5), "w_hh_b": rnd((h, 4 * h), h ** -0.5), "b_b": zeros(4 * h),
        }

    def adain(c):
        return {"fc_w": rnd((cfg.style_dim, 2 * c), cfg.style_dim ** -0.5), "fc_b": zeros(2 * c)}

    def res_blk(ci, co, upsample=False):
        w1, b1 = conv(3, ci, co)
        w2, b2 = conv(3, co, co)
        p = {"norm1": adain(ci), "norm2": adain(co), "conv1_w": w1, "conv1_b": b1, "conv2_w": w2, "conv2_b": b2}
        if ci != co:
            p["sc_w"] = rnd((ci, co), ci ** -0.5)
        if upsample:
            p["pool_w"], p["pool_b"] = conv(3, 1, ci)
        return p

    def snake_blk(c, kernel, dils):
        p = {"adain1": [adain(c) for _ in dils], "adain2": [adain(c) for _ in dils],
             "alpha1": [ones(c) for _ in dils], "alpha2": [ones(c) for _ in dils],
             "c1_w": [], "c1_b": [], "c2_w": [], "c2_b": []}
        for _ in dils:
            for name in ("c1", "c2"):
                w, b = conv(kernel, c, c)
                p[f"{name}_w"].append(w)
                p[f"{name}_b"].append(b)
        return p

    h, sty = cfg.hidden_dim, cfg.style_dim
    predictor = {
        "text_encoder": {"layers": [{"lstm": lstm(h + sty, h // 2), "ada_ln": adain(h)} for _ in range(cfg.n_layer)]},
        "lstm": lstm(h + sty, h // 2),
        "duration_proj": lin(h, cfg.max_dur),
        "shared": lstm(h + sty, h // 2),
        "F0": [res_blk(h, h), res_blk(h, h // 2, upsample=True), res_blk(h // 2, h // 2)],
        "N": [res_blk(h, h), res_blk(h, h // 2, upsample=True), res_blk(h // 2, h // 2)],
        "F0_proj": lin(h // 2, 1),
        "N_proj": lin(h // 2, 1),
    }
    text_encoder = {"embed": rnd((cfg.n_token, h)), "cnn": [], "lstm": lstm(h, h // 2)}
    for _ in range(cfg.n_layer):
        w, b = conv(5, h, h)
        text_encoder["cnn"].append({"conv_w": w, "conv_b": b, "ln_w": ones(h), "ln_b": zeros(h)})

    ch0 = cfg.upsample_initial
    n_fft2 = cfg.gen_istft_n_fft + 2
    gen_p = {"ups_w": [], "ups_b": [], "res": [], "noise_conv_w": [], "noise_conv_b": [], "noise_res": [],
             "source": {"lin_w": rnd((9, 1), 3 ** -0.5), "lin_b": zeros(1)}}
    ch = ch0
    for i, (rate, ksz) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        out_ch = ch0 // (2 ** (i + 1))
        w, b = conv(ksz, ch, out_ch)
        gen_p["ups_w"].append(w)
        gen_p["ups_b"].append(b)
        for kern, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations):
            gen_p["res"].append(snake_blk(out_ch, kern, dils))
        if i + 1 < len(cfg.upsample_rates):
            stride_f0 = int(np.prod(cfg.upsample_rates[i + 1:]))
            w, b = conv(stride_f0 * 2, n_fft2, out_ch)
            gen_p["noise_res"].append(snake_blk(out_ch, 7, (1, 3, 5)))
        else:
            w, b = conv(1, n_fft2, out_ch)
            gen_p["noise_res"].append(snake_blk(out_ch, 11, (1, 3, 5)))
        gen_p["noise_conv_w"].append(w)
        gen_p["noise_conv_b"].append(b)
        ch = out_ch
    gen_p["post_w"], gen_p["post_b"] = conv(7, ch, n_fft2)

    bn = cfg.bottleneck
    f0w, f0b = conv(3, 1, 1)
    nw, nb = conv(3, 1, 1)
    decoder = {
        "encode": res_blk(h + 2, bn),
        "decode": [res_blk(bn + 2 + h // 8, bn) for _ in range(3)] + [res_blk(bn + 2 + h // 8, ch0, upsample=True)],
        "f0_conv_w": f0w, "f0_conv_b": f0b,
        "n_conv_w": nw, "n_conv_b": nb,
        "asr_res_w": rnd((h, h // 8), h ** -0.5), "asr_res_b": zeros(h // 8),
        "generator": gen_p,
    }
    tree = {
        "bert": albert,
        "bert_encoder": lin(hs, h),
        "predictor": predictor,
        "text_encoder": text_encoder,
        "decoder": decoder,
        # voicepack rows (n_voices, 2*style); a converted checkpoint brings real packs
        "voices": rnd((8, 2 * sty)),
    }
    return weights.kokoro_params(tree, device)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


class KokoroTTS:
    """Host wrapper: text/phonemes -> float32 audio @24 kHz, on *device*.

    Voice selection mirrors the reference voicepacks: each voice is a
    (510, 2*style) table indexed by input length (``pack[len-1]``); random
    init uses the per-voice rows in ``params['voices']`` directly."""

    def __init__(self, params: Params | None = None, cfg: KokoroConfig = KokoroConfig(),
                 seed: int = 0, vocab: dict[str, int] | None = None, g2p=None,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            params = init_params(cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
        self.params = params
        self.vocab = vocab
        #: grapheme->phoneme callable (:mod:`s2s_tpu_torch.tts.g2p`); applied
        #: before the vocab map.  ``None`` = input is already a phoneme string.
        self.g2p = g2p
        self.voicepacks: dict[str, np.ndarray] = {}

    def add_voice(self, name: str, pack: np.ndarray) -> None:
        """pack: (N, 2*style) length-indexed style table (510 rows in the
        reference packs; a single row also works)."""
        self.voicepacks[name] = np.asarray(pack, np.float32).reshape(-1, 2 * self.cfg.style_dim)

    def _ref_s(self, voice, n_tokens: int) -> torch.Tensor:
        if isinstance(voice, str) and voice in self.voicepacks:
            pack = self.voicepacks[voice]
            return torch.from_numpy(pack[min(n_tokens - 1, len(pack) - 1)][None].copy()).to(self.device)
        vid = voice if isinstance(voice, int) else 0
        voices = self.params["voices"]
        return voices[vid % len(voices)][None]

    def _encode(self, text: str) -> list[int]:
        """With a converted vocab sidecar the input is a PHONEME string (or
        plain text through ``g2p``); without one, a byte-level fallback keeps
        random-init serving and tests running."""
        if self.g2p is not None and self.vocab is not None:
            text = self.g2p(text)
        if self.vocab is not None:
            return [self.vocab[c] for c in text if c in self.vocab]
        return [1 + (b % (self.cfg.n_token - 1)) for b in text.encode("utf-8")]

    def token_bucket(self, n_ids: int) -> int:
        cfg = self.cfg
        bucket = next(b for b in TOKEN_BUCKETS if b >= n_ids) if cfg.max_tokens >= 64 else cfg.max_tokens
        return min(bucket, cfg.max_tokens)

    def frame_bucket(self, total: int) -> int:
        return next((b for b in self.cfg.frame_buckets if b >= total), self.cfg.frame_buckets[-1])

    @torch.inference_mode()
    def synthesize(self, text: str, voice_id=0, speed: float = 1.0) -> np.ndarray:
        cfg = self.cfg
        ids = self._encode(text)[: cfg.max_tokens] or [1]
        tokens = torch.zeros((1, self.token_bucket(len(ids))), dtype=torch.long)
        tokens[0, : len(ids)] = torch.tensor(ids)
        ref_s = self._ref_s(voice_id, len(ids))
        pred_dur, d, t_en = encode_text(self.params, cfg, tokens.to(self.device), torch.tensor([len(ids)]),
                                        ref_s, float(speed))
        total = int(torch.sum(pred_dur[0]))  # the one host read between the phases
        frame_bucket = self.frame_bucket(total)
        en, asr = align(d, pred_dur, frame_bucket), align(t_en, pred_dur, frame_bucket)
        audio = vocode(self.params, cfg, en, asr, ref_s)
        n = min(total, frame_bucket) * cfg.samples_per_frame
        return audio[0, :n].float().cpu().numpy()

    def stream(self, text: str, voice_id=0, speed: float = 1.0, chunk_s: float = 0.5):
        """Chunked emission (kokoro-class models synthesize faster than
        realtime; the reference streams per generated segment)."""
        audio = self.synthesize(text, voice_id, speed)
        step = int(chunk_s * self.cfg.sample_rate)
        for i in range(0, max(len(audio), 1), step):
            yield audio[i: i + step], self.cfg.sample_rate


# ---------------------------------------------------------------------------
# checkpoint conversion: the JAX package's numpy converter, its tree on a device
# ---------------------------------------------------------------------------


def convert_state_dict(sd: dict, cfg: KokoroConfig = KokoroConfig(), device: torch.device | str = "cpu") -> Params:
    """Flattened kokoro checkpoint ('bert.*', 'bert_encoder.*', 'predictor.*',
    'text_encoder.*', 'decoder.*'; 'module.' prefixes stripped by the
    loader) -> the JAX package's tree on *device*.  Layout documented in
    scripts/_kokoro_torch_twin.py."""
    sd = HostStateDict(sd)

    def t(name):
        return np.asarray(sd[name], np.float32)

    def lin_t(name):
        return t(name).T

    def conv_t(w):
        return np.asarray(w, np.float32).transpose(2, 1, 0)

    def convT_t(w):
        w = np.asarray(w, np.float32)  # (I, O, K) non-grouped
        return w[:, :, ::-1].transpose(2, 0, 1).copy()  # flip -> (K, I, O)

    def convT_group_t(w):
        w = np.asarray(w, np.float32)  # (I, O/g=1, K) depthwise
        return w[:, :, ::-1].transpose(2, 1, 0).copy()  # flip -> (K, 1, I)

    # ALBERT — note HF prefix "encoder.albert_layer_groups.0.albert_layers.0"
    al = "bert.encoder.albert_layer_groups.0.albert_layers.0"
    albert = {
        "word_emb": t("bert.embeddings.word_embeddings.weight"),
        "pos_emb": t("bert.embeddings.position_embeddings.weight"),
        "type_emb": t("bert.embeddings.token_type_embeddings.weight"),
        "emb_ln_w": t("bert.embeddings.LayerNorm.weight"),
        "emb_ln_b": t("bert.embeddings.LayerNorm.bias"),
        "map_w": lin_t("bert.encoder.embedding_hidden_mapping_in.weight"),
        "map_b": t("bert.encoder.embedding_hidden_mapping_in.bias"),
        "layer": {
            "q_w": lin_t(f"{al}.attention.query.weight"), "q_b": t(f"{al}.attention.query.bias"),
            "k_w": lin_t(f"{al}.attention.key.weight"), "k_b": t(f"{al}.attention.key.bias"),
            "v_w": lin_t(f"{al}.attention.value.weight"), "v_b": t(f"{al}.attention.value.bias"),
            "o_w": lin_t(f"{al}.attention.dense.weight"), "o_b": t(f"{al}.attention.dense.bias"),
            "attn_ln_w": t(f"{al}.attention.LayerNorm.weight"),
            "attn_ln_b": t(f"{al}.attention.LayerNorm.bias"),
            "ffn_w": lin_t(f"{al}.ffn.weight"), "ffn_b": t(f"{al}.ffn.bias"),
            "ffn_out_w": lin_t(f"{al}.ffn_output.weight"), "ffn_out_b": t(f"{al}.ffn_output.bias"),
            "full_ln_w": t(f"{al}.full_layer_layer_norm.weight"),
            "full_ln_b": t(f"{al}.full_layer_layer_norm.bias"),
        },
    }

    def lstm_t(prefix):
        return {
            "w_ih_f": lin_t(f"{prefix}.weight_ih_l0"),
            "w_hh_f": lin_t(f"{prefix}.weight_hh_l0"),
            "b_f": t(f"{prefix}.bias_ih_l0") + t(f"{prefix}.bias_hh_l0"),
            "w_ih_b": lin_t(f"{prefix}.weight_ih_l0_reverse"),
            "w_hh_b": lin_t(f"{prefix}.weight_hh_l0_reverse"),
            "b_b": t(f"{prefix}.bias_ih_l0_reverse") + t(f"{prefix}.bias_hh_l0_reverse"),
        }

    def adain_t(prefix):
        return {"fc_w": lin_t(f"{prefix}.fc.weight"), "fc_b": t(f"{prefix}.fc.bias")}

    def res_blk_t(prefix, upsample=False):
        p = {
            "norm1": adain_t(f"{prefix}.norm1"),
            "norm2": adain_t(f"{prefix}.norm2"),
            "conv1_w": conv_t(_wn(sd, f"{prefix}.conv1")), "conv1_b": t(f"{prefix}.conv1.bias"),
            "conv2_w": conv_t(_wn(sd, f"{prefix}.conv2")), "conv2_b": t(f"{prefix}.conv2.bias"),
        }
        if f"{prefix}.conv1x1.weight_v" in sd or f"{prefix}.conv1x1.weight" in sd \
                or f"{prefix}.conv1x1.parametrizations.weight.original0" in sd:
            p["sc_w"] = _wn(sd, f"{prefix}.conv1x1")[:, :, 0].T
        if upsample:
            p["pool_w"] = convT_group_t(_wn(sd, f"{prefix}.pool"))
            p["pool_b"] = t(f"{prefix}.pool.bias")
        return p

    def snake_blk_t(prefix, n):
        p = {"adain1": [], "adain2": [], "alpha1": [], "alpha2": [],
             "c1_w": [], "c1_b": [], "c2_w": [], "c2_b": []}
        for j in range(n):
            p["adain1"].append(adain_t(f"{prefix}.adain1.{j}"))
            p["adain2"].append(adain_t(f"{prefix}.adain2.{j}"))
            p["alpha1"].append(t(f"{prefix}.alpha1.{j}")[0, :, 0])
            p["alpha2"].append(t(f"{prefix}.alpha2.{j}")[0, :, 0])
            p["c1_w"].append(conv_t(_wn(sd, f"{prefix}.convs1.{j}")))
            p["c1_b"].append(t(f"{prefix}.convs1.{j}.bias"))
            p["c2_w"].append(conv_t(_wn(sd, f"{prefix}.convs2.{j}")))
            p["c2_b"].append(t(f"{prefix}.convs2.{j}.bias"))
        return p

    de_layers = []
    for i in range(cfg.n_layer):
        de_layers.append({
            "lstm": lstm_t(f"predictor.text_encoder.lstms.{2 * i}"),
            "ada_ln": adain_t(f"predictor.text_encoder.lstms.{2 * i + 1}"),
        })

    dur_key = ("predictor.duration_proj.linear_layer.weight"
               if "predictor.duration_proj.linear_layer.weight" in sd
               else "predictor.duration_proj.weight")
    predictor = {
        "text_encoder": {"layers": de_layers},
        "lstm": lstm_t("predictor.lstm"),
        "duration_proj": {"w": np.asarray(sd[dur_key], np.float32).T,
                          "b": t(dur_key.replace("weight", "bias"))},
        "shared": lstm_t("predictor.shared"),
        "F0": [res_blk_t("predictor.F0.0"), res_blk_t("predictor.F0.1", upsample=True),
               res_blk_t("predictor.F0.2")],
        "N": [res_blk_t("predictor.N.0"), res_blk_t("predictor.N.1", upsample=True),
              res_blk_t("predictor.N.2")],
        "F0_proj": {"w": t("predictor.F0_proj.weight")[:, :, 0].T,
                    "b": t("predictor.F0_proj.bias")},
        "N_proj": {"w": t("predictor.N_proj.weight")[:, :, 0].T,
                   "b": t("predictor.N_proj.bias")},
    }

    text_encoder = {
        "embed": t("text_encoder.embedding.weight"),
        "cnn": [
            {
                "conv_w": conv_t(_wn(sd, f"text_encoder.cnn.{i}.0")),
                "conv_b": t(f"text_encoder.cnn.{i}.0.bias"),
                "ln_w": t(f"text_encoder.cnn.{i}.1.gamma"),
                "ln_b": t(f"text_encoder.cnn.{i}.1.beta"),
            }
            for i in range(cfg.n_layer)
        ],
        "lstm": lstm_t("text_encoder.lstm"),
    }

    nk = len(cfg.resblock_kernels)
    gen = {"ups_w": [], "ups_b": [], "res": [], "noise_conv_w": [], "noise_conv_b": [],
           "noise_res": [],
           "source": {"lin_w": lin_t("decoder.generator.m_source.l_linear.weight"),
                      "lin_b": t("decoder.generator.m_source.l_linear.bias")}}
    for i in range(len(cfg.upsample_rates)):
        gen["ups_w"].append(convT_t(_wn(sd, f"decoder.generator.ups.{i}")))
        gen["ups_b"].append(t(f"decoder.generator.ups.{i}.bias"))
        for j in range(nk):
            gen["res"].append(snake_blk_t(f"decoder.generator.resblocks.{i * nk + j}",
                                          len(cfg.resblock_dilations[j])))
        gen["noise_conv_w"].append(conv_t(sd[f"decoder.generator.noise_convs.{i}.weight"]))
        gen["noise_conv_b"].append(t(f"decoder.generator.noise_convs.{i}.bias"))
        gen["noise_res"].append(snake_blk_t(f"decoder.generator.noise_res.{i}", 3))
    gen["post_w"] = conv_t(_wn(sd, "decoder.generator.conv_post"))
    gen["post_b"] = t("decoder.generator.conv_post.bias")

    decoder = {
        "encode": res_blk_t("decoder.encode"),
        "decode": [res_blk_t(f"decoder.decode.{i}") for i in range(3)]
                  + [res_blk_t("decoder.decode.3", upsample=True)],
        "f0_conv_w": conv_t(_wn(sd, "decoder.F0_conv")),
        "f0_conv_b": t("decoder.F0_conv.bias"),
        "n_conv_w": conv_t(_wn(sd, "decoder.N_conv")),
        "n_conv_b": t("decoder.N_conv.bias"),
        "asr_res_w": _wn(sd, "decoder.asr_res.0")[:, :, 0].T,
        "asr_res_b": t("decoder.asr_res.0.bias"),
        "generator": gen,
    }

    return tree_to_device({
        "bert": albert,
        "bert_encoder": {"w": lin_t("bert_encoder.weight"), "b": t("bert_encoder.bias")},
        "predictor": predictor,
        "text_encoder": text_encoder,
        "decoder": decoder,
        "voices": np.zeros((1, 2 * cfg.style_dim), np.float32),
    }, device)
