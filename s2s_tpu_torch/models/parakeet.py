"""Parakeet-TDT ASR (port of ``s2s_tpu/models/parakeet.py``): log-mel
frontend, FastConformer encoder with relative-position attention, LSTM
prediction network, additive joint and the TDT greedy decode.

Layouts follow the JAX package except the depthwise conv of the conformer
conv module, which is kept in PyTorch's Conv1d layout ``(d, 1, k)`` (the JAX
tree stores ``(k, 1, d)``; :mod:`s2s_tpu_torch.weights` converts).
:func:`convert_state_dict` maps an HF or NeMo checkpoint onto the JAX tree.

The TDT decode is a host loop over device tensors with one host read per
step (token and duration together), where JAX runs one ``lax.while_loop`` on
the device; moving it on the device is later work (PERF.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch.models.common import (
    Params, device_tensor, host_array, layer_norm, layer_slice, linear, n_stacked, stack_layers,
)
from s2s_tpu_torch.models.decoder_lm import normal
from s2s_tpu_torch.ops import log_mel

LOG_ZERO_GUARD = 2.0 ** -24
NORM_EPS = 1e-5
MAX_TOKENS = 512


@dataclass(frozen=True)
class ParakeetConfig:
    # frontend
    sample_rate: int = 16_000
    n_mels: int = 128
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    preemphasis: float = 0.97
    # encoder
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 8
    d_ff: int = 4096
    conv_kernel: int = 9
    sub_channels: int = 256
    sub_layers: int = 3  # log2(subsampling factor 8)
    # decoder / joint (blank id == vocab_size, NeMo layout)
    vocab_size: int = 8192
    pred_hidden: int = 640
    pred_layers: int = 1
    joint_hidden: int = 640
    n_durations: int = 5  # durations 0..4
    max_symbols_per_frame: int = 10
    max_enc_frames: int = 1500 // 8 + 8
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def sub_factor(self) -> int:
        return 2 ** self.sub_layers

    @staticmethod
    def tdt_0_6b_v3() -> "ParakeetConfig":
        """nvidia/parakeet-tdt-0.6b-v3 (25-language, the reference default)."""
        return ParakeetConfig()

    @staticmethod
    def tdt_0_6b_v2() -> "ParakeetConfig":
        """nvidia/parakeet-tdt-0.6b-v2 (English, 1024-token vocab)."""
        return ParakeetConfig(vocab_size=1024)

    @staticmethod
    def test_tiny() -> "ParakeetConfig":
        return ParakeetConfig(
            n_mels=32, d_model=64, n_layers=2, n_heads=4, d_ff=128, sub_channels=32,
            vocab_size=64, pred_hidden=32, pred_layers=1, joint_hidden=32,
            max_enc_frames=64, dtype=torch.float32,
        )


# ---------------------------------------------------------------------------
# log-mel frontend (NeMo preprocessing semantics)
# ---------------------------------------------------------------------------


def frontend(cfg: ParakeetConfig) -> log_mel.Frontend:
    """The frontend parameters of *cfg*, as the log-mel kernel takes them."""
    return log_mel.Frontend(n_mels=cfg.n_mels, n_fft=cfg.n_fft, win_length=cfg.win_length, hop=cfg.hop_length,
                            preemphasis=cfg.preemphasis, sample_rate=cfg.sample_rate)


def log_mel_frontend(audio: torch.Tensor, n_valid: int, cfg: ParakeetConfig):
    """audio: (N,) f32 (zero-padded past n_valid) -> ((T, n_mels) normalized
    log-mel, valid frame count).  T = 1 + N // hop.  Preemphasis over valid
    samples, centered STFT with constant padding, power, slaney mel,
    log(x + 2^-24), per-feature mean/std over the valid frames."""
    n = audio.shape[0]
    x = torch.cat([audio[:1], audio[1:] - cfg.preemphasis * audio[:-1]])
    x = torch.where(torch.arange(n, device=audio.device) < n_valid, x, 0.0).float()
    pad = cfg.n_fft // 2
    x = F.pad(x, (pad, pad))
    n_frames = 1 + n // cfg.hop_length
    frames = x.unfold(0, cfg.n_fft, cfg.hop_length)[:n_frames]  # (T, n_fft)
    cos_b, sin_b, fb = log_mel.stft_tables(frontend(cfg), audio.device)
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ fb
    logmel = torch.log(mel + LOG_ZERO_GUARD)
    n_valid_frames = n_valid // cfg.hop_length
    frame_mask = (torch.arange(n_frames, device=audio.device) < n_valid_frames)[:, None]
    masked = torch.where(frame_mask, logmel, 0.0)
    denom = float(max(n_valid_frames, 1))
    mean = masked.sum(dim=0, keepdim=True) / denom
    var = torch.where(frame_mask, (logmel - mean) ** 2, 0.0).sum(dim=0, keepdim=True)
    std = torch.sqrt(var / max(denom - 1.0, 1.0))
    out = (logmel - mean) / (std + NORM_EPS)
    return torch.where(frame_mask, out, 0.0), n_valid_frames


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ParakeetConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights (stacked conformer blocks) drawn from *gen*."""
    dt, d, L, ch, h = cfg.dtype, cfg.d_model, cfg.n_layers, cfg.sub_channels, cfg.head_dim

    def lin(*shape):
        return normal(gen, shape, shape[-2] ** -0.5, dt, device)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape, dtype=dt):
        return torch.ones(shape, dtype=dtype, device=device)

    def norm():
        return {"w": ones(L, d), "b": zeros(L, d)}

    def ff():
        return {"w1": lin(L, d, cfg.d_ff), "b1": zeros(L, cfg.d_ff),
                "w2": lin(L, cfg.d_ff, d), "b2": zeros(L, d)}

    blocks = {
        "ff1_norm": norm(), "ff1": ff(),
        "attn_norm": norm(),
        "attn": {
            "wq": lin(L, d, d), "bq": zeros(L, d), "wk": lin(L, d, d), "bk": zeros(L, d),
            "wv": lin(L, d, d), "bv": zeros(L, d), "wo": lin(L, d, d), "bo": zeros(L, d),
            "wpos": lin(L, d, d),
            "u": normal(gen, (L, cfg.n_heads, h), 0.02, dt, device),
            "v": normal(gen, (L, cfg.n_heads, h), 0.02, dt, device),
        },
        "conv_norm": norm(),
        "conv": {
            "pw1_w": lin(L, d, 2 * d), "pw1_b": zeros(L, 2 * d),
            "dw_w": normal(gen, (L, d, 1, cfg.conv_kernel), cfg.conv_kernel ** -0.5, dt, device),
            "dw_b": zeros(L, d),
            "bn_w": ones(L, d, dtype=torch.float32), "bn_b": zeros(L, d, dtype=torch.float32),
            "bn_mean": zeros(L, d, dtype=torch.float32), "bn_var": ones(L, d, dtype=torch.float32),
            "pw2_w": lin(L, d, d), "pw2_b": zeros(L, d),
        },
        "ff2_norm": norm(), "ff2": ff(),
        "out_norm": norm(),
    }

    def conv2d(cin, cout, k, groups=1):
        fan = cin // groups * k * k
        return {"w": normal(gen, (cout, cin // groups, k, k), fan ** -0.5, dt, device), "b": zeros(cout)}

    sub: Params = {"conv0": conv2d(1, ch, 3)}
    for i in range(1, cfg.sub_layers):
        sub[f"dw{i}"] = conv2d(ch, ch, 3, groups=ch)
        sub[f"pw{i}"] = conv2d(ch, ch, 1)
    sub["out"] = {"w": lin(ch * (cfg.n_mels // cfg.sub_factor), d), "b": zeros(d)}
    ph, nv = cfg.pred_hidden, cfg.vocab_size + 1
    return {
        "sub": sub,
        "blocks": blocks,
        "pred": {
            "embed": normal(gen, (nv, ph), 0.02, dt, device),
            "layers": [{"wi": lin(ph, 4 * ph), "wh": lin(ph, 4 * ph),
                        "bi": zeros(4 * ph), "bh": zeros(4 * ph)} for _ in range(cfg.pred_layers)],
        },
        "joint": {
            "enc_w": lin(d, cfg.joint_hidden), "enc_b": zeros(cfg.joint_hidden),
            "pred_w": lin(ph, cfg.joint_hidden), "pred_b": zeros(cfg.joint_hidden),
            "out_w": lin(cfg.joint_hidden, nv + cfg.n_durations),
            "out_b": zeros(nv + cfg.n_durations),
        },
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _conv2d(x, p, stride: int, groups: int = 1):
    pad = (p["w"].shape[-1] - 1) // 2
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride, pad, groups=groups)


def _sub_len(length):
    return (length - 1) // 2 + 1


def _subsample(params: Params, cfg: ParakeetConfig, mel, n_frames):
    """mel: (B, T, n_mels) -> (B, T//8, d_model); valid length after each
    strided conv masked to zero.  n_frames: (B,) valid mel frames."""
    x = mel[:, None, :, :].to(cfg.dtype)  # NCHW, H=time, W=mel

    def mask_time(x, length):
        m = torch.arange(x.shape[2], device=x.device)[None, None, :, None] < length[:, None, None, None]
        return torch.where(m, x, 0)

    length = n_frames
    x = torch.relu(_conv2d(x, params["conv0"], 2))
    length = _sub_len(length)
    x = mask_time(x, length)
    for i in range(1, cfg.sub_layers):
        x = _conv2d(x, params[f"dw{i}"], 2, groups=cfg.sub_channels)
        length = _sub_len(length)
        x = mask_time(x, length)
        x = torch.relu(_conv2d(x, params[f"pw{i}"], 1))
        x = mask_time(x, length)
    b, c, t, f = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, c * f)
    return linear(x, params["out"]["w"], params["out"]["b"]), length


@lru_cache(maxsize=16)
def _rel_pos_embed(t: int, d_model: int, device: torch.device) -> torch.Tensor:
    """(2t-1, d_model) interleaved sin/cos over positions t-1 .. -(t-1)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, d_model, 2, dtype=np.float64) / d_model))
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)
    freqs = np.outer(pos, inv)
    pe = np.stack([np.sin(freqs), np.cos(freqs)], axis=-1).reshape(2 * t - 1, d_model)
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def _rel_attention(x, p: Params, cfg: ParakeetConfig, pos_emb, valid):
    """Transformer-XL attention. x: (B,T,D); pos_emb: (2T-1,D); valid: (B,T) bool."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    def heads(y):
        return y.reshape(b, t, h, hd).transpose(1, 2)

    q = heads(linear(x, p["wq"], p["bq"]))
    k = heads(linear(x, p["wk"], p["bk"]))
    v = heads(linear(x, p["wv"], p["bv"]))
    rel_k = linear(pos_emb.to(x.dtype), p["wpos"]).reshape(2 * t - 1, h, hd)
    qu = (q + p["u"][None, :, None, :]).float()
    qv = (q + p["v"][None, :, None, :]).float()
    ac = torch.matmul(qu, k.float().transpose(-1, -2))
    bd_raw = torch.einsum("bhqd,phd->bhqp", qv, rel_k.float())
    # rel_shift: out[i, j] = raw[i, (T-1) - i + j]
    idx = (t - 1) - torch.arange(t, device=x.device)[:, None] + torch.arange(t, device=x.device)[None, :]
    bd = torch.gather(bd_raw, -1, idx[None, None].expand(b, h, t, t))
    scores = (ac + bd) * hd ** -0.5
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0).to(v.dtype)
    out = torch.matmul(probs.float(), v.float()).to(x.dtype).transpose(1, 2).reshape(b, t, d)
    return linear(out, p["wo"], p["bo"])


def _conv_module(x, p: Params, cfg: ParakeetConfig, valid):
    """GLU pointwise -> masked depthwise -> BatchNorm(eval) -> SiLU -> pointwise."""
    h = linear(x, p["pw1_w"], p["pw1_b"])
    a, gate = h.chunk(2, dim=-1)
    h = a * torch.sigmoid(gate.float()).to(a.dtype)
    h = torch.where(valid[:, :, None], h, 0)
    pad = (cfg.conv_kernel - 1) // 2
    h = F.conv1d(h.transpose(1, 2), p["dw_w"].to(h.dtype), None, padding=pad, groups=cfg.d_model)
    h = h.transpose(1, 2).float() + p["dw_b"].float()
    bn_scale = p["bn_w"] * torch.rsqrt(p["bn_var"] + 1e-5)
    h = (h - p["bn_mean"]) * bn_scale + p["bn_b"]
    h = F.silu(h).to(x.dtype)
    return linear(h, p["pw2_w"], p["pw2_b"])


def _ff(x, p: Params):
    h = F.silu(linear(x, p["w1"], p["b1"]).float()).to(x.dtype)
    return linear(h, p["w2"], p["b2"])


def _block(x, p: Params, cfg: ParakeetConfig, pos_emb, valid):
    x = x + 0.5 * _ff(layer_norm(x, p["ff1_norm"]["w"], p["ff1_norm"]["b"]), p["ff1"])
    x = x + _rel_attention(layer_norm(x, p["attn_norm"]["w"], p["attn_norm"]["b"]),
                           p["attn"], cfg, pos_emb, valid)
    x = x + _conv_module(layer_norm(x, p["conv_norm"]["w"], p["conv_norm"]["b"]),
                         p["conv"], cfg, valid)
    x = x + 0.5 * _ff(layer_norm(x, p["ff2_norm"]["w"], p["ff2_norm"]["b"]), p["ff2"])
    return layer_norm(x, p["out_norm"]["w"], p["out_norm"]["b"])


def encode(params: Params, cfg: ParakeetConfig, mel, n_frames):
    """mel: (B, T_mel, n_mels) normalized; n_frames: (B,) tensor or int of
    valid mel frames.  Returns (enc (B, T', d_model), enc_len (B,))."""
    n_frames = torch.as_tensor(n_frames, device=mel.device).reshape(-1)
    x, enc_len = _subsample(params["sub"], cfg, mel, n_frames)
    x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cfg.dtype, device=x.device)
    t = x.shape[1]
    pos_emb = _rel_pos_embed(t, cfg.d_model, x.device)
    valid = torch.arange(t, device=x.device)[None, :] < enc_len[:, None]
    blocks = params["blocks"]
    for i in range(n_stacked(blocks)):
        x = _block(x, layer_slice(blocks, i), cfg, pos_emb, valid)
    return torch.where(valid[:, :, None], x, 0), enc_len


# ---------------------------------------------------------------------------
# prediction network / joint / TDT greedy decode
# ---------------------------------------------------------------------------


class PredState(NamedTuple):
    h: torch.Tensor  # (L, B, H)
    c: torch.Tensor  # (L, B, H)


def init_pred_state(cfg: ParakeetConfig, batch: int = 1, device: torch.device | str = "cpu") -> PredState:
    shape = (cfg.pred_layers, batch, cfg.pred_hidden)
    return PredState(torch.zeros(shape, dtype=cfg.dtype, device=device),
                     torch.zeros(shape, dtype=cfg.dtype, device=device))


def pred_step(params: Params, cfg: ParakeetConfig, token, state: PredState):
    """One prediction-network step.  token: (B,) int (blank == SOS).
    Torch LSTM gate order i,f,g,o; gates and activations in f32."""
    x = params["pred"]["embed"][token.long()]
    hs, cs = [], []
    for li, lp in enumerate(params["pred"]["layers"]):
        gates = (x @ lp["wi"] + lp["bi"] + state.h[li] @ lp["wh"] + lp["bh"]).float()
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * state.c[li].float() + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        x = h.to(x.dtype)
        hs.append(x)
        cs.append(c.to(x.dtype))
    return x, PredState(torch.stack(hs), torch.stack(cs))


def joint(params: Params, cfg: ParakeetConfig, enc_t, pred_out):
    """(B, D), (B, H) -> (token logits (B, V+1), duration logits (B, n_dur)), f32."""
    jp = params["joint"]
    h = linear(enc_t, jp["enc_w"], jp["enc_b"]) + linear(pred_out, jp["pred_w"], jp["pred_b"])
    logits = linear(torch.relu(h), jp["out_w"], jp["out_b"]).float()
    return logits[:, : cfg.vocab_size + 1], logits[:, cfg.vocab_size + 1 :]


def tdt_greedy_decode(params: Params, cfg: ParakeetConfig, encoded, enc_len: int) -> list[int]:
    """TDT greedy decode for one utterance: the B=1 case of
    :func:`tdt_greedy_decode_batch`.  encoded: (1, T, D); enc_len: valid
    frames.  Returns the emitted token ids (at most MAX_TOKENS)."""
    return tdt_greedy_decode_batch(params, cfg, encoded, [enc_len])[0]


def transcribe_step(params: Params, cfg: ParakeetConfig, audio: torch.Tensor, n_valid: int) -> list[int]:
    """mel -> encoder -> TDT decode for one utterance.  audio: (N,) f32 on
    the weights' device, zero-padded past *n_valid* samples."""
    return transcribe_step_batch(params, cfg, audio[None], [n_valid])[0]


def tdt_greedy_decode_batch(params: Params, cfg: ParakeetConfig, encoded, enc_len: list[int]) -> list[list[int]]:
    """TDT greedy decode (NeMo ``GreedyTDTInfer`` semantics) for a batch of
    utterances in one loop: it steps every lane while any lane is live, and
    each lane's carry (frame, prediction state, tokens, counters) advances
    only while that lane is live, as the JAX package's vmapped
    ``while_loop`` does.  encoded: (B, T, D); enc_len: valid frames per lane
    (0 for a padding row, which never steps).  One host read per step for
    the whole batch."""
    b, t_max = encoded.shape[0], encoded.shape[1]
    max_steps = t_max * (cfg.max_symbols_per_frame + 1) + MAX_TOKENS
    blank = cfg.blank_id
    device = encoded.device
    pred_out, state = pred_step(params, cfg, torch.full((b,), blank, dtype=torch.long, device=device),
                                init_pred_state(cfg, b, device=device))
    tokens: list[list[int]] = [[] for _ in range(b)]
    t, syms, steps = [0] * b, [0] * b, [0] * b

    def live(i: int) -> bool:
        return t[i] < enc_len[i] and len(tokens[i]) < MAX_TOKENS and steps[i] < max_steps

    while any(live(i) for i in range(b)):
        lanes = [live(i) for i in range(b)]
        enc_t = torch.stack([encoded[i, min(t[i], t_max - 1)] for i in range(b)])
        token_logits, dur_logits = joint(params, cfg, enc_t, pred_out)
        tok_dev = token_logits.argmax(-1)
        tok, dur = torch.stack([tok_dev, dur_logits.argmax(-1)]).tolist()
        emit = [lanes[i] and tok[i] != blank for i in range(b)]
        if all(emit):
            pred_out, state = pred_step(params, cfg, tok_dev, state)
        elif any(emit):
            # emission lanes step the prediction LSTM; every other lane keeps its state
            new_out, new_state = pred_step(params, cfg, tok_dev, state)
            keep = torch.tensor(emit, device=device)
            pred_out = torch.where(keep[:, None], new_out, pred_out)
            state = PredState(torch.where(keep[None, :, None], new_state.h, state.h),
                              torch.where(keep[None, :, None], new_state.c, state.c))
        for i in range(b):
            if not lanes[i]:
                continue
            # frame advance: a blank with duration 0 forces 1; an emission may
            # stay on the frame (duration 0) at most max_symbols_per_frame times
            advance = max(dur[i], 1) if not emit[i] else dur[i]
            if emit[i]:
                tokens[i].append(tok[i])
                syms[i] += 1
                if syms[i] >= cfg.max_symbols_per_frame:
                    advance = max(advance, 1)
            if advance > 0:
                syms[i] = 0
            t[i] += advance
            steps[i] += 1
    return tokens


def transcribe_step_batch(params: Params, cfg: ParakeetConfig, audio: torch.Tensor,
                          n_valid: list[int]) -> list[list[int]]:
    """Cross-session batched transcribe: mel -> encoder -> TDT decode for a
    batch of same-bucket utterances.  audio: (B, N) f32 on the weights'
    device, zero-padded rows; n_valid: valid samples per row.  Returns each
    row's token ids.  The frontend is one call of the batched log-mel
    (:func:`s2s_tpu_torch.ops.log_mel.parakeet_log_mel`, the kernel on the
    card).  Padding rows (``n_valid == 0``) stay invisible: their frames are
    masked in the frontend and encoder, and their decode never steps."""
    n_valid_t = torch.tensor([int(v) for v in n_valid], dtype=torch.int32, device=audio.device)
    mels, frames = log_mel.parakeet_log_mel(audio, n_valid_t, frontend(cfg))  # one launch on the card
    encoded, _ = encode(params, cfg, mels, frames)
    return tdt_greedy_decode_batch(params, cfg, encoded,
                                   [_sub_len_int(int(v) // cfg.hop_length, cfg.sub_layers) for v in n_valid])


def transcribe_tokens(params: Params, cfg: ParakeetConfig, audio, n_valid: int | None = None,
                      device: torch.device | str | None = None) -> list[int]:
    """Host convenience: *audio* (numpy or tensor) -> emitted token ids."""
    device = device or params["sub"]["conv0"]["w"].device
    if not torch.is_tensor(audio):
        audio = torch.from_numpy(np.asarray(audio, np.float32))
    audio = audio.to(device=device, dtype=torch.float32)
    return transcribe_step(params, cfg, audio, audio.shape[0] if n_valid is None else int(n_valid))


def _sub_len_int(length: int, n: int) -> int:
    """Host copy of the valid encoder length (``_sub_len`` applied *n* times)."""
    for _ in range(n):
        length = (length - 1) // 2 + 1
    return length


# ---------------------------------------------------------------------------
# checkpoint conversion (HF transformers ParakeetEncoder naming; NeMo-export
# names are translated first)
# ---------------------------------------------------------------------------

_NEMO_TO_HF = {
    "pre_encode.conv.": "subsampling.layers.",
    "pre_encode.out.": "subsampling.linear.",
    ".self_attn.linear_q.": ".self_attn.q_proj.",
    ".self_attn.linear_k.": ".self_attn.k_proj.",
    ".self_attn.linear_v.": ".self_attn.v_proj.",
    ".self_attn.linear_out.": ".self_attn.o_proj.",
    ".self_attn.linear_pos.": ".self_attn.relative_k_proj.",
    ".self_attn.pos_bias_u": ".self_attn.bias_u",
    ".self_attn.pos_bias_v": ".self_attn.bias_v",
    ".conv.batch_norm.": ".conv.norm.",
}


def _normalize_keys(sd: dict) -> dict:
    """The JAX package's key renaming; the entries stay as given (each is
    read on the host when the converter takes it)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("model."):
            k = k[len("model."):]
        # both NeMo and HF ParakeetForCTC nest the encoder under "encoder.";
        # decoder./joint. (NeMo) stay as-is
        if k.startswith("encoder."):
            k = k[len("encoder."):]
        for old, new in _NEMO_TO_HF.items():
            k = k.replace(old, new)
        out[k] = v
    return out


def convert_state_dict(sd: dict, cfg: ParakeetConfig, device: torch.device | str = "cpu") -> Params:
    """HF ``ParakeetEncoder``-naming (or NeMo-export naming) state dict
    (numpy arrays or tensors) -> the JAX package's tree on *device*, cast to
    ``cfg.dtype`` there (batch norm in f32).

    Encoder keys follow transformers ``modeling_parakeet.py``; prediction
    network and joint follow NeMo (``decoder.prediction.*``, ``joint.*``)
    since HF ships only the CTC variant.
    """
    sd = _normalize_keys(sd)
    dt = cfg.dtype

    def t(name):  # torch Linear weight (out, in) -> (in, out)
        return device_tensor(host_array(sd[name]).T, dt, device)

    def a(name, dtype=None):
        return device_tensor(host_array(sd[name]), dtype or dt, device)

    def pointwise(name):  # Conv1d (out, in, 1) -> (in, out)
        return device_tensor(host_array(sd[name])[:, :, 0].T, dt, device)

    sub: Params = {"conv0": {"w": a("subsampling.layers.0.weight"),
                             "b": a("subsampling.layers.0.bias")}}
    for i in range(1, cfg.sub_layers):
        base = 3 * i - 1  # ModuleList indices: 2,3 then 5,6 (ReLU at 1,4,7)
        sub[f"dw{i}"] = {"w": a(f"subsampling.layers.{base}.weight"),
                         "b": a(f"subsampling.layers.{base}.bias")}
        sub[f"pw{i}"] = {"w": a(f"subsampling.layers.{base + 1}.weight"),
                         "b": a(f"subsampling.layers.{base + 1}.bias")}
    sub["out"] = {"w": t("subsampling.linear.weight"), "b": a("subsampling.linear.bias")}

    blocks = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        blocks.append({
            "ff1_norm": {"w": a(p + "norm_feed_forward1.weight"), "b": a(p + "norm_feed_forward1.bias")},
            "ff1": {"w1": t(p + "feed_forward1.linear1.weight"), "b1": a(p + "feed_forward1.linear1.bias"),
                    "w2": t(p + "feed_forward1.linear2.weight"), "b2": a(p + "feed_forward1.linear2.bias")},
            "attn_norm": {"w": a(p + "norm_self_att.weight"), "b": a(p + "norm_self_att.bias")},
            "attn": {
                "wq": t(p + "self_attn.q_proj.weight"), "bq": a(p + "self_attn.q_proj.bias"),
                "wk": t(p + "self_attn.k_proj.weight"), "bk": a(p + "self_attn.k_proj.bias"),
                "wv": t(p + "self_attn.v_proj.weight"), "bv": a(p + "self_attn.v_proj.bias"),
                "wo": t(p + "self_attn.o_proj.weight"), "bo": a(p + "self_attn.o_proj.bias"),
                "wpos": t(p + "self_attn.relative_k_proj.weight"),
                "u": a(p + "self_attn.bias_u"), "v": a(p + "self_attn.bias_v"),
            },
            "conv_norm": {"w": a(p + "norm_conv.weight"), "b": a(p + "norm_conv.bias")},
            "conv": {
                "pw1_w": pointwise(p + "conv.pointwise_conv1.weight"),
                "pw1_b": a(p + "conv.pointwise_conv1.bias"),
                # torch depthwise Conv1d (C, 1, k) -> NTC/TIO (k, 1, C)
                "dw_w": device_tensor(host_array(sd[p + "conv.depthwise_conv.weight"]).transpose(2, 1, 0), dt,
                                      device),
                "dw_b": a(p + "conv.depthwise_conv.bias"),
                "bn_w": a(p + "conv.norm.weight", torch.float32),
                "bn_b": a(p + "conv.norm.bias", torch.float32),
                "bn_mean": a(p + "conv.norm.running_mean", torch.float32),
                "bn_var": a(p + "conv.norm.running_var", torch.float32),
                "pw2_w": pointwise(p + "conv.pointwise_conv2.weight"),
                "pw2_b": a(p + "conv.pointwise_conv2.bias"),
            },
            "ff2_norm": {"w": a(p + "norm_feed_forward2.weight"), "b": a(p + "norm_feed_forward2.bias")},
            "ff2": {"w1": t(p + "feed_forward2.linear1.weight"), "b1": a(p + "feed_forward2.linear1.bias"),
                    "w2": t(p + "feed_forward2.linear2.weight"), "b2": a(p + "feed_forward2.linear2.bias")},
            "out_norm": {"w": a(p + "norm_out.weight"), "b": a(p + "norm_out.bias")},
        })

    params: Params = {"sub": sub, "blocks": stack_layers(blocks)}

    if "decoder.prediction.embed.weight" in sd:
        n_lstm = sum(1 for k in sd if k.startswith("decoder.prediction.dec_rnn.lstm.weight_ih_l"))
        if n_lstm != cfg.pred_layers:
            raise ValueError(
                f"checkpoint has {n_lstm} prediction LSTM layers; config says "
                f"{cfg.pred_layers} — set ParakeetConfig(pred_layers={n_lstm})"
            )
        base = "decoder.prediction.dec_rnn.lstm."
        layers = [{"wi": t(base + f"weight_ih_l{i}"), "wh": t(base + f"weight_hh_l{i}"),
                   "bi": a(base + f"bias_ih_l{i}"), "bh": a(base + f"bias_hh_l{i}")} for i in range(n_lstm)]
        params["pred"] = {"embed": a("decoder.prediction.embed.weight"), "layers": layers}
        params["joint"] = {
            "enc_w": t("joint.enc.weight"), "enc_b": a("joint.enc.bias"),
            "pred_w": t("joint.pred.weight"), "pred_b": a("joint.pred.bias"),
            "out_w": t("joint.joint_net.2.weight"), "out_b": a("joint.joint_net.2.bias"),
        }
    return params
