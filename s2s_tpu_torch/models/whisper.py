"""Whisper encoder-decoder (port of ``s2s_tpu/models/whisper.py``).

One implementation serves every Whisper-flavored STT backend (``whisper``,
``faster-whisper``, ``whisper-mlx``, ``mlx-audio-whisper``) and the Smart
Turn end-of-turn classifier (the encoder plus a head,
:mod:`s2s_tpu_torch.vad.smart_turn`).  The JAX package's layouts and
numerics, with two layout notes:

- layer weights stay STACKED with a leading layer axis (as in the JAX
  package and its converted ``.npz`` checkpoints); the layer loops index
  them where JAX runs a ``lax.scan``;
- the convolutions take PyTorch's Conv1d layout ``(d, C_in, 3)``
  (:func:`s2s_tpu_torch.weights.whisper_to_torch` converts a JAX tree).

The encoder's self-attention is unmasked, so it goes to the flash-attention
kernel through :func:`s2s_tpu_torch.models.common.attention` at every
duration bucket.  The decoder's self-attention KV caches are written in
place; its position is a host integer.  Greedy decoding is a host loop
(one host read per token) where JAX runs a ``lax.while_loop``; the tokens
are the same.  Sharding specs and the HF converter are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch.models.common import KVCache, Params, attention, causal_mask, layer_norm, layer_slice, linear
from s2s_tpu_torch.models.decoder_lm import normal

# Whisper special tokens (multilingual vocab, v2/v3 layout).
SOT = 50258
EOT = 50257
TRANSCRIBE = 50360
TRANSLATE = 50359
NO_TIMESTAMPS = 50364
LANG_BASE = 50259  # <|en|>; language tokens are LANG_BASE + lang_index


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500
    d_model: int = 384
    n_heads: int = 6
    n_enc_layers: int = 4
    n_dec_layers: int = 4
    vocab_size: int = 51865
    n_text_ctx: int = 448
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "WhisperConfig":
        return WhisperConfig()

    @staticmethod
    def base() -> "WhisperConfig":
        return WhisperConfig(d_model=512, n_heads=8, n_enc_layers=6, n_dec_layers=6)

    @staticmethod
    def small() -> "WhisperConfig":
        return WhisperConfig(d_model=768, n_heads=12, n_enc_layers=12, n_dec_layers=12)

    @staticmethod
    def large_v3() -> "WhisperConfig":
        return WhisperConfig(
            n_mels=128, d_model=1280, n_heads=20, n_enc_layers=32, n_dec_layers=32, vocab_size=51866
        )

    @staticmethod
    def distil_large_v3() -> "WhisperConfig":
        return WhisperConfig(
            n_mels=128, d_model=1280, n_heads=20, n_enc_layers=32, n_dec_layers=2, vocab_size=51866
        )

    @staticmethod
    def test_tiny() -> "WhisperConfig":
        return WhisperConfig(
            n_mels=80, n_audio_ctx=64, d_model=64, n_heads=4, n_enc_layers=2, n_dec_layers=2,
            vocab_size=1024, n_text_ctx=32, dtype=torch.float32,
        )


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _init_blocks(cfg: WhisperConfig, n: int, cross: bool, gen: torch.Generator, device) -> Params:
    """*n* stacked blocks; the JAX package's distributions, not its numbers."""
    d, dt = cfg.d_model, cfg.dtype

    def w(di, do):
        return normal(gen, (n, di, do), di ** -0.5, dt, device)

    def zeros(*shape):
        return torch.zeros((n, *shape), dtype=dt, device=device)

    def ones(*shape):
        return torch.ones((n, *shape), dtype=dt, device=device)

    def attn():
        return {"wq": w(d, d), "bq": zeros(d), "wk": w(d, d), "wv": w(d, d), "bv": zeros(d),
                "wo": w(d, d), "bo": zeros(d)}

    p: Params = {
        "ln1_w": ones(d), "ln1_b": zeros(d), "attn": attn(),
        "ln2_w": ones(d), "ln2_b": zeros(d),
        "mlp_w1": w(d, 4 * d), "mlp_b1": zeros(4 * d), "mlp_w2": w(4 * d, d), "mlp_b2": zeros(d),
    }
    if cross:
        p["lnx_w"] = ones(d)
        p["lnx_b"] = zeros(d)
        p["xattn"] = attn()
    return p


def init_params(cfg: WhisperConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device* (convolutions in the
    Conv1d layout ``(d, C_in, 3)``)."""
    d, dt = cfg.d_model, cfg.dtype
    return {
        "conv1_w": normal(gen, (d, cfg.n_mels, 3), (3 * cfg.n_mels) ** -0.5, dt, device),
        "conv1_b": torch.zeros(d, dtype=dt, device=device),
        "conv2_w": normal(gen, (d, d, 3), (3 * d) ** -0.5, dt, device),
        "conv2_b": torch.zeros(d, dtype=dt, device=device),
        "enc_pos": torch.from_numpy(_sinusoids(cfg.n_audio_ctx, d)).to(device=device, dtype=dt),
        "enc_blocks": _init_blocks(cfg, cfg.n_enc_layers, False, gen, device),
        "enc_ln_w": torch.ones(d, dtype=dt, device=device), "enc_ln_b": torch.zeros(d, dtype=dt, device=device),
        "tok_emb": normal(gen, (cfg.vocab_size, d), 0.02, dt, device),
        "dec_pos": normal(gen, (cfg.n_text_ctx, d), 0.01, dt, device),
        "dec_blocks": _init_blocks(cfg, cfg.n_dec_layers, True, gen, device),
        "dec_ln_w": torch.ones(d, dtype=dt, device=device), "dec_ln_b": torch.zeros(d, dtype=dt, device=device),
    }


def _heads(x: torch.Tensor, cfg: WhisperConfig) -> torch.Tensor:
    """(B, T, d) -> (B, H, T, head_dim), a view."""
    b, t, _ = x.shape
    return x.reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)


def _mha(p: Params, x_q: torch.Tensor, x_kv: torch.Tensor | None, cfg: WhisperConfig, mask=None,
         cache: KVCache | None = None, pos: int = 0):
    """Whisper attention (no rope, k has no bias).  Returns (out, cache); a
    given self-attention cache is written in place at *pos*."""
    b, tq, d = x_q.shape
    q = _heads(linear(x_q, p["wq"]) + p["bq"], cfg)
    if x_kv is not None:
        k = _heads(linear(x_kv, p["wk"]), cfg)
        v = _heads(linear(x_kv, p["wv"]) + p["bv"], cfg)
        if cache is not None:
            cache = cache.update(k, v, pos)
            k, v = cache.k, cache.v
    else:  # cached cross-attention: reuse cache contents
        if cache is None:
            raise ValueError("cross-attention without x_kv needs a cache")
        k, v = cache.k, cache.v
    out = attention(q, k, v, mask)
    out = out.transpose(1, 2).reshape(b, tq, d)
    return linear(out, p["wo"]) + p["bo"], cache


def _mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(F.gelu(linear(x, p["mlp_w1"]) + p["mlp_b1"]), p["mlp_w2"]) + p["mlp_b2"]


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B, C_in, T), w (C_out, C_in, 3): 'same' padding as torch conv1d(p=1);
    the bias added in x's dtype after the product, as in the JAX package."""
    return F.conv1d(x, w.to(x.dtype), stride=stride, padding=1) + b


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: (B, n_mels, T_mel) -> (B, T_mel // 2, d_model)."""
    x = mel.to(cfg.dtype)
    x = F.gelu(_conv1d(x, params["conv1_w"], params["conv1_b"][:, None], 1))
    x = F.gelu(_conv1d(x, params["conv2_w"], params["conv2_b"][:, None], 2))
    x = x.transpose(1, 2)  # (B, T, d)
    t = x.shape[1]
    x = x + params["enc_pos"][:t]
    for i in range(cfg.n_enc_layers):
        blk = layer_slice(params["enc_blocks"], i)
        h_in = layer_norm(x, blk["ln1_w"], blk["ln1_b"])
        h, _ = _mha(blk["attn"], h_in, h_in, cfg)
        x = x + h
        x = x + _mlp(blk, layer_norm(x, blk["ln2_w"], blk["ln2_b"]))
    return layer_norm(x, params["enc_ln_w"], params["enc_ln_b"])


class WhisperDecodeState(NamedTuple):
    """Stacked caches (L, B, H, T, head_dim), the self-attention ones written
    in place; the next write position (host int)."""

    self_caches: KVCache
    cross_caches: KVCache
    pos: int


def init_decode_state(params: Params, cfg: WhisperConfig, encoded: torch.Tensor) -> WhisperDecodeState:
    """Cross-attention K/V of every decoder layer from the encoder output;
    empty self caches."""
    b = encoded.shape[0]
    shape = (cfg.n_dec_layers, b, cfg.n_heads, cfg.n_text_ctx, cfg.head_dim)
    zeros = torch.zeros(shape, dtype=cfg.dtype, device=encoded.device)
    self_caches = KVCache(zeros, torch.zeros_like(zeros))
    ck, cv = [], []
    for i in range(cfg.n_dec_layers):
        xp = layer_slice(params["dec_blocks"]["xattn"], i)
        ck.append(_heads(linear(encoded, xp["wk"]), cfg).to(cfg.dtype))
        cv.append(_heads(linear(encoded, xp["wv"]) + xp["bv"], cfg).to(cfg.dtype))
    return WhisperDecodeState(self_caches, KVCache(torch.stack(ck), torch.stack(cv)), 0)


def decode_tokens(params: Params, cfg: WhisperConfig, tokens: torch.Tensor, state: WhisperDecodeState):
    """Teacher-forced step over *tokens* (B, T) appended at ``state.pos``.
    Returns (logits (B, T, V) float32, new state); the self caches are
    written in place."""
    t = tokens.shape[1]
    pos = state.pos
    x = params["tok_emb"][tokens.long()].to(cfg.dtype) + params["dec_pos"][pos : pos + t]
    mask = causal_mask(t, cfg.n_text_ctx, pos, device=x.device)
    for i in range(cfg.n_dec_layers):
        blk = layer_slice(params["dec_blocks"], i)
        self_cache = KVCache(state.self_caches.k[i], state.self_caches.v[i])
        h_in = layer_norm(x, blk["ln1_w"], blk["ln1_b"])
        h, _ = _mha(blk["attn"], h_in, h_in, cfg, mask=mask, cache=self_cache, pos=pos)
        x = x + h
        cross = KVCache(state.cross_caches.k[i], state.cross_caches.v[i])
        h, _ = _mha(blk["xattn"], layer_norm(x, blk["lnx_w"], blk["lnx_b"]), None, cfg, cache=cross)
        x = x + h
        x = x + _mlp(blk, layer_norm(x, blk["ln2_w"], blk["ln2_b"]))
    x = layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    logits = torch.matmul(x.float(), params["tok_emb"].float().T)
    return logits, state._replace(pos=pos + t)


def decode_step(params: Params, cfg: WhisperConfig, token: torch.Tensor, state: WhisperDecodeState):
    """One-token decode step (B,) -> ((B, V), state)."""
    logits, state = decode_tokens(params, cfg, token[:, None], state)
    return logits[:, 0], state


def greedy_decode_device(params: Params, cfg: WhisperConfig, encoded: torch.Tensor, prompt: torch.Tensor,
                         max_new: int, eot: int = EOT):
    """Greedy transcription of one utterance with the JAX function's
    contract: prompt (1, P) int32; returns (tokens (max_new,) int32 padded
    with *eot*, n_tokens).  JAX runs it as one ``lax.while_loop``; here it is
    :func:`greedy_decode`'s host loop, which gives the same tokens."""
    out = greedy_decode(params, cfg, encoded, prompt[0].tolist(), max_new, eot)
    buf = torch.full((max_new,), eot, dtype=torch.int32)
    buf[: len(out)] = torch.tensor(out, dtype=torch.int32)
    return buf, len(out)


def greedy_decode(params: Params, cfg: WhisperConfig, encoded: torch.Tensor, prompt_tokens: list[int],
                  max_new: int = 128, eot: int = EOT, cancel_check=None) -> list[int]:
    """Greedy transcription; *prompt_tokens* is the SOT sequence.  Host loop
    (one host read per token, to stop at EOT), cancellable via
    *cancel_check()* between tokens.  Returns the generated ids (without
    prompt or EOT)."""
    if encoded.shape[0] != 1:
        raise ValueError("greedy_decode is per utterance (batch 1)")
    state = init_decode_state(params, cfg, encoded)
    prompt = torch.tensor([prompt_tokens], dtype=torch.int32, device=encoded.device)
    logits, state = decode_tokens(params, cfg, prompt, state)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out: list[int] = []
    for _ in range(max_new):
        tid = int(token[0])
        if tid == eot:
            break
        out.append(tid)
        if cancel_check is not None and cancel_check():
            break
        logits, state = decode_step(params, cfg, token, state)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
    return out


def detect_language_logits(params: Params, cfg: WhisperConfig, encoded: torch.Tensor) -> torch.Tensor:
    """Logits over the first decoded token after SOT (language tokens)."""
    state = init_decode_state(params, cfg, encoded)
    sot = torch.tensor([[SOT]], dtype=torch.int32, device=encoded.device)
    logits, _ = decode_tokens(params, cfg, sot, state)
    return logits[:, -1]
