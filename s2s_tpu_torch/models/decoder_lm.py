"""Decoder-only language model (port of ``s2s_tpu/models/decoder_lm.py``).

Llama/SmolLM2/Qwen3 layout: RMSNorm, interleaved-pair RoPE, GQA attention,
SwiGLU MLP, optional tied embeddings and Qwen3 q/k norms.  Serves the local
LLM (SmolLM2-1.7B) and, through :func:`_hidden_prefill` / :func:`_hidden_step`,
the Qwen3-TTS talker and code predictor.

Layer weights stay STACKED with a leading layer axis, as in the JAX package
(and in its converted ``.npz`` checkpoints); the layer loop indexes them per
layer where JAX runs a ``lax.scan``.  The KV cache is written in place.
The decode position is a host integer: the serving loops here are eager, so
it costs no device sync.  Training, sharding and HF conversion are not
ported yet (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from s2s_tpu_torch.models.common import (
    KVCache,
    Params,
    apply_rope,
    attention,
    causal_mask,
    layer_slice,
    length_mask,
    linear,
    n_stacked,
    rms_norm,
    rope_frequencies,
    swiglu,
)
from s2s_tpu_torch.ops.quant import QUANT_TYPES


@dataclass(frozen=True)
class DecoderLMConfig:
    vocab_size: int = 49152  # SmolLM2 default
    d_model: int = 2048
    n_layers: int = 24
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 8192
    max_seq_len: int = 4096
    rope_theta: float = 130000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = True
    qk_norm: bool = False  # Qwen3-style per-head RMS norm on q/k (pre-rope)
    head_dim_override: int | None = None  # Qwen3 decouples head_dim from d_model
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @staticmethod
    def smollm2_1_7b() -> "DecoderLMConfig":
        return DecoderLMConfig()

    @staticmethod
    def qwen3_1_7b(vocab_size: int = 151936) -> "DecoderLMConfig":
        """Qwen3-1.7B dense layout (the Qwen3-TTS talker body)."""
        return DecoderLMConfig(
            vocab_size=vocab_size, d_model=2048, n_layers=28, n_heads=16, n_kv_heads=8,
            d_ff=6144, max_seq_len=32768, rope_theta=1_000_000.0, rms_eps=1e-6,
            tie_embeddings=True, qk_norm=True, head_dim_override=128,
        )

    @staticmethod
    def smollm2_360m() -> "DecoderLMConfig":
        return DecoderLMConfig(d_model=960, n_layers=32, n_heads=15, n_kv_heads=5, d_ff=2560)

    @staticmethod
    def tiny(vocab: int = 256) -> "DecoderLMConfig":
        """Test-size config (CPU-friendly)."""
        return DecoderLMConfig(
            vocab_size=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=128, dtype=torch.float32,
        )


def normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from *gen*, cast to *dtype*."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale).to(dtype)


def init_params(cfg: DecoderLMConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights (stacked layers) drawn from *gen* on *device*.
    The same distributions as the JAX package; not the same numbers."""
    dt, L, d = cfg.dtype, cfg.n_layers, cfg.d_model
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def lin(di, do):
        return normal(gen, (L, di, do), di ** -0.5, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": ones(L, d),
        "wq": lin(d, hq), "wk": lin(d, hkv), "wv": lin(d, hkv), "wo": lin(hq, d),
        "mlp_norm": ones(L, d),
        "w_gate": lin(d, cfg.d_ff), "w_up": lin(d, cfg.d_ff), "w_down": lin(cfg.d_ff, d),
    }
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, cfg.head_dim)
        layers["k_norm"] = ones(L, cfg.head_dim)
    params: Params = {
        "embed": normal(gen, (cfg.vocab_size, d), 0.02, dt, device),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (d, cfg.vocab_size), d ** -0.5, dt, device)
    return params


class DecodeState(NamedTuple):
    """Decode carry: stacked per-layer caches (L, B, n_kv, max_t, head_dim),
    written in place, and the next write position (host int)."""

    caches: KVCache
    pos: int


def init_decode_state(cfg: DecoderLMConfig, batch: int, max_t: int | None = None,
                      device: torch.device | str = "cpu") -> DecodeState:
    max_t = max_t or cfg.max_seq_len
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_t, cfg.head_dim)
    caches = KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                     torch.zeros(shape, dtype=cfg.dtype, device=device))
    return DecodeState(caches, 0)


def _block(x, lp: Params, cfg: DecoderLMConfig, cache: KVCache | None, pos, cos, sin, mask):
    """One transformer block over UNSTACKED layer params; returns (x, cache)."""
    b, t, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = linear(h, lp["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = linear(h, lp["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = linear(h, lp["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        cache = cache.update(k, v, pos)
        k_all, v_all = cache.k, cache.v
    else:
        k_all, v_all = k, v
    attn = attention(q, k_all, v_all, mask)
    attn = attn.transpose(1, 2).reshape(b, t, cfg.n_heads * cfg.head_dim)
    x = x + linear(attn, lp["wo"])
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), cache


def _run_blocks(x, params: Params, cfg: DecoderLMConfig, caches: KVCache | None, pos, cos, sin, mask):
    """The layer loop (the JAX package's ``_scan_blocks``)."""
    layers = params["layers"]
    for i in range(n_stacked(layers)):
        cache = KVCache(caches.k[i], caches.v[i]) if caches is not None else None
        x, _ = _block(x, layer_slice(layers, i), cfg, cache, pos, cos, sin, mask)
    return x, caches


def _logits(x, params: Params, cfg: DecoderLMConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, QUANT_TYPES):
        return linear(x, head).float()
    return torch.matmul(x, head.to(x.dtype)).float()


def _rope(cfg: DecoderLMConfig, device):
    return rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device)


def _hidden_prefill(params: Params, cfg: DecoderLMConfig, x, state: DecodeState, prompt_len):
    """x: (B, T, D) right-padded prompt embeddings; prompt_len: int or (B,)
    tensor of valid lengths.  Returns (last valid hidden (B, D), state)."""
    b, t, _ = x.shape
    cos_full, sin_full = _rope(cfg, x.device)
    max_t = state.caches.k.shape[3]
    mask = causal_mask(t, max_t, 0, x.device) & length_mask(max_t, t, x.device)
    x, caches = _run_blocks(x, params, cfg, state.caches, 0, cos_full[:t], sin_full[:t], mask)
    if isinstance(prompt_len, int):
        return x[:, prompt_len - 1], DecodeState(caches, prompt_len)
    # per-row lengths on the device: one host read for the next position
    lengths = prompt_len.reshape(-1).expand(b).long()
    last = x[torch.arange(b, device=x.device), lengths - 1]
    return last, DecodeState(caches, int(lengths.max()))


def prefill(params: Params, cfg: DecoderLMConfig, tokens, state: DecodeState, prompt_len):
    """Consume a (B, T_bucket) right-padded prompt; fill caches; return
    (last-position logits (B, V) f32, new state)."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    last, state = _hidden_prefill(params, cfg, x, state, prompt_len)
    return _logits(last[:, None, :], params, cfg)[:, 0], state


def _hidden_step(params: Params, cfg: DecoderLMConfig, x, state: DecodeState):
    """x: (B, 1, D) one step of embeddings at ``state.pos``."""
    cos_full, sin_full = _rope(cfg, x.device)
    pos = state.pos
    max_t = state.caches.k.shape[3]
    mask = length_mask(max_t, pos + 1, x.device)
    x, caches = _run_blocks(x, params, cfg, state.caches, pos,
                            cos_full[pos : pos + 1], sin_full[pos : pos + 1], mask)
    return x, DecodeState(caches, pos + 1)


def decode_step(params: Params, cfg: DecoderLMConfig, token, state: DecodeState):
    """One token step. token: (B,) int. Returns (logits (B, V) f32, new state)."""
    x = params["embed"][token.long()][:, None, :].to(cfg.dtype)
    x, state = _hidden_step(params, cfg, x, state)
    return _logits(x, params, cfg)[:, 0], state


def decode_chunk(params: Params, cfg: DecoderLMConfig, token, state: DecodeState, n_tokens: int, eos_id: int):
    """Greedily decode *n_tokens* steps without a host sync: emits the input
    token first, then successors; the caller truncates at EOS.

    Returns (tokens (n_tokens, B), eos_flags (n_tokens,), next token, state),
    all on the device."""
    toks, flags = [], []
    tok = token
    for _ in range(n_tokens):
        logits, state = decode_step(params, cfg, tok, state)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
        flags.append(nxt[0] == eos_id)
        tok = nxt
    return torch.stack(toks), torch.stack(flags), tok, state
