"""Qwen3-TTS streaming TTS (port of ``s2s_tpu/models/qwen3_tts.py``): dense
Qwen3 codec-token talker LM + MTP code predictor + Code2Wav vocoder, and the
host-side streaming synthesizer :class:`Qwen3TTS`.

Public functions keep the JAX package's NTC activations.  Convolution
weights are held in PyTorch's layouts (Conv1d ``(out, in/g, k)``,
ConvTranspose1d ``(in, out, k)``); :mod:`s2s_tpu_torch.weights` converts a
JAX tree.  Per audio chunk the talker steps, code-predictor expansions and
the vocoder run without a host sync; the chunk's audio and EOS flags are
read back once, as in the JAX package's fused chunk program.

The cross-session batched talker programs that the serving scheduler
dispatches are the tail programs (``*_tail`` below), which update the batched
state in place (:mod:`s2s_tpu_torch.parallel.batched_decode`).  The
checkpoint converters (:func:`convert_state_dict`, :func:`convert_c2w_state_dict`)
give the JAX package's trees; :func:`speaker_from_reference` clones a voice
from reference audio.  Not ported yet (ROADMAP): the legacy batched
programs, the one-shot ``synthesize`` program.

Under tensor parallelism (``--model_parallel``) the talker programs take a
``tp`` group and ``params["talker"]`` is one rank's shard; its codec
embedding stays whole (read outside the blocks, and 4,206 rows divide by
neither 4 nor 8), and the code predictor, heads and Code2Wav stay
replicated, so every rank computes the same codes, embeddings and audio.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch.models import decoder_lm
from s2s_tpu_torch.models.common import (
    Params,
    apply_rope,
    attention,
    device_tensor,
    f32_weight,
    host_array,
    layer_slice,
    linear,
    n_stacked,
    rms_norm,
    rope_frequencies,
    stack_layers,
)
from s2s_tpu_torch.models.decoder_lm import DecoderLMConfig, DecodeState, normal
from s2s_tpu_torch.ops.quant import TTS_MODES, check_mode, quantize_tree
from s2s_tpu_torch.parallel import batched_decode as bd

logger = logging.getLogger(__name__)

SAMPLE_RATE = 24_000
FRAMES_PER_SECOND = 12.5
DEFAULT_CHUNK_FRAMES = 8
VOCODER_CONTEXT_FRAMES = 25


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Code2WavConfig:
    codebook_size: int = 2048
    num_quantizers: int = 16
    hidden: int = 1024
    n_layers: int = 8
    n_heads: int = 16
    d_ff: int = 3072
    rope_theta: float = 10000.0
    sliding_window: int = 72
    rms_eps: float = 1e-5
    upsampling_ratios: tuple = (2, 2)
    upsample_rates: tuple = (8, 5, 4, 3)
    decoder_dim: int = 1536
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates) * math.prod(self.upsampling_ratios)


@dataclass(frozen=True)
class Qwen3TTSConfig:
    text_vocab: int = 1024
    codec_vocab: int = 4206
    codec_bos_id: int = 4197
    codec_eos_id: int = 4198
    n_speakers: int = 16
    lm: DecoderLMConfig = field(default_factory=lambda: DecoderLMConfig(
        vocab_size=1, d_model=2048, n_layers=28, n_heads=16, n_kv_heads=8, d_ff=6144,
        max_seq_len=4096, rope_theta=1_000_000.0, rms_eps=1e-6, tie_embeddings=False,
        qk_norm=True, head_dim_override=128, dtype=torch.bfloat16,
    ))
    cp: DecoderLMConfig = field(default_factory=lambda: DecoderLMConfig(
        vocab_size=1, d_model=2048, n_layers=5, n_heads=16, n_kv_heads=8, d_ff=6144,
        max_seq_len=32, rope_theta=10000.0, rms_eps=1e-6, tie_embeddings=False,
        qk_norm=True, head_dim_override=128, dtype=torch.bfloat16,
    ))
    c2w: Code2WavConfig = field(default_factory=Code2WavConfig)
    dtype: Any = torch.bfloat16

    @property
    def n_q(self) -> int:
        return self.c2w.num_quantizers

    @property
    def codebook_size(self) -> int:
        return self.c2w.codebook_size

    @property
    def upsample(self) -> int:
        return self.c2w.total_upsample

    @staticmethod
    def qwen3_tts_12hz_1_7b() -> "Qwen3TTSConfig":
        return Qwen3TTSConfig()

    @staticmethod
    def tiny() -> "Qwen3TTSConfig":
        return Qwen3TTSConfig(
            text_vocab=256, codec_vocab=72, codec_bos_id=65, codec_eos_id=66,
            lm=DecoderLMConfig(
                vocab_size=1, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=256, tie_embeddings=False, qk_norm=True, head_dim_override=16,
                dtype=torch.float32,
            ),
            cp=DecoderLMConfig(
                vocab_size=1, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=16, tie_embeddings=False, qk_norm=True, head_dim_override=16,
                dtype=torch.float32,
            ),
            c2w=Code2WavConfig(
                codebook_size=64, num_quantizers=4, hidden=32, n_layers=1, n_heads=2,
                d_ff=64, sliding_window=8, upsampling_ratios=(2, 2), upsample_rates=(4, 3),
                decoder_dim=32, dtype=torch.float32,
            ),
            dtype=torch.float32,
        )


#: ``--tts_model_size`` -> its configuration (the handler's ``config_for``)
CONFIGS = {"1.7b": Qwen3TTSConfig.qwen3_tts_12hz_1_7b, "tiny": Qwen3TTSConfig.tiny}


# ---------------------------------------------------------------------------
# init (the JAX package's distributions; torch layouts for conv weights)
# ---------------------------------------------------------------------------


def init_c2w_params(cfg: Code2WavConfig, gen: torch.Generator, device) -> Params:
    dt, d, L = cfg.dtype, cfg.hidden, cfg.n_layers

    def rnd(shape, scale):
        return normal(gen, shape, scale, dt, device)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=device)

    def conv(cin, cout, k):  # Conv1d (out, in, k)
        return {"w": rnd((cout, cin, k), (cin * k) ** -0.5), "b": zeros(cout)}

    def tconv(cin, cout, k):  # ConvTranspose1d (in, out, k)
        return {"w": rnd((cin, cout, k), (cin * k) ** -0.5), "b": zeros(cout)}

    def snake(dim):
        return {"alpha": torch.zeros(dim, device=device), "beta": torch.zeros(dim, device=device)}

    upsample = [{
        "tconv": tconv(d, d, r),
        "convnext": {
            "dw_w": rnd((d, 1, 7), 0.1), "dw_b": zeros(d),
            "ln_w": torch.ones(d, dtype=dt, device=device), "ln_b": zeros(d),
            "pw1_w": rnd((d, 4 * d), d ** -0.5), "pw1_b": zeros(4 * d),
            "pw2_w": rnd((4 * d, d), (4 * d) ** -0.5), "pw2_b": zeros(d),
            "gamma": torch.full((d,), 1e-6, dtype=dt, device=device),
        },
    } for r in cfg.upsampling_ratios]
    dec_blocks, dim = [], cfg.decoder_dim
    for rate in cfg.upsample_rates:
        out = dim // 2
        dec_blocks.append({
            "act": snake(dim),
            "tconv": tconv(dim, out, 2 * rate),
            "units": [{"act1": snake(out), "conv1": conv(out, out, 7),
                       "act2": snake(out), "conv2": conv(out, out, 1)} for _ in range(3)],
        })
        dim = out

    def lin(di, do):
        return rnd((L, di, do), di ** -0.5)

    layers = {
        "attn_norm": torch.ones((L, d), dtype=dt, device=device),
        "wq": lin(d, d), "wk": lin(d, d), "wv": lin(d, d), "wo": lin(d, d),
        "attn_scale": torch.full((L, d), 0.01, dtype=dt, device=device),
        "mlp_norm": torch.ones((L, d), dtype=dt, device=device),
        "w_gate": lin(d, cfg.d_ff), "w_up": lin(d, cfg.d_ff), "w_down": lin(cfg.d_ff, d),
        "mlp_scale": torch.full((L, d), 0.01, dtype=dt, device=device),
    }
    return {
        "embed": rnd((cfg.codebook_size * cfg.num_quantizers, d), 0.02),
        "layers": layers,
        "final_norm": torch.ones(d, dtype=dt, device=device),
        "upsample": upsample,
        "dec_in": conv(d, cfg.decoder_dim, 7),
        "dec_blocks": dec_blocks,
        "dec_act": snake(dim),
        "dec_out": conv(dim, 1, 7),
    }


def init_params(cfg: Qwen3TTSConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*."""
    d, dt, n_res = cfg.lm.d_model, cfg.dtype, cfg.n_q - 1
    lm = decoder_lm.init_params(cfg.lm, gen, device)
    lm.pop("lm_head", None)
    lm["embed"] = normal(gen, (cfg.codec_vocab, d), 0.02, dt, device)
    cp = decoder_lm.init_params(cfg.cp, gen, device)
    cp.pop("lm_head", None)
    cp.pop("embed", None)
    return {
        "talker": lm,
        "codec_head": normal(gen, (d, cfg.codec_vocab), d ** -0.5, dt, device),
        "text_embed": normal(gen, (cfg.text_vocab, d), 0.02, dt, device),
        "speakers": normal(gen, (cfg.n_speakers, d), 0.02, dt, device),
        "pad_embed": normal(gen, (d,), 0.02, dt, device),
        "spk_proj": normal(gen, (80, d), 80 ** -0.5, dt, device),
        "cp": cp,
        "cp_embeds": normal(gen, (n_res, cfg.codebook_size, cfg.cp.d_model), 0.02, dt, device),
        "cp_heads": normal(gen, (n_res, cfg.cp.d_model, cfg.codebook_size), cfg.cp.d_model ** -0.5,
                           dt, device),
        "c2w": init_c2w_params(cfg.c2w, gen, device),
    }


# ---------------------------------------------------------------------------
# Code2Wav vocoder (NTC activations)
# ---------------------------------------------------------------------------


def _causal_conv(x, p: Params, dilation: int = 1):
    """NTC causal conv, stride 1: left-pad (k-1)*dilation, length preserved."""
    w = p["w"].to(x.dtype)
    k, groups = w.shape[-1], x.shape[-1] // w.shape[1]
    h = F.pad(x.transpose(1, 2), (dilation * (k - 1), 0))
    out = F.conv1d(h, w, p["b"].to(x.dtype), dilation=dilation, groups=groups)
    return out.transpose(1, 2)


def _causal_trans_conv(x, p: Params, stride: int, kernel: int):
    """ConvTranspose1d + the causal trim of (kernel - stride) samples on each side."""
    out = F.conv_transpose1d(x.transpose(1, 2), p["w"].to(x.dtype), p["b"].to(x.dtype), stride)
    out = out.transpose(1, 2)
    trim = kernel - stride
    return out[:, trim : out.shape[1] - trim] if trim else out


def _snake(x, p: Params):
    """SnakeBeta: x + (1/e^beta) sin^2(x * e^alpha), per channel, f32."""
    xf = x.float()
    alpha = torch.exp(p["alpha"])
    beta = torch.exp(p["beta"])
    return (xf + (1.0 / (beta + 1e-9)) * torch.square(torch.sin(xf * alpha))).to(x.dtype)


def _convnext_block(x, p: Params):
    h = _causal_conv(x, {"w": p["dw_w"], "b": p["dw_b"]})
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = torch.square(hf - mean).mean(dim=-1, keepdim=True)
    h = ((hf - mean) * torch.rsqrt(var + 1e-6) * p["ln_w"] + p["ln_b"]).to(x.dtype)
    h = linear(h, p["pw1_w"], p["pw1_b"])
    h = F.gelu(h.float()).to(x.dtype)
    h = linear(h, p["pw2_w"], p["pw2_b"])
    return x + p["gamma"] * h


def _c2w_transformer(params: Params, cfg: Code2WavConfig, x):
    t = x.shape[1]
    cos, sin = rope_frequencies(cfg.head_dim, t, cfg.rope_theta, x.device)
    qpos = torch.arange(t, device=x.device)[:, None]
    kpos = torch.arange(t, device=x.device)[None, :]
    mask = ((kpos <= qpos) & (kpos > qpos - cfg.sliding_window))[None, None]
    layers = params["layers"]
    b = x.shape[0]
    for i in range(n_stacked(layers)):
        lp = layer_slice(layers, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = linear(h, lp["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)
        k = linear(h, lp["wk"]).reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)
        v = linear(h, lp["wv"]).reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        a = attention(q, k, v, mask).transpose(1, 2).reshape(b, t, -1)
        x = x + lp["attn_scale"] * linear(a, lp["wo"])
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        h = linear(F.silu(linear(h, lp["w_gate"]).float()).to(x.dtype) * linear(h, lp["w_up"]),
                   lp["w_down"])
        x = x + lp["mlp_scale"] * h
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


@lru_cache(maxsize=8)
def c2w_deficit(cfg: Code2WavConfig) -> int:
    """Samples the causal trans-conv trims eat per vocoder call:
    ``len(wav(T)) == T * total_upsample - deficit`` (constant in T)."""
    t = 8
    length = t * math.prod(cfg.upsampling_ratios)
    for r in cfg.upsample_rates:
        length = (length - 1) * r
    return t * cfg.total_upsample - length


def code2wav(params: Params, cfg: Code2WavConfig, codes):
    """codes: (B, n_q, T) int -> waveform (B, T') float32 @ 24 kHz."""
    offsets = (torch.arange(cfg.num_quantizers, device=codes.device) * cfg.codebook_size)[None, :, None]
    emb = params["embed"][(codes + offsets).long()]  # (B, n_q, T, H)
    x = emb.float().mean(dim=1).to(cfg.dtype)
    x = _c2w_transformer(params, cfg, x)
    for blk, r in zip(params["upsample"], cfg.upsampling_ratios):
        x = _causal_trans_conv(x, blk["tconv"], r, r)
        x = _convnext_block(x, blk["convnext"])
    x = _causal_conv(x, params["dec_in"])
    for blk, rate in zip(params["dec_blocks"], cfg.upsample_rates):
        x = _snake(x, blk["act"])
        x = _causal_trans_conv(x, blk["tconv"], rate, 2 * rate)
        for unit, dil in zip(blk["units"], (1, 3, 9)):
            res = x
            x = _causal_conv(_snake(x, unit["act1"]), unit["conv1"], dilation=dil)
            x = _causal_conv(_snake(x, unit["act2"]), unit["conv2"])
            x = x + res
    x = _snake(x, params["dec_act"])
    x = _causal_conv(x, params["dec_out"])
    return torch.clamp(x[:, :, 0].float(), -1.0, 1.0)


# ---------------------------------------------------------------------------
# talker + code predictor decode
# ---------------------------------------------------------------------------


def quantize_params(params: Params, min_size: int | None = None, talker_bits: int = 8, cp_bits: int = 8,
                    act_quant: bool = False) -> Params:
    """Quantization of the decode-loop weights (talker and code predictor),
    each to int8 or packed int4, int8 leaves W8A8 with *act_quant*; heads,
    embeddings and the vocoder stay exact."""
    out = dict(params)
    out["talker"] = quantize_tree(params["talker"], min_size=min_size, bits=talker_bits, act_quant=act_quant)
    out["cp"] = quantize_tree(params["cp"], min_size=min_size, bits=cp_bits, act_quant=act_quant)
    return out


#: ``--tts_quantize`` mode -> (talker bits, code-predictor bits), the JAX
#: package's table; ``int8-dyn`` is int8 with W8A8 activations
_MODE_BITS = {"int8": (8, 8), "int8-dyn": (8, 8), "int8+cp4": (8, 4), "int4": (4, 4)}


class TalkerState(NamedTuple):
    lm_state: DecodeState
    next_embed: torch.Tensor  # (B, D) input embedding for the next frame step


def _cp_expand_frame(params: Params, cfg: Qwen3TTSConfig, talker_hidden, code0):
    """Per-frame MTP: expand (talker hidden, code0) into the residual
    codebooks.  talker_hidden: (B, D) PRE-final-norm talker output; code0:
    (B,) clipped to the codebook.  Returns (codes (B, n_q), embed_sum (B, D))
    where embed_sum includes the talker's code0 embedding."""
    cp, n_res = cfg.cp, cfg.n_q - 1
    b = code0.shape[0]
    cpp = params["cp"]
    state = decoder_lm.init_decode_state(cp, b, max_t=cfg.n_q + 2, device=code0.device)
    code0_emb = params["talker"]["embed"][code0.long()]
    prompt = torch.stack([talker_hidden.to(cp.dtype), code0_emb.to(cp.dtype)], dim=1)
    h, state = decoder_lm._hidden_prefill(cpp, cp, prompt, state, 2)
    h = rms_norm(h, cpp["final_norm"], cp.rms_eps)
    emb_sum = code0_emb.float()
    residuals = []
    for i in range(n_res):
        logits = h.float() @ f32_weight(params, "cp_heads")[i]
        code = torch.argmax(logits, dim=-1).to(torch.int32)
        residuals.append(code)
        emb = params["cp_embeds"][i][code.long()]
        emb_sum = emb_sum + emb.float()
        if i < n_res - 1:  # the last step's hidden state feeds nothing
            x, state = decoder_lm._hidden_step(cpp, cp, emb[:, None, :], state)
            h = rms_norm(x[:, 0], cpp["final_norm"], cp.rms_eps)
    codes = torch.stack([code0.to(torch.int32), *residuals], dim=1)  # (B, n_q)
    return codes, emb_sum.to(cfg.dtype)


def _frame_step(params: Params, cfg: Qwen3TTSConfig, state: TalkerState, tp=None):
    """One codec frame: talker step -> code0 -> code-predictor expansion.
    Returns (codes (B, n_q), eos (B,), new state)."""
    x, lm_state = decoder_lm._hidden_step(params["talker"], cfg.lm, state.next_embed[:, None, :],
                                          state.lm_state, tp)
    hidden = x[:, 0]
    normed = rms_norm(hidden, params["talker"]["final_norm"], cfg.lm.rms_eps)
    logits = normed.float() @ f32_weight(params, "codec_head")
    code0 = torch.argmax(logits, dim=-1).to(torch.int32)
    eos = code0 == cfg.codec_eos_id
    code0_cb = torch.clamp(code0, 0, cfg.codebook_size - 1)
    codes, emb_sum = _cp_expand_frame(params, cfg, hidden, code0_cb)
    next_embed = emb_sum + params["pad_embed"][None, :]
    return codes, eos, TalkerState(lm_state, next_embed)


def talker_prefill(params: Params, cfg: Qwen3TTSConfig, text_tokens, speaker_vec, state: DecodeState, tp=None):
    """Fill the talker cache with [speaker, text...]; the first frame step
    then consumes the codec BOS embedding.  Returns a TalkerState."""
    text_emb = params["text_embed"][text_tokens.long()]
    prompt = torch.cat([speaker_vec[:, None, :].to(text_emb.dtype), text_emb], dim=1)
    prompt_len = (text_tokens > 0).sum(dim=1) + 1
    _, lm_state = decoder_lm._hidden_prefill(params["talker"], cfg.lm, prompt, state, prompt_len, tp)
    bos = params["talker"]["embed"][
        torch.full((text_tokens.shape[0],), cfg.codec_bos_id, dtype=torch.long, device=text_tokens.device)
    ]
    return TalkerState(lm_state, bos)


def decode_chunk_audio(params: Params, cfg: Qwen3TTSConfig, state: TalkerState, context, n_frames: int,
                       tp=None):
    """Decode *n_frames* codec frames and vocode them with *context* (C, n_q)
    trailing frames of the previous chunk, trimmed from the returned audio.
    Everything stays on the device.

    Returns (audio, eos_flags (n_frames,), new state, next context)."""
    frames, flags = [], []
    for _ in range(n_frames):
        codes, eos, state = _frame_step(params, cfg, state, tp)
        frames.append(codes[0])
        flags.append(eos[0])
    full = torch.cat([context, torch.stack(frames)], dim=0)  # (C + n, n_q)
    wav = code2wav(params["c2w"], cfg.c2w, full.T[None])
    start = max(0, context.shape[0] * cfg.upsample - c2w_deficit(cfg.c2w))
    next_context = full[-context.shape[0]:] if context.shape[0] else full[:0]
    return wav[0, start:], torch.stack(flags), state, next_context


# ── cross-session batched tail programs (slots share talker/cp/vocoder) ──


def prompt_embeds(params: Params, cfg: Qwen3TTSConfig, text_tokens, speaker_vec):
    """[speaker, text...] prompt embeddings (1, 1 + T, D) and the prompt
    length as a 0-dim device tensor.  text_tokens: (1, T)."""
    text_emb = params["text_embed"][text_tokens.long()]
    prompt = torch.cat([speaker_vec[:, None, :].to(text_emb.dtype), text_emb], dim=1)
    return prompt, (text_tokens > 0).sum(dim=1)[0] + 1


def prefill_tts_slot(params: Params, cfg: Qwen3TTSConfig, text_tokens, speaker_vec, state, slot: int, tp=None):
    """Prefill one slot of the batched talker state in place; returns (the
    codec BOS embedding (D,) for the slot's first frame, state)."""
    prompt, prompt_len = prompt_embeds(params, cfg, text_tokens, speaker_vec)
    state = bd.prefill_slot_embeds(params["talker"], cfg.lm, prompt, prompt_len, state, slot, tp)
    return params["talker"]["embed"][cfg.codec_bos_id], state


def _frame_step_multi_tail(params: Params, cfg: Qwen3TTSConfig, embeds, kc, vc, pos0, tk, tv,
                           n_act, active, i: int, tp=None):
    """One codec frame for every row against frozen caches + the tail.
    Returns (codes (B, n_q), eos (B,), next embeds (B, D), tk, tv)."""
    hidden, tk, tv = bd.tail_hidden_step(params["talker"], cfg.lm, embeds, kc, vc, pos0, tk, tv,
                                         n_act, active, i, tp)
    normed = rms_norm(hidden, params["talker"]["final_norm"], cfg.lm.rms_eps)
    logits = normed.float() @ f32_weight(params, "codec_head")
    code0 = torch.argmax(logits, dim=-1).to(torch.int32)
    eos = code0 == cfg.codec_eos_id
    codes, emb_sum = _cp_expand_frame(params, cfg, hidden, torch.clamp(code0, 0, cfg.codebook_size - 1))
    next_embeds = torch.where(active[:, None], emb_sum + params["pad_embed"][None, :], embeds)
    return codes, eos, next_embeds, tk, tv


def decode_chunk_audio_tail(params: Params, cfg: Qwen3TTSConfig, embeds, state, contexts,
                            n_frames: int, active, tp=None):
    """*n_frames* codec frames for every row plus Code2Wav, with one cache
    write per chunk.  embeds: (B, D); contexts: (B, C, n_q) trailing frames of
    each row's previous chunk; active: (B,) bool.  Returns (audio (B, T'),
    eos (n, B), next embeds, state, next contexts)."""
    b = embeds.shape[0]
    kc, vc, pos0 = state.caches.k, state.caches.v, state.pos
    tk, tv = bd.init_tail(cfg.lm, b, n_frames, embeds.device, kc.shape[2])
    n_act = torch.zeros((b,), dtype=torch.int32, device=embeds.device)
    frames, flags = [], []
    for i in range(n_frames):
        codes, eos, embeds, tk, tv = _frame_step_multi_tail(params, cfg, embeds, kc, vc, pos0, tk, tv,
                                                            n_act, active, i, tp)
        frames.append(codes)
        flags.append(eos)
        n_act = n_act + active.to(torch.int32)
    state = bd.blend_tail_into_state(state, tk, tv, n_act)
    full = torch.cat([contexts, torch.stack(frames, dim=1)], dim=1)  # (B, C + n, n_q)
    wav = code2wav(params["c2w"], cfg.c2w, full.transpose(1, 2))
    start = max(0, contexts.shape[1] * cfg.upsample - c2w_deficit(cfg.c2w))
    next_contexts = full[:, full.shape[1] - contexts.shape[1]:]
    return wav[:, start:], torch.stack(flags), embeds, state, next_contexts


def decode_chunk_audio_slot_tail(params: Params, cfg: Qwen3TTSConfig, embed, state, context,
                                 n_frames: int, slot: int, tp=None):
    """Priority lane: *n_frames* frames + vocode for ONE slot at batch-1
    cost, on views of its row.  embed: (D,); context: (C, n_q).  Returns
    (audio (T',), eos (n,), next embed (D,), state, next context)."""
    active = torch.ones((1,), dtype=torch.bool, device=embed.device)
    audio, eos, emb, _, ctx = decode_chunk_audio_tail(params, cfg, embed[None], bd._slot_row(state, slot),
                                                      context[None], n_frames, active, tp)
    return audio[0], eos[:, 0], emb[0], state, ctx[0]


def prefill_and_first_chunk_slot_tail(params: Params, cfg: Qwen3TTSConfig, text_tokens, speaker_vec,
                                      state, contexts_all, n_frames: int, slot: int, tp=None):
    """Fused prefill + first ramp chunk for one slot (prompt ingest and the
    first audible frames in one dispatch); the slot's context is reset and
    then set in place.  Returns (audio, eos, next embed, state, contexts_all)."""
    bos, state = prefill_tts_slot(params, cfg, text_tokens, speaker_vec, state, slot, tp)
    ctx0 = torch.zeros_like(contexts_all[0])
    audio, eos, emb, state, ctx = decode_chunk_audio_slot_tail(params, cfg, bos, state, ctx0, n_frames, slot, tp)
    contexts_all[slot] = ctx
    return audio, eos, emb, state, contexts_all


def decode_chunk_audio_gathered_tail(params: Params, cfg: Qwen3TTSConfig, embeds_all, state,
                                     contexts_all, n_frames: int, slot_ids, tp=None):
    """Steady lane over a compact gathered batch (``slot_ids`` (W,), padded
    by repeating a valid id).  Returns (audio (W, T'), eos (n, W),
    embeds_all, state, contexts_all), the last three updated in place."""
    rows = bd._gather_rows(state, slot_ids)
    active = torch.ones(slot_ids.shape, dtype=torch.bool, device=embeds_all.device)
    audio, eos, emb, rows, ctx = decode_chunk_audio_tail(params, cfg, embeds_all[slot_ids], rows,
                                                         contexts_all[slot_ids], n_frames, active, tp)
    bd._scatter_rows(state, slot_ids, rows)
    embeds_all[slot_ids] = emb
    contexts_all[slot_ids] = ctx
    return audio, eos, embeds_all, state, contexts_all


def speaker_from_reference(params: Params, ref_audio: np.ndarray) -> torch.Tensor:
    """Voice-clone embedding: the mean 80-mel log-mel of the reference audio
    (16 kHz f32) projected to D by ``spk_proj``; a (1, D) f32 tensor on the
    weights' device.  The log-mel is the kernel on the card."""
    from s2s_tpu_torch.ops.log_mel import log_mel_spectrogram

    spk_proj = params["spk_proj"]
    audio = torch.from_numpy(np.asarray(ref_audio, np.float32)).to(spk_proj.device)
    pooled = torch.mean(log_mel_spectrogram(audio, 80), dim=1)  # (80,)
    return (pooled @ spk_proj.float())[None, :]


def load_speaker_file(path: str, device: torch.device | str = "cpu") -> torch.Tensor:
    """A precomputed speaker embedding (.npy/.npz) as a (1, D) f32 tensor."""
    arr = np.load(path)
    if hasattr(arr, "files"):
        arr = arr[arr.files[0]]
    return torch.from_numpy(np.asarray(arr, np.float32).reshape(1, -1)).to(device)


# ---------------------------------------------------------------------------
# host-side streaming synthesizer
# ---------------------------------------------------------------------------


class Qwen3TTS:
    """Host-side streaming synthesizer over the chunk decode."""

    #: KV-cache length buckets: decode-step cost scales with cache reads.
    CACHE_BUCKETS = (512, 768, 1024, 1536, 2048)

    def __init__(
        self,
        params: Params | None = None,
        cfg: Qwen3TTSConfig | None = None,
        seed: int = 0,
        chunk_frames: int = DEFAULT_CHUNK_FRAMES,
        context_frames: int = VOCODER_CONTEXT_FRAMES,
        ramp_chunks: tuple[int, ...] = (2, 4),
        int8: bool | str = False,
        tokenizer=None,
        device: torch.device | str = "cpu",
    ) -> None:
        self.cfg = cfg or Qwen3TTSConfig()
        self.device = torch.device(device)
        self.tokenizer = tokenizer
        mode = (int8 if isinstance(int8, str) else "int8") if int8 else None
        check_mode(mode, TTS_MODES)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen, self.device)
        # quantization modes (--tts_quantize): True/"int8" = talker and code
        # predictor int8 W8A16; "int8-dyn" = W8A8 dynamic; "int8+cp4" =
        # talker int8, code predictor packed int4; "int4" = both int4.
        # Quantized on the device the weights live on.
        if mode:
            talker_bits, cp_bits = _MODE_BITS[mode]
            params = quantize_params(params, talker_bits=talker_bits, cp_bits=cp_bits, act_quant=mode == "int8-dyn")
        self.params = params
        self.chunk_frames = chunk_frames
        self.context_frames = context_frames
        self.ramp_chunks = tuple(min(c, chunk_frames) for c in ramp_chunks)

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE

    def _encode_text(self, text: str, bucket: int | None = None) -> tuple[torch.Tensor, int]:
        """Text -> padded (1, bucket) token ids on the device + valid length."""
        arr, n = self.encode_text_host(text, bucket)
        return torch.from_numpy(arr).to(self.device), n

    def encode_text_host(self, text: str, bucket: int | None = None) -> tuple[np.ndarray, int]:
        """Text -> padded (1, bucket) int32 token ids on the host + valid length
        (tokenizer ids, or a clamped UTF-8 byte fallback without one); the
        batched engine takes host ids."""
        bucket = bucket or min(256, self.cfg.lm.max_seq_len // 2 - 1)
        if self.tokenizer is not None:
            ids = [i for i in self.tokenizer.encode(text) if 0 <= i < self.cfg.text_vocab][:bucket]
            ids = ids or [1]
        else:
            ids = [min(self.cfg.text_vocab - 1, max(1, b)) for b in text.encode("utf-8")][:bucket]
        arr = np.zeros((1, bucket), np.int32)
        arr[0, : len(ids)] = ids
        return arr, len(ids)

    def _cache_len(self, prompt_bucket: int, max_new: int) -> int:
        need = prompt_bucket + 1 + max_new
        for b in self.CACHE_BUCKETS:
            if need <= b <= self.cfg.lm.max_seq_len:
                return b
        return self.cfg.lm.max_seq_len

    def speaker(self, speaker_id: int) -> torch.Tensor:
        return self.params["speakers"][speaker_id : speaker_id + 1]

    def stream(
        self,
        text: str,
        max_new_tokens: int = 64,
        speaker_id: int = 0,
        speaker_vec: Any | None = None,
        cancel_check=None,
    ) -> Iterator[tuple[np.ndarray, int]]:
        """Yield (float32 audio chunk, sample_rate) per chunk of codec frames
        (a short ramp first, then ``chunk_frames``); one host read per chunk.
        ``cancel_check()`` polls between chunks."""
        cfg = self.cfg
        tokens, _ = self._encode_text(text)
        if speaker_vec is None:
            speaker_vec = self.speaker(speaker_id)
        speaker_vec = torch.as_tensor(speaker_vec, device=self.device)
        state = decoder_lm.init_decode_state(
            cfg.lm, 1, max_t=self._cache_len(tokens.shape[1], max_new_tokens), device=self.device
        )
        tstate = talker_prefill(self.params, cfg, tokens, speaker_vec, state)
        context = torch.zeros((self.context_frames, cfg.n_q), dtype=torch.int32, device=self.device)
        emitted = 0
        chunk_i = 0
        while emitted < max_new_tokens:
            chunk = self.ramp_chunks[chunk_i] if chunk_i < len(self.ramp_chunks) else self.chunk_frames
            chunk_i += 1
            n = min(chunk, max_new_tokens - emitted)
            audio_dev, eos_flags, tstate, context = decode_chunk_audio(self.params, cfg, tstate, context, n)
            audio = audio_dev.cpu().numpy()
            eos = eos_flags.cpu().numpy()
            valid = n
            hit_eos = False
            nz = np.nonzero(eos)[0]
            if len(nz):
                valid = int(nz[0])  # EOS frame itself carries no audio
                hit_eos = True
            if valid > 0:
                yield audio[: min(len(audio), valid * cfg.upsample)], SAMPLE_RATE
            emitted += max(valid, 1)
            if hit_eos:
                return
            if cancel_check is not None and cancel_check():
                return


# ---------------------------------------------------------------------------
# checkpoint conversion (transformers Qwen3-Omni talker/code2wav naming)
# ---------------------------------------------------------------------------


def convert_c2w_state_dict(sd: dict, cfg: Code2WavConfig, device: torch.device | str = "cpu") -> Params:
    """transformers ``Qwen3OmniMoeCode2Wav`` state dict (numpy arrays or
    tensors) -> the JAX package's tree on *device* (convolutions in its
    NTC/TIO layouts, :func:`s2s_tpu_torch.weights.c2w_params` takes them to
    PyTorch's)."""
    dt = cfg.dtype

    def a(name, dtype=None):
        return device_tensor(host_array(sd[name]), dtype or dt, device)

    def t(name):
        return device_tensor(host_array(sd[name]).T, dt, device)

    def conv(name):  # torch Conv1d (out, in/groups, k) -> NTC/TIO (k, in/g, out)
        return {"w": device_tensor(host_array(sd[name + ".weight"]).transpose(2, 1, 0), dt, device),
                "b": a(name + ".bias")}

    def tconv(name):  # torch ConvTranspose1d (in, out, k) -> flipped (k, in, out)
        w = host_array(sd[name + ".weight"]).transpose(2, 0, 1)[::-1].copy()
        return {"w": device_tensor(w, dt, device), "b": a(name + ".bias")}

    def snake(name):
        return {"alpha": a(name + ".alpha", torch.float32), "beta": a(name + ".beta", torch.float32)}

    perm = decoder_lm._rope_perm(cfg.head_dim)

    def rope_perm(name):
        w = host_array(sd[name])  # (n_heads*hd, d)
        w = w.reshape(-1, cfg.head_dim, w.shape[-1])[:, perm, :].reshape(-1, w.shape[-1])
        return device_tensor(w.T, dt, device)

    layers = []
    for i in range(cfg.n_layers):
        p = f"pre_transformer.layers.{i}."
        layers.append({
            "attn_norm": a(p + "input_layernorm.weight"),
            "wq": rope_perm(p + "self_attn.q_proj.weight"),
            "wk": rope_perm(p + "self_attn.k_proj.weight"),
            "wv": t(p + "self_attn.v_proj.weight"),
            "wo": t(p + "self_attn.o_proj.weight"),
            "attn_scale": a(p + "self_attn_layer_scale.scale"),
            "mlp_norm": a(p + "post_attention_layernorm.weight"),
            "w_gate": t(p + "mlp.gate_proj.weight"),
            "w_up": t(p + "mlp.up_proj.weight"),
            "w_down": t(p + "mlp.down_proj.weight"),
            "mlp_scale": a(p + "mlp_layer_scale.scale"),
        })

    upsample = []
    for i in range(len(cfg.upsampling_ratios)):
        p = f"upsample.{i}."
        upsample.append({
            "tconv": tconv(p + "0.conv"),
            "convnext": {
                "dw_w": device_tensor(host_array(sd[p + "1.dwconv.conv.weight"]).transpose(2, 1, 0), dt, device),
                "dw_b": a(p + "1.dwconv.conv.bias"),
                "ln_w": a(p + "1.norm.weight"), "ln_b": a(p + "1.norm.bias"),
                "pw1_w": t(p + "1.pwconv1.weight"), "pw1_b": a(p + "1.pwconv1.bias"),
                "pw2_w": t(p + "1.pwconv2.weight"), "pw2_b": a(p + "1.pwconv2.bias"),
                "gamma": a(p + "1.gamma"),
            },
        })

    dec_blocks = []
    for i in range(len(cfg.upsample_rates)):
        p = f"decoder.{i + 1}.block."
        units = []
        for j in range(3):
            q = p + f"{j + 2}."
            units.append({
                "act1": snake(q + "act1"), "conv1": conv(q + "conv1.conv"),
                "act2": snake(q + "act2"), "conv2": conv(q + "conv2.conv"),
            })
        dec_blocks.append({"act": snake(p + "0"), "tconv": tconv(p + "1.conv"), "units": units})

    n_dec = len(cfg.upsample_rates)
    return {
        "embed": a("code_embedding.weight"),
        "layers": stack_layers(layers),
        "final_norm": a("pre_transformer.norm.weight"),
        "upsample": upsample,
        "dec_in": conv("decoder.0.conv"),
        "dec_blocks": dec_blocks,
        "dec_act": snake(f"decoder.{n_dec + 1}"),
        "dec_out": conv(f"decoder.{n_dec + 2}.conv"),
    }


def convert_state_dict(sd: dict, cfg: Qwen3TTSConfig, device: torch.device | str = "cpu") -> Params:
    """Full Qwen3-TTS checkpoint (talker + code predictor + code2wav; numpy
    arrays or tensors) using transformers Qwen3-Omni talker naming -> the
    JAX package's tree on *device*:

    - ``talker.model.layers.*`` / ``talker.codec_head`` — dense Qwen3 talker
    - ``talker.code_predictor.model.layers.*``, ``.codec_embedding.{i}``,
      ``.lm_head.{i}`` — MTP code predictor
    - ``code2wav.*`` — vocoder
    Optional TTS-specific tables: ``talker.text_embed``, ``talker.speakers``,
    ``talker.tts_pad_embed``, ``talker.spk_proj``.
    """
    dt = cfg.dtype

    def sub(prefix, rename_to="model."):  # the entries themselves: each converter reads its own
        return {rename_to + k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def a(name):
        return device_tensor(host_array(sd[name]), dt, device)

    def t(name):
        return device_tensor(host_array(sd[name]).T, dt, device)

    talker_sd = sub("talker.model.")
    talker_sd["model.embed_tokens.weight"] = sd["talker.model.embed_tokens.weight"]
    talker = decoder_lm.convert_hf_state_dict(talker_sd, cfg.lm, device)
    talker.pop("lm_head", None)

    cp_sd = sub("talker.code_predictor.model.")
    cp_sd["model.embed_tokens.weight"] = np.zeros((1, cfg.cp.d_model), np.float32)  # unused
    cp = decoder_lm.convert_hf_state_dict(cp_sd, cfg.cp, device)
    cp.pop("lm_head", None)
    cp.pop("embed", None)

    n_res = cfg.n_q - 1
    cp_embeds = torch.stack([a(f"talker.code_predictor.model.codec_embedding.{i}.weight") for i in range(n_res)])
    cp_heads = torch.stack([t(f"talker.code_predictor.lm_head.{i}.weight") for i in range(n_res)])

    c2w_sd = {k[len("code2wav."):]: v for k, v in sd.items() if k.startswith("code2wav.")}

    def opt(name, shape):
        return a(name) if name in sd else torch.zeros(shape, dtype=dt, device=device)

    d = cfg.lm.d_model
    return {
        "talker": talker,
        "codec_head": t("talker.codec_head.weight"),
        "text_embed": opt("talker.text_embed.weight", (cfg.text_vocab, d)),
        "speakers": opt("talker.speakers.weight", (cfg.n_speakers, d)),
        "pad_embed": opt("talker.tts_pad_embed", (d,)),
        "spk_proj": opt("talker.spk_proj.weight", (80, d)),
        "cp": cp,
        "cp_embeds": cp_embeds,
        "cp_heads": cp_heads,
        "c2w": convert_c2w_state_dict(c2w_sd, cfg.c2w, device),
    }
