"""ChatTTS in PyTorch: the port of ``s2s_tpu/models/chattts.py``
(2noise/ChatTTS: a Llama-backbone audio-token LM + GFSQ DVAE decoder +
Vocos vocoder, with a sampled speaker embedding per session).

The same structure, numerics (f32 throughout) and names as the JAX
package:

- **GPT**: a Llama decoder (hidden 768, 20 layers at full scale) from
  :mod:`s2s_tpu_torch.models.decoder_lm`.  Text positions embed through
  ``emb_text``; audio positions embed as the SUM of ``num_vq=4`` codebook
  embeddings (``emb_code``); each step runs all 4 ``head_code`` heads in
  f32.  Frame 0's codes come from the prompt's last position.
- **Speaker**: a 768-dim embedding drawn per session from ``spk_mean`` /
  ``spk_std``, normalised and spliced in at the ``[spk_emb]`` text-token
  positions.  The port draws it with a ``torch.Generator``, so a seed gives
  a different speaker from the JAX package's ``jax.random`` draw; parity
  checks pass the speaker in.
- **DVAE decoder**: GFSQ dequantize (each code decomposed mixed-radix over
  ``levels``, projected per group and residual), "same"-padded convs and
  ConvNeXt blocks with depthwise convs, 100-bin mel at 2 frames per token
  scaled by ``coef``.
- **Vocos vocoder**: ConvNeXt backbone + the iSTFT head of
  :mod:`s2s_tpu_torch.ops.istft`, mel -> 24 kHz waveform.

The AR loop runs eagerly with no host read between steps; one utterance
reads the prompt length once (after the prefill's inputs are on the
device) and the valid-frame count once, with the audio.  Convolution
weights are PyTorch's Conv1d ``(out, in/g, k)``;
:func:`s2s_tpu_torch.weights.chattts_params` carries the JAX package's
trees across.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from s2s_tpu_torch import weights
from s2s_tpu_torch.models import decoder_lm
from s2s_tpu_torch.models.common import HostStateDict, Params, f32_weight, layer_norm, linear, rms_norm, tree_to_device
from s2s_tpu_torch.models.common import weight_norm as _wn
from s2s_tpu_torch.models.decoder_lm import DecoderLMConfig, normal
from s2s_tpu_torch.ops.istft import istft

SAMPLE_RATE = 24_000


@dataclass(frozen=True)
class DvaeConfig:
    levels: tuple = (5, 5, 5, 5)   # FSQ levels per quantized dim
    groups: int = 2                # G
    residuals: int = 2             # R; num_vq = G * R
    latent_dim: int = 512          # decoder input dim (G groups concat)
    dec_hidden: int = 256          # decoder conv width
    dec_bottleneck: int = 128
    dec_layers: int = 12
    n_mels: int = 100
    frames_per_token: int = 2

    @property
    def num_vq(self) -> int:
        return self.groups * self.residuals

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))  # 625


@dataclass(frozen=True)
class VocosConfig:
    n_mels: int = 100
    dim: int = 512
    n_layers: int = 8
    ff_mult: int = 3
    n_fft: int = 1024
    hop: int = 256


@dataclass(frozen=True)
class ChatTTSConfig:
    text_vocab: int = 21178
    num_audio_tokens: int = 626    # 625 codes + EOS
    audio_eos_id: int = 625
    spk_emb_token: int = 21143     # [spk_emb] placeholder id in the text vocab
    gpt: DecoderLMConfig = field(default_factory=lambda: DecoderLMConfig(
        vocab_size=1, d_model=768, n_layers=20, n_heads=12, n_kv_heads=12,
        d_ff=3072, max_seq_len=4096, rope_theta=10000.0, rms_eps=1e-6,
        tie_embeddings=False, dtype=torch.float32,
    ))
    dvae: DvaeConfig = field(default_factory=DvaeConfig)
    vocos: VocosConfig = field(default_factory=VocosConfig)
    dtype: Any = torch.float32

    @staticmethod
    def tiny() -> "ChatTTSConfig":
        return ChatTTSConfig(
            text_vocab=64, num_audio_tokens=626, audio_eos_id=625, spk_emb_token=5,
            gpt=DecoderLMConfig(vocab_size=1, d_model=32, n_layers=2, n_heads=4,
                                n_kv_heads=4, d_ff=64, max_seq_len=256,
                                tie_embeddings=False, dtype=torch.float32),
            dvae=DvaeConfig(latent_dim=16, dec_hidden=16, dec_bottleneck=8,
                            dec_layers=2, n_mels=10, frames_per_token=2),
            vocos=VocosConfig(n_mels=10, dim=16, n_layers=1, ff_mult=2,
                              n_fft=16, hop=4),
        )


def init_params(cfg: ChatTTSConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*: the JAX package's
    distributions and tree (its layouts, then
    :func:`s2s_tpu_torch.weights.chattts_params`), not its numbers."""

    def rnd(shape, scale=0.02):
        return normal(gen, shape, scale, torch.float32, device)

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    def conv(cin, cout, k):
        return {"w": rnd((k, cin, cout), (cin * k) ** -0.5), "b": full(cout, 0.0)}

    def lin(i, o):
        return {"w": rnd((i, o)), "b": full(o, 0.0)}

    def convnext(c, hidden):
        return {"dw": conv(1, c, 7),  # depthwise (k, 1, C)
                "ln_w": full(c, 1.0), "ln_b": full(c, 0.0),
                "pw1": lin(c, hidden), "pw2": lin(hidden, c),
                "gamma": full(c, 1e-6)}

    d, dv, vc = cfg.gpt.d_model, cfg.dvae, cfg.vocos
    gpt = decoder_lm.init_params(cfg.gpt, gen, device)
    gpt.pop("lm_head", None)
    gpt.pop("embed", None)
    tree = {
        "gpt": gpt,
        "emb_text": rnd((cfg.text_vocab, d)),
        "emb_code": rnd((dv.num_vq, cfg.num_audio_tokens, d)),
        "head_code": rnd((dv.num_vq, d, cfg.num_audio_tokens), d ** -0.5),
        "spk_mean": full(d, 0.0),
        "spk_std": full(d, 1.0),
        "dvae": {
            # FSQ out-projection: one (len(levels) -> latent_dim // G) per (G, R)
            "project_out": rnd((dv.groups, dv.residuals, len(dv.levels), dv.latent_dim // dv.groups)),
            "conv_in": [conv(dv.latent_dim, dv.dec_bottleneck, 3), conv(dv.dec_bottleneck, dv.dec_hidden, 3)],
            "blocks": [convnext(dv.dec_hidden, dv.dec_bottleneck) for _ in range(dv.dec_layers)],
            "out_conv": conv(dv.dec_hidden, dv.n_mels * dv.frames_per_token, 3),
            "coef": full(dv.n_mels, 1.0),
        },
        "vocos": {
            "embed": conv(vc.n_mels, vc.dim, 7),
            "norm_w": full(vc.dim, 1.0), "norm_b": full(vc.dim, 0.0),
            "layers": [convnext(vc.dim, vc.ff_mult * vc.dim) for _ in range(vc.n_layers)],
            "final_ln_w": full(vc.dim, 1.0), "final_ln_b": full(vc.dim, 0.0),
            "head": lin(vc.dim, vc.n_fft + 2),
        },
    }
    return weights.chattts_params(tree, device)


# ---------------------------------------------------------------------------
# DVAE decode: codes -> mel
# ---------------------------------------------------------------------------


def gfsq_dequantize(params: Params, cfg: DvaeConfig, codes):
    """codes (B, T, num_vq) int -> latent (B, T, latent_dim).

    Stream order is (group-major, residual-minor): stream g*R + r belongs
    to group g, residual depth r.  Each index decomposes mixed-radix over
    ``levels`` to per-dim level indices, normalised to [-1, 1]; the
    ``project_out`` matrices map each vector back to the group's latent
    slice; residuals SUM within a group, groups CONCAT.
    """
    levels = np.asarray(cfg.levels)
    radices = np.concatenate([[1], np.cumprod(levels[::-1])[:-1]])[::-1].copy()
    codes = codes.long()
    group_parts = []
    for g in range(cfg.groups):
        acc = None
        for r in range(cfg.residuals):
            idx = codes[..., g * cfg.residuals + r]  # (B, T)
            digits = []
            for lvl, rad in zip(levels, radices):
                digit = torch.remainder(torch.div(idx, int(rad), rounding_mode="floor"), int(lvl))
                # IEEE division by a tensor, as JAX divides
                half = torch.tensor((lvl - 1) / 2.0, dtype=torch.float32, device=codes.device)
                digits.append((digit.float() - half) / half)
            vec = torch.stack(digits, dim=-1)  # (B, T, len(levels))
            part = vec @ params["project_out"][g, r]
            acc = part if acc is None else acc + part
        group_parts.append(acc)
    return torch.cat(group_parts, dim=-1)


def _causal_pad_conv(x, p):
    """Symmetric ('same') conv over (B, T, C), kernel (out, in/g, k): grouped
    where in/g < C (the depthwise blocks).  DVAE/Vocos convs are non-causal
    same-padded in the reference."""
    w = p["w"]
    k = w.shape[-1]
    pad = (k - 1) // 2
    xt = F.pad(x.transpose(1, 2), (pad, k - 1 - pad))
    return F.conv1d(xt, w, p["b"], groups=x.shape[-1] // w.shape[1]).transpose(1, 2)


def _convnext(x, blk):
    h = _causal_pad_conv(x, blk["dw"])  # depthwise
    h = layer_norm(h, blk["ln_w"], blk["ln_b"])
    h = linear(h, blk["pw1"]["w"], blk["pw1"]["b"])
    h = F.gelu(h)
    h = linear(h, blk["pw2"]["w"], blk["pw2"]["b"])
    return x + blk["gamma"] * h


def dvae_decode(params: Params, cfg: DvaeConfig, codes):
    """codes (B, T, num_vq) -> mel (B, n_mels, T * frames_per_token)."""
    x = gfsq_dequantize(params, cfg, codes)
    x = _causal_pad_conv(x, params["conv_in"][0])
    x = F.gelu(x)
    x = _causal_pad_conv(x, params["conv_in"][1])
    for blk in params["blocks"]:
        x = _convnext(x, blk)  # the reference DVAEDecoder block form
    x = _causal_pad_conv(x, params["out_conv"])  # (B, T, n_mels * fpt)
    b, t, _ = x.shape
    mel = x.reshape(b, t * cfg.frames_per_token, cfg.n_mels)
    return (mel * params["coef"][None, None, :]).transpose(1, 2)


# ---------------------------------------------------------------------------
# Vocos: mel -> waveform
# ---------------------------------------------------------------------------


def vocos_decode(params: Params, cfg: VocosConfig, mel):
    """mel (B, n_mels, T) -> waveform (B, (T - 1) * hop)."""
    x = mel.transpose(1, 2)  # (B, T, n_mels)
    x = _causal_pad_conv(x, params["embed"])
    x = layer_norm(x, params["norm_w"], params["norm_b"])
    for lp in params["layers"]:
        x = _convnext(x, lp)
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"])
    spec = linear(x, params["head"]["w"], params["head"]["b"])  # (B, T, n_fft + 2)
    half = cfg.n_fft // 2 + 1
    mag = torch.exp(torch.clamp(spec[..., :half], -20.0, 10.0))
    return istft(mag, spec[..., half:], cfg.n_fft, cfg.hop)


# ---------------------------------------------------------------------------
# GPT generation
# ---------------------------------------------------------------------------


class ChatState(NamedTuple):
    lm_state: decoder_lm.DecodeState
    prev_codes: torch.Tensor  # (B, num_vq) last emitted codes, on the device


def apply_spk_emb(params: Params, cfg: ChatTTSConfig, text_tokens, spk_emb):
    """Text embeddings with the normalised speaker embedding spliced in at
    ``[spk_emb]`` token positions (the reference's apply_spk_emb)."""
    emb = params["emb_text"][text_tokens]  # (B, T, D)
    if spk_emb is None:
        return emb
    norm = spk_emb / (torch.linalg.vector_norm(spk_emb) + 1e-8)
    styled = norm * params["spk_std"] + params["spk_mean"]
    mask = (text_tokens == cfg.spk_emb_token)[..., None]
    return torch.where(mask, styled[None, None, :], emb)


def sample_speaker(params: Params, gen: torch.Generator) -> torch.Tensor:
    """A random speaker: an N(spk_mean, spk_std) draw (reference rand_spk).
    The noise is drawn on *gen*'s device and moved to the weights', so a CPU
    generator gives the same speaker on every device."""
    mean = params["spk_mean"]
    noise = torch.randn(mean.shape, generator=gen, dtype=torch.float32, device=gen.device)
    return mean + params["spk_std"] * noise.to(mean.device)


def _codes_from_hidden(params: Params, cfg: ChatTTSConfig, h):
    """All num_vq heads over one normed hidden: (codes (B, nvq), eos (B,))."""
    heads = f32_weight(params, "head_code")
    codes = torch.stack([torch.argmax(h.float() @ heads[k], dim=-1) for k in range(cfg.dvae.num_vq)], dim=-1)
    eos = torch.any(codes == cfg.audio_eos_id, dim=-1)
    return torch.clamp(codes, 0, cfg.dvae.codebook_size - 1), eos


def prefill(params: Params, cfg: ChatTTSConfig, text_tokens, spk_emb, state):
    """Prefill the text prompt; the FIRST audio frame's codes come from the
    last text position's heads (the reference decodes frame 0 from the
    prompt logits, not from a synthetic BOS step).  The prompt length (the
    longest row's count of non-zero ids) is read to the host once.
    Returns (ChatState, codes0 (B, nvq), eos0 (B,))."""
    text_tokens = text_tokens.long()
    embeds = apply_spk_emb(params, cfg, text_tokens, spk_emb).to(cfg.gpt.dtype)
    prompt_len = int(torch.sum(text_tokens > 0, dim=1).max())
    h, lm_state = decoder_lm._hidden_prefill(params["gpt"], cfg.gpt, embeds, state, prompt_len)
    h = rms_norm(h, params["gpt"]["final_norm"], cfg.gpt.rms_eps)
    codes0, eos0 = _codes_from_hidden(params, cfg, h)
    return ChatState(lm_state, codes0), codes0, eos0


def generate_codes(params: Params, cfg: ChatTTSConfig, state: ChatState, n_tokens: int):
    """Greedy AR loop CONTINUING from the prefill-predicted frame: each step
    embeds the previous frame's codes (summed), runs one GPT step, and emits
    argmax from all heads, with no host read.
    Returns (codes (n, B, num_vq), eos (n, B), state), on the device."""
    all_codes, all_eos = [], []
    for _ in range(n_tokens):
        prev = state.prev_codes
        emb = torch.zeros((prev.shape[0], cfg.gpt.d_model), dtype=cfg.gpt.dtype, device=prev.device)
        for k in range(cfg.dvae.num_vq):
            emb = emb + params["emb_code"][k][prev[:, k]].to(cfg.gpt.dtype)
        x, lm_state = decoder_lm._hidden_step(params["gpt"], cfg.gpt, emb[:, None, :], state.lm_state)
        h = rms_norm(x[:, 0], params["gpt"]["final_norm"], cfg.gpt.rms_eps)
        codes, eos = _codes_from_hidden(params, cfg, h)
        state = ChatState(lm_state, codes)
        all_codes.append(codes)
        all_eos.append(eos)
    if not all_codes:  # a one-token budget: the prefill's frame only
        prev = state.prev_codes
        return prev.new_zeros((0, *prev.shape)), prev.new_zeros((0, prev.shape[0]), dtype=torch.bool), state
    return torch.stack(all_codes), torch.stack(all_eos), state


def synthesize_utterance(params: Params, cfg: ChatTTSConfig, text_tokens, spk_emb,
                         max_tokens: int, cache_len: int | None = None):
    """Whole utterance: prefill + AR loop + DVAE + Vocos.
    Returns (audio (B, T_samples), n_valid_tokens ()), on the device."""
    device = params["emb_text"].device
    text_tokens = text_tokens.to(device)
    state = decoder_lm.init_decode_state(cfg.gpt, text_tokens.shape[0], max_t=cache_len or cfg.gpt.max_seq_len,
                                         device=device)
    cstate, codes0, eos0 = prefill(params, cfg, text_tokens, spk_emb, state)
    rest, eos_rest, _ = generate_codes(params, cfg, cstate, max_tokens - 1)
    codes = torch.cat([codes0[None], rest], dim=0)
    eos = torch.cat([eos0[None], eos_rest], dim=0)
    mel = dvae_decode(params["dvae"], cfg.dvae, codes.transpose(0, 1))
    audio = vocos_decode(params["vocos"], cfg.vocos, mel)
    n_valid = torch.where(eos[:, 0].any(), torch.argmax(eos[:, 0].int()), torch.tensor(max_tokens, device=device))
    return audio, n_valid


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


def config_from_params(params: Params) -> ChatTTSConfig:
    """Shape-driven configuration from the port's tree (exact dims come from
    the weights; token-id metadata keeps the published ChatTTS values)."""
    base = ChatTTSConfig()
    text_vocab, d = params["emb_text"].shape
    nvq, n_audio, _ = params["emb_code"].shape
    n_layers = params["gpt"]["layers"]["wq"].shape[0]
    d_ff = params["gpt"]["layers"]["w_gate"].shape[2]
    heads = 4 if d <= 64 else max(1, d // 64)
    dv = params["dvae"]  # the port's layouts: Conv1d (out, in/g, k)
    g, r, n_levels, per_group = dv["project_out"].shape
    hidden = dv["out_conv"]["w"].shape[1]
    n_mels = dv["coef"].shape[0]
    fpt = dv["out_conv"]["w"].shape[0] // n_mels
    vc = params["vocos"]
    vdim = vc["embed"]["w"].shape[0]
    n_fft = vc["head"]["w"].shape[1] - 2
    spk_token = base.spk_emb_token if text_vocab > base.spk_emb_token else 5
    return ChatTTSConfig(
        text_vocab=text_vocab, num_audio_tokens=n_audio,
        audio_eos_id=n_audio - 1, spk_emb_token=spk_token,
        gpt=DecoderLMConfig(vocab_size=1, d_model=d, n_layers=n_layers,
                            n_heads=heads, n_kv_heads=heads, d_ff=d_ff,
                            max_seq_len=base.gpt.max_seq_len if d > 64 else 256,
                            tie_embeddings=False, dtype=torch.float32),
        dvae=DvaeConfig(
            levels=base.dvae.levels[:n_levels], groups=g, residuals=r,
            latent_dim=g * per_group,
            dec_hidden=hidden,
            dec_bottleneck=dv["conv_in"][0]["w"].shape[0],
            dec_layers=len(dv["blocks"]), n_mels=n_mels, frames_per_token=fpt),
        vocos=VocosConfig(n_mels=n_mels, dim=vdim, n_layers=len(vc["layers"]),
                          ff_mult=vc["layers"][0]["pw1"]["w"].shape[1] // vdim
                          if vc["layers"] else 3,
                          n_fft=n_fft,
                          hop=base.vocos.hop if n_fft >= 256 else n_fft // 4),
    )


class ChatTTSModel:
    """Host wrapper: text -> float32 audio @ 24 kHz on *device* (the
    reference's ``Chat.infer`` surface).  Byte-level text fallback without a
    converted tokenizer; per-session random speaker via ``sample_speaker``."""

    def __init__(self, params: Params | None = None, cfg: ChatTTSConfig | None = None,
                 seed: int = 0, vocab: dict[str, int] | None = None, device: torch.device | str = "cpu"):
        if cfg is None:
            cfg = config_from_params(params) if params is not None else ChatTTSConfig()
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            params = init_params(cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
        self.params = params
        self.vocab = vocab

    def _encode(self, text: str) -> torch.Tensor:
        if self.vocab is not None:
            ids = [self.vocab[c] for c in text if c in self.vocab] or [1]
        else:
            lo = min(self.cfg.spk_emb_token + 1, self.cfg.text_vocab - 2)
            span = max(2, self.cfg.text_vocab - lo)
            ids = [lo + (b % span) for b in text.encode("utf-8")] or [lo]
        ids = [self.cfg.spk_emb_token] + ids
        return torch.tensor(ids, dtype=torch.long)[None]

    def _budget(self, text: str) -> int:
        # ~0.08 s/char @ 2 mel frames per token, hop 256 @ 24 kHz
        seconds = (0.5 + 0.08 * len(text)) * 1.3
        samples_per_token = self.cfg.dvae.frames_per_token * self.cfg.vocos.hop
        return max(4, int(seconds * SAMPLE_RATE / samples_per_token))

    @torch.inference_mode()
    def synthesize(self, text: str, speaker=None, seed: int = 0,
                   max_tokens: int | None = None) -> np.ndarray:
        tokens = self._encode(text)
        # leave room for at least a handful of audio frames in the context
        max_text = self.cfg.gpt.max_seq_len - 16
        if tokens.shape[1] > max_text:
            tokens = tokens[:, :max_text]
        budget = max_tokens or self._budget(text)
        budget = max(1, min(budget, self.cfg.gpt.max_seq_len - tokens.shape[1] - 2))
        if speaker is None:
            speaker = sample_speaker(self.params, torch.Generator().manual_seed(seed))
        speaker = torch.as_tensor(speaker, dtype=torch.float32).to(self.device)
        cache_len = 1 << max(6, int(np.ceil(np.log2(tokens.shape[1] + budget + 2))))
        audio, n_valid = synthesize_utterance(self.params, self.cfg, tokens, speaker, budget, cache_len)
        samples = int(n_valid) * self.cfg.dvae.frames_per_token * self.cfg.vocos.hop
        return audio[0, :samples].cpu().numpy().astype(np.float32)

    def stream(self, text: str, speaker=None, seed: int = 0, chunk_tokens: int = 16):
        """Chunked emission over the one-shot synthesis (the reference's
        stream mode slices the same decode)."""
        audio = self.synthesize(text, speaker=speaker, seed=seed)
        step = chunk_tokens * self.cfg.dvae.frames_per_token * self.cfg.vocos.hop
        for i in range(0, len(audio), step):
            yield audio[i: i + step], SAMPLE_RATE


# ---------------------------------------------------------------------------
# checkpoint conversion: the JAX package's numpy converter, its tree on a device
# ---------------------------------------------------------------------------


def convert_state_dict(sd: dict, cfg: ChatTTSConfig = ChatTTSConfig(), device: torch.device | str = "cpu") -> Params:
    """ChatTTS layout (``scripts/_chattts_torch_twin.py`` documents it:
    GPT.pt's ``emb_text``/``emb_code.{k}``/weight-normed ``head_code.{k}``/
    Llama body under ``gpt(.model).layers.{i}``; Decoder.pt's GFSQ
    ``project_out`` + ``conv_in`` + ConvNeXt ``decoder_block`` + ``out_conv``
    + ``coef``; Vocos.pt's backbone+head) -> the JAX package's tree on *device*."""
    sd = HostStateDict(sd)

    def t(name):
        return np.asarray(sd[name], np.float32)

    def conv_t(w):
        return np.asarray(w, np.float32).transpose(2, 1, 0)

    def conv(prefix):
        return {"w": conv_t(t(f"{prefix}.weight")), "b": t(f"{prefix}.bias")}

    gp = "gpt.model.layers" if any(k.startswith("gpt.model.layers") for k in sd) else "gpt.layers"
    layers = []
    for i in range(cfg.gpt.n_layers):
        lp = f"{gp}.{i}"
        layers.append({
            "attn_norm": t(f"{lp}.input_layernorm.weight"),
            "wq": t(f"{lp}.self_attn.q_proj.weight").T,
            "wk": t(f"{lp}.self_attn.k_proj.weight").T,
            "wv": t(f"{lp}.self_attn.v_proj.weight").T,
            "wo": t(f"{lp}.self_attn.o_proj.weight").T,
            "mlp_norm": t(f"{lp}.post_attention_layernorm.weight"),
            "w_gate": t(f"{lp}.mlp.gate_proj.weight").T,
            "w_up": t(f"{lp}.mlp.up_proj.weight").T,
            "w_down": t(f"{lp}.mlp.down_proj.weight").T,
        })
    stacked = {k: np.stack([l[k] for l in layers]) for k in layers[0]}
    norm_key = "gpt.model.norm.weight" if "gpt.model.norm.weight" in sd else "gpt.norm.weight"

    nvq = cfg.dvae.num_vq
    if "spk_stat" in sd:  # shipped as a concatenated (2*d,) mean/std vector
        stat = np.asarray(sd["spk_stat"], np.float32).reshape(-1)
        d = stat.shape[0] // 2
        spk_mean, spk_std = stat[:d], stat[d:]
    else:
        spk_mean = t("spk_mean") if "spk_mean" in sd else np.zeros(cfg.gpt.d_model, np.float32)
        spk_std = t("spk_std") if "spk_std" in sd else np.ones(cfg.gpt.d_model, np.float32)

    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("decoder_block.")})
    n_vocos = len({k.split(".")[1] for k in sd if k.startswith("convnext.")})
    return tree_to_device({
        "gpt": {"layers": stacked, "final_norm": t(norm_key)},
        "emb_text": t("emb_text.weight"),
        "emb_code": np.stack([t(f"emb_code.{k}.weight") for k in range(nvq)]),
        "head_code": np.stack([_wn(sd, f"head_code.{k}").T for k in range(nvq)]),
        "spk_mean": spk_mean,
        "spk_std": spk_std,
        "dvae": {
            "project_out": t("project_out"),
            "conv_in": [conv("conv_in.0"), conv("conv_in.2")],
            "blocks": [
                {
                    "dw": {"w": conv_t(t(f"decoder_block.{i}.dwconv.weight")),
                           "b": t(f"decoder_block.{i}.dwconv.bias")},
                    "ln_w": t(f"decoder_block.{i}.norm.weight"),
                    "ln_b": t(f"decoder_block.{i}.norm.bias"),
                    "pw1": {"w": t(f"decoder_block.{i}.pwconv1.weight").T,
                            "b": t(f"decoder_block.{i}.pwconv1.bias")},
                    "pw2": {"w": t(f"decoder_block.{i}.pwconv2.weight").T,
                            "b": t(f"decoder_block.{i}.pwconv2.bias")},
                    "gamma": t(f"decoder_block.{i}.gamma"),
                }
                for i in range(n_blocks)
            ],
            "out_conv": conv("out_conv"),
            "coef": np.asarray(sd["coef"], np.float32).reshape(-1),
        },
        "vocos": {
            "embed": conv("embed"),
            "norm_w": t("norm.weight"), "norm_b": t("norm.bias"),
            "layers": [
                {
                    "dw": {"w": conv_t(t(f"convnext.{i}.dwconv.weight")),
                           "b": t(f"convnext.{i}.dwconv.bias")},
                    "ln_w": t(f"convnext.{i}.norm.weight"),
                    "ln_b": t(f"convnext.{i}.norm.bias"),
                    "pw1": {"w": t(f"convnext.{i}.pwconv1.weight").T,
                            "b": t(f"convnext.{i}.pwconv1.bias")},
                    "pw2": {"w": t(f"convnext.{i}.pwconv2.weight").T,
                            "b": t(f"convnext.{i}.pwconv2.bias")},
                    "gamma": t(f"convnext.{i}.gamma"),
                }
                for i in range(n_vocos)
            ],
            "final_ln_w": t("final_layer_norm.weight"),
            "final_ln_b": t("final_layer_norm.bias"),
            "head": {"w": t("head.weight").T, "b": t("head.bias")},
        },
    }, device)
