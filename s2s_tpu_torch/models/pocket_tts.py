"""Pocket-TTS-class delayed-streams TTS LM in PyTorch: the port of
``s2s_tpu/models/pocket_tts.py`` (the Moshi / delayed-streams family,
Défossez et al. 2024, arXiv:2410.00037 §3.3-3.4, which Kyutai's Pocket TTS
instantiates).

The same structure, numerics and names as the JAX package:

- **backbone**: a causal transformer at the 12.5 Hz frame rate
  (:mod:`s2s_tpu_torch.models.decoder_lm`); its input at each frame is the
  SUM of the text-stream embedding and one embedding per audio codebook,
  each audio stream delayed by ``delays[k]`` frames;
- **depformer**: a small transformer over the codebook slots of one frame:
  slot k's input is a per-slot projection of the backbone hidden plus the
  embedding of slot k-1's code (slot 0 takes ``dep_bos``); each slot has
  its own f32 head, slot 0's with the extra EOS row;
- **voice conditioning**: a voice-embedding prefix prefilled into the
  backbone cache before the frames;
- **codec**: the codes go to the Mimi decoder
  (:mod:`s2s_tpu_torch.models.mimi`) for 24 kHz waveforms.

Where the JAX package runs one ``lax.scan`` per chunk of frames, the port
loops over the frames in Python with the frame index a host int: every
branch on it (the text schedule, which delayed streams have started, the
ring slot) is decided on the host, and nothing is read back from the
device inside a chunk.  :meth:`PocketTTS.stream` reads the chunk's codes
and EOS flags back once per chunk, as the JAX wrapper does.  The
depformer's 9-slot cache is allocated once per chunk and zeroed before each
frame, where the JAX package builds a new one every frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from s2s_tpu_torch.models import decoder_lm, mimi
from s2s_tpu_torch.models.common import HostStateDict, Params, f32_weight, rms_norm, tree_to_device
from s2s_tpu_torch.models.decoder_lm import DecodeState, DecoderLMConfig, normal

SAMPLE_RATE = mimi.SAMPLE_RATE
FRAME_RATE = 12.5


@dataclass(frozen=True)
class PocketTTSConfig:
    text_vocab: int = 4000        # sentencepiece text tokens
    text_pad_id: int = 3          # stream filler once text is exhausted
    n_q: int = 8
    codebook_size: int = 2048
    audio_eos_id: int = 2048      # extra slot-0 head row: end of speech
    delays: tuple = (0, 2, 2, 2, 2, 2, 2, 2)
    backbone: DecoderLMConfig = field(default_factory=lambda: DecoderLMConfig(
        vocab_size=1, d_model=1024, n_layers=16, n_heads=16, n_kv_heads=16,
        d_ff=2816, max_seq_len=2048, rope_theta=10000.0, rms_eps=1e-8,
        tie_embeddings=False, dtype=torch.bfloat16,
    ))
    dep: DecoderLMConfig = field(default_factory=lambda: DecoderLMConfig(
        vocab_size=1, d_model=1024, n_layers=6, n_heads=16, n_kv_heads=16,
        d_ff=2816, max_seq_len=16, rope_theta=10000.0, rms_eps=1e-8,
        tie_embeddings=False, dtype=torch.bfloat16,
    ))
    mimi: mimi.MimiConfig = field(default_factory=mimi.MimiConfig)
    dtype: Any = torch.bfloat16

    @property
    def max_delay(self) -> int:
        return max(self.delays)

    @staticmethod
    def tiny() -> "PocketTTSConfig":
        small = dict(vocab_size=1, n_heads=4, n_kv_heads=4, tie_embeddings=False,
                     dtype=torch.float32)
        return PocketTTSConfig(
            text_vocab=64, text_pad_id=3, n_q=4, codebook_size=64, audio_eos_id=64,
            delays=(0, 2, 2, 2),
            backbone=DecoderLMConfig(d_model=32, n_layers=2, d_ff=64, max_seq_len=128,
                                     rms_eps=1e-8, **small),
            dep=DecoderLMConfig(d_model=32, n_layers=2, d_ff=64, max_seq_len=8,
                                rms_eps=1e-8, **small),
            mimi=mimi.MimiConfig.tiny(),
            dtype=torch.float32,
        )


def init_params(cfg: PocketTTSConfig, gen: torch.Generator, device: torch.device | str = "cpu") -> Params:
    """Random-init weights drawn from *gen* on *device*: the JAX package's
    distributions and tree, not its numbers."""
    d, dd, dt = cfg.backbone.d_model, cfg.dep.d_model, cfg.dtype

    def rnd(shape, scale=0.02):
        return normal(gen, shape, scale, dt, device)

    backbone = decoder_lm.init_params(cfg.backbone, gen, device)
    dep = decoder_lm.init_params(cfg.dep, gen, device)
    for lm in (backbone, dep):
        lm.pop("lm_head", None)
        lm.pop("embed", None)
    return {
        "backbone": backbone,
        "text_embed": rnd((cfg.text_vocab, d)),
        # +1 row per stream: the "empty" token before the delayed stream starts
        "audio_embeds": rnd((cfg.n_q, cfg.codebook_size + 1, d)),
        "dep": dep,
        "dep_in": rnd((cfg.n_q, d, dd)),
        "dep_bos": rnd((dd,)),
        "dep_embeds": rnd((cfg.n_q - 1, cfg.codebook_size, dd)),
        # slot 0 head carries the extra EOS row
        "dep_head0": rnd((dd, cfg.codebook_size + 1), dd ** -0.5),
        "dep_heads": rnd((cfg.n_q - 1, dd, cfg.codebook_size), dd ** -0.5),
        "mimi": mimi.init_decoder_params(cfg.mimi, gen, device),
    }


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


class PocketState(NamedTuple):
    lm_state: DecodeState
    ring: torch.Tensor    # (max_delay + 1, B, n_q) recent frames' codes, on the device
    frame: int            # frames generated so far (host int)


def _empty_ring(cfg: PocketTTSConfig, batch: int, device) -> torch.Tensor:
    # the "+1 row" empty-stream token = codebook_size
    return torch.full((cfg.max_delay + 1, batch, cfg.n_q), cfg.codebook_size, dtype=torch.long, device=device)


def _dep_state(cfg: PocketTTSConfig, batch: int, device) -> DecodeState:
    """The depformer's cache: one slot per codebook plus one."""
    return decoder_lm.init_decode_state(cfg.dep, batch, max_t=cfg.n_q + 1, device=device)


def _depformer_frame(params, cfg: PocketTTSConfig, hidden, state: DecodeState):
    """Expand one backbone hidden (B, D) into all n_q codes via the depth
    transformer.  *state* is the depformer cache (``_dep_state``), zeroed
    and rewound here, so one allocation serves every frame of a chunk.
    Returns (codes (B, n_q), eos (B,))."""
    dep = cfg.dep
    state.caches.k.zero_()
    state.caches.v.zero_()
    state = DecodeState(state.caches, 0)
    h_in = hidden.to(dep.dtype)

    def slot(inp, head):
        nonlocal state
        x, state = decoder_lm._hidden_step(params["dep"], dep, inp[:, None, :], state)
        h = rms_norm(x[:, 0], params["dep"]["final_norm"], dep.rms_eps)
        return torch.argmax(h.float() @ head, dim=-1)

    code = slot(h_in @ params["dep_in"][0] + params["dep_bos"][None, :], f32_weight(params, "dep_head0"))
    eos = code == cfg.audio_eos_id
    code = torch.clamp(code, 0, cfg.codebook_size - 1)
    codes = [code]
    heads = f32_weight(params, "dep_heads")
    for k in range(1, cfg.n_q):
        inp = h_in @ params["dep_in"][k] + params["dep_embeds"][k - 1][code]
        code = slot(inp, heads[k - 1])
        codes.append(code)
    return torch.stack(codes, dim=-1), eos


def _frame_input(params, cfg: PocketTTSConfig, text_tokens_bt, ring, frame: int):
    """Backbone input embedding for this frame: text stream + delayed audio
    streams.  text_tokens_bt: (B, T_text) padded schedule; ring holds the
    last max_delay+1 frames' codes; *frame* is a host int."""
    b, t_text = text_tokens_bt.shape
    if frame < t_text:
        text_tok = text_tokens_bt[:, frame].long()
    else:
        text_tok = torch.full((b,), cfg.text_pad_id, dtype=torch.long, device=ring.device)
    emb = params["text_embed"][text_tok]
    ring_len = cfg.max_delay + 1
    for k, delay in enumerate(cfg.delays):
        # code generated at frame (frame - 1 - delay) = ring slot offset
        src = frame - 1 - delay
        if src >= 0:
            tok = ring[src % ring_len, :, k]
        else:
            tok = torch.full((b,), cfg.codebook_size, dtype=torch.long, device=ring.device)
        emb = emb + params["audio_embeds"][k][tok]
    return emb.to(cfg.dtype)


def prefill_voice(params, cfg: PocketTTSConfig, voice_prefix, state: DecodeState) -> DecodeState:
    """Prefill the backbone cache with the voice-embedding prefix
    (B, T_v, D).  Returns the advanced DecodeState."""
    _, state = decoder_lm._hidden_prefill(params["backbone"], cfg.backbone, voice_prefix.to(cfg.dtype), state,
                                          voice_prefix.shape[1])
    return state


def generate_frames(params, cfg: PocketTTSConfig, text_tokens_bt, state: PocketState, n_frames: int):
    """Generate *n_frames* codec frames with no host read.
    Returns (codes (n, B, n_q), eos_flags (n, B), new state), on the device."""
    ring, lm_state, frame = state.ring, state.lm_state, state.frame
    dep_state = _dep_state(cfg, ring.shape[1], ring.device)
    all_codes, all_eos = [], []
    for _ in range(n_frames):
        emb = _frame_input(params, cfg, text_tokens_bt, ring, frame)
        x, lm_state = decoder_lm._hidden_step(params["backbone"], cfg.backbone, emb[:, None, :], lm_state)
        hidden = rms_norm(x[:, 0], params["backbone"]["final_norm"], cfg.backbone.rms_eps)
        codes, eos = _depformer_frame(params, cfg, hidden, dep_state)
        ring[frame % (cfg.max_delay + 1)] = codes
        all_codes.append(codes)
        all_eos.append(eos)
        frame += 1
    return torch.stack(all_codes), torch.stack(all_eos), PocketState(lm_state, ring, frame)


def init_state(cfg: PocketTTSConfig, batch: int = 1, cache_len: int | None = None,
               device: torch.device | str = "cpu") -> PocketState:
    lm_state = decoder_lm.init_decode_state(cfg.backbone, batch, max_t=cache_len or cfg.backbone.max_seq_len,
                                            device=device)
    return PocketState(lm_state, _empty_ring(cfg, batch, device), 0)


def synthesize_utterance(params, cfg: PocketTTSConfig, text_tokens_bt, max_frames: int,
                         voice_prefix=None, cache_len: int | None = None):
    """Whole utterance: optional voice prefill + frames + Mimi decode, with
    no host read.  Returns (audio (B, T_samples), n_valid_frames ())."""
    device = params["text_embed"].device
    text_tokens_bt = text_tokens_bt.to(device)
    state = init_state(cfg, text_tokens_bt.shape[0], cache_len, device)
    if voice_prefix is not None:
        state = state._replace(lm_state=prefill_voice(params, cfg, voice_prefix.to(device), state.lm_state))
    codes, eos, state = generate_frames(params, cfg, text_tokens_bt, state, max_frames)
    # codes: (n, B, n_q) -> (B, n, n_q); un-delay each stream so frame f of
    # the DECODED audio takes codebook k from generation step f + delays[k]
    codes_b = codes.transpose(0, 1)
    aligned = torch.stack([torch.roll(codes_b[:, :, k], -delay, dims=1) for k, delay in enumerate(cfg.delays)],
                          dim=-1)
    n_audio = max_frames - cfg.max_delay
    audio = mimi.decode(params["mimi"], cfg.mimi, aligned[:, :n_audio])
    first_eos = torch.argmax(eos[:, 0].int())
    n_valid = torch.where(eos[:, 0].any(), torch.clamp(first_eos - cfg.max_delay, min=0),
                          torch.tensor(n_audio, device=device))
    return audio, n_valid


def config_from_params(params: Params) -> PocketTTSConfig:
    """Infer the model configuration from the port's tree (its shapes, as the
    JAX package infers them from a converted checkpoint).  Heads keep the
    family ratio d_model/64; dtype follows the family (f32 at test scale);
    delays/pad ids keep the family defaults (metadata, not weights)."""
    base = PocketTTSConfig()
    text_vocab, d = params["text_embed"].shape
    n_q, cb_plus, _ = params["audio_embeds"].shape
    dd = params["dep_in"].shape[2]
    bb_layers = params["backbone"]["layers"]["wq"].shape[0]
    bb_ff = params["backbone"]["layers"]["w_gate"].shape[2]
    dep_layers = params["dep"]["layers"]["wq"].shape[0]
    dep_ff = params["dep"]["layers"]["w_gate"].shape[2]
    dtype = torch.float32 if d <= 64 else torch.bfloat16
    heads = max(1, d // 64)
    dep_heads = max(1, dd // 64)
    if d <= 64:  # tiny/test scale keeps the tiny head ratio
        heads, dep_heads = 4, 4
    delays = base.delays[:n_q] if n_q <= len(base.delays) \
        else base.delays + (base.delays[-1],) * (n_q - len(base.delays))
    mimi_cfg = mimi.MimiConfig.tiny() if d <= 64 else base.mimi
    if "mimi" in params:
        m = params["mimi"]  # the port's layouts: Conv1d (out, in, k), ConvTranspose1d (in, out, k)
        cb_size, cb_dim = m["sem_codebook"].shape
        mimi_cfg = mimi.MimiConfig(
            n_q=n_q, codebook_size=cb_size, codebook_dim=cb_dim, dim=m["sem_out_proj"].shape[1],
            t_layers=len(m["tlayers"]),
            t_heads=mimi_cfg.t_heads, t_ff=m["tlayers"][0]["w1"].shape[1],
            t_context=mimi_cfg.t_context,
            n_filters=m["final_conv"]["w"].shape[1],
            ratios=tuple(b["up"]["w"].shape[2] // 2 for b in m["blocks"]),
            kernel=m["init_conv"]["w"].shape[2],
            last_kernel=m["final_conv"]["w"].shape[2],
        )
    common = dict(vocab_size=1, tie_embeddings=False, rms_eps=1e-8, dtype=dtype)
    return PocketTTSConfig(
        text_vocab=text_vocab, n_q=n_q, codebook_size=cb_plus - 1,
        audio_eos_id=cb_plus - 1, delays=delays,
        backbone=DecoderLMConfig(d_model=d, n_layers=bb_layers, n_heads=heads,
                                 n_kv_heads=heads, d_ff=bb_ff, max_seq_len=2048, **common),
        dep=DecoderLMConfig(d_model=dd, n_layers=dep_layers, n_heads=dep_heads,
                            n_kv_heads=dep_heads, d_ff=dep_ff, max_seq_len=16, **common),
        mimi=mimi_cfg, dtype=dtype,
    )


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


class PocketTTS:
    """Host wrapper: text -> float32 audio @ 24 kHz on *device*, streaming in
    codec-frame chunks (the reference's ``TTSModel.generate_*`` surface).

    Text tokenization: with a converted sentencepiece vocab the input is
    tokenized properly; without one a byte-level fallback keeps random-init
    serving and tests running.  Voices are named (T_v, d_model) embedding
    prefixes; cloning from raw audio needs the Mimi *encoder*, which the
    decode path does not have."""

    CHUNK_FRAMES = 8  # 640 ms of audio per chunk

    def __init__(self, params: Params | None = None, cfg: PocketTTSConfig | None = None,
                 seed: int = 0, vocab: dict[str, int] | None = None, tokenizer=None,
                 device: torch.device | str = "cpu"):
        if cfg is None:
            cfg = config_from_params(params) if params is not None else PocketTTSConfig()
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            params = init_params(cfg, torch.Generator(device=self.device).manual_seed(seed), self.device)
        self.params = params
        self.vocab = vocab
        self.tokenizer = tokenizer  # SentencePiece-style object with .encode()
        self.voices: dict[str, np.ndarray] = {}
        # re-vocoded Mimi left context per chunk: the decoder's receptive
        # field, so streamed chunks match the one-shot decode exactly
        self.context_frames = mimi.decode_deficit(self.cfg.mimi)

    def add_voice(self, name: str, prefix: np.ndarray) -> None:
        self.voices[name] = np.asarray(prefix, np.float32).reshape(1, -1, self.cfg.backbone.d_model)

    def _encode(self, text: str) -> list[int]:
        if self.tokenizer is not None:
            return [i for i in self.tokenizer.encode(text) if i < self.cfg.text_vocab]
        if self.vocab is not None:
            return [self.vocab[c] for c in text if c in self.vocab]
        lo = self.cfg.text_pad_id + 1
        return [lo + (b % (self.cfg.text_vocab - lo)) for b in text.encode("utf-8")]

    def _frame_budget(self, text: str) -> int:
        # ~0.08 s per character + 0.6 s floor, x1.35 margin
        seconds = (0.6 + 0.08 * len(text)) * 1.35
        return int(np.ceil(seconds * FRAME_RATE)) + self.cfg.max_delay

    def _text_array(self, text: str) -> torch.Tensor:
        ids = self._encode(text) or [self.cfg.text_pad_id]
        return torch.tensor(ids, dtype=torch.long, device=self.device)[None]

    @torch.inference_mode()
    def stream(self, text: str, voice: str | None = None, max_frames: int | None = None):
        """Yield (float32 audio, 24000) per generated chunk until EOS or the
        frame budget runs out."""
        cfg = self.cfg
        budget = max_frames or self._frame_budget(text)
        text_arr = self._text_array(text)
        prefix = None
        prefix_len = 0
        if voice is not None and voice in self.voices:
            prefix = torch.from_numpy(self.voices[voice]).to(self.device)
            prefix_len = prefix.shape[1]
        # cache must hold voice prefix + every backbone frame, and rope
        # tables stop at max_seq_len — clamp the budget to what fits
        budget = max(1, min(budget, cfg.backbone.max_seq_len - prefix_len - 2))
        need = budget + prefix_len + 8
        cache_len = min(1 << max(6, int(np.ceil(np.log2(need)))), cfg.backbone.max_seq_len)
        state = init_state(cfg, 1, cache_len=cache_len, device=self.device)
        if prefix is not None:
            state = state._replace(lm_state=prefill_voice(self.params, cfg, prefix, state.lm_state))
        history = np.zeros((1, 0, cfg.n_q), np.int64)
        emitted = 0  # audio frames already yielded
        done_at = None
        generated = 0
        while generated < budget and done_at is None:
            n = min(self.CHUNK_FRAMES, budget - generated)
            codes, eos, state = generate_frames(self.params, cfg, text_arr, state, n)
            generated += n
            # the chunk's one read back: codes and EOS flags together
            host = torch.cat([codes[:, 0, :], eos[:, :1].long()], dim=1).cpu().numpy()
            codes_np, eos_np = host[:, :-1], host[:, -1].astype(bool)
            history = np.concatenate([history, codes_np[None]], axis=1)
            if eos_np.any():
                done_at = generated - n + int(np.argmax(eos_np))
            # un-delay: audio frame f needs codebook k from step f + delays[k]
            ready = (done_at if done_at is not None else generated) - cfg.max_delay
            if done_at is not None:
                ready = max(ready, 0)
            if ready <= emitted:
                continue
            aligned = np.stack(
                [history[0, emitted + cfg.delays[k]: ready + cfg.delays[k], k]
                 for k in range(cfg.n_q)], axis=-1)
            lo = max(0, emitted - self.context_frames)
            ctx = np.stack(
                [history[0, lo + cfg.delays[k]: emitted + cfg.delays[k], k]
                 for k in range(cfg.n_q)], axis=-1)
            chunk_codes = torch.from_numpy(np.concatenate([ctx, aligned], axis=0)).to(self.device)[None]
            wav = mimi.decode(self.params["mimi"], cfg.mimi, chunk_codes)[0]
            audio = wav[ctx.shape[0] * cfg.mimi.hop:].cpu().numpy()
            emitted = ready
            if len(audio):
                yield audio.astype(np.float32), SAMPLE_RATE

    def synthesize(self, text: str, voice: str | None = None,
                   max_frames: int | None = None) -> np.ndarray:
        parts = [a for a, _ in self.stream(text, voice=voice, max_frames=max_frames)]
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)


# ---------------------------------------------------------------------------
# checkpoint conversion: the JAX package's numpy converter, its tree on a device
# ---------------------------------------------------------------------------


def convert_state_dict(sd: dict, cfg: PocketTTSConfig = PocketTTSConfig(), device: torch.device | str = "cpu") -> Params:
    """moshi-style delayed-streams LM layout -> the JAX package's tree on *device*.  Expected keys
    (mirrored by ``scripts/_pocket_torch_twin.py``):

    - ``text_emb.weight``; ``emb.{k}.weight`` (audio streams, each with the
      trailing "empty" row)
    - ``transformer.layers.{i}.{self_attn.{q,k,v,o}_proj|norm1|norm2|
      gating.linear_in/linear_out}.weight`` — backbone (rmsnorm weights
      under ``norm{1,2}.alpha`` or ``.weight``); ``out_norm.alpha|weight``
    - ``depformer_in.{k}.weight``; ``depformer_emb.{k}.weight``;
      ``depformer.layers.{i}...`` (same block layout); ``depformer_norm``;
      ``linears.{k}.weight`` (per-slot heads; slot 0 carries the EOS row)
    - the Mimi decoder converts separately (``--family mimi``).
    """
    sd = HostStateDict(sd)

    def t(name):
        return np.asarray(sd[name], np.float32)

    def norm_w(prefix):
        for suffix in (".alpha", ".weight"):
            if prefix + suffix in sd:
                w = np.asarray(sd[prefix + suffix], np.float32)
                return w.reshape(-1)  # moshi stores alpha as (1, 1, d)
        raise KeyError(prefix)

    def lm_tree(prefix, lm_cfg: DecoderLMConfig, final_norm_key):
        layers = []
        for i in range(lm_cfg.n_layers):
            lp = f"{prefix}.layers.{i}"
            if f"{lp}.self_attn.in_proj_weight" in sd:
                wq, wk, wv = np.split(t(f"{lp}.self_attn.in_proj_weight"), 3, axis=0)
            else:
                wq = t(f"{lp}.self_attn.q_proj.weight")
                wk = t(f"{lp}.self_attn.k_proj.weight")
                wv = t(f"{lp}.self_attn.v_proj.weight")
            wo_key = (f"{lp}.self_attn.out_proj.weight"
                      if f"{lp}.self_attn.out_proj.weight" in sd
                      else f"{lp}.self_attn.o_proj.weight")
            gate_key = (f"{lp}.gating.linear_in.weight"
                        if f"{lp}.gating.linear_in.weight" in sd else None)
            if gate_key:
                # moshi gating: linear_in packs [gate; up] rows
                w_in = t(gate_key)
                w_gate, w_up = np.split(w_in, 2, axis=0)
                w_down = t(f"{lp}.gating.linear_out.weight")
            else:
                w_gate = t(f"{lp}.mlp.gate_proj.weight")
                w_up = t(f"{lp}.mlp.up_proj.weight")
                w_down = t(f"{lp}.mlp.down_proj.weight")
            layers.append({
                "attn_norm": norm_w(f"{lp}.norm1"),
                "wq": wq.T, "wk": wk.T, "wv": wv.T, "wo": t(wo_key).T,
                "mlp_norm": norm_w(f"{lp}.norm2"),
                "w_gate": w_gate.T, "w_up": w_up.T, "w_down": w_down.T,
            })
        stacked = {k: np.stack([l[k] for l in layers]) for k in layers[0]}
        return {"layers": stacked, "final_norm": norm_w(final_norm_key)}

    n_q = cfg.n_q
    p: Params = {
        "backbone": lm_tree("transformer", cfg.backbone, "out_norm"),
        "text_embed": t("text_emb.weight"),
        "audio_embeds": np.stack([t(f"emb.{k}.weight") for k in range(n_q)]),
        "dep": lm_tree("depformer", cfg.dep, "depformer_norm"),
        "dep_in": np.stack([t(f"depformer_in.{k}.weight").T for k in range(n_q)]),
        "dep_bos": t("depformer_bos") if "depformer_bos" in sd
        else np.zeros(cfg.dep.d_model, np.float32),
        "dep_embeds": np.stack([t(f"depformer_emb.{k}.weight") for k in range(n_q - 1)]),
        "dep_head0": t("linears.0.weight").T,
        "dep_heads": np.stack([t(f"linears.{k}.weight").T for k in range(1, n_q)]),
    }
    return tree_to_device(p, device)
