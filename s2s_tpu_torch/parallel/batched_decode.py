"""Cross-session batched decoding with per-slot positions (port of the
serving programs of ``s2s_tpu/parallel/batched_decode.py``).

N concurrent sessions decode through one program although each sits at its
own position: ``pos`` is a (B,) device tensor, rope tables are gathered per
row, and each step attends over [frozen cache keys < chunk-start pos | the
chunk's tail keys] in one softmax (:func:`s2s_tpu_torch.ops.decode_attention.concat_attention`,
the hand-written CUDA kernel on the card).  Fresh K/V go into a small
per-chunk tail buffer and are blended into the caches once at chunk end, as
in the JAX package's tail design.

Only what the serving scheduler dispatches is ported: the slot prefills and
the tail chunks (gathered steady lane, single-slot priority lane, fused
prefill + first chunk).  The legacy per-step-write and fused-layer variants
are not (ROADMAP).

Every program takes an optional ``tp`` group (``mesh.TPGroup``) for
tensor-parallel serving: the parameters are then one rank's shard, the
caches hold the rank's kv heads (:func:`init_multi_state`), and the
collectives are :mod:`~s2s_tpu_torch.models.decoder_lm`'s (row-parallel
sums, the split embedding and the gathered logits), so the tokens each
program returns are the same on every rank.

Unlike the JAX programs, which return fresh arrays under donation, these
update the KV caches and positions IN PLACE and return the same state: a
slot's cache row is never copied for the priority lane, and the gathered
lane copies only the rows it gathers.  Every tensor a program returns besides
the state (tokens, emitted masks, next tokens) is freshly allocated, so a
later in-place dispatch cannot overwrite it before the host reads it.  The
slot index and the prompt length are host ints (the scheduler knows them),
the step index of a chunk a Python int; nothing reads the device back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from s2s_tpu_torch.models import decoder_lm
from s2s_tpu_torch.models.common import (
    KVCache,
    Params,
    apply_rope,
    layer_slice,
    linear,
    n_stacked,
    rms_norm,
    rope_frequencies,
    swiglu,
)
from s2s_tpu_torch.models.decoder_lm import (
    DecoderLMConfig,
    _logits,
    embed_tokens,
    local_kv_heads,
    out_width,
    row_parallel,
)
from s2s_tpu_torch.ops.decode_attention import concat_attention


class MultiDecodeState(NamedTuple):
    """Batched decode carry: stacked caches (L, B, KV, T, hd) and per-slot
    positions (B,) int32, both on the device and updated in place."""

    caches: KVCache
    pos: torch.Tensor


def init_multi_state(cfg: DecoderLMConfig, batch: int, max_t: int | None = None,
                     device: torch.device | str = "cpu", tp=None) -> MultiDecodeState:
    """Zero caches and positions; under tensor parallelism the caches hold
    this rank's kv heads."""
    max_t = max_t or cfg.max_seq_len
    shape = (cfg.n_layers, batch, local_kv_heads(cfg, tp), max_t, cfg.head_dim)
    return MultiDecodeState(
        KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.zeros(shape, dtype=cfg.dtype, device=device)),
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _slot_row(state: MultiDecodeState, slot: int) -> MultiDecodeState:
    """Views of one slot's cache row (L, 1, KV, T, hd) and position (1,):
    writes through them land in the batched state."""
    return MultiDecodeState(
        KVCache(state.caches.k[:, slot : slot + 1], state.caches.v[:, slot : slot + 1]),
        state.pos[slot : slot + 1],
    )


def _gather_rows(state: MultiDecodeState, slot_ids: torch.Tensor) -> MultiDecodeState:
    """Copies of the gathered rows (the steady lane's compact batch)."""
    return MultiDecodeState(
        KVCache(state.caches.k[:, slot_ids], state.caches.v[:, slot_ids]), state.pos[slot_ids]
    )


def _scatter_rows(state: MultiDecodeState, slot_ids: torch.Tensor, rows: MultiDecodeState) -> None:
    """Write gathered rows back; duplicate ids carry bit-equal rows."""
    state.caches.k[:, slot_ids] = rows.caches.k
    state.caches.v[:, slot_ids] = rows.caches.v
    state.pos[slot_ids] = rows.pos


def _prefill_row_caches(params: Params, cfg: DecoderLMConfig, x, row: MultiDecodeState, tp=None):
    """Causal prefill of (1, t, D) embeddings into a slot row's caches from
    position 0; returns the hidden states (1, t, D).  Keys past the prompt
    bucket keep old values, masked until the row's next chunk overwrites them."""
    t = x.shape[1]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, x.device)
    max_t = row.caches.k.shape[3]
    mask = decoder_lm.causal_mask(t, max_t, 0, x.device) & decoder_lm.length_mask(max_t, t, x.device)
    hidden, _ = decoder_lm._run_blocks(x, params, cfg, row.caches, 0, cos[:t], sin[:t], mask, tp)
    return hidden


def prefill_slot(params: Params, cfg: DecoderLMConfig, tokens, prompt_len: int,
                 state: MultiDecodeState, slot: int, tp=None):
    """Prefill ONE slot from a (1, T_bucket) right-padded prompt, in place;
    other rows are untouched.  Returns (first token () int32, state)."""
    row = _slot_row(state, slot)
    x = embed_tokens(params["embed"], tokens, cfg, tp).to(cfg.dtype)
    hidden = _prefill_row_caches(params, cfg, x, row, tp)
    logits = _logits(hidden[:, prompt_len - 1 : prompt_len], params, cfg, tp)[:, 0]
    row.pos.fill_(prompt_len)
    return torch.argmax(logits[0], dim=-1).to(torch.int32), state


def prefill_slot_embeds(params: Params, cfg: DecoderLMConfig, embeds, prompt_len,
                        state: MultiDecodeState, slot: int, tp=None) -> MultiDecodeState:
    """Prefill ONE slot from (1, T, D) prompt embeddings (the TTS talker
    prompt [speaker, text...]).  ``prompt_len`` is an int or a 0-dim device
    tensor.  Returns the state."""
    row = _slot_row(state, slot)
    _prefill_row_caches(params, cfg, embeds.to(cfg.dtype), row, tp)
    row.pos.copy_(torch.as_tensor(prompt_len, dtype=torch.int32, device=row.pos.device).reshape(1))
    return state


def init_tail(cfg: DecoderLMConfig, batch: int, n: int, device: torch.device | str = "cpu",
              n_kv: int | None = None):
    """Fresh per-chunk tail buffers (L, B, KV, n, hd) x2; *n_kv* (default
    ``cfg.n_kv_heads``) is the caches' kv heads."""
    shape = (cfg.n_layers, batch, n_kv or cfg.n_kv_heads, n, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def tail_hidden_step(params: Params, cfg: DecoderLMConfig, embeds, kc, vc, pos0,
                     tail_k, tail_v, n_act, act, i: int, tp=None):
    """One step over (B, D) embeddings against FROZEN caches kc/vc
    (L, B, KV, T, hd) and this chunk's tail (L, B, KV, n, hd), written in place
    at step index *i*.  pos0: (B,) chunk-start positions; n_act: (B,) active
    steps so far; act: (B,) bool.  Returns (pre-final-norm hidden (B, D),
    tail_k, tail_v).  The shared step of the LM chunk and the talker chunk.
    Head counts are the weights' (a rank's heads under tensor parallelism)."""
    b = embeds.shape[0]
    hd = cfg.head_dim
    n_q, n_kv = out_width(params["layers"]["wq"]) // hd, out_width(params["layers"]["wk"]) // hd
    cos_full, sin_full = rope_frequencies(hd, cfg.max_seq_len, cfg.rope_theta, embeds.device)
    pos = (pos0 + n_act).long()  # per-row query position (frozen after EOS)
    cos_b = cos_full[pos][:, None, None, :]  # (B, 1, 1, hd/2)
    sin_b = sin_full[pos][:, None, None, :]
    # cache keys < pos0 (this chunk's keys live in the tail); tail keys over
    # the row's active prefix, including this step's write for active rows
    tail_len = (n_act + act.to(torch.int32)).to(torch.int32)
    x = embeds[:, None, :].to(cfg.dtype)
    layers = params["layers"]
    for l in range(n_stacked(layers)):
        lp = layer_slice(layers, l)
        hn = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = linear(hn, lp["wq"]).reshape(b, 1, n_q, hd)
        k = linear(hn, lp["wk"]).reshape(b, 1, n_kv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
            k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
        q = apply_rope(q.transpose(1, 2), cos_b, sin_b)  # (B, H, 1, hd)
        k = apply_rope(k.transpose(1, 2), cos_b, sin_b)
        v = linear(hn, lp["wv"]).reshape(b, 1, n_kv, hd).transpose(1, 2)
        tail_k[l, :, :, i] = k[:, :, 0]
        tail_v[l, :, :, i] = v[:, :, 0]
        attn = concat_attention(q[:, :, 0].contiguous(), kc[l], vc[l], tail_k[l], tail_v[l], pos0, tail_len)
        x = x + row_parallel(linear(attn.reshape(b, 1, n_q * hd), lp["wo"]), lp["wo"], cfg.n_heads * hd, tp)
        hn = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + row_parallel(swiglu(hn, lp["w_gate"], lp["w_up"], lp["w_down"]), lp["w_down"], cfg.d_ff, tp)
    return x[:, 0], tail_k, tail_v


def blend_tail_into_state(state: MultiDecodeState, tail_k, tail_v, n_act) -> MultiDecodeState:
    """One cache write per chunk, in place: each row's tail prefix (slots
    j < n_act[b]) lands at its chunk-start position, which is clamped to
    T - n as the JAX ``dynamic_update_slice`` clamps it; positions advance by
    the active-step count."""
    _, b, _, t, _ = state.caches.k.shape
    n = tail_k.shape[3]
    dev = tail_k.device
    start = torch.clamp(state.pos.long(), max=t - n)
    idx = start[:, None] + torch.arange(n, device=dev)[None, :]  # (B, n), distinct per row
    rows = torch.arange(b, device=dev)[:, None].expand(b, n)
    keep = (torch.arange(n, device=dev)[None, :] < n_act[:, None])[:, :, None, None, None]
    for cache, tail in ((state.caches.k, tail_k), (state.caches.v, tail_v)):
        old = cache[:, rows, :, idx]  # (B, n, L, KV, hd)
        cache[:, rows, :, idx] = torch.where(keep, tail.permute(1, 3, 0, 2, 4), old)
    state.pos.add_(n_act.to(torch.int32))
    return state


def decode_chunk_tail(params: Params, cfg: DecoderLMConfig, tokens, state: MultiDecodeState,
                      n_tokens: int, eos_id: int, active, tp=None):
    """Greedily decode *n_tokens* for every active row: emits each step's
    input token; a row deactivates after emitting ``eos_id``; idle rows
    repeat their token under an inactive mask.  Returns (toks (n, B),
    emitted (n, B), next tokens (B,), state, active (B,))."""
    b = tokens.shape[0]
    kc, vc, pos0 = state.caches.k, state.caches.v, state.pos  # frozen until the blend
    tail_k, tail_v = init_tail(cfg, b, n_tokens, tokens.device, kc.shape[2])
    n_act = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    tok, act = tokens, active
    toks, emitted = [], []
    for i in range(n_tokens):
        x = embed_tokens(params["embed"], tok, cfg, tp).to(cfg.dtype)
        hidden, tail_k, tail_v = tail_hidden_step(params, cfg, x, kc, vc, pos0, tail_k, tail_v, n_act, act, i, tp)
        logits = _logits(hidden[:, None, :], params, cfg, tp)[:, 0]
        nxt = torch.where(act, torch.argmax(logits, dim=-1).to(torch.int32), tok)
        toks.append(tok)
        emitted.append(act)
        n_act = n_act + act.to(torch.int32)
        act = act & (tok != eos_id)
        tok = nxt
    state = blend_tail_into_state(state, tail_k, tail_v, n_act)
    return torch.stack(toks), torch.stack(emitted), tok, state, act


def decode_chunk_gathered_tail(params: Params, cfg: DecoderLMConfig, tokens, state: MultiDecodeState,
                               n_tokens: int, eos_id: int, slot_ids, tp=None):
    """The serving steady lane: a tail chunk over a compact gathered batch
    of ``W = len(slot_ids)`` slots, padded by repeating a valid id (duplicate
    rows compute bit-equal values, so their scatter is benign).  Returns
    (toks (n, W), emitted (n, W), next tokens (W,), state)."""
    rows = _gather_rows(state, slot_ids)
    active = torch.ones(slot_ids.shape, dtype=torch.bool, device=tokens.device)
    toks, emitted, tok, rows, _ = decode_chunk_tail(params, cfg, tokens, rows, n_tokens, eos_id, active, tp)
    _scatter_rows(state, slot_ids, rows)
    return toks, emitted, tok, state


def decode_chunk_slot_tail(params: Params, cfg: DecoderLMConfig, token, state: MultiDecodeState,
                           n_tokens: int, eos_id: int, slot: int, tp=None):
    """The serving priority lane: *n_tokens* greedy steps for ONE slot at
    batch-1 cost, on views of the slot's row (other rows untouched).  token:
    () int32.  Returns (toks (n,), emitted (n,), next token (), state)."""
    active = torch.ones((1,), dtype=torch.bool, device=token.device)
    toks, emitted, tok, _, _ = decode_chunk_tail(params, cfg, token.reshape(1), _slot_row(state, slot),
                                                 n_tokens, eos_id, active, tp)
    return toks[:, 0], emitted[:, 0], tok[0], state


def prefill_and_chunk_slot_tail(params: Params, cfg: DecoderLMConfig, tokens, prompt_len: int,
                                state: MultiDecodeState, slot: int, n_tokens: int, eos_id: int, tp=None):
    """Fused prefill + first priority chunk for one slot (one dispatch for a
    new turn's prompt and its first-sentence tokens)."""
    token, state = prefill_slot(params, cfg, tokens, prompt_len, state, slot, tp)
    return decode_chunk_slot_tail(params, cfg, token, state, n_tokens, eos_id, slot, tp)
