"""Decoder-only language model (port of ``s2s_tpu/models/decoder_lm.py``).

Llama/SmolLM2/Qwen3 layout: RMSNorm, interleaved-pair RoPE, GQA attention,
SwiGLU MLP, optional tied embeddings and Qwen3 q/k norms.  Serves the local
LLM (SmolLM2-1.7B) and, through :func:`_hidden_prefill` / :func:`_hidden_step`,
the Qwen3-TTS talker and code predictor.

Layer weights stay STACKED with a leading layer axis, as in the JAX package
(and in its converted ``.npz`` checkpoints); the layer loop indexes them per
layer where JAX runs a ``lax.scan``.  The KV cache is written in place.
The decode position is a host integer: the serving loops here are eager, so
it costs no device sync.

The training and scoring path (:func:`forward`, :func:`loss_fn`,
:func:`sgd_train_step`) runs the same layer loop without a cache; gradients
come from ``torch.autograd`` and nothing on it writes in place.  Its
parameters may be plain tensors or DTensors placed on a ``("data",
"model")`` mesh per :func:`param_shardings`
(:mod:`s2s_tpu_torch.parallel.mesh`); the constants the forward makes are
then lifted onto the parameters' mesh.  :func:`convert_hf_state_dict` maps a
Hugging Face Llama/SmolLM2 checkpoint onto the parameter tree.

Tensor-parallel serving runs the same blocks on one rank's shard of the
tree (``mesh.local_shard`` of :func:`param_shardings`, plain tensors) with
a ``tp`` group (``mesh.TPGroup``): head counts come from the shard's
widths, the row-parallel ``wo`` and ``w_down`` outputs are summed across
ranks, a vocabulary-split embedding is looked up rank by rank and summed,
and vocabulary-split logits are gathered before anyone takes an argmax.
Each of these engages only where the weight at hand is split, so with
``tp=None``, or a group of one rank, nothing changes.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from s2s_tpu_torch.models.common import (
    KVCache,
    P,
    Params,
    apply_rope,
    attention,
    causal_mask,
    device_tensor,
    host_array,
    length_mask,
    linear,
    rms_norm,
    rope_frequencies,
    stack_layers,
    swiglu,
    unstack_layers,
)
from s2s_tpu_torch.ops.quant import QUANT_TYPES, Quant4Weight


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


def param_shardings(cfg: DecoderLMConfig) -> Params:
    """Megatron-style specs over a ("data", "model") mesh (stacked layers get
    a leading replicated layer axis): columns on "model" for the q/k/v, gate
    and up projections, rows for the output and down projections, the
    vocabulary for the embedding (and an untied head's columns)."""
    layers = {
        "attn_norm": P(None, None),
        "wq": P(None, None, "model"),
        "wk": P(None, None, "model"),
        "wv": P(None, None, "model"),
        "wo": P(None, "model", None),
        "mlp_norm": P(None, None),
        "w_gate": P(None, None, "model"),
        "w_up": P(None, None, "model"),
        "w_down": P(None, "model", None),
    }
    if cfg.qk_norm:
        layers["q_norm"] = P(None, None)
        layers["k_norm"] = P(None, None)
    specs: Params = {
        "embed": P("model", None),
        "layers": layers,
        "final_norm": P(),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    return specs


def local_kv_heads(cfg: DecoderLMConfig, tp=None) -> int:
    """The kv heads one rank holds (all of them without tensor parallelism)."""
    return cfg.n_kv_heads // (tp.size if tp is not None else 1)


class DecodeState(NamedTuple):
    """Decode carry: stacked per-layer caches (L, B, n_kv, max_t, head_dim),
    written in place, and the next write position (host int)."""

    caches: KVCache
    pos: int


def init_decode_state(cfg: DecoderLMConfig, batch: int, max_t: int | None = None,
                      device: torch.device | str = "cpu", tp=None) -> DecodeState:
    """Zero caches; under tensor parallelism, for this rank's kv heads."""
    max_t = max_t or cfg.max_seq_len
    shape = (cfg.n_layers, batch, local_kv_heads(cfg, tp), max_t, cfg.head_dim)
    caches = KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                     torch.zeros(shape, dtype=cfg.dtype, device=device))
    return DecodeState(caches, 0)


def out_width(w) -> int:
    """Output columns of a weight (a tensor or a quantized leaf; stacked or not)."""
    return w.scale.shape[-1] if isinstance(w, QUANT_TYPES) else w.shape[-1]


def in_width(w) -> int:
    """Input rows of a weight (a packed int4 payload holds two a byte)."""
    if isinstance(w, QUANT_TYPES):
        return w[0].shape[-2] * (2 if isinstance(w, Quant4Weight) else 1)
    return w.shape[-2]


def row_parallel(y, w, full_in: int, tp):
    """*y* = x @ *w*, summed across the ranks of *tp* when *w* holds only a
    block of its *full_in* input rows (a row-parallel shard)."""
    return y if tp is None or in_width(w) == full_in else tp.all_reduce(y)


def embed_tokens(table, tokens, cfg: DecoderLMConfig, tp=None):
    """``table[tokens]``.  A vocabulary-split table (fewer rows than
    ``cfg.vocab_size``, rank r holding block r) looks up the tokens in its
    block, zeros elsewhere, and the rows are summed across ranks: exact."""
    tokens = tokens.long()
    rows = table.shape[0]
    if tp is None or rows == cfg.vocab_size:
        return table[tokens]
    local = tokens - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    found = table[local.clamp(0, rows - 1)]
    return tp.all_reduce(torch.where(inside[..., None], found, torch.zeros_like(found)))


def _block(x, lp: Params, cfg: DecoderLMConfig, cache: KVCache | None, pos, cos, sin, mask, tp=None):
    """One transformer block over UNSTACKED layer params; returns (x, cache).
    Head counts are the weights' (a rank's heads under tensor parallelism)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    n_q, n_kv = out_width(lp["wq"]) // hd, out_width(lp["wk"]) // hd
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = _split_heads(linear(h, lp["wq"]), n_q, hd)
    k = _split_heads(linear(h, lp["wk"]), n_kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = _split_heads(linear(h, lp["wv"]), n_kv, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        cache = cache.update(k, v, pos)
        k_all, v_all = cache.k, cache.v
    else:
        k_all, v_all = k, v
    attn = _attention(q, k_all, v_all, mask)
    attn = attn.transpose(1, 2).reshape(b, t, n_q * hd)
    x = x + row_parallel(linear(attn, lp["wo"]), lp["wo"], cfg.n_heads * hd, tp)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + row_parallel(swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), lp["w_down"], cfg.d_ff, tp), cache


def _dtensor(t):
    """``torch.distributed.tensor`` when *t* is a DTensor (parameters placed
    on a mesh), else None: a DTensor can exist only once that module is
    imported, so the single-device path never imports it."""
    module = sys.modules.get("torch.distributed.tensor")
    return module if module is not None and isinstance(t, module.DTensor) else None


def _split_heads(x, n: int, head_dim: int):
    """``x.reshape(b, t, n, head_dim)``.  On a DTensor whose features are
    split on a mesh axis that does not divide *n* (more ranks on "model"
    than kv heads), they are first gathered on that axis: DTensor does not
    split a head across ranks."""
    dtensor = _dtensor(x)
    if dtensor is not None:
        mesh = x.device_mesh
        placements = [dtensor.Replicate() if p == dtensor.Shard(2) and n % mesh.size(i) else p
                      for i, p in enumerate(x.placements)]
        if placements != list(x.placements):
            x = x.redistribute(mesh, placements)
    return x.reshape(*x.shape[:2], n, head_dim)


def _placed(dtensor, local: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """A DTensor of global *shape* (contiguous) from each rank's *local* shard."""
    return dtensor.DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                                      stride=torch.empty(shape, device="meta").stride())


def _attention(q, k, v, mask):
    """:func:`attention`; on DTensors (the training path on a mesh) shard by
    shard.  Rows and heads are independent: q, k and v are placed with their
    rows as q's on "data" and their heads split on "model" (whole heads and
    their kv heads on each rank, the megatron layout; a partial sum from the
    projections is reduced here), and each rank attends its own shard.
    Heads split only where the "model" axis divides the kv heads (and so
    the q heads, a multiple of them): else a rank's q heads would meet
    another group's kv heads, so there every rank of "model" attends all
    heads.  DTensor's batched product would merge the row and head dims,
    split over two mesh axes, which not every release propagates."""
    dtensor = _dtensor(q)
    if dtensor is None:
        return attention(q, k, v, mask)
    mesh, rows, shape = q.device_mesh, dtensor.Shard(0), q.shape
    names = mesh.mesh_dim_names
    heads = dtensor.Shard(1) if k.shape[1] % mesh.size(names.index("model")) == 0 else dtensor.Replicate()
    placements = [heads if axis == "model" else (rows if p == rows else dtensor.Replicate())
                  for axis, p in zip(names, q.placements)]
    q, k, v = (t.redistribute(mesh, placements).to_local() for t in (q, k, v))
    return _placed(dtensor, attention(q, k, v, mask.full_tensor()), mesh, placements, shape)


def _embed(table, tokens):
    """``table[tokens]``; on DTensors, rank by rank: the vocabulary shards
    gathered into the whole table, each rank's tokens looked up in it, and
    the rows placed as the tokens are.  The table's gradient from ranks that
    saw other rows is a partial sum on those axes, reduced by DTensor; its
    batched scatter (the lookup's backward) would otherwise go through
    sharding rules that not every release has."""
    dtensor = _dtensor(table)
    if dtensor is None:
        return table[tokens]
    mesh = table.device_mesh
    seen = [dtensor.Partial() if isinstance(p, dtensor.Shard) else dtensor.Replicate() for p in tokens.placements]
    whole = table.redistribute(mesh, [dtensor.Replicate()] * mesh.ndim).to_local(grad_placements=seen)
    return _placed(dtensor, whole[tokens.to_local()], mesh, tokens.placements, (*tokens.shape, table.shape[1]))


def _run_blocks(x, params: Params, cfg: DecoderLMConfig, caches: KVCache | None, pos, cos, sin, mask, tp=None):
    """The layer loop (the JAX package's ``_scan_blocks``)."""
    for i, lp in enumerate(unstack_layers(params["layers"])):
        cache = KVCache(caches.k[i], caches.v[i]) if caches is not None else None
        x, _ = _block(x, lp, cfg, cache, pos, cos, sin, mask, tp)
    return x, caches


def _logits(x, params: Params, cfg: DecoderLMConfig, tp=None) -> torch.Tensor:
    """f32 logits (..., V); a vocabulary-split head's are gathered across
    the ranks of *tp* (exact)."""
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, QUANT_TYPES):
        logits = linear(x, head).float()
    else:
        logits = torch.matmul(x, head.to(x.dtype)).float()
    if tp is not None and logits.shape[-1] != cfg.vocab_size:
        logits = tp.gather_last(logits, cfg.vocab_size)
    return logits


def _rope(cfg: DecoderLMConfig, device):
    return rope_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device)


def _on_mesh_of(ref: torch.Tensor, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """*tensors* (the rope tables, masks, tokens and targets the forward and
    the loss make or take) lifted to replicated DTensors on the mesh of
    *ref*, a parameter, when the parameters are DTensors: DTensor refuses to
    mix a plain tensor with a DTensor.  Unchanged on the single-device path
    and for tensors that already are DTensors."""
    dtensor = _dtensor(ref)
    if dtensor is None:
        return tensors
    mesh = ref.device_mesh
    return tuple(t if isinstance(t, dtensor.DTensor)
                 else dtensor.DTensor.from_local(t.to(ref.device), mesh, [dtensor.Replicate()] * mesh.ndim,
                                                 run_check=False)
                 for t in tensors)


def _hidden_full(params: Params, cfg: DecoderLMConfig, x) -> torch.Tensor:
    """The causal layer stack over a full sequence x (B, T, D), no cache."""
    t = x.shape[1]
    cos_full, sin_full = _rope(cfg, x.device)
    cos, sin, mask = _on_mesh_of(params["embed"], cos_full[:t], sin_full[:t], causal_mask(t, t, 0, x.device))
    x, _ = _run_blocks(x, params, cfg, None, None, cos, sin, mask)
    return x


def forward(params: Params, cfg: DecoderLMConfig, tokens, positions=None) -> torch.Tensor:
    """Full-sequence causal forward (training / scoring). tokens: (B, T) int.
    Returns float32 logits (B, T, V).  Positions are 0..T-1: *positions* is
    accepted and unused, as in the JAX package."""
    (tokens,) = _on_mesh_of(params["embed"], tokens.long())
    return _logits(_hidden_full(params, cfg, _embed(params["embed"], tokens).to(cfg.dtype)), params, cfg)


def forward_embeds(params: Params, cfg: DecoderLMConfig, embeds) -> torch.Tensor:
    """Full-sequence causal forward over precomputed embeddings (B, T, D),
    the multimodal splice path. Returns float32 logits (B, T, V)."""
    (embeds,) = _on_mesh_of(params["embed"], embeds)
    return _logits(_hidden_full(params, cfg, embeds.to(cfg.dtype)), params, cfg)


def _hidden_prefill(params: Params, cfg: DecoderLMConfig, x, state: DecodeState, prompt_len, tp=None):
    """x: (B, T, D) right-padded prompt embeddings; prompt_len: int or (B,)
    tensor of valid lengths.  Returns (last valid hidden (B, D), state)."""
    b, t, _ = x.shape
    cos_full, sin_full = _rope(cfg, x.device)
    max_t = state.caches.k.shape[3]
    mask = causal_mask(t, max_t, 0, x.device) & length_mask(max_t, t, x.device)
    x, caches = _run_blocks(x, params, cfg, state.caches, 0, cos_full[:t], sin_full[:t], mask, tp)
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


def prefill_embeds(params: Params, cfg: DecoderLMConfig, embeds, state: DecodeState, prompt_len):
    """Like :func:`prefill` over precomputed embeddings; returns the last
    hidden state (B, D) after final_norm (the caller applies its own head)."""
    last, state = _hidden_prefill(params, cfg, embeds.to(cfg.dtype), state, prompt_len)
    return rms_norm(last, params["final_norm"], cfg.rms_eps), state


def _hidden_step(params: Params, cfg: DecoderLMConfig, x, state: DecodeState, tp=None):
    """x: (B, 1, D) one step of embeddings at ``state.pos``."""
    cos_full, sin_full = _rope(cfg, x.device)
    pos = state.pos
    max_t = state.caches.k.shape[3]
    mask = length_mask(max_t, pos + 1, x.device)
    x, caches = _run_blocks(x, params, cfg, state.caches, pos,
                            cos_full[pos : pos + 1], sin_full[pos : pos + 1], mask, tp)
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


def loss_fn(params: Params, cfg: DecoderLMConfig, tokens, targets, mask) -> torch.Tensor:
    """Mean next-token cross-entropy over *mask* (training path)."""
    logits = forward(params, cfg, tokens)
    targets, mask = _on_mesh_of(params["embed"], targets.long(), mask)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def value_and_grad(params: Params, cfg: DecoderLMConfig, tokens, targets, mask) -> tuple[torch.Tensor, Params]:
    """(loss, gradients): the loss of :func:`loss_fn` and, by
    ``torch.autograd``, its gradient for every floating leaf (None for the
    others).  The parameters stay as they are: the loss is taken over
    detached leaves that require grad."""
    leaves, spec = pytree.tree_flatten(params)
    diff = [p.is_floating_point() for p in leaves]
    live = [p.detach().requires_grad_(True) if d else p for p, d in zip(leaves, diff)]
    with torch.enable_grad():
        loss = loss_fn(pytree.tree_unflatten(live, spec), cfg, tokens, targets, mask)
        grads = iter(torch.autograd.grad(loss, [p for p, d in zip(live, diff) if d]))
    return loss.detach(), pytree.tree_unflatten([next(grads) if d else None for d in diff], spec)


def sgd_train_step(params: Params, cfg: DecoderLMConfig, tokens, targets, mask, lr: float = 1e-4):
    """One SGD step: (loss, new params).  Floating leaves take
    ``(p - lr * g) in f32``, cast back to their dtype; other leaves pass
    through.  The AdamW step is :mod:`s2s_tpu_torch.parallel.training`'s."""
    loss, grads = value_and_grad(params, cfg, tokens, targets, mask)
    with torch.no_grad():
        new_params = pytree.tree_map(lambda p, g: p if g is None else (p - lr * g.float()).to(p.dtype),
                                     params, grads)
    return loss, new_params


# ── HF checkpoint conversion ─────────────────────────────────────────


def _rope_perm(hd: int) -> np.ndarray:
    """Row order taking Hugging Face's half-split rope layout to the
    interleaved one: pair i = (half row i, half row i + hd/2)."""
    perm = np.empty(hd, np.int64)
    perm[0::2] = np.arange(hd // 2)
    perm[1::2] = np.arange(hd // 2) + hd // 2
    return perm


def convert_hf_state_dict(state_dict: dict[str, Any], cfg: DecoderLMConfig,
                          device: torch.device | str = "cpu") -> Params:
    """Map a HF Llama/SmolLM2-style ``state_dict`` (numpy arrays or tensors)
    onto the parameter tree, each tensor cast to ``cfg.dtype`` on *device*.
    HF stores (out, in), so projections transpose; q/k rows are permuted
    from HF's half-split rope to the interleaved pairs :func:`apply_rope`
    rotates (and the Qwen3 q/k norm weights with them: RMS is
    permutation-equivariant); layers stack.  The same trees, bit for bit, as
    the JAX package's converter."""
    perm = _rope_perm(cfg.head_dim)

    def arr(name) -> np.ndarray:
        return host_array(state_dict[name])

    def tensor(w: np.ndarray) -> torch.Tensor:
        return device_tensor(w, cfg.dtype, device)

    def t(name):
        return tensor(arr(name).T)

    def rope_permuted(name, n_heads):
        w = arr(name)  # (n_heads*hd, d_in)
        hd = w.shape[0] // n_heads
        return tensor(w.reshape(n_heads, hd, -1)[:, _rope_perm(hd), :].reshape(n_heads * hd, -1).T)

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layer = {
            "attn_norm": tensor(arr(p + "input_layernorm.weight")),
            "wq": rope_permuted(p + "self_attn.q_proj.weight", cfg.n_heads),
            "wk": rope_permuted(p + "self_attn.k_proj.weight", cfg.n_kv_heads),
            "wv": t(p + "self_attn.v_proj.weight"),
            "wo": t(p + "self_attn.o_proj.weight"),
            "mlp_norm": tensor(arr(p + "post_attention_layernorm.weight")),
            "w_gate": t(p + "mlp.gate_proj.weight"),
            "w_up": t(p + "mlp.up_proj.weight"),
            "w_down": t(p + "mlp.down_proj.weight"),
        }
        if cfg.qk_norm:
            layer["q_norm"] = tensor(arr(p + "self_attn.q_norm.weight")[perm])
            layer["k_norm"] = tensor(arr(p + "self_attn.k_norm.weight")[perm])
        layers.append(layer)
    params: Params = {
        "embed": tensor(arr("model.embed_tokens.weight")),
        "layers": stack_layers(layers),
        "final_norm": tensor(arr("model.norm.weight")),
    }
    if not cfg.tie_embeddings and "lm_head.weight" in state_dict:
        params["lm_head"] = t("lm_head.weight")
    return params
