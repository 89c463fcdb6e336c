"""Plain decoder-only transformer (SmolLM2's Llama layout; the Qwen3 talker
and code predictor with per-head q/k RMS norm), full-sequence and causal,
in f32, one layer at a time.

Follows the published layer equations: pre-norm RMSNorm, rotary
embeddings on interleaved pairs, grouped-query attention with softmax over
the causal past, SwiGLU MLP, residuals.  The weights are a tree of stacked
layers in the benchmark's layout; a layer's matrices enter at the
configuration's precision (:func:`s2sbench.reference.nn.weight`).
"""

from __future__ import annotations

import torch

from s2sbench.reference import nn

MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def prepare(tree: dict, c: dict, precision: str, min_size: int = 1 << 16) -> list[dict]:
    """Every layer's leaves in f32, the matrices that the mode quantizes at
    *precision* (the rest exact)."""
    layers = tree["layers"]
    out = []
    for i in range(c["n_layers"]):
        lp = {}
        for name, leaf in layers.items():
            w = leaf[i]
            quantized = name in MATRICES and precision != "bf16" and nn.quantized_leaf(name, leaf, min_size)
            lp[name] = nn.weight(w, precision) if quantized else w.float()
        out.append(lp)
    return out


def hidden(layers: list[dict], c: dict, x: torch.Tensor) -> torch.Tensor:
    """The layer stack (:func:`prepare`'s) over embeddings x (B, T, D) in
    f32, positions 0..T-1; returns the last layer's output before the
    final norm."""
    b, t, _ = x.shape
    hd = c.get("head_dim") or c["d_model"] // c["n_heads"]
    nq, nkv = c["n_heads"], c["n_kv_heads"]
    cos, sin = nn.rope(hd, t, c["rope_theta"], x.device)
    mask = nn.causal(t, x.device)
    eps = c["rms_eps"]
    for lp in layers:
        h = nn.rms_norm(x, lp["attn_norm"], eps)
        q = (h @ lp["wq"]).reshape(b, t, nq, hd)
        k = (h @ lp["wk"]).reshape(b, t, nkv, hd)
        if c.get("qk_norm"):
            q = nn.rms_norm(q, lp["q_norm"], eps)
            k = nn.rms_norm(k, lp["k_norm"], eps)
        v = (h @ lp["wv"]).reshape(b, t, nkv, hd).transpose(1, 2)
        q = nn.apply_rope(q.transpose(1, 2), cos, sin)
        k = nn.apply_rope(k.transpose(1, 2), cos, sin)
        a = nn.attention(q, k, v, mask).transpose(1, 2).reshape(b, t, nq * hd)
        x = x + a @ lp["wo"]
        h = nn.rms_norm(x, lp["mlp_norm"], eps)
        x = x + (nn.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    return x


def head(tree: dict, c: dict, precision: str, min_size: int = 1 << 16) -> torch.Tensor:
    """The LM head (D, V) in f32: a tied head is the embedding, never quantized."""
    if c.get("tie_embeddings", True):
        return tree["embed"].float().T
    leaf = tree["lm_head"]
    quantized = precision != "bf16" and nn.quantized_leaf("lm_head", leaf, min_size)
    return nn.weight(leaf, precision) if quantized else leaf.float()


def lm_logits(tree: dict, layers: list[dict], lm_head: torch.Tensor, c: dict, tokens: torch.Tensor) -> torch.Tensor:
    """f32 logits (T, V) of a causal LM over *tokens* (T,)."""
    x = tree["embed"][tokens.long()].float()[None]
    return nn.rms_norm(hidden(layers, c, x)[0], tree["final_norm"], c["rms_eps"]) @ lm_head
