"""Plain Qwen3-TTS-12Hz: the talker and the code predictor teacher-forced
on served codec frames, and Code2Wav, in f32.

Talker: a Qwen3 decoder over [speaker, text...] and then one input a
frame: the codec BOS embedding first, then for each frame the sum of its
16 codebooks' embeddings (code 0 from the talker's codec table, codes 1-15
from the code predictor's) plus the pad embedding.  Its pre-norm hidden at
a frame's position, normed, times the codec head gives code 0's logits.
Code predictor: a 5-layer Qwen3 decoder over [talker hidden, code-0
embedding, the embeddings of codes 1-14]; head i at position 1 + i gives
code i + 1's logits.  Code 0 is clipped to the 2,048-entry codebook before
it feeds the code predictor and the vocoder.

Code2Wav: each code's embedding averaged over the 16 codebooks, an 8-layer
sliding-window (72) transformer with layer scales, two x2 transposed-conv
upsamplers with ConvNeXt blocks, and a decoder of four SnakeBeta /
transposed-conv / dilated residual stages (x8, x5, x4, x3): 1,920 samples
a frame at 24 kHz.  Streaming as served: each chunk is vocoded with the
8 frames before it (zero codes before the first) and the context's
samples are dropped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from s2sbench.reference import decoder, nn


def frame_logits(tree: dict, talker_layers: list[dict], cp_layers: list[dict], c: dict, text: torch.Tensor,
                 speaker: torch.Tensor, codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced on served *codes* (N, 16) of one synthesis of *text*
    (padded ids, zeros past the text) with *speaker* (D,): (code-0 logits
    (N, codec_vocab), codes 1-15 logits (N, 15, codebook))."""
    t, cp_c = c["talker"], c["cp"]
    talker = tree["talker"]
    text = text[text > 0].long()
    prompt = torch.cat([speaker.float()[None], tree["text_embed"][text].float()])
    code0, res = codes[:, 0].long(), codes[:, 1:].long()
    emb0 = talker["embed"][code0].float()
    inputs = [talker["embed"][c["codec_bos_id"]].float()[None]]
    if len(codes) > 1:
        sums = emb0[:-1] + sum(tree["cp_embeds"][i][res[:-1, i]].float() for i in range(res.shape[1]))
        inputs.append(sums + tree["pad_embed"].float())
    x = torch.cat([prompt, *inputs])[None]
    h = decoder.hidden(talker_layers, t, x)[0, len(prompt):]  # (N, D) before the final norm
    logits0 = nn.rms_norm(h, talker["final_norm"], t["rms_eps"]) @ tree["codec_head"].float()
    cp_in = torch.cat([h[:, None], emb0[:, None],
                       torch.stack([tree["cp_embeds"][i][res[:, i]].float() for i in range(res.shape[1] - 1)],
                                   dim=1)], dim=1)  # (N, 16, D)
    hc = nn.rms_norm(decoder.hidden(cp_layers, cp_c, cp_in), tree["cp"]["final_norm"], cp_c["rms_eps"])
    return logits0, torch.einsum("nid,idv->niv", hc[:, 1:], tree["cp_heads"].float())


def code0_gap(ref: torch.Tensor, chosen: torch.Tensor, codebook: int) -> float:
    """Widest gap of code-0 choices *chosen* (N,), as the engine keeps them
    (clipped to the codebook), under the reference's logits *ref* (N, V):
    the best logit minus the best among the ids that clip to the choice."""
    clipped = torch.clamp(torch.arange(ref.shape[1], device=ref.device), max=codebook - 1)
    same = clipped[None, :] == chosen.long()[:, None]
    return float((ref.amax(1) - ref.masked_fill(~same, float("-inf")).amax(1)).max())


def codes_gap(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """Widest gap of choices *chosen* (..., ) under logits *ref* (..., V)."""
    return float((ref.amax(-1) - ref.gather(-1, chosen.long()[..., None])[..., 0]).max())


# ── Code2Wav ──


def prepare_code2wav(tree: dict, precision: str) -> dict:
    """The vocoder's tree in f32, its matrices (``w*``, ``pw*_w``) and conv
    weights at *precision*; embeddings, norms, scales, biases exact.  At
    ``"fp8"`` every product's input is rounded to fp8 as well (``act``)."""
    def walk(node, name: str):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        w = node.float()
        if precision == "bf16" or name not in ("w", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                                               "pw1_w", "pw2_w", "dw_w"):
            return w
        if w.dim() == 3 and name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):  # stacked (L, in, out)
            return torch.stack([nn.weight(layer, precision) for layer in w])
        if w.dim() == 2:
            return nn.weight(w, precision)
        return nn.weight(w, precision, in_dim=0)
    out = walk(tree, "")
    # a transposed conv's weight is (in, out, k): its output channel is dim 1
    for mine, theirs in zip([*out["upsample"], *out["dec_blocks"]], [*tree["upsample"], *tree["dec_blocks"]]):
        w = theirs["tconv"]["w"].float()
        mine["tconv"]["w"] = w if precision == "bf16" else \
            nn.weight(w.transpose(0, 1), precision, in_dim=0).transpose(0, 1)
    out["act"] = precision
    return out


def _causal_conv(x, p, act: str, dilation: int = 1):
    """x (B, T, C) -> causal conv (stride 1), length kept."""
    x, w = nn.activation(x, act), p["w"]
    k, groups = w.shape[-1], x.shape[-1] // w.shape[1]
    h = F.pad(x.transpose(1, 2), (dilation * (k - 1), 0))
    return F.conv1d(h, w, p["b"], dilation=dilation, groups=groups).transpose(1, 2)


def _trans_conv(x, p, act: str, stride: int, kernel: int):
    out = F.conv_transpose1d(nn.activation(x, act).transpose(1, 2), p["w"], p["b"], stride).transpose(1, 2)
    trim = kernel - stride
    return out[:, trim:out.shape[1] - trim] if trim else out


def _snake(x, p):
    alpha, beta = torch.exp(p["alpha"]), torch.exp(p["beta"])
    return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha) ** 2


def _lin(x, w, act: str, b=None):
    out = nn.activation(x, act) @ w
    return out + b if b is not None else out


def code2wav(tree: dict, c: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, n_q, T) -> waveform (B, T * 1920 - deficit) in [-1, 1];
    *tree* from :func:`prepare_code2wav`."""
    nq, cb, d = c["num_quantizers"], c["codebook_size"], c["hidden"]
    offsets = (torch.arange(nq, device=codes.device) * cb)[None, :, None]
    x = tree["embed"][(codes + offsets).long()].mean(dim=1)
    b, t, _ = x.shape
    hd = d // c["n_heads"]
    cos, sin = nn.rope(hd, t, c["rope_theta"], x.device)
    mask = nn.causal(t, x.device, c["sliding_window"])
    layers, act = tree["layers"], tree["act"]
    for i in range(c["n_layers"]):
        lp = {k: v[i] for k, v in layers.items()}
        h = nn.rms_norm(x, lp["attn_norm"], c["rms_eps"])
        q, k, v = (_lin(h, lp[n], act).reshape(b, t, c["n_heads"], hd).transpose(1, 2) for n in ("wq", "wk", "wv"))
        q, k = nn.apply_rope(q, cos, sin), nn.apply_rope(k, cos, sin)
        a = nn.attention(q, k, v, mask).transpose(1, 2).reshape(b, t, d)
        x = x + lp["attn_scale"] * _lin(a, lp["wo"], act)
        h = nn.rms_norm(x, lp["mlp_norm"], c["rms_eps"])
        h = _lin(F.silu(_lin(h, lp["w_gate"], act)) * _lin(h, lp["w_up"], act), lp["w_down"], act)
        x = x + lp["mlp_scale"] * h
    x = nn.rms_norm(x, tree["final_norm"], c["rms_eps"])
    for blk, r in zip(tree["upsample"], c["upsampling_ratios"]):
        x = _trans_conv(x, blk["tconv"], act, r, r)
        p = blk["convnext"]
        h = _causal_conv(x, {"w": p["dw_w"], "b": p["dw_b"]}, act)
        mean = h.mean(-1, keepdim=True)
        var = (h - mean).pow(2).mean(-1, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + 1e-6) * p["ln_w"] + p["ln_b"]
        h = _lin(F.gelu(_lin(h, p["pw1_w"], act, p["pw1_b"])), p["pw2_w"], act, p["pw2_b"])
        x = x + p["gamma"] * h
    x = _causal_conv(x, tree["dec_in"], act)
    for blk, rate in zip(tree["dec_blocks"], c["upsample_rates"]):
        x = _snake(x, blk["act"])
        x = _trans_conv(x, blk["tconv"], act, rate, 2 * rate)
        for unit, dil in zip(blk["units"], (1, 3, 9)):
            res = x
            x = _causal_conv(_snake(x, unit["act1"]), unit["conv1"], act, dilation=dil)
            x = _causal_conv(_snake(x, unit["act2"]), unit["conv2"], act)
            x = x + res
    x = _causal_conv(_snake(x, tree["dec_act"]), tree["dec_out"], act)
    return torch.clamp(x[:, :, 0], -1.0, 1.0)


def upsample(c: dict) -> int:
    return math.prod(c["upsample_rates"]) * math.prod(c["upsampling_ratios"])


def deficit(c: dict) -> int:
    """Samples the trimmed transposed convs remove from every vocoder call."""
    t = 8
    length = t * math.prod(c["upsampling_ratios"])
    for r in c["upsample_rates"]:
        length = (length - 1) * r
    return t * upsample(c) - length


def streamed_audio(tree: dict, c: dict, codes: torch.Tensor, chunk_sizes: list[int], context: int,
                   n_served: int) -> torch.Tensor:
    """The served waveform of *n_served* frames of *codes* (N, n_q), vocoded
    chunk by chunk as the engine's chunks ran (*chunk_sizes*), each with
    *context* frames before it."""
    up = upsample(c)
    start = max(0, context * up - deficit(c))
    full = torch.cat([torch.zeros((context, codes.shape[1]), dtype=codes.dtype, device=codes.device), codes])
    out, pos = [], 0
    for n in chunk_sizes:
        if pos >= n_served:
            break
        window = full[pos:pos + context + n]
        wav = code2wav(tree, c, window.T[None])[0, start:]
        out.append(wav[:min(n, n_served - pos) * up])
        pos += n
    return torch.cat(out) if out else torch.zeros(0, device=codes.device)
