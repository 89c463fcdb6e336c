"""Plain Parakeet-TDT (FastConformer encoder, LSTM prediction network,
TDT joint), in f32.

Frontend (NeMo's preprocessing): preemphasis 0.97 over the valid
samples, a centred hann(400) in a 512-point real DFT every 160 samples
with n_fft/2 zero padding, power, a slaney mel filterbank of 128 bands,
log(x + 2^-24), and each band normalized to zero mean and unit std over
the valid frames.  Encoder: three stride-2 conv stages (a 3x3 conv, then
depthwise 3x3 and pointwise 1x1 pairs, ReLUs), a linear to d_model scaled
by sqrt(d_model), then conformer blocks: half-step FFN, relative-position
(Transformer-XL) self-attention, the GLU / depthwise conv / batch norm /
SiLU conv module, half-step FFN, layer norm.  Decode: TDT greedy (NeMo
``GreedyTDTInfer``): at each step the joint of the frame's encoding and
the prediction network's output gives a token (blank included) and a
duration; a blank advances at least one frame, an emission may stay on
the frame at most ``max_symbols_per_frame`` times.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from s2sbench.reference import nn

LOG_ZERO_GUARD = 2.0 ** -24
NORM_EPS = 1e-5
MAX_TOKENS = 512


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz, logstep = 200.0 / 3, 1000.0, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, logstep = 200.0 / 3, np.log(6.4) / 27.0
    min_log_mel = 1000.0 / f_sp
    return np.where(m >= min_log_mel, 1000.0 * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def filterbank(n_mels: int, n_freqs: int, sr: int) -> np.ndarray:
    freqs = np.linspace(0, sr / 2, n_freqs)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-ramps[:, :-2] / fdiff[None, :-1], ramps[:, 2:] / fdiff[None, 1:]))
    return (fb * (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[None, :]).astype(np.float32)


def frontend(c: dict, audio: torch.Tensor, n_valid: int) -> tuple[torch.Tensor, int]:
    """audio (N,) f32 zero-padded past *n_valid* -> ((T, n_mels), valid frames)."""
    n, dev = audio.shape[0], audio.device
    x = torch.cat([audio[:1], audio[1:] - c["preemphasis"] * audio[:-1]])
    x = torch.where(torch.arange(n, device=dev) < n_valid, x, 0.0)
    n_fft, hop, win = c["n_fft"], c["hop_length"], c["win_length"]
    x = F.pad(x, (n_fft // 2, n_fft // 2))
    n_frames = 1 + n // hop
    frames = x.unfold(0, n_fft, hop)[:n_frames].double()
    window = np.zeros(n_fft)
    off = (n_fft - win) // 2
    window[off:off + win] = np.hanning(win)
    k = np.arange(n_fft // 2 + 1)
    angle = -2.0 * np.pi * np.outer(np.arange(n_fft), k) / n_fft
    cos_b = torch.from_numpy(np.cos(angle) * window[:, None]).to(dev)
    sin_b = torch.from_numpy(np.sin(angle) * window[:, None]).to(dev)
    fb = torch.from_numpy(filterbank(c["n_mels"], n_fft // 2 + 1, 16000).astype(np.float64)).to(dev)
    re, im = frames @ cos_b, frames @ sin_b
    logmel = torch.log((re * re + im * im) @ fb + LOG_ZERO_GUARD)
    valid = n_valid // hop
    mask = (torch.arange(n_frames, device=dev) < valid)[:, None]
    denom = float(max(valid, 1))
    mean = torch.where(mask, logmel, 0.0).sum(0, keepdim=True) / denom
    var = torch.where(mask, (logmel - mean) ** 2, 0.0).sum(0, keepdim=True)
    out = (logmel - mean) / (torch.sqrt(var / max(denom - 1.0, 1.0)) + NORM_EPS)
    return torch.where(mask, out, 0.0).float(), valid


def _sub_len(n: int) -> int:
    return (n - 1) // 2 + 1


class Weights:
    """The tree's leaves in f32 at a precision (matrices and convs; norms,
    biases and the relative-position biases stay exact).  At ``"fp8"`` the
    TDT joint's and the prediction network's product inputs are rounded to
    fp8 too (:func:`s2sbench.reference.nn.activation`)."""

    def __init__(self, tree: dict, precision: str) -> None:
        self.tree, self.precision = tree, precision

    def mat(self, w):
        return nn.weight(w, self.precision) if self.precision != "bf16" else w.float()

    def conv(self, w):
        return nn.weight(w, self.precision, in_dim=0) if self.precision != "bf16" else w.float()


def encode(tree: dict, c: dict, mel: torch.Tensor, valid: int, precision: str) -> tuple[torch.Tensor, int]:
    """mel (T, n_mels) -> (encoding (T', d), valid encoder frames)."""
    W = Weights(tree, precision)
    sub = tree["sub"]
    x = mel[None, None]
    length = valid

    def mask_time(x, length):
        return torch.where(torch.arange(x.shape[2], device=x.device)[None, None, :, None] < length, x, 0.0)

    def conv2d(x, p, stride, groups=1):
        pad = (p["w"].shape[-1] - 1) // 2
        return F.conv2d(x, W.conv(p["w"]), p["b"].float(), stride, pad, groups=groups)

    x = torch.relu(conv2d(x, sub["conv0"], 2))
    length = _sub_len(length)
    x = mask_time(x, length)
    for i in range(1, c["sub_layers"]):
        x = conv2d(x, sub[f"dw{i}"], 2, groups=c["sub_channels"])
        length = _sub_len(length)
        x = mask_time(x, length)
        x = torch.relu(conv2d(x, sub[f"pw{i}"], 1))
        x = mask_time(x, length)
    _, ch, t, f = x.shape
    x = x.permute(0, 2, 1, 3).reshape(t, ch * f)
    d, h = c["d_model"], c["n_heads"]
    hd = d // h
    x = (x @ W.mat(sub["out"]["w"]) + sub["out"]["b"].float()) * math.sqrt(d)
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float64) / d))
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)
    fr = np.outer(pos, inv)
    pos_emb = torch.from_numpy(np.stack([np.sin(fr), np.cos(fr)], -1).reshape(2 * t - 1, d)).float().to(x.device)
    valid_t = torch.arange(t, device=x.device) < length
    blocks = tree["blocks"]

    def ln(x, p, i):
        return nn.layer_norm(x, p["w"][i], p["b"][i])

    def ff(x, p, i):
        return F.silu(x @ W.mat(p["w1"][i]) + p["b1"][i].float()) @ W.mat(p["w2"][i]) + p["b2"][i].float()

    idx = (t - 1) - torch.arange(t, device=x.device)[:, None] + torch.arange(t, device=x.device)[None, :]
    for i in range(c["n_layers"]):
        x = x + 0.5 * ff(ln(x, blocks["ff1_norm"], i), blocks["ff1"], i)
        a, y = blocks["attn"], ln(x, blocks["attn_norm"], i)
        q = (y @ W.mat(a["wq"][i]) + a["bq"][i].float()).reshape(t, h, hd).transpose(0, 1)
        k = (y @ W.mat(a["wk"][i]) + a["bk"][i].float()).reshape(t, h, hd).transpose(0, 1)
        v = (y @ W.mat(a["wv"][i]) + a["bv"][i].float()).reshape(t, h, hd).transpose(0, 1)
        rel_k = (pos_emb @ W.mat(a["wpos"][i])).reshape(2 * t - 1, h, hd)
        ac = (q + a["u"][i].float()[:, None, :]) @ k.transpose(-1, -2)
        bd_raw = torch.einsum("hqd,phd->hqp", q + a["v"][i].float()[:, None, :], rel_k)
        bd = torch.gather(bd_raw, -1, idx[None].expand(h, t, t))
        scores = (ac + bd) * hd ** -0.5
        keep = valid_t[None, None, :] & valid_t[None, :, None]
        probs = torch.nan_to_num(torch.softmax(scores.masked_fill(~keep, float("-inf")), -1), nan=0.0)
        o = (probs @ v).transpose(0, 1).reshape(t, d)
        x = x + o @ W.mat(a["wo"][i]) + a["bo"][i].float()
        cv, y = blocks["conv"], ln(x, blocks["conv_norm"], i)
        g = y @ W.mat(cv["pw1_w"][i]) + cv["pw1_b"][i].float()
        y = g[:, :d] * torch.sigmoid(g[:, d:])
        y = torch.where(valid_t[:, None], y, 0.0)
        kk = c["conv_kernel"]
        y = F.conv1d(y.T[None], W.conv(cv["dw_w"][i]), None, padding=(kk - 1) // 2, groups=d)[0].T
        y = y + cv["dw_b"][i].float()
        y = (y - cv["bn_mean"][i]) * (cv["bn_w"][i] * torch.rsqrt(cv["bn_var"][i] + 1e-5)) + cv["bn_b"][i]
        x = x + F.silu(y) @ W.mat(cv["pw2_w"][i]) + cv["pw2_b"][i].float()
        x = x + 0.5 * ff(ln(x, blocks["ff2_norm"], i), blocks["ff2"], i)
        x = ln(x, blocks["out_norm"], i)
    return torch.where(valid_t[:, None], x, 0.0), length


def _pred_outputs(pred: dict, W: Weights, tokens: list[int], blank: int, device) -> torch.Tensor:
    """The prediction network's output after SOS (blank) and after each of
    *tokens*: (len(tokens) + 1, H)."""
    layers = [{k: (W.mat(v) if k in ("wi", "wh") else v.float()) for k, v in lp.items()} for lp in pred["layers"]]
    ph = layers[0]["wh"].shape[0]
    hs = [torch.zeros(ph, device=device) for _ in layers]
    cs = [torch.zeros(ph, device=device) for _ in layers]
    outs = []
    act = W.precision
    for token in [blank, *tokens]:
        x = pred["embed"][token].float()
        for li, lp in enumerate(layers):
            i, f, g, o = (nn.activation(x, act) @ lp["wi"] + lp["bi"] + nn.activation(hs[li], act) @ lp["wh"]
                          + lp["bh"]).chunk(4)
            cs[li] = torch.sigmoid(f) * cs[li] + torch.sigmoid(i) * torch.tanh(g)
            hs[li] = torch.sigmoid(o) * torch.tanh(cs[li])
            x = hs[li]
        outs.append(x)
    return torch.stack(outs)


def _joint(tree: dict, W: Weights, enc: torch.Tensor, pred_out: torch.Tensor) -> torch.Tensor:
    """Joint logits of every (frame, prediction state) pair: (T, S, V + 1 + n_dur)."""
    jp, act = tree["joint"], W.precision
    e = nn.activation(enc, act) @ W.mat(jp["enc_w"]) + jp["enc_b"].float()
    p = nn.activation(pred_out, act) @ W.mat(jp["pred_w"]) + jp["pred_b"].float()
    return nn.activation(torch.relu(e[:, None] + p[None]), act) @ W.mat(jp["out_w"]) + jp["out_b"].float()


def decode(tree: dict, c: dict, enc: torch.Tensor, enc_len: int, precision: str) -> list[int]:
    """The reference's TDT greedy decode of *enc* (T, d): its tokens."""
    W = Weights(tree, precision)
    blank, v1 = c["vocab_size"], c["vocab_size"] + 1
    tokens: list[int] = []
    pred_out = _pred_outputs(tree["pred"], W, [], blank, enc.device)[-1]
    t = syms = steps = 0
    max_steps = enc.shape[0] * (c["max_symbols_per_frame"] + 1) + MAX_TOKENS
    while t < enc_len and len(tokens) < MAX_TOKENS and steps < max_steps:
        logits = _joint(tree, W, enc[t:t + 1], pred_out[None])[0, 0]
        k, d = int(logits[:v1].argmax()), int(logits[v1:].argmax())
        emit = k != blank
        advance = d if emit else max(d, 1)
        if emit:
            tokens.append(k)
            pred_out = _pred_outputs(tree["pred"], W, tokens, blank, enc.device)[-1]
            syms += 1
            if syms >= c["max_symbols_per_frame"]:
                advance = max(advance, 1)
        if advance > 0:
            syms = 0
        t += advance
        steps += 1
    return tokens


def alignment_gap(tree: dict, c: dict, enc: torch.Tensor, enc_len: int, served: list[int],
                  precision: str) -> float:
    """How far *served* tokens are from the reference's greedy TDT choices
    on *enc*: over every alignment of the tokens to the frames that a TDT
    greedy decode can take (at each step a token or blank, and a
    duration), the least of the widest gap, on its steps, between the
    reference's best logit and the logit of the choice taken (token and
    duration heads apart).  0 when the reference's own decode gives
    *served*; a token the reference never puts near the top on any
    alignment reads large.  The prediction network's state depends only
    on the tokens emitted, so the alignments form a (frame, tokens) grid
    and the least widest gap is a bottleneck path through it."""
    W = Weights(tree, precision)
    blank, v1 = c["vocab_size"], c["vocab_size"] + 1
    n = len(served)
    pred_out = _pred_outputs(tree["pred"], W, served, blank, enc.device)  # (n + 1, H)
    logits = _joint(tree, W, enc[:enc_len], pred_out)  # (T, n + 1, V)
    tok, dur = logits[..., :v1], logits[..., v1:]
    best = tok.amax(-1)
    blank_cost = (best - tok[..., blank]).cpu().numpy()
    emit_cost = np.full((enc_len, n + 1), np.inf)
    if n:
        idx = torch.tensor(served, device=enc.device)
        emit_cost[:, :n] = (best[:, :n] - tok[:, torch.arange(n, device=enc.device), idx]).cpu().numpy()
    dur_cost = (dur.amax(-1, keepdim=True) - dur).cpu().numpy()  # (T, n + 1, n_dur)
    inf = float("inf")
    n_dur, most = dur.shape[-1], c["max_symbols_per_frame"]
    # reach[t, j, s]: least widest gap to frame t with j tokens out, s of them on frame t
    reach = np.full((enc_len + n_dur + 1, n + 1, most), inf)
    reach[0, 0, 0] = 0.0
    done = inf

    def arrive(t: int, j: int, cost: float) -> None:
        nonlocal done
        if t >= enc_len:
            if j == n:
                done = min(done, cost)
        else:
            reach[t, j, 0] = min(reach[t, j, 0], cost)

    for t in range(enc_len):
        for j in range(n + 1):
            b = reach[t, j]
            if not np.isfinite(b).any():
                continue
            for d in range(n_dur):
                dc = np.maximum(b, dur_cost[t, j, d])
                if j < n:
                    cost = np.maximum(dc, emit_cost[t, j])
                    if d == 0:  # stay on the frame, up to the symbols a frame may take
                        reach[t, j + 1, 1:] = np.minimum(reach[t, j + 1, 1:], cost[:-1])
                        arrive(t + 1, j + 1, float(cost[-1]))
                    else:
                        arrive(t + d, j + 1, float(cost.min()))
                arrive(t + max(d, 1), j, float(np.maximum(dc, blank_cost[t, j]).min()))
    return float(done)


def encoding(tree: dict, c: dict, audio: np.ndarray, n_valid: int, precision: str, device):
    """(encoding, valid frames) of one transcription's padded *audio*."""
    mel, valid = frontend(c, torch.from_numpy(audio).to(device), n_valid)
    return encode(tree, c, mel, valid, precision)
