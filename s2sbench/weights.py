"""Seeded weights of a configuration, made on the device.

Each model's tree has the port's one weight layout (stacked layers, (in,
out) matrices, the leaf names the port's models read) and the port's
random-init distributions: N(0, fan_in^-1/2) matrices, N(0, 0.02)
embeddings, ones for norms, zeros for biases.  Every leaf is one
``torch.randn`` call from one ``torch.Generator`` on the device, in the
dtype the configuration serves: a stacked leaf holds all its layers, so a
model takes a few dozen calls.  The same seed on the same device gives the
same numbers, so the reference makes the trees again after the serve is
gone instead of keeping a copy beside it.

The shapes come from the configuration file (``models`` section), never
from the program; :func:`check_against_program` holds the two together.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed for *stream* derived from the run's *seed* (any size)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), stream]).generate_state(1, np.uint64)[0] >> 1)


class _Maker:
    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype) -> None:
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device, self.dtype = device, dtype

    def normal(self, shape, scale: float, dtype=None) -> torch.Tensor:
        t = torch.randn(tuple(shape), generator=self.gen, device=self.device, dtype=dtype or self.dtype)
        return t.mul_(scale)

    def lin(self, *shape) -> torch.Tensor:
        return self.normal(shape, shape[-2] ** -0.5)

    def ones(self, *shape, dtype=None) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype or self.dtype, device=self.device)

    def zeros(self, *shape, dtype=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=self.dtype, device=self.device)


def parakeet_tree(c: dict, seed: int, device: torch.device) -> dict:
    m = _Maker(seed, device, DTYPES[c["dtype"]])
    d, L, ch, ff = c["d_model"], c["n_layers"], c["sub_channels"], c["d_ff"]
    hd = d // c["n_heads"]
    f32 = torch.float32

    def norm():
        return {"w": m.ones(L, d), "b": m.zeros(L, d)}

    def ffn():
        return {"w1": m.lin(L, d, ff), "b1": m.zeros(L, ff), "w2": m.lin(L, ff, d), "b2": m.zeros(L, d)}

    blocks = {
        "ff1_norm": norm(), "ff1": ffn(), "attn_norm": norm(),
        "attn": {"wq": m.lin(L, d, d), "bq": m.zeros(L, d), "wk": m.lin(L, d, d), "bk": m.zeros(L, d),
                 "wv": m.lin(L, d, d), "bv": m.zeros(L, d), "wo": m.lin(L, d, d), "bo": m.zeros(L, d),
                 "wpos": m.lin(L, d, d), "u": m.normal((L, c["n_heads"], hd), 0.02),
                 "v": m.normal((L, c["n_heads"], hd), 0.02)},
        "conv_norm": norm(),
        "conv": {"pw1_w": m.lin(L, d, 2 * d), "pw1_b": m.zeros(L, 2 * d),
                 "dw_w": m.normal((L, d, 1, c["conv_kernel"]), c["conv_kernel"] ** -0.5),
                 "dw_b": m.zeros(L, d),
                 "bn_w": m.ones(L, d, dtype=f32), "bn_b": m.zeros(L, d, dtype=f32),
                 "bn_mean": m.zeros(L, d, dtype=f32), "bn_var": m.ones(L, d, dtype=f32),
                 "pw2_w": m.lin(L, d, d), "pw2_b": m.zeros(L, d)},
        "ff2_norm": norm(), "ff2": ffn(), "out_norm": norm(),
    }

    def conv2d(cin, cout, k, groups=1):
        return {"w": m.normal((cout, cin // groups, k, k), (cin // groups * k * k) ** -0.5), "b": m.zeros(cout)}

    sub = {"conv0": conv2d(1, ch, 3)}
    for i in range(1, c["sub_layers"]):
        sub[f"dw{i}"] = conv2d(ch, ch, 3, groups=ch)
        sub[f"pw{i}"] = conv2d(ch, ch, 1)
    sub["out"] = {"w": m.lin(ch * (c["n_mels"] // 2 ** c["sub_layers"]), d), "b": m.zeros(d)}
    ph, nv, jh = c["pred_hidden"], c["vocab_size"] + 1, c["joint_hidden"]
    return {
        "sub": sub, "blocks": blocks,
        "pred": {"embed": m.normal((nv, ph), 0.02),
                 "layers": [{"wi": m.lin(ph, 4 * ph), "wh": m.lin(ph, 4 * ph), "bi": m.zeros(4 * ph),
                             "bh": m.zeros(4 * ph)} for _ in range(c["pred_layers"])]},
        "joint": {"enc_w": m.lin(d, jh), "enc_b": m.zeros(jh), "pred_w": m.lin(ph, jh), "pred_b": m.zeros(jh),
                  "out_w": m.lin(jh, nv + c["n_durations"]), "out_b": m.zeros(nv + c["n_durations"])},
    }


def decoder_tree(c: dict, m: _Maker, head: bool = True, embed: bool = True) -> dict:
    d, L = c["d_model"], c["n_layers"]
    hd = c.get("head_dim") or d // c["n_heads"]
    hq, hkv = c["n_heads"] * hd, c["n_kv_heads"] * hd
    layers = {"attn_norm": m.ones(L, d), "wq": m.lin(L, d, hq), "wk": m.lin(L, d, hkv), "wv": m.lin(L, d, hkv),
              "wo": m.lin(L, hq, d), "mlp_norm": m.ones(L, d), "w_gate": m.lin(L, d, c["d_ff"]),
              "w_up": m.lin(L, d, c["d_ff"]), "w_down": m.lin(L, c["d_ff"], d)}
    if c.get("qk_norm"):
        layers["q_norm"] = m.ones(L, hd)
        layers["k_norm"] = m.ones(L, hd)
    tree = {"layers": layers, "final_norm": m.ones(d)}
    if embed:
        tree["embed"] = m.normal((c["vocab_size"], d), 0.02)
    if head and not c.get("tie_embeddings", True):
        tree["lm_head"] = m.normal((d, c["vocab_size"]), d ** -0.5)
    return tree


def lm_tree(c: dict, seed: int, device: torch.device) -> dict:
    return decoder_tree(c, _Maker(seed, device, DTYPES[c["dtype"]]))


def code2wav_tree(c: dict, m: _Maker) -> dict:
    d, L = c["hidden"], c["n_layers"]
    f32 = torch.float32

    def conv(cin, cout, k):
        return {"w": m.normal((cout, cin, k), (cin * k) ** -0.5), "b": m.zeros(cout)}

    def tconv(cin, cout, k):
        return {"w": m.normal((cin, cout, k), (cin * k) ** -0.5), "b": m.zeros(cout)}

    def snake(dim):
        return {"alpha": m.zeros(dim, dtype=f32), "beta": m.zeros(dim, dtype=f32)}

    upsample = [{"tconv": tconv(d, d, r),
                 "convnext": {"dw_w": m.normal((d, 1, 7), 0.1), "dw_b": m.zeros(d), "ln_w": m.ones(d),
                              "ln_b": m.zeros(d), "pw1_w": m.normal((d, 4 * d), d ** -0.5),
                              "pw1_b": m.zeros(4 * d), "pw2_w": m.normal((4 * d, d), (4 * d) ** -0.5),
                              "pw2_b": m.zeros(d), "gamma": m.full((d,), 1e-6)}}
                for r in c["upsampling_ratios"]]
    dec_blocks, dim = [], c["decoder_dim"]
    for rate in c["upsample_rates"]:
        out = dim // 2
        dec_blocks.append({"act": snake(dim), "tconv": tconv(dim, out, 2 * rate),
                           "units": [{"act1": snake(out), "conv1": conv(out, out, 7), "act2": snake(out),
                                      "conv2": conv(out, out, 1)} for _ in range(3)]})
        dim = out
    layers = {"attn_norm": m.ones(L, d), "wq": m.lin(L, d, d), "wk": m.lin(L, d, d), "wv": m.lin(L, d, d),
              "wo": m.lin(L, d, d), "attn_scale": m.full((L, d), 0.01), "mlp_norm": m.ones(L, d),
              "w_gate": m.lin(L, d, c["d_ff"]), "w_up": m.lin(L, d, c["d_ff"]), "w_down": m.lin(L, c["d_ff"], d),
              "mlp_scale": m.full((L, d), 0.01)}
    return {"embed": m.normal((c["codebook_size"] * c["num_quantizers"], d), 0.02), "layers": layers,
            "final_norm": m.ones(d), "upsample": upsample, "dec_in": conv(d, c["decoder_dim"], 7),
            "dec_blocks": dec_blocks, "dec_act": snake(dim), "dec_out": conv(dim, 1, 7)}


def tts_tree(c: dict, seed: int, device: torch.device) -> dict:
    m = _Maker(seed, device, DTYPES[c["dtype"]])
    talker, cp, c2w = c["talker"], c["cp"], c["code2wav"]
    d, n_res, cb = talker["d_model"], c2w["num_quantizers"] - 1, c2w["codebook_size"]
    lm = decoder_tree(talker, m, head=False, embed=False)
    lm["embed"] = m.normal((c["codec_vocab"], d), 0.02)
    return {
        "talker": lm,
        "codec_head": m.normal((d, c["codec_vocab"]), d ** -0.5),
        "text_embed": m.normal((c["text_vocab"], d), 0.02),
        "speakers": m.normal((c["n_speakers"], d), 0.02),
        "pad_embed": m.normal((d,), 0.02),
        "spk_proj": m.normal((80, d), 80 ** -0.5),
        "cp": decoder_tree(cp, m, head=False, embed=False),
        "cp_embeds": m.normal((n_res, cb, cp["d_model"]), 0.02),
        "cp_heads": m.normal((n_res, cp["d_model"], cb), cp["d_model"] ** -0.5),
        "c2w": code2wav_tree(c2w, m),
    }


#: stream numbers of each model's weights under the run's seed
STREAMS = {"parakeet": 1, "lm": 2, "tts": 3}
BUILDERS = {"parakeet": parakeet_tree, "lm": lm_tree, "tts": tts_tree}


def make(model: str, models: dict, seed: int, device: torch.device) -> dict:
    """The weight tree of *model* ("parakeet", "lm" or "tts") of a
    configuration's ``models`` section, from the run's *seed*."""
    return BUILDERS[model](models[model], subseed(seed, STREAMS[model]), device)


def check_against_program(models: dict, flags: dict) -> None:
    """Raise where the configuration file's shapes differ from the program's
    presets that its serve flags name (the harness's side of the contract;
    the reference never imports the program)."""
    from s2s_tpu_torch.llm.local_backend import lm_config
    from s2s_tpu_torch.models.qwen3_tts import CONFIGS
    from s2s_tpu_torch.stt.parakeet_handler import config_for

    def same(what: str, mine: dict, theirs: dict) -> None:
        for key, value in theirs.items():
            if key in mine and mine[key] != value:
                raise ValueError(f"{what}.{key}: configuration file {mine[key]!r}, program {value!r}")

    def dtype(t) -> str:
        return str(t).removeprefix("torch.")

    p = config_for(flags["stt_model_size"])
    same("parakeet", models["parakeet"], {**{k: getattr(p, k) for k in (
        "n_mels", "n_fft", "win_length", "hop_length", "preemphasis", "d_model", "n_layers", "n_heads", "d_ff",
        "conv_kernel", "sub_channels", "sub_layers", "vocab_size", "pred_hidden", "pred_layers", "joint_hidden",
        "n_durations", "max_symbols_per_frame")}, "dtype": dtype(p.dtype)})
    lm = lm_config(flags["llm_model_size"])

    def dec(cfg) -> dict:
        return {"vocab_size": cfg.vocab_size, "d_model": cfg.d_model, "n_layers": cfg.n_layers,
                "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
                "rope_theta": cfg.rope_theta, "rms_eps": cfg.rms_eps, "tie_embeddings": cfg.tie_embeddings,
                "qk_norm": cfg.qk_norm, "head_dim": cfg.head_dim, "max_seq_len": cfg.max_seq_len,
                "dtype": dtype(cfg.dtype)}

    same("lm", models["lm"], dec(lm))
    t = CONFIGS[flags["tts_model_size"]]()
    tts = models["tts"]
    same("tts", tts, {"text_vocab": t.text_vocab, "codec_vocab": t.codec_vocab, "codec_bos_id": t.codec_bos_id,
                      "codec_eos_id": t.codec_eos_id, "n_speakers": t.n_speakers, "dtype": dtype(t.dtype)})
    same("tts.talker", tts["talker"], {k: v for k, v in dec(t.lm).items() if k != "vocab_size"})
    same("tts.cp", tts["cp"], {k: v for k, v in dec(t.cp).items() if k != "vocab_size"})
    c = t.c2w
    same("tts.code2wav", tts["code2wav"], {
        "codebook_size": c.codebook_size, "num_quantizers": c.num_quantizers, "hidden": c.hidden,
        "n_layers": c.n_layers, "n_heads": c.n_heads, "d_ff": c.d_ff, "rope_theta": c.rope_theta,
        "sliding_window": c.sliding_window, "rms_eps": c.rms_eps, "upsampling_ratios": list(c.upsampling_ratios),
        "upsample_rates": list(c.upsample_rates), "decoder_dim": c.decoder_dim, "dtype": dtype(c.dtype)})
