"""Model FLOPs of the work a configuration delivers, from its shapes.

Counted from what the clients received, so the count reads the same
whatever implements it: two FLOPs a multiply-add of every matrix product,
convolution and attention product the model's equations hold; norms,
activations and softmax are left out.  Units:

- Parakeet: a transcription of ``s`` seconds of audio (the encoder's
  frames at 100 / 2^sub_layers a second, its attention over all of them,
  and the joint once a frame);
- the LM: a turn of ``p`` prompt and ``o`` output tokens, each attending
  to its causal past;
- Qwen3-TTS: a frame (12.5 a second of audio): the talker step at a
  position past the prompt, the code predictor's 16 positions and 15
  heads, and Code2Wav's share of a frame (its transformer at the frame
  rate, the convolutional decoder at 1,920 samples a frame), without the
  context frames that streaming vocodes again.
"""

from __future__ import annotations


def decoder_token(c: dict, ctx: float) -> float:
    """One token through a decoder's layers at *ctx* positions of context."""
    d, hd = c["d_model"], c.get("head_dim") or c["d_model"] // c["n_heads"]
    hq, hkv = c["n_heads"] * hd, c["n_kv_heads"] * hd
    linear = 2 * (d * hq + 2 * d * hkv + hq * d + 3 * d * c["d_ff"])
    attention = 2 * 2 * ctx * hq
    return c["n_layers"] * (linear + attention)


def lm_turn(c: dict, prompt: int, output: int) -> float:
    """A turn of *prompt* and *output* tokens (the head once per token)."""
    n = prompt + output
    return n * decoder_token(c, 0.0) + c["n_layers"] * 4 * c["n_heads"] * (c.get("head_dim") or 64) * n * n / 2 \
        + 2 * c["d_model"] * c["vocab_size"] * n


def parakeet(c: dict, seconds: float) -> float:
    d, ff, k = c["d_model"], c["d_ff"], c["conv_kernel"]
    frames = seconds * c.get("sample_rate", 16000) / c["hop_length"] / 2 ** c["sub_layers"]
    per_frame = 2 * (2 * d * ff) * 2 + 2 * 4 * d * d + 2 * 2 * d * d + 2 * (2 * d * d + d * k + d * d)
    attention = 2 * 3 * frames * frames * d
    ch = c["sub_channels"]
    sub = 0.0
    rows, cols = seconds * c.get("sample_rate", 16000) / c["hop_length"], c["n_mels"]
    rows, cols = rows / 2, cols / 2
    sub += 2 * rows * cols * ch * 9
    for _ in range(1, c["sub_layers"]):
        rows, cols = rows / 2, cols / 2
        sub += 2 * rows * cols * ch * 9 + 2 * rows * cols * ch * ch
    sub += 2 * frames * ch * (c["n_mels"] / 2 ** c["sub_layers"]) * d
    joint = 2 * frames * (d * c["joint_hidden"] + c["pred_hidden"] * c["joint_hidden"]
                          + c["joint_hidden"] * (c["vocab_size"] + 1 + c["n_durations"]))
    return sub + c["n_layers"] * (frames * per_frame + attention) + joint


def code2wav_frame(c: dict) -> float:
    d, dd = c["hidden"], c["decoder_dim"]
    tr = c["n_layers"] * 2 * (4 * d * d + 3 * d * c["d_ff"] + 2 * 2 * c["sliding_window"] * d)
    pos, up = 1, 0.0
    for r in c["upsampling_ratios"]:
        up += 2 * pos * d * d * r  # transposed conv, per input position
        pos *= r
        up += pos * 2 * (7 * d + 2 * d * 4 * d)  # ConvNeXt: depthwise, two pointwise
    dec = pos * 2 * 7 * d * dd
    dim = dd
    for r in c["upsample_rates"]:
        out = dim // 2
        dec += 2 * pos * dim * out * 2 * r
        pos *= r
        dec += pos * 3 * 2 * (7 * out * out + out * out)
        dim = out
    dec += pos * 2 * 7 * dim
    return tr + up + dec


def tts_frame(c: dict, ctx: float) -> float:
    t, cp, c2w = c["talker"], c["cp"], c["code2wav"]
    talker = decoder_token(t, ctx) + 2 * t["d_model"] * c["codec_vocab"]
    predictor = sum(decoder_token(cp, p) for p in range(16)) + 15 * 2 * cp["d_model"] * c2w["codebook_size"]
    return talker + predictor + code2wav_frame(c2w)


def frames(models: dict, audio_s: float) -> float:
    return audio_s * models["tts"].get("frames_per_second", 12.5)
