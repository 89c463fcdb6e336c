"""The whole step's share of the chip's dense bf16 peak: the model FLOPs of
the work delivered in the window (``s2sbench.flops``: input audio through
Parakeet for the voice turns whose request fell in it, their LM prompt
and output tokens from ``usage``, and the reply audio that arrived in it
as codec frames), over the window's seconds times 989 TFLOP/s."""

from s2sbench import bounds, flops
from s2sbench.metrics import audio_rate, ok


def read(run):
    m = run.models
    total = 0.0
    for t in run.window_turns:
        if not ok(t):
            continue
        if t["kind"] == "voice":
            total += flops.parakeet(m["parakeet"], t.get("input_audio_s") or 0.0)
        usage = t.get("usage") or {}
        out = int(usage.get("output_tokens") or 0)
        # the engine keeps a prompt's tail that fits its slot (--llm_batched_max_t)
        prompt = min(int(usage.get("input_tokens") or 0), max(0, run.lm_max_t - out))
        total += flops.lm_turn(m["lm"], prompt, out)
    total += flops.frames(m, audio_rate(run) * run.seconds) * flops.tts_frame(m["tts"], 96.0)
    return 100.0 * total / (run.seconds * bounds.BF16_FLOPS)
