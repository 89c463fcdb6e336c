"""Each configuration's FLOPs a unit against a count by hand."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT

from s2sbench import bounds, flops

MODELS = json.loads((ROOT / "s2sbench/configs/smollm2-qwen3tts-int8.json").read_text())["models"]


def test_smollm2_token_by_hand():
    # 24 layers of q, k, v, o (2048 x 2048 each, 32/32 heads of 64) and the
    # SwiGLU's three 2048 x 8192 products; the tied head 2048 x 49,152
    layer = 2 * (4 * 2048 * 2048 + 3 * 2048 * 8192)
    assert flops.decoder_token(MODELS["lm"], 0) == 24 * layer
    head = 2 * 2048 * 49152
    # one prompt token at position 0: no attention
    assert flops.lm_turn(MODELS["lm"], 1, 0) == pytest.approx(24 * layer + head + 24 * 4 * 2048 * 0.5)


def test_talker_and_code_predictor_by_hand():
    t = MODELS["tts"]
    # talker: q 2048 x 2048, k and v 2048 x 1024 (8 kv heads of 128), o, MLP 3 x 2048 x 6144
    layer = 2 * (2048 * 2048 + 2 * 2048 * 1024 + 2048 * 2048 + 3 * 2048 * 6144)
    assert flops.decoder_token(t["talker"], 0) == 28 * layer
    cp = 5 * layer
    frame = flops.tts_frame(t, 0.0)
    c2w = flops.code2wav_frame(t["code2wav"])
    predictor = 16 * cp + sum(5 * 2 * 2 * p * 2048 for p in range(16)) + 15 * 2 * 2048 * 2048
    assert frame == pytest.approx(28 * layer + 2 * 2048 * 4206 + predictor + c2w)
    # Code2Wav's transformer alone: 8 layers of 4 x 1024^2 and 3 x 1024 x 3072, a 72-frame window
    assert c2w > 8 * 2 * (4 * 1024 * 1024 + 3 * 1024 * 3072)


def test_parakeet_second_by_hand():
    c = MODELS["parakeet"]
    f1, f2 = flops.parakeet(c, 1.0), flops.parakeet(c, 2.0)
    # 12.5 encoder frames a second: per frame and layer two FFNs (4 x 1024 x 4096), q/k/v/o and
    # the position projection, the conv module's pointwise pair and depthwise taps
    per_frame = 24 * 2 * (2 * 2 * 1024 * 4096 + 4 * 1024 * 1024 + 2 * 1024 * 1024 + 2 * 1024 * 1024
                          + 1024 * 9 + 1024 * 1024)
    assert f1 > 12.5 * per_frame
    assert 2 * f1 < f2 < 2.5 * f1  # linear in length, and its attention quadratic


def test_the_peaks_and_bound_arithmetic():
    assert bounds.bound(3.35e12, 0, bounds.BF16_FLOPS) == (pytest.approx(1000.0), "bytes")
    assert bounds.bound(0, 989e12, bounds.BF16_FLOPS) == (pytest.approx(1000.0), "operations")
    ms, what = bounds.gemv_bound(1, 2048, 6144, 2048 * 6144, bounds.INT8_OPS)
    assert what == "bytes" and ms == pytest.approx((2048 * 6144 + 2048 * 2 + 6144 * 4 + 6144 * 2) / 3.35e9)
