"""The traffic is the same for the same seed, differs across seeds, and
gives every seed the same sizes in another order."""

from __future__ import annotations

import numpy as np
import pytest

from s2sbench import traffic

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("mix", ["voice16", "text16"])
def test_same_seed_same_traffic(mix):
    a, b = traffic.Plan(traffic.load(mix), BIG), traffic.Plan(traffic.load(mix), BIG)
    assert a.start_offsets == b.start_offsets
    for s in range(a.sessions):
        for k in range(6):
            assert a.turn(s, k) == b.turn(s, k)
    if a.mix["kind"] == "voice":
        pa, ea = a.utterance(a.turn(3, 2))
        pb, eb = b.utterance(b.turn(3, 2))
        assert ea == eb and np.array_equal(pa, pb)


@pytest.mark.parametrize("mix", ["voice16", "text16"])
def test_other_seeds_other_traffic(mix):
    a, b = traffic.Plan(traffic.load(mix), 7), traffic.Plan(traffic.load(mix), 8)
    assert a.start_offsets != b.start_offsets
    assert [a.turn(s, k) for s in range(4) for k in range(4)] != [b.turn(s, k) for s in range(4) for k in range(4)]


@pytest.mark.parametrize("mix", ["voice16", "text16"])
def test_every_seed_gets_the_same_sizes(mix):
    m = traffic.load(mix)
    plans = [traffic.Plan(m, seed) for seed in (1, 2, BIG)]
    for s in range(m["sessions"]):
        sizes = [sorted(p.turn(s, k).reply_tokens for k in range(m["pool"])) for p in plans]
        assert sizes[0] == sizes[1] == sizes[2]
    assert sorted(plans[0].start_offsets) == sorted(plans[1].start_offsets)


def test_voice_utterance_layout():
    plan = traffic.Plan(traffic.load("voice16"), 3)
    turn = plan.turn(0, 0)
    pcm, speech_end = plan.utterance(turn)
    rate = plan.mix["sample_rate"]
    assert pcm.dtype == np.int16
    assert speech_end == int(0.2 * rate) + int(turn.tone_s * rate)
    assert len(pcm) == speech_end + int(0.8 * rate)
    assert not pcm[:int(0.2 * rate)].any() and not pcm[speech_end:].any()
    assert 1.0 <= turn.tone_s <= 4.0 and 3 <= turn.reply_tokens <= 8


def test_text_turns_have_their_word_counts():
    m = traffic.load("text16")
    plan = traffic.Plan(m, 5)
    counts = sorted(len(plan.turn(2, k).text.split()) for k in range(m["pool"]))
    assert counts == sorted(int(round(x)) for x in np.linspace(4, 20, m["pool"]))
