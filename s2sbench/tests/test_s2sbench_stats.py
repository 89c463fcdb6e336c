"""Percentiles are taken over all turns and rates over the whole window;
the metric readers read them so."""

from __future__ import annotations

import pytest

from s2sbench import stats
from s2sbench.metrics import reader
from s2sbench.run import RunData


def test_percentile_interpolates_over_every_value():
    vals = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.median(vals) == 3.0
    assert stats.percentile(vals, 90) == pytest.approx(4.6)
    assert stats.percentile([], 50) is None


def test_rate_counts_only_the_window_over_its_whole_length():
    events = [(0.5, 10.0), (1.0, 1.0), (2.0, 2.0), (2.999, 3.0), (3.0, 100.0)]
    assert stats.rate(events, 1.0, 3.0) == pytest.approx(3.0)


def _turn(t_req, ttfa, audio, warmup=False, kind="text", **kw):
    t = {"warmup": warmup, "kind": kind, "t_req": t_req, "t_first_audio": t_req + ttfa if audio else None,
         "t_done": t_req + ttfa + 1.0, "errors": [], "audio": audio, "rate": 24000, "usage": None}
    t.update(kw)
    return t


def _run(turns, t0=10.0, t1=20.0):
    window = [t for t in turns if not t["warmup"] and t0 <= t["t_req"] < t1]
    return RunData(t0=t0, t1=t1, seconds=t1 - t0, turns=turns, window_turns=window, setup_s=3.0, profile=None,
                   variants_after_warmup=0, lm_max_t=512, models={})


def test_ttfa_median_and_tail_over_every_window_turn():
    turns = [_turn(11.0 + i * 0.5, float(i + 1), [(12.0 + i, 2400)]) for i in range(10)]
    turns.append(_turn(5.0, 100.0, [(6.0, 2400)]))  # before the window
    turns.append(_turn(21.0, 100.0, [(22.0, 2400)]))  # after it
    turns.append(_turn(12.0, 50.0, []))  # failed: no audio, no time
    run = _run(turns)
    assert reader("ttfa_p50_s").read(run) == pytest.approx(5.5)
    assert reader("ttfa_p90_s").read(run) == pytest.approx(9.1)


def test_audio_rate_counts_deltas_inside_the_window_from_every_turn():
    turns = [_turn(5.0, 1.0, [(9.0, 24000), (10.0, 24000), (19.9, 48000), (20.0, 24000)], warmup=True),
             _turn(12.0, 1.0, [(13.0, 24000)])]
    assert reader("audio_s_per_s").read(_run(turns)) == pytest.approx(4.0 / 10.0)


def test_stream_rtf_per_reply():
    turns = [_turn(11.0, 1.0, [(12.0, 24000), (13.0, 24000), (14.0, 24000)])]
    assert reader("stream_rtf_p50").read(_run(turns)) == pytest.approx(1.5)


def test_device_readers_find_nothing_without_a_profile():
    run = _run([_turn(11.0, 1.0, [(12.0, 2400)])])
    for name in ("device_idle_pct", "elementwise_ms_per_audio_s", "port_kernel_ms_per_audio_s"):
        assert reader(name).read(run) is None


def test_profile_window_reduction_and_device_readers():
    from s2sbench.profile import Window

    events = [("void weight_only::weight_only_gemv_kernel<...>", 10.0, 0.2), ("nvjet_tst_64x8", 10.1, 0.2),
              ("void at::native::elementwise_kernel<...>", 10.5, 0.1), ("Memcpy DtoD (Device -> Device)", 11.0, 0.5)]
    w = Window(10.0, 12.0, events)
    assert w.busy_s() == pytest.approx(0.3 + 0.1 + 0.5)
    assert w.seconds_of("port") == pytest.approx(0.2) and w.seconds_of("gemm") == pytest.approx(0.2)
    assert w.seconds_of("other") == pytest.approx(0.1)
    assert w.gaps(1)[0][1] == pytest.approx(0.4) and w.gaps(1)[0][0].startswith("after void at::native")
    run = _run([_turn(11.0, 1.0, [(12.0, 24000 * 5)])])
    run.profile = w
    assert reader("device_idle_pct").read(run) == pytest.approx(100 * (1 - 0.9 / 2.0))
    # 0.1 s of other kernels in 2 s, at 0.5 audio s/s: 100 ms per audio second
    assert reader("elementwise_ms_per_audio_s").read(run) == pytest.approx(100.0)
    assert reader("port_kernel_ms_per_audio_s").read(run) == pytest.approx(200.0)
