"""Metric readers, one module a metric, found by the metric's name.

Each module ``<name>.py`` has ``read(run) -> float | None``: *run* is the
finished run (:class:`s2sbench.run.RunData`: the turns and their event
times, the window, the profiled window in a traced run, the compile
watch's count, the configuration).  A reader that finds nothing to read
returns None and the harness leaves the metric out of the line.
"""

from __future__ import annotations

import importlib
import re

from s2sbench import stats

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def reader(name: str):
    """The reader module of metric *name* (dots in a name become ``__``)."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    return importlib.import_module(f"s2sbench.metrics.{name.replace('.', '__').replace('-', '_')}")


def audio_rate(run) -> float:
    """Audio seconds that reached the clients inside the window, a second."""
    events = [(t, n / turn["rate"]) for turn in run.turns for t, n in turn["audio"]]
    return stats.rate(events, run.t0, run.t1)


def ok(turn: dict) -> bool:
    """A turn that did not fail: no error event, a response.done within its
    limit, and reply audio."""
    return not turn["errors"] and turn["t_done"] is not None and bool(turn["audio"])


def times(run, start: str, end: str) -> list[float]:
    """end - start of every turn in flight in the window that did not fail
    and has both."""
    out = []
    for t in run.window_turns:
        if ok(t) and t.get(start) is not None and t.get(end) is not None:
            out.append(t[end] - t[start])
    return out
