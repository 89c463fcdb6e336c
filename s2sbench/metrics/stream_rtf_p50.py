"""Median, over window replies with two audio deltas or more, of the
reply's audio seconds over the time from its first to its last audio
delta: below 1, playback stalls."""

from s2sbench import stats
from s2sbench.metrics import ok


def read(run):
    vals = []
    for t in run.window_turns:
        if ok(t) and len(t["audio"]) >= 2:
            span = t["audio"][-1][0] - t["audio"][0][0]
            if span > 0:
                vals.append(sum(n for _, n in t["audio"]) / t["rate"] / span)
    return stats.median(vals)
