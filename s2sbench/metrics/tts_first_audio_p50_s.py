"""Median, over window turns, of the first transcript delta to the first
audio delta (the TTS handler and engine's first chunk)."""

from s2sbench import stats
from s2sbench.metrics import times


def read(run):
    return stats.median(times(run, "t_first_text", "t_first_audio"))
