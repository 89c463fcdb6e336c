"""Median, over window turns, of the LM's trigger (the final transcript of
a voice turn, ``response.create`` of a text turn) to the first
``response.output_audio_transcript.delta``."""

from s2sbench import stats
from s2sbench.metrics import ok


def read(run):
    vals = []
    for t in run.window_turns:
        trigger = t.get("t_transcribed") if t["kind"] == "voice" else t["t_req"]
        if ok(t) and trigger is not None and t.get("t_first_text") is not None:
            vals.append(t["t_first_text"] - trigger)
    return stats.median(vals)
