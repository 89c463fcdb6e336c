"""Median time to first audio over every turn in flight in the window
(requested before its end, not done before its start): from the request
(a voice turn's last voiced chunk sent, a text turn's ``response.create``)
to its first ``response.output_audio.delta``.  A failed turn has no time;
it counts in ``failed``."""

from s2sbench import stats
from s2sbench.metrics import times


def read(run):
    return stats.median(times(run, "t_req", "t_first_audio"))
