"""90th percentile of the same time to first audio over all window turns."""

from s2sbench import stats
from s2sbench.metrics import times


def read(run):
    return stats.percentile(times(run, "t_req", "t_first_audio"), 90.0)
