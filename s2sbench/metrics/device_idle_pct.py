"""Share of the profiled window in which no device operation ran."""


def read(run):
    w = run.profile
    if w is None or not w.events:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.seconds)
