"""Device milliseconds a second of the kernels that are neither the port's
nor a library matrix product, in the profiled part of the window, over the
audio seconds the window delivered a second: their device time per second
of reply audio."""

from s2sbench.metrics import audio_rate


def read(run):
    w, audio = run.profile, audio_rate(run)
    if w is None or not w.events or audio <= 0:
        return None
    return w.seconds_of("other") / w.seconds * 1e3 / audio
