"""Device milliseconds a second of the port's hand kernels (matched by the
names the profiler prints against ``s2sbench.profile.PORT_KERNELS``), in
the profiled part of the window, over the audio seconds the window
delivered a second: their device time per second of reply audio."""

from s2sbench.metrics import audio_rate


def read(run):
    w, audio = run.profile, audio_rate(run)
    if w is None or audio <= 0:
        return None
    port = w.seconds_of("port")
    return port / w.seconds * 1e3 / audio if port > 0 else None
