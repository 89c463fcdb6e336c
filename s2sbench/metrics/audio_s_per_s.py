"""Reply audio delivered to all clients over the window: the PCM16 of every
``response.output_audio.delta`` that arrived inside the window, in seconds
at the stream's rate, over the window's seconds."""

from s2sbench.metrics import audio_rate


def read(run):
    return audio_rate(run)
