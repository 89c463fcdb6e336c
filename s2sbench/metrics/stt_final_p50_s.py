"""Median, over window voice turns, of ``input_audio_buffer.speech_stopped``
to ``conversation.item.input_audio_transcription.completed``: endpointing's
end to the final transcript (VAD and STT)."""

from s2sbench import stats
from s2sbench.metrics import times


def read(run):
    return stats.median(times(run, "t_speech_stopped", "t_transcribed"))
