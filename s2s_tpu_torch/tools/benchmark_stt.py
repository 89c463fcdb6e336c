"""Per-handler STT benchmark.

The port of ``scripts/benchmark_stt.py``: ``handler.process`` driven
directly, with no pipeline threads, on synthetic (or WAV) audio: the
warm-up, the average, least, most and spread of the transcription time,
RTFx, a transcript sample and, with ``--progressive``, one progressive tick,
as one JSON line under the JAX script's keys.  The handler is built on
``--device`` with no checkpoint (random weights from seed 0, as the
handlers draw them).  Beside the JAX keys: the transcriptions made
(``transcriptions``), the launches of the kernels a transcription may run
over all of them (``launches``: Whisper's encoder attention, one launch a
layer; the log-mel of Whisper and Paraformer; Parakeet's batched frontend)
and over each timed run (``run_launches``).  Run from the repository root:

    python -m s2s_tpu_torch.tools.benchmark_stt --stt whisper --model_size distil-large-v3 --runs 5

``--device cpu --model_size tiny`` runs on the CPU.  On the card the
card's ``nvidia-smi`` name and power limit follow on a line of their own.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
import wave
from queue import Queue

import numpy as np
import torch

from s2s_tpu_torch.ops import flash_attention as fa
from s2s_tpu_torch.ops import log_mel
from s2s_tpu_torch.tools.microbench_decode import card

#: the kernels a transcription may launch, by their counters' names
KERNELS = {"flash_attention": fa.flash_attention, "log_mel": log_mel.log_mel_spectrogram,
           "parakeet_log_mel": log_mel.parakeet_log_mel}


def load_audio(path: str | None, seconds: float, rate: int = 16000) -> np.ndarray:
    if path:
        with wave.open(path) as w:
            return np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float32) / 32768.0
    t = np.arange(int(seconds * rate)) / rate
    return (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


def build_handler(backend: str, model_size: str, language: str | None, device: torch.device):
    stop = threading.Event()
    kwargs = dict(model_size=model_size, language=language, warmup=False, device=device)
    if backend == "parakeet-tdt":
        from s2s_tpu_torch.stt.parakeet_handler import ParakeetSTTHandler

        return ParakeetSTTHandler(stop, Queue(), Queue(), setup_kwargs=kwargs)
    if backend == "paraformer":
        from s2s_tpu_torch.stt.paraformer_handler import ParaformerSTTHandler

        return ParaformerSTTHandler(stop, Queue(), Queue(), setup_kwargs=kwargs)
    from s2s_tpu_torch.stt.whisper_handler import WhisperSTTHandler

    return WhisperSTTHandler(stop, Queue(), Queue(), setup_kwargs=kwargs)


def _launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _since(before: dict[str, int]) -> dict[str, int]:
    return {name: n - before[name] for name, n in _launches().items()}


def run(backend: str = "whisper", model_size: str = "tiny", language: str | None = "en", audio: str | None = None,
        seconds: float = 5.0, runs: int = 5, progressive: bool = False, device: str = "cuda") -> dict:
    """The JAX script's run of one handler on *device*; returns its JSON line."""
    from s2s_tpu_torch.pipeline.messages import VADAudio

    device = torch.device(device)
    samples = load_audio(audio, seconds)
    handler = build_handler(backend, model_size, language, device)
    decode, made = handler.streamer.decode_fn, []

    def counted(window):
        made.append(len(window))
        return decode(window)

    handler.streamer.decode_fn = counted
    start = _launches()
    t0 = time.perf_counter()
    list(handler.process(VADAudio(audio=samples, mode="final")))
    warmup_s = time.perf_counter() - t0
    handler.on_session_end()

    times, run_launches = [], []
    transcript = ""
    for _ in range(runs):
        before = _launches()
        t0 = time.perf_counter()
        out = list(handler.process(VADAudio(audio=samples, mode="final")))
        times.append(time.perf_counter() - t0)
        run_launches.append(_since(before))
        handler.on_session_end()
        if out:
            transcript = out[0].text

    result = {
        "backend": backend,
        "model_size": model_size,
        "audio_s": len(samples) / 16000,
        "warmup_s": warmup_s,
        "avg_s": statistics.mean(times),
        "min_s": min(times),
        "max_s": max(times),
        "std_s": statistics.pstdev(times),
        "rtfx": len(samples) / 16000 / statistics.mean(times),
        "transcript_sample": transcript[:120],
    }
    if progressive:
        t0 = time.perf_counter()
        list(handler.process(VADAudio(audio=samples[:16000], mode="progressive")))
        result["progressive_tick_s"] = time.perf_counter() - t0
    result.update(device=device.type, transcriptions=len(made), launches=_since(start), run_launches=run_launches)
    return result


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--stt", default="whisper", choices=["whisper", "parakeet-tdt", "paraformer"])
    parser.add_argument("--model_size", default="tiny")
    parser.add_argument("--language", default="en")
    parser.add_argument("--audio", default=None, help="wav file (16 kHz mono); synthetic otherwise")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--progressive", action="store_true", help="also time progressive ticks")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("benchmark_stt: no CUDA device (pass --device cpu for a CPU run)")
    print(json.dumps(run(args.stt, args.model_size, args.language, args.audio, args.seconds, args.runs,
                         args.progressive, args.device)), flush=True)
    if torch.device(args.device).type == "cuda":
        print(json.dumps({"card": card(), "device_name": torch.cuda.get_device_name(args.device)}))


if __name__ == "__main__":
    main()
