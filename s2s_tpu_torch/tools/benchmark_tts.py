"""Per-handler TTS benchmark.

The port of ``scripts/benchmark_tts.py``: ``handler.process`` timed
directly on one sentence: the warm-up, the average time of a synthesis and
to its first chunk (TTFC), the audio produced and the real-time factor
(audio seconds over wall seconds), as one JSON line under the JAX script's
keys.  The handler is built as the serve builds it, through the registry's
factory for ``--tts`` on ``--device`` with the backend's default arguments
and no checkpoint (random weights from seed 0); ``--quantize int8`` builds
Qwen3-TTS int8 weight-only (``--tts_quantize int8``), so its talker and
code predictor run on the W8A16 kernel.  ChatTTS's speaker is drawn from
seed 0 (:data:`CHATTTS_SEED`; the JAX script leaves it unseeded), so that a
run repeats.  Beside the JAX keys: the W8A16 kernel's launches over each
timed run and over the whole run (warm-up included).  Run from the
repository root:

    python -m s2s_tpu_torch.tools.benchmark_tts --tts qwen3 --runs 3 [--quantize int8]

``--device cpu --model_size tiny`` runs Qwen3-TTS on the CPU.  On the card
the card's ``nvidia-smi`` name and power limit follow on a line of their own.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
from queue import Queue

import torch

from s2s_tpu_torch.ops import int8_matmul as mm
from s2s_tpu_torch.tools.microbench_decode import card

SENTENCE = "This is a representative assistant reply used to benchmark synthesis."
#: the seed of ChatTTS's speaker (``--tts_seed``)
CHATTTS_SEED = 0


def build_handler(backend: str, model_size: str, quantize: str | None = None, device: str = "cuda",
                  model_cache=None):
    """*backend*'s handler from its registry factory on *device*, its model
    taken from *model_cache* (a new, empty cache by default)."""
    from s2s_tpu_torch import registry

    spec = registry.get_backend("tts", backend)
    fields = {"qwen3": dict(model_size=model_size, quantize=quantize), "chatTTS": dict(seed=CHATTTS_SEED)}
    ctx = registry.HandlerContext(
        stop_event=threading.Event(), queue_in=Queue(), queue_out=Queue(), text_output_queue=Queue(),
        should_listen=None, cancel_scope=None, speculative_turns=None, device_scheduler=None,
        model_cache=model_cache if model_cache is not None else registry.ModelCache(), device=torch.device(device))
    return spec.create_handler(spec.config_type(**fields.get(backend, {})), ctx)


def run(backend: str = "qwen3", model_size: str = "1.7b", quantize: str | None = None, text: str = SENTENCE,
        runs: int = 3, device: str = "cuda", model_cache=None) -> dict:
    """The JAX script's run of one handler on *device*; returns its JSON line."""
    from s2s_tpu_torch.pipeline.messages import TTSInput

    start = mm.int8_matmul.launches
    handler = build_handler(backend, model_size, quantize, device, model_cache)

    def run_once():
        before = mm.int8_matmul.launches
        t0 = time.perf_counter()
        ttfc = None
        samples = 0
        for chunk in handler.process(TTSInput(text=text)):
            if ttfc is None:
                ttfc = time.perf_counter() - t0
            samples += len(chunk)
        return time.perf_counter() - t0, ttfc or 0.0, samples, mm.int8_matmul.launches - before

    warmup_s, _, _, _ = run_once()
    totals, ttfcs, durations, launches = [], [], [], []
    for _ in range(runs):
        total, ttfc, samples, n = run_once()
        totals.append(total)
        ttfcs.append(ttfc)
        durations.append(samples / 16000)
        launches.append(n)

    avg_total = statistics.mean(totals)
    avg_audio = statistics.mean(durations)
    return {
        "backend": backend,
        "quantize": quantize,
        "warmup_s": warmup_s,
        "avg_inference_s": avg_total,
        "avg_ttfc_s": statistics.mean(ttfcs),
        "avg_audio_s": avg_audio,
        "rtf": avg_audio / avg_total if avg_total else None,
        "device": torch.device(device).type,
        "int8_matmul_run_launches": launches,
        "int8_matmul_launches": mm.int8_matmul.launches - start,
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tts", default="qwen3", choices=["qwen3", "kokoro", "pocket", "chatTTS", "facebookMMS"])
    parser.add_argument("--model_size", default="1.7b")
    parser.add_argument("--quantize", default=None, choices=[None, "int8"],
                        help="qwen3: weight-only int8 (--tts_quantize int8)")
    parser.add_argument("--text", default=SENTENCE)
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("benchmark_tts: no CUDA device (pass --device cpu for a CPU run)")
    print(json.dumps(run(args.tts, args.model_size, args.quantize, args.text, args.runs, args.device)), flush=True)
    if torch.device(args.device).type == "cuda":
        print(json.dumps({"card": card(), "device_name": torch.cuda.get_device_name(args.device)}))


if __name__ == "__main__":
    main()
