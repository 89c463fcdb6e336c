"""Console entry point of the port: ``s2s-tpu-torch serve`` /
``python -m s2s_tpu_torch.cli serve [--device {cuda,cpu}] <s2s_tpu flags>``.

The flags are the JAX package's (``s2s_tpu_torch.arguments`` is its copy of
``s2s_tpu/arguments.py``), so ``scripts/run_soak.py``'s command lines work
verbatim.  ``--device``
(default ``cuda``) is stripped before they are parsed; ``cuda`` without a
card raises, and ``cpu`` exists for the tests.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading

import torch

logger = logging.getLogger(__name__)


def split_device(argv: list[str]) -> tuple[str, list[str]]:
    """Remove ``--device X`` / ``--device=X`` from *argv*; returns (X, rest)."""
    device, rest, i = "cuda", [], 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--device" and i + 1 < len(argv):
            device, i = argv[i + 1], i + 2
            continue
        if tok.startswith("--device="):
            device = tok.split("=", 1)[1]
        else:
            rest.append(tok)
        i += 1
    return device, rest


def resolve_device(name: str) -> torch.device:
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is visible to PyTorch")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--device must be cuda or cpu, got {name!r}")


def build_from_argv(argv: list[str], stop_event: threading.Event):
    """Parse *argv* (``--device`` included) and build the pipeline:
    returns (thread manager, server, parsed args), not started."""
    from s2s_tpu_torch.arguments import parse_arguments
    from s2s_tpu_torch.builder import build_pipeline

    device_name, rest = split_device(argv)
    device = resolve_device(device_name)
    args = parse_arguments(rest)
    manager, server = build_pipeline(args, stop_event, device)
    return manager, server, args


def run_serve(argv: list[str]) -> None:
    stop_event = threading.Event()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    manager, _server, args = build_from_argv(argv, stop_event)
    logging.getLogger().setLevel(getattr(logging, args.module.log_level.upper(), logging.INFO))

    def handle_signal(signum, frame):
        logger.info("Signal %s received; shutting down", signum)
        stop_event.set()

    signal.signal(signal.SIGINT, handle_signal)
    signal.signal(signal.SIGTERM, handle_signal)
    manager.start()
    try:
        while not stop_event.is_set():
            stop_event.wait(0.5)
    finally:
        manager.stop()


def main() -> None:
    argv = sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: s2s-tpu-torch serve [--device {cuda,cpu}] [s2s-tpu serve options]\n")
        print("  serve  run the realtime voice-agent server on the PyTorch/CUDA port")
        return
    if argv[0] == "serve":
        argv = argv[1:]
    run_serve(argv)


if __name__ == "__main__":
    main()
