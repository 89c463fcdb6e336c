"""Console entry point of the port: ``s2s-tpu-torch {serve,talk,local}`` /
``python -m s2s_tpu_torch.cli serve [--device {cuda,cpu}] <s2s_tpu flags>``.

- ``serve`` runs the realtime voice-agent server (bare options mean serve);
- ``talk`` connects the audio client to a running server (live with
  ``sounddevice``, else headless with ``--input_wav``/``--output_wav``);
- ``local`` runs the server and a loopback client in one process: server
  flags, then ``--``, then client flags;
- ``tp-follower`` is one follower rank of a ``--model_parallel`` serve,
  started by the serve itself (``builder.launch_tp``).

The flags are the JAX package's (``s2s_tpu_torch.arguments`` is its copy of
``s2s_tpu/arguments.py``), so ``scripts/run_soak.py``'s command lines work
verbatim.  ``--device`` (``serve`` and ``local``; default ``cuda``) is
stripped before they are parsed; ``cuda`` without a card raises, and
``cpu`` exists for the tests.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading

import torch

logger = logging.getLogger(__name__)

COMMANDS = ("serve", "talk", "local", "tp-follower")


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


def _setup_logging(level: str) -> None:
    logging.basicConfig(level=getattr(logging, level.upper(), logging.INFO),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def parse_with_device(argv: list[str]):
    """Parse *argv* (``--device`` included): returns (device, parsed args)."""
    from s2s_tpu_torch.arguments import parse_arguments

    device_name, rest = split_device(argv)
    return resolve_device(device_name), parse_arguments(rest)


def build_from_argv(argv: list[str], stop_event: threading.Event, tp_layout=None):
    """Parse *argv* (``--device`` included) and build the pipeline:
    returns (thread manager, server, parsed args), not started.
    *tp_layout* places the ranks of ``--model_parallel`` (see
    ``builder.launch_tp``)."""
    from s2s_tpu_torch.builder import build_pipeline

    device, args = parse_with_device(argv)
    manager, server = build_pipeline(args, stop_event, device, tp_layout)
    return manager, server, args


def run_serve(argv: list[str]) -> None:
    stop_event = threading.Event()
    _setup_logging("info")
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


def run_talk(argv: list[str]) -> None:
    import argparse
    from dataclasses import fields

    from s2s_tpu_torch.arguments import ClientArgs
    from s2s_tpu_torch.client import run_realtime_audio_client

    parser = argparse.ArgumentParser(prog="s2s-tpu-torch talk")
    for f in fields(ClientArgs):
        typ = {int: int, float: float}.get(f.type if isinstance(f.type, type) else str, str)
        parser.add_argument(f"--{f.name}", type=typ, default=f.default)
    ns = parser.parse_args(argv)
    _setup_logging("info")
    run_realtime_audio_client(ns)


def run_local(argv: list[str]) -> None:
    """Server + loopback client in one process: ``[--device X] <server
    flags> -- <client flags>``."""
    import time

    from s2s_tpu_torch.builder import build_pipeline

    split = argv.index("--") if "--" in argv else len(argv)
    server_argv, client_argv = argv[:split], argv[split + 1 :]
    device, args = parse_with_device(server_argv)
    args.server.port = args.server.port or 0
    _setup_logging(args.module.log_level)
    stop_event = threading.Event()
    manager, server = build_pipeline(args, stop_event, device)
    manager.start()
    try:
        if not server.started.wait(30):
            raise SystemExit("server failed to start")
        run_talk(["--url", f"ws://{args.server.host}:{server.bound_port}/v1/realtime", *client_argv])
        time.sleep(0.2)
    finally:
        stop_event.set()
        manager.stop()


def run_follower(argv: list[str]) -> int:
    """A follower rank (``s2s-tpu-torch tp-follower --rank R --store
    HOST:PORT``, started by ``builder.launch_tp``): joins the groups, builds its
    shards of the tensor-parallel engines (``registry.build_tp_engines``),
    replays the leader's programs until its stop, then leaves each engine's
    ``state_summary`` in the store.  Exits non-zero if any of that fails,
    among others when the leader is gone or a collective times out."""
    import argparse
    import json
    import pickle
    from datetime import timedelta

    import torch.distributed as dist

    from s2s_tpu_torch.builder import full_f32
    from s2s_tpu_torch.parallel.mesh import TPRuntime, rank_report
    from s2s_tpu_torch.registry import build_tp_engines

    parser = argparse.ArgumentParser(prog="s2s-tpu-torch tp-follower")
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--store", required=True, help="HOST:PORT of the leader's TCPStore")
    ns = parser.parse_args(argv)
    host, port = ns.store.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), is_master=False, timeout=timedelta(seconds=120))
    args, layout, timeout_s = pickle.loads(store.get("tp/args"))
    logging.basicConfig(level=getattr(logging, args.module.log_level.upper(), logging.INFO),
                        format=f"%(asctime)s %(levelname)s tp-rank-{ns.rank} %(name)s: %(message)s")
    full_f32()
    runtime = TPRuntime(ns.rank, layout, store, timeout_s)
    failed: list[BaseException] = []

    def follow(engine) -> None:
        try:
            engine.follow()
        except BaseException as e:  # noqa: BLE001 - reported by the exit code
            logger.exception("TP follower loop failed")
            failed.append(e)

    try:
        engines = build_tp_engines(args, runtime)
        threads = [threading.Thread(target=follow, args=(engine,), name=f"tp-follow-{name}")
                   for name, engine in engines.items()]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()
        if not failed:
            for name, engine in engines.items():
                store.set(runtime.summary_key(name, ns.rank), json.dumps(engine.state_summary()))
            store.set(runtime.report_key(ns.rank), json.dumps(rank_report(runtime.device)))
    finally:
        runtime.shutdown()
    return 1 if failed else 0


def main() -> None:
    argv = sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: s2s-tpu-torch {{{','.join(COMMANDS)}}} [--device {{cuda,cpu}}] [options]\n")
        print("  serve  run the realtime voice-agent server on the PyTorch/CUDA port")
        print("  talk   connect an audio client to a running server")
        print("  local  server + loopback client in one process (server flags -- client flags)")
        print("  tp-follower  one follower rank of a --model_parallel serve (the serve starts them)")
        return
    command, rest = argv[0], argv[1:]
    if command not in COMMANDS:
        # bare options default to serve
        command, rest = "serve", argv
    if command == "tp-follower":
        sys.exit(run_follower(rest))
    {"serve": run_serve, "talk": run_talk, "local": run_local}[command](rest)


if __name__ == "__main__":
    main()
