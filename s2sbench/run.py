"""Run one cell of the benchmark once.

    python3 -m s2sbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with a CUDA card.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(``s2sbench/configs/<config>.json``: the serve's flags and the models'
shapes) and a traffic mix (``s2sbench/traffic/<mix>.json``).  The run
makes every model's weights on the card from the seed, builds and warms
the port's realtime serve in this process (set-up ends when it listens),
starts the mix's clients in a child process, lets each session's first
turn run outside the window, measures the window, follows its turns to their end,
stops the serve, holds a seeded sample of what the serve produced against
the plain reference (``s2sbench/reference/``), and prints one JSON line:
the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1`` (which also profiles a few seconds of the window).
Every metric is read by its own module, ``s2sbench/metrics/<name>.py``.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: where the program's build and kernel caches live: fixed, inside the checkout
CACHE = ROOT / "build" / "s2sbench"
#: the profiled part of a traced window: its start and length as shares of the window
PROFILE_AT, PROFILE_FOR = 0.3, 0.15


def cache_env() -> None:
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class RunData:
    """What the metric readers read."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(the BENCHMARK.json entry of *workload*, the benchmark, the
    configuration, the mix)."""
    from s2sbench import traffic

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = json.loads((root / "s2sbench" / "configs" / f"{cell['config']}.json").read_text())
    return cell, bench, config, traffic.load(cell["traffic"], root / "s2sbench")


def metric_names(bench: dict, cell: dict, trace: bool) -> list[str]:
    """The cell's end-to-end metrics, or with *trace* its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m["name"] for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return {"nvidia_smi": out}


def _reader(stream, lines: queue.Queue) -> None:
    for line in stream:
        lines.put(line)
    lines.put(None)


def run_cell(root: Path, cell: dict, config: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device, control: bool = False) -> dict:
    """One run of *cell*: the run's data, the judge's numbers (with
    *control*, the control's beside them) and the device readings (none on
    a CPU device)."""
    import torch

    from s2sbench import profile, serve
    from s2sbench.reference import judge

    cuda = device.type == "cuda"
    if trace and cuda:
        # torch.profiler imports torch.distributed.tensor when it starts; the
        # LM engine's threads look that module up in sys.modules at every
        # product, and must not find it half imported
        import torch.distributed.tensor  # noqa: F401
        import torch.profiler  # noqa: F401
    if cuda:
        torch.empty(0, device=device)  # the allocator's stats exist once the device is in use
        torch.cuda.reset_peak_memory_stats(device)
    t_serve = time.monotonic()
    srv = serve.Serve(config, seed, device, root)
    t_ready = time.monotonic()  # built, warmed up and listening: set-up ends here
    serve_s = t_ready - t_serve
    child = None
    try:
        env = dict(os.environ, PYTHONPATH=str(root))
        child = subprocess.Popen([sys.executable, "-m", "s2sbench.clients"], cwd=str(root), env=env,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=_reader, args=(child.stdout, lines), daemon=True).start()
        child.stdin.write(json.dumps({"url": srv.url, "mix": mix, "seed": seed, "seconds": seconds}) + "\n")
        child.stdin.flush()
        window = result = prof = None
        deadline = time.monotonic() + 600
        while result is None:
            line = lines.get(timeout=max(1.0, deadline - time.monotonic()))
            if line is None:
                raise RuntimeError(f"the clients' process ended without a result (rc {child.wait()})")
            msg = json.loads(line)
            if "window" in msg:
                window = msg["window"]
                deadline = window[1] + mix["turn_limit_s"] + 120
                if trace and cuda:
                    prof = profile.record(device, window[0] + PROFILE_AT * seconds, PROFILE_FOR * seconds)
            elif "result" in msg:
                result = msg["result"]
        child.wait(timeout=60)
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else None
        variants = srv.variants_after_warmup()
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        srv.stop()
    srv.recorder.to_host()  # once the serve has stopped, nothing adds to it
    t0, t1 = result["t0"], result["t1"]
    turns = [t for s in result["sessions"] for t in s["turns"]]
    # the turns in flight in the window: requested before its end, not done before its start
    window_turns = [t for t in turns if t["t_req"] is not None and t["t_req"] < t1
                    and (t["t_done"] is None or t["t_done"] >= t0)]
    flags = serve.flag_values(config["serve_flags"])
    context = int(flags.get("tts_context_frames", 8))
    data = RunData(t0=t0, t1=t1, seconds=t1 - t0, setup_s=t_ready - T_START, turns=turns, window_turns=window_turns,
                   lm_max_t=int(flags.get("llm_batched_max_t", 512)), profile=prof, variants_after_warmup=variants,
                   models=config["models"], mix=mix, sessions=result["sessions"])
    verdict = judge.judge(srv.recorder, config["models"], seed, device, t0, context, control=control)
    return {"data": data, "judge": verdict, "serve_s": serve_s, "memory_peak": memory_peak, "child_jax": result.get("jax_modules", []),
            "session_errors": [s["error"] for s in result["sessions"] if s["error"]]}


def compare(numbers: dict, limits: dict, reported: tuple = ()) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}).  A number in
    *reported* (one whose control reading does not clear the program's by
    3x, so no limit holds) is listed with limit None and not held; any
    other number without a limit fails."""
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in sorted(numbers.items())
                if not k.startswith("control_")}
    held = [c for k, c in compared.items() if k not in reported]
    ok = bool(held) and all(c["limit"] is not None and c["value"] <= c["limit"] for c in held)
    return ok, compared


def failures(data: RunData) -> dict:
    from s2sbench.metrics import ok

    causes: dict = {}
    for t in data.window_turns:
        if ok(t):
            continue
        cause = "error" if t["errors"] else "no response.done within the turn limit" if t["t_done"] is None \
            else "no audio"
        causes[cause] = causes.get(cause, 0) + 1
    return causes


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m s2sbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    if not (root / "BENCHMARK.json").exists() or not (root / "s2s_tpu_torch").is_dir():
        print("s2sbench: run from the root of a checkout that holds BENCHMARK.json and s2s_tpu_torch/",
              file=sys.stderr)
        return 2
    cache_env()
    sys.path.insert(0, str(root))
    cell, bench, config, mix = load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"s2sbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(root, cell, config, mix, args.seed, args.seconds, bool(args.trace), device)
    data, verdict = out["data"], out["judge"]
    from s2sbench import nojax
    from s2sbench.metrics import reader

    found = nojax.loaded() + out["child_jax"]
    if found:
        print(f"s2sbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    for name in metric_names(bench, cell, bool(args.trace)):
        value = reader(name).read(data)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    correct, compared = compare(verdict["numbers"], config.get("limits", {}), tuple(config.get("reported", ())))
    attempted = len(data.window_turns)
    causes = failures(data)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell["chips"],
                   "memory_peak_bytes": int(out["memory_peak"])}
    line = {"correct": correct, "attempted": attempted, "failed": sum(causes.values()), "metrics": metrics,
            "device": device_info}
    if args.trace and data.profile is not None:
        device_info["busy_s"] = data.profile.busy_s()
        device_info["window_s"] = data.profile.seconds
        line["breakdown"] = {"device_ops": [[n, s] for n, s in data.profile.top()],
                             "idle_gaps": [[n, s] for n, s in data.profile.gaps()]}
    info = {"failures": causes, "session_errors": out["session_errors"], "sampled": verdict["sampled"],
            "lm_records": verdict["records"].get("lm"), "card": card(), "turns_total": len(data.turns),
            "setup_s": data.setup_s}
    print(json.dumps(info), file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line["compared"] = compared
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # noqa: BLE001 - the serve's threads must not keep a failed run alive
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
