"""Readings for the limits of ``correct``: the program's numbers and the
control's, seed by seed, for one cell, in one process.

    python3 -m s2sbench.calibrate --workload <name> --seeds 1,2,3 --seconds 20

Each seed runs the cell as :mod:`s2sbench.run` does (its own serve,
weights and traffic from the seed, a window of the given seconds) and
prints one JSON line: the numbers compared (the program's) and the
control's (the reference one precision down, on the same prompts, tokens,
frames and audio).  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def summary(turn: dict, t0: float) -> dict:
    """A turn's event times relative to its request (its request's to the window's start)."""
    req = turn["t_req"]
    out = {k: turn[k] for k in ("session", "index", "warmup", "reply_tokens", "status")}
    out["req"] = None if req is None else round(req - t0, 3)
    for key in ("t_speech_stopped", "t_transcribed", "t_first_text", "t_first_audio", "t_done"):
        out[key[2:]] = None if turn.get(key) is None or req is None else round(turn[key] - req, 3)
    out["audio_s"] = round(sum(n for _, n in turn["audio"]) / turn["rate"], 3)
    out["deltas"] = len(turn["audio"])
    out["errors"] = turn["errors"][:2]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(prog="python3 -m s2sbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--sessions", type=int, default=None,
                        help="run the mix with this many sessions instead (a load sweep)")
    parser.add_argument("--turn_limit", type=float, default=None, help="the mix's turn limit instead")
    parser.add_argument("--turns", action="store_true", help="also print every turn's event times")
    args = parser.parse_args()
    from s2sbench import run
    from s2sbench.metrics import reader

    run.cache_env()
    root = Path.cwd()
    cell, _, config, mix = run.load_cell(root, args.workload)
    if args.sessions:
        mix = dict(mix, sessions=args.sessions)
    if args.turn_limit:
        mix = dict(mix, turn_limit_s=args.turn_limit)
    import torch

    if not torch.cuda.is_available():
        print("s2sbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        out = run.run_cell(root, cell, config, mix, seed, args.seconds, False, device, control=True)
        d = out["data"]
        metrics = {name: reader(name).read(d) for name in ("audio_s_per_s", "ttfa_p50_s", "ttfa_p90_s",
                                                           "stream_rtf_p50", "llm_first_text_p50_s")}
        print(json.dumps({"workload": cell["name"], "seed": seed, "numbers": out["judge"]["numbers"],
                          "sampled": out["judge"]["sampled"], "attempted": len(d.window_turns),
                          "failures": run.failures(d), "setup_s": d.setup_s, "serve_s": out["serve_s"],
                          "sessions": mix["sessions"], "wall_s": time.monotonic() - t, "metrics": metrics,
                          "records": out["judge"].get("records")}), flush=True)
        if args.turns:
            for turn in d.turns:
                print(json.dumps({"turn": summary(turn, d.t0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
