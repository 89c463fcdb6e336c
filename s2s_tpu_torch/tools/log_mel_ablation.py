"""Where the log-mel kernel's time goes, by ablation, on one NVIDIA GPU.

Run from the repository root: ``python3 s2s_tpu_torch/tools/log_mel_ablation.py
[variant ...]``.  Each variant is a copy of the package under
``build/log_mel_ablation/<variant>/`` whose ``csrc/log_mel.cu`` has one part
switched off; it is built and timed in a process of its own (one build of
the kernel library a process), at the Whisper shapes 1, 8 and 30 s and the
Parakeet batches 1 x 1 s, 4 x 3 s and 16 x 15 s, device time per call from
CUDA graphs (``chip_smoke.device_ms``).  Variants:

- ``full``: the kernel as it is;
- ``no_tiles``: no tile is computed (launch, tables, barriers, epilogue);
- ``no_tables_no_tiles``: nor are the tables loaded;
- ``no_mel``: the tiles skip the mel projection and the log;
- ``no_fft``: the tiles skip the FFT stages;
- ``no_row_sums``: Parakeet's blocks skip the sums of their rows' partials;
- ``no_stats``: Parakeet's blocks skip both passes after the first barrier
  (the squared deviations and the normalized output).

Outputs of the ablated variants are wrong by design; only their times mean
anything.  Prints one JSON line a variant, then the card's ``nvidia-smi``
name and power limit.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "s2s_tpu_torch"
OUT = ROOT / "build" / "log_mel_ablation"
NO_TILES = ("last = min(first + a.tiles_per_block, n_tiles);", "last = first;")
NO_TABLES = tuple((f"  for (int i = tid; i < {n}; i += nt)", f"  if (false) for (int i = tid; i < {n}; i += nt)")
                  for n in ("a.n_fft", "a.n_wts", "3 * n_mels"))
NO_MEL = ("    for_pairs(nf, n_mels, [&](int f, int m) {\n      const int lo",
          "    if (false) for_pairs(nf, n_mels, [&](int f, int m) {\n      const int lo")
NO_FFT = ("    for (int plan = a.radices; plan; plan >>= 4) {", "    for (int plan = 0; plan; plan >>= 4) {")
NO_ROW_SUMS = (("      row_sum<1>(part1, 0, a, row, (valid + ff - 1) / ff, xs, stats);", ""),
               ("      row_sum<2>(part1, part2 - part1, a, row, vt, xs, stats);", ""))
NO_STATS = (("  seg = 0.f, seg_row = -1;\n  for (int tile = first; tile < last; ++tile) {",
             "  seg = 0.f, seg_row = -1;\n  for (int tile = first; tile < first; ++tile) {"),
            ("  seg_row = -1;\n  for (int tile = first; tile < last; ++tile) {",
             "  seg_row = -1;\n  for (int tile = first; tile < first; ++tile) {"))
VARIANTS = {"full": (), "no_tiles": (NO_TILES,), "no_tables_no_tiles": (NO_TILES, *NO_TABLES),
            "no_mel": (NO_MEL,), "no_fft": (NO_FFT,), "no_row_sums": NO_ROW_SUMS, "no_stats": NO_STATS}
SHAPES = [("whisper", 1, 1, 80), ("whisper", 1, 8, 80), ("whisper", 1, 30, 128),
          ("parakeet", 1, 1, 128), ("parakeet", 4, 3, 128), ("parakeet", 16, 15, 128)]

TIMER = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import chip_smoke
from s2s_tpu_torch.ops import _build, log_mel
assert log_mel.__file__.startswith(sys.argv[1]), log_mel.__file__
_build.build()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(3)
times = {}
for kind, rows, seconds, n_mels in json.loads(sys.argv[3]):
    n = seconds * 16_000
    audio = torch.stack([chip_smoke._speech_like(n, gen, dev) for _ in range(rows)])
    if kind == "parakeet":
        n_valid = torch.full((rows,), n, dtype=torch.int32, device=dev)
        fn = lambda i: log_mel.parakeet_log_mel(audio, n_valid)
    else:
        fn = lambda i: log_mel.log_mel_spectrogram(audio[0], n_mels)
    times[f"{kind}_{rows}x{seconds}s_us"] = chip_smoke.device_ms(fn, 20) * 1e3
print(json.dumps(times))
'''


def patched(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"ablation patch does not apply: {old!r}")
        source = source.replace(old, new)
    return source


def main(names: list[str]) -> int:
    source = (PACKAGE / "csrc" / "log_mel.cu").read_text()
    failed = 0
    for name in names or list(VARIANTS):
        dst = OUT / name
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(PACKAGE, dst / "s2s_tpu_torch", ignore=shutil.ignore_patterns("__pycache__"))
        (dst / "s2s_tpu_torch" / "csrc" / "log_mel.cu").write_text(patched(source, VARIANTS[name]))
        proc = subprocess.run([sys.executable, "-c", TIMER, str(dst), str(ROOT), json.dumps(SHAPES)],
                              capture_output=True, text=True, cwd=ROOT, timeout=900)
        if proc.returncode:
            failed += 1
            print(json.dumps({"variant": name, "error": proc.stderr[-2000:]}), flush=True)
        else:
            print(json.dumps({"variant": name, **json.loads(proc.stdout.strip().splitlines()[-1])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
