"""A tiny serve on the CPU through the harness's whole path: the port's
serve built with the seeded weights, the clients' process, the window,
the recorder and the reference's comparison.  No device metric comes out
of it, and a run without a card fails instead of falling back.

Each fault planted in the timed path (a token or an answer altered where
it is produced) must turn ``correct`` false.
"""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch
from conftest import ROOT, load

from s2sbench import run

SEED = 2 ** 31 + 77
CELL = {"name": "tiny", "chips": 1}


def _run(mix: str, seconds: float = 6.0):
    config = load("tiny_config.json")
    out = run.run_cell(ROOT, CELL, config, load(mix), SEED, seconds, True, torch.device("cpu"))
    correct, compared = run.compare(out["judge"]["numbers"], config["limits"], tuple(config.get("reported", ())))
    return out, correct, compared


@pytest.fixture(scope="module")
def voice():
    return _run("tiny_voice.json")


def test_tiny_voice_serve_is_correct_and_reports_no_device_metric(voice):
    out, correct, compared = voice
    data = out["data"]
    assert correct, compared
    assert set(compared) == {"lm_gap", "talker_gap", "cp_gap", "audio_dist", "stt_enc_dist", "stt_gap",
                             "stt_edit"}
    assert out["judge"]["sampled"]["lm"] and out["judge"]["sampled"]["tts"] and out["judge"]["sampled"]["stt"]
    assert out["memory_peak"] is None and data.profile is None
    assert data.window_turns and data.setup_s > 0
    assert out["child_jax"] == []
    from s2sbench.metrics import reader

    assert reader("ttfa_p50_s").read(data) > 0
    assert reader("audio_s_per_s").read(data) > 0
    assert reader("stt_final_p50_s").read(data) is not None
    for name in ("device_idle_pct", "elementwise_ms_per_audio_s", "port_kernel_ms_per_audio_s"):
        assert reader(name).read(data) is None


def test_tiny_text_serve_bypasses_the_stt():
    out, correct, compared = _run("tiny_text.json")
    assert correct, compared
    assert "stt_gap" not in compared and "stt_enc_dist" not in compared and out["judge"]["sampled"]["stt"] == 0


def _alter_lm_token(monkeypatch):
    from s2s_tpu_torch.parallel import session_scheduler as ss

    generate = ss.BatchedLMScheduler.generate

    def altered(self, prompt_ids, max_new, *args, **kwargs):
        for i, tok in enumerate(generate(self, prompt_ids, max_new, *args, **kwargs)):
            yield (tok + 1) % 256 if i == 2 else tok

    monkeypatch.setattr(ss.BatchedLMScheduler, "generate", altered)
    monkeypatch.setattr(ss.BatchedLMScheduler, "start", lambda self, *a, **k: None)


def _alter_codec_frame(monkeypatch):
    from s2s_tpu_torch.models import qwen3_tts

    next_frame = qwen3_tts._next_frame

    def altered(params, cfg, hidden, embeds, active):
        codes, eos, next_embeds = next_frame(params, cfg, hidden, embeds, active)
        codes = codes.clone()
        codes[:, 2] = (codes[:, 2] + 1) % cfg.codebook_size
        return codes, eos, next_embeds

    monkeypatch.setattr(qwen3_tts, "_next_frame", altered)


def _alter_transcript(monkeypatch):
    from s2s_tpu_torch.models import parakeet

    decode = parakeet.tdt_greedy_decode_batch

    def altered(params, cfg, encoded, enc_len):
        return [[(t + 1) % cfg.vocab_size for t in row] + [1] for row in decode(params, cfg, encoded, enc_len)]

    monkeypatch.setattr(parakeet, "tdt_greedy_decode_batch", altered)


@pytest.mark.parametrize("fault, caught", [(_alter_lm_token, "lm_gap"), (_alter_codec_frame, "cp_gap")])
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(monkeypatch, fault, caught):
    fault(monkeypatch)
    _, correct, compared = _run("tiny_voice.json")
    assert not correct
    assert compared[caught]["value"] > compared[caught]["limit"], compared


def test_an_altered_transcript_reads_in_the_reported_stt_gap(monkeypatch):
    _alter_transcript(monkeypatch)
    _, correct, compared = _run("tiny_voice.json")
    assert compared["stt_gap"]["limit"] is None and compared["stt_gap"]["value"] > 0.1, compared
    assert compared["stt_edit"]["limit"] is None and compared["stt_edit"]["value"] > 0.5, compared
    assert correct  # reported, not held: the card's control does not clear them (PERF.md, section 6)


def test_the_edit_share_counts_edits_over_the_longer_list():
    from s2sbench.reference.judge import edit_share

    assert edit_share([], []) == 0.0 and edit_share([1, 2, 3], [1, 2, 3]) == 0.0
    assert edit_share([1, 2, 3], [1, 3]) == 1 / 3 and edit_share([1, 2], [3, 4, 5, 6]) == 1.0


def test_a_number_without_a_limit_fails_unless_reported():
    assert run.compare({"a": 0.0, "b": 5.0}, {"a": 1.0}) == (False, {"a": {"value": 0.0, "limit": 1.0},
                                                                       "b": {"value": 5.0, "limit": None}})
    assert run.compare({"a": 0.0, "b": 5.0}, {"a": 1.0}, ("b",))[0]
    assert not run.compare({"control_a": 0.0}, {})[0]


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "s2sbench.run", "--workload", "int8-voice4", "--seed", "1",
                          "--seconds", "5"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_directory_without_the_program_prints_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "s2sbench", tmp_path / "s2sbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "s2sbench.run", "--workload", "int8-voice4", "--seed", "1",
                          "--seconds", "5"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card_prints_its_line():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json

    out = subprocess.run([sys.executable, "-m", "s2sbench.run", "--workload", "int8-voice4", "--seed", "3",
                          "--seconds", "10", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
