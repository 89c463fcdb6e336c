"""The harness finds each configuration, traffic mix and metric by name,
and BENCHMARK.json keeps to the shapes the harness reads."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT

from s2sbench import metrics, run, traffic, weights
from s2sbench.serve import flag_values

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_configuration_and_mix_by_name():
    for cell in BENCH["workloads"]:
        entry, bench, config, mix = run.load_cell(ROOT, cell["name"])
        assert entry is cell or entry == cell
        assert config["name"] == cell["config"]
        assert mix["kind"] in ("voice", "text")
        assert traffic.load(cell["traffic"]) == mix


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(metrics.reader(m["name"]).read), m["name"]


def test_a_metric_name_outside_the_contract_is_refused():
    with pytest.raises(ValueError):
        metrics.reader("no/slash")


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for cell in BENCH["workloads"]:
        e2e = run.metric_names(BENCH, cell, trace=False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metric_names(BENCH, cell, trace=True)


def test_benchmark_names_units_and_bounds_keep_to_the_contract():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    configs = {c["name"]: c for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["config"] in configs and cell["chips"] == 1 and len(cell["why"]) <= 200
    for c in configs.values():
        assert (ROOT / c["file"]).exists() and c["file"].startswith("s2sbench/")


def test_configuration_shapes_match_the_programs_presets():
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        weights.check_against_program(config["models"], flag_values(config["serve_flags"]))
        assert config["reduced"] == c["reduced"]


def test_a_shape_that_drifts_from_the_program_is_refused():
    config = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    config["models"]["lm"]["d_ff"] += 1
    with pytest.raises(ValueError, match="d_ff"):
        weights.check_against_program(config["models"], flag_values(config["serve_flags"]))


def test_the_synthetic_tokenizer_speaks_every_word_id_and_encodes_any_prompt(tmp_path):
    from s2s_tpu_torch.llm.bpe_tokenizer import BPETokenizer, PurePythonBPE

    from s2sbench import tokenizer

    path = tokenizer.path(tmp_path, 49152)
    assert tokenizer.path(tmp_path, 49152) == path
    tok = BPETokenizer(path)
    pure = PurePythonBPE(json.loads(path.read_text()))
    assert tok.vocab_size == 49152 and tok.eos_id == 2
    prompt = "<|im_start|>user\nhello, world: é 𝄞<|im_end|>\n<|im_start|>assistant\n"
    assert tok.encode(prompt) == pure.encode(prompt)
    for i in (259, 1000, 30000, 49151):
        word = tok.decode([i])
        assert word == pure.decode([i]) and word[0] == " " and word[1:].isalpha() and len(word) >= 5
