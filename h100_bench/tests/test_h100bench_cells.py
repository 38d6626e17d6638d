"""BENCHMARK.json against its required form, and every cell against its
files."""

from __future__ import annotations

import json
import re

import pytest
from conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
}
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["h100_bench"]
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_the_contract_keys(section):
    b = bench()
    names = [e["name"] for e in b[section]]
    assert len(names) == len(set(names))
    for e in b[section]:
        assert NAME.match(e["name"]), e["name"]
        if section in ENTRY_KEYS:
            assert set(e) == ENTRY_KEYS[section], e
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
        else:
            assert set(e) - {"workloads"} == METRIC_KEYS[section], e
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    if section == "end_to_end":
        assert "setup_s" in names
        for e in b[section]:
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
    if section == "per_layer":
        e2e = {m["name"] for m in b["end_to_end"]}
        for e in b[section]:
            assert e["moves"] in e2e and e["workloads"] and set(e["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell_name", CELLS)
def test_each_cell_resolves_to_its_files(cell_name):
    from harness import cell as cells

    c = cells.load(cell_name, ROOT)
    assert c.workload["chips"] == 1
    assert (ROOT / c.config_entry["file"]).is_file()
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert {m["name"] for m in c.end_to_end} == {
        "setup_s", "train_examples_per_s", "train_step_p95_ms", "peak_device_gb"}
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert all(callable(r.read) for r in c.readers.values())
    for key in c.config_entry["reduced"]:
        assert NAME.match(key) and key in c.config["published"], key
    for key, value in c.config["published"].items():  # the source's values, unless reduced
        if key in c.config and key not in c.config_entry["reduced"]:
            ours = c.config[key]
            assert (ours["name"] if isinstance(ours, dict) else ours) == value, key
    assert c.config["embed_size"] == c.config["published"]["embed_size"]


def test_every_configuration_is_used_and_its_file_under_paths():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("h100_bench/") for f in files)
