"""BENCHMARK.json against the benchmark's contract, and every cell's files."""
import json
import re

import pytest

from perfbench import harness
from perfbench.tests.tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
WIDTH = re.compile(r"(_dim|_rank)$|^d_|hidden_size|intermediate|latent|state|proj|head_size|expansion|top_k"
                   r"|experts_per_tok")


def _line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) for p in MANIFEST["paths"])
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert not any(w.startswith("/") or ".." in w for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 x 90 s of compile a cell, 1200 s spare, in 43200 s
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS + [m["name"] for m in metrics]
    for group in (MANIFEST["configs"], MANIFEST["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and _line(w["why"])
    for c in MANIFEST["configs"]:
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())


def test_every_cell_on_one_chip_and_every_config_used():
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) == len(CELLS)


def test_moves_and_cell_lists():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(_line(layer) for layer in layers)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert c.driver.Driver and c.reference.forward
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_module(ROOT, "metrics", m["name"]).read)
    assert set(c.workload["limits"]) >= {"slots_missing", "slots_invalid", "hash_gap"}


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert config["file"].startswith("perfbench/configs/")
    spec = json.loads((ROOT / config["file"]).read_text())
    assert spec["name"] == config["name"] and spec["source"] == config["source"]
    assert spec["reduced"] == config["reduced"]
    # `reduced` names keys of the published configuration, which the file keeps
    assert all(k in spec["published"] for k in config["reduced"])
    assert not any(WIDTH.search(k) for k in config["reduced"])
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
