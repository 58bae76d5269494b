"""Cells, configurations and metrics added as files alone, run end to end on
the CPU against repro_torch at tiny sizes."""
import json

import pytest

from perfbench import harness

from perfbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_tiny_cell_runs_correct(root, cell):
    out = tiny.run(root, cell)
    res = out["result"]
    assert res["correct"], out["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and res["metrics"]["setup_s"]["value"] > 0
    rate = "decode_tok_s" if cell.endswith("decode") else "batch_tok_s"
    assert res["metrics"][rate]["value"] > 0
    assert list(res)[-1] == "checks"


def test_added_metric_is_read_without_editing_a_file(root):
    (root / "perfbench" / "metrics" / "tokens_seen.batch.py").write_text(
        "def read(rec):\n    return float(rec['tokens'])\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "tokens_seen.batch", "unit": "tokens",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "entry", "moves": "batch_tok_s",
                                  "workloads": ["tiny.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    res = tiny.run(root, "tiny.batch", trace=True)["result"]
    assert res["metrics"]["tokens_seen.batch"]["value"] > 0


def test_zipf_traffic_is_a_data_file(root):
    traffic = dict(tiny.TRAFFIC["tiny_sync"], tokens={"kind": "zipf", "a": 1.2})
    tiny.write(root / "perfbench" / "traffic" / "tiny_zipf.json", traffic)
    tiny.write(root / "perfbench" / "workloads" / "tiny.zipf.json", tiny.WORKLOADS["tiny.batch"])
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "tiny.zipf", "config": "tiny-switch",
                                  "traffic": "tiny_zipf", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"]:
        if "tiny.batch" in m.get("workloads", ()):
            m["workloads"].append("tiny.zipf")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    res = tiny.run(root, "tiny.zipf")["result"]
    assert res["correct"] and res["metrics"]["batch_tok_s"]["value"] > 0


@pytest.mark.parametrize("cell,name", [("tiny.batch", "logit_err"), ("tiny.async", "logit_err"),
                                       ("tiny.decode", "token_gap")])
def test_control_fails_where_the_program_passes(root, cell, name):
    """The control, the reference in fp8 in the program's place, reads above
    the limit on every seed, the program below it."""
    runs = harness.control_readings(harness.resolve(cell, root), [3, 4, 5], 0.1, "cpu")
    limit = tiny.WORKLOADS[cell]["limits"][name]
    for r in runs:
        assert r["program"][name] <= limit < r["control"][name], r
