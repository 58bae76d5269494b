"""A tiny Jamba cell, added as files alone beside the manifest's cells, run
end to end through `hybrid_batch_serve` on the CPU: correct, its Mamba
metrics read from the program's counters, and its control (the reference
in fp8 in the program's place) failing `logit_err` where the program
passes. Also the driver's weights and FLOPs against the sizes they count."""
import json

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CONFIG = json.loads((tiny.ROOT / "perfbench" / "configs" / "jamba2-mini-d8.json").read_text())
CONFIG["name"] = "tiny-jamba"
CONFIG["model"].update(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=300)
CONFIG["model"]["moe"].update(num_experts=4, d_expert=96)
CONFIG["weights"]["predictor_d_h"] = 16
TRAFFIC = dict(tiny.BATCH, driver="hybrid_batch_serve", slots=3, prefetch_depth=2)
# the tiny model in bf16 reads logit_err near 0.07 (in fp32 4e-6: bf16
# rounding throughout, a third of it in the Mamba mixers), its fp8 control
# near 0.8
WORKLOAD = {"check": {"calls": 2, "rows": 4}, "limits": dict(tiny.LIMITS, logit_err=0.2)}
CELL = "tiny.jamba"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    tiny.write(root / "perfbench" / "configs" / "tiny-jamba.json", CONFIG)
    tiny.write(root / "perfbench" / "traffic" / "tiny_hybrid.json", TRAFFIC)
    tiny.write(root / "perfbench" / "workloads" / f"{CELL}.json", WORKLOAD)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-jamba", "source": "test", "reduced": [],
                                "why": "test", "file": "perfbench/configs/tiny-jamba.json"})
    manifest["workloads"].append({"name": CELL, "config": "tiny-jamba", "traffic": "tiny_hybrid",
                                  "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "jamba2mini.batch" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    tiny.write(root / "BENCHMARK.json", manifest)
    return root


def test_tiny_jamba_cell_runs_correct_and_reads_its_mamba_metrics(root):
    out = tiny.run(root, CELL, trace=True)
    res = out["result"]
    assert res["correct"], out["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for name in ("mamba_ms.batch", "mamba_scan_roofline", "mfu.batch", "hash_ms.batch",
                 "expert_hit_rate.batch", "device_idle.batch"):
        assert res["metrics"][name]["value"] > 0, name


def test_untraced_run_reports_no_mamba_metric(root):
    res = tiny.run(root, CELL)["result"]
    assert res["correct"] and res["metrics"]["batch_tok_s"]["value"] > 0
    assert not {"mamba_ms.batch", "mamba_scan_roofline"} & set(res["metrics"])


def test_control_fails_logit_err_where_the_program_passes(root):
    runs = harness.control_readings(harness.resolve(CELL, root), [3, 4, 5], 0.1, "cpu")
    limit = WORKLOAD["limits"]["logit_err"]
    for r in runs:
        assert r["program"]["logit_err"] <= limit < r["control"]["logit_err"], r


def test_mamba_metrics_read_nothing_without_the_program_counters(root):
    rec = {"batches": 4, "mamba": {"calls": 0, "device_s": 0.0, "scan_device_s": 0.0,
                                   "tokens_per_call": 64, "d_inner": 128, "dt_rank": 4,
                                   "state": 16}}
    for name in ("mamba_ms.batch", "mamba_scan_roofline"):
        read = harness.load_module(root, "metrics", name).read
        assert read(rec) is None and read({"batches": 4}) is None


def test_mamba_metrics_on_known_counters(root):
    k = harness.load_module(root, "kernels", "mamba_scan")
    T, di, R, N = 4096, 8192, 256, 16
    assert k.flops_bf16(T, di, R, N) == 2 * T * (di * (R + 2 * N) + R * di)
    assert k.flops_fp32(T, di, N) == 6 * T * di * N
    assert k.nbytes(T, di, R, N) == 2 * 3 * T * di + 2 * (di * (R + 2 * N) + R * di + di + R
                                                         + 2 * N) + 4 * (di * N + di)
    least = k.least_seconds(T, di, R, N)
    assert least == pytest.approx(k.flops_bf16(T, di, R, N) / 989e12
                                  + k.flops_fp32(T, di, N) / 67e12)
    rec = {"batches": 2, "mamba": {"calls": 14, "device_s": 0.5, "scan_device_s": 28 * least,
                                   "tokens_per_call": T, "d_inner": di, "dt_rank": R,
                                   "state": N}}
    assert harness.load_module(root, "metrics", "mamba_ms.batch").read(rec) == \
        pytest.approx(250.0)
    assert harness.load_module(root, "metrics", "mamba_scan_roofline").read(rec) == \
        pytest.approx(50.0)


def test_driver_leaves_and_flops_follow_the_pattern(root):
    drv = harness.load_module(root, "drivers", "hybrid_batch_serve")
    m = CONFIG["model"]
    W = drv.model_params(CONFIG, "cpu")
    blocks = W["blocks"]
    assert set(blocks["sub4"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(blocks["sub1"]) == {"ln1", "mamba", "ln2", "moe"}
    mb = blocks["sub0"]["mamba"]
    assert mb["A_log"].dtype == mb["D"].dtype == torch.float32
    assert mb["A_log"].shape == (1, 128, 16) and mb["dt_norm"]["scale"].shape == (1, 4)
    assert float(mb["dt_bias"].float().mean()) < -3 and abs(float(mb["D"].mean()) - 1) < 0.1
    d, di, R, N, V = 64, 128, 4, 16, 300
    mamba = 2 * (d * 2 * di + di * (R + 2 * N) + R * di + di * d)
    attn = 2 * d * (2 * 4 * 16 + 2 * 2 * 16) + 4 * 4 * 16 * 10
    want = 7 * mamba + attn + 4 * 2 * 2 * 3 * d * 96 + 4 * 2 * 3 * d * 128 + 2 * d * V
    assert drv.per_token(m, 10) == want
