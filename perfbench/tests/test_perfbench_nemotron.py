"""A tiny Nemotron-H cell, added as files alone beside the manifest's cells,
run end to end through `nemotron_batch_serve` on the CPU: correct, its
Mamba-2 metrics read from the program's counters, and its control (the
reference in fp8 in the program's place) failing `logit_err` where the
program passes. Also `nemotron_batch_serve`'s weights, FLOPs and configuration against
the sizes they count, and the SSD's least time by hand."""
import json

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

CONFIG = json.loads((tiny.ROOT / "perfbench" / "configs" / "nemotron-3-nano-d13.json").read_text())
CONFIG["name"] = "tiny-nemotron"
CONFIG["model"].update(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab_size=300)
CONFIG["model"]["moe"].update(num_experts=8, top_k=2, d_expert=64, d_shared=64)
CONFIG["model"]["ssm"].update(state_dim=16, mamba2_heads=4, mamba2_head_dim=16, n_groups=2,
                              chunk_size=16)
CONFIG["weights"]["predictor_d_h"] = 16
TRAFFIC = dict(tiny.BATCH, driver="nemotron_batch_serve", seq=40, slots=6, prefetch_depth=2)
# the tiny model in bf16 reads logit_err 0.035-0.050 over seeds 3-8 (bf16
# rounding throughout; its fp32 forward reads 1e-6 in
# tests/test_torch_nemotron_h.py), its fp8 control 0.38-0.62
WORKLOAD = {"check": {"calls": 2, "rows": 4}, "limits": dict(tiny.LIMITS, logit_err=0.1)}
CELL = "tiny.nemotron"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    tiny.write(root / "perfbench" / "configs" / "tiny-nemotron.json", CONFIG)
    tiny.write(root / "perfbench" / "traffic" / "tiny_nemotron.json", TRAFFIC)
    tiny.write(root / "perfbench" / "workloads" / f"{CELL}.json", WORKLOAD)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-nemotron", "source": "test", "reduced": [],
                                "why": "test", "file": "perfbench/configs/tiny-nemotron.json"})
    manifest["workloads"].append({"name": CELL, "config": "tiny-nemotron",
                                  "traffic": "tiny_nemotron", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "nemotron3nano.batch" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    tiny.write(root / "BENCHMARK.json", manifest)
    return root


def _driver(root):
    return harness.load_module(root, "drivers", "nemotron_batch_serve")


def test_tiny_nemotron_cell_runs_correct_and_reads_its_mamba2_metrics(root):
    out = tiny.run(root, CELL, trace=True)
    res = out["result"]
    assert res["correct"], out["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for name in ("mamba2_ms.batch", "ssd_scan_roofline", "mfu.batch", "hash_ms.batch",
                 "expert_hit_rate.batch", "device_idle.batch"):
        assert res["metrics"][name]["value"] > 0, name


def test_untraced_run_reports_no_mamba2_metric(root):
    res = tiny.run(root, CELL)["result"]
    assert res["correct"] and res["metrics"]["batch_tok_s"]["value"] > 0
    assert not {"mamba2_ms.batch", "ssd_scan_roofline"} & set(res["metrics"])


def test_control_fails_logit_err_where_the_program_passes(root):
    runs = harness.control_readings(harness.resolve(CELL, root), [3, 4, 5], 0.1, "cpu")
    limit = WORKLOAD["limits"]["logit_err"]
    for r in runs:
        assert r["program"]["logit_err"] <= limit < r["control"]["logit_err"], r


def test_mamba2_metrics_read_nothing_without_the_program_counters(root):
    rec = {"batches": 4, "mamba2": {"calls": 0, "device_s": 0.0, "ssd_device_s": 0.0,
                                    "tokens_per_call": 64, "heads": 4, "head_dim": 16,
                                    "groups": 2, "state": 16, "chunk": 16}}
    for name in ("mamba2_ms.batch", "ssd_scan_roofline"):
        read = harness.load_module(root, "metrics", name).read
        assert read(rec) is None and read({"batches": 4}) is None


def test_ssd_least_time_and_the_metrics_on_known_counters(root):
    """At the cell's shape, a batch of 8 x 1024 tokens through 64 heads of
    64, 8 groups of state 128, chunk 128: the operations and bytes by hand."""
    k = harness.load_module(root, "kernels", "ssd_scan")
    T, H, P, G, N, L = 8192, 64, 64, 8, 128, 128
    mm = T * (G * N * (L + 1) + H * P * (L + 1) + 4 * H * P * N)
    assert k.flops_mm(T, H, P, G, N, L) == mm == 8192 * 2_757_632
    assert k.flops_fp32(T, H, P, L) == T * (H * 129 / 2 + 3 * H * P)
    nbytes = 2 * T * (H * P + G * N + G * N + H + H * P) + 4 * 3 * H
    assert k.nbytes(T, H, P, G, N) == nbytes == 168_821_504
    least = k.least_seconds(T, H, P, G, N, L)
    assert least == pytest.approx(nbytes / 3.35e12)     # the bytes bound: 50.4 µs
    rec = {"batches": 2, "mamba2": {"calls": 12, "device_s": 0.5, "ssd_device_s": 24 * least,
                                    "tokens_per_call": T, "heads": H, "head_dim": P,
                                    "groups": G, "state": N, "chunk": L}}
    assert harness.load_module(root, "metrics", "mamba2_ms.batch").read(rec) == \
        pytest.approx(250.0)
    assert harness.load_module(root, "metrics", "ssd_scan_roofline").read(rec) == \
        pytest.approx(50.0)


def _published():
    spec = json.loads((tiny.ROOT / "perfbench" / "configs" / "nemotron-3-nano-d13.json")
                      .read_text())
    pub = spec["published"]
    kinds = {"M": "mamba2", "E": "moe", "*": "global"}
    m = json.loads(json.dumps(spec["model"]))
    m["n_layers"] = pub["num_hidden_layers"]
    m["attn"]["layer_pattern"] = [kinds[c] for c in pub["hybrid_override_pattern"]]
    return m


def test_driver_leaves_count_the_published_31_6b_parameters(root):
    """Every leaf but the unused w_gate stacks (the store's), at the
    published 52 blocks: 31.6B parameters, as the program's count."""
    drv = _driver(root)
    m = _published()
    n = sum(torch.Size(shape).numel() for path, shape, _, _ in drv.model_leaves(m)
            if path[-1] != "w_gate")
    assert 31.5e9 < n < 31.7e9
    assert n == drv.build({"model": m}).param_counts()["total"]
    assert _driver(root).n_moe(m) == 23 and _driver(root).n_moe(CONFIG["model"]) == 5


def test_driver_weights_flops_and_check_follow_the_pattern(root):
    drv = _driver(root)
    m = CONFIG["model"]
    W = drv.model_params(CONFIG, "cpu")
    blocks = W["blocks"]
    assert set(blocks["sub0"]) == {"ln1", "mamba2"} and set(blocks["sub5"]) == {"ln1", "attn"}
    assert set(blocks["sub1"]["moe"]) == {"router", "router_bias", "w_in", "w_gate", "w_out",
                                          "shared_w_in", "shared_w_out"}
    mb = blocks["sub0"]["mamba2"]
    assert mb["A_log"].dtype == mb["D"].dtype == mb["dt_bias"].dtype == torch.float32
    A = torch.exp(mb["A_log"])
    dt = torch.nn.functional.softplus(mb["dt_bias"])
    assert bool(((A >= 1) & (A <= 16)).all()) and bool(((dt >= 1e-3) & (dt <= 0.1 + 1e-6)).all())
    assert bool((mb["D"] == 1).all()) and tuple(mb["in_proj"].shape) == (1, 64, 2 * 64 + 64 + 4)
    hp = drv.predictor_params(CONFIG, "cpu")
    assert tuple(hp["heads"].shape) == (16, 5 * 8)
    d, di, G, N, H, V, keys = 64, 64, 2, 16, 4, 300, 20
    seen = (keys - 1) % 16 + 1
    mamba2 = 2 * d * (di + di + 2 * G * N + H) + 2 * di * d + 2 * (G * N + di) * seen \
        + 4 * di * N
    moe = 2 * 2 * 2 * d * 64 + 2 * 2 * d * 64
    attn = 2 * d * (2 * 4 * 16 + 2 * 2 * 16) + 4 * 4 * 16 * keys
    assert drv.per_token(m, keys) == 6 * mamba2 + 5 * moe + 2 * attn + 2 * d * V


def test_a_program_without_the_block_kind_is_refused_before_any_weight(root):
    """`build` names the missing block kind where the program's
    configuration refuses a nemotron_h field."""
    spec = json.loads(json.dumps(CONFIG))
    spec["model"]["moe"]["no_such_field"] = 1
    with pytest.raises(ValueError, match="no block kind 'nemotron_h'"):
        _driver(root).build(spec)
