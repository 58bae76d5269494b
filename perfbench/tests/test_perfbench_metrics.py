"""The metric arithmetic on known inputs."""
import numpy as np
import pytest
import torch

from perfbench import compare, flops, harness, peaks, trace
from perfbench.reference import routing
from perfbench.spans import Spans
from perfbench.tests.tiny import CONFIGS, ROOT


def read(name, rec):
    return harness.load_module(ROOT, "metrics", name).read(rec)


def test_rates_take_all_work_over_all_time():
    rec = {"tokens": 3000, "window_s": 1.5, "batch_latency_s": [0.1] * 3, "steps": 5}
    assert read("batch_tok_s", rec) == pytest.approx(2000.0)
    assert read("decode_tok_s", rec) == pytest.approx(2000.0)
    assert read("batch_tok_s", {"tokens": 1, "window_s": 1.0}) is None


def test_p90_is_over_all_batches():
    lat = [i / 1000 for i in range(1, 101)]          # 1 .. 100 ms
    assert read("batch_p90_ms", {"batch_latency_s": lat}) == pytest.approx(90.1)
    assert read("batch_p90_ms", {"batch_latency_s": lat[::-1]}) == pytest.approx(90.1)


def test_counters_per_batch():
    rec = {"batches": 4, "hash_time_s": 0.2, "prefetch_stall_s": 0.1,
           "store": {"hits": 30, "loads": 10, "prepare_time_s": 0.3}}
    assert read("hash_ms.batch", rec) == pytest.approx(50.0)
    assert read("upload_stall_ms.batch", rec) == pytest.approx(100.0)
    assert read("expert_hit_rate.batch", rec) == pytest.approx(75.0)
    assert read("peak_device_gib", {"memory_peak_bytes": 3 * 2 ** 30}) == pytest.approx(3.0)


def test_model_flops_on_a_known_shape():
    m = CONFIGS["tiny-switch"]["model"]      # 4 layers, d 64, 4 heads, d_ff = d_expert 128, top-1
    layer = 2 * 64 * (2 * 64 + 2 * 64) + 4 * 64 * 10
    want = 4 * layer + 2 * (2 * 2 * 64 * 128) + 2 * (1 * 2 * 2 * 64 * 128) + 2 * 64 * 300
    assert flops.per_token(m, 10) == want
    assert flops.sequence(m, 3) == sum(flops.per_token(m, k) for k in (1, 2, 3))
    rec = {"model_flops": peaks.BF16_FLOPS * 0.5, "window_s": 2.0, "trace": {}}
    assert read("mfu.batch", {**rec, "trace": {"busy_s": 1}}) == pytest.approx(25.0)


def test_rooflines_on_known_shapes():
    ffn = harness.load_module(ROOT, "kernels", "expert_ffn")
    d, F = 1024, 4096
    assert ffn.flops(10, d, F, True) == 2 * 10 * d * F * 3
    assert ffn.nbytes(10, 2, d, F, False) == 2 * (2 * 10 * d + 2 * d * F * 2)
    least = peaks.least_seconds(ffn.flops(1000, d, F, False), ffn.nbytes(1000, 3, d, F, False))
    rec = {"trace": {"kernels": {"void sm90_gemm_kernel<64, 128, false, 0>": [2, 2 * least],
                                 "other": [5, 1.0]}},
           "expert_ffn": {"d": d, "F": F, "glu": False, "calls": [(1000, 3)]}}
    assert read("expert_ffn_roofline", rec) == pytest.approx(50.0)
    fd = harness.load_module(ROOT, "kernels", "flash_decode")
    assert fd.flops(2, 4, 64, 10) == 4 * 2 * 4 * 64 * 10
    assert fd.nbytes(1, 4, 2, 64, 10, 2) == 2 * 10 * 2 * 64 * 2 + 2 * 4 * 64 * 2 + 4 * 10 + 4
    one = peaks.least_seconds(fd.flops(8, 4, 64, 5), fd.nbytes(8, 4, 4, 64, 5, 2))
    rec = {"trace": {"kernels": {"void flash_decode_kernel<bf16>": [6, 4 * 6 * one]}},
           "flash_decode": {"lanes": 8, "heads": 4, "kv_heads": 4, "head_dim": 64,
                            "elem_bytes": 2, "calls": [(5, 6)]}}
    assert read("flash_decode_roofline", rec) == pytest.approx(25.0)
    no_kernel = {"trace": {"kernels": {}},
                 "expert_ffn": {"d": d, "F": F, "glu": False, "calls": [(1, 1)]}}
    assert read("expert_ffn_roofline", no_kernel) is None


def test_trace_reduction_union_gaps_and_labels():
    s = Spans()
    s.items = [("serve", 1, 0, 1000), ("hash", 2, 100, 400), ("copy", 1, 500, 900)]
    events = [("k1(int)", 0, 100), ("k2", 50, 110), ("memcpy", 600, 700), ("k1(int)", 950, 990)]
    r = trace.reduce([e[0] for e in events], np.array([e[1] for e in events]),
                     np.array([e[2] for e in events]), 0, 1000, s)
    assert r["busy_s"] == pytest.approx(250 / 1e9)
    assert r["window_s"] == pytest.approx(1000 / 1e9)
    assert r["kernels"]["k1"] == [2, pytest.approx(140 / 1e9)]
    idle = dict(r["breakdown"]["idle_gaps"])
    # idle 110..600, 700..950, 990..1000; hash on thread 2 over 100..400,
    # copy inside serve on thread 1 over 500..900
    assert idle == {"hash+serve": pytest.approx(290 / 1e9), "serve": pytest.approx(160 / 1e9),
                    "copy": pytest.approx(300 / 1e9)}
    assert trace.reduce([], np.array([], np.int64), np.array([], np.int64), 0, 10, s) is None
    assert trace.short_name("void (anonymous namespace)::k<64>(int, float)") == \
        "void (anonymous namespace)::k<64>"
    assert read("device_idle.batch", {"trace": r}) == pytest.approx(75.0)


def test_capacity_drops_in_token_order_and_parks_misses_on_slot_0():
    # one layer, 10 tokens, top-1; slots 2 -> C = max(8, int(1.25 * 10 / 2)) = 8
    ids = np.array([[[0]] * 9 + [[1]]])[..., None].reshape(1, 10, 1)
    trans = np.array([[0, 1, -1]])
    w = routing.effective_routing(ids, np.ones((1, 10, 1), np.float32), trans, 2, 1, 1.25)
    assert w[0, :8, 0].tolist() == [1.0] * 8 and w[0, 8, 0] == 0 and w[0, 9, 0] == 1
    # expert 2 holds no slot: weight 0, but it fills slot 0's capacity first
    ids = np.array([[2] * 8 + [0, 0]]).reshape(1, 10, 1)
    w = routing.effective_routing(ids, np.ones((1, 10, 1), np.float32), trans, 2, 1, 1.25)
    assert w.sum() == 0
    # top-2: a miss keeps weight 0 and the survivor takes the token's whole mass
    ids = np.array([[[0, 2]]])
    w = routing.effective_routing(ids, np.array([[[0.75, 0.25]]], np.float32), trans, 2, 2, 1.25)
    assert w.tolist() == [[[1.0, 0.0]]]


def test_needed_and_residency():
    ids = np.array([[[0], [1], [1], [2], [2], [2]]]).reshape(1, 6, 1)
    alpha = np.array([1, 1, 1, 1, 1, 1], np.float32).reshape(1, 6, 1)
    need = routing.needed_experts(ids, alpha, 2, 4)
    assert need == [{1, 2}]
    assert routing.residency_faults(np.array([[-1, 0, 1, -1]]), need, 2) == (0, 0)
    assert routing.residency_faults(np.array([[-1, 0, -1, 0]]), need, 2) == (1, 1)
    assert routing.residency_faults(np.array([[2, 0, 1, -1]]), need, 2) == (0, 1)


def test_comparisons():
    ref = torch.tensor([[3.0, 2.0, 1.0, 0.0]])
    assert compare.routing_gap(ref, np.array([[0, 1]]), torch.softmax(ref[:, :2], -1).numpy()) \
        == (0.0, pytest.approx(0.0, abs=1e-7))
    gap, _ = compare.routing_gap(ref, np.array([[0, 3]]), np.array([[0.5, 0.5]]))
    assert gap == pytest.approx(2.0)
    assert compare.token_gap(ref, torch.tensor([2])) == pytest.approx(2.0)
    got = ref.clone()
    got[0, 0] += 3.7416573867739413 * 0.1
    assert compare.logit_error(got, ref) == pytest.approx(0.1)
    assert compare.logit_error(ref * float("nan"), ref) == float("inf")
