"""The batch engine's table build replayed as a CUDA graph on a stream of
its own (`core/engine.py::SiDAEngine.build_table`, `HashGraph`).

On the CPU: which builds may replay (`hash_graph_engages`), the graph
counters of eager builds, threaded and sequential `serve` tables against
`hash_fn_apply` + `predict_topk`, the capture after `GRAPH_WARM_STEPS`
eager builds in a row and the drop at another shape or moved weights
(through a stand-in for the capture that replays the eager build), and the
launch bookkeeping of a capture and its replays. On the card
(`python -m pytest --noconftest -m gpu tests/test_torch_hash_graph.py`):
replayed tables against eager ones bit for bit at switch-base-8's and
deepseek-moe-16b's widths inside a threaded `serve` whose forwards run
while the capture happens, kernel launches alike; a second shape that
captures anew and frees the first graph; a long prompt that stays eager."""
import dataclasses
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import engine as engine_mod
from repro_torch.core.decode_engine import GRAPH_WARM_STEPS
from repro_torch.core.engine import HashGraph, SiDAEngine
from repro_torch.core.hash_fn import (HASH_SEG_LEN, hash_fn_apply, hash_fn_apply_segmented,
                                      init_hash_fn, predict_topk)
from repro_torch.kernels import ops
from repro_torch.models.transformer import init_params, n_moe_layers
from repro_torch.serving.telemetry import Telemetry
from repro_torch.tree import tree_map

COUNTERS = ("hash_graph_captures", "hash_graph_replays", "hash_graph_eager_builds")


def _model(cfg, device="cpu", d_h=16, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, cfg, device=device)
    hp = init_hash_fn(gen, cfg.d_model, n_moe_layers(cfg), cfg.moe.num_experts, d_h=d_h,
                      device=device)
    return params, hp


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("switch-base-8").reduced()
    params, hp = _model(cfg)
    return cfg, params, hp


def _batches(cfg, shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, shape).astype(np.int32) for _ in range(n)]


def _counters(tel):
    return [tel.counter(c).value for c in COUNTERS]


def _record(eng):
    """Wrap the engine's table build to log the tables it returns."""
    tables, build = [], eng.build_table

    def rec(j, toks):
        t = build(j, toks)
        tables.append(t)
        return t

    eng.build_table = rec
    return tables


def _want(eng, toks):
    """The table `hash_fn_apply` (or its segmented form) and `predict_topk`
    give on the engine's weights."""
    with torch.inference_mode():
        emb = eng.embed_table[torch.as_tensor(toks, device=eng.device).long()]
        apply = hash_fn_apply_segmented if toks.shape[1] > HASH_SEG_LEN else hash_fn_apply
        ids, w = predict_topk(apply(eng.hash_params, emb, eng.E), eng.k)
    return ids.cpu().numpy(), w.cpu().numpy()


@pytest.mark.parametrize("device,seq_len,want", [
    ("cuda", 256, True),
    ("cuda:0", HASH_SEG_LEN, True),
    ("cuda", HASH_SEG_LEN + 1, False),
    ("cpu", 256, False),
    ("cpu", 2 * HASH_SEG_LEN, False),
], ids=["cuda-256", "cuda0-seg", "cuda-long", "cpu-256", "cpu-long"])
def test_graph_engages_only_on_cuda_up_to_the_segment_length(device, seq_len, want):
    assert engine_mod.hash_graph_engages(torch.device(device), seq_len) is want


@pytest.mark.parametrize("threaded", [True, False], ids=["threaded", "sequential"])
def test_serve_tables_equal_hash_fn_apply_and_every_cpu_build_is_eager(tiny, threaded):
    cfg, params, hp = tiny
    tel = Telemetry()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=2, device="cpu", telemetry=tel)
    tables = _record(eng)
    batches = _batches(cfg, (3, 16), 5)
    try:
        for _ in range(2):
            eng.serve(batches, threaded=threaded)
    finally:
        eng.close()
    assert eng._hash_stream is None and eng._hash_graph is None
    assert _counters(tel) == [0, 0, 2 * len(batches)]
    assert [t.batch_index for t in tables] == 2 * list(range(len(batches)))
    for t in tables:
        ids, w = _want(eng, batches[t.batch_index])
        np.testing.assert_array_equal(t.expert_ids, ids)
        np.testing.assert_array_equal(t.weights, w)


class _StandInGraph:
    """Replays by running the eager build into the capture's outputs."""

    def __init__(self, eng, tokens, ids, alpha):
        self.eng, self.tokens, self.ids, self.alpha = eng, tokens, ids, alpha
        self.replays = 0

    def replay(self):
        ids, alpha = self.eng._predict_body(self.tokens)
        self.ids.copy_(ids)
        self.alpha.copy_(alpha)
        self.replays += 1


@pytest.fixture
def stand_in(tiny, monkeypatch):
    """A CPU engine on which the graph engages: each capture builds once
    and hands back a stand-in that replays the eager build. Yields the
    engine, its telemetry and the list of captures made."""
    cfg, params, hp = tiny
    captures = []

    def capture(self, key, tokens):
        static = torch.as_tensor(tokens, device=self.device)
        with ops.held_launches() as launches:
            ids, alpha = self._predict_body(static)
        graph = HashGraph(_StandInGraph(self, static, ids, alpha), key, static, ids, alpha,
                          launches)
        captures.append(graph)
        return graph

    monkeypatch.setattr(engine_mod, "hash_graph_engages", lambda device, s: s <= HASH_SEG_LEN)
    monkeypatch.setattr(SiDAEngine, "_capture_build", capture)
    tel = Telemetry()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=2, device="cpu", telemetry=tel)
    yield eng, tel, captures
    eng.close()


def test_capture_after_warm_builds_and_drop_on_another_shape(tiny, stand_in):
    eng, tel, captures = stand_in
    cfg = tiny[0]
    a, b = _batches(cfg, (3, 16), 6, seed=1), _batches(cfg, (2, 12), 4, seed=2)
    seq = a[:4] + b + a[4:]
    got = [eng.build_table(j, t) for j, t in enumerate(seq)]
    for t, toks in zip(got, seq):
        ids, w = _want(eng, toks)
        np.testing.assert_array_equal(t.expert_ids, ids)
        np.testing.assert_array_equal(t.weights, w)
    # a: 2 eager, capture, 1 more replay; b: drop, 2 eager, capture, 1 more;
    # a again: drop, 2 eager
    W = GRAPH_WARM_STEPS
    assert len(captures) == 2
    assert [c.graph.replays for c in captures] == [4 - W, 4 - W]
    assert [c.key[0] for c in captures] == [(3, 16), (2, 12)]
    assert eng._hash_graph is None
    assert _counters(tel) == [2, 8 - 2 * W, 2 * W + 2]
    eng.build_table(len(seq), a[0])           # the third a in a row captures
    assert len(captures) == 3 and eng._hash_graph is captures[-1]


def test_moved_weights_drop_the_graph(tiny, stand_in):
    eng, tel, captures = stand_in
    toks = _batches(tiny[0], (3, 16), 1)[0]
    for j in range(GRAPH_WARM_STEPS + 2):
        eng.build_table(j, toks)
    assert len(captures) == 1 and eng._hash_graph is captures[0]
    eng.hash_params = tree_map(torch.clone, eng.hash_params)
    eng.hash_params["lstm1"]["b"].add_(0.5)   # the new weights are read, not the old
    t = eng.build_table(9, toks)
    assert eng._hash_graph is None
    ids, w = _want(eng, toks)
    np.testing.assert_array_equal(t.expert_ids, ids)
    np.testing.assert_array_equal(t.weights, w)
    assert _counters(tel) == [1, 2, GRAPH_WARM_STEPS + 1]


def test_long_prompts_stay_eager(tiny, stand_in):
    eng, tel, captures = stand_in
    toks = _batches(tiny[0], (1, HASH_SEG_LEN + 3), 1)[0]
    for j in range(GRAPH_WARM_STEPS + 1):
        t = eng.build_table(j, toks)
    ids, w = _want(eng, toks)
    np.testing.assert_array_equal(t.expert_ids, ids)
    np.testing.assert_array_equal(t.weights, w)
    assert captures == [] and _counters(tel) == [0, 0, GRAPH_WARM_STEPS + 1]


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_each_replay_adds_the_captures_launches_once():
    tokens = torch.zeros(2, 4, dtype=torch.int32)
    ids, alpha = torch.zeros(3, 2, 4, 1, dtype=torch.int32), torch.ones(3, 2, 4, 1)
    graph = HashGraph(_StubGraph(), ((2, 4),), tokens, ids, alpha, ({"sparsemax": 1}, {}))
    ops.reset_launches()
    new = np.arange(8, dtype=np.int32).reshape(2, 4)
    for n in range(1, 4):
        got = graph.replay(new)
        assert got[0] is ids and got[1] is alpha
        assert ops.launches() == {**{k: 0 for k in ops.KERNELS}, "sparsemax": n}
        assert ops.launches_by_shape() == {}
    assert graph.graph.replays == 3
    assert torch.equal(tokens, torch.from_numpy(new))
    ops.reset_launches()


def test_held_launches_leave_other_threads_counted():
    """A capture on the hash thread holds its own launches only: the
    inference thread's forwards meanwhile count in the totals once."""
    ops.reset_launches()
    q = torch.zeros(1, 4, 8)
    inside, go = threading.Event(), threading.Event()

    def other():
        inside.wait()
        ops._count("expert_ffn")
        ops._count("flash_prefill", q, q, 0, 0.0)
        go.set()

    t = threading.Thread(target=other)
    t.start()
    with ops.held_launches() as (counts, by_shape):
        ops._count("sparsemax")
        inside.set()
        go.wait()
        ops._count("sparsemax")
    t.join()
    assert counts == {"sparsemax": 2} and by_shape == {}
    assert ops.launches() == {**{k: 0 for k in ops.KERNELS}, "expert_ffn": 1,
                              "flash_prefill": 1}
    assert ops.launches_by_shape() == {("flash_prefill", 4, 4, 8, 0, 0.0): 1}
    ops.reset_launches()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card_model(name, depth=0):
    """A published config in bf16 (its depth cut where given), weights and
    a 64-wide predictor drawn on the card from a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_config(name), dtype="bfloat16")
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    params, hp = _model(cfg, device="cuda", d_h=64)
    return cfg, params, hp


@pytest.fixture(scope="module")
def switch8():
    return _card_model("switch-base-8")


@pytest.fixture(scope="module")
def deepseek():
    return _card_model("deepseek-moe-16b", depth=2)


def _serve_on_card(model, shape, slots, n, eager, monkeypatch):
    """Tables, launches and counters of a threaded `serve` of n batches,
    the build replayed or (`eager`) never captured."""
    cfg, params, hp = model
    if eager:
        monkeypatch.setattr(engine_mod, "hash_graph_engages", lambda *a: False)
    tel = Telemetry()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=slots, device="cuda", telemetry=tel)
    tables = _record(eng)
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        eng.serve(_batches(cfg, shape, n, seed=7), threaded=True)
        torch.cuda.synchronize()
        return tables, ops.launches(), _counters(tel)
    finally:
        eng.close()
        monkeypatch.undo()


@pytest.mark.gpu
@pytest.mark.parametrize("which,shape,slots", [
    ("switch8", (32, 256), 4),
    ("deepseek", (16, 256), 64),
], ids=["switch8", "deepseek"])
def test_replayed_tables_equal_eager_ones_on_the_card(which, shape, slots, request,
                                                      monkeypatch):
    model = request.getfixturevalue(which)
    n = 8
    g_tabs, g_launch, g_count = _serve_on_card(model, shape, slots, n, False, monkeypatch)
    e_tabs, e_launch, e_count = _serve_on_card(model, shape, slots, n, True, monkeypatch)
    assert g_count == [1, n - GRAPH_WARM_STEPS, GRAPH_WARM_STEPS]
    assert e_count == [0, 0, n]
    for g, e in zip(g_tabs, e_tabs):
        np.testing.assert_array_equal(g.expert_ids, e.expert_ids)
        np.testing.assert_array_equal(g.weights.view(np.int32), e.weights.view(np.int32))
    assert g_launch == e_launch
    assert g_launch["sparsemax"] == n and g_launch["expert_ffn"] > 0


@pytest.mark.gpu
def test_a_second_shape_captures_anew_and_frees_the_first(switch8):
    cfg, params, hp = switch8
    tel = Telemetry()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=8, device="cuda", telemetry=tel)
    try:
        for j, toks in enumerate(_batches(cfg, (32, 256), GRAPH_WARM_STEPS + 2)):
            eng.build_table(j, toks)
        first = eng._hash_graph
        assert first is not None and first.key[0] == (32, 256)
        refs = [weakref.ref(t) for t in (first.tokens, first.ids, first.alpha)]
        del first
        small = _batches(cfg, (8, 128), GRAPH_WARM_STEPS + 2, seed=3)
        got = [eng.build_table(j, toks) for j, toks in enumerate(small)]
        gc.collect()
        torch.cuda.synchronize()
        assert all(r() is None for r in refs)
        assert eng._hash_graph.key[0] == (8, 128)
        for t, toks in zip(got, small):
            ids, w = _want(eng, toks)
            np.testing.assert_array_equal(t.expert_ids, ids)
            np.testing.assert_array_equal(t.weights.view(np.int32), w.view(np.int32))
        assert _counters(tel) == [2, 4, 2 * GRAPH_WARM_STEPS]
    finally:
        eng.close()


@pytest.mark.gpu
def test_a_long_prompt_stays_eager_on_the_card(switch8):
    cfg, params, hp = switch8
    tel = Telemetry()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=8, device="cuda", telemetry=tel)
    toks = _batches(cfg, (1, HASH_SEG_LEN + 64), 1)[0]
    try:
        got = [eng.build_table(j, toks) for j in range(GRAPH_WARM_STEPS + 2)]
        ids, w = _want(eng, toks)
        for t in got:
            np.testing.assert_array_equal(t.expert_ids, ids)
            np.testing.assert_array_equal(t.weights.view(np.int32), w.view(np.int32))
        assert eng._hash_graph is None
        assert _counters(tel) == [0, 0, GRAPH_WARM_STEPS + 2]
    finally:
        eng.close()
