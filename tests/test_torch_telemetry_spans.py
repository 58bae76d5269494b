"""Spans of `serving/telemetry.py::Telemetry` inside the port's serving
threads and decode loop: off by default and free of effects on what is
served, nested per thread, each stamped with its batch or step, and adding
up to the engines' own host-clock accounting. Also the batch engine's
results copy: results kept from one call survive the next, and on the card
(`python -m pytest --noconftest -m gpu tests/test_torch_telemetry_spans.py`)
each is pinned, equals the forward's logits, reuses the host blocks of the
call before and holds no second logits on the device."""
import bisect
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.decode_engine import SiDADecodeEngine
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.core.residency import PagedKVConfig
from repro_torch.models.transformer import init_params, n_moe_layers
from repro_torch.serving import RequestServer
from repro_torch.serving.telemetry import Telemetry

HASH_LEAVES = ("hash.launch", "hash.d2h", "hash.submit", "hash.queue_put")


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("switch-base-8").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    hp = init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg),
                      cfg.moe.num_experts, d_h=16, device="cpu", draft=True)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32) for _ in range(5)]
    return cfg, params, hp, batches


def _serve(tiny, telemetry, depth):
    cfg, params, hp, batches = tiny
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=2, prefetch_depth=depth, device="cpu",
                     telemetry=telemetry)
    try:
        m = eng.serve(batches)
    finally:
        eng.close()
    return eng, m


DECODE = {"ring": ({}, {}),
          "paged": ({}, {"paged": PagedKVConfig(page_size=4, kv_pages=6, max_seq=16)}),
          "spec": ({"spec_mode": "draft", "spec_k": 3}, {})}


def _generate(tiny, telemetry, mode, steps=8):
    cfg, params, hp, _ = tiny
    kw, gen_kw = DECODE[mode]
    eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=2, device="cpu",
                           telemetry=telemetry, **kw)
    out, m = eng.generate(np.array([3, 1, 4], np.int32), steps=steps, cache_len=16, **gen_kw)
    eng.close()
    return out, m


def test_span_off_is_one_shared_noop_and_keeps_the_schema():
    tel = Telemetry()
    before = tel.snapshot()
    a, b = tel.span("hash.launch", 0), tel.span("infer.forward")
    assert a is b
    with a:
        pass
    assert tel.spans == []
    tel.record_spans = True
    after = tel.snapshot()
    before.pop("wall_s"), after.pop("wall_s")
    assert after == before and "spans" not in tel.to_json()
    with tel.span("x", 7):
        pass
    assert list(tel.snapshot()["spans"]) == ["x"]
    assert tel.span_totals()["x"]["count"] == 1


def test_spans_nest_per_thread_and_inherit_the_ident():
    """More threads than cores, switching every microsecond: no span is
    lost, each nests in its own thread's parent and takes its ident."""
    tel = Telemetry(record_spans=True)
    n_threads, rounds = 16, 200
    alive = threading.Barrier(n_threads)   # a thread id is unique among live threads
    ident = {}

    def work(j):
        ident[threading.get_ident()] = j
        for _ in range(rounds):
            with tel.span("outer", j):
                with tel.span("inner"):
                    with tel.span("leaf", 100 + j):
                        pass
        alive.wait(timeout=60)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(j,)) for j in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert len(tel.spans) == 3 * n_threads * rounds
    for s in tel.spans:
        j = ident[s.thread]
        assert s.ident == {"outer": j, "inner": j, "leaf": 100 + j}[s.name]
        assert s.parent == {"outer": None, "inner": "outer", "leaf": "inner"}[s.name]
    _check_nesting(tel.spans)


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "async"])
def test_batch_spans_change_nothing_served(tiny, depth):
    off = Telemetry()
    plain, _ = _serve(tiny, None, depth)
    quiet, _ = _serve(tiny, off, depth)
    traced, _ = _serve(tiny, Telemetry(record_spans=True), depth)
    assert off.spans == [] and "spans" not in off.snapshot()
    assert traced.telemetry.spans
    for a, b, c in zip(plain.results, quiet.results, traced.results):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("mode", sorted(DECODE))
def test_decode_spans_change_nothing_served(tiny, mode):
    off, on = Telemetry(), Telemetry(record_spans=True)
    plain, _ = _generate(tiny, None, mode)
    quiet, _ = _generate(tiny, off, mode)
    traced, _ = _generate(tiny, on, mode)
    assert off.spans == [] and on.spans
    np.testing.assert_array_equal(plain, quiet)
    np.testing.assert_array_equal(plain, traced)


def _check_nesting(spans):
    """Each span with a parent lies inside the latest span of that name
    opened before it on its thread."""
    opened = {}
    for s in spans:
        opened.setdefault((s.thread, s.name), []).append(s)
    for v in opened.values():
        v.sort(key=lambda q: q.start_ns)
    starts = {k: [q.start_ns for q in v] for k, v in opened.items()}
    for s in spans:
        if s.parent is None:
            continue
        i = bisect.bisect_right(starts[(s.thread, s.parent)], s.start_ns) - 1
        assert i >= 0, s
        p = opened[(s.thread, s.parent)][i]
        assert s.end_ns <= p.end_ns, (s, p)


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "async"])
def test_hash_spans_add_up_to_hash_time(tiny, depth):
    tel = Telemetry(record_spans=True)
    eng, m = _serve(tiny, tel, depth)
    n = len(tiny[3])
    hash_thread = {s.thread for s in tel.spans if s.name == "hash.batch"}
    assert len(hash_thread) == 1
    leaves = [s for s in tel.spans if s.name in HASH_LEAVES]
    assert {s.thread for s in leaves} == hash_thread
    assert sorted(s.ident for s in tel.spans if s.name == "hash.batch") == list(range(n))
    for s in tel.spans:
        if s.name.startswith("hash.") or s.name == "prefetch.backpressure":
            assert s.ident in range(n), s
    assert all(s.parent == "hash.batch" for s in leaves)
    total = sum(s.end_ns - s.start_ns for s in leaves) / 1e9
    assert total == pytest.approx(m.hash_time_s, rel=0.05)
    assert (depth > 0) == any(s.name == "hash.submit" for s in leaves)
    _check_nesting(tel.spans)
    # the inference thread's spans carry their batch, and the results copy
    # counts every byte it moved
    for name in ("infer.route", "infer.forward", "infer.drain", "infer.results_copy"):
        idents = sorted({s.ident for s in tel.spans if s.name == name})
        assert idents == list(range(n)), name
    got = tel.counter("results_copy_bytes").value
    assert got == sum(r.numel() * r.element_size() for r in eng.results)
    inline, transfer = (tel.counter(f"upload_bytes_{k}").value for k in ("inline", "transfer"))
    assert inline + transfer == eng.store.stats.bytes_h2d > 0


@pytest.mark.parametrize("mode", sorted(DECODE))
def test_decode_spans_add_up_to_each_step(tiny, mode):
    tel = Telemetry(record_spans=True)
    _, m = _generate(tiny, tel, mode)
    assert len(m.step_s) == m.steps > 0
    top = [s for s in tel.spans if s.parent is None]
    assert all(s.name.startswith("decode.") for s in top)
    want = {"decode.predict", "decode.ids_d2h", "decode.route", "decode.translate",
            "decode.step", "decode.token_d2h"} | ({"decode.page_tick"} if mode == "paged" else set())
    assert {s.name for s in top} == want
    for i, step_s in enumerate(m.step_s):
        mine = [s for s in top if s.ident == i]
        assert {s.name for s in mine} == want
        assert sum(s.end_ns - s.start_ns for s in mine) / 1e9 == pytest.approx(step_s, rel=0.05)
    assert all(s.ident in range(m.steps) for s in tel.spans)
    _check_nesting(tel.spans)


def test_request_server_shares_its_telemetry(tiny):
    cfg, params, hp, _ = tiny
    tel = Telemetry()
    srv = RequestServer(cfg, params, hp, slots_per_layer=2, max_lanes=2, prefetch_depth=2,
                        device="cpu", telemetry=tel)
    try:
        assert srv.telemetry is tel
        assert srv.store.telemetry is tel and srv.engine.telemetry is tel
        assert srv.prefetch.telemetry is tel
    finally:
        srv.close()


@pytest.mark.parametrize("threaded", [True, False], ids=["threaded", "sequential"])
def test_kept_results_survive_the_next_call(tiny, threaded):
    cfg, params, hp, batches = tiny
    tel = Telemetry()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=2, device="cpu", telemetry=tel)
    other = [np.random.default_rng(9).integers(0, cfg.vocab_size, b.shape).astype(np.int32)
             for b in batches]
    try:
        eng.serve(batches, threaded=threaded)
        kept = eng.results
        want = [r.clone() for r in kept]
        eng.serve(other, threaded=threaded)
    finally:
        eng.close()
    assert all(torch.equal(a, b) for a, b in zip(kept, want))
    assert not all(torch.equal(a, b) for a, b in zip(kept, eng.results))
    assert tel.counter("results_copy_bytes").value == sum(
        r.numel() * r.element_size() for r in kept + eng.results)
    assert tel.counter("results_pinned_new").value == 0
    assert tel.counter("results_pinned_reused").value == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_results_copy_pinned_and_reused_on_the_card(tiny, cuda):
    # switch-base-8's vocabulary, so that a batch's logits (263 MB) dwarf
    # the predictor's tensors in the device peak
    cfg = dataclasses.replace(tiny[0], vocab_size=32128)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    hp = tiny[2]
    rng = np.random.default_rng(3)
    tel = Telemetry()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=2, device=cuda, telemetry=tel)
    forward_logits = {}
    infer = eng.infer

    def recording_infer(tokens, table, ticket=None):
        out = infer(tokens, table, ticket=ticket)
        forward_logits[table.batch_index] = out.cpu()
        return out

    eng.infer = recording_infer
    counts = lambda: tuple(tel.counter(f"results_pinned_{k}").value for k in ("new", "reused"))

    def call(n):
        """Serve `n` fresh [8, 256] batches; the device peak over the call
        and the pinned counters' moves."""
        forward_logits.clear()
        before = counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng.serve([rng.integers(0, cfg.vocab_size, (8, 256)).astype(np.int32)
                   for _ in range(n)])
        peak = torch.cuda.max_memory_allocated()
        for i, r in enumerate(eng.results):
            assert r.is_pinned() and r.device.type == "cpu"
            assert torch.equal(r, forward_logits[i])
        return peak, tuple(b - a for a, b in zip(before, counts()))

    try:
        n = 4
        _, first = call(n)          # also sets up the threads' cuBLAS workspaces
        assert first == (n, 0)
        eng.results = []
        peak_one, _ = call(1)
        eng.results = []
        peak_four, second = call(n)
        assert second == (0, n)                     # every block of the first call
        kept, want = eng.results[0], forward_logits[0]    # `want` is pageable
        eng.results = []
        _, third = call(n)                          # one block still held by `kept`
        assert third == (1, n - 1)
        assert torch.equal(kept, want)
        # no second batch's logits is alive on the device while a copy runs
        assert peak_four == pytest.approx(peak_one, rel=0.01)
    finally:
        eng.close()
