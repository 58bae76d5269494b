"""The port's async prefetch pipeline (`repro_torch.core.offload.PrefetchPipeline`):
the protocol cases of `tests/test_prefetch.py` on the CPU — fences that
block only on needed experts, no half-written slot, clean shutdown,
protection by outstanding tickets, refresh after eviction, pinned experts,
staging counts, warm submits, work stealing, async uploads bit-equal to
inline ones in every slot format, the last of two uploads into a warm slot,
in-flight affinity — plus three differentials against the JAX package on
the committed `experiments/cache/sys_E8`: the async batch engine's logits
(1e-4 relative, against the JAX async engine and the port's synchronous
one), the async decode engine's greedy tokens and per-step loads, and a
paged pool that spills and pages in through the pipeline (traffic, tables
and spilled K/V). The `gpu` cases run the slow-link and staging checks, and
each slot format's side-stream writes against the inline ones, on the card
(`python -m pytest --noconftest -m gpu tests/test_torch_prefetch.py`);
nothing here imports JAX at module level, so they run where JAX is absent."""
import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.core.offload as offload
from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.core.hash_table import HashTable
from repro_torch.core.offload import EXPERT_TENSORS, ExpertStore, PrefetchPipeline
from repro_torch.models.transformer import init_params, n_moe_layers

torch.set_num_threads(2)
CK = os.path.join(os.path.dirname(__file__), "..", "experiments", "cache", "sys_E8")
REL = 1e-4
_PARAMS = {}


def _reduced():
    if "p" not in _PARAMS:
        cfg = get_config("switch-base-8").reduced()
        _PARAMS["p"] = (cfg, init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    return _PARAMS["p"]


def _store(slots, device="cpu", **kw):
    cfg, params = _reduced()
    return cfg, ExpertStore(cfg, params, slots_per_layer=slots, device=device, **kw)


def _table(L, experts, idx=0):
    """Every token of one sequence routed to `experts` (one a position) at
    every MoE layer."""
    n = len(experts)
    ids = np.zeros((L, 1, n, 1), np.int32)
    for j, e in enumerate(experts):
        ids[:, 0, j, 0] = e
    return HashTable(idx, ids, np.ones((L, 1, n, 1), np.float32))


def _slot_rows(store, s, g, slot, e):
    """(device slot row, what the host master says it must hold) pairs."""
    moe_p = store.serve_params["blocks"][f"sub{s}"]["moe"]
    out = []
    for t in EXPERT_TENSORS:
        if slot >= store.S8:
            w = slot - store.S8
            out += [(moe_p[t + "_q4"][g, w], store.host4[f"sub{s}"][t][g, e]),
                    (moe_p[t + "_q4_scale"][g, w], store.host4_scale[f"sub{s}"][t][g, e])]
        elif store.quantized_slots:
            out += [(moe_p[t][g, slot], store.host[f"sub{s}"][t][g, e]),
                    (moe_p[t + "_scale"][g, slot], store.host_scale[f"sub{s}"][t][g, e])]
        elif store.quant == "int8":
            q, sc = store.host[f"sub{s}"][t][g, e], store.host_scale[f"sub{s}"][t][g, e]
            out.append((moe_p[t][g, slot], (q.float() * sc).to(moe_p[t].dtype)))
        else:
            out.append((moe_p[t][g, slot], store.host[f"sub{s}"][t][g, e]))
    return out


def _assert_resident_matches_host(store):
    for l in range(store.L):
        g, s = store.layer_to_gs(l)
        for e, slot in store.resident[(g, s)].items():
            for dev, host in _slot_rows(store, s, g, slot, e):
                assert torch.equal(dev.cpu(), host), (l, e, slot)


@pytest.fixture
def slow_link(monkeypatch):
    """A saturated H2D link: every staged put sleeps first."""

    def patch(delay):
        real = offload._staged_put

        def slow(x, device):
            time.sleep(delay)
            return real(x, device)

        monkeypatch.setattr(offload, "_staged_put", slow)

    return patch


# ---------------------------------------------------------------------------
# basic protocol
# ---------------------------------------------------------------------------


def test_submit_wait_release_roundtrip():
    cfg, store = _store(2)
    pipe = PrefetchPipeline(store, depth=2, staging_buffers=2)
    rng = np.random.default_rng(0)
    try:
        for it in range(8):
            t = _table(store.L, rng.integers(0, store.E, size=2), it)
            tk = pipe.submit(t)
            assert tk.wait(timeout=20), "fence timed out"
            _, w = store.translate(t, tk.trans)
            assert (w > 0).all()              # every needed expert resident
            _assert_resident_matches_host(store)
            tk.release()
    finally:
        pipe.close()
    assert pipe.stats.uploads > 0 and pipe.stats.submitted == 8


def test_async_matches_sync_batch_serving():
    """SiDAEngine.serve through the pipeline gives the synchronous engine's
    logits under eviction, with lookahead reordering."""
    cfg, params = _reduced()
    hp = init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg),
                      cfg.moe.num_experts, d_h=16, device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32) for _ in range(4)]
    ea = SiDAEngine(cfg, params, hp, slots_per_layer=2, prefetch_depth=2, device="cpu")
    ea.serve(batches, threaded=True, lookahead=2)
    ea.close()
    es = SiDAEngine(cfg, params, hp, slots_per_layer=2, device="cpu")
    es.serve(batches, threaded=True, lookahead=2)
    for a, b in zip(ea.results, es.results):
        assert (a - b).abs().max() / max(b.abs().max(), 1e-9) < REL
    assert ea.prefetcher.stats.submitted == 4 and ea.store._prefetcher is None


def test_prefetch_knobs_precedence():
    """Explicit arguments > cfg.prefetch > off, as the reference resolves them."""
    cfg, store = _store(2)
    assert PrefetchPipeline.maybe_create(store, cfg) is None
    on = dataclasses.replace(cfg, prefetch=dataclasses.replace(cfg.prefetch, enabled=True,
                                                               depth=3, staging_buffers=4))
    pipe = PrefetchPipeline.maybe_create(store, on)
    assert (pipe.depth, pipe.n_staging) == (3, 4)
    with pytest.raises(ValueError, match="already has"):
        PrefetchPipeline(store)
    pipe.close()
    assert PrefetchPipeline.maybe_create(store, on, prefetch_depth=0) is None
    pipe = PrefetchPipeline.maybe_create(store, cfg, prefetch_depth=1, staging_buffers=1)
    assert (pipe.depth, pipe.n_staging) == (1, 1)
    pipe.close()


# ---------------------------------------------------------------------------
# concurrency: slow transfers, partial fences, half-written slots
# ---------------------------------------------------------------------------


def test_fence_blocks_only_on_needed_experts(slow_link):
    slow_link(0.15)
    cfg, store = _store(4)
    pipe = PrefetchPipeline(store, depth=2)
    try:
        warm = pipe.submit(_table(store.L, [0, 1]))
        warm.wait(timeout=60)
        warm.release()
        tk = pipe.submit(_table(store.L, [2]))    # slow upload in flight
        t0 = time.perf_counter()
        tk.wait_experts(0, [0, 1])                # resident, no pending upload
        fast = time.perf_counter() - t0
        t0 = time.perf_counter()
        tk.wait_experts(0, [2])                   # must wait for the slow copy
        slow = time.perf_counter() - t0
        assert fast < 0.1, f"fence on resident experts blocked {fast:.3f}s"
        assert slow >= 0.05 or pipe.stats.uploads >= 3
        tk.wait(timeout=60)
        tk.release()
    finally:
        pipe.close()


def _no_half_written_slot(device):
    cfg, store = _store(2, device=device)
    pipe = PrefetchPipeline(store, depth=2)
    rng = np.random.default_rng(1)
    try:
        for it in range(5):
            tk = pipe.submit(_table(store.L, rng.integers(0, store.E, size=2), it))
            # fence-only wait (no stealing): the async writes themselves
            for l, ids in tk.needed.items():
                tk.wait_experts(l, ids)
            _assert_resident_matches_host(store)
            tk.release()
    finally:
        pipe.close()


def test_no_half_written_slot_is_observable(slow_link):
    """A ready fence fires only after all of its expert's tensors are
    written: with a slow link, waiting the fences and then reading every
    needed expert's tensors always gives the host master."""
    slow_link(0.02)
    _no_half_written_slot("cpu")


def test_shutdown_drains_and_joins(slow_link):
    slow_link(0.05)
    cfg, store = _store(4)
    pipe = PrefetchPipeline(store, depth=4)
    tk = pipe.submit(_table(store.L, [0, 1, 2]))
    pipe.close()                                  # drains the queued upload, then joins
    assert not pipe._thread.is_alive()
    assert tk.wait(timeout=0.1), "every fence is set after close()"
    _assert_resident_matches_host(store)
    assert store._prefetcher is None              # detached: the store is reusable


def test_close_is_idempotent():
    cfg, store = _store(2)
    pipe = PrefetchPipeline(store, depth=1)
    pipe.close()
    pipe.close()
    assert not pipe._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(_table(store.L, [0]))


def test_transfer_failure_raises_instead_of_hanging(monkeypatch):
    """A CUDA error on the transfer thread reaches the consumer: it is not
    retried, poisoned or degraded away into the synchronous path, and no
    fence waiter hangs. (Other errors are retried and replanned:
    tests/test_torch_faults.py.)"""
    cfg, store = _store(2)

    def broken(x, device):
        raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(offload, "_staged_put", broken)
    pipe = PrefetchPipeline(store, depth=1)
    try:
        tk = pipe.submit(_table(store.L, [0, 1]))
        tk._job = None                            # leave the job to the thread
        with pytest.raises(RuntimeError, match="CUDA error"):
            tk.wait(timeout=20)
        with pytest.raises(RuntimeError, match="CUDA error"):
            pipe.submit(_table(store.L, [2]))
        assert pipe.stats.upload_retries == pipe.stats.upload_failures == 0
    finally:
        pipe.close()


# ---------------------------------------------------------------------------
# eviction protection + consume-time refresh
# ---------------------------------------------------------------------------


def test_outstanding_ticket_protects_experts_from_planning():
    cfg, store = _store(2)
    pipe = PrefetchPipeline(store, depth=2)
    try:
        t1 = pipe.submit(_table(store.L, [0, 1]))
        t1.wait(timeout=20)
        # t1 unreleased: its experts cannot be planned out by a new submit
        t2 = pipe.submit(_table(store.L, [2, 3]))
        assert (t2.trans[0][[2, 3]] < 0).all()
        res = store.resident[(0, store.moe_subs[0])]
        assert 0 in res and 1 in res
        t1.release()                              # t2's refresh now re-plans and loads
        t2.wait(timeout=20)
        assert t2.trans[0][2] >= 0 and t2.trans[0][3] >= 0
        _assert_resident_matches_host(store)
        t2.release()
    finally:
        pipe.close()


def test_refresh_reloads_expert_evicted_after_planning():
    cfg, store = _store(2)
    pipe = PrefetchPipeline(store, depth=4)
    try:
        t1 = pipe.submit(_table(store.L, [0, 1]))
        t1.wait(timeout=20)
        t1.release()
        t2 = pipe.submit(_table(store.L, [0]))
        t2.wait(timeout=20)
        t3 = pipe.submit(_table(store.L, [2, 3]))
        t2.release()
        t3.wait(timeout=20)
        t3.release()
        # t3's refresh evicted t2's expert 0; a new consumer of 0 reloads it
        t4 = pipe.submit(_table(store.L, [0]))
        t4.wait(timeout=20)
        assert t4.trans[0][0] >= 0
        _assert_resident_matches_host(store)
        t4.release()
    finally:
        pipe.close()


def test_pinned_experts_survive_async_planning():
    cfg, store = _store(2)
    pipe = PrefetchPipeline(store, depth=2)
    try:
        t1 = pipe.submit(_table(store.L, [0, 1]))
        t1.wait(timeout=20)
        t1.release()
        for l in range(store.L):
            store.pin_experts(l, [0, 1])
        t2 = pipe.submit(_table(store.L, [2, 3]))
        t2.wait(timeout=20)
        res = store.resident[(0, store.moe_subs[0])]
        assert 0 in res and 1 in res, "pinned experts were evicted"
        assert (t2.trans[0][[2, 3]] < 0).all()
        t2.release()
    finally:
        pipe.close()


# ---------------------------------------------------------------------------
# staging buffers, warm submits, work stealing
# ---------------------------------------------------------------------------


def _staging_counts(n_staging, device):
    cfg, store = _store(2, device=device)
    pipe = PrefetchPipeline(store, depth=2, staging_buffers=n_staging)
    rng = np.random.default_rng(2)
    try:
        for it in range(6):
            tk = pipe.submit(_table(store.L, rng.integers(0, store.E, size=2), it))
            tk._job = None          # no stealing: every upload goes through a slab
            tk.wait(timeout=20)
            _assert_resident_matches_host(store)
            tk.release()
        assert [len(ring) for ring in pipe._staging] == [n_staging]   # one shard's ring
        slabs = [slab for ring in pipe._staging for b in ring for slab in b.values()]
        # pinned on the card (the copies are asynchronous), pageable on the CPU
        assert slabs and all(slab.is_pinned() == (torch.device(device).type == "cuda")
                             for slab in slabs)
    finally:
        pipe.close()
    assert pipe.stats.uploads > 0


@pytest.mark.parametrize("n_staging", [1, 2, 3])
def test_staging_buffer_counts(n_staging):
    _staging_counts(n_staging, "cpu")


def test_warm_submit_is_fire_and_forget(slow_link):
    slow_link(0.1)
    cfg, store = _store(4)
    pipe = PrefetchPipeline(store, depth=1)
    try:
        tickets = [pipe.submit(_table(store.L, [i % 4]), protect=False) for i in range(6)]
        # backpressure: with depth 1 and a slow link some warming submits skip
        assert any(t is None for t in tickets) or pipe.stats.warm_skipped > 0
        # warm tickets hold no protection: a consumer can take every slot
        tk = pipe.submit(_table(store.L, [0, 1, 2, 3]))
        tk.wait(timeout=60)
        assert (tk.trans[0][[0, 1, 2, 3]] >= 0).all()
        _assert_resident_matches_host(store)
        tk.release()
    finally:
        pipe.close()


def test_fence_steals_queued_job_from_starved_thread(slow_link):
    slow_link(0.3)
    cfg, store = _store(4)
    pipe = PrefetchPipeline(store, depth=4)
    try:
        t1 = pipe.submit(_table(store.L, [0]))
        time.sleep(0.05)                          # the thread takes t1's job
        t2 = pipe.submit(_table(store.L, [1]))    # queued behind it
        t2.wait(timeout=60)
        assert pipe.stats.stolen >= 1, "the queued job should have been stolen"
        t2.release()
        t1.wait(timeout=60)
        t1.release()
        _assert_resident_matches_host(store)
    finally:
        pipe.close()


def test_steal_wakes_blocked_producer(slow_link):
    slow_link(0.2)
    cfg, store = _store(4)
    pipe = PrefetchPipeline(store, depth=1)
    try:
        t1 = pipe.submit(_table(store.L, [0]))
        time.sleep(0.05)
        t2 = pipe.submit(_table(store.L, [1]))    # fills the depth-1 queue
        produced = []
        th = threading.Thread(target=lambda: produced.append(pipe.submit(_table(store.L, [2]))))
        th.start()
        time.sleep(0.05)                          # the producer waits in backpressure
        t2.wait(timeout=60)                       # steals t2's job: must notify
        th.join(timeout=10)
        assert not th.is_alive(), "producer never woke after the steal"
        t2.release()
        t1.wait(timeout=60)
        t1.release()
        produced[0].wait(timeout=60)
        produced[0].release()
        _assert_resident_matches_host(store)
    finally:
        pipe.close()


def test_switch_interval_restored_after_close():
    before = sys.getswitchinterval()
    cfg, store = _store(2)
    pipe = PrefetchPipeline(store, depth=1)
    assert sys.getswitchinterval() <= PrefetchPipeline.SWITCH_INTERVAL_S
    pipe.close()
    assert sys.getswitchinterval() == before


def _assert_pools_equal(store, ref):
    """Both stores hold the same residents, and every resident slot's pool
    rows (w_in / w_gate / w_out, their `_scale` planes, the `_q4` /
    `_q4_scale` planes) are bit-equal between them."""
    assert store.resident == ref.resident and any(store.resident.values())
    for (g, s), res in store.resident.items():
        for e, slot in res.items():
            got, want = _slot_rows(store, s, g, slot, e), _slot_rows(ref, s, g, slot, e)
            assert len(got) == len(want)
            for (a, _), (b, _) in zip(got, want):
                assert torch.equal(a.cpu(), b.cpu()), (g, s, e, slot)


SLOT_FORMATS = pytest.mark.parametrize(
    "kw", [dict(), dict(host_quant="int8"), dict(quantized_slots=True),
           dict(quantized_slots=True, tier=TierConfig(int4_slots=True, warm_slots=1))],
    ids=["fp", "host-int8", "int8-slots", "tiered"])


def _async_uploads(kw, device):
    cfg, store = _store(2, device=device, **kw)
    _, ref = _store(2, device=device, **kw)
    pipe = PrefetchPipeline(store, depth=2)
    rng = np.random.default_rng(3)
    try:
        for it in range(6):
            t = _table(store.L, rng.integers(0, store.E, size=3), it)
            tk = pipe.submit(t)
            tk.wait(timeout=20)
            _assert_resident_matches_host(store)
            tk.release()
            ref.prepare(t)
    finally:
        pipe.close()
    for f in ("loads", "evictions", "hits", "dropped", "bytes_h2d", "promotions", "demotions"):
        assert getattr(store.stats, f) == getattr(ref.stats, f), f
    _assert_pools_equal(store, ref)
    if "tier" in kw:
        assert store.S4 == 1 and store.stats.demotions > 0


@SLOT_FORMATS
def test_quantized_async_uploads(kw):
    """fp slots, int8 masters dequantised at write, int8-resident slots with
    their scale planes, and hot int8 / warm int4 tiers: every resident slot
    holds its master, the counters equal a synchronous store's on the same
    table stream, and the transfer thread's writes are bit-equal to the
    inline ones in every pool."""
    _async_uploads(kw, "cpu")


def _warm_slot_twice(path, device):
    tier = dict(quantized_slots=True, tier=TierConfig(int4_slots=True, warm_slots=1))
    _, store = _store(2, device=device, **tier)
    _, ref = _store(2, device=device, **tier)
    assert (store.S8, store.S4) == (2, 1)
    first, second = _table(store.L, [0, 1], 0), _table(store.L, [2, 3], 1)
    for t in (first, second):
        ref.prepare(t)
    if path == "inline":
        for t in (first, second):
            store.prepare(t)
    else:
        pipe = PrefetchPipeline(store, depth=2)
        try:
            for t in (first, second):
                tk = pipe.submit(t)
                tk._job = None                    # no stealing: the thread writes it
                assert tk.wait(timeout=20)
                tk.release()
        finally:
            pipe.close()
        assert pipe.stats.stolen == pipe.stats.sync_fallbacks == 0
    warm = store.S8
    for res in store.resident.values():
        # 0 and then 1 were demoted into the one warm slot: 1 holds it
        assert sorted(res) == [1, 2, 3] and res[1] == warm and max(res[2], res[3]) < warm
    assert store.stats.demotions == ref.stats.demotions == 2 * store.L
    assert store.stats.evictions == ref.stats.evictions == store.L
    assert store.stats.bytes_h2d == ref.stats.bytes_h2d
    _assert_resident_matches_host(store)
    _assert_pools_equal(store, ref)


@pytest.mark.parametrize("path", ["transfer", "inline"])
def test_one_plan_fills_a_warm_slot_twice(path):
    """Two demotions into the one warm slot in one plan (the second evicts
    the first's expert): both uploads are counted and the last one lands,
    on the transfer thread and inline."""
    _warm_slot_twice(path, "cpu")


def test_inflight_cache_affinity_credits_uploads(slow_link):
    slow_link(0.2)
    cfg, store = _store(4)
    pipe = PrefetchPipeline(store, depth=2)
    try:
        t = _table(store.L, [0, 1])
        tk = pipe.submit(t)
        # uploads still in flight: the pipeline's affinity credits them
        assert pipe.cache_affinity(t) == 1.0
        assert store.cache_affinity(t) <= 1.0
        tk.wait(timeout=60)
        tk.release()
        assert store.cache_affinity(t) == 1.0
    finally:
        pipe.close()


def test_sync_prepare_fences_on_inflight_uploads(slow_link):
    """A synchronous prepare on a store with a pipeline attached waits on the
    uploads in flight instead of issuing them again."""
    slow_link(0.1)
    cfg, store = _store(4)
    pipe = PrefetchPipeline(store, depth=2)
    try:
        t = _table(store.L, [0, 1])
        tk = pipe.submit(t)
        tk._job = None                           # left to the transfer thread
        loads = store.stats.loads
        trans = store.prepare(t)
        assert store.stats.loads == loads        # nothing planned twice
        assert (trans[0][[0, 1]] >= 0).all()
        _assert_resident_matches_host(store)
        tk.wait(timeout=20)
        tk.release()
    finally:
        pipe.close()


def test_stress_many_producers_one_consumer():
    """Eight producer threads submit while one consumer clears, checks and
    releases the tickets in submission order, under a 10 µs switch interval:
    every consumed ticket finds each needed expert resident and whole."""
    import queue

    cfg, store = _store(2)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pipe = PrefetchPipeline(store, depth=2)
    handoff: "queue.Queue" = queue.Queue()

    def producer(k):
        rng = np.random.default_rng(k)
        for it in range(8):
            t = _table(store.L, rng.integers(0, store.E, size=2), it)
            handoff.put((t, pipe.submit(t)))

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(8)]
    try:
        for th in threads:
            th.start()
        for _ in range(64):
            t, tk = handoff.get(timeout=60)
            assert tk.wait(timeout=60)
            _, w = store.translate(t, tk.trans)
            assert (w > 0).all()
            for l, ids in tk.needed.items():
                g, s = store.layer_to_gs(l)
                for e in ids:
                    for dev, host in _slot_rows(store, s, g, store.resident[(g, s)][int(e)],
                                                int(e)):
                        assert torch.equal(dev, host)
            tk.release()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        assert pipe.stats.submitted == 64 and not any(pipe._refs[k] for k in pipe._refs)
    finally:
        pipe.close()
        sys.setswitchinterval(before)


# ---------------------------------------------------------------------------
# differentials against the JAX package on sys_E8
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def e8():
    import jax

    from repro.checkpoint.io import load_checkpoint
    from repro.configs.base import get_config as jget_config
    from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
    from repro.models.transformer import init_params as j_init_params
    from repro.models.transformer import n_moe_layers as j_n_moe_layers
    from repro_torch.checkpoint import params_from_numpy

    def cfg_of(get):   # the miniature the benchmarks train (bench_cfg(8))
        cfg = get("switch-base-8").reduced()
        return dataclasses.replace(cfg, n_layers=4, d_ff=128, moe=dataclasses.replace(
            cfg.moe, num_experts=8, top_k=1, capacity_factor=4.0, d_expert=512))

    cfg_j, cfg_t = cfg_of(jget_config), cfg_of(get_config)
    pj, _ = load_checkpoint(os.path.join(CK, "model"),
                            like=j_init_params(jax.random.PRNGKey(0), cfg_j))
    hj, _ = load_checkpoint(os.path.join(CK, "hash"), like=j_init_hash_fn(
        jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j), 8, d_h=32))
    pj, hj = jax.tree.map(np.asarray, pj), jax.tree.map(np.asarray, hj)
    return cfg_j, cfg_t, pj, hj, params_from_numpy(pj), params_from_numpy(hj)


@pytest.mark.parametrize("slots,lookahead", [(2, 1), (3, 2)])
def test_async_engine_matches_jax_async_and_port_sync_on_e8(e8, slots, lookahead):
    from repro.core.engine import SiDAEngine as JEngine

    cfg_j, cfg_t, pj, hj, pt, ht = e8
    batches = [np.random.default_rng(i).integers(0, cfg_t.vocab_size, (2, 24)).astype(np.int32)
               for i in range(5)]
    ej = JEngine(cfg_j, pj, hj, slots_per_layer=slots, prefetch_depth=2)
    ea = SiDAEngine(cfg_t, pt, ht, slots_per_layer=slots, prefetch_depth=2, device="cpu")
    es = SiDAEngine(cfg_t, pt, ht, slots_per_layer=slots, device="cpu")
    for e in (ej, ea, es):
        e.serve(batches, threaded=True, lookahead=lookahead)
        e.close()
    for a, b, c in zip(ea.results, ej.results, es.results):
        a = a.numpy()
        assert np.abs(a - np.asarray(b)).max() / np.abs(np.asarray(b)).max() < REL
        assert np.abs(a - c.numpy()).max() / np.abs(c.numpy()).max() < REL
    assert ea.prefetcher.stats.submitted == 5 and ea.store.stats.evictions > 0
    _assert_resident_matches_host(ea.store)     # two groups share slot indices


@pytest.mark.parametrize("quant", [dict(), dict(quantized_slots=True)], ids=["fp", "int8"])
def test_async_decode_engine_matches_jax_on_e8(e8, quant):
    from repro.core import decode_engine as jd
    from repro_torch.core import decode_engine as td

    cfg_j, cfg_t, pj, hj, pt, ht = e8
    start = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (3,)).astype(np.int32)
    ej = jd.SiDADecodeEngine(cfg_j, pj, hj, slots_per_layer=3, prefetch_depth=2, **quant)
    et = td.SiDADecodeEngine(cfg_t, pt, ht, slots_per_layer=3, prefetch_depth=2, device="cpu",
                             **quant)
    oj, mj = ej.generate(start, steps=20, cache_len=16)
    ot, mt = et.generate(start, steps=20, cache_len=16)
    np.testing.assert_array_equal(ot, oj)
    assert mt.loads_per_step == mj.loads_per_step and sum(mt.loads_per_step[1:]) > 0
    assert mt.stall_s > 0 and et.prefetcher.stats.submitted == 20
    for f in ("bytes_h2d", "loads", "evictions", "hits", "dropped"):
        assert getattr(et.store.stats, f) == getattr(ej.store.stats, f), f
    assert et.store.resident == ej.store.resident
    et.close()
    ej.close()
    assert et.store._prefetcher is None


def test_paged_pool_pages_in_through_the_pipeline_like_jax():
    """A windowed model whose tight pool spills and pages back in, with the
    page-ins riding the pipeline: the JAX engine's tokens, the same pool
    traffic and table, and the same spilled K/V."""
    from test_torch_paged import _generate, _system
    from repro_torch.core import residency as tr

    wtiny = _system(window=8)
    tight = tr.PagedKVConfig(page_size=4, kv_pages=6, max_seq=64)
    ot, _, et = _generate(wtiny, "torch", tight, steps=24, prefetch_depth=2)
    oj, _, ej = _generate(wtiny, "jax", tight, steps=24, prefetch_depth=2)
    ref, _, _ = _generate(wtiny, "torch", tight, steps=24)
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(ot, ref)
    pt, pj = et.kv_pool, ej.kv_pool
    assert pt.pipeline is not None and pj.pipeline is not None
    got = dataclasses.asdict(pt.stats)
    assert got.pop("fence_wait_s") >= 0.0
    assert got == {k: getattr(pj.stats, k) for k in got}
    assert pt.stats.spills > 0 and pt.stats.page_ins > 0
    np.testing.assert_array_equal(pt.table, pj.table)
    assert set(pt._spill) == set(pj._spill)
    for key, subs in pt._spill.items():
        for skey, (k, v) in subs.items():
            kj, vj = pj._spill[key][skey]
            np.testing.assert_allclose(k.numpy(), np.asarray(kj), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(v.numpy(), np.asarray(vj), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_no_half_written_slot_on_the_card(cuda, slow_link):
    """The side-stream copies and writes behind CUDA-event fences: after the
    fences, the consumer's stream reads every needed slot whole."""
    slow_link(0.02)
    _no_half_written_slot(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("n_staging", [1, 2])
def test_staging_reuse_on_the_card(cuda, n_staging):
    """One (or two) pinned slabs reused across back-to-back uploads: a slab
    is refilled only after the copies out of it have completed."""
    _staging_counts(n_staging, cuda)


@pytest.mark.gpu
@SLOT_FORMATS
def test_async_uploads_on_the_card(cuda, kw):
    """Each slot format written on the transfer thread's side stream is
    bit-equal to the inline write on the consumer's stream."""
    _async_uploads(kw, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["transfer", "inline"])
def test_warm_slot_twice_on_the_card(cuda, path):
    """The last of two uploads into one warm slot lands on the card too."""
    _warm_slot_twice(path, cuda)
