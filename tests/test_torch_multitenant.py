"""The port's multi-tenant front door against the JAX package's, on the CPU:
mirrors of `tests/test_multitenant.py` (WFQ by deficit round robin over
per-tenant queues, rate budgets that defer and never drop, pin quotas that
cap a tenant's pinned share at floor(quota x S) a layer, the tenant-aware
split of the shed gate, and two tenants through the whole server). Each
case runs the same seeded inputs through the reference's objects and the
port's, and compares the WFQ batch order, shedding decisions, pin grants,
refusals and tokens per request exactly, beside the reference's own
assertions."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
from repro.core.hash_table import HashTable as JHashTable
from repro.core.offload import ExpertStore as JExpertStore
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro import serving as jserving
from repro_torch import serving as tserving
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.hash_table import HashTable
from repro_torch.core.offload import ExpertStore

torch.set_num_threads(2)
# (serving package, hash table class) of each side
SIDES = {"jax": (jserving, JHashTable), "port": (tserving, HashTable)}


def _req(side, rid, tenant, plen=8, new=4, arrival=0.0, slo=None):
    mod, table = SIDES[side]
    r = mod.Request(rid=rid, prompt=np.arange(plen, dtype=np.int32), max_new_tokens=new,
                    arrival_s=arrival, slo_s=slo, tenant=tenant)
    r.table = table(rid, np.zeros((1, 1, plen, 1), np.int32), np.ones((1, 1, plen, 1), np.float32))
    return r


def _drain(sched, now=0.0, max_batch=4, rounds=200):
    """Pop prefill batches until the queues drain; the rids of each batch in
    service order (every batch single-tenant)."""
    served = []
    for _ in range(rounds):
        batch, _bucket = sched.next_prefill_batch(now, max_batch)
        if not batch:
            break
        assert len({r.tenant for r in batch}) == 1
        served.append([r.rid for r in batch])
    return served


def _both(build):
    """`build(side)` on each side; returns (jax result, port result)."""
    return build("jax"), build("port")


def _wfq(side, tenants, **kw):
    mod = SIDES[side][0]
    return mod.WFQScheduler([mod.TenantConfig(**t) for t in tenants], **kw)


# ---------------------------------------------------------------------------
# WFQ / DRR units
# ---------------------------------------------------------------------------


def test_wfq_service_tracks_weight_not_load():
    """3:1 weights, equal offered load: the same batch order, whose first 80
    batches serve the tenants about 3:1."""
    def run(side):
        sched = _wfq(side, [dict(name="heavy", weight=3.0), dict(name="light", weight=1.0)],
                     quantum=4.0, buckets=(8,), use_affinity=False)
        for i in range(120):
            sched.enqueue(_req(side, 2 * i, "heavy"))
            sched.enqueue(_req(side, 2 * i + 1, "light"))
        return _drain(sched, max_batch=1, rounds=400)

    want, got = _both(run)
    assert got == want
    window = ["heavy" if b[0] % 2 == 0 else "light" for b in got[:80]]
    h, li = window.count("heavy"), window.count("light")
    assert li > 0 and 2.0 <= h / li <= 4.0, (h, li)


def test_wfq_starvation_free_under_flood():
    def run(side):
        sched = _wfq(side, [dict(name="whale", weight=100.0), dict(name="minnow")],
                     quantum=8.0, buckets=(8,), use_affinity=False)
        for i in range(200):
            sched.enqueue(_req(side, i, "whale"))
        sched.enqueue(_req(side, 999, "minnow"))
        return _drain(sched, max_batch=1, rounds=300)

    want, got = _both(run)
    assert got == want
    assert [999] in got and got.index([999]) < 10


def test_wfq_unknown_tenant_gets_default_contract():
    def run(side):
        sched = _wfq(side, [dict(name="known")], quantum=8.0, buckets=(8,))
        sched.enqueue(_req(side, 0, "walk-in"))
        batch, bucket = sched.next_prefill_batch(0.0, 4)
        return [r.rid for r in batch], bucket, sched.tenants["walk-in"].cfg.weight

    want, got = _both(run)
    assert got == want == ([0], 8, 1.0)


def test_wfq_rate_budget_defers_and_resumes():
    """An exhausted token budget defers the tenant (kept queued), and refill
    serves it later: never dropped."""
    def run(side):
        sched = _wfq(side, [dict(name="capped", token_rate=10.0, burst=10.0), dict(name="free")],
                     quantum=64.0, buckets=(8,))
        sched.enqueue(_req(side, 0, "capped"))
        sched.enqueue(_req(side, 1, "free"))
        sched.debit("capped", 30, now=0.0)
        at_0 = _drain(sched, now=0.0, rounds=4)
        pending = sched.pending_tenant("capped")
        later, _ = sched.next_prefill_batch(2.5, 4)
        return at_0, pending, [r.tenant for r in later], sched.tenants["capped"].tokens

    want, got = _both(run)
    assert got == want
    assert got[:3] == ([[1]], 1, ["capped"])


def test_wfq_empty_queue_forfeits_deficit():
    def run(side):
        sched = _wfq(side, [dict(name="a"), dict(name="b")], quantum=8.0, buckets=(8,))
        sched.enqueue(_req(side, 0, "a"))
        first = _drain(sched)
        for i in range(5):
            sched.enqueue(_req(side, 10 + i, "b"))
        return first, _drain(sched), sched.tenants["a"].deficit, sched.tenants["b"].deficit

    want, got = _both(run)
    assert got == want and got[2] == 0.0


def test_wfq_single_tenant_batch_fills_same_bucket():
    def run(side):
        sched = _wfq(side, [dict(name="a")], quantum=1000.0, buckets=(8, 16))
        for i in range(3):
            sched.enqueue(_req(side, i, "a", plen=8))
        sched.enqueue(_req(side, 3, "a", plen=16))
        out = []
        for _ in range(2):
            batch, bucket = sched.next_prefill_batch(0.0, 4)
            out.append(([r.rid for r in batch], bucket))
        return out

    want, got = _both(run)
    assert got == want == [([0, 1, 2], 8), ([3], 16)]


@pytest.mark.parametrize("seed", [0, 1])
def test_wfq_mixed_stream_matches_jax(seed):
    """A seeded mixed stream (three tenants, weights, rate budgets, SLOs,
    two buckets, arrivals and debits interleaved with the pops): the same
    batches, in the same order, with the same deficits and token balances."""
    tenants = [dict(name="a", weight=2.0), dict(name="b", token_rate=20.0, burst=8.0),
               dict(name="c", weight=0.5, default_slo_s=1.0)]

    def run(side):
        rng = np.random.default_rng(seed)
        sched = _wfq(side, tenants, quantum=16.0, buckets=(8, 16), use_affinity=False)
        out, rid, now = [], 0, 0.0
        for step in range(60):
            for _ in range(int(rng.integers(0, 3))):
                t = ("a", "b", "c")[int(rng.integers(0, 3))]
                sched.enqueue(_req(side, rid, t, plen=int(rng.integers(2, 17)),
                                   new=int(rng.integers(1, 9)), arrival=now,
                                   slo=float(rng.uniform(0.5, 3.0)) if rng.random() < 0.5 else None))
                rid += 1
            now += float(rng.uniform(0.0, 0.2))
            batch, bucket = sched.next_prefill_batch(now, int(rng.integers(1, 4)))
            for r in batch:
                sched.debit(r.tenant, r.max_new_tokens, now)
            out.append(([r.rid for r in batch], bucket))
        state = {n: (st.deficit, st.tokens) for n, st in sched.tenants.items()}
        return out, state, sched.pending()

    want, got = _both(run)
    assert got == want
    assert sum(len(b) for b, _ in got[0]) > 20


# ---------------------------------------------------------------------------
# pin quotas (core/offload.py)
# ---------------------------------------------------------------------------


def _tiny_cfg(get):
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(cfg, n_layers=2,
                               moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


@pytest.fixture(scope="module")
def tiny():
    """(cfg_j, cfg_t, JAX params, JAX hash params, port params, port hash
    params): the reference's seeds, d_h 16."""
    cfg_j, cfg_t = _tiny_cfg(jget_config), _tiny_cfg(get_config)
    pj = j_init_params(jax.random.PRNGKey(0), cfg_j)
    hj = j_init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j),
                        cfg_j.moe.num_experts, d_h=16)
    return (cfg_j, cfg_t, pj, hj, params_from_numpy(jax.tree.map(np.asarray, pj)),
            params_from_numpy(jax.tree.map(np.asarray, hj)))


def _stores(tiny, slots):
    return (JExpertStore(tiny[0], tiny[2], slots_per_layer=slots),
            ExpertStore(tiny[1], tiny[4], slots_per_layer=slots, device="cpu"))


def _pins(store):
    return ({k: sorted(v) for k, v in store.pinned.items()},
            {k: dict(v) for k, v in store.pin_owner.items()}, store.stats.pin_quota_refusals)


def test_pin_quota_caps_share(tiny):
    out = []
    for store in _stores(tiny, 4):
        store.set_pin_quota("greedy", 0.5)        # cap = floor(0.5 x 4) = 2 a layer
        g1 = store.pin_experts(0, [0, 1, 2, 3], tenant="greedy")
        g2 = store.pin_experts(0, [2, 3], tenant="other")
        out.append((g1, g2, store.pinned_count(0, "greedy"), store.pinned_share("greedy"),
                    store.pin_cap("greedy"), _pins(store)))
    assert out[1] == out[0]
    assert out[1][0] == {0, 1} and 2 in out[1][1] and out[1][3] <= 0.5
    assert out[1][5][2] == 2                      # two refusals


def test_pin_quota_same_expert_not_double_attributed(tiny):
    out = []
    for store in _stores(tiny, 4):
        store.set_pin_quota("t", 0.5)
        steps = [store.pin_experts(0, [5], tenant="t"), store.pin_experts(0, [5], tenant="t"),
                 store.pinned_count(0, "t"), store.pin_experts(0, [5], tenant="u")]
        store.unpin_experts(0, [5], tenant="u")
        steps.append(store.pinned_count(0, "t"))
        store.unpin_experts(0, [5], tenant="t")
        steps += [store.pinned_count(0, "t"), _pins(store)]
        out.append(steps)
    assert out[1] == out[0]
    assert out[1][:6] == [{5}, {5}, 1, set(), 1, 0]


def test_pin_quota_rejects_bad_fraction(tiny):
    for store in _stores(tiny, 2):
        for bad in (0.0, -0.5, 1.5):
            with pytest.raises(ValueError):
                store.set_pin_quota("t", bad)


def test_legacy_untenanted_pins_unchanged(tiny):
    out = []
    for store in _stores(tiny, 4):
        store.set_pin_quota("t", 0.25)
        out.append((store.pin_experts(0, [0, 1, 2]), _pins(store)))
    assert out[1] == out[0] and out[1][0] == {0, 1, 2} and out[1][1][2] == 0


def test_pinned_experts_steer_planning_like_jax(tiny):
    """Tenant pins under a quota, then a seeded table stream: the same
    grants, refusals, resident sets, evictions and translations."""
    from repro.core.hash_table import HashTable as JT

    out = []
    for store, table in zip(_stores(tiny, 3), (JT, HashTable)):
        store.set_pin_quota("heavy", 0.34)        # 1 of 3 slots
        grants = [store.pin_experts(l, [1, 2], tenant="heavy") for l in range(store.L)]
        rng = np.random.default_rng(7)
        trans = []
        for i in range(12):
            ids = rng.integers(0, store.E, (store.L, 1, 4, 1)).astype(np.int32)
            t = table(i, ids, np.ones(ids.shape, np.float32))
            trans.append(np.asarray(store.prepare(t)).tolist())
        st = store.stats
        out.append((grants, _pins(store), trans, store.resident,
                    (st.loads, st.hits, st.evictions, st.dropped, st.pin_quota_refusals)))
    assert out[1] == out[0]
    assert out[1][4][4] == len(out[1][0]) and out[1][0][0] == {1}   # one refusal a MoE layer


# ---------------------------------------------------------------------------
# the tenant-aware admission split
# ---------------------------------------------------------------------------


def _admission(side, tenants, **kw):
    mod = SIDES[side][0]
    return mod.TenantAdmission(mod.AdmissionController(**kw),
                               [mod.TenantConfig(**t) for t in tenants])


def test_tenant_admission_isolates_shedding():
    def run(side):
        ta = _admission(side, [dict(name="busy", default_slo_s=1.0),
                               dict(name="idle", default_slo_s=1.0)], margin=0.5)
        ta.observe("busy", 2.0)
        return (ta.should_shed("busy", depth=8, slack_s=1.0),
                ta.should_shed("idle", depth=8, slack_s=1.0), ta.shedding)

    want, got = _both(run)
    assert got == want == (True, False, True)


def test_tenant_admission_applies_contract_slo():
    def run(side):
        ta = _admission(side, [dict(name="t", default_slo_s=1.0)], margin=0.5)
        ta.observe("t", 2.0)
        ta.observe("walkin", 2.0)
        return ta.should_shed("t", depth=8, slack_s=None), ta.should_shed("walkin", 8, None)

    want, got = _both(run)
    assert got == want == (True, False)


def test_admission_clone_is_independent():
    def run(side):
        base = SIDES[side][0].AdmissionController(margin=0.7, default_slo_s=3.0)
        base.observe(5.0)
        c = base.clone()
        fresh = (c.margin, c.default_slo_s, c.service_s, c.shedding)
        c.observe(1.0)
        return fresh, base.service_s, c.service_s

    want, got = _both(run)
    assert got == want == ((0.7, 3.0, 0.0, False), 5.0, 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_tenant_admission_decisions_match_jax(seed):
    """A seeded stream of observations and admission queries over three
    tenants (one without a contract SLO) and degraded fractions: the same
    decision each time, and the same latches and EMAs."""
    tenants = [dict(name="a", default_slo_s=1.0), dict(name="b", default_slo_s=4.0),
               dict(name="c")]

    def run(side):
        rng = np.random.default_rng(seed)
        ta = _admission(side, tenants, margin=0.8, exit_frac=0.6, init_service_s=0.05)
        out = []
        for _ in range(200):
            t = ("a", "b", "c", "walkin")[int(rng.integers(0, 4))]
            if rng.random() < 0.4:
                ta.observe(t, float(rng.exponential(0.3)))
            slack = None if rng.random() < 0.3 else float(rng.uniform(-0.5, 5.0))
            out.append(ta.should_shed(t, int(rng.integers(0, 20)), slack,
                                      float(rng.choice([0.0, 0.0, 0.5, 1.0]))))
        return out, {n: (c.service_s, c.shedding) for n, c in ta._by_tenant.items()}

    want, got = _both(run)
    assert got == want and 0 < sum(got[0]) < len(got[0])


# ---------------------------------------------------------------------------
# two tenants through the server
# ---------------------------------------------------------------------------


def _two_tenant_requests(side, cfg):
    mod = SIDES[side][0]
    rng = np.random.default_rng(3)
    reqs = []
    for i, name in enumerate(("paid", "free")):
        reqs.extend(mod.poisson_requests(rng, 4, rate_rps=50.0, vocab_size=cfg.vocab_size,
                                         prompt_len_range=(4, 12), max_new_range=(2, 4),
                                         tenant=name, rid_base=100 * i))
    return reqs


def _serve(side, tiny, tenants, reqs, pre_admit, prime=None, **kw):
    mod = SIDES[side][0]
    cfg, p, hp = (tiny[0], tiny[2], tiny[3]) if side == "jax" else (tiny[1], tiny[4], tiny[5])
    config = mod.ServingConfig.from_kwargs(
        slots_per_layer=cfg.moe.num_experts, max_lanes=2, max_prefill_batch=2,
        buckets=(8, 16), cache_len=32, tenants=tuple(mod.TenantConfig(**t) for t in tenants),
        **kw)
    srv = mod.RequestServer(cfg, p, hp, config, **({} if side == "jax" else {"device": "cpu"}))
    batches = []
    pick = srv.scheduler.next_prefill_batch

    def spy(*a, **k):
        batch, bucket = pick(*a, **k)
        if batch:
            batches.append([r.rid for r in batch])
        return batch, bucket

    srv.scheduler.next_prefill_batch = spy
    if prime is not None:
        prime(srv)
    try:
        if pre_admit:
            for r in reqs:
                srv.build_request_table(r)
                srv.admit(r, 0.0)
            srv.run([], realtime=False)
        else:
            srv.run(reqs, realtime=False)
    finally:
        srv.close()
    return srv, batches


TWO = [dict(name="paid", weight=4.0, pin_quota=0.5), dict(name="free", weight=1.0)]


def test_two_tenant_server_end_to_end(tiny):
    """Two tenants through the whole server, arrivals from the hash thread:
    the WFQ scheduler engaged, every request of both tenants complete with
    the JAX server's tokens, per-tenant partitions and summaries filled,
    and every generated token debited to a tenant."""
    cfg_t = tiny[1]
    got, _ = _serve("port", tiny, TWO, _two_tenant_requests("port", cfg_t), False)
    want, _ = _serve("jax", tiny, TWO, _two_tenant_requests("jax", cfg_t), False)
    assert isinstance(got.scheduler, tserving.WFQScheduler)
    toks = lambda s: {r.rid: list(r.generated) for r in s.completed}
    assert toks(got) == toks(want) and len(toks(got)) == 8
    summary, ref_summary = got.tenant_summary(), want.tenant_summary()
    assert set(summary) == set(ref_summary) == {"paid", "free"}
    for name in ("paid", "free"):
        blk = summary[name]
        assert blk["arrived"] == blk["completed"] == 4 and blk["slo_attainment"] == 1.0
        for key in ("arrived", "completed", "rejected", "tokens_generated", "pinned_share"):
            assert blk[key] == ref_summary[name][key], (name, key)
    snap = got.telemetry.snapshot()
    assert set(snap["tenants"]) == {"paid", "free"}
    assert sum(summary[n]["tokens_generated"] for n in summary) == \
        snap["counters"]["tokens_generated"]


def test_two_tenant_server_wfq_order_matches_jax(tiny):
    """Pre-admitted (one deterministic schedule), one request a batch: the
    WFQ batch order, the tokens of every request and the per-tenant counts
    equal the JAX server's; paid (weight 4) is served ahead of free."""
    cfg_t = tiny[1]
    got, gb = _serve("port", tiny, TWO, _two_tenant_requests("port", cfg_t), True,
                     wfq_quantum=4.0)
    want, wb = _serve("jax", tiny, TWO, _two_tenant_requests("jax", cfg_t), True,
                      wfq_quantum=4.0)
    assert gb == wb and sum(map(len, gb)) == 8
    assert {r.rid: list(r.generated) for r in got.completed} == \
        {r.rid: list(r.generated) for r in want.completed}
    assert [r.rid for r in got.completed] == [r.rid for r in want.completed]
    order = [rid for b in gb for rid in b]
    assert order.index(100) > order.index(0)      # a weight-4 head goes first


def test_tenant_default_slo_stamped_at_admission(tiny):
    out = []
    for side in ("jax", "port"):
        r = _two_tenant_requests(side, tiny[1])[0]
        r.tenant = "slo"
        srv, _ = _serve(side, tiny, [dict(name="slo", default_slo_s=60.0)], [r], True)
        out.append((r.slo_s, [q.rid for q in srv.completed], list(r.generated)))
    assert out[1] == out[0] and out[1][0] == 60.0 and out[1][1] == [0]


def test_tenant_shedding_in_the_server_matches_jax(tiny):
    """A slow service history closes one tenant's gate and only its own
    (pre-admitted, so the queue the gate reads is deterministic): the same
    requests shed, the same tokens for the rest."""
    cfg_t = tiny[1]
    tenants = [dict(name="paid", default_slo_s=300.0), dict(name="free", default_slo_s=300.0)]
    out = []
    for side in ("jax", "port"):
        mod = SIDES[side][0]
        reqs = _two_tenant_requests(side, cfg_t)
        shed = mod.AdmissionController(margin=0.8)
        srv, _ = _serve(side, tiny, tenants, reqs, True, shed=shed,
                        prime=lambda srv: srv._shed_mt.observe("paid", 1000.0))
        out.append((sorted((r.rid, r.reject_reason) for r in srv.rejected),
                    {r.rid: list(r.generated) for r in srv.completed},
                    {n: (b["rejected_overloaded"], b["completed"])
                     for n, b in srv.tenant_summary().items()}))
    assert out[1] == out[0]
    rejected = out[1][0]
    assert rejected and all(rid < 100 and why == "overloaded" for rid, why in rejected)
    assert out[1][2]["free"] == (0.0, 4.0)
