"""The port's fault tolerance against the JAX package's, on the CPU: mirrors
of `tests/test_faults.py` (the `FaultPlan` grammar and schedules, retried
uploads, exhausted retries that roll back and poison, degradation to the
synchronous commit, supervised thread restarts, the dead shard's inline
commits and the watchdog's revival, stalled-job detection, host-read
faults, the ticket's timeout contract, shutdown hygiene, the admission
controller, and the request server under hash faults, upload chaos, fence
timeouts, overload and thread crashes), plus the close cases of
`tests/test_prefetch.py` and the port's own rule that a CUDA error is never
retried. Each scenario runs on the reference's pipeline and the port's over
the same weights (the reference's reduced switch-base-8, through
`params_from_numpy`) and the same `FaultPlan`; what the reference's test
asserts is compared exactly between the two, and tokens per request
exactly. The `slow_link` fixture patches each side's `_staged_put`."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

import repro.core.faults as jfaults
import repro.core.offload as joffload
import repro_torch.core.faults as tfaults
import repro_torch.core.offload as toffload
from conftest import reduced_params
from repro import serving as jserving
from repro.core.hash_table import HashTable as JHashTable
from repro_torch import serving as tserving
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core.hash_table import HashTable

torch.set_num_threads(2)
SIDES = ("jax", "port")
_PORT = {}


class Side:
    """One side's modules and store builder."""

    def __init__(self, side):
        self.side = side
        self.offload, self.faults, self.serving, self.Table = (
            (joffload, jfaults, jserving, JHashTable) if side == "jax"
            else (toffload, tfaults, tserving, HashTable))

    def store(self, slots, **kw):
        cfg, params = reduced_params("switch-base-8")
        if self.side == "jax":
            return self.offload.ExpertStore(cfg, params, slots_per_layer=slots, **kw)
        if "p" not in _PORT:
            _PORT["p"] = (get_config("switch-base-8").reduced(),
                          params_from_numpy(jax.tree.map(np.asarray, params)))
        cfg_t, pt = _PORT["p"]
        return self.offload.ExpertStore(cfg_t, pt, slots_per_layer=slots, device="cpu", **kw)

    def table(self, L, experts, idx=0):
        n = len(experts)
        ids = np.zeros((L, 1, n, 1), np.int32)
        for j, e in enumerate(experts):
            ids[:, 0, j, 0] = e
        return self.Table(idx, ids, np.ones((L, 1, n, 1), np.float32))

    def pipe(self, store, plan=None, seed=0, **kw):
        faults = self.faults.FaultPlan.parse(plan, seed=seed) if plan else None
        return self.offload.PrefetchPipeline(store, faults=faults, **kw)


def _both(fn):
    """`fn(Side)` on each side: (jax result, port result)."""
    return tuple(fn(Side(s)) for s in SIDES)


def _resident_matches_host(store) -> bool:
    for l in range(store.L):
        g, s = store.layer_to_gs(l)
        moe_p = store.serve_params["blocks"][f"sub{s}"]["moe"]
        for e, slot in store.resident[(g, s)].items():
            for t in ("w_in", "w_gate", "w_out"):
                if not np.array_equal(np.asarray(moe_p[t][g, slot]),
                                      np.asarray(store.host[f"sub{s}"][t][g, e])):
                    return False
    return True


def _slot_accounting(store) -> bool:
    """No slot leaked or double-booked: each is free or backs one mapping."""
    for (g, s), res in store.resident.items():
        used = sorted(res.values())
        free = list(store.free[(g, s)]) + list(store.free4[(g, s)] if store.S4 else [])
        free = {x for part in free for x in (part if isinstance(part, list) else [part])}
        if len(used) != len(set(used)) or free & set(used) or len(free) + len(used) != store.S:
            return False
    return True


def _wait_for(pred, timeout=20.0, msg="condition"):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            pytest.fail(f"timed out waiting for {msg}")
        time.sleep(0.002)


def _resident(store):
    return {k: dict(v) for k, v in store.resident.items()}


@pytest.fixture
def slow_link(monkeypatch):
    """A saturated H2D link on both sides: every staged put sleeps first."""

    def patch(delay):
        jreal, treal = joffload._staged_put, toffload._staged_put

        def jslow(x):
            time.sleep(delay)
            return jreal(x)

        def tslow(x, device):
            time.sleep(delay)
            return treal(x, device)

        monkeypatch.setattr(joffload, "_staged_put", jslow)
        monkeypatch.setattr(toffload, "_staged_put", tslow)

    return patch


# ---------------------------------------------------------------------------
# FaultPlan: grammar and schedules (the port's copy against the reference)
# ---------------------------------------------------------------------------


def test_fault_spec_parse_grammar():
    def run(side):
        F = side.faults
        out = [dataclasses.astuple(F.FaultSpec.parse(t)) for t in (
            "upload:fail@3", "upload:fail@3x2", "upload:stall=0.05,p=.1", " thread:crash@2 ")]
        plan = F.FaultPlan.parse("upload:fail@1;hash:fail,p=0.5", seed=3)
        return out, len(plan.specs), plan.seed

    want, got = _both(run)
    assert got == want
    assert got[0][0][:2] == ("upload", "fail") and got[1:] == (2, 3)


@pytest.mark.parametrize("bad", [
    "upload", "upload:explode@1", "upload:fail@0", "upload:fail@2x0", "upload:fail",
    "upload:stall@1", "upload:fail,p=1.5", "upload:fail,q=0.5",
])
def test_fault_spec_parse_rejects(bad):
    def run(side):
        with pytest.raises(ValueError) as e:
            side.faults.FaultSpec.parse(bad)
        return str(e.value)

    want, got = _both(run)
    assert got == want


def _pattern(plan_text, seed, n, sites=("upload",), F=None):
    plan = F.FaultPlan.parse(plan_text, seed=seed)
    out = []
    for _ in range(n):
        for site in sites:
            try:
                plan.inject(site)
                out.append((site, 0))
            except F.InjectedFault as e:
                out.append((site, e.n))
    return out, plan.summary()


def test_fault_plan_nth_window():
    want, got = _both(lambda s: _pattern("upload:fail@3x2", 0, 6, F=s.faults))
    assert got == want
    assert [n for _, n in got[0] if n] == [3, 4]
    assert got[1] == {"fault_ops_upload": 6.0, "fault_fired_upload": 2.0}


def test_fault_plan_probabilistic_is_seed_deterministic():
    want, got = _both(lambda s: [_pattern("upload:fail,p=0.3", seed, 64, F=s.faults)[0]
                                 for seed in (7, 7, 8)])
    assert got == want
    a, b, c = ([n > 0 for _, n in p] for p in got)
    assert a == b and 0 < sum(a) < 64 and c != a


def test_fault_plan_sites_are_independent():
    def run(side):
        lone = _pattern("upload:fail,p=0.3", 5, 32, F=side.faults)[0]
        mixed = _pattern("upload:fail,p=0.3;hash:fail,p=0.9", 5, 32, ("hash", "upload"),
                         F=side.faults)[0]
        return lone, [x for x in mixed if x[0] == "upload"]

    want, got = _both(run)
    assert got == want and got[0] == got[1]


def test_fault_plan_stall_sleeps_not_raises():
    def run(side):
        plan = side.faults.FaultPlan.parse("upload:stall=0.05@1")
        t0 = time.perf_counter()
        plan.inject("upload")
        slept = time.perf_counter() - t0 >= 0.04
        plan.inject("upload")
        return slept, plan.fired("upload")

    want, got = _both(run)
    assert got == want == (True, 1)


def test_unmatched_site_is_free():
    def run(side):
        plan = side.faults.FaultPlan.parse("upload:fail@1")
        plan.inject("host_read")
        return plan.ops("host_read"), plan.fired("host_read")

    want, got = _both(run)
    assert got == want == (1, 0)


# ---------------------------------------------------------------------------
# supervised uploads: retry, poisoning, degradation, death, revival
# ---------------------------------------------------------------------------


def test_transient_upload_fault_is_retried():
    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, "upload:fail@1", depth=2, max_retries=3, backoff_s=0.001)
        try:
            t = side.table(store.L, [0, 1])
            tk = pipe.submit(t)
            # the thread must own the job (wait() would steal it)
            _wait_for(lambda: pipe.stats.upload_retries >= 1, msg="a retry")
            ok = tk.wait(timeout=20)
            _, w = store.translate(t, tk.trans)
            res = (ok, tk.failed, bool((w > 0).all()), _resident_matches_host(store))
            tk.release()
        finally:
            pipe.close()
        st = pipe.stats
        return res, st.upload_retries >= 1, st.upload_failures, st.poisoned_fences, _resident(store)

    want, got = _both(run)
    assert got == want
    assert got[:4] == ((True, False, True, True), True, 0, 0)


def test_exhausted_retries_poison_rollback_and_replan():
    """A persistently failing batch is abandoned: slots roll back, fences
    fire poisoned, and the waiting ticket's replan reloads the experts
    inline: a fully resident, byte-correct translation."""
    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, "upload:fail@1x10", depth=2, max_retries=2, backoff_s=0.001,
                         degrade_after=99)
        try:
            t = side.table(store.L, [0, 1])
            tk = pipe.submit(t)
            _wait_for(lambda: pipe.stats.upload_failures >= 1, msg="abandonment")
            ok = tk.wait(timeout=20)
            _, w = store.translate(t, tk.trans)
            res = (ok, tk.failed, bool((w > 0).all()), _resident_matches_host(store),
                   _slot_accounting(store))
            tk.release()
        finally:
            pipe.close()
        st = pipe.stats
        return (res, st.upload_retries, st.upload_failures, st.poisoned_fences,
                _slot_accounting(store), _resident(store))

    want, got = _both(run)
    assert got == want
    assert got[0] == (True, True, True, True, True) and got[3] >= 1 and got[4]


def test_consecutive_failures_degrade_shard_to_sync():
    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, "upload:fail,p=1.0", depth=4, max_retries=0, backoff_s=0.0,
                         degrade_after=1)
        try:
            tk0 = pipe.submit(side.table(store.L, [0]))
            _wait_for(lambda: pipe.degraded_fraction() == 1.0, msg="degradation")
            ok0 = tk0.wait(timeout=20)
            tk0.release()
            tk = pipe.submit(side.table(store.L, [2, 3]))
            _wait_for(lambda: pipe.stats.sync_fallbacks > 0, msg="sync fallback")
            res = (ok0, tk.wait(timeout=20), tk.failed, _resident_matches_host(store))
            tk.release()
            return res, pipe.stats.sync_fallbacks > 0, pipe.stats.degraded, _resident(store)
        finally:
            pipe.close()

    want, got = _both(run)
    assert got == want and got[:3] == ((True, True, False, True), True, 1)


def test_thread_crash_is_supervised_and_restarted():
    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, "thread:crash@1", depth=2, max_thread_restarts=3)
        try:
            t = side.table(store.L, [0, 1])
            tk = pipe.submit(t)
            # the crashed job's fences are poisoned after the crash is counted
            _wait_for(lambda: pipe.stats.poisoned_fences >= 1, msg="the crash")
            ok = tk.wait(timeout=20)
            _, w = store.translate(t, tk.trans)
            tk.release()
            _wait_for(lambda: pipe._threads[0].is_alive(), msg="restart")
            tk2 = pipe.submit(side.table(store.L, [2, 3], idx=1))
            ok2 = tk2.wait(timeout=20)
            tk2.release()
            return (ok, bool((w > 0).all()), pipe.stats.thread_restarts >= 1, pipe._dead[0],
                    ok2, _resident_matches_host(store), _resident(store))
        finally:
            pipe.close()

    want, got = _both(run)
    assert got == want and got[:6] == (True, True, True, False, True, True)


def test_dead_thread_inline_commit_and_watchdog_revival():
    """Crashes past max_thread_restarts make the shard dead: producers
    commit inline, and the watchdog's revive brings the async path back."""
    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, "thread:crash@1", depth=1, max_thread_restarts=0)
        try:
            tk0 = pipe.submit(side.table(store.L, [0]))
            _wait_for(lambda: pipe._dead[0], msg="shard death")
            ok0 = tk0.wait(timeout=20)
            tk0.release()
            tk = pipe.submit(side.table(store.L, [2, 3], idx=1))
            ok1 = tk.wait(timeout=20)
            tk.release()
            inline = (_resident_matches_host(store), pipe.stats.sync_fallbacks > 0)
            revived, _ = pipe.watchdog()
            after = (revived, pipe._dead[0], pipe.degraded_fraction())
            _wait_for(lambda: pipe._threads[0].is_alive(), msg="revived thread")
            ups = pipe.stats.uploads
            tk2 = pipe.submit(side.table(store.L, [0, 1], idx=2))
            _wait_for(lambda: pipe.stats.uploads > ups, msg="async upload")
            ok2 = tk2.wait(timeout=20)
            tk2.release()
            return (ok0, ok1, inline, after, ok2, _resident_matches_host(store),
                    pipe.stats.thread_restarts, _resident(store))
        finally:
            pipe.close()

    want, got = _both(run)
    assert got == want
    assert got[:6] == (True, True, (True, True), (1, False, 0.0), True, True)


def test_watchdog_flags_stalled_job():
    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, "upload:stall=0.4@1", depth=2)
        try:
            tk = pipe.submit(side.table(store.L, [0, 1]))
            _wait_for(lambda: pipe._current_job[0] is not None, msg="job pickup")
            time.sleep(0.1)
            stalled, t0 = 0, time.perf_counter()
            while stalled == 0 and time.perf_counter() - t0 < 2.0:
                _, stalled = pipe.watchdog(max_job_age_s=0.05)
                time.sleep(0.01)
            ok = tk.wait(timeout=20)
            tk.release()
            return stalled >= 1, ok
        finally:
            pipe.close()

    want, got = _both(run)
    assert got == want == (True, True)


def test_host_read_fault_is_supervised_too():
    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, "host_read:fail@1", depth=2, max_retries=3, backoff_s=0.001)
        try:
            tk = pipe.submit(side.table(store.L, [0, 1]))
            _wait_for(lambda: pipe.stats.upload_retries >= 1, msg="a retry")
            ok = tk.wait(timeout=20)
            tk.release()
        finally:
            pipe.close()
        return ok, _resident_matches_host(store), pipe.stats.upload_failures, _resident(store)

    want, got = _both(run)
    assert got == want and got[:3] == (True, True, 0)


@pytest.mark.parametrize("kw", [dict(quantized_slots=True), dict(host_quant="int8"),
                                dict(quantized_slots=True, tier=TierConfig(
                                    int4_slots=True, tier_split=0.5, group_size=64))],
                         ids=["int8-slots", "int8-host", "tiered"])
def test_retried_and_poisoned_uploads_land_every_format(kw):
    """Seeded upload and host-read faults over int8-resident slots, int8
    host masters and hot int8 / warm int4 tiers (rollback of warm slots and
    tier moves): every ticket of a seeded stream ends fully resident, with
    each slot holding its master's bytes, and no slot is leaked. Port only:
    the reference's `_refresh` stops after a fence it waited on came back
    poisoned without planning the rolled-back expert again (ROADMAP §C),
    so its tickets can end short of experts here, depending on whether
    the failure lands before or after the consumer's residency check."""
    from test_torch_prefetch import _assert_resident_matches_host

    side = Side("port")
    store = side.store(3, **kw)
    pipe = side.pipe(store, "upload:fail,p=0.4;host_read:fail,p=0.2", seed=3, depth=2,
                     max_retries=1, backoff_s=0.0, degrade_after=99)
    rng = np.random.default_rng(11)
    try:
        for i in range(10):
            t = side.table(store.L, [int(e) for e in rng.integers(0, store.E, 3)], idx=i)
            tk = pipe.submit(t)
            tk._job = None                     # leave the job to the thread
            assert tk.wait(timeout=20)
            _, w = store.translate(t, tk.trans)
            assert (w > 0).all(), i
            _assert_resident_matches_host(store)
            tk.release()
    finally:
        pipe.close()
    st = pipe.stats
    assert st.upload_retries >= 1 and st.upload_failures >= 1 and st.poisoned_fences >= 1
    assert _slot_accounting(store) and pipe._error is None
    if "tier" in kw:
        assert store.S4 > 0 and store.stats.demotions + store.stats.promotions > 0


def test_plain_transfer_error_is_retried_and_replanned(monkeypatch):
    """A non-CUDA error on the transfer thread (here every staged copy
    raising) is treated like an injected fault: retried, abandoned,
    poisoned, and the waiter replans inline; consumers do not raise."""
    cfg_side = Side("port")
    store = cfg_side.store(2)

    def broken(x, device):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(toffload, "_staged_put", broken)
    pipe = cfg_side.pipe(store, depth=1, max_retries=1, backoff_s=0.0, degrade_after=99)
    try:
        t = cfg_side.table(store.L, [0, 1])
        tk = pipe.submit(t)
        tk._job = None
        assert tk.wait(timeout=20) and tk.failed
        _, w = store.translate(t, tk.trans)
        assert (w > 0).all() and _resident_matches_host(store)
        tk.release()
        tk2 = pipe.submit(cfg_side.table(store.L, [2], idx=1))   # the pipeline still serves
        assert tk2.wait(timeout=20)
        tk2.release()
    finally:
        pipe.close()
    assert pipe.stats.upload_retries >= 1 and pipe.stats.upload_failures >= 1
    assert pipe._error is None and _slot_accounting(store)


# ---------------------------------------------------------------------------
# the ticket's wait(timeout) contract and shutdown
# ---------------------------------------------------------------------------


def test_ticket_wait_timeout_contract(slow_link):
    """wait(timeout) -> False; the caller falls back to store.prepare and
    gets a correct translation; a later wait() still converges."""
    slow_link(0.3)

    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, depth=2)
        try:
            t = side.table(store.L, [0, 1])
            tk = pipe.submit(t)
            _wait_for(lambda: pipe._current_job[0] is not None, msg="job pickup")
            timed_out = tk.wait(timeout=0.01) is False
            trans = store.prepare(t)
            _, w = store.translate(t, trans)
            res = (timed_out, bool((w > 0).all()), _resident_matches_host(store),
                   tk.wait(timeout=20))
            tk.release()
            return res, _resident(store)
        finally:
            pipe.close()

    want, got = _both(run)
    assert got == want and got[0] == (True, True, True, True)


def test_close_is_idempotent_with_inflight_uploads(slow_link):
    slow_link(0.1)

    def run(side):
        store = side.store(4)
        pipe = side.pipe(store, depth=4, staging_buffers=2)
        tickets = [pipe.submit(side.table(store.L, [2 * i % 4, (2 * i + 1) % 4], idx=i))
                   for i in range(3)]
        pipe.close()
        pipe.close()
        return (not any(t.is_alive() for t in pipe._threads),
                all(ev.is_set() for tk in tickets for _, ev in tk._fences),
                all(not pend for pend in pipe._pending.values()),
                not any(pipe._staging), _slot_accounting(store), _resident(store))

    want, got = _both(run)
    assert got == want and got[:5] == (True,) * 5


def test_close_after_thread_death_drains_and_fires_fences():
    def run(side):
        store = side.store(2)
        pipe = side.pipe(store, "thread:crash@1", depth=4, max_thread_restarts=0)
        tk0 = pipe.submit(side.table(store.L, [0]))
        _wait_for(lambda: pipe._dead[0], msg="shard death")
        tk1 = pipe.submit(side.table(store.L, [2, 3], idx=1))
        pipe.close()
        return (all(ev.is_set() for tk in (tk0, tk1) for _, ev in tk._fences),
                all(not pend for pend in pipe._pending.values()), _slot_accounting(store),
                _resident(store))

    want, got = _both(run)
    assert got == want and got[:3] == (True, True, True)


def test_cuda_error_is_kept_and_reraised(monkeypatch):
    """The port's rule, which the reference has no CUDA to need: a CUDA error
    on the transfer thread is never retried or poisoned away; the thread
    stops, every fence fires, and every later submit and wait re-raises it
    (a sticky context error must fail the run)."""
    side = Side("port")
    store = side.store(2)
    calls = []

    def broken(x, device):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(toffload, "_staged_put", broken)
    pipe = side.pipe(store, depth=2, max_retries=3, backoff_s=0.0)
    try:
        tk = pipe.submit(side.table(store.L, [0, 1]))
        tk._job = None
        with pytest.raises(RuntimeError, match="CUDA error") as e:
            tk.wait(timeout=20)
        assert "illegal memory access" in str(e.value.__cause__)
        with pytest.raises(RuntimeError, match="CUDA error"):
            pipe.submit(side.table(store.L, [2]))
        with pytest.raises(RuntimeError, match="CUDA error"):
            pipe.submit_job(lambda: None)
        assert len(calls) == 1 and pipe.stats.upload_retries == 0
        assert not pipe._threads[0].is_alive()
    finally:
        pipe.close()


# ---------------------------------------------------------------------------
# admission controller units
# ---------------------------------------------------------------------------


def test_admission_controller_threshold_and_hysteresis():
    def run(side):
        a = side.serving.AdmissionController(margin=0.8, exit_frac=0.6, init_service_s=0.1)
        return [a.should_shed(d, 1.0) for d in (2, 10, 5, 4)], a.shedding

    want, got = _both(run)
    assert got == want == ([False, True, True, False], False)


def test_admission_controller_no_slo_and_default():
    def run(side):
        A = side.serving.AdmissionController
        return (A(init_service_s=0.1).should_shed(10 ** 6, None),
                A(init_service_s=0.1, default_slo_s=1.0).should_shed(10 ** 6, None),
                A().should_shed(10 ** 6, 0.001))

    want, got = _both(run)
    assert got == want == (False, True, False)


def test_admission_controller_degradation_shrinks_threshold():
    def run(side):
        a = side.serving.AdmissionController(margin=0.8, init_service_s=0.1)
        first = a.should_shed(6, 1.0, degraded_frac=0.0)
        a.shedding = False
        return first, a.should_shed(6, 1.0, degraded_frac=1.0)

    want, got = _both(run)
    assert got == want == (False, True)


def test_admission_controller_ema():
    def run(side):
        a = side.serving.AdmissionController(ema_decay=0.5)
        a.observe(1.0)
        first = a.service_s
        a.observe(0.0)
        return first, a.service_s

    want, got = _both(run)
    assert got == want == (1.0, 0.5)


# ---------------------------------------------------------------------------
# the request server: hash faults, chaos, fence timeouts, shedding, crashes
# ---------------------------------------------------------------------------


def _tiny_cfg(get):
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(cfg, n_layers=2,
                               moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


@pytest.fixture(scope="module")
def tiny_moe():
    from repro.configs.base import get_config as jget_config
    from repro.core.hash_fn import init_hash_fn
    from repro.models.transformer import init_params, n_moe_layers

    cfg_j = _tiny_cfg(jget_config)
    pj = init_params(jax.random.PRNGKey(0), cfg_j)
    hj = init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, n_moe_layers(cfg_j),
                      cfg_j.moe.num_experts, d_h=16)
    return {"jax": (cfg_j, pj, hj),
            "port": (_tiny_cfg(get_config), params_from_numpy(jax.tree.map(np.asarray, pj)),
                     params_from_numpy(jax.tree.map(np.asarray, hj)))}


def _requests(side, cfg, n, seed=0, max_new=3, slo=None):
    rng = np.random.default_rng(seed)
    Request = side.serving.Request
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (int(p),)).astype(np.int32),
                    max_new_tokens=max_new, arrival_s=0.0, slo_s=slo)
            for i, p in enumerate(rng.integers(4, 9, size=n))]


def _serve(side, tiny_moe, n, seed, lanes=2, slots=None, plan=None, plan_seed=0, **kw):
    cfg, p, hp = tiny_moe[side.side]
    if plan is not None:
        kw["faults"] = side.faults.FaultPlan.parse(plan, seed=plan_seed)
    srv = side.serving.RequestServer(
        cfg, p, hp, slots_per_layer=slots or cfg.moe.num_experts, max_lanes=lanes,
        max_prefill_batch=lanes, buckets=(8, 16), cache_len=32,
        **kw, **({} if side.side == "jax" else {"device": "cpu"}))
    try:
        srv.run(_requests(side, cfg, n, seed=seed, slo=kw.get("shed") and 300.0), realtime=False)
    finally:
        srv.close()
    return srv


def _tokens(srv):
    return {r.rid: list(r.generated) for r in srv.completed}


def test_server_hash_fault_rejects_request_and_continues(tiny_moe):
    def run(side):
        srv = _serve(side, tiny_moe, 4, 0, plan="hash:fail@2")
        return (len(srv.completed), [(r.rid, r.reject_reason) for r in srv.rejected],
                srv.telemetry.counter("hash_thread_errors").value,
                srv.summary()["rejected_hash_error"], _tokens(srv))

    want, got = _both(run)
    assert got == want and got[:4] == (3, [(1, "hash_error")], 1, 1.0)


def test_server_hash_thread_escape_reraises_not_spins(tiny_moe):
    """An exception escaping the per-request guard ends run() with that
    exception on the caller's thread."""
    side = Side("port")
    cfg, p, hp = tiny_moe["port"]
    srv = side.serving.RequestServer(cfg, p, hp, slots_per_layer=cfg.moe.num_experts,
                                     max_lanes=1, max_prefill_batch=1, buckets=(8, 16),
                                     cache_len=32, device="cpu")

    def boom(req, now):
        raise RuntimeError("admission blew up")

    srv.admit = boom
    try:
        with pytest.raises(RuntimeError, match="admission blew up"):
            srv.run(_requests(side, cfg, 2, seed=1), realtime=False)
    finally:
        srv.close()


@pytest.fixture(scope="module")
def churn_ref(tiny_moe):
    """The JAX server's tokens on the churning stream (2 slots of 8, async),
    fault-free: the reference every faulted port run must reproduce."""
    return _tokens(_serve(Side("jax"), tiny_moe, 6, 2, slots=2, prefetch_depth=2))


def test_server_chaos_upload_faults_byte_identical(tiny_moe, churn_ref):
    """Seeded p=0.2 upload faults under retry, poison and degrade: every
    request completes with the fault-free tokens, which are the JAX
    server's."""
    side = Side("port")
    clean = _serve(side, tiny_moe, 6, 2, slots=2, prefetch_depth=2)
    srv = _serve(side, tiny_moe, 6, 2, slots=2, prefetch_depth=2, plan="upload:fail,p=0.2",
                 plan_seed=11, fence_timeout_s=10.0)
    assert _tokens(clean) == _tokens(srv) == churn_ref and len(churn_ref) == 6
    assert srv.faults.fired("upload") >= 1
    s = srv.summary()
    assert s["upload_retries"] + s["upload_failures"] >= 1
    fence = srv.telemetry.histogram("prefetch_fence_s")
    assert not fence.samples or max(fence.samples) < 10.0
    c = clean.summary()
    assert c["upload_retries"] == c["upload_failures"] == c["thread_crashes"] == 0
    assert c["sync_fallbacks"] == 0 and srv.telemetry.counter("fault_ops_upload").value > 0


def test_server_fence_timeout_falls_back_to_sync(tiny_moe, churn_ref, slow_link, monkeypatch):
    """A timed-out ticket never forwards its stale translation: the tick
    prepares synchronously and the tokens stay the reference's. Stealing is
    off, so every upload runs on the slowed transfer thread and a fence
    times out however the host schedules the threads."""
    slow_link(0.05)
    monkeypatch.setattr(toffload.PrefetchPipeline, "_steal", lambda self, ticket: None)
    srv = _serve(Side("port"), tiny_moe, 6, 2, slots=2, prefetch_depth=2, fence_timeout_s=0.005)
    assert _tokens(srv) == churn_ref, (_tokens(srv), churn_ref)
    assert srv.telemetry.counter("prefetch_fence_timeouts").value >= 1, srv.prefetch.stats


def test_server_overload_sheds_before_deadline_misses(tiny_moe):
    """A pessimistic service-time prior sheds at admission, and no admitted
    request misses its deadline."""
    def run(side):
        shed = side.serving.AdmissionController(margin=0.8, init_service_s=1000.0)
        srv = _serve(side, tiny_moe, 8, 4, lanes=1, shed=shed)
        s = srv.summary()
        return (s["rejected_overloaded"] >= 1, s["deadline_miss"],
                len(srv.completed) + len(srv.rejected),
                {r.reject_reason for r in srv.rejected})

    want, got = _both(run)
    assert got == want == (True, 0.0, 8, {"overloaded"})


@pytest.mark.parametrize("plan,restarts", [("thread:crash@1x2", 3), ("thread:crash@1x3", 0)],
                         ids=["restarted", "dead-and-revived"])
def test_server_survives_transfer_thread_crashes(tiny_moe, plan, restarts, monkeypatch):
    """Transfer threads that crash mid-stream restart in place (or, past
    their restarts, die, commit inline and are revived by the serve loop's
    watchdog); the crashed jobs' fences poison and replan, and the stream
    completes with the fault-free tokens (the JAX server's)."""
    side = Side("port")
    ref = _tokens(_serve(Side("jax"), tiny_moe, 4, 5, prefetch_depth=2))
    init = toffload.PrefetchPipeline.__init__
    monkeypatch.setattr(toffload.PrefetchPipeline, "__init__",
                        lambda self, *a, **k: init(self, *a, **k, max_thread_restarts=restarts))
    srv = _serve(side, tiny_moe, 4, 5, prefetch_depth=2, plan=plan, watchdog_interval_s=0.01)
    assert _tokens(srv) == ref and len(ref) == 4
    s = srv.summary()
    assert srv.telemetry.counter("prefetch_thread_crashes").value >= 1
    if restarts == 0:
        assert s["watchdog_revives"] >= 1 and s["thread_restarts"] >= 1


def test_page_ins_lost_to_crashes_are_written_by_sync(monkeypatch):
    """K/V page-ins ride the pipeline as callable jobs. Under a plan that
    crashes the transfer loop on every job, each page-in job is dropped
    (its done fence fires without its copy) and each expert upload is
    poisoned: `KVPagePool.sync` writes the dropped pages from their host
    copies and the decode replans the experts, so a windowed model whose
    tight pool spills and pages back in decodes the tokens of the run
    without a pipeline. (The reference's `sync` writes only the pages
    that arrived, `src/repro/core/residency.py:325-345`.)"""
    from test_torch_paged import _generate, _system
    from repro_torch.core import residency as tr

    wtiny = _system(window=8)
    tight = tr.PagedKVConfig(page_size=4, kv_pages=6, max_seq=64)
    ref, _, _ = _generate(wtiny, "torch", tight, steps=24)
    init = toffload.PrefetchPipeline.__init__
    plan = tfaults.FaultPlan.parse("thread:crash@1x100000")
    monkeypatch.setattr(toffload.PrefetchPipeline, "__init__", lambda self, *a, **k: init(
        self, *a, **{**k, "faults": plan, "max_thread_restarts": 10 ** 6}))
    out, _, eng = _generate(wtiny, "torch", tight, steps=24, prefetch_depth=2)
    np.testing.assert_array_equal(out, ref)
    pool, st = eng.kv_pool, eng.prefetcher.stats
    assert pool.stats.page_ins > 0 and pool.stats.spills > 0
    assert st.thread_crashes == plan.fired("thread") > 0 and st.job_errors == 0
    assert not pool._inflight and not pool._arrived


def test_stress_producers_under_faults_crashes_and_revivals():
    """Eight producer threads submit while one consumer clears, checks and
    releases the tickets, under a 10 µs switch interval and a plan that
    fails uploads and host reads and crashes the transfer loop (two
    in-place restarts, then the shard dies and the consumer's watchdog
    revives it): every consumed ticket finds each needed expert resident
    and holding its master's bytes, no slot leaks, and no reference or
    pending upload outlives the pipeline."""
    import queue
    import sys
    import threading

    from test_torch_prefetch import _slot_rows

    side = Side("port")
    store = side.store(4)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    pipe = side.pipe(store, "upload:fail,p=0.5;host_read:fail,p=0.2;thread:crash@2x3",
                     seed=4, depth=8, max_retries=1, backoff_s=0.0, max_thread_restarts=2)
    handoff: "queue.Queue" = queue.Queue()

    def producer(k):
        rng = np.random.default_rng(k)
        for it in range(16):
            t = side.table(store.L, [int(e) for e in rng.integers(0, store.E, size=2)], it)
            handoff.put((t, pipe.submit(t)))

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(4)]
    try:
        for th in threads:
            th.start()
        for _ in range(64):
            t, tk = handoff.get(timeout=60)
            pipe.watchdog()
            time.sleep(0.002)              # let the thread take the job, not the steal
            assert tk.wait(timeout=60)
            _, w = store.translate(t, tk.trans)
            assert (w > 0).all()
            for l, ids in tk.needed.items():
                g, s = store.layer_to_gs(l)
                for e in ids:
                    slot = store.resident[(g, s)][int(e)]
                    for dev, host in _slot_rows(store, s, g, slot, int(e)):
                        assert torch.equal(dev, host)
            tk.release()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        pipe.close()
        sys.setswitchinterval(before)
    st = pipe.stats
    assert st.submitted == 64 and st.upload_retries > 0 and st.thread_crashes == 3, st
    assert not any(pipe._refs[k] for k in pipe._refs) and not any(pipe._pending.values())
    assert _slot_accounting(store) and pipe._error is None
