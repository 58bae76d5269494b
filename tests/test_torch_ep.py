"""The port's expert-parallel store, pipeline and MoE dispatch against the
JAX package's, on the CPU.

Mirrors of `tests/test_ep_serving.py`'s bookkeeping cases (home
placements, plans kept within the home partition, no cross-shard eviction,
per-shard pins, renormalised misses, the per-shard prefetch fan-out,
per-destination warm back-pressure, bad geometry, hot-expert replicas,
their reclaim and promotion, `rebalance_homes`), each run on the JAX
`ExpertStore` / `PrefetchPipeline` (sharded, no mesh) and on the port's
over the same weights (`params_from_numpy`) and the same tables: the
resident sets, replicas, homes, free lists, translations, local
translations, α EMAs, `shard_load_score`, the stats (loads, hits,
evictions, drops, bytes, `replica_loads`, `rebalance_moves`, tier moves)
and `uploads_by_shard` are compared exactly, and the reference test's own
assertions are checked on the port. Then `moe_layer` under the port's
expert-parallel context: at top-1 bit for bit the port's one-device
dispatch over the same global slot ids (fp32, int8 slots, hot int8 / warm
int4 tiers), and within 1e-5 of JAX's `moe_layer`; at top-6 with two
shared experts (the narrow deepseek config of `test_torch_models.py`)
within 1e-5 of both, the shared experts added once."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.offload as joffload
import repro_torch.core.offload as toffload
import repro_torch.models.moe as tmoe
from conftest import reduced_params
from repro.configs.base import TierConfig as JTierConfig
from repro.configs.base import get_config as jget_config
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.hash_table import HashTable as JHashTable
from repro.models.attention import ShardingCtx as JShardingCtx
from repro.models.moe import moe_layer as j_moe_layer
from repro.models.transformer import init_params as j_init_params
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core.faults import FaultPlan
from repro_torch.core.hash_table import HashTable
from repro_torch.launch.mesh import make_ep_mesh
from repro_torch.models.attention import ShardingCtx
from repro_torch.sharding.policy import serve_ctx, store_ctx
from test_torch_models import narrow_config

torch.set_num_threads(2)
SIDES = ("jax", "port")
STATS = ("bytes_h2d", "loads", "hits", "evictions", "dropped", "replica_loads",
         "rebalance_moves", "promotions", "demotions")
_WEIGHTS = {}


def _e8_cfg(get):
    """`tests/test_ep_serving.py::_e8_system`: reduced Switch, 8 experts, top-1."""
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8, d_expert=64, capacity_factor=4.0))


def _weights(model: str):
    """(cfg_j, cfg_t, JAX params, port params): "r4" the reduced switch
    (4 experts, the reference's `reduced_params`), "e8" `_e8_cfg`,
    "deepseek" the narrow deepseek config (16 experts, top-6, 2 shared)."""
    if model not in _WEIGHTS:
        if model == "r4":
            cfg_j, pj = reduced_params("switch-base-8")
            cfg_t = get_config("switch-base-8").reduced()
        else:
            if model == "e8":
                cfg_j, cfg_t = _e8_cfg(jget_config), _e8_cfg(get_config)
            else:
                cfg_j = narrow_config(jget_config, "deepseek-narrow")
                cfg_t = narrow_config(get_config, "deepseek-narrow")
            pj = j_init_params(jax.random.PRNGKey(0), cfg_j)
        pj = jax.tree.map(np.asarray, pj)
        _WEIGHTS[model] = (cfg_j, cfg_t, pj, params_from_numpy(pj))
    return _WEIGHTS[model]


class Side:
    """One side's store, pipeline and table builders."""

    def __init__(self, side):
        self.jax = side == "jax"
        self.off = joffload if self.jax else toffload
        self.Table = JHashTable if self.jax else HashTable

    def sharded(self, **kw):
        return self.off.ShardedStoreConfig(**kw)

    def store(self, slots, model="r4", sharded=None, tier=None, **kw):
        cfg_j, cfg_t, pj, pt = _weights(model)
        if sharded is not None:
            kw["sharded"] = self.sharded(**sharded)
        if tier is not None:
            kw["tier"] = (JTierConfig if self.jax else TierConfig)(**tier)
        if self.jax:
            return self.off.ExpertStore(cfg_j, pj, slots_per_layer=slots, **kw)
        return self.off.ExpertStore(cfg_t, pt, slots_per_layer=slots, device="cpu", **kw)

    def pipe(self, store, plan=None, **kw):
        if plan is not None:
            kw["faults"] = (JFaultPlan if self.jax else FaultPlan).parse(plan, seed=0)
        return self.off.PrefetchPipeline(store, **kw)

    def table(self, ids, w=None, idx=0):
        ids = np.asarray(ids, np.int32)
        w = np.ones(ids.shape, np.float32) if w is None else np.asarray(w, np.float32)
        return self.Table(idx, ids.copy(), w.copy())


def _both(fn):
    """`fn(Side)` on each side: (jax result, port result)."""
    return tuple(fn(Side(s)) for s in SIDES)


def _random_table(L, E, B=1, S=4, k=1, seed=0):
    """`tests/test_ep_serving.py::_table`."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, E, (L, B, S, k)).astype(np.int32), rng.random((L, B, S, k)).astype(np.float32)


def _mass_ids(L, spec):
    """`_mass_table`: `count` tokens routed to `expert` at every layer."""
    ids = np.concatenate([np.full((c,), e, np.int32) for e, c in spec])
    return np.tile(ids.reshape(1, 1, -1, 1), (L, 1, 1, 1))


def _expert_ids(L, experts):
    """`_expert_table`: one token per listed expert at every layer."""
    return np.tile(np.asarray(experts, np.int32).reshape(1, 1, -1, 1), (L, 1, 1, 1))


def _state(st):
    """Everything the bookkeeping decides, as plain Python values."""
    return {
        "resident": {k: dict(v) for k, v in st.resident.items()},
        "replicas": {k: {e: dict(d) for e, d in v.items()} for k, v in st.replicas.items()},
        "home": [int(h) for h in st.home],
        "free": {k: [list(f) for f in v] for k, v in st.free.items()},
        "free4": {k: [list(f) for f in v] for k, v in st.free4.items()},
        "pinned": {k: set(v) for k, v in st.pinned.items()},
        "stats": {f: getattr(st.stats, f) for f in STATS},
        "ema": {k: v.tolist() for k, v in st.alpha_ema.items()},
        "shard_alpha": st._shard_alpha.tolist(),
        "geometry": (st.shards, st.S, st.S_loc, st.S8, st.S4, st.S8_loc, st.S4_loc, st.R),
    }


def _slots_hold_masters(st) -> bool:
    """Every primary and replica slot holds its expert's host master rows."""
    for (g, s), res in st.resident.items():
        pool = st.serve_params["blocks"][f"sub{s}"]["moe"]
        for e, slot in res.items():
            for sl in [slot, *st.replicas[(g, s)].get(e, {}).values()]:
                if sl >= st.S8:
                    continue
                for t in ("w_in", "w_gate", "w_out"):
                    if not np.array_equal(np.asarray(pool[t][g, sl]),
                                          np.asarray(st.host[f"sub{s}"][t][g, e])):
                        return False
    return True


def _wait_for(pred, timeout=20.0, msg="condition"):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            pytest.fail(f"timed out waiting for {msg}")
        time.sleep(0.002)


# ---------------------------------------------------------------------------
# placements, geometry and the plan within the home partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("placement", ["mod", "block"])
def test_home_shard_placements(placement):
    for E in (4, 8, 64):
        for shards in (1, 2, 4):
            got = toffload.ShardedStoreConfig(ep_shards=shards, placement=placement)
            want = joffload.ShardedStoreConfig(ep_shards=shards, placement=placement)
            np.testing.assert_array_equal(got.home_shards(E), want.home_shards(E))
            assert got.enabled == want.enabled == (shards > 1)
    mod = toffload.ShardedStoreConfig(ep_shards=4)
    np.testing.assert_array_equal(mod.home_shards(8), [0, 1, 2, 3, 0, 1, 2, 3])
    blk = toffload.ShardedStoreConfig(ep_shards=4, placement="block")
    np.testing.assert_array_equal(blk.home_shards(8), [0, 0, 1, 1, 2, 2, 3, 3])


@pytest.mark.parametrize("placement", ["mod", "block"])
def test_sharded_store_plans_within_home_partition(placement):
    def run(side):
        st = side.store(4, sharded=dict(ep_shards=2, placement=placement))
        out = []
        for seed in range(6):
            ids, w = _random_table(st.L, st.E, S=8, seed=3 + seed)
            t = side.table(ids, w, seed)
            trans = st.prepare(t)
            out.append((trans.tolist(), st.local_trans(trans).tolist(),
                        [a.tolist() for a in st.translate(t, trans)]))
        return out, _state(st), st
    (want, sj_state, _), (got, st_state, st) = _both(run)
    assert got == want and st_state == sj_state
    assert st.shards == 2 and st.S_loc == 2
    for (g, s), res in st.resident.items():
        for e, slot in res.items():
            assert slot in st.shard_slots(st.shard_of(e)), (e, slot)
            assert st.slot_shard(slot) == st.shard_of(e)
    assert _slots_hold_masters(st)


def test_sharded_eviction_never_crosses_shards():
    def run(side):
        st = side.store(2, sharded=dict(ep_shards=2))   # mod: shard0 = {0, 2}, shard1 = {1, 3}
        st.prepare_layer(0, np.array([0, 1]))
        g, s = st.layer_to_gs(0)
        slot1 = st.resident[(g, s)][1]
        st.prepare_layer(0, np.array([2]))            # shard 0 overflows: evicts e0
        return slot1, _state(st)
    (want_slot, want), (got_slot, got) = _both(run)
    assert got == want and got_slot == want_slot
    res = got["resident"][(0, 1)]
    assert 2 in res and 0 not in res and res[1] == got_slot
    assert got["stats"]["evictions"] == 1


def test_sharded_pinning_protects_per_shard():
    def run(side):
        st = side.store(2, sharded=dict(ep_shards=2))
        for l in range(st.L):
            st.pin_experts(l, [0])
        st.prepare_layer(0, np.array([0]))
        st.prepare_layer(0, np.array([2, 1]))        # e2: shard 0 full + pinned; e1: shard 1
        return _state(st)
    want, got = _both(run)
    assert got == want
    res = got["resident"][(0, 1)]
    assert 0 in res and 1 in res and 2 not in res
    assert got["stats"]["dropped"] == 1


def test_sharded_translate_renormalizes_dropped_experts():
    def run(side):
        st = side.store(2, sharded=dict(ep_shards=2))
        ids = np.zeros((st.L, 1, 2, 2), np.int32)
        ids[..., 0, :] = [0, 2]                       # both on shard 0: one drops
        ids[..., 1, :] = [0, 2]
        t = side.table(ids, np.full(ids.shape, 0.5, np.float32))
        slots, w = st.translate(t, st.prepare(t))
        return slots.tolist(), w.tolist(), _state(st)
    want, got = _both(run)
    assert got == want
    w = np.asarray(got[1])
    assert got[2]["stats"]["dropped"] > 0
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-6)
    assert (w == 0).any()


def test_sharded_store_rejects_bad_geometry():
    for kw in (dict(slots=4, sharded=dict(ep_shards=3)),      # 4 experts % 3 shards
               dict(slots=1, sharded=dict(ep_shards=2))):     # < 1 slot a shard
        slots = kw.pop("slots")
        with pytest.raises(AssertionError):
            Side("jax").store(slots, **kw)
        with pytest.raises(ValueError):
            Side("port").store(slots, **kw)
    tier = dict(int4_slots=True, tier_split=0.5)
    with pytest.raises(AssertionError):
        Side("jax").store(4, model="e8", sharded=dict(ep_shards=2, replicate_hot=1),
                          quantized_slots=True, tier=tier)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Side("port").store(4, model="e8", sharded=dict(ep_shards=2, replicate_hot=1),
                           quantized_slots=True, tier=tier)


@pytest.mark.parametrize("shards", [2, 4])
def test_tiered_sharded_store_matches_jax(shards):
    """Hot int8 / warm int4 tiers a shard: the same tier geometry, the two
    ranges a shard, local ids hot-first, tier moves and evictions kept
    within each shard, on a drifting table stream."""
    def run(side):
        # 6 int8 slots' bytes, split 0.5: 3 hot (2 a shard at EP-2, 1 a
        # shard at EP-4) and the warm slots they buy, rounded to the shards
        st = side.store(6, model="e8", sharded=dict(ep_shards=shards), quantized_slots=True,
                        tier=dict(int4_slots=True, tier_split=0.5))
        rng = np.random.default_rng(shards)
        out = []
        for j in range(10):
            hot = rng.choice(st.E, size=rng.integers(2, st.E + 1), replace=False)
            ids = rng.choice(hot, size=(st.L, 2, 6, 1)).astype(np.int32)
            t = side.table(ids, rng.random(ids.shape), j)
            trans = st.prepare(t)
            out.append((trans.tolist(), st.local_trans(trans).tolist(),
                        [[st.slot_shard(sl) for sl in row if sl >= 0] for row in trans]))
        return out, _state(st), st
    (want, sj_state, _), (got, st_state, st) = _both(run)
    assert got == want and st_state == sj_state
    assert st.tiered and st.S8 % shards == 0 and st.S4 % shards == 0
    for (g, s), res in st.resident.items():
        for e, slot in res.items():
            m = st.slot_shard(slot)
            rng_hot = range(m * st.S8_loc, (m + 1) * st.S8_loc)
            rng_warm = range(st.S8 + m * st.S4_loc, st.S8 + (m + 1) * st.S4_loc)
            assert slot in rng_hot or slot in rng_warm
    assert st.stats.demotions > 0


# ---------------------------------------------------------------------------
# hot-expert replication and rebalancing
# ---------------------------------------------------------------------------


def _repl(side, shards=2, slots=4, replicate_hot=1):
    """`_repl_store`: block placement over E8, lru, 2 slots a shard."""
    return side.store(slots, model="e8", eviction="lru", sharded=dict(
        ep_shards=shards, placement="block", replicate_hot=replicate_hot))


def test_replicas_fill_free_slots_with_global_ids():
    def run(side):
        st = _repl(side)
        trans = st.prepare(side.table(_mass_ids(st.L, [(0, 7), (4, 1)])))
        return _state(st), st.replica_cand(trans).tolist(), st.shard_load_score().tolist(), st
    (want, cand_j, score_j, _), (got, cand_t, score_t, st) = _both(run)
    assert got == want and cand_t == cand_j and score_t == score_j
    assert st.R == 2 and st.stats.replica_loads > 0
    for (g, s), res in st.resident.items():
        reps = st.replicas[(g, s)]
        assert set(reps) == {0}, "only the hot expert replicates"
        (sh, slot), = reps[0].items()
        assert sh == 1 and slot // st.S_loc == 1 and slot != res[4]
        assert res[0] // st.S_loc == 0 and res[4] // st.S_loc == 1
    g, s = st.layer_to_gs(0)
    assert set(cand_t[0][0]) == {st.resident[(g, s)][0], *st.replicas[(g, s)][0].values()}
    assert _slots_hold_masters(st)


def test_replicated_translate_round_robins_and_matches_device():
    def run(side):
        st = _repl(side)
        st.prepare(side.table(_mass_ids(st.L, [(0, 7), (4, 1)])))
        t = side.table(_mass_ids(st.L, [(0, 8)]))
        trans = st.prepare(t)
        slots, w = st.translate(t, trans)
        if side.jax:
            ds, dw = st.translate_device(jnp.asarray(t.expert_ids), jnp.asarray(t.weights), trans)
        else:
            ds, dw = st.translate_device(torch.from_numpy(t.expert_ids),
                                         torch.from_numpy(t.weights), trans)
        return (slots.tolist(), w.tolist(), np.asarray(ds).tolist(), np.asarray(dw).tolist(),
                _state(st)), st, t
    (want, _, _), (got, st, t) = _both(run)
    assert got == want
    slots, w, ds, dw, _ = got
    assert ds == slots and dw == w
    g, s = st.layer_to_gs(0)
    copies = {st.resident[(g, s)][0], *st.replicas[(g, s)][0].values()}
    assert set(np.asarray(slots)[0, 0, :, 0].tolist()) == copies and len(copies) == 2
    np.testing.assert_array_equal(w, t.weights)


def test_replica_reclaimed_before_primary_eviction():
    def run(side):
        st = _repl(side)
        st.prepare(side.table(_mass_ids(st.L, [(0, 7), (4, 1)])))   # rep(e0) -> shard 1
        st.prepare(side.table(_mass_ids(st.L, [(1, 1)])))           # shard 0 full
        st.prepare(side.table(_mass_ids(st.L, [(5, 1)])))           # shard 1 full: reclaim
        return _state(st)
    want, got = _both(run)
    assert got == want
    for key, res in got["resident"].items():
        assert not got["replicas"][key] and {0, 1, 4, 5} <= set(res)
    assert got["stats"]["evictions"] == 0


def test_primary_eviction_promotes_surviving_replica():
    def run(side):
        st = _repl(side)
        st.prepare(side.table(_mass_ids(st.L, [(0, 7), (4, 1)])))
        st.prepare(side.table(_mass_ids(st.L, [(1, 1)])))
        st.prepare(side.table(_mass_ids(st.L, [(1, 1), (2, 1)])))   # e2 wants shard 0
        return _state(st), st.S_loc
    (want, _), (got, S_loc) = _both(run)
    assert got == want
    for key, res in got["resident"].items():
        assert res[0] // S_loc == 1 and 0 not in got["replicas"][key] and res[2] // S_loc == 0
    assert got["stats"]["evictions"] == 0


def test_rebalance_homes_migrates_primaries():
    def run(side):
        st = _repl(side, shards=4, slots=8)           # home: shard0 = {0, 1}, S_loc 2
        for _ in range(3):
            st.prepare(side.table(_mass_ids(st.L, [(0, 6), (1, 6), (2, 1)])))
        old_home, epoch = st.home.copy(), st.affinity_epoch
        moved = st.rebalance_homes()
        mid = _state(st)
        t = side.table(_mass_ids(st.L, [(0, 2), (1, 2), (2, 1)]))
        _, w = st.translate(t, st.prepare(t))
        return moved, old_home.tolist(), st.affinity_epoch != epoch, mid, _state(st), \
            w.tolist(), st
    want, got = _both(run)
    assert got[:6] == want[:6]
    moved, old_home, bumped, mid, _, w, st = got
    assert moved > 0 and mid["stats"]["rebalance_moves"] == moved and bumped
    assert mid["home"] != old_home and mid["home"][0] != mid["home"][1]
    for key, res in mid["resident"].items():
        slots = list(res.values()) + [sl for d in mid["replicas"][key].values() for sl in d.values()]
        assert len(slots) == len(set(slots)) and all(0 <= sl < st.S for sl in slots)
    assert (np.asarray(w) > 0).all() and _slots_hold_masters(st)


# ---------------------------------------------------------------------------
# the prefetch pipeline's shard fan-out
# ---------------------------------------------------------------------------


def test_sharded_prefetch_fans_out_per_shard_queues():
    def run(side):
        st = side.store(4, sharded=dict(ep_shards=2))
        pipe = side.pipe(st, depth=2)
        try:
            geometry = (len(pipe._jobs), len(pipe._threads), len(st.free[(0, st.moe_subs[0])]))
            weights_ok = True
            for it in range(4):
                ids, w = _random_table(st.L, st.E, S=4, seed=it)
                t = side.table(ids, w, it)
                tk = pipe.submit(t)
                assert tk.wait(timeout=30)
                weights_ok &= bool((st.translate(t, tk.trans)[1] > 0).all())
                tk.release()
            return (geometry, weights_ok, dict(pipe.stats.uploads_by_shard), pipe.stats.uploads,
                    _slots_hold_masters(st), _state(st)), pipe
        finally:
            pipe.close()
    (want, _), (got, pipe) = _both(run)
    assert got == want
    assert got[0] == (2, 2, 2) and got[1] and got[4]
    assert set(got[2]) == {0, 1} and sum(got[2].values()) == got[3]
    assert not any(t.is_alive() for t in pipe._threads)
    s = pipe.stats.summary()
    assert [s[f"prefetch_uploads_shard{m}"] for m in range(2)] == [got[2][0], got[2][1]]


def test_warm_backpressure_is_per_destination_shard():
    def run(side):
        st = side.store(4, sharded=dict(ep_shards=2))          # mod: {0, 2} | {1, 3}
        pipe = side.pipe(st, depth=1)
        try:
            with pipe._jobs_cv:
                pipe._jobs[0][2].append({})                    # a backlog on shard 0's warm queue
            skipped = pipe.submit(side.table(_expert_ids(st.L, [0])), protect=False)
            tk = pipe.submit(side.table(_expert_ids(st.L, [1])), protect=False)
            ok = tk is not None and tk.wait(timeout=30)
            with pipe._jobs_cv:
                pipe._jobs[0][2].clear()
            return skipped is None, pipe.stats.warm_skipped, ok
        finally:
            pipe.close()
    want, got = _both(run)
    assert got == want == (True, 1, True)


def test_rebalance_moves_ride_the_shard_queues():
    """`rebalance_homes` under a pipeline: its uploads go through
    `submit_loads` to their destination shards' queues, each with a fence;
    the state, the per-shard uploads and the slot contents equal the
    reference's once the fences fire."""
    def run(side):
        st = _repl(side, shards=4, slots=8)
        pipe = side.pipe(st, depth=2)
        try:
            for j in range(3):
                tk = pipe.submit(side.table(_mass_ids(st.L, [(0, 6), (1, 6), (2, 1)]), idx=j))
                assert tk.wait(timeout=30)
                tk.release()
            ups0 = dict(pipe.stats.uploads_by_shard)
            moved = st.rebalance_homes()
            with st._lock:
                fences = [ev for pend in pipe._pending.values() for d in pend.values()
                          for ev in d.values()]
            assert all(ev.wait(30) for ev in fences)
            _wait_for(lambda: not any(pipe._pending.values()), msg="the moves' uploads")
            return (moved, ups0, dict(pipe.stats.uploads_by_shard), _slots_hold_masters(st),
                    _state(st), st.shard_load_score().tolist())
        finally:
            pipe.close()
    want, got = _both(run)
    assert got == want
    moved, ups0, ups, held, state, _ = got
    assert moved > 0 and held and sum(ups.values()) > sum(ups0.values())
    assert state["stats"]["rebalance_moves"] == moved


def test_watchdog_revives_a_dead_shard_among_several():
    """A transfer thread that crashes past its restarts leaves its shard
    dead (its jobs commit inline) while the other shard's thread serves;
    the watchdog revives it. Which shard's thread takes the crash is a
    race, so the tokens of state compared are those it cannot change."""
    def run(side):
        st = side.store(4, sharded=dict(ep_shards=2))
        pipe = side.pipe(st, "thread:crash@1", depth=1, max_thread_restarts=0)
        try:
            tk0 = pipe.submit(side.table(_expert_ids(st.L, [0, 1])))
            _wait_for(lambda: any(pipe._dead), msg="a shard's death")
            ok0 = tk0.wait(timeout=20)
            tk0.release()
            tk1 = pipe.submit(side.table(_expert_ids(st.L, [2, 3]), idx=1))
            ok1 = tk1.wait(timeout=20)
            tk1.release()
            dead = sum(pipe._dead)
            revived, _ = pipe.watchdog()
            _wait_for(lambda: all(t.is_alive() for t in pipe._threads), msg="revival")
            return (ok0, ok1, dead, revived, any(pipe._dead), pipe.degraded_fraction(),
                    _slots_hold_masters(st), _state(st)["resident"])
        finally:
            pipe.close()
    want, got = _both(run)
    assert got == want
    assert got[:7] == (True, True, 1, 1, False, 0.0, True)


# ---------------------------------------------------------------------------
# the expert-parallel dispatch
# ---------------------------------------------------------------------------


def _moe_inputs(model, slots, shards, seed, k=1, **store_kw):
    """The same sharded store on each side, one table prepared: (JAX store,
    port store, x [B, S, d] numpy, (ids, w) slot-translated numpy)."""
    sj = Side("jax").store(slots, model=model, sharded=dict(ep_shards=shards), **store_kw)
    st = Side("port").store(slots, model=model, sharded=dict(ep_shards=shards), **store_kw)
    ids, w = _random_table(st.L, st.E, B=2, S=8, k=k, seed=seed)
    if k > 1:   # distinct experts a token
        rng = np.random.default_rng(seed)
        ids = np.stack([rng.permutation(st.E)[:k] for _ in range(ids[..., 0].size)]).reshape(ids.shape)
        w = w / w.sum(-1, keepdims=True)
    tj, tt = JHashTable(0, ids, w), HashTable(0, ids, w)
    rj, rt = sj.translate(tj, sj.prepare(tj)), st.translate(tt, st.prepare(tt))
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(a, b)
    cfg_t = _weights(model)[1]
    x = np.random.default_rng(seed + 1).standard_normal((2, 8, cfg_t.d_model)).astype(np.float32)
    return sj, st, x, rt


def _layer_params(store, layer=0):
    g, s = store.layer_to_gs(layer)
    moe = store.serve_params["blocks"][f"sub{s}"]["moe"]
    if isinstance(store, joffload.ExpertStore):
        return jax.tree.map(lambda a: a[g], moe)
    return {k: v[g] for k, v in moe.items()}


FORMATS = {
    "fp32": dict(slots=8),
    "int8": dict(slots=8, quantized_slots=True),
    "tiered": dict(slots=6, quantized_slots=True, tier=dict(int4_slots=True, tier_split=0.5)),
}


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_ep_moe_layer_equals_one_device_dispatch(fmt, shards):
    """Top-1: the expert-parallel dispatch over a sharded store's pools
    equals the port's one-device dispatch over the same global slot ids bit
    for bit, and JAX's `moe_layer` (no mesh) within 1e-5; one expert-FFN
    launch a shard, each over a view of the shard's slice of the pool."""
    kw = dict(FORMATS[fmt])
    sj, st, x, (sl, w) = _moe_inputs("e8", kw.pop("slots"), shards, seed=shards, **kw)
    cfg_j, cfg_t = _weights("e8")[:2]
    pt, pj = _layer_params(st), _layer_params(sj)
    ro = (torch.from_numpy(sl[0]), torch.from_numpy(w[0]))
    ctx = store_ctx(st)
    assert ctx.ep_shards == shards and (fmt == "tiered") == ("w_in_q4" in pt)

    calls = []
    real = tmoe.shard_slice

    def spy(*args):
        p = real(*args)
        calls.append({k: (v.data_ptr(), v.shape[0], v._base is not None) for k, v in p.items()})
        return p

    tmoe.shard_slice = spy
    try:
        y_ep, _ = tmoe.moe_layer(pt, torch.from_numpy(x), cfg_t, routing_override=ro, ctx=ctx)
    finally:
        tmoe.shard_slice = real
    y_one, _ = tmoe.moe_layer(pt, torch.from_numpy(x), cfg_t, routing_override=ro)
    assert torch.equal(y_ep, y_one), (y_ep - y_one).abs().max()
    y_j, _ = j_moe_layer(pj, jnp.asarray(x), cfg_j, JShardingCtx(),
                         routing_override=(jnp.asarray(sl[0]), jnp.asarray(w[0])))
    np.testing.assert_allclose(y_ep.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)

    assert len(calls) == shards
    for m, call in enumerate(calls):
        for k, (ptr, n, is_view) in call.items():
            base = pt[k]
            assert is_view and n == base.shape[0] // shards
            assert ptr == base.data_ptr() + m * n * base.stride(0) * base.element_size()


@pytest.mark.parametrize("shards", [2, 4])
def test_ep_moe_layer_top_k_with_shared_experts(shards):
    """Top-6 of 16 experts with 2 shared experts (deepseek-narrow): the
    partials' sum order differs from the one-device combine, so within
    1e-5 of it and of JAX; the shared experts are added once."""
    sj, st, x, (sl, w) = _moe_inputs("deepseek", 16, shards, seed=5, k=6)
    cfg_j, cfg_t = _weights("deepseek")[:2]
    pt, pj = _layer_params(st), _layer_params(sj)
    xt = torch.from_numpy(x)
    ro = (torch.from_numpy(sl[0]), torch.from_numpy(w[0]))
    ctx = store_ctx(st)
    y_ep, _ = tmoe.moe_layer(pt, xt, cfg_t, routing_override=ro, ctx=ctx)
    y_one, _ = tmoe.moe_layer(pt, xt, cfg_t, routing_override=ro)
    np.testing.assert_allclose(y_ep.numpy(), y_one.numpy(), atol=1e-5, rtol=1e-5)
    y_j, _ = j_moe_layer(pj, jnp.asarray(x), cfg_j, JShardingCtx(),
                         routing_override=(jnp.asarray(sl[0]), jnp.asarray(w[0])))
    np.testing.assert_allclose(y_ep.numpy(), np.asarray(y_j), atol=1e-5, rtol=1e-5)
    no_shared = dict(pt, shared_w_out=torch.zeros_like(pt["shared_w_out"]))
    y_ns, _ = tmoe.moe_layer(no_shared, xt, cfg_t, routing_override=ro, ctx=ctx)
    shared = tmoe.shared_experts(pt, xt.reshape(-1, cfg_t.d_model), cfg_t).reshape(x.shape)
    np.testing.assert_allclose((y_ep - y_ns).numpy(), shared.numpy(), atol=1e-6, rtol=1e-6)


def test_ep_context_rules():
    """A sharded store always serves expert-parallel: its own context by
    default, a given one only when it shards the experts as many ways;
    shards on distinct devices raise, naming ROADMAP A14(c)."""
    st = Side("port").store(4, sharded=dict(ep_shards=2))
    ctx = store_ctx(st)
    assert ctx.ep_shards == 2 and ctx.expert_axis == "model" and ctx.mesh.device == st.device
    assert store_ctx(st, serve_ctx(make_ep_mesh(2, "cpu"))).ep_shards == 2
    for bad in (ShardingCtx(), serve_ctx(make_ep_mesh(4, "cpu"))):
        with pytest.raises(ValueError, match="ways"):
            store_ctx(st, bad)
    assert store_ctx(Side("port").store(4)).ep_shards == 1
    with pytest.raises(NotImplementedError, match=r"A14\(c\)"):
        make_ep_mesh(2, devices=["cpu", "meta"])
    # the store takes the mesh's device, and refuses a mesh of another size
    on_mesh = Side("port").store(4, sharded=dict(ep_shards=2)).__class__
    cfg_t, pt = _weights("r4")[1], _weights("r4")[3]
    assert on_mesh(cfg_t, pt, 4, sharded=toffload.ShardedStoreConfig(ep_shards=2),
                   mesh=make_ep_mesh(2, "cpu")).device == torch.device("cpu")
    with pytest.raises(ValueError, match="ep_shards=2"):
        on_mesh(cfg_t, pt, 4, sharded=toffload.ShardedStoreConfig(ep_shards=2),
                mesh=make_ep_mesh(4, "cpu"))


def test_sharded_pipeline_under_concurrent_producers():
    """Stress: two producer threads submit, wait and release tickets on a
    4-shard pipeline (one slot a shard, so plans evict and drop under each
    other's protection) while four transfer threads upload, the switch
    interval shortened. Every join is bounded; afterwards no fence is
    pending, the per-shard uploads add up, and every resident slot holds
    its expert's master."""
    import sys
    import threading

    st = Side("port").store(4, model="e8", sharded=dict(ep_shards=4))
    pipe = toffload.PrefetchPipeline(st, depth=1)
    errors, saved = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def producer(seed):
        try:
            rng = np.random.default_rng(seed)
            for j in range(15):
                ids = rng.integers(0, st.E, (st.L, 1, 3, 1)).astype(np.int32)
                tk = pipe.submit(HashTable(j, ids, np.ones(ids.shape, np.float32)))
                assert tk.wait(timeout=30)
                tk.release()
        except Exception as exc:    # reported by the main thread
            errors.append(exc)

    threads = [threading.Thread(target=producer, args=(s,)) for s in (1, 2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        _wait_for(lambda: not any(pipe._pending.values()), msg="the uploads")
        assert sum(pipe.stats.uploads_by_shard.values()) == pipe.stats.uploads > 0
        assert _slots_hold_masters(st)
    finally:
        sys.setswitchinterval(saved)
        pipe.close()
    assert not any(t.is_alive() for t in pipe._threads)
