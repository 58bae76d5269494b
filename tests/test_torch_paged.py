"""The port's paged K/V residency against the JAX package on the CPU: the
page pool's bookkeeping on the same calls (tables, free lists, spills and
page-ins, the overcommit errors), the budget splits, the
`flash_decode_paged` oracle (and the Pallas kernel in interpret mode),
`attend_decode_paged` with an inactive lane, and `SiDADecodeEngine.generate`
over pages: paged == ring, the same tokens and per-step loads as the JAX
engine on tiered slots, and a windowed model whose tight pool spills and
pages back in."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TierConfig as JTier
from repro.configs.base import get_config as jget_config
from repro.core import decode_engine as jd
from repro.core import residency as jr
from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import ShardingCtx
from repro.models.attention import attend_decode_paged as j_attend_decode_paged
from repro.models.attention import init_attention as j_init_attention
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core import decode_engine as td
from repro_torch.core import residency as tr
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import attend_decode_paged

torch.set_num_threads(2)
TOL = 2e-5       # tests/test_paged_kv.py's kernel-vs-oracle tolerance


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfg(get, window=0):
    """tests/test_paged_kv.py's `tiny` (and, windowed, `wtiny`)."""
    cfg = get("switch-base-8").reduced()
    cfg = dataclasses.replace(cfg, n_layers=2,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    if window:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, window=window, layer_pattern=("local",)))
    return cfg


def _system(window=0):
    cfg_j, cfg_t = _cfg(jget_config, window), _cfg(get_config, window)
    pj = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg_j))
    hj = jax.tree.map(np.asarray, j_init_hash_fn(
        jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j), cfg_j.moe.num_experts,
        d_h=16))
    return cfg_j, cfg_t, pj, hj, params_from_numpy(pj), params_from_numpy(hj)


@pytest.fixture(scope="module")
def tiny():
    return _system()


@pytest.fixture(scope="module")
def wtiny():
    return _system(window=8)


# ---------------------------------------------------------------------------
# pool bookkeeping against the JAX pool
# ---------------------------------------------------------------------------


def test_paged_config_geometry_and_budget_splits():
    for kw in (dict(page_size=8, kv_pages=4), dict(page_size=8, kv_pages=4, max_seq=100),
               dict(kv_pages=0)):
        t, j = tr.PagedKVConfig(**kw), jr.PagedKVConfig(**kw)
        assert (t.enabled, t.seq_len) == (j.enabled, j.seq_len)
        if t.enabled:
            assert t.pages_per_lane() == j.pages_per_lane()
    assert tr.PagedKVConfig(page_size=8, kv_pages=4, max_seq=100).pages_per_lane() == 13
    for args, kw in (((1000, 100, 10, 2), {}), ((1000, 100, 10, 2), dict(kv_mass=3.0)),
                     ((5000, 300, 7, 3), dict(expert_mass=2.0, min_pages=4))):
        assert tr.ResidencyManager.split_budget(*args, **kw) == \
            jr.ResidencyManager.split_budget(*args, **kw)
    with pytest.raises(ValueError, match="floor"):
        tr.ResidencyManager.split_budget(100, 100, 10, 2)
    for split in (0.5, 0.25, 1.0):
        got = tr.ResidencyManager.split_budget_tiered(100_000, 1000, 550, 100, 2, tier_split=split)
        assert got == jr.ResidencyManager.split_budget_tiered(100_000, 1000, 550, 100, 2,
                                                              tier_split=split)
    hot, warm, pages = tr.ResidencyManager.split_budget_tiered(100_000, 1000, 550, 100, 2)
    slots, pages0 = tr.ResidencyManager.split_budget(100_000, 1000, 100, 2)
    assert hot * 1000 + warm * 550 <= slots * 1000 and pages == pages0 and warm >= 1
    assert tr.ResidencyManager.split_budget_tiered(100_000, 1000, 550, 100, 2,
                                                   tier_split=1.0)[:2] == (slots, 0)


def _pools(sys_, n_lanes, **kw):
    cfg_j, cfg_t = sys_[0], sys_[1]
    pj = jr.KVPagePool(cfg_j, jr.PagedKVConfig(**kw), n_lanes=n_lanes)
    pt = tr.KVPagePool(cfg_t, tr.PagedKVConfig(**kw), n_lanes=n_lanes, device="cpu")
    return (pj, pj.init_cache()), (pt, pt.init_cache())


def _rand_kv(pool, rng, S):
    G, K, D = pool.n_groups, pool.cfg.n_kv_heads, pool.cfg.hd
    return {f"sub{s}": (rng.standard_normal((G, S, K, D)).astype(np.float32),
                        rng.standard_normal((G, S, K, D)).astype(np.float32))
            for s in pool.kv_subs}


def _page(cache, skey, pid):
    return tuple(np.asarray(cache[skey][n][:, pid]) for n in ("kp", "vp"))


def _same_stats(st, sj):
    """The port's pool counters equal the reference's (which also keeps a
    fence-wait time, always 0 without a pipeline)."""
    got = dataclasses.asdict(st)
    assert got == {k: getattr(sj, k) for k in got}


def _same_pools(a, b):
    (pj, cj), (pt, ct) = a, b
    np.testing.assert_array_equal(pt.table, pj.table)
    np.testing.assert_array_equal(pt.device_table().numpy(), np.asarray(pj.device_table()))
    assert pt._free == pj._free and set(pt._spill) == set(pj._spill)
    _same_stats(pt.stats, pj.stats)
    assert (pt.kv_pool_bytes(), pt.capacity_bytes(), pt.page_bytes()) == \
        (pj.kv_pool_bytes(), pj.capacity_bytes(), pj.page_bytes())
    for s in pt.kv_subs:
        for n in ("kp", "vp"):
            live = [int(x) for x in pt.table.reshape(-1) if x >= 0]
            np.testing.assert_array_equal(ct[f"sub{s}"][n][:, live].numpy(),
                                          np.asarray(cj[f"sub{s}"][n])[:, live])


def test_pool_spill_page_in_roundtrip(tiny):
    (pj, cj), (pt, ct) = _pools(tiny, 1, page_size=4, kv_pages=4)
    kv = _rand_kv(pt, np.random.default_rng(0), 12)
    skey = f"sub{pt.kv_subs[0]}"
    for pool, cache in ((pj, cj), (pt, ct)):
        cache = pool.seed(cache, 0, kv, 12)
        assert pool.resident_pages() == 3 and pool.stats.allocs == 3
        pid = int(pool.table[0, 1])
        before = _page(cache, skey, pid)
        np.testing.assert_array_equal(before[0], kv[skey][0][:, 4:8])
        cache = pool.spill(cache, 0, 1)
        assert pool.table[0, 1] == -1 and pool.stats.bytes_spilled == pool.page_bytes()
        cache = pool.page_in(cache, 0, 1)
        after = _page(cache, skey, int(pool.table[0, 1]))
        np.testing.assert_array_equal(after[0], before[0])
        np.testing.assert_array_equal(after[1], before[1])
        if pool is pj:
            cj = cache
    _same_pools((pj, cj), (pt, ct))
    pt.pin_lane(0)
    with pytest.raises(ValueError, match="pinned"):
        pt.spill(ct, 0, 0)
    pt.unpin_all()
    pt.release_lane(0)
    assert pt.resident_pages() == 0 and not pt._spill and not pt.policy.score


def test_seed_overcommit_errors_not_corrupts(tiny):
    _, (pt, ct) = _pools(tiny, 1, page_size=4, kv_pages=2, max_seq=16)
    with pytest.raises(RuntimeError, match="exhausted"):
        pt.seed(ct, 0, _rand_kv(pt, np.random.default_rng(5), 12), 12)
    assert not pt._pinned           # pins released on the error path


def test_seed_pressure_spills_other_lane_losslessly(tiny):
    a, b = _pools(tiny, 2, page_size=4, kv_pages=4, max_seq=16)
    rng = np.random.default_rng(6)
    kv0, kv1 = _rand_kv(b[0], rng, 8), _rand_kv(b[0], rng, 12)
    out = []
    for pool, cache in (a, b):
        cache = pool.seed(cache, 0, kv0, 8)                  # 2 pages
        cache = pool.seed(cache, 1, kv1, 12)                 # 3 pages: spills one of lane 0's
        assert sum(1 for k in pool._spill if k[0] == 0) == 1
        pool.release_lane(1)
        cache = pool.ensure(cache, 0, 8)                     # pages the spill back in
        skey = f"sub{pool.kv_subs[0]}"
        for i in range(2):
            k_got, v_got = _page(cache, skey, int(pool.table[0, i]))
            np.testing.assert_array_equal(k_got, kv0[skey][0][:, 4 * i:4 * i + 4])
            np.testing.assert_array_equal(v_got, kv0[skey][1][:, 4 * i:4 * i + 4])
        out.append((pool, cache))
    _same_pools(*out)


def test_pool_full_attention_overcommit_asserts(tiny):
    _, (pt, ct) = _pools(tiny, 1, page_size=4, kv_pages=2, max_seq=32)
    ct = pt.ensure(ct, 0, 8)                                 # exactly the pool: fine
    with pytest.raises(ValueError, match="full-attention working set"):
        pt.ensure(ct, 0, 12)
    with pytest.raises(ValueError, match="addressable range"):
        pt.ensure(ct, 0, 33)
    with pytest.raises(NotImplementedError, match="A13"):
        tr.KVPagePool(tiny[1], tr.PagedKVConfig(prefill_chunk=8), 1, device="cpu")


# ---------------------------------------------------------------------------
# the paged oracle and paged attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (5, 20.0)])
def test_flash_decode_paged_ref_matches_jax(window, cap):
    rng = np.random.default_rng(0)
    B, H, K, D, page, n_pages, Mp = 3, 4, 2, 8, 4, 5, 4
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((n_pages + 1, page, K, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, page, K, D)).astype(np.float32)
    # lane 0: pages 0..2 resident, page 3 unallocated; lane 1: its first page
    # spilled; lane 2: no valid key (averages V over every gathered slot)
    table = np.array([[0, 1, 2, -1], [-1, 3, 4, -1], [-1, -1, -1, 0]], np.int32)
    pos = np.array([10, 9, 5], np.int32)
    args_t = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    args_j = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
    got = ref.flash_decode_paged_ref(*args_t, window=window, cap=cap)
    _close(got, jref.flash_decode_paged_ref(*args_j, window=window, cap=cap), TOL)
    _close(got, jops.flash_decode_paged(*args_j, window=window, cap=cap), TOL)   # interpret
    _close(ops.flash_decode_paged(*args_t, window=window, cap=cap), got, 0.0)
    gathered = np.concatenate([vp[p] if p >= 0 else vp[n_pages] for p in table[2]])
    want2 = gathered.mean(0)                                 # [K, D]
    _close(got[2].reshape(K, H // K, D), np.repeat(want2[:, None], H // K, axis=1), TOL)


def _attn_pair(window):
    out = []
    for get in (jget_config, get_config):
        base = get("switch-base-8").reduced()
        attn = dataclasses.replace(base.attn, window=window,
                                   layer_pattern=("local",) if window else ("global",))
        out.append(dataclasses.replace(base, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                                       attn=attn))
    return out


@pytest.mark.parametrize("window", [0, 6])
def test_attend_decode_paged_matches_jax(window):
    cfg_j, cfg_t = _attn_pair(window)
    pj = jax.tree.map(np.asarray, j_init_attention(jax.random.PRNGKey(0), cfg_j))
    pt = params_from_numpy(pj)
    B, page, n_pages, Mp, steps = 3, 4, 8, 5, 14
    rng = np.random.default_rng(1)
    kp = rng.standard_normal((n_pages + 1, page, 2, 8)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, page, 2, 8)).astype(np.float32)
    # lane 0 owns pages 0..3; lane 1 pages 4..6 with its third entry spilled;
    # lane 2 is inactive: its writes go to the trash page
    table = np.array([[0, 1, 2, 3, -1], [4, 5, -1, 6, -1], [7, -1, -1, -1, -1]], np.int32)
    active = np.array([True, True, False])
    kp_j, vp_j = jnp.asarray(kp), jnp.asarray(vp)
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    jstep = jax.jit(lambda p, x, k, v, t, pos, a: j_attend_decode_paged(
        p, x, k, v, t, pos, cfg_j, 0, ShardingCtx(), active=a))
    for i in range(steps):
        x = rng.standard_normal((B, 32)).astype(np.float32)
        pos = np.array([i, i + 3, i], np.int32)              # lane 1 runs past its table at 20
        yj, kp_j, vp_j = jstep(pj, x, kp_j, vp_j, table, pos, active)
        yt, kp_t, vp_t = attend_decode_paged(pt, torch.from_numpy(x), kp_t, vp_t,
                                             torch.from_numpy(table), torch.from_numpy(pos),
                                             cfg_t, 0, active=torch.from_numpy(active))
        _close(yt[:2], np.asarray(yj)[:2], 1e-5)             # the inactive lane's y is unused
        _close(kp_t[:n_pages], np.asarray(kp_j)[:n_pages], 1e-5)  # every real page
        _close(vp_t[:n_pages], np.asarray(vp_j)[:n_pages], 1e-5)
    np.testing.assert_array_equal(kp_t[7].numpy(), kp[7])    # the inactive lane wrote no page


# ---------------------------------------------------------------------------
# the engine over pages
# ---------------------------------------------------------------------------


def _generate(sys_, side, paged, lanes=(1, 2), steps=10, slots=None, top_k=1, **kw):
    cfg_j, cfg_t, pj, hj, pt, ht = sys_
    slots = slots or cfg_t.moe.num_experts
    start = np.asarray(lanes, np.int32)
    if side == "jax":
        if "tier" in kw:
            kw["tier"] = JTier(**dataclasses.asdict(kw["tier"]))
        eng = jd.SiDADecodeEngine(cfg_j, pj, hj, slots_per_layer=slots, serve_top_k=top_k, **kw)
        paged = None if paged is None else jr.PagedKVConfig(**dataclasses.asdict(paged))
        make = eng._make_cache

        def keep_pool(*args):      # the JAX engine keeps no handle on its pool
            cache, eng.kv_pool = make(*args)
            return cache, eng.kv_pool

        eng._make_cache = keep_pool
    else:
        eng = td.SiDADecodeEngine(cfg_t, pt, ht, slots_per_layer=slots, serve_top_k=top_k,
                                  device="cpu", **kw)
    out, m = eng.generate(start, steps=steps, cache_len=32, paged=paged)
    eng.close()
    return out, m, eng


_PAGED = tr.PagedKVConfig(page_size=8, kv_pages=4)   # seq_len 32


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_paged_matches_ring_and_jax(tiny, quantized):
    ring, _, _ = _generate(tiny, "torch", None, quantized_slots=quantized)
    paged, _, eng = _generate(tiny, "torch", _PAGED, quantized_slots=quantized)
    np.testing.assert_array_equal(paged, ring)
    assert eng.kv_pool.stats.allocs == 2 * 2 and eng.kv_pool.stats.spills == 0
    jax_paged, _, _ = _generate(tiny, "jax", _PAGED, quantized_slots=quantized)
    np.testing.assert_array_equal(paged, jax_paged)


def test_engine_paged_wide_table_matches_ring(tiny):
    ring, _, _ = _generate(tiny, "torch", None)
    wide, _, eng = _generate(tiny, "torch", tr.PagedKVConfig(page_size=8, kv_pages=4,
                                                             max_seq=256))
    np.testing.assert_array_equal(wide, ring)
    assert eng.kv_pool.Mp == 32


def test_tiered_paged_decode_matches_jax(tiny):
    """Hot int8 / warm int4 slots under pressure over a paged cache: the JAX
    engine's tokens, per-step loads and tier moves."""
    kw = dict(slots=2, top_k=2, lanes=(1, 2, 3), steps=16, quantized_slots=True,
              eviction="alpha", tier=TierConfig(int4_slots=True, warm_slots=1))
    paged = tr.PagedKVConfig(page_size=4, kv_pages=12)
    ot, mt, et = _generate(tiny, "torch", paged, **kw)
    oj, mj, ej = _generate(tiny, "jax", paged, **kw)
    np.testing.assert_array_equal(ot, oj)
    assert mt.loads_per_step == mj.loads_per_step
    assert et.store.S4 == 1 and et.store.resident == ej.store.resident
    for f in ("loads", "hits", "evictions", "promotions", "demotions", "dropped", "bytes_h2d"):
        assert getattr(et.store.stats, f) == getattr(ej.store.stats, f), f
    assert et.store.stats.demotions > 0 and sum(mt.loads_per_step[1:]) > 0


def test_windowed_tight_pool_spills_and_pages_in_like_jax(wtiny):
    """Windowed attention bounds the residency span, so two lanes stream
    through a pool smaller than their pages: out-of-window pages spill,
    in-window pages an other lane's tick evicted page back in, and the
    tokens equal the JAX engine's and a roomy pool's."""
    tight = tr.PagedKVConfig(page_size=4, kv_pages=6, max_seq=64)
    ot, _, et = _generate(wtiny, "torch", tight, steps=24)
    oj, _, ej = _generate(wtiny, "jax", tight, steps=24)
    np.testing.assert_array_equal(ot, oj)
    st = et.kv_pool.stats
    _same_stats(st, ej.kv_pool.stats)
    np.testing.assert_array_equal(et.kv_pool.table, ej.kv_pool.table)
    assert st.spills > 0 and st.page_ins > 0 and st.allocs > 6
    roomy, _, er = _generate(wtiny, "torch", tr.PagedKVConfig(page_size=4, kv_pages=32,
                                                              max_seq=64), steps=24)
    assert er.kv_pool.stats.spills == 0
    np.testing.assert_array_equal(ot, roomy)
