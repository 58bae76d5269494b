"""The port's hot int8 / warm int4 residency tiers against the JAX package
on the CPU: the int4 format and oracles bit for bit / within the reference's
tolerances, `forget` on the three eviction policies, the tiered
`ExpertStore` against the JAX store on the same table streams and tier
transitions (the same resident maps, pending loads and counters), the
tiered MoE forward and decode step against JAX on the same slot pools, and
the serve CLI's tier flags."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import TierConfig as JTier
from repro.configs.base import get_config as jget_config
from repro.core import offload as jo
from repro.core.hash_table import HashTable as JHashTable
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import ShardingCtx
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_cache as j_init_cache
from repro.models.transformer import init_params as j_init_params
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core import offload as to
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.core.hash_table import HashTable
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models.transformer import decode_step, forward, init_cache, n_moe_layers

torch.set_num_threads(2)
F32_TOL, BF16_TOL = 1e-4, 5e-2     # tests/test_quantized.py's kernel tolerances
ORACLE_F32_TOL = 1e-5
REL_TOL_TIERED = 0.15              # tests/test_tiering.py's warm-tier serving budget


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else np.asarray(x)


# ---------------------------------------------------------------------------
# int4 format and oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,group", [(64, 16), (96, 64), (33, 8), (40, 40), (40, 64)])
def test_quantize_expert_q4_is_bit_identical(k, group, dtype):
    """The store's torch int4 quantisation (`quantize_stack_int4`, a layer at a
    time, on the store's device: the CPU here) gives the reference's numpy
    masters bit for bit, from fp32 and bf16 weights (the reference
    quantises the fp32 view of a bf16 master); the packing unpacks to the
    reference's values."""
    w = (np.random.default_rng(k).standard_normal((2, 3, k, 24)) * 0.05).astype(np.float32)
    w[0, 1, :, 5] = 0.0                                   # an all-zero group (the 1e-8 floor)
    full = torch.from_numpy(w).to(getattr(torch, dtype))
    qt, st = to.quantize_stack_int4(full, "cpu", group)
    wj = w.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else w
    qj, sj = jo.quantize_expert_q4(wj, group)
    assert qt.dtype == torch.uint8 and tuple(qt.shape) == (2, 3, (k + 1) // 2, 24)
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(ref.unpack_int4_ref(qt, k).numpy(), jo.unpack_nibbles(qj, k))


def _q4_inputs(E, C, d, F, glu, group, seed=0):
    rng = np.random.default_rng(seed)
    xe = rng.standard_normal((E, C, d)).astype(np.float32)
    ws = [(rng.standard_normal((E, d, F)) / np.sqrt(d)).astype(np.float32),
          (rng.standard_normal((E, d, F)) / np.sqrt(d)).astype(np.float32) if glu else None,
          (rng.standard_normal((E, F, d)) / np.sqrt(F)).astype(np.float32)]
    out = [xe]
    for w in ws:
        out += [None, None] if w is None else list(jo.quantize_expert_q4(w, group))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,F,glu,act,group", [
    (2, 8, 64, 128, False, "gelu", 64), (3, 5, 32, 64, True, "silu", 16),
    (1, 4, 48, 96, False, "relu", 100),                  # 100 tiles neither axis: one group
])
def test_int4_oracles_match_jax(E, C, d, F, glu, act, group, dtype):
    args = _q4_inputs(E, C, d, F, glu, group)
    tol = ORACLE_F32_TOL if dtype == "float32" else BF16_TOL
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    args_j = [None if a is None else jnp.asarray(a) for a in args]
    args_j[0] = args_j[0].astype(jdt)
    args_t = [None if a is None else torch.from_numpy(a) for a in args]
    args_t[0] = args_t[0].to(getattr(torch, dtype))
    np.testing.assert_array_equal(ref.unpack_int4_ref(args_t[1], d).numpy(),
                                  np.asarray(jref.unpack_int4_ref(args_j[1], d)))
    _close(ref.dequantize_q4_ref(args_t[5], args_t[6], F),
           jref.dequantize_q4_ref(args_j[5], args_j[6], F), 0.0)
    got = ref.expert_ffn_q4_ref(*args_t, act=act)
    assert got.dtype == getattr(torch, dtype)
    _close(_np(got), np.asarray(jref.expert_ffn_q4_ref(*args_j, act=act), np.float32), tol)
    _close(ops.expert_ffn_q4(*args_t, act=act).float(), got.float(), 0.0)   # CPU dispatch
    if dtype == "float32" and group <= d:
        # the Pallas kernel in interpret mode, at its f32 tolerance
        _close(got, jops.expert_ffn_q4(*args_j, act=act, bc=C, bf=F), F32_TOL)


# ---------------------------------------------------------------------------
# eviction policies: forget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fifo", "lru", "alpha"])
def test_policy_forget_matches_jax(name):
    pt, pj = to.EVICTION_POLICIES[name](), jo.EVICTION_POLICIES[name]()
    victims = {}
    for pol, key in ((pt, "t"), (pj, "j")):
        for e, w in enumerate([0.5, 0.1, 0.9, 0.3, 0.7]):
            pol.admit(e, w)
        pol.touch(3, 2.0)
        pol.touch(1, 0.05)
        pol.forget(2)
        pol.forget(9)                       # absent: a no-op
        out = [pol.pick_victim({4})]
        pol.admit(2, 0.2)
        pol.forget(out[0])                  # already gone: a no-op
        while (v := pol.pick_victim({4})) is not None:
            out.append(v)
        victims[key] = out
    assert victims["t"] == victims["j"]
    assert 4 not in victims["t"] and sorted(victims["t"]) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the tiered store against the JAX store
# ---------------------------------------------------------------------------


def _tiny(get):
    """tests/test_tiering.py's miniature: 2 layers, capacity that never binds."""
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(cfg, n_layers=2,
                               moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg_t = _tiny(jget_config), _tiny(get_config)
    pj = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg_j))
    return cfg_j, cfg_t, pj, params_from_numpy(pj)


def _stores(tiny, slots=1, eviction="lru", **tkw):
    """(JAX store, port store) on the same weights and tier."""
    cfg_j, cfg_t, pj, pt = tiny
    tkw.setdefault("int4_slots", True)
    sj = jo.ExpertStore(cfg_j, pj, slots_per_layer=slots, eviction=eviction,
                        quantized_slots=True, tier=JTier(**tkw))
    st = to.ExpertStore(cfg_t, pt, slots_per_layer=slots, eviction=eviction,
                        quantized_slots=True, tier=TierConfig(**tkw), device="cpu")
    return sj, st


def _table(st, needed, step=0):
    """One token routed to each expert in `needed`, at every MoE layer."""
    ids = np.broadcast_to(np.asarray(needed, np.int32).reshape(1, 1, -1, 1),
                          (st.L, 1, len(needed), 1))
    w = np.ones(ids.shape, np.float32)
    return (JHashTable if isinstance(st, jo.ExpertStore) else HashTable)(step, ids.copy(), w)


def _free(st, key):
    return st.free[key][0]          # shard 0's free list (both stores keep one a shard)


def _policy(st, key):
    return st.policy[key][0]


def _tiers(st, layer=0):
    return {e: st.slot_tier(sl) for e, sl in st.resident[st.layer_to_gs(layer)].items()}


def check_tier_invariants(st):
    """One slot per resident expert, in one tier; resident and free slots
    partition each tier's slot space; the bytes stay in the budget."""
    b = st.tier_slot_bytes()
    for key, res in st.resident.items():
        slots = list(res.values())
        assert len(slots) == len(set(slots)), res
        hot = [sl for sl in slots if sl < st.S8]
        warm = [sl for sl in slots if sl >= st.S8]
        assert all(st.S8 <= sl < st.S8 + st.S4 for sl in warm)
        assert len(hot) * b["hot"] + len(warm) * b["warm"] <= st.S8 * b["hot"] + st.S4 * b["warm"]
        free = {sl for part in st.free[key] + st.free4[key] for sl in part}
        assert not free & set(slots) and free | set(slots) == set(range(st.S))


def _assert_same(sj, st):
    assert st.resident == sj.resident
    for f in ("loads", "hits", "evictions", "promotions", "demotions", "dropped", "bytes_h2d"):
        assert getattr(st.stats, f) == getattr(sj.stats, f), f
    for key in st.resident:
        assert st.free[key] == sj.free[key] and st.free4[key] == sj.free4[key]
        np.testing.assert_allclose(st.alpha_ema[key], sj.alpha_ema[key], rtol=1e-12)
    for s in st.moe_subs:
        pool_t = st.serve_params["blocks"][f"sub{s}"]["moe"]
        pool_j = sj.serve_params["blocks"][f"sub{s}"]["moe"]
        assert set(pool_t) == set(pool_j)
        for k in pool_t:
            if k.startswith("w_"):
                np.testing.assert_array_equal(pool_t[k].numpy(), np.asarray(pool_j[k]))


@pytest.mark.parametrize("slots,tkw", [
    (2, dict(warm_slots=2)), (8, dict(warm_slots=16)), (32, dict(tier_split=0.5)),
    (4, dict(tier_split=0.5)), (4, dict(tier_split=0.5, group_size=100)), (3, dict(tier_split=1.0)),
])
def test_tier_geometry_matches_jax(tiny, slots, tkw):
    sj, st = _stores(tiny, slots=slots, **tkw)
    E = st.E
    assert (st.S8, st.S4, st.S, st.tiered) == (sj.S8, sj.S4, sj.S, sj.tiered)
    assert st.S8 + st.S4 <= E                        # the combined slots cap at E
    assert st.tier_slot_bytes() == sj.tier_slot_bytes()
    assert st.device_bytes() == sj.device_bytes()
    assert st.expert_slot_bytes() == sj.expert_slot_bytes()
    b = st.tier_slot_bytes()
    assert st.device_bytes() // len(st.moe_subs) == st.S8 * b["hot"] + st.S4 * b["warm"]
    if st.S4:
        assert b["hot"] / b["warm"] >= 1.78
        assert [st.slot_tier(x) for x in range(st.S)] == ["hot"] * st.S8 + ["warm"] * st.S4
    else:   # no warm slots: the plain quantized store, no int4 pools
        assert not st.tiered
        assert all("w_in_q4" not in b_["moe"] for b_ in st.serve_params["blocks"].values()
                   if "moe" in b_)


def _case_miss_pressure_demotes(st):
    st.prepare(_table(st, [0]))
    assert _tiers(st) == {0: "hot"}
    st.prepare(_table(st, [1], step=1))
    assert _tiers(st) == {1: "hot", 0: "warm"}       # demoted, not evicted
    assert st.stats.demotions >= 1 and st.stats.evictions == 0


def _case_warm_hit_promotes_into_free_hot_slot(st):
    st.prepare(_table(st, [0, 1]))
    st.prepare(_table(st, [2, 3], step=1))           # 0 and 1 demoted to warm
    warm_e = sorted(e for e, t in _tiers(st).items() if t == "warm")
    hot_e = sorted(e for e, t in _tiers(st).items() if t == "hot")
    key = st.layer_to_gs(0)
    _free(st, key).append(st.resident[key].pop(hot_e[0]))   # free a hot slot
    _policy(st, key).forget(hot_e[0])
    before = st.stats.promotions
    st.prepare(_table(st, [warm_e[0]], step=2))
    assert st.stats.promotions > before and _tiers(st)[warm_e[0]] == "hot"


def _case_warm_hit_swaps_by_alpha(st):
    def mass(ws):
        m = np.zeros(st.E, np.float64)
        for e, w in ws.items():
            m[e] = w
        return m

    st.plan_layer(0, np.array([0, 1]), mass=mass({0: 1.0, 1: 0.01}))
    st.plan_layer(0, np.array([2]), mass=mass({2: 0.02}))
    assert _tiers(st) == {0: "hot", 2: "hot", 1: "warm"}
    before = st.stats.promotions
    for _ in range(4):                                # heavy hits push 1 past the margin
        st.plan_layer(0, np.array([1]), mass=mass({1: 1.0}))
    assert st.stats.promotions > before
    assert _tiers(st) == {0: "hot", 1: "hot", 2: "warm"}     # swapped, both resident


def _case_protected_hot_tier_overflows_to_warm(st):
    st.prepare(_table(st, [0, 1, 2]))
    assert sorted(_tiers(st).values()) == ["hot", "warm", "warm"] and st.stats.dropped == 0


def _case_pinned_never_demotes(st):
    st.prepare(_table(st, [0]))
    st.pin_experts(0, [0])
    for step, e in enumerate([1, 2, 3, 1, 2]):
        st.prepare(_table(st, [e], step=step + 1))
        assert _tiers(st)[0] == "hot"
        check_tier_invariants(st) if isinstance(st, to.ExpertStore) else None


def _case_in_flight_never_moves(st):
    st.prepare(_table(st, [0]))
    key = st.layer_to_gs(0)
    slot0 = st.resident[key][0]
    for l in range(st.L):
        pend = st.plan_layer(l, np.array([1]), extra_protected={0})
        st.commit_loads(st.layer_to_gs(l)[1], pend)
    assert st.resident[key][0] == slot0


def _case_promotion_reuploads_masters(st):
    st.prepare(_table(st, [0]))
    st.prepare(_table(st, [1], step=1))              # 0 demoted: int4 master rows
    key = st.layer_to_gs(0)
    g, s = key
    moe_p = st.serve_params["blocks"][f"sub{s}"]["moe"]
    wslot = st.resident[key][0]
    assert wslot >= st.S8
    for t in to.EXPERT_TENSORS:
        np.testing.assert_array_equal(_np(moe_p[t + "_q4"][g, wslot - st.S8]),
                                      _np(st.host4[f"sub{s}"][t][g, 0]))
        np.testing.assert_array_equal(_np(moe_p[t + "_q4_scale"][g, wslot - st.S8]),
                                      _np(st.host4_scale[f"sub{s}"][t][g, 0]))
    st.resident[key].pop(1)                          # free the hot tier, then hit 0
    _free(st, key).append(0)
    _policy(st, key).forget(1)
    st.prepare(_table(st, [0], step=2))
    slot = st.resident[key][0]
    assert slot < st.S8 and st.stats.promotions >= 1
    for t in to.EXPERT_TENSORS:                      # the int8 master, not an int4 upcast
        np.testing.assert_array_equal(_np(moe_p[t][g, slot]), _np(st.host[f"sub{s}"][t][g, 0]))


@pytest.mark.parametrize("case,slots,tkw,eviction", [
    (_case_miss_pressure_demotes, 1, dict(warm_slots=1), "lru"),
    (_case_warm_hit_promotes_into_free_hot_slot, 2, dict(warm_slots=2), "lru"),
    (_case_warm_hit_swaps_by_alpha, 2, dict(warm_slots=2, promote_margin=1.25), "alpha"),
    (_case_protected_hot_tier_overflows_to_warm, 1, dict(warm_slots=2), "lru"),
    (_case_pinned_never_demotes, 1, dict(warm_slots=2), "lru"),
    (_case_in_flight_never_moves, 1, dict(warm_slots=2), "fifo"),
    (_case_promotion_reuploads_masters, 1, dict(warm_slots=2), "lru"),
], ids=lambda x: x.__name__[6:] if callable(x) else None)
def test_tier_transition_matches_jax(tiny, case, slots, tkw, eviction):
    sj, st = _stores(tiny, slots=slots, eviction=eviction, **tkw)
    case(sj)
    case(st)
    check_tier_invariants(st)
    _assert_same(sj, st)


def test_warm_masters_are_the_f32_originals_quantised(tiny):
    _, cfg_t, pj, _ = tiny
    _, st = _stores(tiny, slots=1, warm_slots=2)
    for s in st.moe_subs:
        for t in to.EXPERT_TENSORS:
            q, sc = jo.quantize_expert_q4(pj["blocks"][f"sub{s}"]["moe"][t], st.tier.group_size)
            np.testing.assert_array_equal(st.host4[f"sub{s}"][t].numpy(), q)
            np.testing.assert_array_equal(st.host4_scale[f"sub{s}"][t].numpy(), sc)


def _stream(n, L, E, seed):
    """A skewed stream: each table draws from a drifting subset of experts."""
    rng = np.random.default_rng(seed)
    for j in range(n):
        hot = rng.choice(E, size=rng.integers(2, E + 1), replace=False)
        yield j, rng.choice(hot, size=(L, 2, 6, 1)).astype(np.int32), \
            rng.random((L, 2, 6, 1)).astype(np.float32)


@pytest.mark.parametrize("eviction,slots,tkw", [
    ("fifo", 4, dict(tier_split=0.5)), ("lru", 2, dict(warm_slots=3)),
    ("alpha", 3, dict(warm_slots=3, promote_margin=1.1)),
])
def test_tiered_store_matches_jax_on_table_stream(tiny, eviction, slots, tkw):
    sj, st = _stores(tiny, slots=slots, eviction=eviction, **tkw)
    assert st.tiered
    for j, ids, w in _stream(12, st.L, st.E, seed=slots):
        with sj._lock, st._lock:
            trans_j, pend_j, need_j = sj.plan(JHashTable(j, ids, w))
            trans_t, pend_t, need_t = st.plan(HashTable(j, ids, w))
            assert pend_t == pend_j                  # the same (g, slot, e) uploads per plan
            np.testing.assert_array_equal(trans_t, trans_j)
            for l in need_j:
                np.testing.assert_array_equal(need_t[l], need_j[l])
            for s in st.moe_subs:
                sj.commit_loads(s, pend_j[s])
                st.commit_loads(s, pend_t[s])
        check_tier_invariants(st)
    assert st.stats.demotions + st.stats.promotions > 0
    _assert_same(sj, st)


def test_all_hot_tier_behaves_as_plain_quantized_slots(tiny):
    """S4 == 0 (tier_split 1.0) turns tiering off: the same bookkeeping and
    slot pools as the untiered int8 store on one stream."""
    _, cfg_t, _, pt = tiny
    _, st = _stores(tiny, slots=3, eviction="alpha", tier_split=1.0)
    plain = to.ExpertStore(cfg_t, pt, slots_per_layer=3, eviction="alpha",
                           quantized_slots=True, device="cpu")
    assert (st.S8, st.S4, st.tiered) == (3, 0, False)
    for j, ids, w in _stream(8, st.L, st.E, seed=0):
        np.testing.assert_array_equal(st.prepare(HashTable(j, ids, w)),
                                      plain.prepare(HashTable(j, ids, w)))
    assert st.resident == plain.resident
    assert dataclasses.replace(st.stats, prepare_time=0.0) == \
        dataclasses.replace(plain.stats, prepare_time=0.0)
    assert not st.alpha_ema[(0, 1)].any()            # no tier EMA was fed
    for s in st.moe_subs:
        a, b = (x.serve_params["blocks"][f"sub{s}"]["moe"] for x in (st, plain))
        assert set(a) == set(b)
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the tiered forward and decode step against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resident_tiers(tiny):
    """JAX and port stores holding every expert, half hot int8, half warm int4."""
    E = tiny[1].moe.num_experts
    sj, st = _stores(tiny, slots=E // 2, eviction="lru", warm_slots=E - E // 2)
    needed = list(range(E))
    sj.prepare(_table(sj, needed))
    st.prepare(_table(st, needed))
    _assert_same(sj, st)
    assert sorted(_tiers(st).values()) == ["hot"] * (E // 2) + ["warm"] * (E - E // 2)
    return sj, st


def test_tiered_forward_and_decode_step_match_jax(tiny, resident_tiers):
    cfg_j, cfg_t, _, _ = tiny
    sj, st = resident_tiers
    L, ctx = st.L, ShardingCtx()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, 12)).astype(np.int32)
    ids = rng.integers(0, st.E, (L, 2, 12, 1)).astype(np.int32)
    w = np.ones(ids.shape, np.float32)
    trans = np.stack([sj.trans_row(l) for l in range(L)])
    slot_ids, sw = st.translate(HashTable(0, ids, w), trans)
    assert (slot_ids >= st.S8).any() and (slot_ids < st.S8).any()    # both tiers serve
    lj = np.asarray(j_forward(sj.serve_params, cfg_j, ctx, tokens,
                              routing_override=(jnp.asarray(slot_ids), jnp.asarray(sw)))["logits"])
    lt = forward(st.serve_params, cfg_t, torch.from_numpy(tokens),
                 routing_override=(torch.from_numpy(slot_ids), torch.from_numpy(sw)))["logits"]
    scale = float(np.abs(lj).max())
    _close(lt.numpy() / scale, lj / scale, F32_TOL)

    cj, ct = j_init_cache(cfg_j, 2, 8), init_cache(cfg_t, 2, 8, device="cpu")
    jstep = jax.jit(lambda p, c, t, i, w: j_decode_step(p, c, t, cfg_j, ctx,
                                                        routing_override=(i, w)))
    toks = tokens[:, 0]
    for i in range(10):                              # the ring wraps
        sid, sw1 = slot_ids[:, :, i], sw[:, :, i]
        lj, cj = jstep(sj.serve_params, cj, toks, sid, sw1)
        lt, ct = decode_step(st.serve_params, ct, torch.from_numpy(toks), cfg_t,
                             routing_override=(torch.from_numpy(sid), torch.from_numpy(sw1)))
        scale = float(np.abs(np.asarray(lj)).max())
        _close(lt.numpy() / scale, np.asarray(lj) / scale, F32_TOL)
        toks = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)


def test_tiered_all_resident_close_to_fp(tiny):
    """Hot + warm covering every expert serves logits within
    REL_TOL_TIERED of fp residency on a shared token stream."""
    _, cfg_t, _, pt = tiny
    E = cfg_t.moe.num_experts
    hp = init_hash_fn(torch.Generator().manual_seed(1), cfg_t.d_model, n_moe_layers(cfg_t), E,
                      d_h=16, device="cpu")
    fp = SiDAEngine(cfg_t, pt, hp, slots_per_layer=E, eviction="lru", device="cpu")
    tiered = SiDAEngine(cfg_t, pt, hp, slots_per_layer=E // 2, eviction="lru", device="cpu",
                        quantized_slots=True, tier=TierConfig(int4_slots=True,
                                                              warm_slots=E - E // 2))
    assert tiered.store.S8 + tiered.store.S4 == E
    rng = np.random.default_rng(0)
    worst = 0.0
    for i in range(3):
        toks = rng.integers(0, cfg_t.vocab_size, (2, 16)).astype(np.int32)
        lf = fp.infer(toks, fp.build_table(i, toks)).numpy()
        lt = tiered.infer(toks, tiered.build_table(i, toks)).numpy()
        worst = max(worst, float(np.abs(lf - lt).max() / np.abs(lf).max()))
    assert 0.0 < worst < REL_TOL_TIERED, worst
    assert tiered.store.stats.dropped == 0
    assert any(sl >= tiered.store.S8 for r in tiered.store.resident.values() for sl in r.values())


def test_serve_cli_takes_the_tier_flags(capsys):
    args = serve.build_parser().parse_args([])
    assert (args.int4_slots, args.tier_split, args.quant_group) == (False, 0.5, 64)
    serve.main(["--device", "cpu", "--slots", "2", "--batches", "2", "--batch", "2", "--seq", "8",
                "--quantized-slots", "--int4-slots", "--tier-split", "0.5", "--quant-group", "32"])
    out = capsys.readouterr().out
    assert "int4_slots=True" in out and "promotions=" in out and "demotions=" in out
    for bad in (["--int4-slots"], ["--int4-slots", "--quantized-slots", "--tier-split", "0"],
                ["--int4-slots", "--quantized-slots", "--tier-split", "1.5"],
                ["--int4-slots", "--quantized-slots", "--quant-group", "0"]):
        with pytest.raises(SystemExit, match="invalid flags"):
            serve.main(["--device", "cpu", *bad])
