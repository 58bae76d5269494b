"""The serving engines on the MoE attention-family configs against the JAX
engines on the CPU (fp32): `SiDAEngine` and `SiDADecodeEngine` (ring and
paged, fp slots and hot int8 / warm int4 tiers) on the narrow deepseek
(top-6 of 16, two shared experts that stay resident) and qwen3 (top-8 of
16, GQA group 16) configs of `tests/test_torch_models.py`: the same hash
ids, slot traces, logits or tokens, per-step loads and store counters;
and the batch engine at the published expert counts (64 top-6, 128 top-8)
with tiny widths."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TierConfig as JTier
from repro.core import decode_engine as jd
from repro.core import residency as jr
from repro.core.engine import SiDAEngine as JEngine
from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import TierConfig
from repro_torch.core import decode_engine as td
from repro_torch.core import residency as tr
from repro_torch.core.engine import SiDAEngine
from test_torch_models import NARROW, WIDE_E, system

torch.set_num_threads(2)
TOL = 1e-4
COUNTERS = ("loads", "hits", "evictions", "promotions", "demotions", "dropped", "bytes_h2d")

_HASH: dict = {}


def _hash(name):
    """The narrow system with a seeded hash predictor (d_h 16), cached."""
    if name not in _HASH:
        cfg_j, cfg_t, pj, pt = system(name)
        hj = jax.tree.map(np.asarray, j_init_hash_fn(
            jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j), cfg_j.moe.num_experts,
            d_h=16))
        _HASH[name] = (cfg_j, cfg_t, pj, hj, pt, params_from_numpy(hj))
    return _HASH[name]


def _record(engine, batch=True):
    """Log the tables the engine builds (batch) and each slot trace its store
    prepares."""
    tables, traces = [], []
    prepare = engine.store.prepare

    def rec_prepare(table):
        trans = prepare(table)
        traces.append(np.array(trans, copy=True))
        return trans

    engine.store.prepare = rec_prepare
    if batch:
        build = engine.build_table

        def rec_build(j, toks):
            t = build(j, toks)
            tables.append(t)
            return t

        engine.build_table = rec_build
    return tables, traces


def _same_store(et, ej):
    for f in COUNTERS:
        assert getattr(et.store.stats, f) == getattr(ej.store.stats, f), f
    assert et.store.resident == ej.store.resident


@pytest.mark.parametrize("name", NARROW + WIDE_E)
def test_batch_engine_matches_jax(name):
    """The narrow configs at 8 slots of 16; deepseek's 64 experts top-6 and
    qwen3's 128 top-8 (tiny widths) at a quarter of them, as phase 10
    serves them."""
    cfg_j, cfg_t, pj, hj, pt, ht = _hash(name)
    E = cfg_t.moe.num_experts
    slots = 8 if E == 16 else E // 4
    batches = [np.random.default_rng(10 + i).integers(0, cfg_t.vocab_size, (2, 16))
               .astype(np.int32) for i in range(3)]
    ej = JEngine(cfg_j, pj, hj, slots_per_layer=slots)
    et = SiDAEngine(cfg_t, pt, ht, slots_per_layer=slots, device="cpu")
    (tj, sj), (tt, st) = _record(ej), _record(et)
    ej.serve(batches, threaded=False)
    et.serve(batches, threaded=False)
    for a, b in zip(et.results, ej.results):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=TOL)
    assert len(tt) == len(tj) == 3 and len(st) == len(sj) == 3
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(a.expert_ids, b.expert_ids)
        np.testing.assert_allclose(a.weights, b.weights, atol=1e-5)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    _same_store(et, ej)
    assert et.store.stats.evictions > 0           # the budget binds
    # the shared experts stay with the dense weights, resident and counted
    # there: the saving is over the routed experts alone, 1 - slots / E
    assert et.memory_saving() == ej.memory_saving()
    assert et.memory_saving()["reduction"] == pytest.approx(1 - slots / E)
    assert et.device_memory_bytes() == ej.device_memory_bytes()
    moe = et.store.serve_params["blocks"]["sub0"]["moe"]
    assert ("shared_w_in" in moe) == (cfg_t.moe.num_shared_experts > 0)
    et.close()
    ej.close()


TIER = dict(quantized_slots=True, eviction="alpha",
            tier=TierConfig(int4_slots=True, warm_slots=4))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("slots", ["fp", "tiers"])
@pytest.mark.parametrize("name", NARROW)
def test_decode_engine_matches_jax(name, slots, paged):
    """Three lanes, 12 steps, 6 slots a layer (the tiered store: 6 int8 hot
    plus 4 int4 warm), over a 32-slot ring or pages of 4."""
    cfg_j, cfg_t, pj, hj, pt, ht = _hash(name)
    kw = dict(TIER) if slots == "tiers" else {}
    start = np.array([1, 2, 3], np.int32)
    page_cfg = tr.PagedKVConfig(page_size=4, kv_pages=24) if paged else None
    et = td.SiDADecodeEngine(cfg_t, pt, ht, slots_per_layer=6, device="cpu", **kw)
    if "tier" in kw:
        kw["tier"] = JTier(**dataclasses.asdict(kw["tier"]))
    ej = jd.SiDADecodeEngine(cfg_j, pj, hj, slots_per_layer=6, **kw)
    (_, st), (_, sj) = _record(et, batch=False), _record(ej, batch=False)
    ot, mt = et.generate(start, steps=12, cache_len=32, paged=page_cfg)
    oj, mj = ej.generate(start, steps=12, cache_len=32,
                         paged=None if page_cfg is None
                         else jr.PagedKVConfig(**dataclasses.asdict(page_cfg)))
    np.testing.assert_array_equal(ot, oj)
    assert mt.loads_per_step == mj.loads_per_step
    assert sum(mt.loads_per_step[1:]) > 0           # the budget binds after step 0
    assert len(st) == len(sj) == 12
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(a, b)
    _same_store(et, ej)
    if slots == "tiers":
        assert et.store.S4 == 4 and et.store.stats.demotions > 0
    et.close()
    ej.close()


def test_baselines_with_shared_experts():
    """Standard and OnDemand on the narrow deepseek config equal the JAX
    baselines. PrefetchAll adds the shared experts once, so it equals
    Standard; the reference's runs the whole layer each wave of slots and
    adds them once a wave (ROADMAP C14), which shows here as a difference
    from its own Standard. Top-1 at capacity factor 100: a wave routes the
    tokens of the other waves' experts to slot 0 at weight 0, one
    assignment a token, so no real assignment overflows (at top-k > 1 they
    would, in both packages: C9)."""
    from repro.core import baselines as jb
    from repro_torch.core import baselines as tb

    cfg_j, cfg_t, pj, _, pt, _ = _hash("deepseek-narrow")
    cfg_j, cfg_t = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=100.0,
                                                                   top_k=1))
                    for c in (cfg_j, cfg_t))
    toks = np.random.default_rng(20).integers(0, cfg_t.vocab_size, (2, 12)).astype(np.int32)
    std_j = np.asarray(jb.StandardServer(cfg_j, pj)._fwd(pj, toks))
    std_t = tb.StandardServer(cfg_t, pt, device="cpu")._fwd(toks).numpy()
    np.testing.assert_allclose(std_t, std_j, atol=TOL, rtol=TOL)
    # OnDemand with a slot for each expert: nothing dropped, as Standard
    od_j = np.asarray(jb.OnDemandServer(cfg_j, pj, slots_per_layer=16)._forward_batch(toks))
    od_t = tb.OnDemandServer(cfg_t, pt, slots_per_layer=16, device="cpu")._forward_batch(toks)
    np.testing.assert_allclose(od_t.numpy(), od_j, atol=TOL, rtol=TOL)
    pf_t = tb.PrefetchAllServer(cfg_t, pt, slots_per_layer=4, device="cpu")._forward_batch(toks)
    pf_j = np.asarray(jb.PrefetchAllServer(cfg_j, pj, slots_per_layer=4)._forward_batch(toks))
    # the baselines' `_final` neither softcaps nor masks: compare the vocab
    V = cfg_t.vocab_size
    np.testing.assert_allclose(pf_t.numpy()[..., :V], od_t.numpy()[..., :V], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pf_t.numpy()[..., :V], std_t[..., :V], atol=1e-3, rtol=1e-3)
    assert np.abs(pf_j[..., :V] - std_j[..., :V]).max() > 1e-2
