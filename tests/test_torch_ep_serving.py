"""The port's expert-parallel serving against the JAX package's on the CPU:
`RequestServer`, `SiDADecodeEngine` and `SiDAEngine` with `ep_shards` 2
and 4 over `tests/test_ep_serving.py`'s `_e8_system` geometry (reduced
Switch, 8 experts, top-1, capacity 4), the JAX objects sharded the same way
with `ShardingCtx()` (no mesh: its dispatch runs over the global slot ids
on one device, which the reference pins as byte-identical to its shard_map
dispatch at top-1), the port's through its expert-parallel dispatch.

This file: pre-admitted synchronous servers at slots < E (one
deterministic schedule). Tokens, the store's counters (loads, hits,
evictions, drops, bytes, `replica_loads`, `rebalance_moves`), residency,
replicas, homes and the summary's shard fields equal the JAX server's, fp
and int8 slots, vanilla and speculative, and with `replicate_hot=1` and a
rebalance round on every loop iteration. `test_torch_ep_async.py` streams
requests through the per-shard transfer queues; `test_torch_ep_engines.py`
holds the tiered server, the decode and batch engines and the launcher.
The other two import their helpers from here.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TierConfig as JTierConfig
from repro.configs.base import get_config as jget_config
from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
from repro.core.offload import ShardedStoreConfig as JSharded
from repro.core.residency import PagedKVConfig as JPaged
from repro.models.attention import ShardingCtx as JShardingCtx
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro.serving import Request as JRequest
from repro.serving import RequestServer as JRequestServer
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core.offload import ShardedStoreConfig
from repro_torch.core.residency import PagedKVConfig
from repro_torch.serving import Request, RequestServer, poisson_requests

torch.set_num_threads(2)
COUNTERS = ("loads", "hits", "evictions", "dropped", "bytes_h2d", "replica_loads",
            "rebalance_moves")
SHARD_FIELDS = ("replicate_hot", "replica_loads", "rebalance_moves")


def _e8_cfg(get):
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8, d_expert=64, capacity_factor=4.0))


@pytest.fixture(scope="module")
def e8():
    """(cfg_j, cfg_t, JAX params, JAX hash params with the draft head, port
    params, port hash params): `_e8_system(draft=True)`'s seeds."""
    cfg_j, cfg_t = _e8_cfg(jget_config), _e8_cfg(get_config)
    pj = j_init_params(jax.random.PRNGKey(0), cfg_j)
    hj = j_init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j),
                        cfg_j.moe.num_experts, d_h=16, draft=True)
    pj, hj = jax.tree.map(np.asarray, pj), jax.tree.map(np.asarray, hj)
    return cfg_j, cfg_t, pj, hj, params_from_numpy(pj), params_from_numpy(hj)


def _requests(cfg, n=5, seed=7):
    """`tests/test_ep_serving.py::_request_stream`."""
    return poisson_requests(np.random.default_rng(seed), n, rate_rps=1e6,
                            vocab_size=cfg.vocab_size, prompt_len_range=(4, 14),
                            max_new_range=(4, 8))


def _serve(side, e8, ep, reqs, pre_admit=True, replicate_hot=0, tier=None, paged=None,
           capacity_factor=None, **kw):
    """One server of `side` ("jax" / "port") over `reqs`, closed after the
    run; `ep` shards (1: unsharded). `capacity_factor` overrides the
    config's (100: capacity never binds, so a token's output does not
    depend on which requests share its prefill batch)."""
    cfg_j, cfg_t, pj, hj, pt, ht = e8
    if capacity_factor is not None:
        cfg_j, cfg_t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (cfg_j, cfg_t))
    kw = dict(dict(max_lanes=3, max_prefill_batch=3, buckets=(8, 16)), **kw)
    if paged is None:
        kw.setdefault("cache_len", 32)
    if side == "jax":
        if ep > 1:
            kw["sharded"] = JSharded(ep_shards=ep, replicate_hot=replicate_hot)
        if tier is not None:
            kw["tier"] = JTierConfig(**tier)
        if paged is not None:
            kw["paged"] = JPaged(**paged)
        srv = JRequestServer(cfg_j, pj, hj, ctx=JShardingCtx(), **kw)
        reqs = [JRequest(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                         arrival_s=r.arrival_s) for r in reqs]
    else:
        if ep > 1:
            kw["sharded"] = ShardedStoreConfig(ep_shards=ep, replicate_hot=replicate_hot)
        if tier is not None:
            kw["tier"] = TierConfig(**tier)
        if paged is not None:
            kw["paged"] = PagedKVConfig(**paged)
        srv = RequestServer(cfg_t, pt, ht, device="cpu", **kw)
        reqs = [Request(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                        arrival_s=r.arrival_s) for r in reqs]
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
    return srv


def _tokens(srv):
    return {r.rid: list(r.generated) for r in srv.completed}


def _same_counters(got, want):
    for f in COUNTERS:
        assert getattr(got.store.stats, f) == getattr(want.store.stats, f), f
    sg, sw = got.summary(), want.summary()
    for key in SHARD_FIELDS:
        assert sg[key] == sw[key], key
    assert got.store.resident == want.store.resident
    assert got.store.replicas == want.store.replicas
    np.testing.assert_array_equal(got.store.home, want.store.home)


# ---------------------------------------------------------------------------
# the request server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("ep", [2, 4])
def test_ep_server_matches_jax_under_slot_pressure(e8, ep, quantized):
    """4 slots of 8 (2 or 1 a shard), pre-admitted, synchronous."""
    reqs = _requests(e8[1])
    kw = dict(slots_per_layer=4, quantized_slots=quantized)
    got = _serve("port", e8, ep, reqs, **kw)
    want = _serve("jax", e8, ep, reqs, **kw)
    assert len(got.completed) == 5 and _tokens(got) == _tokens(want)
    _same_counters(got, want)
    assert got.store.stats.evictions > 0 and got.ctx.ep_shards == ep


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_server_replicas_and_rebalancing_match_jax(e8, ep):
    """`replicate_hot=1` with a rebalance round on every loop iteration,
    6 slots (2E copies would hold everything): the replicas, the moves,
    the homes and the tokens equal the JAX server's."""
    reqs = _requests(e8[1], n=6, seed=11)
    kw = dict(slots_per_layer=ep * 2 if ep == 4 else 6, replicate_hot=1,
              rebalance_interval=1e-6, eviction="lru")
    got = _serve("port", e8, ep, reqs, **kw)
    want = _serve("jax", e8, ep, reqs, **kw)
    assert _tokens(got) == _tokens(want)
    _same_counters(got, want)
    counters = got.telemetry.snapshot()["counters"]
    wcounters = want.telemetry.snapshot()["counters"]
    for key in ("rebalance_moves", "rebalance_rounds", "expert_replica_loads"):
        assert counters.get(key) == wcounters.get(key), key
    assert got.store.stats.replica_loads > 0 and got.store.stats.rebalance_moves > 0


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_server_speculative_matches_jax(e8, ep):
    reqs = _requests(e8[1], n=4)
    kw = dict(slots_per_layer=4, spec_mode="draft", spec_k=2)
    got = _serve("port", e8, ep, reqs, **kw)
    want = _serve("jax", e8, ep, reqs, **kw)
    assert _tokens(got) == _tokens(want)
    _same_counters(got, want)
    assert got.summary()["spec_acceptance_rate"] == want.summary()["spec_acceptance_rate"]
