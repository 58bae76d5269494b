"""Port `ExpertStore` against `repro.core.offload.ExpertStore` on one table
stream: the same translation tables, resident sets, loads / hits /
evictions / drops and H2D bytes for every eviction policy, with pinning,
plus the uploaded slot contents and the miss-renormalised translation."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.hash_table import HashTable as JHashTable
from repro.core.offload import ExpertStore as JStore
from repro.models.transformer import init_params as j_init_params
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.hash_table import HashTable
from repro_torch.core.offload import ExpertStore

torch.set_num_threads(2)


def _cfgs():
    out = []
    for get in (jget_config, get_config):
        base = get("switch-base-8").reduced()
        out.append(dataclasses.replace(
            base, n_layers=4, moe=dataclasses.replace(base.moe, num_experts=8, d_expert=32),
        ))
    return out


@pytest.fixture(scope="module")
def system():
    cfg_j, cfg_t = _cfgs()
    pj = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg_j))
    return cfg_j, cfg_t, pj, params_from_numpy(pj)


def _tables(n, L, E, seed=0):
    """A skewed stream: each batch draws from a drifting subset of experts."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        hot = rng.choice(E, size=rng.integers(2, E + 1), replace=False)
        ids = rng.choice(hot, size=(L, 2, 6, 1)).astype(np.int32)
        w = rng.random((L, 2, 6, 1)).astype(np.float32)
        out.append((j, ids, w))
    return out


def _assert_same_state(sj, st):
    assert st.resident == sj.resident
    for f in ("bytes_h2d", "loads", "evictions", "hits", "dropped"):
        assert getattr(st.stats, f) == getattr(sj.stats, f), f


@pytest.mark.parametrize("eviction", ["fifo", "lru", "alpha"])
def test_store_matches_jax_on_table_stream(system, eviction):
    cfg_j, cfg_t, pj, pt = system
    sj = JStore(cfg_j, pj, slots_per_layer=3, eviction=eviction)
    st = ExpertStore(cfg_t, pt, slots_per_layer=3, eviction=eviction, device="cpu")
    sj.pin_experts(1, [5])
    st.pin_experts(1, [5])
    for j, ids, w in _tables(12, sj.L, sj.E):
        tj, tt = JHashTable(j, ids, w), HashTable(j, ids, w)
        assert st.cache_affinity(tt) == sj.cache_affinity(tj)
        trans_j, trans_t = sj.prepare(tj), st.prepare(tt)
        np.testing.assert_array_equal(trans_t, trans_j)
        _assert_same_state(sj, st)
        for a, b in zip(st.translate(tt, trans_t), sj.translate(tj, trans_j)):
            np.testing.assert_array_equal(a, b)
    # the slots hold the resident experts' weights, bit for bit
    for (g, s), res in st.resident.items():
        pool = st.serve_params["blocks"][f"sub{s}"]["moe"]
        for e, slot in res.items():
            for t in ("w_in", "w_gate", "w_out"):
                np.testing.assert_array_equal(
                    pool[t][g, slot].numpy(), pj["blocks"][f"sub{s}"]["moe"][t][g, e])


def test_drops_when_every_victim_is_protected(system):
    cfg_j, cfg_t, pj, pt = system
    sj = JStore(cfg_j, pj, slots_per_layer=2)
    st = ExpertStore(cfg_t, pt, slots_per_layer=2, device="cpu")
    for store in (sj, st):
        store.pin_experts(0, [0, 1])
    stream = [(0, [0, 1]), (1, [2, 3, 0])]
    for j, experts in stream:
        ids = np.array(experts * 4, np.int32)[: 8].reshape(1, 1, 8, 1)
        ids = np.broadcast_to(ids, (sj.L, 1, 8, 1)).copy()
        w = np.ones_like(ids, np.float32)
        trans_j = sj.prepare(JHashTable(j, ids, w))
        trans_t = st.prepare(HashTable(j, ids, w))
        np.testing.assert_array_equal(trans_t, trans_j)
    assert st.stats.dropped == sj.stats.dropped > 0
    _assert_same_state(sj, st)
    # per-layer OnDemand path
    np.testing.assert_array_equal(st.prepare_layer(1, np.array([4, 5, 6])),
                                  sj.prepare_layer(1, np.array([4, 5, 6])))
    _assert_same_state(sj, st)
    # unpinned experts become victims again: the same loads now land
    for store in (sj, st):
        store.unpin_experts(0, [0, 1])
    trans_j = sj.prepare(JHashTable(2, ids, w))
    np.testing.assert_array_equal(st.prepare(HashTable(2, ids, w)), trans_j)
    _assert_same_state(sj, st)
    assert st.stats.evictions > 0


def test_byte_accounting_matches_jax(system):
    cfg_j, cfg_t, pj, pt = system
    sj = JStore(cfg_j, pj, slots_per_layer=3)
    st = ExpertStore(cfg_t, pt, slots_per_layer=3, device="cpu")
    assert st.device_bytes() == sj.device_bytes()
    assert st.full_expert_bytes() == sj.full_expert_bytes()
    assert st.expert_slot_bytes() == sj.expert_slot_bytes()
    assert "router" not in st.serve_params["blocks"]["sub1"]["moe"]
