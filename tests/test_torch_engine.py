"""The port's whole batch-serving path against `repro.core.engine.SiDAEngine`
on the committed trained miniature `experiments/cache/sys_E8/{model,hash}`:
the same hash tables, the same slot traces and store counters, logits within
fp32 tolerance, for sequential, threaded and lookahead=2 serving, and equal
memory accounting. Also the checkpoint reader and the weight carry."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as j_load_checkpoint
from repro.configs.base import get_config as jget_config
from repro.core.engine import SiDAEngine as JEngine
from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro.models.attention import ShardingCtx
from repro_torch.checkpoint import load_checkpoint, params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.engine import SiDAEngine
from repro_torch.models.transformer import forward
from repro_torch.tree import flatten

torch.set_num_threads(2)
CK = os.path.join(os.path.dirname(__file__), "..", "experiments", "cache", "sys_E8")
TOL = 1e-4


def _e8_cfg(get):
    """The miniature Switch the benchmarks train (benchmarks/common.py::bench_cfg(8))."""
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(
        cfg, n_layers=4, d_ff=128,
        moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=1, capacity_factor=4.0,
                                d_expert=512),
    )


@pytest.fixture(scope="module")
def e8():
    cfg_j, cfg_t = _e8_cfg(jget_config), _e8_cfg(get_config)
    pj, _ = j_load_checkpoint(os.path.join(CK, "model"),
                              like=j_init_params(jax.random.PRNGKey(0), cfg_j))
    hj, _ = j_load_checkpoint(
        os.path.join(CK, "hash"),
        like=j_init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j), 8, d_h=32),
    )
    pj, hj = jax.tree.map(np.asarray, pj), jax.tree.map(np.asarray, hj)
    return cfg_j, cfg_t, pj, hj, params_from_numpy(pj), params_from_numpy(hj)


def test_checkpoint_reader_equals_weight_carry(e8):
    _, _, pj, _, pt, _ = e8
    loaded, manifest = load_checkpoint(os.path.join(CK, "model"))
    a, b = flatten(loaded), flatten(pt)
    assert sorted(a) == sorted(b) == sorted(manifest["keys"])
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32
        assert torch.equal(a[k], b[k]), k


def test_forward_router_mode_matches_jax(e8):
    cfg_j, cfg_t, pj, _, pt, _ = e8
    toks = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (2, 20)).astype(np.int32)
    oj = j_forward(pj, cfg_j, ShardingCtx(), toks, collect_router_logits=True)
    ot = forward(pt, cfg_t, torch.from_numpy(toks), collect_router_logits=True)
    np.testing.assert_allclose(ot["logits"].numpy(), np.asarray(oj["logits"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ot["router_logits"].numpy(), np.asarray(oj["router_logits"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(ot["aux_loss"]), float(oj["aux_loss"]), rtol=1e-4)


def _record(engine):
    """Wrap the engine's table build and slot prepare to log what they return."""
    tables, traces = [], []
    build, prepare = engine.build_table, engine.store.prepare

    def rec_build(j, toks):
        t = build(j, toks)
        tables.append(t)
        return t

    def rec_prepare(table):
        trans = prepare(table)
        traces.append((table.batch_index, trans.copy()))
        return trans

    engine.build_table, engine.store.prepare = rec_build, rec_prepare
    return tables, traces


def test_engine_matches_jax_on_e8(e8):
    cfg_j, cfg_t, pj, hj, pt, ht = e8
    batches = [np.random.default_rng(i).integers(0, cfg_t.vocab_size, (2, 24)).astype(np.int32)
               for i in range(5)]
    ej = JEngine(cfg_j, pj, hj, slots_per_layer=4)
    et = SiDAEngine(cfg_t, pt, ht, slots_per_layer=4, device="cpu")
    rec_j, rec_t = _record(ej), _record(et)
    # one engine each, three serves in a row: the store state carries over,
    # so every mode is compared from the same residency
    for kw in (dict(threaded=False), dict(threaded=True), dict(threaded=True, lookahead=2)):
        ej.serve(batches, **kw)
        et.serve(batches, **kw)
        for a, b in zip(et.results, ej.results):
            np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=TOL)
    (tj, sj), (tt, st) = rec_j, rec_t
    assert len(tt) == len(tj) == 15 and len(st) == len(sj) == 15
    for a, b in zip(tt, tj):
        assert a.batch_index == b.batch_index
        np.testing.assert_array_equal(a.expert_ids, b.expert_ids)
        np.testing.assert_allclose(a.weights, b.weights, atol=1e-5)
    for (ia, ta), (ib, tb) in zip(st, sj):
        assert ia == ib
        np.testing.assert_array_equal(ta, tb)
    for f in ("bytes_h2d", "loads", "evictions", "hits", "dropped"):
        assert getattr(et.store.stats, f) == getattr(ej.store.stats, f), f
    assert et.store.stats.evictions > 0          # the budget really binds
    assert et.memory_saving() == ej.memory_saving()
    assert et.device_memory_bytes() == ej.device_memory_bytes()

    # prefill: logits plus every layer's rope-applied K/V, same table
    toks = batches[0]
    lj, kvj = ej.prefill(toks, tj[0])
    lt, kvt = et.prefill(toks, tt[0])
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    assert sorted(kvt) == sorted(kvj)
    for sub in kvj:
        for a, b in zip(kvt[sub], kvj[sub]):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def test_engine_surfaces_inference_errors(e8):
    _, cfg_t, _, _, pt, ht = e8
    eng = SiDAEngine(cfg_t, pt, ht, slots_per_layer=2, device="cpu")
    bad = [np.zeros((1, 8), np.int32), np.full((1, 8), 10**6, np.int32)]   # out-of-vocab ids
    with pytest.raises(IndexError):
        eng.serve(bad, threaded=True)
