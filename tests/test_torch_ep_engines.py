"""Expert-parallel serving on the CPU against the JAX package's, continued
(see `test_torch_ep_serving.py` for the geometry and the JAX side): the
tiered EP server of `tests/test_tiering.py`, `SiDADecodeEngine` at
slots < E (tokens, loads a step, counters and `uploads_by_shard` equal the
JAX sharded decode engine's, sync and async, fp and int8), every expert
resident in fp32 (EP-2 and EP-4 decode tokens and batch-engine logits
equal the one-device engines' bit for bit), and the launcher's
`--ep-shards`, `--replicate-hot` and `--rebalance-interval`.
"""
import numpy as np
import pytest
import torch

from repro.core.decode_engine import SiDADecodeEngine as JDecodeEngine
from repro.core.engine import SiDAEngine as JEngine
from repro.core.offload import ShardedStoreConfig as JSharded
from repro_torch.core.decode_engine import SiDADecodeEngine
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.offload import ShardedStoreConfig
from repro_torch.launch import serve as tserve
from test_torch_ep_serving import (  # noqa: F401
    COUNTERS,
    _requests,
    _same_counters,
    _serve,
    _tokens,
    e8,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_server_tiered_matches_single_device(e8, ep):
    """`tests/test_tiering.py::test_ep2_server_tiered_matches_single_device`:
    a fully resident tiered set (4 hot + 4 warm) under EP gives the
    one-device tiered server's tokens, and the JAX sharded server's."""
    reqs = _requests(e8[1])
    kw = dict(slots_per_layer=4, quantized_slots=True,
              tier=dict(int4_slots=True, warm_slots=4))
    got = _serve("port", e8, ep, reqs, **kw)
    want = _serve("jax", e8, ep, reqs, **kw)
    assert got.store.S4 == 4 and got.store.S4_loc == 4 // ep
    assert _tokens(got) == _tokens(_serve("port", e8, 1, reqs, **kw)) == _tokens(want)
    _same_counters(got, want)


@pytest.mark.parametrize("prefetch_depth", [0, 2], ids=["sync", "async"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("ep", [2, 4])
def test_ep_decode_engine_matches_jax(e8, ep, quantized, prefetch_depth):
    """4 slots of 8: tokens, loads a step, the store's state and counters,
    and the per-shard uploads equal the JAX sharded decode engine's."""
    cfg_j, cfg_t, pj, hj, pt, ht = e8
    start = np.array([3, 5, 11], np.int32)
    kw = dict(slots_per_layer=4, quantized_slots=quantized, prefetch_depth=prefetch_depth)
    et = SiDADecodeEngine(cfg_t, pt, ht, device="cpu",
                          sharded=ShardedStoreConfig(ep_shards=ep), **kw)
    ej = JDecodeEngine(cfg_j, pj, hj, sharded=JSharded(ep_shards=ep), **kw)
    try:
        ot, mt = et.generate(start, 10, cache_len=16)
        oj, mj = ej.generate(start, 10, cache_len=16)
        np.testing.assert_array_equal(ot, oj)
        assert mt.loads_per_step == mj.loads_per_step
        for f in COUNTERS:
            assert getattr(et.store.stats, f) == getattr(ej.store.stats, f), f
        assert et.store.resident == ej.store.resident
        if prefetch_depth:
            assert et.prefetcher.stats.uploads_by_shard == ej.prefetcher.stats.uploads_by_shard
            assert len(et.prefetcher.stats.uploads_by_shard) > 1
    finally:
        et.close()
        ej.close()


def test_ep_engines_all_resident_equal_one_device(e8):
    """fp32, every expert resident: EP-2 and EP-4 decode tokens equal the
    one-device decode engine's, and the batch engine's EP logits equal its
    one-device logits bit for bit and the JAX sharded engine's within
    1e-5."""
    cfg_j, cfg_t, pj, hj, pt, ht = e8
    start = np.array([3, 5], np.int32)
    outs = []
    for ep in (1, 2, 4):
        sharded = ShardedStoreConfig(ep_shards=ep) if ep > 1 else None
        eng = SiDADecodeEngine(cfg_t, pt, ht, slots_per_layer=8, device="cpu", sharded=sharded)
        outs.append(eng.generate(start, 8, cache_len=16)[0])
        eng.close()
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[2], outs[0])

    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg_t.vocab_size, (2, 8)).astype(np.int32) for _ in range(2)]
    logits = []
    for ep in (1, 2, 4):
        sharded = ShardedStoreConfig(ep_shards=ep) if ep > 1 else None
        eng = SiDAEngine(cfg_t, pt, ht, slots_per_layer=8, device="cpu", sharded=sharded)
        eng.serve(batches, threaded=False)
        logits.append([r.numpy() for r in eng.results])
        eng.close()
    assert eng.ctx.ep_shards == 4
    ej = JEngine(cfg_j, pj, hj, slots_per_layer=8, sharded=JSharded(ep_shards=4))
    ej.serve(batches, threaded=False)
    for one, ep2, ep4, jax_ep4 in zip(*logits, ej.results):
        np.testing.assert_array_equal(ep2, one)
        np.testing.assert_array_equal(ep4, one)
        np.testing.assert_allclose(ep4, np.asarray(jax_ep4), atol=1e-5, rtol=1e-5)
    ej.close()


def test_launcher_serves_expert_parallel(e8, capsys):
    """`python -m repro_torch.launch.serve --ep-shards 2 --replicate-hot 1
    --rebalance-interval ...` on the CPU: the batch engine and the server."""
    tserve.main(["--device", "cpu", "--engine", "sida", "--slots", "2", "--batches", "2",
                 "--batch", "2", "--seq", "8", "--ep-shards", "2"])
    out = capsys.readouterr().out
    assert "replica_loads=" in out and "throughput_tok_s" in out
    tserve.main(["--device", "cpu", "--engine", "server", "--requests", "3", "--rate", "8",
                 "--lanes", "2", "--new-tokens", "3", "--seq", "12", "--no-realtime",
                 "--slots", "4", "--ep-shards", "2", "--replicate-hot", "1",
                 "--rebalance-interval", "0.001", "--prefetch-depth", "2"])
    out = capsys.readouterr().out
    assert "ep_shards=2" in out and "prefetch_uploads_shard1" in out
    assert "shard_upload_max_over_mean" in out
    ctx, sharded = tserve.ep_setup(4, 1, "cpu")
    assert ctx.ep_shards == 4 and sharded.replicate_hot == 1
    assert tserve.ep_setup(1)[1] is None
