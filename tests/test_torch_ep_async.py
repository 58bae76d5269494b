"""Expert-parallel request servers fed as a stream, through the per-shard
transfer queues, on the CPU, against the JAX package's (see
`test_torch_ep_serving.py` for the geometry and the JAX side).

Streamed and through the async pipeline the schedule is timing-dependent:
the hash thread races the serve loop, so which requests share a prefill
batch varies, and at capacity factor 4 a batch's capacity decides which
tokens drop (both packages show it, unsharded too). These runs hold every
expert resident, as the reference's EP differentials do, at capacity
factor 100: tokens equal the JAX server's and the port's one-device
server's, fp and int8 slots, with replicas and rebalancing, speculative;
every shard's queue uploaded. Paged K/V under EP-2 gives the ring's
tokens, page-ins riding shard 0's queue
(`tests/test_paged_kv.py::test_ep2_server_paged_matches_ring`).
"""
import pytest

from test_torch_ep_serving import _requests, _serve, _tokens, e8  # noqa: F401


@pytest.mark.parametrize("case", ["fp", "int8", "replicas", "spec"])
@pytest.mark.parametrize("ep", [2, 4])
def test_ep_server_async_all_resident(e8, ep, case):
    """Through the per-shard transfer queues, every expert resident (2E
    slots with replicas): the tokens of the JAX server and of the port's
    one-device server; every shard's queue uploaded."""
    reqs = _requests(e8[1], n=4 if case == "spec" else 5)
    kw = dict(slots_per_layer=8, prefetch_depth=2)
    if case == "int8":
        kw["quantized_slots"] = True
    if case == "replicas":
        kw.update(slots_per_layer=16, replicate_hot=1, rebalance_interval=0.005)
    if case == "spec":
        kw.update(spec_mode="draft", spec_k=2)
    kw["capacity_factor"] = 100.0
    got = _serve("port", e8, ep, reqs, pre_admit=False, **kw)
    want = _serve("jax", e8, ep, reqs, pre_admit=False, **kw)
    one = {k: v for k, v in kw.items() if k not in ("replicate_hot", "rebalance_interval")}
    single = _serve("port", e8, 1, reqs, pre_admit=False, **one)
    assert _tokens(got) == _tokens(want) == _tokens(single)
    ups = got.prefetch.stats.uploads_by_shard
    assert len(got.prefetch._threads) == ep and sorted(ups) == list(range(ep))
    s = got.summary()
    assert [s[k] for k in ("replicate_hot",)] == [float(kw.get("replicate_hot", 0))]
    assert s["shard_upload_max_over_mean"] >= 1.0
    assert sum(ups.values()) == got.prefetch.stats.uploads
    if case == "replicas":
        assert got.store.R == 2


@pytest.mark.parametrize("prefetch_depth", [0, 2], ids=["sync", "async"])
def test_ep2_server_paged_matches_ring(e8, prefetch_depth):
    """`tests/test_paged_kv.py::test_ep2_server_paged_matches_ring`: under
    EP-2, paged K/V gives the ring's tokens (page-ins ride shard 0's
    queue when async), and the JAX paged EP-2 server's."""
    reqs = _requests(e8[1])
    kw = dict(slots_per_layer=8, prefetch_depth=prefetch_depth, capacity_factor=100.0)
    paged = dict(page_size=8, kv_pages=16)
    ring = _serve("port", e8, 2, reqs, pre_admit=False, **kw)
    got = _serve("port", e8, 2, reqs, pre_admit=False, paged=paged, **kw)
    want = _serve("jax", e8, 2, reqs, pre_admit=False, paged=paged, **kw)
    assert _tokens(got) == _tokens(ring) == _tokens(want)
    assert got.summary()["paged_kv"] == 1.0


def test_batch_composition_decides_dropped_tokens(e8):
    """ROADMAP C16, pinned on one schedule each: the same requests
    pre-admitted into prefill batches of 3 and of 1, every expert resident,
    unsharded. At capacity factor 4 a batch's capacity decides which tokens
    overflow a slot, so the two schedules give different tokens, in both
    packages alike (each package equals the other on each schedule); at 100
    nothing overflows and the schedules agree. A streamed run's schedule
    depends on the hash thread's timing, so the reference's streamed EP
    differentials at factor 4 compare two draws of it."""
    reqs = _requests(e8[1])
    got = {(side, mpb): _tokens(_serve(side, e8, 1, reqs, slots_per_layer=8,
                                       max_prefill_batch=mpb))
           for side in ("jax", "port") for mpb in (3, 1)}
    assert got[("port", 3)] == got[("jax", 3)] and got[("port", 1)] == got[("jax", 1)]
    assert got[("port", 3)] != got[("port", 1)]
    wide = [_tokens(_serve("port", e8, 1, reqs, slots_per_layer=8, max_prefill_batch=mpb,
                           capacity_factor=100.0)) for mpb in (3, 1)]
    assert wide[0] == wide[1]
