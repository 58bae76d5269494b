"""The port's request server against the JAX one on the CPU, tokens per
request on the same weights (through `params_from_numpy`): mirrors of
`tests/test_serving.py`'s server tests (prefill logits against the batch
engine, decode against a teacher-forced forward, continuous batching
transparent, expired requests dropped), a ring lane released and reused by
a shorter prompt (the port's decode writes a masked ring lane's K/V in place
at its stale position), and a run on the trained miniature
`experiments/cache/sys_E8` with its committed draft head, spec on and off,
synchronous and pre-admitted, where the tokens, the expert loads and
`bytes_h2d` equal the JAX server's. The `gpu` cases run one server at
phase 9a's settings on the card (JAX is imported only inside the CPU
differentials' fixtures, so they run where JAX is absent:
`python -m pytest --noconftest -m gpu tests/test_torch_server.py`).
Tolerance: 1e-5 on fp32 logits; tokens, loads and counters exactly."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.decode_engine import hash_fn_step
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.core.hash_table import HashTable
from repro_torch.core.offload import ExpertStore
from repro_torch.models.layers import top_k
from repro_torch.models.transformer import forward, init_params, n_moe_layers
from repro_torch.serving import Request, RequestServer, RequestState, poisson_requests

torch.set_num_threads(2)
CK = os.path.join(os.path.dirname(__file__), "..", "experiments", "cache", "sys_E8")
TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


class _Ref:
    """The JAX package's pieces, imported on first use."""

    def __init__(self):
        import jax

        from repro.configs.base import get_config as jget_config
        from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
        from repro.models.transformer import init_params as j_init_params
        from repro.models.transformer import n_moe_layers as j_n_moe_layers
        from repro.serving import Request as JRequest
        from repro.serving import RequestServer as JRequestServer

        self.jax, self.get_config = jax, jget_config
        self.init_hash_fn, self.init_params = j_init_hash_fn, j_init_params
        self.n_moe_layers = j_n_moe_layers
        self.Request, self.RequestServer = JRequest, JRequestServer


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def _tiny_cfg(get):
    """tests/test_serving.py's `tiny_moe`: 2 layers, capacity never binding."""
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(cfg, n_layers=2,
                               moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


@pytest.fixture(scope="module")
def tiny(ref):
    """(cfg_j, cfg_t, JAX params, JAX hash params, port params, port hash
    params): the reference's seeds, d_h 16, with the draft head."""
    jax = ref.jax
    cfg_j, cfg_t = _tiny_cfg(ref.get_config), _tiny_cfg(get_config)
    pj = ref.init_params(jax.random.PRNGKey(0), cfg_j)
    hj = ref.init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, ref.n_moe_layers(cfg_j),
                          cfg_j.moe.num_experts, d_h=16, draft=True)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj))
    ht = params_from_numpy(jax.tree.map(np.asarray, hj))
    return cfg_j, cfg_t, pj, hj, pt, ht


def _clone(Req, reqs):
    return [Req(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                arrival_s=r.arrival_s, slo_s=r.slo_s) for r in reqs]


def _run(srv, reqs, pre_admit: bool, realtime: bool):
    try:
        if pre_admit:
            for r in reqs:
                srv.build_request_table(r)
                srv.admit(r, 0.0)
            srv.run([], realtime=False)
        else:
            srv.run(reqs, realtime=realtime)
    finally:
        srv.close()
    return srv


def serve_port(sysm, reqs, pre_admit=False, realtime=False, **kw):
    cfg_t, pt, ht = sysm[1], sysm[4], sysm[5]
    return _run(RequestServer(cfg_t, pt, ht, device="cpu", **kw), _clone(Request, reqs),
                pre_admit, realtime)


def serve_jax(ref, sysm, reqs, pre_admit=False, realtime=False, **kw):
    cfg_j, pj, hj = sysm[0], sysm[2], sysm[3]
    return _run(ref.RequestServer(cfg_j, pj, hj, **kw), _clone(ref.Request, reqs),
                pre_admit, realtime)


def tokens(srv):
    return {r.rid: list(r.generated) for r in srv.completed}


RING = dict(buckets=(8, 16), cache_len=32)


def _ring(cfg, lanes, **kw):
    return dict(slots_per_layer=cfg.moe.num_experts, max_lanes=lanes,
                max_prefill_batch=lanes, **RING, **kw)


# ---------------------------------------------------------------------------
# tests/test_serving.py's server tests
# ---------------------------------------------------------------------------


def test_server_prefill_matches_engine_serve(ref, tiny):
    """One pre-admitted prefill batch of 4 same-length prompts: the port's
    prefill logits equal the JAX server's and the port's batch engine's."""
    cfg_t = tiny[1]
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg_t.vocab_size, (8,)).astype(np.int32),
                    max_new_tokens=1) for i in range(4)]
    kw = _ring(cfg_t, 4, keep_prefill_logits=True)
    got = serve_port(tiny, reqs, pre_admit=True, **kw)
    want = serve_jax(ref, tiny, reqs, pre_admit=True, **kw)
    assert len(got.completed) == 4 and got.telemetry.counter("prefill_batches").value == 1
    eng = SiDAEngine(cfg_t, tiny[4], tiny[5], slots_per_layer=cfg_t.moe.num_experts,
                     device="cpu")
    eng.serve([np.stack([r.prompt for r in reqs])], threaded=False)
    by_rid = {r.rid: r for r in want.completed}
    for r in got.completed:
        _close(r.prefill_logits, by_rid[r.rid].prefill_logits)
        _close(r.prefill_logits, eng.results[0][r.rid].numpy())
    assert tokens(got) == tokens(want)


def test_server_decode_matches_teacher_forced_forward(ref, tiny):
    """The decode lane (prefill-seeded cache + incremental hash routing)
    emits the JAX server's tokens, and those of a teacher-forced full
    forward over the final sequence with the equivalent routing."""
    cfg_t, pt, ht = tiny[1], tiny[4], tiny[5]
    P, G = 8, 5
    prompt = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (P,)).astype(np.int32)
    reqs = [Request(rid=0, prompt=prompt, max_new_tokens=G)]
    srv = serve_port(tiny, reqs, **_ring(cfg_t, 1))
    gen = srv.completed[0].generated
    assert len(gen) == G and tokens(srv) == tokens(serve_jax(ref, tiny, reqs,
                                                             **_ring(cfg_t, 1)))
    E, k, L = cfg_t.moe.num_experts, srv.k, srv.L
    table = srv.engine.build_table(0, prompt[None, :])
    seq = np.concatenate([prompt, np.asarray(gen[:-1], np.int32)])
    ids = np.zeros((L, 1, len(seq), k), np.int32)
    w = np.zeros((L, 1, len(seq), k), np.float32)
    ids[:, :, :P], w[:, :, :P] = table.expert_ids, table.weights
    state = srv._hash_prefill(prompt[None, :], np.array([P], np.int32))
    for j, tok in enumerate(gen[:-1]):
        logits_h, state = hash_fn_step(srv.hash_params, pt["embed"][[tok]], state, E)
        vals, top = top_k(logits_h, k)
        ids[:, 0, P + j] = top[0].numpy()
        w[:, 0, P + j] = torch.softmax(vals, dim=-1)[0].numpy()
    store = ExpertStore(cfg_t, pt, slots_per_layer=E, device="cpu")
    full = HashTable(0, ids, w)
    slot_ids, ww = store.translate(full, store.prepare(full))
    out = forward(store.serve_params, cfg_t, torch.from_numpy(seq[None, :]),
                  routing_override=(torch.from_numpy(slot_ids), torch.from_numpy(ww)))
    np.testing.assert_array_equal(out["logits"][0, P - 1:].argmax(-1).numpy(), np.asarray(gen))


def test_server_interleaving_is_transparent(ref, tiny):
    """Serving a stream through 3 lanes (join and leave mid-flight) equals
    serving it one request at a time, and equals the JAX server's."""
    cfg_t = tiny[1]
    reqs = poisson_requests(np.random.default_rng(2), 6, rate_rps=1e6,
                            vocab_size=cfg_t.vocab_size, prompt_len_range=(4, 14),
                            max_new_range=(4, 8))
    multi = serve_port(tiny, reqs, **_ring(cfg_t, 3))
    one = serve_port(tiny, reqs, **_ring(cfg_t, 1))
    assert tokens(multi) == tokens(one) == tokens(serve_jax(ref, tiny, reqs, **_ring(cfg_t, 3)))
    assert multi.telemetry.gauge("active_lanes").max > 1


def test_server_slo_drop_expired(ref, tiny):
    cfg_t = tiny[1]
    prompt = np.random.default_rng(3).integers(0, cfg_t.vocab_size, (6,)).astype(np.int32)
    reqs = [Request(rid=0, prompt=prompt, max_new_tokens=2, slo_s=-1.0),   # expired on arrival
            Request(rid=1, prompt=prompt, max_new_tokens=2, slo_s=1e6)]
    got = serve_port(tiny, reqs, **_ring(cfg_t, 2, drop_expired=True))
    want = serve_jax(ref, tiny, reqs, **_ring(cfg_t, 2, drop_expired=True))
    assert [r.rid for r in got.rejected] == [r.rid for r in want.rejected] == [0]
    assert got.rejected[0].state == RequestState.REJECTED
    assert got.rejected[0].reject_reason == "deadline_expired"
    assert got.telemetry.counter("requests_rejected_deadline_expired").value == 1
    assert tokens(got) == tokens(want) and list(tokens(got)) == [1]
    assert got.summary()["rejected"] == 1


def test_ring_lane_reused_by_a_shorter_prompt(ref, tiny):
    """The port's ring decode writes a masked-out lane's K/V in place at its
    stale position (the reference merges the lane's old rows back). A lane
    idles after its request finishes, then takes a shorter prompt whose
    decode reaches the idle writes' slot: every request's tokens still equal
    the JAX server's and those of serving it alone."""
    cfg_t = tiny[1]
    rng = np.random.default_rng(4)
    mk = lambda rid, P, m, t: Request(rid=rid, prompt=rng.integers(
        0, cfg_t.vocab_size, (P,)).astype(np.int32), max_new_tokens=m, arrival_s=t)
    # lane of rid 1 finishes at position 14 and idles (writing slot 14 each
    # tick) until rid 2 (a 5-token prompt, seeded at [:8]) arrives and
    # decodes through position 14
    reqs = [mk(0, 8, 22, 0.0), mk(1, 12, 3, 0.0), mk(2, 5, 14, 0.05)]
    got = RequestServer(cfg_t, tiny[4], tiny[5], device="cpu", **_ring(cfg_t, 2))
    ticks = []
    decode = got._decode_masked

    def spy(toks, slot_ids, w, active):
        ticks.append((active.copy(), got.cache["pos"].clone().numpy()))
        return decode(toks, slot_ids, w, active)

    got._decode_masked = spy
    _run(got, _clone(Request, reqs), pre_admit=False, realtime=True)
    assert sorted(r.rid for r in got.completed) == [0, 1, 2]
    # some tick ran with a lane masked out at rid 1's last position 14
    assert any((~act & (pos == 14)).any() and act.any() for act, pos in ticks)
    lanes_of = {}
    for r in _clone(Request, reqs):
        lanes_of[r.rid] = tokens(serve_port(tiny, [r], **_ring(cfg_t, 1)))[r.rid]
    assert tokens(got) == lanes_of
    assert tokens(got) == tokens(serve_jax(ref, tiny, reqs, realtime=True, **_ring(cfg_t, 2)))


def test_server_refuses_what_is_not_ported(tiny):
    cfg_t, pt, ht = tiny[1], tiny[4], tiny[5]
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.offload import ShardedStoreConfig
    from repro_torch.serving import ServingConfig, TenantConfig

    for kw, item in ((dict(tenants=(TenantConfig("a"),)), "A13"),
                     (dict(faults=FaultPlan.parse("upload:fail@1")), "A13"),
                     (dict(sharded=ShardedStoreConfig(ep_shards=2)), "A14"),
                     (dict(rebalance_interval=0.5), "A14")):
        with pytest.raises(NotImplementedError, match=item):
            RequestServer(cfg_t, pt, ht, device="cpu", **kw)
    with pytest.raises(TypeError, match="either"):
        RequestServer(cfg_t, pt, ht, ServingConfig(), max_lanes=2, device="cpu")
    srv = RequestServer(cfg_t, pt, ht, 3, device="cpu")        # legacy positional slots
    assert srv.config.slots_per_layer == 3 and srv.tenant_summary() == {}
    assert srv.prefetch is None
    srv = RequestServer(cfg_t, pt, ht, device="cpu", prefetch_depth=2)
    assert srv.prefetch.degraded_fraction() == 0.0
    srv.close()


# ---------------------------------------------------------------------------
# the trained miniature: tokens, loads and bytes equal the JAX server's
# ---------------------------------------------------------------------------


def _e8_cfg(get):
    """The miniature Switch the benchmarks train (benchmarks/common.py::bench_cfg(8))."""
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(
        cfg, n_layers=4, d_ff=128,
        moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=1, capacity_factor=4.0,
                                d_expert=512),
    )


@pytest.fixture(scope="module")
def e8(ref):
    import jax.numpy as jnp

    from repro.checkpoint.io import load_checkpoint as j_load_checkpoint

    jax = ref.jax
    cfg_j, cfg_t = _e8_cfg(ref.get_config), _e8_cfg(get_config)
    pj, _ = j_load_checkpoint(os.path.join(CK, "model"),
                              like=ref.init_params(jax.random.PRNGKey(0), cfg_j))
    hj, _ = j_load_checkpoint(
        os.path.join(CK, "hash"),
        like=ref.init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, ref.n_moe_layers(cfg_j),
                              8, d_h=32))
    dj, _ = j_load_checkpoint(os.path.join(CK, "draft"),
                              like={"draft_proj": jnp.zeros((32, cfg_j.d_model), jnp.float32)})
    hj = {**hj, **dj}
    return (cfg_j, cfg_t, pj, hj, params_from_numpy(jax.tree.map(np.asarray, pj)),
            params_from_numpy(jax.tree.map(np.asarray, hj)))


@pytest.mark.parametrize("spec", [False, True], ids=["vanilla", "spec"])
def test_server_matches_jax_on_e8(ref, e8, spec):
    """Pre-admitted (one deterministic schedule), synchronous, 3 expert
    slots of 8 under LRU: the same tokens, expert loads, hits, evictions and
    bytes, and with spec on, the same acceptance."""
    cfg_t = e8[1]
    reqs = poisson_requests(np.random.default_rng(5), 6, rate_rps=1e6,
                            vocab_size=cfg_t.vocab_size, prompt_len_range=(4, 16),
                            max_new_range=(3, 9))
    kw = dict(slots_per_layer=3, max_lanes=3, max_prefill_batch=3, **RING)
    if spec:
        kw.update(spec_mode="draft", spec_k=3)
    got = serve_port(e8, reqs, pre_admit=True, **kw)
    want = serve_jax(ref, e8, reqs, pre_admit=True, **kw)
    assert len(got.completed) == 6 and tokens(got) == tokens(want)
    for f in ("loads", "hits", "evictions", "bytes_h2d"):
        assert getattr(got.store.stats, f) == getattr(want.store.stats, f), f
    sg, sw = got.summary(), want.summary()
    assert sg.keys() == sw.keys()
    for key in ("completed", "spec_acceptance_rate", "cache_hit_rate", "h2d_mb", "spec_k"):
        assert sg[key] == sw[key], key
    snap_g, snap_w = got.telemetry.snapshot()["counters"], want.telemetry.snapshot()["counters"]
    for key in ("decode_steps", "tokens_generated", "prefill_batches", "spec_proposed_tokens",
                "spec_accepted_tokens", "expert_loads", "h2d_bytes"):
        assert snap_g.get(key) == snap_w.get(key), key
    assert not spec or 0.0 < sg["spec_acceptance_rate"] < 1.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("prefetch_depth", [0, 2], ids=["sync", "async"])
def test_full_width_server_on_the_card(cuda, prefetch_depth):
    """Phase 9a's server (switch-base-8 at full width, 12 layers, bf16, 4
    slots, 8 lanes, a 512-slot ring), 8 requests: every request completes
    with in-vocab tokens, and the path launches its kernels."""
    from repro_torch.kernels import ops

    cfg = get_config("switch-base-8")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    hp = init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg),
                      cfg.moe.num_experts, d_h=64, device="cpu")
    reqs = poisson_requests(np.random.default_rng(0), 8, rate_rps=8.0,
                            vocab_size=cfg.vocab_size, prompt_len_range=(16, 256),
                            max_new_range=(8, 32))
    srv = RequestServer(cfg, params, hp, slots_per_layer=4, max_lanes=8, max_prefill_batch=8,
                        buckets=(64, 128, 256), cache_len=512, prefetch_depth=prefetch_depth,
                        device=cuda)
    ops.reset_launches()
    try:
        srv.run(reqs, realtime=False)
    finally:
        srv.close()
    counts = ops.launches()
    assert len(srv.completed) == 8 and not srv.rejected
    for r in srv.completed:
        assert len(r.generated) == r.max_new_tokens
        assert 0 <= min(r.generated) and max(r.generated) < cfg.vocab_size
    for name in ("expert_ffn", "sparsemax", "flash_prefill", "flash_decode"):
        assert counts[name] > 0, (name, counts)
