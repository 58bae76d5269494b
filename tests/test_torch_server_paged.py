"""The port's paged request server against the JAX one on the CPU, mirroring
`tests/test_paged_kv.py`'s server tests on the same weights: paged == ring
(synchronous and through the prefetch pipeline), speculative paged == ring,
spec at the addressable edge, a chunked long prefill == one big bucket
(and the reference's chunk counters), long and short prompts interleaved,
a long prompt on a reused lane (where the reference prefills at the
released request's stale position), and the admission rejections and their
reasons (the windowed model's spills are in
`tests/test_torch_server_windowed.py`). Tokens and counters exactly."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.residency import PagedKVConfig
from repro_torch.serving import Request

from test_torch_server import _Ref, serve_jax, serve_port, tokens

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def _cfg(get, window=0):
    """tests/test_paged_kv.py's `tiny` (and, windowed, `wtiny`)."""
    cfg = get("switch-base-8").reduced()
    cfg = dataclasses.replace(cfg, n_layers=2,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    if window:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, window=window, layer_pattern=("local",)))
    return cfg


def _system(ref, window=0):
    from repro_torch.checkpoint import params_from_numpy

    jax = ref.jax
    cfg_j, cfg_t = _cfg(ref.get_config, window), _cfg(get_config, window)
    pj = ref.init_params(jax.random.PRNGKey(0), cfg_j)
    hj = ref.init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, ref.n_moe_layers(cfg_j),
                          cfg_j.moe.num_experts, d_h=16, draft=not window)
    return (cfg_j, cfg_t, pj, hj, params_from_numpy(jax.tree.map(np.asarray, pj)),
            params_from_numpy(jax.tree.map(np.asarray, hj)))


@pytest.fixture(scope="module")
def tiny(ref):
    return _system(ref)


def _reqs(cfg, seed, n=5):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               (int(rng.integers(4, 16)),)).astype(np.int32),
                    max_new_tokens=int(rng.integers(3, 8)))
            for i in range(n)]


def _kw(cfg, lanes=3, **kw):
    kw.setdefault("buckets", (8, 16))
    return dict(slots_per_layer=cfg.moe.num_experts, max_lanes=lanes,
                max_prefill_batch=lanes, **kw)


def _long_prompt(cfg, P=40, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (P,)).astype(np.int32)


# ---------------------------------------------------------------------------
# paged == ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefetch_depth", [0, 2])
def test_server_paged_matches_ring(ref, tiny, prefetch_depth):
    cfg = tiny[1]
    reqs = _reqs(cfg, 1)
    ring = serve_port(tiny, reqs, **_kw(cfg, cache_len=32, prefetch_depth=prefetch_depth))
    paged_kw = _kw(cfg, paged=PagedKVConfig(page_size=8, kv_pages=16),
                   prefetch_depth=prefetch_depth)
    paged = serve_port(tiny, reqs, **paged_kw)
    assert tokens(ring) == tokens(paged) == tokens(serve_jax(ref, tiny, reqs, **paged_kw))
    assert paged.summary()["paged_kv"] == 1.0 and ring.summary()["paged_kv"] == 0.0
    assert paged.residency.device_bytes() == (paged.store.device_bytes()
                                              + paged.kv_pool.capacity_bytes())


def test_server_spec_paged_matches_ring(ref, tiny):
    cfg = tiny[1]
    reqs = _reqs(cfg, 1)
    spec = dict(spec_mode="draft", spec_k=3)
    ring = serve_port(tiny, reqs, **_kw(cfg, cache_len=32, **spec))
    paged_kw = _kw(cfg, paged=PagedKVConfig(page_size=8, kv_pages=16), **spec)
    paged = serve_port(tiny, reqs, **paged_kw)
    assert tokens(ring) == tokens(paged) == tokens(serve_jax(ref, tiny, reqs, **paged_kw))
    assert paged.summary()["spec_acceptance_rate"] > 0


def test_server_spec_at_addressable_edge_matches_ring(ref, tiny):
    """P + max_new == the addressable range: the draft block's overdraft is
    clamped out of the ensure target and its writes go to the trash page."""
    cfg = tiny[1]
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (8,)).astype(np.int32)
    reqs = [Request(rid=0, prompt=prompt, max_new_tokens=24)]
    spec = dict(spec_mode="draft", spec_k=3)
    ring = serve_port(tiny, reqs, **_kw(cfg, cache_len=32, **spec))
    paged_kw = _kw(cfg, paged=PagedKVConfig(page_size=8, kv_pages=4), **spec)
    paged = serve_port(tiny, reqs, **paged_kw)
    assert len(paged.completed) == 1 and not paged.rejected
    assert tokens(ring) == tokens(paged) == tokens(serve_jax(ref, tiny, reqs, **paged_kw))
    assert len(paged.completed[0].generated) == 24


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


def test_server_chunked_long_prefill_matches_big_bucket(ref, tiny):
    """A 40-token prompt through buckets (8, 16) and 8-token chunks == the
    same prompt through an unchunked 64-bucket server, token for token."""
    cfg = tiny[1]
    reqs = [Request(rid=0, prompt=_long_prompt(cfg), max_new_tokens=6)]
    big = serve_port(tiny, reqs, **_kw(cfg, buckets=(64,), cache_len=128))
    chunk_kw = _kw(cfg, paged=PagedKVConfig(page_size=8, kv_pages=16, prefill_chunk=8))
    chunked = serve_port(tiny, reqs, **chunk_kw)
    want = serve_jax(ref, tiny, reqs, **chunk_kw)
    assert len(chunked.completed) == 1 and not chunked.rejected
    assert tokens(big) == tokens(chunked) == tokens(want)
    s, sj = chunked.summary(), want.summary()
    assert s["prefill_chunks"] == sj["prefill_chunks"] == 5          # ceil(40 / 8)
    assert s["long_prefills_completed"] == sj["long_prefills_completed"] == 1
    assert chunked.completed[0].chunk_pos == 40
    for key in ("kv_pages_allocated", "kv_pool_bytes", "kv_capacity_bytes"):
        assert s[key] == sj[key], key


def _mix(cfg):
    rng = np.random.default_rng(3)
    return [Request(rid=0, prompt=_long_prompt(cfg), max_new_tokens=4)] + [
        Request(rid=1 + i, prompt=rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32),
                max_new_tokens=6) for i in range(3)]


_MIX_KW = dict(paged=PagedKVConfig(page_size=8, kv_pages=16, prefill_chunk=8))


@pytest.fixture(scope="module")
def long_alone(tiny):
    """The long prompt's tokens served alone (the chunked == big bucket test
    holds the port's chunked prefill to the reference's)."""
    cfg = tiny[1]
    return tokens(serve_port(tiny, _mix(cfg)[:1], **_kw(cfg, **_MIX_KW)))[0]


def test_server_long_and_short_interleave(ref, tiny, long_alone):
    """Every request completes; the short ones emit the JAX server's tokens
    and the long one its tokens when served alone. Which lane the long
    prompt takes depends on the hash thread's timing: see the next test for
    a reused one."""
    cfg = tiny[1]
    mix = _mix(cfg)
    kw = _kw(cfg, **_MIX_KW)
    got = serve_port(tiny, mix, **kw)
    assert sorted(r.rid for r in got.completed) == [0, 1, 2, 3]
    want = tokens(serve_jax(ref, tiny, mix, **kw))
    assert {rid: t for rid, t in tokens(got).items() if rid} == \
        {rid: t for rid, t in want.items() if rid}
    assert tokens(got)[0] == long_alone


def test_long_prompt_on_a_reused_lane_starts_at_position_0(ref, tiny, long_alone):
    """Pre-admitted short requests take all three lanes first, so the long
    prompt starts on a lane a finished request released. The port resets
    that lane's position to 0 and emits the tokens of the prompt served
    alone; the reference keeps the released request's last position, so
    its chunks land past the lane's pages (a fault kept in ROADMAP §C)."""
    cfg = tiny[1]
    mix = _mix(cfg)
    kw = _kw(cfg, **_MIX_KW)
    order = mix[1:] + mix[:1]
    got = serve_port(tiny, order, pre_admit=True, **kw)
    want = serve_jax(ref, tiny, order, pre_admit=True, **kw)
    assert tokens(got)[0] == long_alone
    assert tokens(want)[0] != long_alone                  # the reference's fault
    assert {rid: t for rid, t in tokens(got).items() if rid} == \
        {rid: t for rid, t in tokens(want).items() if rid}


def test_server_admission_rejections(ref, tiny):
    cfg = tiny[1]
    cases = ((_kw(cfg, cache_len=32), 4, "prompt_exceeds_max_bucket"),
             (_kw(cfg, paged=PagedKVConfig(page_size=8, kv_pages=16, prefill_chunk=8)), 200,
              "exceeds_addressable_range"))
    for kw, max_new, reason in cases:
        reqs = [Request(rid=0, prompt=_long_prompt(cfg), max_new_tokens=max_new)]
        for srv in (serve_port(tiny, reqs, **kw), serve_jax(ref, tiny, reqs, **kw)):
            assert srv.rejected and srv.rejected[0].reject_reason == reason
            assert srv.telemetry.counter(f"requests_rejected_{reason}").value == 1
            assert not srv.completed
