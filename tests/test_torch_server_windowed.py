"""The port's paged request server against the JAX one on the CPU, on a
windowed model (window 8, every layer local): a tight pool whose in-span
pages spill and page back in (pre-admitted, so its page counters equal the
reference's too), a range that is not a chunk multiple, and the explicit
pool-exhausted error, mirroring `tests/test_paged_kv.py`'s windowed server
tests. Tokens and counters exactly."""
import numpy as np
import pytest
import torch

from repro_torch.core.residency import PagedKVConfig
from repro_torch.serving import Request

from test_torch_server import _Ref, serve_jax, serve_port, tokens
from test_torch_server_paged import _long_prompt, _system

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref():
    return _Ref()


@pytest.fixture(scope="module")
def wtiny(ref):
    return _system(ref, window=8)


def test_server_windowed_tight_budget_pages_in_like_jax(ref, wtiny):
    """Two long prompts through a pool smaller than their pages: in-span
    pages of one lane are evicted by the other's tick and page back in.
    Pre-admitted, so the schedule is one: the tokens equal a pool that never
    spills and the reference's, and the page counters the reference's."""
    cfg = wtiny[1]
    reqs = [Request(rid=r, prompt=_long_prompt(cfg, seed=r), max_new_tokens=6) for r in range(2)]
    kw = lambda pages: dict(slots_per_layer=cfg.moe.num_experts, max_lanes=2,
                            max_prefill_batch=2, buckets=(8, 16),
                            paged=PagedKVConfig(page_size=4, kv_pages=pages, prefill_chunk=8,
                                                max_seq=64))
    tight = serve_port(wtiny, reqs, pre_admit=True, **kw(8))
    want = serve_jax(ref, wtiny, reqs, pre_admit=True, **kw(8))
    roomy = serve_port(wtiny, reqs, pre_admit=True, **kw(32))
    s, sj = tight.summary(), want.summary()
    assert len(tight.completed) == 2
    assert s["kv_page_spills"] > 0 and s["kv_page_ins"] > 0
    assert roomy.summary()["kv_page_spills"] == 0
    assert tokens(tight) == tokens(roomy) == tokens(want)
    for key in ("kv_pages_allocated", "kv_page_spills", "kv_page_ins", "kv_bytes_spilled",
                "kv_bytes_paged_in", "prefill_chunks", "long_prefills_completed"):
        assert s[key] == sj[key], key


def test_server_chunked_unaligned_max_seq(ref, wtiny):
    """max_seq not a chunk multiple: the last chunk pads past the table, its
    pad writes go to the trash page, and the tokens equal an aligned range's."""
    cfg = wtiny[1]
    reqs = [Request(rid=0, prompt=_long_prompt(cfg, P=41, seed=9), max_new_tokens=1)]
    kw = lambda seq: dict(slots_per_layer=cfg.moe.num_experts, max_lanes=2,
                          max_prefill_batch=2, buckets=(8, 16),
                          paged=PagedKVConfig(page_size=4, kv_pages=8, prefill_chunk=8,
                                              max_seq=seq))
    srv = serve_port(wtiny, reqs, **kw(42))
    assert len(srv.completed) == 1 and not srv.rejected
    assert tokens(srv) == tokens(serve_port(wtiny, reqs, **kw(48))) == \
        tokens(serve_jax(ref, wtiny, reqs, **kw(42)))


def test_server_decode_overpressure_errors_not_misattends(wtiny):
    cfg = wtiny[1]
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32),
                    max_new_tokens=6) for i in range(2)]
    with pytest.raises(RuntimeError, match="exhausted"):
        serve_port(wtiny, reqs, slots_per_layer=cfg.moe.num_experts, max_lanes=2,
                   max_prefill_batch=2, buckets=(8,),
                   paged=PagedKVConfig(page_size=4, kv_pages=3, max_seq=32))
