"""The port's chunked paged prefill against the JAX package on the CPU:
`attend_prefill_chunk` (full attention and a sliding window, a spilled page
masked out, the pad tail past the table routed to the trash page) and
`prefill_chunk_step` over chunks that continue one another, on the same
weights (through `params_from_numpy`), then 40 tokens in 8-token chunks
against one 64-bucket forward. Tolerance: 1e-5 on fp32 outputs, logits and
pools."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.residency import PagedKVConfig as JPaged
from repro.models.attention import ShardingCtx
from repro.models.attention import attend_prefill_chunk as j_attend_prefill_chunk
from repro.models.attention import init_attention as j_init_attention
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_paged_cache as j_init_paged_cache
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro.models.transformer import prefill_chunk_step as j_prefill_chunk_step
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.residency import PagedKVConfig
from repro_torch.models.attention import attend_prefill_chunk
from repro_torch.models.transformer import forward, init_paged_cache, prefill_chunk_step

torch.set_num_threads(2)
TOL = 1e-5
CTX = ShardingCtx()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfg(get, window=0):
    """tests/test_paged_kv.py's `tiny` (and, windowed, `wtiny`): the reduced
    switch-base-8 at 2 layers, capacity never binding."""
    cfg = get("switch-base-8").reduced()
    cfg = dataclasses.replace(cfg, n_layers=2,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    if window:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, window=window, layer_pattern=("local",)))
    return cfg


def _system(window=0):
    cfg_j, cfg_t = _cfg(jget_config, window), _cfg(get_config, window)
    pj = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg_j))
    return cfg_j, cfg_t, pj, params_from_numpy(pj)


@pytest.fixture(scope="module")
def tiny():
    return _system()


@pytest.fixture(scope="module")
def wtiny():
    return _system(window=8)


def _routing(cfg, rng, T):
    """A routing override over the full expert stack (ids index experts
    directly): [L_moe, 1, T, k] ids and α."""
    L, E, k = j_n_moe_layers(cfg), cfg.moe.num_experts, cfg.moe.top_k
    ids = rng.integers(0, E, (L, 1, T, k)).astype(np.int32)
    w = rng.uniform(0.2, 1.0, (L, 1, T, k)).astype(np.float32)
    return ids, w


# ---------------------------------------------------------------------------
# attend_prefill_chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (5, 20.0)])
def test_attend_prefill_chunk_matches_jax(window, cap):
    cfg_j = jget_config("switch-base-8").reduced()
    cfg_j = dataclasses.replace(cfg_j, attn=dataclasses.replace(
        cfg_j.attn, window=window, logit_softcap=cap,
        layer_pattern=("local",) if window else cfg_j.attn.layer_pattern))
    cfg_t = dataclasses.replace(get_config("switch-base-8").reduced(), attn=cfg_j.attn)
    rng = np.random.default_rng(0)
    pj = jax.tree.map(np.asarray, j_init_attention(jax.random.PRNGKey(3), cfg_j))
    pt = params_from_numpy(pj)
    page, n_pages, Mp, T = 4, 9, 5, 8
    K, D = cfg_j.n_kv_heads, cfg_j.hd
    kp = rng.standard_normal((n_pages + 1, page, K, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, page, K, D)).astype(np.float32)
    # position-ordered pages, the first spilled (-1): a chunk at 16 covers
    # positions 16..23, whose last page (index 5) is past the 5-wide table,
    # so its writes go to the trash page
    table = np.array([[-1, 6, 2, 8, 0]], np.int32)
    trash0 = kp[n_pages].copy()
    for pos0 in (8, 16):
        x = rng.standard_normal((1, T, cfg_j.d_model)).astype(np.float32)
        pos = np.array([pos0], np.int32)
        yj, kpj, vpj = j_attend_prefill_chunk(pj, jnp.asarray(x), jnp.asarray(kp),
                                              jnp.asarray(vp), jnp.asarray(table),
                                              jnp.asarray(pos), cfg_j, 0, CTX)
        kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        yt, kt2, vt2 = attend_prefill_chunk(pt, torch.from_numpy(x), kt, vt,
                                            torch.from_numpy(table), torch.from_numpy(pos),
                                            cfg_t, 0)
        assert kt2 is kt and vt2 is vt               # written in place
        _close(yt, yj)
        # every real page equals the reference's; the trash page is written
        # (by the pad tail) but never read
        _close(kt[:n_pages], np.asarray(kpj)[:n_pages])
        _close(vt[:n_pages], np.asarray(vpj)[:n_pages])
        kp, vp = kt.numpy(), vt.numpy()
    # the chunk at 16 sent positions 20..23 (table index 5 >= Mp) to the trash page
    assert not np.array_equal(kp[n_pages], trash0)


# ---------------------------------------------------------------------------
# prefill_chunk_step
# ---------------------------------------------------------------------------


def _caches(sysm, paged, table, pos0):
    cfg_j, cfg_t = sysm[0], sysm[1]
    cj = j_init_paged_cache(cfg_j, 1, JPaged(**paged))
    ct = init_paged_cache(cfg_t, 1, PagedKVConfig(**paged), device="cpu")
    rng = np.random.default_rng(5)
    for skey in [k for k in ct if k.startswith("sub")]:
        for name in ("kp", "vp"):
            garbage = rng.standard_normal(tuple(ct[skey][name].shape)).astype(np.float32)
            ct[skey][name].copy_(torch.from_numpy(garbage))
            cj[skey] = dict(cj[skey], **{name: jnp.asarray(garbage)})
    cj["page_table"], ct["page_table"] = jnp.asarray(table), torch.from_numpy(table.copy())
    cj["pos"] = jnp.asarray([pos0], jnp.int32)
    ct["pos"] = torch.tensor([pos0], dtype=torch.int32)
    return cj, ct


def _same_pools(ct, cj, n_pages):
    for skey in [k for k in ct if k.startswith("sub")]:
        for name in ("kp", "vp"):
            _close(ct[skey][name][:, :n_pages], np.asarray(cj[skey][name])[:, :n_pages])


@pytest.mark.parametrize("windowed", [False, True])
def test_prefill_chunk_step_matches_jax(tiny, wtiny, windowed):
    """Chunks that continue one another: logits and pools equal the
    reference's after each. The table is 11 pages of 4 (max_seq 42), so the
    last 8-token chunk of a 41-token prompt pads past it; the windowed run
    has its first page spilled by then."""
    sysm = wtiny if windowed else tiny
    cfg_j, cfg_t, pj, pt = sysm
    paged = dict(page_size=4, kv_pages=16, max_seq=42)
    table = np.array([[3, 9, 0, 14, 5, 11, 1, 7, 12, 2, 15]], np.int32)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg_t.vocab_size, (48,)).astype(np.int32)
    T = 8
    cj, ct = _caches(sysm, paged, table, 0)
    for c0 in range(0, 48, T):
        if windowed and c0 == 40:
            # a spilled out-of-window page: -1 in the table, masked on both sides
            cj["page_table"] = cj["page_table"].at[0, 0].set(-1)
            ct["page_table"][0, 0] = -1
        toks = prompt[None, c0:c0 + T]
        ids, w = _routing(cfg_t, rng, T)
        lj, cj = j_prefill_chunk_step(pj, cj, jnp.asarray(toks), cfg_j, CTX,
                                      routing_override=(jnp.asarray(ids), jnp.asarray(w)))
        lt, ct = prefill_chunk_step(pt, ct, torch.from_numpy(toks), cfg_t,
                                    routing_override=(torch.from_numpy(ids),
                                                      torch.from_numpy(w)))
        assert lt.shape == (1, T, cfg_t.padded_vocab)
        _close(lt, lj)
        assert int(ct["pos"][0]) == int(cj["pos"][0]) == c0 + T
        _same_pools(ct, cj, paged["kv_pages"])


def test_chunked_prefill_equals_one_bucket_forward(tiny):
    """40 tokens in 8-token chunks through pages == one [1, 64] forward of
    the prompt padded to its bucket (first 40 positions; causal, capacity
    never binds), and == the reference's chunked run."""
    cfg_j, cfg_t, pj, pt = tiny
    rng = np.random.default_rng(2)
    P, T, bucket = 40, 8, 64
    prompt = rng.integers(0, cfg_t.vocab_size, (P,)).astype(np.int32)
    ids, w = _routing(cfg_t, rng, bucket)
    ids[:, :, P:], w[:, :, P:] = ids[:, :, P - 1:P], 0.0     # the server's pad routing
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :P] = prompt
    full = forward(pt, cfg_t, torch.from_numpy(padded),
                   routing_override=(torch.from_numpy(ids), torch.from_numpy(w)))["logits"]
    fj = j_forward(pj, cfg_j, CTX, jnp.asarray(padded),
                   routing_override=(jnp.asarray(ids), jnp.asarray(w)))["logits"]
    _close(full, fj, 1e-4)
    paged = dict(page_size=8, kv_pages=16)
    table = np.full((1, 16), -1, np.int32)
    table[0, :P // 8] = [4, 0, 7, 2, 9]
    cj, ct = _caches(tiny, paged, table, 0)
    got = []
    for c0 in range(0, P, T):
        sl = slice(c0, c0 + T)
        ro_t = (torch.from_numpy(ids[:, :, sl].copy()), torch.from_numpy(w[:, :, sl].copy()))
        lt, ct = prefill_chunk_step(pt, ct, torch.from_numpy(prompt[None, sl].copy()), cfg_t,
                                    routing_override=ro_t)
        lj, cj = j_prefill_chunk_step(pj, cj, jnp.asarray(prompt[None, sl]), cfg_j, CTX,
                                      routing_override=(jnp.asarray(ids[:, :, sl]),
                                                        jnp.asarray(w[:, :, sl])))
        _close(lt, lj)
        got.append(lt[0])
    chunked = torch.cat(got)
    _close(chunked, full[0, :P], 1e-4)
    np.testing.assert_array_equal(chunked.argmax(-1).numpy(), full[0, :P].argmax(-1).numpy())
    _same_pools(ct, cj, paged["kv_pages"])
