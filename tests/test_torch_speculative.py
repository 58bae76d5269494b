"""The port's speculative decode against the JAX package on the CPU: the
tied-embedding draft head (`draft_logits_from_state`, `hash_fn_step` and
`hash_fn_apply` with `embed_table=`) on the committed sys_E8 hash and draft
weights, `draft_unroll_fn`, `select_accepted_state`, `verify_step` over a
ring and over pages (with and without `active`, in fp32 and bf16),
`KVPagePool.ensure(extra_span=)`, and `SiDADecodeEngine(spec_mode="draft")`
on fp, int8 and tiered-over-pages slots, sync and async: the JAX engine's
tokens, per-block acceptance and loads. Port-only mirrors of
`tests/test_speculative.py` and `tests/test_paged_kv.py` hold the rollback
to running only the accepted prefix, and spec decode to vanilla greedy."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as j_load_checkpoint
from repro.configs.base import TierConfig as JTier
from repro.configs.base import get_config as jget_config
from repro.core import decode_engine as jd
from repro.core import hash_fn as jh
from repro.core import residency as jr
from repro.models.attention import ShardingCtx
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import init_cache as j_init_cache
from repro.models.transformer import init_paged_cache as j_init_paged_cache
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro.models.transformer import verify_step as j_verify_step
from repro_torch.checkpoint import load_checkpoint, params_from_numpy
from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core import decode_engine as td
from repro_torch.core import hash_fn as th
from repro_torch.core import residency as tr
from repro_torch.core.hash_table import HashTable
from repro_torch.core.offload import ExpertStore
from repro_torch.models.transformer import (
    decode_step,
    init_cache,
    init_paged_cache,
    init_params,
    n_moe_layers,
    verify_step,
)

torch.set_num_threads(2)
CK = os.path.join(os.path.dirname(__file__), "..", "experiments", "cache", "sys_E8")
TOL = 1e-5        # fp32 modules (tests/test_torch_decode.py)
MODEL_TOL = 1e-4  # whole-model logits and K/V (tests/test_torch_decode.py)
BF16_LOGIT_TOL = 5e-2   # bf16 logits, times max(1, max|logit|) (tests/test_torch_decode.py)
CTX = ShardingCtx()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _e8_cfg(get, dtype="float32"):
    """The miniature Switch the benchmarks train (benchmarks/common.py::bench_cfg(8))."""
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(
        cfg, n_layers=4, d_ff=128, dtype=dtype,
        moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=1, capacity_factor=4.0,
                                d_expert=512),
    )


def _e8(dtype):
    cfg_j, cfg_t = _e8_cfg(jget_config, dtype), _e8_cfg(get_config, dtype)
    pj, _ = j_load_checkpoint(os.path.join(CK, "model"),
                              like=j_init_params(jax.random.PRNGKey(0), cfg_j))
    hj, _ = j_load_checkpoint(
        os.path.join(CK, "hash"),
        like=jh.init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j), 8,
                             d_h=32))
    # the committed draft head, merged into the hash params on both sides as
    # benchmarks/common.py::_with_draft_head does
    dj, _ = j_load_checkpoint(os.path.join(CK, "draft"),
                              like={"draft_proj": jnp.zeros((32, cfg_j.d_model), jnp.float32)})
    pj, hj = jax.tree.map(np.asarray, pj), jax.tree.map(np.asarray, {**hj, **dj})
    return cfg_j, cfg_t, pj, hj, params_from_numpy(pj), params_from_numpy(hj)


@pytest.fixture(scope="module")
def e8():
    return _e8("float32")


# ---------------------------------------------------------------------------
# the draft head
# ---------------------------------------------------------------------------


def test_draft_head_init_and_checkpoint_carry(e8):
    cfg_j, cfg_t, _, hj, _, ht = e8
    # params_from_numpy carries draft_proj; the port's reader gives the same
    dt, manifest = load_checkpoint(os.path.join(CK, "draft"))
    assert manifest["keys"]["draft_proj"]["shape"] == [32, cfg_t.d_model]
    np.testing.assert_array_equal(dt["draft_proj"].numpy(), hj["draft_proj"])
    np.testing.assert_array_equal(ht["draft_proj"].numpy(), hj["draft_proj"])
    # init_hash_fn(draft=True) has the reference's keys and shapes; the
    # draft head is drawn last, so the other weights are those without it
    L, E, d = 2, 8, 24
    pj = jh.init_hash_fn(jax.random.PRNGKey(0), d, L, E, d_h=16, draft=True)
    with_d = th.init_hash_fn(torch.Generator().manual_seed(0), d, L, E, d_h=16, device="cpu",
                             draft=True)
    without = th.init_hash_fn(torch.Generator().manual_seed(0), d, L, E, d_h=16, device="cpu")
    shapes = lambda t: {k: tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(jax.tree.map(np.asarray, pj)) == shapes(jax.tree.map(lambda x: x.numpy(),
                                                                        with_d))
    for k in without:
        jax.tree.map(np.testing.assert_array_equal, without[k], with_d[k])
    attached = th.init_draft_head(torch.Generator().manual_seed(3), without, d)
    assert attached["draft_proj"].shape == (16, d) and attached["heads"] is without["heads"]


def test_draft_logits_and_hash_fn_step_match_jax_on_e8(e8):
    cfg_j, cfg_t, pj, hj, pt, ht = e8
    E, B = 8, 3
    embed_j, embed_t = pj["embed"], pt["embed"]

    @jax.jit
    def jstep(tok, st):
        return jd.hash_fn_step(hj, jnp.take(embed_j, tok, axis=0), st, E, embed_j)

    sj, st = jd.hash_state_init(hj, B), td.hash_state_init(ht, B)
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (12, B)).astype(np.int32)
    for tok in toks:
        lj, dj, sj = jstep(tok, sj)
        lt, dt, st = td.hash_fn_step(ht, embed_t[torch.from_numpy(tok).long()], st, E, embed_t)
        _close(lt, lj, TOL)
        _close(dt, dj, TOL)
        np.testing.assert_array_equal(dt.argmax(-1).numpy(), np.asarray(dj).argmax(-1))
    for name in st:
        _close(st[name], sj[name], TOL)
    # without a table (or without a head) the step is the vanilla one
    assert len(td.hash_fn_step(ht, embed_t[:B], st, E)) == 2
    no_head = {k: v for k, v in ht.items() if k != "draft_proj"}
    assert len(td.hash_fn_step(no_head, embed_t[:B], st, E, embed_t)) == 2
    # the full-sequence view (hash_fn_apply's draft branch)
    seq = toks.T.copy()
    lj, dj = jh.hash_fn_apply(hj, jnp.take(embed_j, seq, axis=0), E, causal=True,
                              embed_table=embed_j)
    lt, dt = th.hash_fn_apply(ht, embed_t[torch.from_numpy(seq).long()], E, causal=True,
                              embed_table=embed_t)
    _close(lt, lj, TOL)
    _close(dt, dj, TOL)
    _close(th.draft_logits_from_state(ht, torch.ones(2, 32), embed_t),
           jh.draft_logits_from_state(hj, jnp.ones((2, 32)), embed_j), TOL)


# ---------------------------------------------------------------------------
# draft unroll and the predictor's rollback
# ---------------------------------------------------------------------------


def _unroll_pair(e8, K, B=3, seed=1, active=None):
    cfg_j, cfg_t, pj, hj, pt, ht = e8
    tok = np.random.default_rng(seed).integers(0, cfg_t.vocab_size, (B,)).astype(np.int32)
    sj, st = jd.hash_state_init(hj, B), td.hash_state_init(ht, B)
    # advance both predictors a few tokens first, so the states are not zero
    for t in np.random.default_rng(seed + 1).integers(0, cfg_t.vocab_size, (5, B)):
        _, sj = jd.hash_fn_step(hj, jnp.take(pj["embed"], t, axis=0), sj, 8)
        _, st = td.hash_fn_step(ht, pt["embed"][torch.from_numpy(t).long()], st, 8)
    uj = jax.jit(jd.draft_unroll_fn(8, 2, K))(
        hj, pj["embed"], tok, sj, None if active is None else jnp.asarray(active))
    ut = td.draft_unroll_fn(8, 2, K)(
        ht, pt["embed"], torch.from_numpy(tok), st,
        None if active is None else torch.from_numpy(active))
    return uj, ut, (sj, st)


@pytest.mark.parametrize("active", [None, np.array([True, False, True])])
def test_draft_unroll_matches_jax_on_e8(e8, active):
    K = 4
    (ij, idj, aj, sj), (it, idt, at, st), _ = _unroll_pair(e8, K, active=active)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))              # [B, K]
    assert idt.shape == (n_moe_layers(e8[1]), 3, K, 2) and idt.dtype == torch.int32
    np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))            # [L, B, K, k]
    _close(at, aj, TOL)
    if active is not None:
        assert float(at[:, 1].abs().sum()) == 0.0
    assert set(st) == set(sj)
    for name in st:
        assert st[name].shape[0] == K
        _close(st[name], sj[name], TOL)


def test_select_accepted_state_matches_jax(e8):
    K = 4
    (_, _, _, sj), (_, _, _, st), (oj, ot) = _unroll_pair(e8, K)
    for n_acc in ([1, 4, 2], [0, 3, 1]):
        nj, nt = jnp.asarray(n_acc, jnp.int32), torch.tensor(n_acc, dtype=torch.int32)
        for old_j, old_t in ((None, None), (oj, ot)):
            if old_j is None and 0 in n_acc:
                continue   # n_acc 0 needs `old` (the masked server's inactive lanes)
            gj = jd.select_accepted_state(sj, nj, old_j)
            gt = td.select_accepted_state(st, nt, old_t)
            for name in gt:
                _close(gt[name], gj[name], TOL)
            if old_t is not None:
                for b, n in enumerate(n_acc):
                    want = ot if n == 0 else {k: v[n - 1] for k, v in st.items()}
                    for name in gt:
                        np.testing.assert_array_equal(gt[name][b].numpy(), want[name][b].numpy())


# ---------------------------------------------------------------------------
# verify_step against the JAX one
# ---------------------------------------------------------------------------

_PAGE, _MP = 4, 4   # 16 addressable positions a lane


def _caches(cfg_j, cfg_t, B, paged, start_pos):
    """Fresh caches on both sides, lanes starting at `start_pos`. Paged: a
    hand-made table of distinct pages, lane b's pages b*Mp.. (the last lane
    owns only its first three pages, so its later entries are unallocated)."""
    if not paged:
        cj, ct = j_init_cache(cfg_j, B, 16), init_cache(cfg_t, B, 16, device="cpu")
    else:
        pcj = jr.PagedKVConfig(page_size=_PAGE, kv_pages=B * _MP, max_seq=_PAGE * _MP)
        pct = tr.PagedKVConfig(page_size=_PAGE, kv_pages=B * _MP, max_seq=_PAGE * _MP)
        cj, ct = j_init_paged_cache(cfg_j, B, pcj), init_paged_cache(cfg_t, B, pct, device="cpu")
        table = np.arange(B * _MP, dtype=np.int32).reshape(B, _MP)
        table[-1, 3:] = -1
        cj["page_table"], ct["page_table"] = jnp.asarray(table), torch.from_numpy(table)
    cj["pos"], ct["pos"] = jnp.asarray(start_pos, jnp.int32), torch.tensor(start_pos,
                                                                          dtype=torch.int32)
    return cj, ct


def _verify_inputs(e8, paged, start_pos, kb, seed):
    """Caches on both sides after three plain steps (so the block reads a
    live cache), a block's routing, and a block whose drafts are the JAX
    model's own greedy continuation (what a perfect head would propose),
    with lane b's draft at column wrong[b] made wrong."""
    cfg_j, cfg_t, pj, _, pt, _ = e8
    B = len(start_pos)
    L, E = j_n_moe_layers(cfg_j), cfg_j.moe.num_experts
    rng = np.random.default_rng(seed)
    cj, ct = _caches(cfg_j, cfg_t, B, paged, start_pos)
    jstep = jax.jit(lambda c, t, ids, w: j_decode_step(pj, c, t, cfg_j, CTX,
                                                       routing_override=(ids, w)))
    for _ in range(3):
        toks = rng.integers(0, cfg_t.vocab_size, (B,)).astype(np.int32)
        ids = rng.integers(0, E, (L, B, 1)).astype(np.int32)
        w = rng.random((L, B, 1)).astype(np.float32)
        _, cj = jstep(cj, toks, ids, w)
        _, ct = decode_step(pt, ct, torch.from_numpy(toks), cfg_t,
                            routing_override=(torch.from_numpy(ids), torch.from_numpy(w)))
    ro_ids = rng.integers(0, E, (kb, L, B, 1)).astype(np.int32)
    ro_w = rng.random((kb, L, B, 1)).astype(np.float32)
    toks, c = [rng.integers(0, cfg_t.vocab_size, (B,)).astype(np.int32)], cj
    for i in range(kb - 1):
        lg, c = jstep(c, toks[-1], ro_ids[i], ro_w[i])
        toks.append(np.asarray(jnp.argmax(lg, -1)).astype(np.int32))
    blk = np.stack(toks, axis=1)
    # lane b accepts wrong[b] tokens (wrong = kb: every draft right)
    wrong = [kb, 2, 1, 3][:B]
    for b, j in enumerate(wrong):
        if j < kb:
            blk[b, j] = (blk[b, j] + 1) % cfg_t.vocab_size
    return cj, ct, blk, ro_ids, ro_w, wrong


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("with_active", [False, True])
def test_verify_step_matches_jax_on_e8(e8, paged, with_active):
    cfg_j, cfg_t, pj, _, pt, _ = e8
    kb = 4
    # lane 3 starts at 10 and reaches 16 in the pre-steps: paged, its block
    # is past its allocated pages and past the table (trash page)
    start_pos = [0, 5, 2, 10]
    cj, ct, blk, ro_ids, ro_w, wrong = _verify_inputs(e8, paged, start_pos, kb, seed=2)
    active = np.array([True, True, False, True]) if with_active else None
    oj, nj, lj, cj2 = j_verify_step(
        pj, cj, jnp.asarray(blk), cfg_j, CTX,
        routing_override=(jnp.asarray(ro_ids), jnp.asarray(ro_w)),
        active=None if active is None else jnp.asarray(active))
    ot, nt, lt, ct2 = verify_step(
        pt, ct, torch.from_numpy(blk), cfg_t,
        routing_override=(torch.from_numpy(ro_ids), torch.from_numpy(ro_w)),
        active=None if active is None else torch.from_numpy(active))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    want_n = np.array(wrong) if active is None else np.where(active, wrong, 0)
    np.testing.assert_array_equal(nt.numpy(), want_n)
    assert lt.shape == (kb, len(start_pos), lj.shape[-1])
    _close(lt, lj, MODEL_TOL)
    np.testing.assert_array_equal(ct2["pos"].numpy(), np.asarray(cj2["pos"]))
    names = ("kp", "vp") if paged else ("k", "v")
    for sub in ("sub0", "sub1"):
        for n in names:
            got, want = ct2[sub][n].numpy(), np.asarray(cj2[sub][n])
            if paged:   # the trash page holds what the overflow writes left
                got, want = got[:, :-1], want[:, :-1]
            _close(got, want, MODEL_TOL)


def test_verify_step_matches_jax_on_e8_bf16():
    cfg_j, cfg_t, pj, _, pt, _ = _e8("bfloat16")
    kb = 4
    cj, ct, blk, ro_ids, ro_w, _ = _verify_inputs((cfg_j, cfg_t, pj, None, pt, None), False,
                                                  [0, 3, 7], kb, seed=3)
    oj, nj, lj, _ = j_verify_step(pj, cj, jnp.asarray(blk), cfg_j, CTX,
                                  routing_override=(jnp.asarray(ro_ids), jnp.asarray(ro_w)))
    ot, nt, lt, ct2 = verify_step(pt, ct, torch.from_numpy(blk), cfg_t,
                                  routing_override=(torch.from_numpy(ro_ids),
                                                    torch.from_numpy(ro_w)))
    assert lt.dtype == torch.bfloat16 and ct2["sub0"]["k"].dtype == torch.bfloat16
    want = np.asarray(lj, np.float32)
    tol = BF16_LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    got = lt.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_verify_step_refuses_a_block_longer_than_the_ring(e8):
    _, cfg_t, _, _, pt, _ = e8
    ct = init_cache(cfg_t, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="draft window 4"):
        verify_step(pt, ct, torch.zeros((2, 4), dtype=torch.int32), cfg_t)


# ---------------------------------------------------------------------------
# rollback == only the accepted prefix (port alone, mirrors tests/test_speculative.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """tests/test_speculative.py's `_sys()` in the port: switch-base-8 reduced,
    8 experts, d_h 16 predictor with a draft head."""
    cfg = get_config("switch-base-8").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    hp = th.init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg),
                         cfg.moe.num_experts, d_h=16, device="cpu", draft=True)
    return cfg, params, hp


def _routing_for(cfg, store, hp, params, blk):
    """Per-position routing for a block from the predictor, through the
    store's device translate (every expert resident)."""
    B, kb = blk.shape
    state = td.hash_state_init(hp, B)
    ids_l, a_l = [], []
    for i in range(kb):
        logits, state = td.hash_fn_step(hp, params["embed"][torch.from_numpy(blk[:, i]).long()],
                                        state, cfg.moe.num_experts)
        vals, ids = td.top_k(logits, 1)
        ids_l.append(ids.movedim(1, 0).to(torch.int32))
        a_l.append(torch.softmax(vals, -1).movedim(1, 0))
    ids, alpha = torch.stack(ids_l, dim=2), torch.stack(a_l, dim=2)
    trans = store.prepare(HashTable(0, ids.numpy(), alpha.numpy()))
    slot_ids, w = store.translate_device(ids, alpha, trans)
    return slot_ids.movedim(2, 0), w.movedim(2, 0)


def _clone(cache):
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone())
            for k, v in cache.items()}


def _paged_cache(cfg, B, pos0):
    pool = tr.KVPagePool(cfg, tr.PagedKVConfig(page_size=4, kv_pages=8 * B, max_seq=32), B,
                         device="cpu")
    cache = pool.init_cache()
    for b in range(B):
        cache = pool.ensure(cache, b, 32)
    cache["page_table"] = pool.device_table()
    cache["pos"] = torch.tensor(pos0, dtype=torch.int32)
    return cache


@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_rollback_matches_accepted_prefix(tiny, paged):
    cfg, params, hp = tiny
    store = ExpertStore(cfg, params, cfg.moe.num_experts, device="cpu")
    B, kb = 3, 4
    rng = np.random.default_rng(3)
    start = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    pos0 = [2, 6, 14]    # paged: lane 2's block crosses a page boundary
    make = (lambda: _paged_cache(cfg, B, pos0)) if paged else (lambda: dict(
        init_cache(cfg, B, 16, device="cpu"), pos=torch.tensor(pos0, dtype=torch.int32)))
    cache0 = make()
    ro = _routing_for(cfg, store, hp, params, np.tile(start[:, None], (1, kb)))
    # drafts: the model's own greedy tokens, lane 1's draft at column 2 and
    # lane 2's at column 1 wrong; lane 0 accepts the whole block
    blk = [start]
    c = _clone(cache0)
    for i in range(kb - 1):
        lg, c = decode_step(store.serve_params, c, torch.from_numpy(blk[-1]), cfg,
                            routing_override=(ro[0][i], ro[1][i]))
        blk.append(lg.argmax(-1).to(torch.int32).numpy())
    blk = np.stack(blk, axis=1)
    blk[1, 2] = (blk[1, 2] + 1) % cfg.vocab_size
    blk[2, 1] = (blk[2, 1] + 1) % cfg.vocab_size

    cache = _clone(cache0)
    out, n_acc, logits, new_cache = verify_step(store.serve_params, cache,
                                                torch.from_numpy(blk), cfg, routing_override=ro)
    assert logits.shape[0] == kb
    for b in range(B):
        exp = 1
        while exp < kb and out[b, exp - 1] == blk[b, exp]:
            exp += 1
        assert n_acc[b] == exp
    assert n_acc.tolist() == [4, 2, 1]

    # reference: each lane's accepted prefix alone, through plain decode_step
    ref = _clone(cache0)
    for i in range(int(n_acc.max())):
        before = _clone(ref)
        _, ref = decode_step(store.serve_params, ref, torch.from_numpy(blk[:, i]), cfg,
                             routing_override=(ro[0][i], ro[1][i]))
        keep = torch.from_numpy(i >= n_acc.numpy())   # lanes done: undo this step
        ref["pos"] = torch.where(keep, before["pos"], ref["pos"])
        for sub in (k for k in ref if k.startswith("sub")):
            for n, t in ref[sub].items():
                if paged:
                    for b in np.flatnonzero(keep.numpy()):
                        pages = new_cache["page_table"][b]
                        pages = pages[pages >= 0].long()
                        t[:, pages] = before[sub][n][:, pages]
                else:
                    t[:, keep] = before[sub][n][:, keep]
    np.testing.assert_array_equal(new_cache["pos"].numpy(), ref["pos"].numpy())
    for sub in (k for k in ref if k.startswith("sub")):
        for n in ref[sub]:
            np.testing.assert_array_equal(new_cache[sub][n].numpy(), ref[sub][n].numpy())


@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_inactive_lane_fully_rolled_back(tiny, paged):
    cfg, params, hp = tiny
    store = ExpertStore(cfg, params, cfg.moe.num_experts, device="cpu")
    B, kb = 2, 3
    blk = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, kb)).astype(np.int32)
    ro = _routing_for(cfg, store, hp, params, blk)
    cache0 = _paged_cache(cfg, B, [0, 0]) if paged else init_cache(cfg, B, 16, device="cpu")
    before = _clone(cache0)
    _, n_acc, _, new_cache = verify_step(store.serve_params, cache0, torch.from_numpy(blk), cfg,
                                         routing_override=ro,
                                         active=torch.tensor([True, False]))
    assert n_acc[1] == 0 and n_acc[0] >= 1
    assert int(new_cache["pos"][1]) == 0
    for sub in (k for k in before if k.startswith("sub")):
        for n, t in before[sub].items():
            if paged:   # lane 1's pages untouched (its writes went to the trash page)
                pages = before["page_table"][1].long()
                np.testing.assert_array_equal(new_cache[sub][n][:, pages].numpy(),
                                              t[:, pages].numpy())
            else:
                np.testing.assert_array_equal(new_cache[sub][n][:, 1].numpy(), t[:, 1].numpy())


# ---------------------------------------------------------------------------
# the engine: spec == vanilla greedy, accounting, paged == ring
# ---------------------------------------------------------------------------


def _engine(tiny, slots=None, **kw):
    cfg, params, hp = tiny
    return td.SiDADecodeEngine(cfg, params, hp, slots_per_layer=slots or cfg.moe.num_experts,
                               serve_top_k=1, device="cpu", **kw)


@pytest.mark.parametrize("prefetch_depth", [0, 2])
@pytest.mark.parametrize("quantized", [False, True])
def test_spec_equals_vanilla_greedy(tiny, prefetch_depth, quantized):
    start = np.arange(3, dtype=np.int32) + 1
    outs = {}
    for mode in ("off", "draft"):
        eng = _engine(tiny, prefetch_depth=prefetch_depth, quantized_slots=quantized,
                      spec_mode=mode, spec_k=3)
        outs[mode], m = eng.generate(start, steps=10, cache_len=32)
        eng.close()
        assert m.tokens == 3 * 10
    np.testing.assert_array_equal(outs["draft"], outs["off"])


def test_decode_metrics_count_accepted_tokens(tiny):
    start = np.arange(2, dtype=np.int32) + 1
    steps, K = 9, 3
    eng = _engine(tiny, slots=4)
    _, m = eng.generate(start, steps=steps, cache_len=32)
    assert m.tokens == m.proposed == 2 * steps and m.steps == steps
    assert m.acceptance_rate == 1.0 and m.accepted_per_step == [1.0] * steps
    assert len(m.loads_per_step) == m.steps
    eng = _engine(tiny, spec_mode="draft", spec_k=K)
    _, ms = eng.generate(start, steps=steps, cache_len=32)
    assert ms.tokens == 2 * steps
    assert ms.proposed == 2 * K * ms.steps
    assert len(ms.loads_per_step) == ms.steps == len(ms.accepted_per_step)
    assert 0.0 < ms.acceptance_rate <= 1.0
    assert sum(ms.accepted_per_step) * 2 == ms.tokens


def test_spec_engine_refuses_a_hash_fn_without_draft_head(tiny):
    cfg, params, hp = tiny
    no_head = {k: v for k, v in hp.items() if k != "draft_proj"}
    with pytest.raises(ValueError, match="draft head"):
        td.SiDADecodeEngine(cfg, params, no_head, 8, device="cpu", spec_mode="draft", spec_k=3)
    # spec_k 1 is the vanilla loop, with or without a head
    assert not td.SiDADecodeEngine(cfg, params, no_head, 8, device="cpu", spec_mode="draft",
                                   spec_k=1).spec


def test_engine_spec_paged_matches_ring_to_the_addressable_edge(tiny):
    """Two lanes decode the whole addressable range (32 positions) over
    pages: the last blocks draft past it, their overflow writes go to the
    trash page and the ensure target is clamped; tokens equal the ring's."""
    start = np.array([1, 2], np.int32)
    paged = tr.PagedKVConfig(page_size=8, kv_pages=8, max_seq=32)
    outs = {}
    for name, kw in (("ring", {}), ("paged", dict(paged=paged))):
        eng = _engine(tiny, spec_mode="draft", spec_k=3)
        outs[name], m = eng.generate(start, steps=paged.seq_len, cache_len=32, **kw)
        assert m.tokens == 2 * paged.seq_len
    np.testing.assert_array_equal(outs["paged"], outs["ring"])
    assert eng.kv_pool.stats.allocs == 2 * 4 and eng.kv_pool.stats.spills == 0


def test_ensure_extra_span_pins_the_reference_pages():
    """A windowed pool: `ensure(extra_span=)` pages in and pins the pages the
    block's earliest query reads, as the reference's does."""
    cfgs = []
    for get in (jget_config, get_config):
        cfg = get("switch-base-8").reduced()
        cfgs.append(dataclasses.replace(cfg, n_layers=2, attn=dataclasses.replace(
            cfg.attn, window=6, layer_pattern=("local",))))
    pj = jr.KVPagePool(cfgs[0], jr.PagedKVConfig(page_size=4, kv_pages=6, max_seq=64), 2)
    pt = tr.KVPagePool(cfgs[1], tr.PagedKVConfig(page_size=4, kv_pages=6, max_seq=64), 2,
                       device="cpu")
    cj, ct = pj.init_cache(), pt.init_cache()
    for extra in (0, 3, 5):
        for upto in (9, 20, 28):
            for b in (0, 1):
                cj = pj.ensure(cj, b, upto, pin=True, extra_span=extra)
                ct = pt.ensure(ct, b, upto, pin=True, extra_span=extra)
                assert pt._pinned == pj._pinned, (extra, upto, b)
                np.testing.assert_array_equal(pt.table, pj.table)
            pj.unpin_all()
            pt.unpin_all()
    assert pt.stats.spills > 0 and pt.stats.page_ins > 0
    assert dataclasses.asdict(pt.stats) == {k: getattr(pj.stats, k)
                                           for k in dataclasses.asdict(pt.stats)}


# ---------------------------------------------------------------------------
# the spec engine against the JAX one on sys_E8
# ---------------------------------------------------------------------------


_SLOTS = {
    "fp": dict(slots_per_layer=3),
    "int8": dict(slots_per_layer=3, quantized_slots=True),
    "tiered-paged": dict(slots_per_layer=3, quantized_slots=True, eviction="alpha"),
}


@pytest.mark.parametrize("prefetch_depth", [0, 2])
@pytest.mark.parametrize("slots", list(_SLOTS))
def test_spec_engine_matches_jax_on_e8(e8, slots, prefetch_depth):
    cfg_j, cfg_t, pj, hj, pt, ht = e8
    start = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (3,)).astype(np.int32)
    kw = dict(_SLOTS[slots], spec_mode="draft", spec_k=3, prefetch_depth=prefetch_depth)
    kj, kt, gen_j, gen_t = dict(kw), dict(kw), {}, {}
    if slots == "tiered-paged":
        kt["tier"] = TierConfig(int4_slots=True, warm_slots=1)
        kj["tier"] = JTier(int4_slots=True, warm_slots=1)
        gen_t["paged"] = tr.PagedKVConfig(page_size=4, kv_pages=24)
        gen_j["paged"] = jr.PagedKVConfig(page_size=4, kv_pages=24)
    ej = jd.SiDADecodeEngine(cfg_j, pj, hj, **kj)
    et = td.SiDADecodeEngine(cfg_t, pt, ht, device="cpu", **kt)
    oj, mj = ej.generate(start, steps=16, cache_len=32, **gen_j)
    ot, mt = et.generate(start, steps=16, cache_len=32, **gen_t)
    ej.close()
    et.close()
    np.testing.assert_array_equal(ot, oj)
    assert (mt.steps, mt.tokens, mt.proposed) == (mj.steps, mj.tokens, mj.proposed)
    assert mt.accepted_per_step == mj.accepted_per_step
    assert mt.loads_per_step == mj.loads_per_step
    assert sum(mt.loads_per_step[1:]) > 0             # the budget binds after block 0
    assert mt.mean_accepted > 1.0                     # the trained head's drafts are taken
    for f in ("bytes_h2d", "loads", "evictions", "hits", "dropped", "promotions", "demotions"):
        assert getattr(et.store.stats, f) == getattr(ej.store.stats, f), f
    assert et.store.resident == ej.store.resident
    print(f"sys_E8 spec_k=3 {slots} depth={prefetch_depth}: acceptance_rate="
          f"{mt.acceptance_rate:.4f} mean_accepted={mt.mean_accepted:.4f} blocks={mt.steps}")
