"""The port's decode path against the JAX package on the CPU (fp32, and
`decode_step` / `forward` also in bf16, the served dtype): the
`flash_decode` oracle (and the Pallas kernel in interpret mode), one-token
`attend_decode` across a ring wrap, the incremental predictor
`hash_fn_step` past its 128-slot ring, `decode_step` on the committed
sys_E8 weights, and `SiDADecodeEngine.generate` on sys_E8 against the JAX
engine on fp, host-int8 and int8-resident slots: the same tokens, the same
per-step loads and the same store counters."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as j_load_checkpoint
from repro.configs.base import get_config as jget_config
from repro.core import decode_engine as jd
from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import ShardingCtx
from repro.models.attention import attend_decode as j_attend_decode
from repro.models.attention import init_attention as j_init_attention
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_cache as j_init_cache
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core import decode_engine as td
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import attend_decode, decode_attention
from repro_torch.models.transformer import decode_step, forward, init_cache

torch.set_num_threads(2)
CK = os.path.join(os.path.dirname(__file__), "..", "experiments", "cache", "sys_E8")
TOL = 1e-5       # fp32 kernels and modules
MODEL_TOL = 1e-4  # whole-model logits (as tests/test_torch_engine.py)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash_decode oracle
# ---------------------------------------------------------------------------


def _decode_inputs(B, S, H, K, D, pos, wrap, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    s_idx = np.arange(S, dtype=np.int32)[None, :]
    sp = p[:, None] - ((p[:, None] - s_idx) % S) if wrap else np.broadcast_to(s_idx, (B, S))
    sp = np.where(sp >= 0, sp, -1).astype(np.int32)
    return q, k, v, sp, p


@pytest.mark.parametrize("B,S,H,K,D,pos,wrap,window,cap", [
    (2, 64, 4, 4, 32, [70, 10], True, 0, 0.0),          # ring after wrap
    (3, 48, 8, 2, 16, [47, 100, 5], True, 16, 30.0),    # G = 4, window + softcap
    (2, 40, 6, 2, 32, [-1, 30], False, 0, 0.0),         # G = 3; lane 0 has no valid slot
    (1, 24, 2, 1, 8, [200], True, 5, 0.0),              # G = 2, window inside the ring
])
def test_flash_decode_ref_matches_jax(B, S, H, K, D, pos, wrap, window, cap):
    q, k, v, sp, p = _decode_inputs(B, S, H, K, D, pos, wrap)
    args_t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, sp, p)]
    args_j = [jnp.asarray(a) for a in (q, k, v, sp, p)]
    got = ref.flash_decode_ref(*args_t, window=window, cap=cap)
    _close(got, jref.flash_decode_ref(*args_j, window=window, cap=cap), TOL)
    _close(got, jops.flash_decode(*args_j, window=window, cap=cap, bs=S), TOL)   # Pallas, interpret
    # the CPU dispatch is the oracle; the model's plain path agrees with both
    _close(ops.flash_decode(*args_t, window=window, cap=cap), got, 0.0)
    _close(decode_attention(*args_t, window, cap), got, TOL)
    if -1 in pos:   # an all-invalid lane averages V uniformly, as the reference
        _close(got[0], np.repeat(v[0].mean(0)[:, None, :], H // K, axis=1).reshape(H, D), TOL)


# ---------------------------------------------------------------------------
# attend_decode over a ring
# ---------------------------------------------------------------------------


def _attn_pair(d_model, n_heads, n_kv_heads, head_dim, window=0, cap=0.0):
    attn = dict(window=window, logit_softcap=cap,
                layer_pattern=("local",) if window else ("global",))
    out = []
    for get in (jget_config, get_config):
        base = get("switch-base-8").reduced()
        out.append(dataclasses.replace(
            base, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, attn=dataclasses.replace(base.attn, **attn),
        ))
    return out


@pytest.mark.parametrize("H,K,window,cap", [(4, 2, 0, 0.0), (4, 4, 5, 20.0)])
def test_attend_decode_matches_jax_across_ring_wrap(H, K, window, cap):
    cfg_j, cfg_t = _attn_pair(32, H, K, 8, window, cap)
    pj = jax.tree.map(np.asarray, j_init_attention(jax.random.PRNGKey(0), cfg_j))
    pt = params_from_numpy(pj)
    B, Sc, steps = 3, 8, 20                           # the ring wraps twice
    ctx = ShardingCtx()
    jstep = jax.jit(lambda p, x, ck, cv, pos: j_attend_decode(p, x, ck, cv, pos, cfg_j, 0, ctx))
    ck_j = cv_j = jnp.zeros((B, Sc, K, 8), jnp.float32)
    ck_t, cv_t = torch.zeros((B, Sc, K, 8)), torch.zeros((B, Sc, K, 8))
    rng = np.random.default_rng(1)
    start = np.array([0, 3, 11], np.int32)           # lanes at different positions
    for i in range(steps):
        x = rng.standard_normal((B, 32)).astype(np.float32)
        pos = start + i
        yj, ck_j, cv_j = jstep(pj, x, ck_j, cv_j, jnp.asarray(pos))
        yt, ck_t, cv_t = attend_decode(pt, torch.from_numpy(x), ck_t, cv_t,
                                       torch.from_numpy(pos), cfg_t, 0)
        _close(yt, yj, TOL)
        _close(ck_t, ck_j, TOL)
        _close(cv_t, cv_j, TOL)


# ---------------------------------------------------------------------------
# incremental predictor
# ---------------------------------------------------------------------------


def test_hash_fn_step_matches_jax_past_the_ring():
    L, E, d_model, d_h, k = 3, 8, 32, 16, 2
    pj = jax.tree.map(np.asarray, j_init_hash_fn(jax.random.PRNGKey(2), d_model, L, E, d_h=d_h))
    pt = params_from_numpy(pj)
    B, steps = 2, td.HISTORY + 12                    # the SparseMax ring wraps
    assert td.HISTORY == jd.HISTORY

    @jax.jit
    def jstep(emb, st):
        logits, st = jd.hash_fn_step(pj, emb, st, E)
        return logits, jax.lax.top_k(logits, k)[1], st

    sj, st = jd.hash_state_init(pj, B), td.hash_state_init(pt, B)
    rng = np.random.default_rng(3)
    for _ in range(steps):
        emb = rng.standard_normal((B, d_model)).astype(np.float32)
        lj, ij, sj = jstep(emb, sj)
        lt, st = td.hash_fn_step(pt, torch.from_numpy(emb), st, E)
        _close(lt, lj, TOL)
        np.testing.assert_array_equal(td.top_k(lt, k)[1].numpy(), np.asarray(ij))
    assert int(st["t"][0]) == steps
    _close(st["ring"], sj["ring"], TOL)


# ---------------------------------------------------------------------------
# sys_E8: decode_step and the engine
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


def test_decode_step_matches_jax_on_e8(e8):
    cfg_j, cfg_t, pj, _, pt, _ = e8
    B, cache_len, steps = 2, 8, 12                    # the K/V ring wraps
    L, E = j_n_moe_layers(cfg_j), cfg_j.moe.num_experts
    ctx = ShardingCtx()
    jstep = jax.jit(lambda p, c, t, ids, w: j_decode_step(p, c, t, cfg_j, ctx,
                                                          routing_override=(ids, w)))
    cj = j_init_cache(cfg_j, B, cache_len)
    ct = init_cache(cfg_t, B, cache_len, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg_t.vocab_size, (B,)).astype(np.int32)
    for _ in range(steps):
        ids = rng.integers(0, E, (L, B, 1)).astype(np.int32)
        w = rng.random((L, B, 1)).astype(np.float32)
        lj, cj = jstep(pj, cj, toks, ids, w)
        lt, ct = decode_step(pt, ct, torch.from_numpy(toks), cfg_t,
                             routing_override=(torch.from_numpy(ids), torch.from_numpy(w)))
        _close(lt, lj, MODEL_TOL)
        toks = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    for sub in ("sub0", "sub1"):
        _close(ct[sub]["k"], cj[sub]["k"], MODEL_TOL)
        _close(ct[sub]["v"], cj[sub]["v"], MODEL_TOL)


# bf16: the served dtype. The weights are sys_E8's, cast once to the dtype
# the bf16 config gives each leaf, and handed as the same numpy arrays to
# both sides. Tolerance: each bf16 kernel of the path is held to its plain
# version at 5e-2 (tests/test_torch_kernels.py), and one bf16 ulp of a logit
# near 6 is 0.03; so logits agree within 5e-2 * max(1, max|logit|).
BF16_LOGIT_TOL = 5e-2


@pytest.fixture(scope="module")
def e8_bf16():
    cfg_j = dataclasses.replace(_e8_cfg(jget_config), dtype="bfloat16")
    cfg_t = dataclasses.replace(_e8_cfg(get_config), dtype="bfloat16")
    pj, _ = j_load_checkpoint(os.path.join(CK, "model"),
                              like=j_init_params(jax.random.PRNGKey(0), cfg_j))
    pj = jax.tree.map(np.asarray, pj)
    assert {str(a.dtype) for a in jax.tree.leaves(pj)} >= {"bfloat16"}
    return cfg_j, cfg_t, pj, params_from_numpy(pj)


def _bf16_close(got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    tol = BF16_LOGIT_TOL * max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _fixed_table(rng, L, B, S, E):
    return (rng.integers(0, E, (L, B, S, 1)).astype(np.int32),
            rng.random((L, B, S, 1)).astype(np.float32))


def test_decode_step_matches_jax_on_e8_bf16(e8_bf16):
    """decode_step in bf16 over a wrapping ring, one fixed routing table for
    every step on both sides; each step feeds both the JAX argmax, so a bf16
    near-tie cannot send the two down different tokens."""
    cfg_j, cfg_t, pj, pt = e8_bf16
    B, cache_len, steps = 2, 8, 12
    L, E = j_n_moe_layers(cfg_j), cfg_j.moe.num_experts
    rng = np.random.default_rng(6)
    ids, w = (a[:, :, 0] for a in _fixed_table(rng, L, B, 1, E))
    jstep = jax.jit(lambda p, c, t, ids, w: j_decode_step(p, c, t, cfg_j, ShardingCtx(),
                                                          routing_override=(ids, w)))
    cj = j_init_cache(cfg_j, B, cache_len)
    ct = init_cache(cfg_t, B, cache_len, device="cpu")
    assert ct["sub0"]["k"].dtype == torch.bfloat16
    toks = rng.integers(0, cfg_t.vocab_size, (B,)).astype(np.int32)
    for _ in range(steps):
        lj, cj = jstep(pj, cj, toks, ids, w)
        lt, ct = decode_step(pt, ct, torch.from_numpy(toks), cfg_t,
                             routing_override=(torch.from_numpy(ids), torch.from_numpy(w)))
        assert lt.dtype == torch.bfloat16
        _bf16_close(lt, lj)
        toks = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


def test_forward_matches_jax_on_e8_bf16(e8_bf16):
    """forward in bf16 over a batch, the same fixed routing table on both sides."""
    cfg_j, cfg_t, pj, pt = e8_bf16
    B, S = 2, 20
    L, E = j_n_moe_layers(cfg_j), cfg_j.moe.num_experts
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    ids, w = _fixed_table(rng, L, B, S, E)
    oj = j_forward(pj, cfg_j, ShardingCtx(), toks,
                   routing_override=(jnp.asarray(ids), jnp.asarray(w)))
    ot = forward(pt, cfg_t, torch.from_numpy(toks),
                 routing_override=(torch.from_numpy(ids), torch.from_numpy(w)))
    assert ot["logits"].dtype == torch.bfloat16
    _bf16_close(ot["logits"], oj["logits"])


@pytest.mark.parametrize("quant", [
    dict(), dict(host_quant="int8"), dict(quantized_slots=True),
])
def test_decode_engine_matches_jax_on_e8(e8, quant):
    cfg_j, cfg_t, pj, hj, pt, ht = e8
    start = np.random.default_rng(5).integers(0, cfg_t.vocab_size, (3,)).astype(np.int32)
    ej = jd.SiDADecodeEngine(cfg_j, pj, hj, slots_per_layer=3, **quant)
    et = td.SiDADecodeEngine(cfg_t, pt, ht, slots_per_layer=3, device="cpu", **quant)
    oj, mj = ej.generate(start, steps=20, cache_len=16)
    ot, mt = et.generate(start, steps=20, cache_len=16)
    np.testing.assert_array_equal(ot, oj)
    assert mt.loads_per_step == mj.loads_per_step
    assert sum(mt.loads_per_step[1:]) > 0             # the budget binds after step 0
    assert (mt.steps, mt.tokens, mt.proposed) == (mj.steps, mj.tokens, mj.proposed) == (20, 60, 60)
    assert mt.acceptance_rate == mj.acceptance_rate == 1.0
    for f in ("bytes_h2d", "loads", "evictions", "hits", "dropped"):
        assert getattr(et.store.stats, f) == getattr(ej.store.stats, f), f
    assert et.store.resident == ej.store.resident
    assert et.store.device_bytes() == ej.store.device_bytes()
    assert et.store.expert_slot_bytes() == ej.store.expert_slot_bytes()
    et.close()
    ej.close()


def test_decode_engine_refuses_unported_modes(e8):
    _, cfg_t, _, _, pt, ht = e8
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.offload import ExpertStore, PrefetchPipeline, ShardedStoreConfig
    from repro_torch.launch.mesh import make_ep_mesh
    from repro_torch.sharding.policy import serve_ctx

    # a real ShardedStoreConfig serves: with every expert resident, EP-2's
    # tokens equal the one-device engine's (fp32, top-1)
    start = np.array([3, 5], np.int32)
    outs = []
    for sharded in (None, ShardedStoreConfig(ep_shards=2)):
        eng = td.SiDADecodeEngine(cfg_t, pt, ht, slots_per_layer=8, device="cpu", sharded=sharded)
        outs.append(eng.generate(start, steps=4, cache_len=16)[0])
        eng.close()
    assert eng.ctx.ep_shards == eng.store.shards == 2
    np.testing.assert_array_equal(outs[1], outs[0])
    # only shards on distinct devices are refused (ROADMAP A14(c))
    with pytest.raises(NotImplementedError, match=r"A14\(c\)"):
        td.SiDADecodeEngine(cfg_t, pt, ht, slots_per_layer=2, device="cpu",
                            sharded=ShardedStoreConfig(ep_shards=2),
                            ctx=serve_ctx(make_ep_mesh(2, devices=["cpu", "meta"])))

    # the pipeline's fault injection is ported: faults= builds a pipeline
    # that takes its retry settings from cfg.prefetch
    store = ExpertStore(cfg_t, pt, 2, device="cpu")
    plan = FaultPlan.parse("upload:fail@1")
    pipe = PrefetchPipeline.maybe_create(store, cfg_t, prefetch_depth=2, faults=plan)
    assert pipe is not None and pipe.faults is plan and store._prefetcher is pipe
    pc = cfg_t.prefetch
    assert (pipe.max_retries, pipe.backoff_s, pipe.degrade_after) == \
        (pc.max_retries, pc.backoff_s, pc.degrade_after)
    pipe.close()
    assert store._prefetcher is None


def test_table_buffer_brings_ids_and_alpha_in_one_copy():
    ids = torch.tensor([[[3, 1]], [[0, 7]]], dtype=torch.int32)          # [L=2, B=1, k=2]
    alpha = torch.tensor([[[0.75, 0.25]], [[0.5, 0.5]]])
    tab = td.TableBuffer(2, 1, 1, 2).fill(4, ids, alpha)
    assert tab.batch_index == 4
    np.testing.assert_array_equal(tab.expert_ids[:, :, 0], ids.numpy())
    np.testing.assert_array_equal(tab.weights[:, :, 0], alpha.numpy())
