"""The attention-family configs through the port against the JAX package on
the CPU (fp32, plain kernels): `forward` and a few `decode_step`s for every
registered attention-family arch at its `reduced()` size and at two narrow
configs that keep what `reduced()` cuts away (deepseek's top-6 over 16
experts with two shared experts; qwen3's GQA group of 16 with qk-norm and
top-8), the shared-expert product of `moe_layer`, and mirrors of the
reference's `tests/test_moe.py::test_shared_experts_always_active` and the
forward / decode cases of `tests/test_models_smoke.py`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.attention import ShardingCtx
from repro.models.transformer import decode_step as j_decode_step
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_cache as j_init_cache
from repro.models.transformer import init_params as j_init_params
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import decode_step, forward, init_cache, init_params
from test_torch_isolation import PORT_ONLY, split_port_only

torch.set_num_threads(2)
TOL = 1e-4
CTX = ShardingCtx()

# every attention-family arch the port registers (hymba, xlstm and seamless
# wait for their block kinds)
ATTN_ARCHS = ["chameleon-34b", "deepseek-moe-16b", "gemma2-9b", "qwen2-1.5b",
              "qwen3-moe-235b-a22b", "smollm-135m", "stablelm-12b", "switch-base-8"]
NARROW = ["deepseek-narrow", "qwen3-narrow"]
WIDE_E = ["deepseek-e64", "qwen3-e128"]     # the published E and top-k, tiny widths


def narrow_config(get, name: str):
    """The same `dataclasses.replace` on either package's config: fp32, two
    layers, a 512-token vocab, and the widths `reduced()` would cut."""
    if name == "deepseek-narrow":
        base = get("deepseek-moe-16b")
        return dataclasses.replace(
            base, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
            vocab_size=512, dtype="float32",
            moe=dataclasses.replace(base.moe, num_experts=16, top_k=6, d_expert=64,
                                    num_shared_experts=2, d_shared=64))
    if name == "qwen3-narrow":
        base = get("qwen3-moe-235b-a22b")
        return dataclasses.replace(
            base, n_layers=2, d_model=128, n_heads=16, n_kv_heads=1, head_dim=32,
            vocab_size=512, dtype="float32",
            moe=dataclasses.replace(base.moe, num_experts=16, top_k=8, d_expert=64))
    if name in ("deepseek-e64", "qwen3-e128"):
        # the published expert counts and top-k, everything else tiny: the
        # predictor's heads, the store's plan and translation at E 64 / 128
        base = narrow_config(get, name.split("-")[0] + "-narrow")
        E, k = (64, 6) if name == "deepseek-e64" else (128, 8)
        return dataclasses.replace(
            base, d_model=64, head_dim=16,
            moe=dataclasses.replace(base.moe, num_experts=E, top_k=k, d_expert=32,
                                    d_shared=32 if base.moe.d_shared else 0))
    raise KeyError(name)


def config_pair(name: str):
    if name in NARROW + WIDE_E:
        return narrow_config(jget_config, name), narrow_config(get_config, name)
    return jget_config(name).reduced(), get_config(name).reduced()


_SYSTEMS: dict = {}


def system(name: str):
    """(cfg_j, cfg_t, JAX params as numpy, the port's params), cached."""
    if name not in _SYSTEMS:
        cfg_j, cfg_t = config_pair(name)
        pj = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg_j))
        _SYSTEMS[name] = (cfg_j, cfg_t, pj, params_from_numpy(pj))
    return _SYSTEMS[name]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_narrow_configs_keep_what_reduced_cuts():
    ds = narrow_config(get_config, "deepseek-narrow")
    assert (ds.moe.num_experts, ds.moe.top_k, ds.moe.num_shared_experts) == (16, 6, 2)
    q3 = narrow_config(get_config, "qwen3-narrow")
    assert q3.n_heads // q3.n_kv_heads == 16 and q3.attn.qk_norm and q3.moe.top_k == 8
    for name in NARROW:
        j, t = config_pair(name)
        shared, extra = split_port_only(dataclasses.asdict(t), dataclasses.asdict(j))
        assert shared == dataclasses.asdict(j) and extra == PORT_ONLY


@pytest.mark.parametrize("name", ATTN_ARCHS + NARROW)
def test_forward_matches_jax(name):
    cfg_j, cfg_t, pj, pt = system(name)
    toks = np.random.default_rng(3).integers(0, cfg_t.vocab_size, (2, 24)).astype(np.int32)
    oj = j_forward(pj, cfg_j, CTX, jnp.asarray(toks), collect_router_logits=cfg_t.moe.enabled)
    ot = forward(pt, cfg_t, torch.from_numpy(toks), collect_router_logits=cfg_t.moe.enabled)
    V = cfg_t.vocab_size
    _close(ot["logits"][..., :V].numpy(), np.asarray(oj["logits"])[..., :V])
    if cfg_t.moe.enabled:
        _close(ot["router_logits"].numpy(), np.asarray(oj["router_logits"]))
        np.testing.assert_allclose(float(ot["aux_loss"]), float(oj["aux_loss"]), rtol=1e-4)


@pytest.mark.parametrize("name", ATTN_ARCHS + NARROW)
def test_decode_steps_match_jax(name):
    """Six steps from a fresh 16-slot cache, router mode: logits at every
    step, and the cache positions."""
    cfg_j, cfg_t, pj, pt = system(name)
    B, seq, steps = 3, 16, 6
    cj = j_init_cache(cfg_j, B, seq)
    ct = init_cache(cfg_t, B, seq, device="cpu")
    rng = np.random.default_rng(4)
    V = cfg_t.vocab_size
    jstep = jax.jit(lambda p, c, t: j_decode_step(p, c, t, cfg_j, CTX))
    for _ in range(steps):
        toks = rng.integers(0, V, (B,)).astype(np.int32)
        lj, cj = jstep(pj, cj, jnp.asarray(toks))
        lt, ct = decode_step(pt, ct, torch.from_numpy(toks), cfg_t)
        _close(lt[:, :V].numpy(), np.asarray(lj)[:, :V])
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("override", [False, True])
def test_moe_layer_with_shared_experts_matches_jax(dispatch, override):
    cfg_j, cfg_t = config_pair("deepseek-narrow")
    pj = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(5), cfg_j))
    pt = params_from_numpy(pj)
    assert tuple(pt["shared_w_in"].shape) == (128, 128)
    assert tuple(pt["shared_w_out"].shape) == (128, 128)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 20, cfg_t.d_model)).astype(np.float32)
    ro_j = ro_t = None
    if override:
        ids = np.stack([rng.permutation(16)[:6] for _ in range(40)]).reshape(2, 20, 6)
        w = rng.random((2, 20, 6)).astype(np.float32)
        ro_j, ro_t = (ids.astype(np.int32), w), (torch.from_numpy(ids), torch.from_numpy(w))
    yj, _ = jmoe.moe_layer(pj, x, cfg_j, CTX, routing_override=ro_j, dispatch=dispatch)
    yt, _ = tmoe.moe_layer(pt, torch.from_numpy(x), cfg_t, routing_override=ro_t,
                           dispatch=dispatch)
    _close(yt.numpy(), np.asarray(yj))


def test_port_init_draws_shared_experts():
    cfg = narrow_config(get_config, "deepseek-narrow")
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    moe = p["blocks"]["sub0"]["moe"]
    assert tuple(moe["shared_w_gate"].shape) == (2, 128, 128)    # [G, d, 2 x 64]
    assert tuple(moe["w_in"].shape) == (2, 16, 128, 64)


# ---------------------------------------------------------------------------
# mirrors of the reference's own tests
# ---------------------------------------------------------------------------


def test_shared_experts_always_active():
    """tests/test_moe.py::test_shared_experts_always_active in the port."""
    base = get_config("deepseek-moe-16b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_experts=4, top_k=2, capacity_factor=100.0, num_shared_experts=1,
        d_shared=base.moe.d_expert))
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(7))
    # zero out all routed-expert weights: output must still be nonzero
    p0 = dict(p)
    for t in ("w_in", "w_gate", "w_out"):
        p0[t] = torch.zeros_like(p0[t])
    y, _ = tmoe.moe_layer(p0, x.to(p0["w_in"].dtype), cfg)
    assert float(y.abs().max()) > 0


def _smoke_params(name):
    cfg = get_config(name).reduced()
    return cfg, init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_forward_smoke(name):
    """tests/test_models_smoke.py::test_forward_smoke in the port."""
    cfg, params = _smoke_params(name)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    logits = forward(params, cfg, toks)["logits"]
    assert tuple(logits.shape) == (2, 16, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size].float()).all()


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_decode_smoke(name):
    """tests/test_models_smoke.py::test_decode_smoke in the port."""
    cfg, params = _smoke_params(name)
    B = 2
    cache = init_cache(cfg, B, 16, device="cpu")
    logits, new_cache = decode_step(params, cache, torch.zeros((B,), dtype=torch.int32), cfg)
    assert tuple(logits.shape) == (B, cfg.padded_vocab)
    assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()
    assert int(new_cache["pos"][0]) == 1
    assert sorted(new_cache) == sorted(cache)
