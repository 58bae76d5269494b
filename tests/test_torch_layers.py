"""Port layers against `repro.models.layers` / `transformer` on the same
numpy inputs (fp32, CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.models.attention import ShardingCtx
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.tree import flatten

torch.set_num_threads(2)
TOL = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_rmsnorm_scales_by_one_plus_scale():
    x, s = _np((3, 5, 16), 0), _np((16,), 1, 0.1)
    got = tl.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x), 1e-6)
    _close(got, jl.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_act_fn_matches_jax(act):
    # gelu is jax.nn.gelu's tanh approximation, not torch's exact default
    x = _np((1000,), 2, 4.0)
    _close(tl.act_fn(act)(torch.from_numpy(x)), jl.act_fn(act)(jnp.asarray(x)))


@pytest.mark.parametrize("glu,act", [(False, "gelu"), (True, "silu")])
def test_ffn_matches_jax(glu, act):
    x = _np((2, 7, 16), 3)
    p = {"w_in": _np((16, 32), 4, 0.2), "w_out": _np((32, 16), 5, 0.2)}
    if glu:
        p["w_gate"] = _np((16, 32), 6, 0.2)
    got = tl.ffn({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), act, glu)
    _close(got, jl.ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act, glu))


def test_rope_split_halves_and_softcap():
    x = _np((2, 9, 3, 8), 7)
    pos = np.arange(9)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(got, jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    y = torch.from_numpy(_np((4, 6), 8, 40.0))
    _close(tl.softcap(y, 30.0), jl.softcap(jnp.asarray(y.numpy()), 30.0))
    assert tl.softcap(y, 0.0) is y


def test_top_k_breaks_ties_to_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tl.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    tids, tw = tmoe.router_topk(torch.from_numpy(x), 2)
    jids, jw = jmoe.router_topk(jnp.asarray(x), 2)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw)


def test_unembed_masks_padded_vocab():
    cfg_j = dataclasses.replace(jget_config("switch-base-8").reduced(), vocab_size=300)
    cfg_t = dataclasses.replace(get_config("switch-base-8").reduced(), vocab_size=300)
    assert cfg_t.padded_vocab == 512
    emb, x = _np((512, cfg_t.d_model), 9, 0.02), _np((2, 3, cfg_t.d_model), 10)
    got = ttr.unembed({"embed": torch.from_numpy(emb)}, cfg_t, torch.from_numpy(x))
    want = np.asarray(jtr.unembed({"embed": jnp.asarray(emb)}, cfg_j, jnp.asarray(x)))
    assert (got[..., 300:] == -1e30).all() and (want[..., 300:] == -1e30).all()
    _close(got[..., :300], want[..., :300])
    toks = np.array([[0, 5, 511]])
    _close(ttr.embed_tokens({"embed": torch.from_numpy(emb)}, cfg_t, torch.from_numpy(toks)),
           jtr.embed_tokens({"embed": jnp.asarray(emb)}, cfg_j, jnp.asarray(toks)))


def test_layer_layout_matches_jax():
    for name in ("switch-base-8", "switch-base-64"):
        cj, ct = jget_config(name), get_config(name)
        assert ttr.period(ct) == jtr.period(cj)
        assert ttr.n_moe_layers(ct) == jtr.n_moe_layers(cj)
        for s in range(ttr.period(ct)):
            sj = jtr.sub_kind(cj, s)
            assert ttr.sub_kind(ct, s) == {"kind": sj["kind"], "moe": sj["moe"], "window": sj["window"]}


def test_init_params_keys_shapes_dtypes_match_jax():
    cfg_j = jget_config("switch-base-8").reduced()
    pj = jtr.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = ttr.init_params(torch.Generator().manual_seed(0), get_config("switch-base-8").reduced(),
                         device="cpu")
    fj = flatten(jax.tree.map(np.asarray, pj))
    ft = flatten(pt)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert tuple(ft[k].shape) == fj[k].shape, k
        assert str(ft[k].dtype).replace("torch.", "") == fj[k].dtype.name, k
    # same seed -> same weights, on any target device
    again = ttr.init_params(torch.Generator().manual_seed(0), get_config("switch-base-8").reduced(),
                         device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(flatten(pt).values(), flatten(again).values()))


def test_forward_attention_dialect_matches_jax():
    """qkv bias, q/k norm, local windows, post norms, embed scale, untied
    head and final softcap through the whole forward (router mode, dense +
    MoE sublayers)."""
    def cfg(get):
        base = get("switch-base-8").reduced()
        return dataclasses.replace(
            base, n_layers=4, post_norm=True, embed_scale=True, tie_embeddings=False,
            final_logit_softcap=30.0, glu=True, act="silu",
            attn=dataclasses.replace(base.attn, qkv_bias=True, qk_norm=True, window=5,
                                     logit_softcap=20.0, layer_pattern=("local", "global")),
        )

    cfg_j, cfg_t = cfg(jget_config), cfg(get_config)
    pj = jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(3), cfg_j))
    # the zero-initialised biases and norm scales would hide a missing term
    rng = np.random.default_rng(4)
    pj = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
                      if a.ndim <= 2 and a.shape[-1] != 512 else a, pj)
    pt = params_from_numpy(pj)
    toks = rng.integers(0, cfg_t.vocab_size, (2, 12)).astype(np.int32)
    oj = jtr.forward(pj, cfg_j, ShardingCtx(), toks, collect_kv=True)
    ot = ttr.forward(pt, cfg_t, torch.from_numpy(toks), collect_kv=True)
    _close(ot["logits"], oj["logits"], 1e-4)
    _close(ot["aux_loss"], oj["aux_loss"], 1e-5)
    for sub in ("sub0", "sub1"):
        for a, b in zip(ot["kv"][sub], oj["kv"][sub]):
            _close(a, b, 1e-4)
