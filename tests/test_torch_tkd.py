"""The port's offline phase against the JAX package's on the CPU: the TKD
loss and its gradient, hash-function training on the reference test's
setup, the draft head's distillation, the `get_system(8)` recipe against the
committed `experiments/cache/sys_E8`, checkpoints across the two packages,
and the sparsity analyses."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as jload, save_checkpoint as jsave
from repro.configs.base import get_config as jget_config
from repro.core import hash_fn as jh
from repro.core import sparsity as jsp
from repro.core import tkd as jtkd
from repro.models import transformer as jtr
from repro.models.attention import ShardingCtx
from repro_torch import checkpoint as tck
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core import hash_fn as th
from repro_torch.core import sparsity as tsp
from repro_torch.core import tkd as ttkd
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import transformer as ttr
from repro_torch.optim.adamw import adamw_init
from repro_torch.tree import flatten, tree_leaves
from test_torch_train import _bench_cfg

torch.set_num_threads(2)
CTX = ShardingCtx()
SYS_E8 = os.path.join(os.path.dirname(__file__), "..", "experiments", "cache", "sys_E8")


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# tkd_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,lam,tau,ties", [(3, 0.005, 1.0, False), (8, 0.1, 2.0, False),
                                            (2, 0.005, 1.0, True)])
def test_tkd_loss_and_grad_match_jax(T, lam, tau, ties):
    B, S, L, E = 2, 5, 3, 8
    s = _np((B, S, L, E), 0, 2.0)
    t = _np((L, B, S, E), 1, 2.0)
    if ties:                 # the T-th logit tied: the mask keeps every tie
        t[..., 1:4] = t[..., :1]
    (jl, jm), jg = jax.value_and_grad(
        lambda s: jtkd.tkd_loss(s, jnp.asarray(t), T=T, lam=lam, tau=tau), has_aux=True)(s)
    st = torch.from_numpy(s).requires_grad_(True)
    tl, tm = ttkd.tkd_loss(st, torch.from_numpy(t), T=T, lam=lam, tau=tau)
    (tg,) = torch.autograd.grad(tl, st)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * max(1.0, abs(float(jl)))
    for k in ("kd", "ce", "acc"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * max(1.0, abs(float(jm[k]))), k
    jg = np.asarray(jg)
    assert float(np.abs(tg.numpy() - jg).max()) <= 1e-6 * max(1.0, float(np.abs(jg).max()))


# ---------------------------------------------------------------------------
# hash-function training, on tests/test_hash_fn.py::test_hash_fn_learns_router's setup
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def router_setup():
    jcfg = jget_config("switch-base-8").reduced()
    tcfg = get_config("switch-base-8").reduced()
    pj = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    E, L = jcfg.moe.num_experts, jtr.n_moe_layers(jcfg)
    hj = jh.init_hash_fn(jax.random.PRNGKey(7), jcfg.d_model, L, E, d_h=32)
    fixed = np.random.default_rng(0).integers(0, jcfg.vocab_size, (8, 16))
    return jcfg, tcfg, pj, hj, fixed


def test_train_hash_fn_learns_the_router_as_jax_does(router_setup):
    jcfg, tcfg, pj, hj, fixed = router_setup
    E = jcfg.moe.num_experts

    toks = jnp.asarray(fixed)
    jout = jtr.forward(pj, jcfg, CTX, toks, collect_router_logits=True)
    jemb = jnp.take(pj["embed"], toks, axis=0)

    def jbatches():
        while True:
            yield jemb, jout["router_logits"]

    hj2, _ = jtkd.train_hash_fn(hj, jbatches(), steps=120, lr=3e-3, T=E, verbose=False)
    jm = jtkd.evaluate_hash_fn(hj2, jemb, jout["router_logits"], top=3)

    pt = _carry(pj)
    tt = torch.from_numpy(fixed)
    with torch.no_grad():
        tout = ttr.forward(pt, tcfg, tt, collect_router_logits=True)
    temb = pt["embed"][tt]

    def tbatches():
        while True:
            yield temb, tout["router_logits"]

    ht2, hist = ttkd.train_hash_fn(_carry(hj), tbatches(), steps=120, lr=3e-3, T=E,
                                   log_every=10, verbose=False)
    tm = ttkd.evaluate_hash_fn(ht2, temb, tout["router_logits"], top=3)
    for m in (jm, tm):
        assert m["top1_hit"] > 2.0 / E, m      # the reference test's bar
        assert m["top3_hit"] > m["top1_hit"] - 1e-9
    assert abs(tm["top1_hit"] - jm["top1_hit"]) <= 0.02, (tm, jm)
    assert abs(tm["top3_hit"] - jm["top3_hit"]) <= 0.02, (tm, jm)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert th.hash_fn_param_count(ht2) == jh.hash_fn_param_count(hj2)


def test_hash_hit_rate_matches_jax():
    logits = np.round(_np((3, 7, 2, 8), 0), 1)     # rounded: ties among the top
    ids = np.random.default_rng(1).integers(0, 8, (2, 3, 7))
    for top in (1, 3):
        want = float(jh.hash_hit_rate(jnp.asarray(logits), jnp.asarray(ids), top=top))
        got = float(th.hash_hit_rate(torch.from_numpy(logits), torch.from_numpy(ids), top=top))
        assert got == want


def test_train_draft_head_trains_draft_proj_alone(router_setup):
    jcfg, tcfg, pj, hj, fixed = router_setup
    pt = _carry(pj)
    hp = th.init_draft_head(torch.Generator().manual_seed(7), _carry(hj), tcfg.d_model)
    tt = torch.from_numpy(fixed)
    with torch.no_grad():
        lm = ttr.forward(pt, tcfg, tt)["logits"]
    emb = pt["embed"][tt]

    def batches():
        while True:
            yield emb, lm

    before = {k: v.clone() for k, v in flatten(hp).items()}
    out, hist = ttkd.train_draft_head(hp, pt["embed"], batches(), steps=30,
                                      num_experts=jcfg.moe.num_experts, lr=3e-3)
    after = flatten(out)
    assert sorted(after) == sorted(before)
    for k in before:
        if k == "draft_proj":
            assert not torch.equal(after[k], before[k])
        else:
            assert torch.equal(after[k], before[k]), k
    assert hist[-1]["loss"] < hist[0]["loss"]


# ---------------------------------------------------------------------------
# the get_system(8) recipe against the committed sys_E8
# ---------------------------------------------------------------------------


def _held_out(params, cfg, n=4, seed=11):
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=48, n_domains=8),
                       seed=seed)
    out = []
    for _ in range(n):
        toks = torch.from_numpy(data.sample(8)[0]).long()
        with torch.no_grad():
            rl = ttr.forward(params, cfg, toks, collect_router_logits=True)["router_logits"]
        out.append((params["embed"][toks], rl))
    return out


def _hits(hp, batches):
    ms = [ttkd.evaluate_hash_fn(hp, e, rl, top=3) for e, rl in batches]
    return {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}


def test_get_system_recipe_reaches_the_committed_hit_rates():
    """benchmarks/common.py::get_system(8) in the port, from the JAX inits:
    80 LM steps at lr 2e-3, then 150 TKD steps at lr 3e-3, T 8, on the same
    data stream; the trained predictor's held-out hit rates against its own
    model's router within 0.03 of the committed sys_E8 predictor's against
    the committed model's."""
    jcfg, cfg = _bench_cfg(jget_config), _bench_cfg(get_config)
    E = cfg.moe.num_experts
    params = _carry(jtr.init_params(jax.random.PRNGKey(0), jcfg))
    hp = _carry(jh.init_hash_fn(jax.random.PRNGKey(1), jcfg.d_model, jtr.n_moe_layers(jcfg), E,
                                d_h=32))
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=48, n_domains=8), seed=0)
    step = steps.make_train_step(cfg, lr=2e-3)
    opt = adamw_init(params)
    for toks, labels in data.batches(8, 80):
        params, opt, m = step(params, opt, torch.from_numpy(toks), torch.from_numpy(labels))
    assert np.isfinite(float(m["lm_loss"]))

    def batches():
        while True:
            toks = torch.from_numpy(data.sample(8)[0]).long()
            with torch.no_grad():
                rl = ttr.forward(params, cfg, toks, collect_router_logits=True)["router_logits"]
            yield params["embed"][toks], rl

    hp, _ = ttkd.train_hash_fn(hp, batches(), steps=150, lr=3e-3, T=min(30, E), verbose=False)
    got = _hits(hp, _held_out(params, cfg))

    sys_params, _ = tck.load_checkpoint(os.path.join(SYS_E8, "model"))
    sys_hp, _ = tck.load_checkpoint(os.path.join(SYS_E8, "hash"))
    want = _hits(sys_hp, _held_out(sys_params, cfg))
    for k in ("top1_hit", "top3_hit"):
        assert abs(got[k] - want[k]) <= 0.03, (k, got, want)
    assert got["top1_hit"] > 2.0 / E


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {
        "a": rng.standard_normal((2, 3)).astype(np.float32),
        "nested": {"b": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
                   "c": rng.integers(-5, 5, (4,)).astype(np.int32)},
    }


def test_port_checkpoint_loads_in_jax(tmp_path):
    tree = _carry(_mixed_tree())
    assert tree["nested"]["b"].dtype == torch.bfloat16
    tck.save_checkpoint(str(tmp_path / "ck"), tree, step=7, extra={"note": "x"})
    like = jax.tree.map(jnp.asarray, _mixed_tree())
    back, manifest = jload(str(tmp_path / "ck"), like=like)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    assert manifest["keys"]["nested/b"]["dtype"] == "bfloat16"
    fj, ft = flatten(jax.tree.map(np.asarray, back)), flatten(tree)
    for k in ft:
        assert str(fj[k].dtype) == str(ft[k].dtype).replace("torch.", "")
        np.testing.assert_array_equal(fj[k].astype(np.float32), ft[k].float().numpy())
    assert not [f for f in os.listdir(tmp_path / "ck") if f.endswith(".tmp.npz")]


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    tree = jax.tree.map(jnp.asarray, _mixed_tree())
    jsave(str(tmp_path / "ck"), tree, step=3)
    back, manifest = tck.load_checkpoint(str(tmp_path / "ck"))
    assert manifest["step"] == 3
    fj, ft = flatten(jax.tree.map(np.asarray, tree)), flatten(back)
    for k in fj:
        assert str(ft[k].dtype).replace("torch.", "") == str(fj[k].dtype)
        np.testing.assert_array_equal(ft[k].float().numpy(), fj[k].astype(np.float32))
    # and back through the port's writer, bit for bit
    tck.save_checkpoint(str(tmp_path / "ck2"), back)
    again, _ = tck.load_checkpoint(str(tmp_path / "ck2"))
    for x, y in zip(tree_leaves(back), tree_leaves(again)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# sparsity analyses (tests/test_sparsity.py, against the JAX functions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,L", [(1, 128), (3, 512), (8, 128)])
def test_eq2_and_estimate_c_match_jax(c, L):
    ps = [0.0, 0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0]
    assert [tsp.expected_phat(p, c, L) for p in ps] == [jsp.expected_phat(p, c, L) for p in ps]
    phats = [jsp.expected_phat(p, c, L) for p in ps[1:-1]]
    assert tsp.estimate_c(ps[1:-1], phats, L) == jsp.estimate_c(ps[1:-1], phats, L) == c
    assert tsp.expected_phat(0.0, 2, 512) == pytest.approx(0.0, abs=1e-9)
    assert tsp.expected_phat(1.0, 1, 512) == pytest.approx(1.0, abs=1e-6)


def test_sentence_sparsity_and_memory_utilization_match_jax():
    L, B, S, E = 2, 3, 16, 8
    rng = np.random.default_rng(0)
    ids = np.zeros((L, B, S), np.int64)
    ids[:, 1] = rng.integers(0, E, (L, S))
    ids[:, 2] = np.arange(S) % E
    np.testing.assert_array_equal(tsp.sentence_sparsity(ids, E), jsp.sentence_sparsity(ids, E))
    for name in ("switch-base-8", "switch-base-128"):
        for idle in (0.0, 0.8):
            assert (tsp.effective_memory_utilization(get_config(name), idle)
                    == jsp.effective_memory_utilization(jget_config(name), idle))


def test_routing_ids_and_corruption_study_match_jax(router_setup):
    jcfg, tcfg, pj, _, fixed = router_setup
    pt = _carry(pj)
    np.testing.assert_array_equal(tsp.routing_ids(pt, tcfg, fixed),
                                  jsp.routing_ids(pj, jcfg, fixed))
    for mode in ("token", "position"):
        kw = dict(ps=[0.1, 0.5], n_positions=2, n_trials=2, mode=mode, seed=3)
        want = jsp.corruption_study(pj, jcfg, fixed[:2], **kw)
        got = tsp.corruption_study(pt, tcfg, fixed[:2], **kw)
        assert got == want, mode
