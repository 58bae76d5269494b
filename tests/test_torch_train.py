"""The port's training path against the JAX package's on the CPU: the kernel
Functions' gradients against `jax.grad` of the reference oracles, the
wrappers without a backward refusing grad mode, `lm_loss`, the train step's
gradients and losses on the benchmarks' miniature Switch (`bench_cfg(8)`),
remat, AdamW and the schedule alone, a 20-step loss trajectory, and the
training launcher."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.hash_fn import sparsemax as jsparsemax
from repro.data.synthetic import SyntheticConfig as JSyntheticConfig, SyntheticLM as JSyntheticLM
from repro.kernels import ref as jref
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.attention import ShardingCtx
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.launch import steps, train
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw, schedule
from repro_torch.tree import (
    flatten, leaf_grads, requiring_grad, tree_leaves, tree_map, tree_stack, tree_unstack,
)

torch.set_num_threads(2)
CTX = ShardingCtx()
GRAD_TOL = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _grads_close(got, want, tol=GRAD_TOL):
    """|got - want| <= tol * max(1, max|want|), leaf by leaf."""
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape
        bound = tol * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= bound, (float(np.abs(g - w).max()), bound)


def _torch_grads(fn, arrays):
    ts = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    live = [t for t in ts if t is not None]
    return out, torch.autograd.grad(out, live)


# ---------------------------------------------------------------------------
# the kernels' Functions against jax.grad of the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,C,d,F,glu,act", [
    (2, 24, 32, 48, False, "gelu"), (3, 17, 32, 64, True, "gelu"),
    (2, 24, 32, 48, False, "silu"), (3, 9, 16, 32, True, "silu"),
])
def test_expert_ffn_grad_matches_jax(E, C, d, F, glu, act):
    xe, wi, wo = _np((E, C, d), 0), _np((E, d, F), 1, 0.2), _np((E, F, d), 2, 0.2)
    wg = _np((E, d, F), 3, 0.2) if glu else None
    ct = _np((E, C, d), 4)
    args = [xe, wi, wg, wo]

    def jf(*a):
        it = iter(a)
        x, i = next(it), next(it)
        g = next(it) if glu else None
        return jnp.sum(jref.expert_ffn_ref(x, i, g, next(it), act=act) * ct)

    live = [a for a in args if a is not None]
    want = jax.grad(jf, argnums=tuple(range(len(live))))(*live)

    def tf(x, i, g, o):
        return (ops.expert_ffn(x, i, g, o, act=act) * torch.from_numpy(ct)).sum()

    out, got = _torch_grads(tf, args)
    np.testing.assert_allclose(float(out.detach()), float(jf(*live)), rtol=1e-5)
    _grads_close(got, want)


@pytest.mark.parametrize("B,S,H,K,D,window,cap", [
    (2, 16, 4, 4, 32, 0, 0.0), (2, 20, 4, 2, 32, 0, 0.0),     # causal; GQA 2
    (1, 24, 4, 2, 32, 6, 0.0), (2, 16, 2, 2, 32, 0, 5.0),     # window; softcap
    (1, 24, 4, 2, 32, 8, 3.0),
])
def test_flash_prefill_grad_matches_jax(B, S, H, K, D, window, cap):
    q, k, v = _np((B, S, H, D), 0), _np((B, S, K, D), 1), _np((B, S, K, D), 2)
    ct = _np((B, S, H, D), 3)

    def jf(q, k, v):
        return jnp.sum(jref.flash_prefill_ref(q, k, v, window=window, cap=cap) * ct)

    want = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    out, got = _torch_grads(
        lambda q, k, v: (ops.flash_prefill(q, k, v, window=window, cap=cap)
                         * torch.from_numpy(ct)).sum(), [q, k, v])
    np.testing.assert_allclose(float(out.detach()), float(jf(q, k, v)), rtol=1e-5)
    _grads_close(got, want)


@pytest.mark.parametrize("case", ["plain", "masked", "ties"])
def test_sparsemax_grad_matches_jax(case):
    z = _np((3, 7, 12), 0, 2.0)
    if case == "masked":        # the predictor's causal rows: -1e30 above the diagonal
        z = np.where(np.tril(np.ones((7, 12), bool))[None], z, -1e30).astype(np.float32)
    if case == "ties":
        z[:, :, 4:8] = z[:, :, 3:4]
        z[0, 0] = 0.5
    ct = _np(z.shape, 1)
    want = jax.grad(lambda z: jnp.sum(jsparsemax(z) * ct))(z)
    out, got = _torch_grads(lambda z: (ops.sparsemax(z) * torch.from_numpy(ct)).sum(), [z])
    np.testing.assert_allclose(float(out.detach()), float(jnp.sum(jsparsemax(z) * ct)), rtol=1e-5)
    _grads_close(got, [want])


def test_kernels_without_a_backward_raise_under_grad():
    E, C, d, F = 2, 4, 16, 32
    xe = torch.randn(E, C, d, requires_grad=True)
    q8 = torch.zeros(E, d, F, dtype=torch.int8)
    s8 = torch.ones(E, 1, F)
    o8 = torch.zeros(E, F, d, dtype=torch.int8)
    so = torch.ones(E, 1, d)
    with pytest.raises(ValueError, match="expert_ffn_q: .*no backward"):
        ops.expert_ffn_q(xe, q8, s8, None, None, o8, so, act="gelu")
    q4 = torch.zeros(E, d // 2, F, dtype=torch.uint8)
    with pytest.raises(ValueError, match="expert_ffn_q4: .*no backward"):
        ops.expert_ffn_q4(xe, q4, torch.ones(E, 1, F), None, None,
                          torch.zeros(E, F // 2, d, dtype=torch.uint8), torch.ones(E, 1, d))
    B, S, H, D = 2, 8, 2, 16
    q = torch.randn(B, H, D, requires_grad=True)
    k = torch.randn(B, S, H, D)
    pos = torch.full((B,), S - 1, dtype=torch.int32)
    slot_pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()
    with pytest.raises(ValueError, match="flash_decode: .*no backward"):
        ops.flash_decode(q, k, k, slot_pos, pos)
    kp = torch.randn(3, 4, H, D)
    pt = torch.tensor([[0, 1], [1, -1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="flash_decode_paged: .*no backward"):
        ops.flash_decode_paged(q, kp, kp, pt, pos.clamp(max=7))
    # the same calls serve under no_grad, and without an input that needs grad
    with torch.no_grad():
        assert ops.flash_decode(q, k, k, slot_pos, pos).shape == (B, H, D)
        assert ops.expert_ffn_q(xe, q8, s8, None, None, o8, so, act="gelu").shape == (E, C, d)
    assert not ops.flash_decode_paged(q.detach(), kp, kp, pt, pos.clamp(max=7)).requires_grad


def test_wrappers_under_no_grad_return_the_plain_forward():
    z = torch.randn(2, 5, 9, requires_grad=True)
    with torch.no_grad():
        a = ops.sparsemax(z)
    b = ops.sparsemax(z)
    assert not a.requires_grad and b.requires_grad and b.grad_fn is not None
    assert torch.equal(a, b.detach())


# ---------------------------------------------------------------------------
# lm_loss, the train step, remat
# ---------------------------------------------------------------------------


def test_lm_loss_matches_jax():
    logits = _np((3, 11, 37), 0, 3.0)
    labels = np.random.default_rng(1).integers(0, 37, (3, 11)).astype(np.int32)
    labels[:, -2:] = -100
    want = float(jtr.lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(ttr.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    mask = labels >= 5
    want_m = float(jtr.lm_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
    got_m = float(ttr.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                              torch.from_numpy(mask)))
    assert abs(got_m - want_m) <= 1e-6 * max(1.0, abs(want_m))


def _bench_cfg(get):
    """`benchmarks/common.py::bench_cfg(8)`: the miniature Switch the
    committed sys_E8 system was trained at."""
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(cfg, n_layers=4, d_ff=128, moe=dataclasses.replace(
        cfg.moe, num_experts=8, top_k=1, capacity_factor=4.0, d_expert=512))


@pytest.fixture(scope="module")
def bench():
    jcfg, tcfg = _bench_cfg(jget_config), _bench_cfg(get_config)
    pj = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    data = JSyntheticLM(JSyntheticConfig(vocab_size=jcfg.vocab_size, seq_len=48, n_domains=8),
                        seed=0)
    toks, labels = next(data.batches(8, 1))
    return jcfg, tcfg, pj, toks, labels


def _jax_loss_and_grads(cfg, params, toks, labels):
    def loss_fn(p):
        out = jtr.forward(p, cfg, CTX, jnp.asarray(toks), scan_mode="assoc", remat=True)
        loss = jtr.lm_loss(out["logits"], jnp.asarray(labels))
        total = loss + cfg.moe.router_aux_coef * out["aux_loss"] + cfg.moe.router_z_coef * out["z_loss"]
        return total, (loss, out["aux_loss"], out["z_loss"])

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def test_train_step_gradients_match_jax(bench):
    jcfg, tcfg, pj, toks, labels = bench
    (jtotal, (jloss, jaux, jz)), jgrads = _jax_loss_and_grads(jcfg, pj, toks, labels)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj))
    total, m, grads = steps.loss_and_grads(tcfg, pt, torch.from_numpy(toks).long(),
                                           torch.from_numpy(labels).long())
    assert abs(float(m["aux_loss"]) - float(jaux)) <= 1e-6
    assert abs(float(m["z_loss"]) - float(jz)) <= 1e-6
    assert abs(float(total) - float(jtotal)) <= 1e-5 * max(1.0, abs(float(jtotal)))
    fj = flatten(jax.tree.map(np.asarray, jgrads))
    ft = flatten(grads)
    assert sorted(fj) == sorted(ft)
    for key in fj:
        g, w = ft[key].numpy(), fj[key]
        assert g.shape == w.shape, key
        bound = 1e-4 * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= bound, (key, float(np.abs(g - w).max()), bound)
    # the unrouted, non-gated w_gate gets zeros, as jax.grad gives it
    assert not ft["blocks/sub1/moe/w_gate"].any()


def test_remat_gradients_are_bit_equal(bench):
    _, tcfg, pj, toks, labels = bench
    pt = params_from_numpy(jax.tree.map(np.asarray, pj))
    t, l = torch.from_numpy(toks).long(), torch.from_numpy(labels).long()
    a_total, _, a = steps.loss_and_grads(tcfg, pt, t, l, remat=True)
    b_total, _, b = steps.loss_and_grads(tcfg, pt, t, l, remat=False)
    assert torch.equal(a_total, b_total)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_tree_unstack_inverts_tree_stack_and_stacks_its_gradient():
    """`tree_unstack` (the forward's per-group split of the stacked blocks)
    gives the leading-axis slices, and the gradient through it is the
    per-slice gradients stacked: that of indexing each slice."""
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, 5, generator=g), "b": {"c": torch.randn(3, 2, generator=g)}}
    parts = tree_unstack(tree)
    assert len(parts) == 3
    for a, b in zip(tree_leaves(tree_stack(parts)), tree_leaves(tree)):
        assert torch.equal(a, b)
    w = [torch.randn(4, 5, generator=g) for _ in range(3)]

    def loss(split):
        p = requiring_grad(tree)
        gs = split(p)
        total = sum((gs[i]["a"] * w[i]).sum() + gs[i]["b"]["c"].square().sum() * i
                    for i in range(3))
        return leaf_grads(total, p)

    by_unbind = loss(tree_unstack)
    by_index = loss(lambda p: [tree_map(lambda t: t[i], p) for i in range(3)])
    for a, b in zip(tree_leaves(by_unbind), tree_leaves(by_index)):
        assert torch.equal(a, b)


def test_loss_trajectory_matches_jax(bench):
    """20 steps of each package from the same weights and batches: every
    step's lm_loss within 1e-3 relative (params are not compared: AdamW's
    first steps move near-zero gradients by ±lr, where float noise decides
    the sign)."""
    jcfg, tcfg, pj, _, _ = bench
    data = JSyntheticLM(JSyntheticConfig(vocab_size=jcfg.vocab_size, seq_len=48, n_domains=8),
                        seed=3)
    batches = list(data.batches(8, 20))
    jstep = jax.jit(jmake_train_step(jcfg, CTX, lr=2e-3))
    jp, jo = pj, jadamw.adamw_init(pj)
    tstep = steps.make_train_step(tcfg, lr=2e-3)
    tp = params_from_numpy(jax.tree.map(np.asarray, pj))
    to = adamw.adamw_init(tp)
    for i, (toks, labels) in enumerate(batches):
        jp, jo, jm = jstep(jp, jo, jnp.asarray(toks), jnp.asarray(labels))
        tp, to, tm = tstep(tp, to, torch.from_numpy(toks), torch.from_numpy(labels))
        want, got = float(jm["lm_loss"]), float(tm["lm_loss"])
        assert abs(got - want) <= 1e-3 * abs(want), (i, got, want)
    assert to["t"] == 20


# ---------------------------------------------------------------------------
# AdamW and the schedule alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip,moments", [(0.0, "float32"), (1.0, "float32"), (0.5, "bfloat16")])
def test_adamw_matches_jax(clip, moments):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}}
    pj = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj))
    sj = jadamw.adamw_init(pj, moment_dtype=getattr(jnp, moments))
    st = adamw.adamw_init(pt, moment_dtype=getattr(torch, moments))
    for step in range(3):
        g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 3, jnp.float32), pj)
        gt = params_from_numpy(jax.tree.map(np.asarray, g))
        pj, sj = jadamw.adamw_update(g, pj, sj, lr=0.05, weight_decay=0.01, grad_clip=clip)
        pt, st = adamw.adamw_update(gt, pt, st, lr=0.05, weight_decay=0.01, grad_clip=clip)
    for tree_j, tree_t in ((pj, pt), (sj["m"], st["m"]), (sj["v"], st["v"])):
        fj, ft = flatten(jax.tree.map(lambda x: np.asarray(x, np.float32), tree_j)), flatten(tree_t)
        for k in fj:
            assert ft[k].dtype == (torch.float32 if tree_t is pt else getattr(torch, moments))
            np.testing.assert_allclose(ft[k].float().numpy(), fj[k], atol=1e-6, rtol=1e-6)
    assert st["t"] == int(sj["t"]) == 3


def test_adamw_optimizes():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.adamw_init(params)
    for _ in range(200):
        params, state = adamw.adamw_update({"w": 2 * params["w"]}, params, state, lr=0.1)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_grad_clip_and_bf16_params():
    params = {"w": torch.tensor([1.0]), "b": torch.ones(3, dtype=torch.bfloat16)}
    state = adamw.adamw_init(params, moment_dtype=torch.bfloat16)
    grads = {"w": torch.tensor([1e9]), "b": torch.full((3,), 1e9, dtype=torch.bfloat16)}
    p2, s2 = adamw.adamw_update(grads, params, state, lr=0.1, grad_clip=1.0)
    assert torch.isfinite(p2["w"]).all() and p2["b"].dtype == torch.bfloat16
    assert s2["m"]["w"].dtype == torch.bfloat16


def test_schedule():
    f = schedule.linear_warmup_cosine(1.0, warmup=10, total=110)
    assert f(0) < f(9) <= 1.0
    assert f(10) == pytest.approx(1.0)
    assert f(110) == pytest.approx(0.1, abs=1e-6)
    from repro.optim.schedule import linear_warmup_cosine as jsched
    g = jsched(3e-4, warmup=4, total=30)
    h = schedule.linear_warmup_cosine(3e-4, warmup=4, total=30)
    assert [g(i) for i in range(32)] == [h(i) for i in range(32)]


# ---------------------------------------------------------------------------
# the launcher and the thin step wrappers
# ---------------------------------------------------------------------------


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    params, hist = train.train("switch-base-8", steps=4, batch=2, seq=16, lr=1e-3,
                               reduced=True, ckpt=ck, log_every=1, device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(b["elapsed_s"] > a["elapsed_s"] for a, b in zip(hist, hist[1:]))
    from repro_torch.checkpoint import load_checkpoint
    back, manifest = load_checkpoint(ck)
    assert manifest["step"] == 4 and manifest["extra"]["arch"] == "switch-base-8"
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)
    train.main(["--arch", "switch-base-8", "--reduced", "--steps", "2", "--batch", "2",
                "--seq", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"dtype={get_config('switch-base-8').reduced().dtype}" in out and "step     1" in out


def test_prefill_and_serve_steps():
    cfg = get_config("switch-base-8").reduced()
    params = ttr.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6))
    last = steps.make_prefill_step(cfg)(params, toks)
    with torch.no_grad():
        full = ttr.forward(params, cfg, toks)["logits"]
    assert torch.equal(last, full[:, -1])
    cache = ttr.init_cache(cfg, 2, 8, device="cpu")
    logits, cache = steps.make_serve_step(cfg)(params, cache, toks[:, 0])
    assert logits.shape == (2, cfg.padded_vocab) and cache["pos"].tolist() == [1, 1]
    assert ttr.param_count(params) == sum(t.numel() for t in tree_leaves(params))
