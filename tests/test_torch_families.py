"""The hybrid, recurrent and encoder-decoder families through the port
against the JAX package on the CPU: hymba-1.5b (parallel attention and
Mamba), xlstm-125m (mLSTM / sLSTM) and seamless-m4t-medium (encoder,
decoder and cross-attention) at `reduced()` size, fp32, JAX's weights
carried over by `params_from_numpy`. `forward`, `decode_step` with its
recurrent states and cross caches, the ring wrap and `verify_step`'s
rollback of recurrent states (the LM-loss gradients and the training
launcher: test_torch_families_train.py); tolerance 1e-4 as in
test_torch_models, decode against forward 5e-3 as the reference's
tests/test_decode_consistency.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import transformer as jtr
from repro.models.attention import ShardingCtx
from repro.models.attention import _project_kv as j_project_kv
from repro.models.layers import rmsnorm as jrmsnorm
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core.residency import PagedKVConfig
from repro_torch.models import transformer as ttr
from repro_torch.models.attention import _project_kv
from repro_torch.tree import flatten, tree_map

torch.set_num_threads(2)
TOL = 1e-4
CTX = ShardingCtx()
ARCHS = ["hymba-1.5b", "xlstm-125m", "seamless-m4t-medium"]
ENC_LEN = 8

_SYSTEMS: dict = {}


def _cfgs(name, window=None):
    cj, ct = jget_config(name).reduced(), get_config(name).reduced()
    if window is not None:
        cj, ct = (dataclasses.replace(c, attn=dataclasses.replace(c.attn, window=window))
                  for c in (cj, ct))
    return cj, ct


def system(name, window=None):
    """(cfg_j, cfg_t, JAX params, their numpy copy, the port's params), cached."""
    key = (name, window)
    if key not in _SYSTEMS:
        cj, ct = _cfgs(name, window)
        pj = jtr.init_params(jax.random.PRNGKey(0), cj)
        pn = jax.tree.map(np.asarray, pj)
        _SYSTEMS[key] = (cj, ct, pj, pn, params_from_numpy(pn))
    return _SYSTEMS[key]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _toks(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _enc(cfg, B, seed=3):
    if not cfg.enc_dec:
        return None
    return np.random.default_rng(seed).normal(size=(B, ENC_LEN, cfg.d_model)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _caches(name, B, budget, enc=None, window=None):
    """Fresh JAX and port caches; an encoder-decoder config's cross caches
    seeded from each package's own encoder over `enc`, as
    tests/test_decode_consistency.py::test_encdec_decode_with_cross_cache."""
    cj, ct, pj, _, pt = system(name, window)
    jc = jtr.init_cache(cj, B, budget, enc_len=ENC_LEN if cj.enc_dec else 0)
    tc = ttr.init_cache(ct, B, budget, device="cpu", enc_len=ENC_LEN if ct.enc_dec else 0)
    if cj.enc_dec:
        e, _ = jtr._run_stack(pj["enc_blocks"], jnp.asarray(enc), cj, CTX, False, None, None,
                              False, "scan")
        jout = jrmsnorm(pj["enc_norm"], e, cj.norm_eps)
        tout = ttr._encode(pt, ct, torch.from_numpy(enc))
        _close(tout.numpy(), np.asarray(jout))
        G = cj.n_layers // jtr.period(cj)
        jk = [j_project_kv(jax.tree.map(lambda x: x[g], pj["blocks"])["sub0"]["xattn"], jout, cj)
              for g in range(G)]
        jc["sub0"]["cross_k"] = jnp.stack([k for k, _ in jk])
        jc["sub0"]["cross_v"] = jnp.stack([v for _, v in jk])
        for g in range(G):
            k, v = _project_kv(tree_map(lambda x: x[g], pt["blocks"])["sub0"]["xattn"], tout, ct)
            tc["sub0"]["cross_k"][g], tc["sub0"]["cross_v"][g] = k, v
    return jc, tc


def _leaves_close(tc, jc, tol=TOL):
    ft, fj = flatten(tc), flatten(jax.tree.map(np.asarray, jc))
    assert sorted(ft) == sorted(fj)
    for key in fj:
        got, want = ft[key].numpy(), fj[key]
        assert got.shape == want.shape, key
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            _close(got, want, tol)


def test_configs_registered_with_their_block_kinds():
    kinds = {n: (get_config(n).block_kind, get_config(n).enc_dec) for n in ARCHS}
    assert kinds == {"hymba-1.5b": ("hymba", False), "xlstm-125m": ("xlstm", False),
                     "seamless-m4t-medium": ("attn", True)}
    assert ttr.period(get_config("xlstm-125m")) == 2
    assert [ttr.sub_kind(get_config("xlstm-125m"), s)["cell"] for s in (0, 1)] == ["m", "s"]
    for name in ARCHS:
        cj, ct = _cfgs(name)
        for s in range(ttr.period(ct)):
            assert ttr.sub_kind(ct, s) == jtr.sub_kind(cj, s)


@pytest.mark.parametrize("name", ARCHS)
def test_params_match_jax_tree(name):
    """The port's own init draws the JAX tree's leaves: the same keys,
    shapes and dtypes (A_log and D fp32 whatever the model dtype)."""
    for dtype in ("float32", "bfloat16"):
        cj, ct = (dataclasses.replace(c, dtype=dtype) for c in _cfgs(name))
        fj = flatten(jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), cj)))
        ft = flatten(ttr.init_params(torch.Generator().manual_seed(0), ct, device="cpu"))
        assert sorted(fj) == sorted(ft)
        for key, sd in fj.items():
            assert tuple(ft[key].shape) == tuple(sd.shape), key
            assert str(ft[key].dtype).replace("torch.", "") == str(sd.dtype), key


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mode", ["assoc", "scan"])
def test_forward_matches_jax(name, mode):
    cj, ct, pj, _, pt = system(name)
    toks, enc = _toks(ct, 2, 24), _enc(ct, 2)
    oj = jtr.forward(pj, cj, CTX, jnp.asarray(toks), enc_input=_j(enc), scan_mode=mode)
    ot = ttr.forward(pt, ct, torch.from_numpy(toks), enc_input=_t(enc), scan_mode=mode)
    V = ct.vocab_size
    _close(ot["logits"][..., :V].numpy(), np.asarray(oj["logits"])[..., :V])


def test_encoder_decoder_forward_needs_enc_input():
    _, ct, _, _, pt = system("seamless-m4t-medium")
    with pytest.raises(ValueError, match="enc_input"):
        ttr.forward(pt, ct, torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_jax(name):
    """Twelve steps from a fresh cache: the logits at every step and every
    cache leaf (ring K/V, recurrent states, cross caches, pos) at the end."""
    cj, ct, pj, _, pt = system(name)
    B, steps_ = 3, 12
    jc, tc = _caches(name, B, 16, _enc(ct, B))
    jstep = jax.jit(lambda p, c, t: jtr.decode_step(p, c, t, cj, CTX))
    toks, V = _toks(ct, B, steps_, seed=4), ct.vocab_size
    for i in range(steps_):
        lj, jc = jstep(pj, jc, jnp.asarray(toks[:, i]))
        lt, tc = ttr.decode_step(pt, tc, torch.from_numpy(toks[:, i]), ct)
        _close(lt[:, :V].numpy(), np.asarray(lj)[:, :V])
    _leaves_close(tc, jc)


@pytest.mark.parametrize("name,window", [("hymba-1.5b", None), ("xlstm-125m", None),
                                         ("seamless-m4t-medium", None), ("hymba-1.5b", 8)])
def test_decode_matches_forward(name, window):
    """The reference's test_decode_matches_forward (and, at window 8 over a
    ring of 8 and 20 tokens, its test_ring_buffer_window_decode): the last
    decoded logits against the full forward's, within 5e-3 relative."""
    cj, ct, _, _, pt = system(name, window)
    B, S = (1, 20) if window else (2, 12)
    toks, enc = _toks(ct, B, S), _enc(ct, B)
    ref = ttr.forward(pt, ct, torch.from_numpy(toks), enc_input=_t(enc),
                      scan_mode="scan")["logits"][:, -1]
    _, tc = _caches(name, B, window or 16, enc, window)
    for t in range(S):
        logits, tc = ttr.decode_step(pt, tc, torch.from_numpy(toks[:, t]), ct)
    if window:
        assert tc["sub0"]["k"].shape[2] == window < S
    err = float((logits - ref).abs().max() / ref.abs().max())
    assert err < 5e-3, err


def test_ring_wrap_matches_jax():
    """hymba at window 8 over a ring of 8, 20 steps: the port's logits and
    cache against JAX's at every step past the wrap."""
    cj, ct, pj, _, pt = system("hymba-1.5b", 8)
    jc, tc = _caches("hymba-1.5b", 2, 8, window=8)
    jstep = jax.jit(lambda p, c, t: jtr.decode_step(p, c, t, cj, CTX))
    toks, V = _toks(ct, 2, 20, seed=6), ct.vocab_size
    for i in range(20):
        lj, jc = jstep(pj, jc, jnp.asarray(toks[:, i]))
        lt, tc = ttr.decode_step(pt, tc, torch.from_numpy(toks[:, i]), ct)
        _close(lt[:, :V].numpy(), np.asarray(lj)[:, :V])
    _leaves_close(tc, jc)


def _verify_case(name, kb=4, window=None, steps=5):
    """A cache advanced by `steps` steps, then a block whose drafts are the
    model's own greedy tokens for the first two positions and wrong after:
    lane 0 accepts 3, lane 1 (drafts all wrong) 1, lane 2 is inactive."""
    cj, ct, pj, _, pt = system(name, window)
    B = 3
    enc = _enc(ct, B)
    jc, tc = _caches(name, B, window or 16, enc, window)
    toks = _toks(ct, B, steps, seed=8)
    for i in range(steps):
        jl, jc = jtr.decode_step(pj, jc, jnp.asarray(toks[:, i]), cj, CTX)
        tl, tc = ttr.decode_step(pt, tc, torch.from_numpy(toks[:, i]), ct)
    # the greedy continuation, from a copy of the port's cache
    probe = tree_map(lambda t: t.clone(), tc)
    last = torch.argmax(tl, -1).to(torch.int32)
    greedy, tok = [], last
    for _ in range(kb):
        lg, probe = ttr.decode_step(pt, probe, tok, ct)
        tok = torch.argmax(lg, -1).to(torch.int32)
        greedy.append(tok)
    block = torch.stack([last] + greedy[:kb - 1], dim=1)       # [B, kb]
    block[0, 3:] = (block[0, 3:] + 1) % ct.vocab_size           # lane 0: 2 drafts right
    block[1, 1:] = (block[1, 1:] + 1) % ct.vocab_size           # lane 1: none right
    active = torch.tensor([True, True, False])
    return cj, ct, pj, pt, jc, tc, block, active


@pytest.mark.parametrize("name", ARCHS)
def test_verify_rollback_equals_the_accepted_prefix(name):
    """After verify_step, every cache leaf (ring K/V and recurrent states)
    is bit-equal to stepping each lane's accepted prefix alone; the
    inactive lane keeps its pre-block cache."""
    _check_rollback(name, *_verify_case(name))


def _check_rollback(name, cj, ct, pj, pt, jc, tc, block, active):
    before = tree_map(lambda t: t.clone(), tc)
    out, n_acc, _, vc = ttr.verify_step(pt, tree_map(lambda t: t.clone(), tc), block, ct,
                                        active=active)
    assert n_acc.tolist() == [3, 1, 0]
    for lane in range(3):
        ref = tree_map(lambda t: t.clone(), before)
        for i in range(int(n_acc[lane])):
            _, ref = ttr.decode_step(pt, ref, block[:, i], ct)
        for skey in (k for k in vc if k.startswith("sub")):
            for key, t in flatten(vc[skey]).items():
                r = flatten(ref[skey])[key]
                assert torch.equal(t[:, lane], r[:, lane]), (name, lane, skey, key)
    assert vc["pos"].tolist() == (before["pos"] + n_acc).tolist()


@pytest.mark.parametrize("name", ARCHS)
def test_verify_step_matches_jax(name):
    _verify_matches_jax(*_verify_case(name))


def test_verify_after_the_ring_wraps():
    """hymba at window 8 over a ring of 8, 10 steps, then the block: its
    writes overwrite slots across the wrap. The rollback bit-equal to the
    accepted prefix, and the result within 1e-4 of JAX's verify_step."""
    case = _verify_case("hymba-1.5b", window=8, steps=10)
    tc = case[5]
    assert tc["sub0"]["k"].shape[2] == 8 and tc["pos"].min() == 10
    _check_rollback("hymba-1.5b", *case)        # verify_step on a clone: tc stays as it was
    _verify_matches_jax(*case)


def _verify_matches_jax(cj, ct, pj, pt, jc, tc, block, active):
    jout, jn, jlg, jvc = jtr.verify_step(pj, jc, jnp.asarray(block.numpy()), cj, CTX,
                                         active=jnp.asarray(active.numpy()))
    tout, tn, tlg, tvc = ttr.verify_step(pt, tc, block, ct, active=active)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    V = ct.vocab_size
    _close(tlg[..., :V].numpy(), np.asarray(jlg)[..., :V])
    _leaves_close(tvc, jvc)


@pytest.mark.parametrize("name", ARCHS)
def test_serving_launcher_refuses_these_archs(name):
    """The reference's launcher asserts cfg.moe.enabled; the port's refuses
    the same archs before it draws any weight."""
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="MoE architectures"):
        serve.main(["--arch", name, "--device", "cpu", "--batches", "1", "--batch", "1",
                    "--seq", "4"])


@pytest.mark.parametrize("name", ARCHS)
def test_paged_cache_and_chunked_prefill_refuse_these_archs(name):
    cj, ct, _, _, pt = system(name)
    paged = PagedKVConfig(page_size=4, kv_pages=8, max_seq=16)
    with pytest.raises(AssertionError):
        jtr.init_paged_cache(cj, 1, paged)
    with pytest.raises(ValueError, match="attention-family decoder-only"):
        ttr.init_paged_cache(ct, 1, paged, device="cpu")
    with pytest.raises(ValueError, match="attention-family decoder-only"):
        ttr.prefill_chunk_step(pt, {"pos": torch.zeros(1, dtype=torch.int32),
                                    "page_table": torch.zeros((1, 4), dtype=torch.int32)},
                               torch.zeros((1, 4), dtype=torch.int32), ct)
