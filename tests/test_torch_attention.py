"""Port `attend_full` against `repro.models.attention.attend_full` (fp32,
CPU): causal, sliding window, softcap, GQA, the `Q_CHUNK` query chunking
with window banding at S > Q_CHUNK, and `return_kv`; and the split decode
kernels' merge of per-rank partials (`decode_attention_local`) against
`repro.kernels.ref`'s decode oracles."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.kernels.ref import flash_decode_paged_ref as j_flash_decode_paged_ref
from repro.kernels.ref import flash_decode_ref as j_flash_decode_ref
from repro.models.attention import ShardingCtx
from repro.models.attention import attend_full as j_attend_full
from repro.models.attention import init_attention as j_init_attention
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models.attention import Q_CHUNK, attend_full, decode_attention_local

torch.set_num_threads(2)
TOL = 1e-4


def _pair(d_model, n_heads, n_kv_heads, head_dim, window=0, cap=0.0, local=False):
    attn = dict(window=window, logit_softcap=cap,
                layer_pattern=("local",) if local else ("global",))
    out = []
    for get in (jget_config, get_config):
        base = get("switch-base-8").reduced()
        out.append(dataclasses.replace(
            base, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, attn=dataclasses.replace(base.attn, **attn),
        ))
    return out


@pytest.mark.parametrize("S,d,H,K,hd,window,cap,causal", [
    (40, 32, 4, 2, 8, 0, 0.0, True),
    (40, 32, 4, 4, 8, 12, 0.0, True),
    (33, 32, 4, 1, 8, 0, 20.0, True),
    (25, 32, 2, 2, 16, 0, 0.0, False),
    (Q_CHUNK + 77, 16, 2, 1, 8, 0, 0.0, True),      # chunked queries
    (Q_CHUNK + 300, 16, 2, 2, 8, 200, 0.0, True),   # chunked + window banding
])
def test_attend_full_matches_jax(S, d, H, K, hd, window, cap, causal):
    cfg_j, cfg_t = _pair(d, H, K, hd, window, cap, local=bool(window))
    pj = jax.tree.map(np.asarray, j_init_attention(jax.random.PRNGKey(0), cfg_j))
    pt = params_from_numpy(pj)
    x = np.random.default_rng(1).standard_normal((2, S, d)).astype(np.float32)
    yj, (kj, vj) = j_attend_full(pj, x, cfg_j, 0, ShardingCtx(), causal=causal, return_kv=True)
    yt, (kt, vt) = attend_full(pt, torch.from_numpy(x), cfg_t, 0, causal=causal, return_kv=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL, rtol=TOL)
    assert torch.equal(attend_full(pt, torch.from_numpy(x), cfg_t, 0, causal=causal), yt)


# ---------------------------------------------------------------------------
# split-S decode: the merge algebra of the split decode kernels
# (csrc/flash_decode.cu), on the CPU against the JAX oracles
# ---------------------------------------------------------------------------

NEG = -1e30
SPLIT_TOL = 1e-5


def _rank_runs(n_keys, tile, splits):
    """The kernels' split: tiles of `tile` keys, rank r owning tiles
    [r·T / splits, (r + 1)·T / splits) of the T, keys below n_keys."""
    T = -(-n_keys // tile)
    return [(r * T // splits * tile, min(n_keys, (r + 1) * T // splits * tile))
            for r in range(splits)]


def _split_merge(q, k, v, sp, pos, window, cap, runs):
    """`decode_attention_local` on each rank's run of keys (an empty run is
    the partial o = 0, l = 0, m = -1e30), then the safe-softmax merge of
    the partials in rank order."""
    B, H, D = q.shape
    parts = []
    for lo, hi in runs:
        if hi > lo:
            parts.append(decode_attention_local(q, k[:, lo:hi], v[:, lo:hi], sp[:, lo:hi], pos,
                                                window, cap))
        else:
            parts.append((torch.zeros(B, H, D), torch.zeros(B, H), torch.full((B, H), NEG)))
    m_g = parts[0][2]
    for _, _, m in parts[1:]:
        m_g = torch.maximum(m_g, m)
    l_g, o_g = torch.zeros(B, H), torch.zeros(B, H, D)
    for o, l, m in parts:
        sc = torch.exp(m - m_g)
        l_g = l_g + l * sc
        o_g = o_g + o * sc[..., None]
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


@pytest.mark.parametrize("case", ["empty run", "masked run", "invalid lane", "window in one run",
                                  "ring wrap, G 4, cap"])
def test_split_decode_merge_matches_jax(case):
    B, S, H, K, D, tile, splits, window, cap = 3, 64, 4, 4, 16, 16, 4, 0, 0.0
    pos = np.array([S - 1, 40, S - 1])
    s_idx = np.arange(S)[None, :]
    sp = np.where(s_idx <= pos[:, None], s_idx, -1)           # linear slots up to pos
    if case == "empty run":            # 7 tiles over 8 ranks: rank 0 has no key
        S, tile, splits = 100, 16, 8
        pos = np.array([99, 150, 7])
        sp = pos[:, None] - ((pos[:, None] - np.arange(S)[None, :]) % S)
        sp = np.where(sp >= 0, sp, -1)
    elif case == "masked run":         # lane 0's first run is all masked, the others not
        sp[0, :16] = -1
        sp[2, 16:32] = -1
    elif case == "invalid lane":       # lane 1 has no valid slot: V averaged over all S
        sp[1, :] = -1
    elif case == "window in one run":  # keys 71..90 lie in rank 2's run [64, 96)
        S, tile, splits, window = 128, 16, 4, 20
        pos = np.array([90, 90, 127])
        sp = np.where(np.arange(S)[None, :] <= pos[:, None], np.arange(S)[None, :], -1)
    elif case == "ring wrap, G 4, cap":
        S, H, K, cap, window = 80, 8, 2, 5.0, 30
        pos = np.array([200, 79, 33])
        sp = pos[:, None] - ((pos[:, None] - np.arange(S)[None, :]) % S)
        sp = np.where(sp >= 0, sp, -1)
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    sp, pos = sp.astype(np.int32), pos.astype(np.int32)
    runs = _rank_runs(S, tile, splits)
    if case == "empty run":
        assert runs[0][1] <= runs[0][0]
    got = _split_merge(*(torch.from_numpy(a) for a in (q, k, v, sp, pos)), window, cap, runs)
    want = np.asarray(j_flash_decode_ref(q, k, v, sp, pos, window=window, cap=cap))
    np.testing.assert_allclose(got.numpy(), want, atol=SPLIT_TOL, rtol=SPLIT_TOL)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (9, 0.0), (6, 20.0)])
def test_split_paged_decode_merge_matches_jax(window, cap):
    """The paged kernel's algebra: each lane's live entries (allocated, and
    overlapping the causal / window band) compacted in table order into a
    page list, or, for a lane with no valid key, every entry with -1 read
    through the trash page; the list's pages back to back are the keys, at
    their global positions, split into the ranks' runs and merged."""
    H, K, D, page, Mp, tile, splits = 4, 2, 16, 4, 8, 8, 4
    table = np.array([
        [0, 1, 2, 3, 4, 5, 6, 7],             # full
        [-1, 8, -1, 9, 10, -1, 11, 12],       # spilled entries
        [13, -1, -1, -1, -1, -1, -1, -1],     # one live page, fewer than the ranks
        [-1, -1, -1, -1, -1, -1, -1, -1],     # no valid key
        [-1, -1, -1, -1, -1, -1, -1, 14],     # its only page the last entry
    ], np.int32)
    pos = np.array([Mp * page - 1, Mp * page - 2, 3, 10, Mp * page - 1], np.int32)
    B, P1 = table.shape[0], 16
    rng = np.random.default_rng(12)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P1, page, K, D)).astype(np.float32)
    vp = rng.standard_normal((P1, page, K, D)).astype(np.float32)
    got = []
    for b in range(B):
        lo = pos[b] - window + 1 if window else 0
        live = [i for i in range(Mp) if table[b, i] >= 0 and i * page <= pos[b]
                and i * page + page - 1 >= lo]
        if live:
            pages, spos = [table[b, i] for i in live], [i * page for i in live]
        else:
            pages = [t if t >= 0 else P1 - 1 for t in table[b]]
            spos = [None] * Mp
        kb = np.concatenate([kp[t] for t in pages])[None]
        vb = np.concatenate([vp[t] for t in pages])[None]
        sb = np.concatenate([np.arange(s, s + page) if s is not None else np.full(page, -1)
                             for s in spos]).astype(np.int32)[None]
        runs = _rank_runs(kb.shape[1], tile, splits)
        got.append(_split_merge(*(torch.from_numpy(a) for a in (q[b:b + 1], kb, vb, sb,
                                                                pos[b:b + 1])),
                                window, cap, runs)[0])
    # lane 2's one page: ranks 0..2 hold no key
    assert [hi > lo for lo, hi in _rank_runs(page, tile, splits)] == [False, False, False, True]
    want = np.asarray(j_flash_decode_paged_ref(q, kp, vp, table, pos, window=window, cap=cap))
    np.testing.assert_allclose(torch.stack(got).numpy(), want, atol=SPLIT_TOL, rtol=SPLIT_TOL)
