"""Port `attend_full` against `repro.models.attention.attend_full` (fp32,
CPU): causal, sliding window, softcap, GQA, the `Q_CHUNK` query chunking
with window banding at S > Q_CHUNK, and `return_kv`."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.attention import ShardingCtx
from repro.models.attention import attend_full as j_attend_full
from repro.models.attention import init_attention as j_init_attention
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models.attention import Q_CHUNK, attend_full

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
