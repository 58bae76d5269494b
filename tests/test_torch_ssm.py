"""The recurrent mixers (`repro_torch.models.ssm`) against the JAX package's
`repro.models.ssm` on the CPU: Mamba, mLSTM and sLSTM full-sequence forwards
in both modes (log-depth "assoc" and the sequential "scan" oracle), the
chunk-divisor fallback at S = 150, and a decode sequence whose states are
compared leaf by leaf. fp32, `reduced()` widths, JAX's weights carried over
by `params_from_numpy`; tolerance 1e-4 as in test_torch_models."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import ssm

torch.set_num_threads(2)
TOL = 1e-4

# (init, forward, init_state, decode, config): each mixer with the arch that uses it
MIXERS = {
    "mamba": ("init_mamba", "mamba_forward", "mamba_init_state", "mamba_decode", "hymba-1.5b"),
    "mlstm": ("init_mlstm", "mlstm_forward", "mlstm_init_state", "mlstm_decode", "xlstm-125m"),
    "slstm": ("init_slstm", "slstm_forward", "slstm_init_state", "slstm_decode", "xlstm-125m"),
}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _mixer(name):
    init, *_, arch = MIXERS[name]
    cfg_j, cfg_t = jget_config(arch).reduced(), get_config(arch).reduced()
    pj = jax.tree.map(np.asarray, getattr(jssm, init)(jax.random.PRNGKey(1), cfg_j))
    return cfg_j, cfg_t, pj, params_from_numpy(pj)


def _x(B, S, d, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


@pytest.mark.parametrize("name", list(MIXERS))
@pytest.mark.parametrize("mode", ["assoc", "scan"])
@pytest.mark.parametrize("S", [96, 150])
def test_forward_matches_jax(name, mode, S):
    """The divisor fallback: S = 96 runs chunks of 48 for Mamba / mLSTM (ck
    64) and S = 150 chunks of 50; sLSTM (ck 256) runs one chunk of S."""
    cfg_j, cfg_t, pj, pt = _mixer(name)
    fwd = MIXERS[name][1]
    x = _x(2, S, cfg_t.d_model)
    yj = getattr(jssm, fwd)(pj, jnp.asarray(x), cfg_j, mode)
    yt = getattr(ssm, fwd)(pt, torch.from_numpy(x), cfg_t, mode)
    _close(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("name", list(MIXERS))
def test_assoc_matches_scan(name):
    _, cfg_t, _, pt = _mixer(name)
    fwd = getattr(ssm, MIXERS[name][1])
    x = torch.from_numpy(_x(2, 128, cfg_t.d_model, seed=5))
    _close(fwd(pt, x, cfg_t, "assoc").numpy(), fwd(pt, x, cfg_t, "scan").numpy())


@pytest.mark.parametrize("name", list(MIXERS))
def test_decode_states_match_jax(name):
    """Ten one-token steps from the initial state: outputs and every state
    leaf against JAX's, and the last output against the full forward's."""
    cfg_j, cfg_t, pj, pt = _mixer(name)
    _, fwd, init_state, dec, _ = MIXERS[name]
    B, S = 3, 10
    if name == "mamba":
        sj = getattr(jssm, init_state)(cfg_j, B, jnp.float32)
        st = getattr(ssm, init_state)(cfg_t, B, torch.float32, "cpu")
    else:
        sj = getattr(jssm, init_state)(cfg_j, B)
        st = getattr(ssm, init_state)(cfg_t, B, "cpu")
    assert sorted(st) == sorted(sj)
    x = _x(B, S, cfg_t.d_model, seed=7)
    for t in range(S):
        yj, sj = getattr(jssm, dec)(pj, jnp.asarray(x[:, t]), sj, cfg_j)
        yt, st = getattr(ssm, dec)(pt, torch.from_numpy(x[:, t]), st, cfg_t)
        _close(yt.numpy(), np.asarray(yj))
        for leaf in sj:
            assert st[leaf].dtype == getattr(torch, str(sj[leaf].dtype))
            _close(st[leaf].numpy(), np.asarray(sj[leaf]))
    full = getattr(ssm, fwd)(pt, torch.from_numpy(x), cfg_t, "assoc")
    _close(yt.numpy(), full[:, -1].numpy())


def test_scans_match_sequential_recurrences():
    """The Hillis–Steele combines against plain loops, chunk lengths that are
    and are not powers of two, and a -inf initial stabiliser."""
    rng = np.random.default_rng(2)
    for n in (1, 5, 64, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(2, n, 3)).astype(np.float32))
        h0 = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
        h, want = h0, []
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(ssm._linear_recurrence_chunk(a, b, h0).numpy(), torch.stack(want, 1).numpy())
        logf, logi = torch.log(a), b
        m, want = torch.full((2, 3), -math.inf), []
        for t in range(n):
            m = torch.maximum(logf[:, t] + m, logi[:, t])
            want.append(m)
        got = ssm._maxplus_chunk(logf, logi, torch.full((2, 3), -math.inf))
        _close(got.numpy(), torch.stack(want, 1).numpy())


def test_mamba_keeps_fp32_leaves_in_a_bf16_model():
    """A_log and D stay fp32 beside bf16 weights, as the reference draws
    them; the forward and a decode step run without a dtype clash."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), dtype="bfloat16")
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, "cpu")
    assert p["A_log"].dtype == p["D"].dtype == torch.float32
    assert p["in_proj"].dtype == torch.bfloat16
    x = torch.from_numpy(_x(2, 16, cfg.d_model)).bfloat16()
    assert ssm.mamba_forward(p, x, cfg).dtype == torch.bfloat16
    st = ssm.mamba_init_state(cfg, 2, torch.bfloat16, "cpu")
    y, st = ssm.mamba_decode(p, x[:, 0], st, cfg)
    assert y.dtype == st["conv"].dtype == torch.bfloat16 and st["h"].dtype == torch.float32
