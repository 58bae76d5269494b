"""Port `moe_layer` against `repro.models.moe.moe_layer` (fp32, CPU): router
and routing-override modes, einsum and gather dispatch, several token
blocks, and a capacity that overflows so that tokens drop — the same tokens
in both."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.attention import ShardingCtx
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)
TOL = 1e-4


def _cfgs(num_experts, top_k, capacity_factor, glu):
    out = []
    for get in (jget_config, get_config):
        base = get("switch-base-8").reduced()
        out.append(dataclasses.replace(
            base, d_model=32, glu=glu, act="gelu" if not glu else "silu",
            moe=dataclasses.replace(base.moe, num_experts=num_experts, top_k=top_k,
                                    d_expert=64, capacity_factor=capacity_factor),
        ))
    return out


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("B,S,E,k,cf,glu,override", [
    (2, 24, 4, 1, 1.25, False, False),
    (2, 24, 4, 2, 1.25, True, False),
    (2, 40, 4, 1, 0.25, False, False),    # capacity overflows: tokens drop
    (2, 40, 3, 2, 0.5, False, True),      # override with 3 slots, overflow
    (2, 2100, 4, 1, 0.25, False, True),   # T > 4096: two token blocks, overflow
])
def test_moe_layer_matches_jax(dispatch, B, S, E, k, cf, glu, override):
    cfg_j, cfg_t = _cfgs(E, k, cf, glu)
    pj = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), cfg_j))
    pt = params_from_numpy(pj)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg_t.d_model)).astype(np.float32)
    ro_j = ro_t = None
    if override:
        ids = rng.integers(0, E, (B, S, k)).astype(np.int32)
        w = rng.random((B, S, k)).astype(np.float32)
        ro_j, ro_t = (ids, w), (torch.from_numpy(ids), torch.from_numpy(w))
    yj, aux_j = jmoe.moe_layer(pj, x, cfg_j, ShardingCtx(), routing_override=ro_j,
                               dispatch=dispatch)
    yt, aux_t = tmoe.moe_layer(pt, torch.from_numpy(x), cfg_t, routing_override=ro_t,
                               dispatch=dispatch)
    yj = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), yj, atol=TOL, rtol=TOL)
    if cf < 1.0:
        dropped = np.all(yj == 0, axis=-1)
        assert dropped.any()
        np.testing.assert_array_equal(np.all(yt.numpy() == 0, axis=-1), dropped)
    if override:
        assert aux_t["router_logits"] is None and float(aux_t["aux_loss"]) == 0.0
    else:
        np.testing.assert_allclose(aux_t["router_logits"].numpy(),
                                   np.asarray(aux_j["router_logits"]), atol=TOL, rtol=TOL)
        for key in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-5)


def test_auto_dispatch_rule_matches_einsum_and_gather():
    cfg_j, cfg_t = _cfgs(4, 1, 1.25, False)
    pt = params_from_numpy(jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(2), cfg_j)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16, 32)).astype(np.float32))
    auto, _ = tmoe.moe_layer(pt, x, cfg_t)
    for d in ("einsum", "gather"):
        np.testing.assert_allclose(auto.numpy(), tmoe.moe_layer(pt, x, cfg_t, dispatch=d)[0].numpy(),
                                   atol=1e-5)
