"""`models/moe.py::apply_expert_stack`, the unblocked expert FFN over
xe [E, C, d] (the reference's three einsums, `src/repro/models/moe.py:95-103`),
against the JAX function on the same seeded numpy inputs: GLU (SiLU) and
non-GLU (the reference's tanh GELU), fp32 within 1e-5, bf16 within
5e-2 * max(1, max|y|); and against the blocked path's plain expert FFN."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.moe import apply_expert_stack as j_apply_expert_stack
from repro_torch.configs.base import get_config
from repro_torch.models.moe import apply_expert_stack, apply_expert_stack_blocked

torch.set_num_threads(2)

CASES = ["switch-base-8", "deepseek-moe-16b"]       # tanh GELU, no gate; SiLU, gated


def _inputs(E, C, d, F, seed):
    rng = np.random.default_rng(seed)
    return {"xe": rng.standard_normal((E, C, d)).astype(np.float32),
            "w_in": (rng.standard_normal((E, d, F)) / np.sqrt(d)).astype(np.float32),
            "w_gate": (rng.standard_normal((E, d, F)) / np.sqrt(d)).astype(np.float32),
            "w_out": (rng.standard_normal((E, F, d)) / np.sqrt(F)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_apply_expert_stack_matches_jax(name, dtype):
    cfg_t = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    cfg_j = dataclasses.replace(jget_config(name).reduced(), dtype=dtype)
    assert cfg_t.glu == (name != "switch-base-8") and cfg_t.act == cfg_j.act
    a = _inputs(4, 24, cfg_t.d_model, cfg_t.moe.d_expert, seed=3)
    p_t = {k: torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in a.items()}
    p_j = {k: jnp.asarray(v).astype(dtype) for k, v in a.items()}
    got = apply_expert_stack(p_t, p_t["xe"], cfg_t)
    want = np.asarray(j_apply_expert_stack(p_j, p_j["xe"], cfg_j), np.float32)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    tol = 1e-5 if dtype == "float32" else 5e-2 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0 if dtype != "float32" else tol)


@pytest.mark.parametrize("name", CASES)
def test_apply_expert_stack_equals_the_blocked_path(name):
    """The unblocked FFN against `apply_expert_stack_blocked` (one block) on
    the CPU, whose plain expert FFN computes the same three products."""
    cfg = get_config(name).reduced()
    a = _inputs(4, 16, cfg.d_model, cfg.moe.d_expert, seed=4)
    p = {k: torch.from_numpy(v) for k, v in a.items()}
    got = apply_expert_stack(p, p["xe"], cfg)
    want = apply_expert_stack_blocked(p, p["xe"][None], cfg)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
