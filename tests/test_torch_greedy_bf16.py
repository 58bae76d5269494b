"""C2 on the trained miniature: the committed sys_E8 model (4 layers,
d_model 128, trained) served in bf16 through `SiDADecodeEngine` with its
trained hash predictor live, no fixed routing table, on the port and on the
JAX package on the CPU: the greedy tokens identical, token for token, and
the loads of every step (all 8 experts resident, and 3 slots a layer where
the budget binds). Measured before this gate: identical on 16 lanes x 128
steps at both budgets, so the gate is identity."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as j_load_checkpoint
from repro.configs.base import get_config as jget_config
from repro.core import decode_engine as jd
from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.core import decode_engine as td
from test_torch_decode import CK, _e8_cfg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def e8_bf16_live():
    cfg_j = dataclasses.replace(_e8_cfg(jget_config), dtype="bfloat16")
    cfg_t = dataclasses.replace(_e8_cfg(get_config), dtype="bfloat16")
    pj, _ = j_load_checkpoint(os.path.join(CK, "model"),
                              like=j_init_params(jax.random.PRNGKey(0), cfg_j))
    hj, _ = j_load_checkpoint(
        os.path.join(CK, "hash"),
        like=j_init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j), 8, d_h=32))
    pj, hj = jax.tree.map(np.asarray, pj), jax.tree.map(np.asarray, hj)
    return cfg_j, cfg_t, pj, hj, params_from_numpy(pj), params_from_numpy(hj)


@pytest.mark.parametrize("slots", [8, 3])
def test_bf16_greedy_tokens_equal_jax_on_trained_e8(e8_bf16_live, slots):
    cfg_j, cfg_t, pj, hj, pt, ht = e8_bf16_live
    assert pt["embed"].dtype == torch.bfloat16
    start = np.random.default_rng(11).integers(0, cfg_t.vocab_size, (8,)).astype(np.int32)
    ej = jd.SiDADecodeEngine(cfg_j, pj, hj, slots_per_layer=slots)
    et = td.SiDADecodeEngine(cfg_t, pt, ht, slots_per_layer=slots, device="cpu")
    oj, mj = ej.generate(start, steps=64, cache_len=72)
    ot, mt = et.generate(start, steps=64, cache_len=72)
    et.close()
    ej.close()
    np.testing.assert_array_equal(np.asarray(ot), np.asarray(oj))
    assert mt.loads_per_step == mj.loads_per_step
