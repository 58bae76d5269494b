"""The port's int8 residency against the JAX package on the CPU:
`quantize_stack_int8` bit for bit at both granularities, `expert_format_bytes`,
the `expert_ffn_q` oracle (and the Pallas kernel in interpret mode), the
int8 branch of `apply_expert_stack_blocked`, and `ExpertStore` with int8 host
masters and with int8-resident slots on one table stream (the same slot
contents, translations, H2D and device bytes), then the batch engine and
its CLI on int8 slots."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_checkpoint as j_load_checkpoint
from repro.configs.base import get_config as jget_config
from repro.core import offload as jo
from repro.core.engine import SiDAEngine as JEngine
from repro.core.hash_fn import init_hash_fn as j_init_hash_fn
from repro.core.hash_table import HashTable as JHashTable
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import n_moe_layers as j_n_moe_layers
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core import offload as to
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_table import HashTable
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)
CK = os.path.join(os.path.dirname(__file__), "..", "experiments", "cache", "sys_E8")
# tests/test_quantized.py's kernel-vs-oracle tolerances
F32_TOL, BF16_TOL = 1e-4, 5e-2


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# host quantisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("granularity", ["channel", "tensor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_expert_is_bit_identical(granularity, dtype):
    w = (np.random.default_rng(0).standard_normal((2, 3, 64, 48)) * 0.05).astype(np.float32)
    w[0, 1, :, 5] = 0.0                                  # an all-zero channel (the 1e-8 floor)
    wj = w.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else w
    qj, sj = jo.quantize_expert(wj, granularity)
    # the store's torch quantisation of its master, a layer at a time
    qt, st = to.quantize_stack_int8(torch.from_numpy(w).to(getattr(torch, dtype)), "cpu",
                                    granularity)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.shape == (2, 3, 1, 48)
    np.testing.assert_array_equal(qt.numpy(), qj)
    np.testing.assert_array_equal(st.numpy(), sj)


def test_expert_format_bytes_match_jax():
    shapes = [(768, 3072), (768, 3072), (3072, 768)]
    for fmt, group in (("int8", 64), ("int4", 64), ("int4", 100)):
        assert to.expert_format_bytes(shapes, fmt, group) == jo.expert_format_bytes(shapes, fmt, group)


# ---------------------------------------------------------------------------
# expert_ffn_q oracle and the int8 expert stack
# ---------------------------------------------------------------------------


def _q_inputs(E, C, d, F, glu, seed=0):
    rng = np.random.default_rng(seed)
    xe = rng.standard_normal((E, C, d)).astype(np.float32)
    ws = []
    for shape in ((E, d, F), (E, d, F), (E, F, d)):
        q, s = jo.quantize_expert((rng.standard_normal(shape) * 0.05).astype(np.float32))
        ws += [q, s]
    if not glu:
        ws[2] = ws[3] = None
    return [xe] + ws


@pytest.mark.parametrize("E,C,d,F,glu,act,dtype", [
    (2, 128, 128, 128, True, "silu", "float32"),
    (3, 128, 128, 256, False, "gelu", "float32"),
    (2, 128, 128, 128, False, "gelu", "bfloat16"),
])
def test_expert_ffn_q_ref_matches_jax(E, C, d, F, glu, act, dtype):
    arrs = _q_inputs(E, C, d, F, glu)
    j = [None if a is None else jnp.asarray(a) for a in arrs]
    j[0] = j[0].astype(dtype)
    t = [None if a is None else torch.from_numpy(a) for a in arrs]
    t[0] = t[0].to(getattr(torch, dtype))
    got = ref.expert_ffn_q_ref(*t, act=act)
    assert got.dtype == t[0].dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(got.float(), jref.expert_ffn_q_ref(*j, act=act), tol)
    _close(got.float(), jops.expert_ffn_q(*j, act=act), tol)       # Pallas, interpret
    _close(ops.expert_ffn_q(*t, act=act).float(), got.float(), 0.0)  # CPU dispatch = plain
    # dequantize_ref is the reference's
    _close(ref.dequantize_ref(t[1], t[2]), jref.dequantize_ref(j[1], j[2]), 0.0)


def _small_cfgs(glu):
    out = []
    for get in (jget_config, get_config):
        base = get("switch-base-8").reduced()
        out.append(dataclasses.replace(base, glu=glu, act="silu" if glu else "gelu"))
    return out


@pytest.mark.parametrize("glu", [False, True])
def test_int8_expert_stack_matches_jax_jnp_path(glu):
    cfg_j, cfg_t = _small_cfgs(glu)
    n, E, C, d, F = 2, 3, 8, cfg_t.d_model, 64
    arrs = _q_inputs(E, C, d, F, glu=True, seed=1)
    xe = np.random.default_rng(2).standard_normal((n, E, C, d)).astype(np.float32)
    names = ["w_in", "w_in_scale", "w_gate", "w_gate_scale", "w_out", "w_out_scale"]
    p = dict(zip(names, arrs[1:]))
    yj = jmoe.apply_expert_stack_blocked({k: jnp.asarray(v) for k, v in p.items()},
                                         jnp.asarray(xe), cfg_j, use_pallas=False)
    yt = tmoe.apply_expert_stack_blocked({k: torch.from_numpy(v) for k, v in p.items()},
                                         torch.from_numpy(xe), cfg_t)
    assert tmoe.expert_params_quantized(p) and jmoe.expert_params_quantized(p)
    _close(yt, yj, F32_TOL)


# ---------------------------------------------------------------------------
# ExpertStore on int8 host masters and int8 slots
# ---------------------------------------------------------------------------


def _store_cfgs():
    out = []
    for get in (jget_config, get_config):
        base = get("switch-base-8").reduced()
        out.append(dataclasses.replace(
            base, n_layers=4, moe=dataclasses.replace(base.moe, num_experts=8, d_expert=32),
        ))
    return out


@pytest.fixture(scope="module")
def system():
    cfg_j, cfg_t = _store_cfgs()
    pj = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), cfg_j))
    return cfg_j, cfg_t, pj, params_from_numpy(pj)


def _tables(n, L, E, seed=0):
    rng = np.random.default_rng(seed)
    for j in range(n):
        hot = rng.choice(E, size=rng.integers(2, E + 1), replace=False)
        yield j, rng.choice(hot, size=(L, 2, 6, 1)).astype(np.int32), \
            rng.random((L, 2, 6, 1)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(quantized_slots=True), dict(quantized_slots=True, scale_granularity="tensor"),
    dict(host_quant="int8"),
])
def test_int8_store_matches_jax_on_table_stream(system, kw):
    cfg_j, cfg_t, pj, pt = system
    sj = jo.ExpertStore(cfg_j, pj, slots_per_layer=3, **kw)
    st = to.ExpertStore(cfg_t, pt, slots_per_layer=3, device="cpu", **kw)
    quantized = kw.get("quantized_slots", False)
    assert st.quant == sj.quant == "int8" and st.quantized_slots == sj.quantized_slots
    for j, ids, w in _tables(10, sj.L, sj.E):
        trans_j = sj.prepare(JHashTable(j, ids, w))
        trans_t = st.prepare(HashTable(j, ids, w))
        np.testing.assert_array_equal(trans_t, trans_j)
        slot_j, w_j = sj.translate(JHashTable(j, ids, w), trans_j)
        slot_t, w_t = st.translate_device(torch.from_numpy(ids), torch.from_numpy(w), trans_t)
        np.testing.assert_array_equal(slot_t.numpy(), slot_j)
        np.testing.assert_array_equal(w_t.numpy(), w_j)
    assert st.resident == sj.resident
    for f in ("bytes_h2d", "loads", "evictions", "hits", "dropped"):
        assert getattr(st.stats, f) == getattr(sj.stats, f), f
    assert st.device_bytes() == sj.device_bytes()
    assert st.expert_slot_bytes() == sj.expert_slot_bytes()
    assert st.full_expert_bytes() == sj.full_expert_bytes()    # int8 masters, no scales
    # slot contents: int8 rows + scale planes as they are, or dequantised fp rows
    for (g, s), res in st.resident.items():
        pool_t = st.serve_params["blocks"][f"sub{s}"]["moe"]
        pool_j = sj.serve_params["blocks"][f"sub{s}"]["moe"]
        assert ("w_in_scale" in pool_t) == quantized
        for e, slot in res.items():
            for t in ("w_in", "w_gate", "w_out"):
                assert pool_t[t].dtype == (torch.int8 if quantized else torch.float32)
                np.testing.assert_array_equal(pool_t[t][g, slot].numpy(),
                                              np.asarray(pool_j[t][g, slot]))
                q, sc = st.host[f"sub{s}"][t][g, e], st.host_scale[f"sub{s}"][t][g, e]
                if quantized:
                    np.testing.assert_array_equal(pool_t[t][g, slot].numpy(), q.numpy())
                    np.testing.assert_array_equal(pool_t[t + "_scale"][g, slot].numpy(), sc.numpy())
                else:
                    np.testing.assert_array_equal(pool_t[t][g, slot].numpy(), (q.float() * sc).numpy())


def test_quantized_capacity_at_equal_bytes(system):
    _, cfg_t, _, pt = system
    fp = to.ExpertStore(cfg_t, pt, slots_per_layer=2, device="cpu")
    q = to.ExpertStore(cfg_t, pt, slots_per_layer=2, device="cpu", quantized_slots=True)
    assert fp.expert_slot_bytes() >= 2 * q.expert_slot_bytes()    # fp32 slots here: ~3.8x
    assert q.device_bytes() < fp.device_bytes()
    # the int4 warm tier: the same int8 budget buys more resident experts
    q4 = to.ExpertStore(cfg_t, pt, slots_per_layer=4, device="cpu", quantized_slots=True)
    tiered = to.ExpertStore(cfg_t, pt, slots_per_layer=4, device="cpu", quantized_slots=True,
                            tier=TierConfig(int4_slots=True))
    assert tiered.S8 + tiered.S4 > q4.S and tiered.device_bytes() <= q4.device_bytes()


# ---------------------------------------------------------------------------
# the batch engine and its CLI on int8 slots
# ---------------------------------------------------------------------------


def _e8_cfg(get):
    cfg = get("switch-base-8").reduced()
    return dataclasses.replace(
        cfg, n_layers=4, d_ff=128,
        moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=1, capacity_factor=4.0,
                                d_expert=512),
    )


@pytest.mark.parametrize("kw", [dict(quantized_slots=True), dict(host_quant="int8")])
def test_batch_engine_on_int8_matches_jax_on_e8(kw):
    cfg_j, cfg_t = _e8_cfg(jget_config), _e8_cfg(get_config)
    pj, _ = j_load_checkpoint(os.path.join(CK, "model"),
                              like=j_init_params(jax.random.PRNGKey(0), cfg_j))
    hj, _ = j_load_checkpoint(
        os.path.join(CK, "hash"),
        like=j_init_hash_fn(jax.random.PRNGKey(1), cfg_j.d_model, j_n_moe_layers(cfg_j), 8, d_h=32),
    )
    pj, hj = jax.tree.map(np.asarray, pj), jax.tree.map(np.asarray, hj)
    batches = [np.random.default_rng(i).integers(0, cfg_t.vocab_size, (2, 16)).astype(np.int32)
               for i in range(3)]
    ej = JEngine(cfg_j, pj, hj, slots_per_layer=4, **kw)
    et = SiDAEngine(cfg_t, params_from_numpy(pj), params_from_numpy(hj), slots_per_layer=4,
                    device="cpu", **kw)
    ej.serve(batches, threaded=False)
    et.serve(batches, threaded=False)
    for a, b in zip(et.results, ej.results):
        _close(a.numpy(), b, 1e-4)
    for f in ("bytes_h2d", "loads", "evictions", "hits"):
        assert getattr(et.store.stats, f) == getattr(ej.store.stats, f), f
    assert et.memory_saving() == ej.memory_saving()
    assert et.device_memory_bytes() == ej.device_memory_bytes()


def test_serve_cli_takes_the_int8_flags(capsys):
    args = serve.build_parser().parse_args([])
    assert (args.host_quant, args.quantized_slots, args.scale_granularity) == ("none", False, "channel")
    serve.main(["--device", "cpu", "--slots", "2", "--batches", "1", "--batch", "1", "--seq", "8",
                "--quantized-slots", "--scale-granularity", "tensor"])
    out = capsys.readouterr().out
    assert "loads=" in out and "engine=sida" in out
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(["--host-quant", "int4"])
