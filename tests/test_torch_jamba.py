"""The jamba block kind (AI21-Jamba2-Mini: attention at sublayer 4 of 8,
Mamba with Δ / B / C norms elsewhere, MoE on the odd sublayers) against the
benchmark's plain reference, `perfbench/reference/jamba.py` (float32, its
Mamba a sequential scan, its attention without positional encoding), at
one period of 8 layers cut to d 64, 4 experts of 128, heads of 32 (widths
the card's kernels take), fp32, on seeded random weights: the full
forward, `SiDAEngine.serve` with the experts on the host, and decoding
token by token (`decode_step`, `SiDADecodeEngine.generate`) against the
reference's full forward at every position. hymba's Mamba is held to its
outputs from before the jamba norms existed.

Tolerances: the port's Mamba scans a chunk by Hillis–Steele doubling and
its MoE combines in another order than the reference, so the two round
differently in float32's last bits. Through 8 layers the logits' widest
relative error (`compare.logit_error`, ||got - ref|| / ||ref|| a
position) reads at most 5e-6 over these tests, so the limit is 5e-5: the
logits rounded to bf16 alone read 2e-3, the reference with its products in
TF32 1e-2, and the Mamba without its Δ / B / C norms 1.6."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import compare
from perfbench.reference import jamba as ref
from perfbench.reference import routing
from repro_torch.configs.base import get_config
from repro_torch.configs.jamba2_mini import CONFIG
from repro_torch.core import decode_engine
from repro_torch.core.decode_engine import SiDADecodeEngine
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.models import ssm
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    n_moe_layers,
    sub_kind,
)
from repro_torch.serving.telemetry import Telemetry
from repro_torch.tree import tree_map

torch.set_num_threads(2)
TOL = 5e-5


def tiny(capacity_factor: float = 1.25):
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=300,
        moe=dataclasses.replace(CONFIG.moe, num_experts=4, d_expert=128,
                                capacity_factor=capacity_factor),
        dtype="float32")


def _perturb(tree, gen):
    """Every norm gain, conv bias, dt bias and D off its initial value, so
    each one reaches the logits."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, gen)
        elif k in ("scale", "conv_b", "dt_bias", "D"):
            v.add_(0.1 * torch.randn(v.shape, generator=gen))


def model(cfg, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    params = init_params(gen, cfg, device="cpu")
    _perturb(params, gen)
    hp = init_hash_fn(gen, cfg.d_model, n_moe_layers(cfg), cfg.moe.num_experts, d_h=16,
                      device="cpu")
    return params, hp


def _m(cfg):
    return dataclasses.asdict(cfg)


def _routing(cfg, shape, seed):
    """Distinct top-k expert ids and a softmax over them, [L_moe, *shape, k]."""
    g = torch.Generator().manual_seed(seed)
    L, E, k = n_moe_layers(cfg), cfg.moe.num_experts, cfg.moe.top_k
    ids = torch.rand((L, *shape, E), generator=g).argsort(-1)[..., :k]
    w = torch.softmax(torch.randn((L, *shape, k), generator=g), -1)
    return ids, w


def test_the_period_holds_each_kind_of_sublayer():
    cfg = tiny()
    kinds = [sub_kind(cfg, s) for s in range(8)]
    assert [k["mixer"] for k in kinds] == ["mamba"] * 4 + ["global"] + ["mamba"] * 3
    assert [k["moe"] for k in kinds] == [False, True] * 4
    params, _ = model(cfg)
    for s in range(8):
        sub = params["blocks"][f"sub{s}"]
        assert ("attn" in sub) == (s == 4) and ("mamba" in sub) == (s != 4)
        assert ("moe" in sub) == (s % 2 == 1) and ("mlp" in sub) == (s % 2 == 0)
    mamba = params["blocks"]["sub0"]["mamba"]
    assert [tuple(mamba[n]["scale"].shape) for n in ("dt_norm", "b_norm", "c_norm")] == \
        [(1, 4), (1, 16), (1, 16)]
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert set(cache["sub4"]) == {"k", "v"}
    assert all(set(cache[f"sub{s}"]) == {"state"} for s in range(8) if s != 4)


def test_the_published_configuration_counts_52b_parameters_12b_active():
    counts = CONFIG.param_counts()
    assert 51e9 < counts["total"] < 53e9 and 11.5e9 < counts["active"] < 12.5e9
    assert counts["moe"] == 16 * 16 * 3 * 4096 * 14336


@pytest.mark.parametrize("mode", ["assoc", "scan"])
def test_forward_matches_the_reference(mode):
    cfg = tiny(capacity_factor=100.0)      # no capacity drops: every pair computed
    params, _ = model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(1))
    ids, w = _routing(cfg, (2, 96), 2)
    got = forward(params, cfg, tokens, routing_override=(ids, w), scan_mode=mode)["logits"]
    want = ref.forward(params, _m(cfg), tokens, ids, w)
    assert compare.logit_error(got[..., : cfg.vocab_size], want) < TOL


def _serve(cfg, params, hp, threaded: bool, **kw):
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=3, device="cpu", **kw)
    routes = {}

    def on_translate(out, table, trans):
        routes[table.batch_index] = (table.expert_ids, table.weights, np.array(trans))

    inner = eng.store.translate

    def translate(table, trans):
        out = inner(table, trans)
        on_translate(out, table, trans)
        return out

    eng.store.translate = translate
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32) for _ in range(3)]
    eng.serve(batches, threaded=threaded)
    eng.close()
    return batches, eng.results, routes, eng


@pytest.mark.parametrize("threaded", [True, False], ids=["threaded_async", "sync"])
def test_serve_matches_the_reference_routed_by_its_table(threaded):
    """3 of 4 slots a MoE layer, the experts on the host; the reference is
    routed by each batch's table through the store's own translation and
    capacity (`routing.effective_routing`)."""
    cfg = tiny()
    params, hp = model(cfg)
    batches, results, routes, eng = _serve(cfg, params, hp, threaded,
                                           prefetch_depth=2 if threaded else 0)
    assert eng.store.stats.loads > 0
    for i, toks in enumerate(batches):
        ids, alpha, trans = routes[i]
        eff = routing.effective_routing(ids, alpha, trans, 3, cfg.moe.top_k,
                                        cfg.moe.capacity_factor)
        want = ref.forward(params, _m(cfg), torch.as_tensor(toks),
                           torch.as_tensor(ids[..., : eff.shape[-1]]), torch.as_tensor(eff))
        assert compare.logit_error(results[i][..., : cfg.vocab_size], want) < TOL


def test_decode_step_matches_the_full_forward_at_every_position():
    cfg = tiny(capacity_factor=100.0)
    params, _ = model(cfg)
    B, T = 2, 20
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(4))
    ids, w = _routing(cfg, (B, T), 5)
    want = ref.forward(params, _m(cfg), tokens, ids, w)
    cache = init_cache(cfg, B, 32, device="cpu")
    for t in range(T):
        logits, cache = decode_step(params, cache, tokens[:, t], cfg,
                                    routing_override=(ids[:, :, t], w[:, :, t]))
        assert compare.logit_error(logits[:, : cfg.vocab_size], want[:, t]) < TOL, t


def test_decode_engine_matches_the_full_forward_at_every_position(monkeypatch):
    """`SiDADecodeEngine.generate` greedy over 3 lanes, 3 of 4 slots: each
    step's logits against the reference's full forward over the lane's
    inputs, routed by each step's prediction through the store's
    translation."""
    cfg = tiny()
    params, hp = model(cfg)
    eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=3, device="cpu")
    steps, logits = [], []
    route = eng._route_table

    def route_table(table, m):
        trans, ticket = route(table, m)
        steps.append((table.expert_ids[:, :, 0].copy(), table.weights[:, :, 0].copy(),
                      np.array(trans)))
        return trans, ticket

    def step(*a, **kw):
        out = decode_step(*a, **kw)
        logits.append(out[0].clone())
        return out

    monkeypatch.setattr(eng, "_route_table", route_table)
    monkeypatch.setattr(decode_engine, "decode_step", step)
    start = np.array([5, 17, 250], np.int32)
    out, _ = eng.generate(start, steps=12, cache_len=16)
    eng.close()
    eff = np.stack([routing.effective_routing(i, a, t, 3, cfg.moe.top_k, cfg.moe.capacity_factor)
                    for i, a, t in steps])                       # [steps, L, B, k]
    ids = np.stack([s[0] for s in steps])
    inputs = torch.cat([torch.as_tensor(start)[:, None], torch.as_tensor(out[:, :-1])], dim=1)
    want = ref.forward(params, _m(cfg), inputs,
                       torch.as_tensor(ids.transpose(1, 2, 0, 3)[..., : eff.shape[-1]]),
                       torch.as_tensor(eff.transpose(1, 2, 0, 3)))
    for t, lg in enumerate(logits):
        assert compare.logit_error(lg[:, : cfg.vocab_size], want[:, t]) < TOL, t


def test_spans_and_device_counters_only_when_recording():
    """With spans on, each Mamba mixer call is a `model.mamba` span holding
    a `model.mamba_scan`, counts in `mamba_calls` and adds its seconds (on
    the CPU, the host clock's) to `mamba_device_s` and the scan's to
    `mamba_scan_device_s`; with them off, or without a telemetry, nothing
    is recorded and the logits are the same."""
    cfg = tiny()
    params, _ = model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(6))
    ids, w = _routing(cfg, (2, 16), 7)
    plain = forward(params, cfg, tokens, routing_override=(ids, w))["logits"]
    off = Telemetry()
    assert torch.equal(forward(params, cfg, tokens, routing_override=(ids, w),
                               telemetry=off)["logits"], plain)
    assert not off.spans and off.snapshot()["counters"] == {} and not off._deferred
    on = Telemetry(record_spans=True)
    assert torch.equal(forward(params, cfg, tokens, routing_override=(ids, w),
                               telemetry=on)["logits"], plain)
    names = [(s.name, s.parent) for s in on.spans]
    assert names.count(("model.mamba", None)) == 7
    assert names.count(("model.mamba_scan", "model.mamba")) == 7
    assert on.counter("mamba_calls").value == 7
    mixer, scan = on.counter("mamba_device_s").value, on.counter("mamba_scan_device_s").value
    assert 0 < scan < mixer
    assert not on._deferred           # CUDA events only on a CUDA device


# hymba's Mamba, reduced(), weights from init_mamba on Generator(7), x from the
# same generator: its outputs before the jamba norms existed
HYMBA_NORM = 8.6215309
HYMBA_Y0 = [0.0857609212398529, -0.031549811363220215, -0.008709648624062538,
            -0.03876886144280434]
HYMBA_DECODE = (0.5000578621611982, 0.022351150373900876)


@pytest.mark.parametrize("mode", ["assoc", "scan"])
def test_hymba_mamba_is_unchanged(mode):
    cfg = get_config("hymba-1.5b").reduced()
    g = torch.Generator().manual_seed(7)
    p = ssm.init_mamba(g, cfg, "cpu")
    assert sorted(p) == ["A_log", "D", "conv_b", "conv_w", "dt_bias", "dt_proj", "in_proj",
                         "out_proj", "x_db"]
    x = torch.randn((2, 80, cfg.d_model), generator=g)
    y = ssm.mamba_forward(p, x, cfg, mode)
    assert float(y.double().norm()) == pytest.approx(HYMBA_NORM, rel=1e-6)
    np.testing.assert_allclose(y[0, 5, :4].numpy(), HYMBA_Y0, rtol=1e-5, atol=1e-7)
    st = ssm.mamba_init_state(cfg, 2, torch.float32, "cpu")
    yd, st = ssm.mamba_decode(p, x[:, 0], st, cfg)
    assert (float(yd.double().norm()), float(st["h"].double().norm())) == \
        pytest.approx(HYMBA_DECODE, rel=1e-6)


@pytest.mark.gpu
def test_tiny_model_on_the_card_matches_the_cpu():
    """The same weights and routing on the card and on the CPU: the card's
    fp32 (flash_prefill for the attention, its own matmuls) within 1e-3 of
    the CPU's, TF32 being off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tiny(capacity_factor=100.0)
    params, _ = model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(8))
    ids, w = _routing(cfg, (2, 64), 9)
    want = forward(params, cfg, tokens, routing_override=(ids, w))["logits"]
    dev = tree_map(lambda t: t.cuda(), params)
    with ref.exact_fp32():
        got = forward(dev, cfg, tokens.cuda(), routing_override=(ids.cuda(), w.cuda()))["logits"]
    assert compare.logit_error(got.cpu()[..., : cfg.vocab_size], want[..., : cfg.vocab_size]) < 1e-3
