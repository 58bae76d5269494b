"""The decode loop's kept ring cache and its step replayed as a CUDA graph
(`core/decode_engine.py::RingStep`).

On the CPU: which calls may replay (`graph_engages`), the ring's in-place
reset (`transformer.reset_cache`) against a fresh `init_cache` in every
block kind, back-to-back calls on one engine against fresh engines token
for token, the launch bookkeeping of a capture and its replays, and the
graph counters of eager runs. On the card
(`python -m pytest --noconftest -m gpu tests/test_torch_decode_graph.py`):
the replayed step against the eager one at switch-base-8's widths, 64
lanes over a 512-slot ring, tokens and kernel launches alike, with slot
uploads between replays, and a second geometry that captures anew and
frees the first's buffers."""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.jamba2_mini import CONFIG as JAMBA
from repro_torch.configs.nemotron3_nano import CONFIG as NEMOTRON
from repro_torch.core import decode_engine
from repro_torch.core.decode_engine import GRAPH_WARM_STEPS, RingStep, SiDADecodeEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.core.residency import PagedKVConfig
from repro_torch.kernels import ops
from repro_torch.models.transformer import init_cache, init_params, n_moe_layers, reset_cache
from repro_torch.serving.telemetry import Telemetry
from repro_torch.tree import tree_leaves

COUNTERS = ("decode_graph_captures", "decode_graph_replays", "decode_graph_eager_steps")


def _jamba_tiny():
    return dataclasses.replace(
        JAMBA, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=300, moe=dataclasses.replace(JAMBA.moe, num_experts=4, d_expert=128),
        dtype="float32")


def _nemotron_tiny():
    """nemotron_h's first 13 blocks (Mamba-2, MoE and attention, one mixer
    a block) at tiny widths."""
    return dataclasses.replace(
        NEMOTRON, n_layers=13, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32, vocab_size=300,
        moe=dataclasses.replace(NEMOTRON.moe, num_experts=4, top_k=2, d_expert=64, d_shared=64),
        attn=dataclasses.replace(NEMOTRON.attn, layer_pattern=NEMOTRON.attn.layer_pattern[:13]),
        ssm=dataclasses.replace(NEMOTRON.ssm, state_dim=16, mamba2_heads=4, mamba2_head_dim=16,
                                n_groups=2, chunk_size=16),
        dtype="float32")


TINY = {"jamba": _jamba_tiny, "nemotron": _nemotron_tiny}


def _model(cfg, device="cpu", d_h=16, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, cfg, device=device)
    hp = init_hash_fn(gen, cfg.d_model, n_moe_layers(cfg), cfg.moe.num_experts, d_h=d_h,
                      device=device)
    return params, hp


@pytest.mark.parametrize("device,paged,spec,want", [
    ("cuda", None, False, True),
    ("cuda:0", None, False, True),
    ("cpu", None, False, False),
    ("cuda", PagedKVConfig(page_size=4, kv_pages=6, max_seq=16), False, False),
    ("cuda", None, True, False),
    ("cpu", PagedKVConfig(page_size=4, kv_pages=6, max_seq=16), True, False),
], ids=["cuda-ring", "cuda0-ring", "cpu-ring", "cuda-paged", "cuda-spec", "cpu-paged-spec"])
def test_graph_engages_only_on_cuda_rings_without_speculation(device, paged, spec, want):
    assert decode_engine.graph_engages(torch.device(device), paged, spec) is want


@pytest.mark.parametrize("name", ["switch-base-8", "hymba-1.5b", "xlstm-125m",
                                  "seamless-m4t-medium", "jamba", "nemotron"])
def test_reset_cache_gives_init_cache_back_in_place(name):
    cfg = TINY[name]() if name in TINY else get_config(name).reduced()
    kw = {"enc_len": 5} if cfg.enc_dec else {}
    cache = init_cache(cfg, 3, 8, device="cpu", **kw)
    want = init_cache(cfg, 3, 8, device="cpu", **kw)
    leaves = tree_leaves(cache)
    ptrs = [t.data_ptr() for t in leaves]
    gen = torch.Generator().manual_seed(0)
    for t in leaves:                       # every value off its initial one
        t.copy_(torch.randint(1, 9, t.shape, generator=gen).to(t.dtype))
    assert reset_cache(cfg, cache) is cache
    assert [t.data_ptr() for t in tree_leaves(cache)] == ptrs
    for got, ref in zip(leaves, tree_leaves(want)):
        assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("arch", ["switch", "jamba", "nemotron"])
def test_back_to_back_calls_equal_fresh_engines(arch):
    """One engine's second call starts from its kept ring, reset in place:
    its tokens are a fresh engine's. Every expert is resident, so the slot
    placement the first call leaves cannot move a token."""
    cfg = TINY[arch]() if arch in TINY else get_config("switch-base-8").reduced()
    params, hp = _model(cfg)
    E = cfg.moe.num_experts
    starts = [np.array([3, 1, 4], np.int32), np.array([2, 7, 1], np.int32)]

    def engine():
        return SiDADecodeEngine(cfg, params, hp, slots_per_layer=E, device="cpu")

    one = engine()
    got = [one.generate(s, steps=10, cache_len=8)[0] for s in starts]   # the ring wraps
    ring = one.ring
    got.append(one.generate(starts[0], steps=10, cache_len=8)[0])
    assert one.ring is ring                 # the same geometry keeps its ring
    one.close()
    for s, g in zip(starts + starts[:1], got):
        fresh = engine()
        np.testing.assert_array_equal(g, fresh.generate(s, steps=10, cache_len=8)[0])
        fresh.close()


def test_a_new_geometry_replaces_the_kept_ring():
    cfg = get_config("switch-base-8").reduced()
    params, hp = _model(cfg)
    eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=cfg.moe.num_experts, device="cpu")
    eng.generate(np.array([3, 1], np.int32), steps=4, cache_len=8)
    first = weakref.ref(eng.ring.cache["sub0"]["k"])
    eng.generate(np.array([3, 1, 4], np.int32), steps=4, cache_len=16)
    gc.collect()
    assert first() is None
    assert eng.ring.geometry == (3, 16)
    assert eng.ring.cache["sub0"]["k"].shape[1:3] == (3, 16)
    eng.generate(np.array([3, 1], np.int32), steps=4, cache_len=8,
                 paged=PagedKVConfig(page_size=4, kv_pages=6, max_seq=16))
    assert eng.ring.geometry == (3, 16)     # paged calls leave the ring alone
    eng.close()


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_each_replay_adds_the_captures_launches_once():
    ring = RingStep({}, (2, 4))
    ring.graph = _StubGraph()
    ring.inputs = (torch.zeros(2, dtype=torch.int32), torch.zeros(3, 2, 1))
    ring.out = torch.full((2,), 7, dtype=torch.int32)
    shape = ("flash_decode", 12, 12, 64, 0, 0.0)
    ring.launches = ({"flash_decode": 12, "expert_ffn": 6}, {shape: 12})
    ops.reset_launches()
    tokens, slots = torch.tensor([5, 6], dtype=torch.int32), torch.ones(3, 2, 1)
    for n in range(1, 4):
        assert ring.replay(tokens, slots) is ring.out
        counts = ops.launches()
        assert counts["flash_decode"] == 12 * n and counts["expert_ffn"] == 6 * n
        assert sum(counts.values()) == 18 * n
        assert ops.launches_by_shape() == {shape: 12 * n}
    assert ring.graph.replays == ring.replays == 3
    assert torch.equal(ring.inputs[0], tokens) and torch.equal(ring.inputs[1], slots)
    ops.reset_launches()


def test_held_launches_keep_a_capture_out_of_the_totals():
    ops.reset_launches()
    q = torch.zeros(1, 4, 8)
    ops._count("sparsemax")
    with ops.held_launches() as (counts, by_shape):
        ops._count("flash_decode", q, q, 0, 0.0)
        ops._count("flash_decode", q, q, 0, 0.0)
        ops._count("expert_ffn")
    assert counts == {"flash_decode": 2, "expert_ffn": 1}
    assert by_shape == {("flash_decode", 4, 4, 8, 0, 0.0): 2}
    assert ops.launches() == {**{k: 0 for k in ops.KERNELS}, "sparsemax": 1}
    assert ops.launches_by_shape() == {}
    ops.add_launches(counts, by_shape)
    assert ops.launches()["flash_decode"] == 2 and ops.launches()["expert_ffn"] == 1
    ops.reset_launches()


@pytest.mark.parametrize("mode", ["ring", "paged", "spec"])
def test_graph_counters_read_every_cpu_step_eager(mode):
    cfg = get_config("switch-base-8").reduced()
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg, device="cpu")
    hp = init_hash_fn(gen, cfg.d_model, n_moe_layers(cfg), cfg.moe.num_experts, d_h=16,
                      device="cpu", draft=True)
    kw = {"spec_mode": "draft", "spec_k": 3} if mode == "spec" else {}
    gen_kw = {"paged": PagedKVConfig(page_size=4, kv_pages=6, max_seq=16)} if mode == "paged" \
        else {}
    tel = Telemetry()
    eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=2, device="cpu", telemetry=tel, **kw)
    steps = 0
    for _ in range(2):
        _, m = eng.generate(np.array([3, 1, 4], np.int32), steps=6, cache_len=16, **gen_kw)
        assert m.graph_steps == 0
        steps += m.steps
    eng.close()
    assert [tel.counter(c).value for c in COUNTERS] == [0, 0, steps]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def switch8():
    """switch-base-8 at its published widths in bf16, weights drawn on the
    card from a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_config("switch-base-8"), dtype="bfloat16")
    params, hp = _model(cfg, device="cuda", d_h=64)
    return cfg, params, hp


def _calls(cfg, params, hp, slots, starts, steps, eager, monkeypatch, cache_len=512):
    """Tokens and launches of `generate` calls on one engine, the step
    replayed or (`eager`) never captured; the engine's DecodeMetrics."""
    if eager:
        monkeypatch.setattr(decode_engine, "graph_engages", lambda *a: False)
    eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=slots, device="cuda")
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        runs = [eng.generate(s, steps=steps, cache_len=cache_len) for s in starts]
        return [r[0] for r in runs], ops.launches(), [r[1] for r in runs]
    finally:
        eng.close()
        monkeypatch.undo()


def _starts(cfg, lanes, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (lanes,)).astype(np.int32) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [8, 4], ids=["resident", "uploads"])
def test_replayed_step_equals_the_eager_step_on_the_card(switch8, slots, monkeypatch):
    cfg, params, hp = switch8
    starts = _starts(cfg, 64, 2)
    graph_toks, graph_launches, metrics = _calls(cfg, params, hp, slots, starts, 32, False,
                                                 monkeypatch)
    eager_toks, eager_launches, eager_metrics = _calls(cfg, params, hp, slots, starts, 32, True,
                                                       monkeypatch)
    for g, e in zip(graph_toks, eager_toks):
        np.testing.assert_array_equal(g, e)
    assert graph_launches == eager_launches
    assert graph_launches["flash_decode"] == 2 * 32 * cfg.n_layers
    assert [m.graph_steps for m in metrics] == [32 - GRAPH_WARM_STEPS, 32]
    assert [m.graph_steps for m in eager_metrics] == [0, 0]
    if slots < cfg.moe.num_experts:         # uploads landed between replays
        assert sum(sum(m.loads_per_step[GRAPH_WARM_STEPS + 1:]) for m in metrics) > 0


@pytest.mark.gpu
def test_a_second_geometry_captures_anew_and_frees_the_first(switch8):
    cfg, params, hp = switch8
    tel = Telemetry()
    eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=8, device="cuda", telemetry=tel)
    try:
        eng.generate(_starts(cfg, 64, 1)[0], steps=8, cache_len=512)
        eng.generate(_starts(cfg, 64, 1, seed=4)[0], steps=8, cache_len=512)
        assert tel.counter("decode_graph_captures").value == 1
        ring = eng.ring
        refs = [weakref.ref(t) for t in (ring.cache["sub0"]["k"], ring.out, *ring.inputs)]
        del ring
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        _, m = eng.generate(_starts(cfg, 32, 1)[0], steps=8, cache_len=256)
        gc.collect()
        torch.cuda.synchronize()
        assert all(r() is None for r in refs)
        assert tel.counter("decode_graph_captures").value == 2
        assert m.graph_steps == 8 - GRAPH_WARM_STEPS
        assert eng.ring.geometry == (32, 256)
        # the 64-lane ring (1.2 GB) gone, the 32-lane one (0.3 GB) in its place
        ring_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(eng.ring.cache))
        assert torch.cuda.memory_allocated() < before - 2 * ring_bytes
        assert [tel.counter(c).value for c in COUNTERS] == [
            2, 24 - 2 * GRAPH_WARM_STEPS, 2 * GRAPH_WARM_STEPS]
    finally:
        eng.close()
