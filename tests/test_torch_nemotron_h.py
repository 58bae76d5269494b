"""The nemotron_h block kind (NVIDIA-Nemotron-3-Nano-30B-A3B: blocks of one
mixer each, Mamba-2, MoE or attention by the pattern) against the
benchmark's plain reference, `perfbench/reference/nemotron_h.py` (float32,
its Mamba-2 a recurrence one position at a time, its attention without
positional encoding), at the pattern's first 13 blocks `MEMEM*EMEMEM*` cut
to d 128, 4 Mamba-2 heads of 32 in 2 groups of state 16 at chunk 16, 8
relu² experts of 64 top-2 beside a shared expert of 128, heads of 32, fp32,
on seeded random weights: the full forward routed by a table and by the
model's own sigmoid router, `SiDAEngine.serve` with the experts on the host,
`decode_step` token by token against the reference's full forward,
on the card `SiDADecodeEngine`'s captured decode graph against the eager
step, the chunked SSD against the sequential
recurrence, and the relu² expert FFN.

Tolerances: the port's SSD sums a chunk's terms as batched matrix products
and passes state between chunks in closed form, and its MoE combines in
another order than the reference, so the two round differently in
float32's last bits. The logits' widest relative error
(`compare.logit_error`, ||got - ref|| / ||ref|| a position) reads at most
1.2e-6 over these tests, so TOL is 3e-5: the reference with its products
in TF32 reads 2.3e-3 and the SSD without the passing of state between its
chunks 0.12 (both asserted below). The SSD alone is held to 1e-5 of the
sequential recurrence's largest output (it reads at most 1.1e-6); without
the passing of state it reads 0.19 or more."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import compare
from perfbench.reference import nemotron_h as ref
from perfbench.reference import routing
from repro_torch.configs.nemotron3_nano import CONFIG
from repro_torch.core import decode_engine
from repro_torch.core.decode_engine import GRAPH_WARM_STEPS, SiDADecodeEngine
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.kernels import ops
from repro_torch.kernels.autograd import expert_ffn_backward
from repro_torch.kernels.ref import expert_ffn_ref
from repro_torch.models import moe, ssm
from repro_torch.models.layers import act_fn
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
TOL, SSD_TOL = 3e-5, 1e-5
KINDS = ["mamba2", "moe", "mamba2", "moe", "mamba2", "global", "moe", "mamba2", "moe", "mamba2",
         "moe", "mamba2", "global"]


def tiny(capacity_factor: float = 1.25):
    return dataclasses.replace(
        CONFIG, n_layers=13, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, vocab_size=300,
        moe=dataclasses.replace(CONFIG.moe, num_experts=8, top_k=2, d_expert=64, d_shared=128,
                                capacity_factor=capacity_factor),
        attn=dataclasses.replace(CONFIG.attn, layer_pattern=CONFIG.attn.layer_pattern[:13]),
        ssm=dataclasses.replace(CONFIG.ssm, state_dim=16, mamba2_heads=4, mamba2_head_dim=32,
                                n_groups=2, chunk_size=16),
        dtype="float32")


def _perturb(tree, gen):
    """Every norm gain, conv bias, dt bias, D and router bias off its
    initial value, so each one reaches the logits."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, gen)
        elif k in ("scale", "conv_b", "dt_bias", "D", "router_bias"):
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


def _tokens(shape, seed):
    return torch.randint(0, 300, shape, generator=torch.Generator().manual_seed(seed))


def _routing(cfg, shape, seed):
    """Distinct top-k expert ids and a softmax over them, [L_moe, *shape, k]."""
    g = torch.Generator().manual_seed(seed)
    L, E, k = n_moe_layers(cfg), cfg.moe.num_experts, cfg.moe.top_k
    ids = torch.rand((L, *shape, E), generator=g).argsort(-1)[..., :k]
    w = torch.softmax(torch.randn((L, *shape, k), generator=g), -1)
    return ids, w


def test_the_pattern_holds_each_kind_of_block():
    cfg = tiny()
    assert [sub_kind(cfg, s)["mixer"] for s in range(13)] == KINDS
    assert [sub_kind(cfg, s)["moe"] for s in range(13)] == [k == "moe" for k in KINDS]
    assert n_moe_layers(cfg) == 5 and n_moe_layers(CONFIG) == 23
    params, _ = model(cfg)
    for s, kind in enumerate(KINDS):
        assert set(params["blocks"][f"sub{s}"]) == {"ln1", {"global": "attn"}.get(kind, kind)}
    mb = params["blocks"]["sub0"]["mamba2"]
    assert tuple(mb["in_proj"].shape) == (1, 128, 2 * 128 + 2 * 2 * 16 + 4)
    assert tuple(mb["conv_w"].shape) == (1, 4, 128 + 2 * 2 * 16)
    assert mb["A_log"].dtype == mb["D"].dtype == mb["dt_bias"].dtype == torch.float32
    mo = params["blocks"]["sub1"]["moe"]
    assert "shared_w_gate" not in mo and tuple(mo["router_bias"].shape) == (1, 8)
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert set(cache["sub5"]) == {"k", "v"} and cache["sub1"] == {}
    assert tuple(cache["sub0"]["state"]["h"].shape) == (1, 2, 4, 32, 16)
    assert tuple(cache["sub0"]["state"]["conv"].shape) == (1, 2, 3, 128 + 2 * 2 * 16)


def test_the_published_configuration_counts_31_6b_parameters():
    counts = CONFIG.param_counts()
    assert 31.5e9 < counts["total"] < 31.7e9
    assert counts["moe"] == 23 * 128 * 2 * 2688 * 1856
    # 3.2B active besides the embedding's lookup
    assert 3.15e9 < counts["active"] - 131072 * 2688 < 3.3e9


def test_forward_matches_the_reference_and_tf32_does_not():
    cfg = tiny(capacity_factor=100.0)      # no capacity drops: every pair computed
    params, _ = model(cfg)
    tokens = _tokens((2, 37), 1)            # 37: not a whole number of chunks
    ids, w = _routing(cfg, (2, 37), 2)
    got = forward(params, cfg, tokens, routing_override=(ids, w))["logits"]
    want = ref.forward(params, _m(cfg), tokens, ids, w)
    assert compare.logit_error(got[..., : cfg.vocab_size], want) < TOL
    tf32 = ref.forward(params, _m(cfg), tokens, ids, w, prec="tf32")
    assert compare.logit_error(tf32, want) > 10 * TOL


def test_leaving_out_the_passing_of_state_between_chunks_fails(monkeypatch):
    """The program's SSD run chunk by chunk from a zero state each."""
    cfg = tiny(capacity_factor=100.0)
    params, _ = model(cfg)
    tokens = _tokens((2, 37), 1)
    ids, w = _routing(cfg, (2, 37), 2)
    whole = ssm.ssd_chunked

    def alone(x, dt, A, Bm, Cm, chunk):
        return torch.cat([whole(*(t[:, i:i + chunk] for t in (x, dt)), A,
                                *(t[:, i:i + chunk] for t in (Bm, Cm)), chunk)
                          for i in range(0, x.shape[1], chunk)], dim=1)

    monkeypatch.setattr(ssm, "ssd_chunked", alone)
    got = forward(params, cfg, tokens, routing_override=(ids, w))["logits"]
    want = ref.forward(params, _m(cfg), tokens, ids, w)
    assert compare.logit_error(got[..., : cfg.vocab_size], want) > 100 * TOL


def test_the_sigmoid_router_path_matches_the_reference():
    """No routing given: each MoE block routes by its own router, sigmoid
    scores, top-2 on score + correction bias, renormalised, times 2.5."""
    cfg = tiny(capacity_factor=100.0)
    params, _ = model(cfg)
    tokens = _tokens((2, 24), 3)
    out = forward(params, cfg, tokens, collect_router_logits=True)
    want = ref.forward(params, _m(cfg), tokens, None, None)
    assert compare.logit_error(out["logits"][..., : cfg.vocab_size], want) < TOL
    # the choice against the reference's own, on the program's router logits
    p = tree_map(lambda t: t[0], params["blocks"]["sub1"]["moe"])
    logits = out["router_logits"][0].reshape(-1, 8)
    ids, w = moe.router_sigmoid_topk(logits, p["router_bias"], 2)
    s = torch.sigmoid(logits)
    want_ids = torch.sort(s + p["router_bias"], dim=-1, descending=True, stable=True)[1][:, :2]
    assert torch.equal(ids, want_ids)
    chosen = torch.gather(s, -1, ids)
    torch.testing.assert_close(w, chosen / chosen.sum(-1, keepdim=True))
    assert not torch.equal(ids, torch.sort(s, dim=-1, descending=True, stable=True)[1][:, :2])


def _serve(cfg, params, hp, threaded: bool, **kw):
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=6, device="cpu", **kw)
    routes = {}
    inner = eng.store.translate

    def translate(table, trans):
        out = inner(table, trans)
        routes[table.batch_index] = (table.expert_ids, table.weights, np.array(trans))
        return out

    eng.store.translate = translate
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, cfg.vocab_size, (3, 20)).astype(np.int32) for _ in range(3)]
    eng.serve(batches, threaded=threaded)
    eng.close()
    return batches, eng.results, routes, eng


@pytest.mark.parametrize("threaded", [True, False], ids=["threaded_async", "sync"])
def test_serve_matches_the_reference_routed_by_its_table(threaded):
    """6 of 8 slots a MoE block, the experts on the host; the reference is
    routed by each batch's table through the store's own translation and
    capacity (`routing.effective_routing`), the table's α times 2.5."""
    cfg = tiny()
    params, hp = model(cfg)
    batches, results, routes, eng = _serve(cfg, params, hp, threaded,
                                           prefetch_depth=2 if threaded else 0)
    assert eng.store.stats.loads > 0
    for i, toks in enumerate(batches):
        ids, alpha, trans = routes[i]
        eff = routing.effective_routing(ids, alpha, trans, 6, cfg.moe.top_k,
                                        cfg.moe.capacity_factor)
        want = ref.forward(params, _m(cfg), torch.as_tensor(toks),
                           torch.as_tensor(ids[..., : eff.shape[-1]]), torch.as_tensor(eff))
        assert compare.logit_error(results[i][..., : cfg.vocab_size], want) < TOL


def test_decode_step_matches_the_full_forward_at_every_position():
    cfg = tiny(capacity_factor=100.0)
    params, _ = model(cfg)
    B, T = 2, 20
    tokens = _tokens((B, T), 4)
    ids, w = _routing(cfg, (B, T), 5)
    want = ref.forward(params, _m(cfg), tokens, ids, w)
    cache = init_cache(cfg, B, 32, device="cpu")
    for t in range(T):
        logits, cache = decode_step(params, cache, tokens[:, t], cfg,
                                    routing_override=(ids[:, :, t], w[:, :, t]))
        assert compare.logit_error(logits[:, : cfg.vocab_size], want[:, t]) < TOL, t


def _ssd_inputs(S, seed, b=2, H=4, P=8, G=2, N=16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, S, H, P), generator=g)
    delta = torch.nn.functional.softplus(torch.randn((b, S, H), generator=g) - 1.0)
    A = -torch.exp(torch.rand((H,), generator=g) * 2.7)
    Bm, Cm = torch.randn((b, S, G, N), generator=g), torch.randn((b, S, G, N), generator=g)
    return x, delta, A, Bm, Cm


@pytest.mark.parametrize("S,chunk", [(37, 16), (64, 16), (5, 16), (33, 8)])
def test_the_chunked_ssd_matches_the_sequential_recurrence(S, chunk):
    x, delta, A, Bm, Cm = _ssd_inputs(S, S + chunk)
    R = x.shape[2] // Bm.shape[2]
    want = ref.ssd_sequential(x, delta, A, Bm.repeat_interleave(R, 2), Cm.repeat_interleave(R, 2))
    got = ssm.ssd_chunked(x, delta, A, Bm, Cm, chunk)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < SSD_TOL * scale
    if S > chunk:
        # each chunk from a zero state, the passing of state left out
        alone = torch.cat([ssm.ssd_chunked(*(t[:, i:i + chunk] for t in (x, delta)), A,
                                           *(t[:, i:i + chunk] for t in (Bm, Cm)), chunk)
                           for i in range(0, S, chunk)], dim=1)
        assert float((alone - want).abs().max()) > 1e3 * SSD_TOL * scale


def test_relu2_expert_ffn_plain_and_dispatch():
    """relu² as the activation, `expert_ffn_ref` and `ops.expert_ffn` on the
    CPU, against relu(x W_in)² W_out written out; its backward."""
    g = torch.Generator().manual_seed(9)
    xe, wi, wo = (torch.randn(s, generator=g) for s in ((3, 5, 16), (3, 16, 24), (3, 24, 16)))
    want = torch.einsum("ecf,efd->ecd", torch.clamp(xe @ wi, min=0) ** 2, wo)
    torch.testing.assert_close(expert_ffn_ref(xe, wi, None, wo, act="relu2"), want)
    torch.testing.assert_close(ops.expert_ffn(xe, wi, None, wo, act="relu2"), want)
    v = torch.tensor([-2.0, 0.0, 0.5, 3.0])
    torch.testing.assert_close(act_fn("relu2")(v), torch.tensor([0.0, 0.0, 0.25, 9.0]))
    # the kernels' backward (kernels/autograd.py) against autograd of the plain FFN
    dy = torch.randn((3, 5, 16), generator=g)
    leaves = [t.clone().requires_grad_() for t in (xe, wi, wo)]
    expert_ffn_ref(leaves[0], leaves[1], None, leaves[2], act="relu2").backward(dy)
    dx, dwi, dwg, dwo = expert_ffn_backward(xe, wi, None, wo, "relu2", dy)
    assert dwg is None
    for got, leaf in zip((dx, dwi, dwo), leaves):
        torch.testing.assert_close(got, leaf.grad)


def test_spans_and_device_counters_only_when_recording():
    """With spans on, each Mamba-2 mixer call is a `model.mamba2` span
    holding a `model.ssd`, counts in `mamba2_calls` and adds its seconds (on
    the CPU, the host clock's) to `mamba2_device_s` and the SSD's to
    `ssd_device_s`; with them off, or without a telemetry, nothing is
    recorded and the logits are the same."""
    cfg = tiny()
    params, _ = model(cfg)
    tokens = _tokens((2, 16), 6)
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
    assert names.count(("model.mamba2", None)) == 6
    assert names.count(("model.ssd", "model.mamba2")) == 6
    assert on.counter("mamba2_calls").value == 6
    mixer, ssd = on.counter("mamba2_device_s").value, on.counter("ssd_device_s").value
    assert 0 < ssd < mixer
    assert not on._deferred


@pytest.mark.gpu
def test_tiny_model_on_the_card_matches_the_cpu():
    """The same weights and routing on the card and on the CPU: the card's
    fp32 (flash_prefill for the attention, its own matmuls) within 1e-3 of
    the CPU's, TF32 being off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tiny(capacity_factor=100.0)
    params, _ = model(cfg)
    tokens = _tokens((2, 64), 8)
    ids, w = _routing(cfg, (2, 64), 9)
    want = forward(params, cfg, tokens, routing_override=(ids, w))["logits"]
    dev = tree_map(lambda t: t.cuda(), params)
    with ref.exact_fp32():
        got = forward(dev, cfg, tokens.cuda(), routing_override=(ids.cuda(), w.cuda()))["logits"]
    assert compare.logit_error(got.cpu()[..., : cfg.vocab_size], want[..., : cfg.vocab_size]) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("E,C", [(4, 8), (4, 240), (2, 384)])
def test_relu2_expert_ffn_kernels_match_plain_in_bf16(fmt, E, C):
    """The relu² epilogue of the Hopper GEMM at nemotron's widths (d 2688 ->
    F 1856), bf16 weights and the int8 / int4 slot formats, at the decode
    tile (8 rows), the cell's capacity a 4,096-token block (240) and its
    rows an expert (384; a launch of the cell's holds 2 x 240),
    against the plain version within 5e-2 (absolute and relative: bf16
    rounds h and y; the weights at the served scale keep y O(1))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.offload import quantize_stack_int4, quantize_stack_int8
    from repro_torch.kernels import ref as kref

    d, F = 2688, 1856
    g = torch.Generator().manual_seed(E * 1000 + C)
    xe = torch.randn((E, C, d), generator=g).to(torch.bfloat16).cuda()
    wi = torch.randn((E, d, F), generator=g) * d ** -0.5
    wo = torch.randn((E, F, d), generator=g) * F ** -0.5
    if fmt == "bf16":
        args = (xe, wi.to(torch.bfloat16).cuda(), None, wo.to(torch.bfloat16).cuda())
        got, want = ops.expert_ffn(*args, act="relu2"), kref.expert_ffn_ref(*args, act="relu2")
    elif fmt == "int8":
        (qi, si), (qo, so) = ((t.cuda() for t in quantize_stack_int8(w, "cuda", "channel"))
                              for w in (wi, wo))
        args = (xe, qi, si, None, None, qo, so)
        got, want = ops.expert_ffn_q(*args, act="relu2"), kref.expert_ffn_q_ref(*args, act="relu2")
    else:
        (qi, si), (qo, so) = ((t.cuda() for t in quantize_stack_int4(w, "cuda", 64))
                              for w in (wi, wo))
        args = (xe, qi, si, None, None, qo, so)
        got, want = (ops.expert_ffn_q4(*args, act="relu2"),
                     kref.expert_ffn_q4_ref(*args, act="relu2"))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [8, 4], ids=["resident", "uploads"])
def test_replayed_decode_equals_the_eager_decode_on_the_card(slots, monkeypatch):
    """`SiDADecodeEngine` on the card captures the decode step, the Mamba-2
    state's update in place included, as one CUDA graph over its ring: two
    calls replayed give the tokens and launches of the same calls never
    captured (fp32, the ring wraps at 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tiny(capacity_factor=100.0)
    params, hp = model(cfg)
    rng = np.random.default_rng(3)
    starts = [rng.integers(0, cfg.vocab_size, (4,)).astype(np.int32) for _ in range(2)]
    steps, runs = 24, {}
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(decode_engine, "graph_engages", lambda *a: False)
        eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=slots, device="cuda")
        torch.cuda.synchronize()
        ops.reset_launches()
        out = [eng.generate(s, steps=steps, cache_len=16) for s in starts]
        runs[eager] = ([o[0] for o in out], ops.launches(), [o[1].graph_steps for o in out])
        eng.close()
    monkeypatch.undo()
    for g, e in zip(runs[False][0], runs[True][0]):
        np.testing.assert_array_equal(g, e)
    assert runs[False][1] == runs[True][1]
    assert runs[False][2] == [steps - GRAPH_WARM_STEPS, steps]
    assert runs[True][2] == [0, 0]
