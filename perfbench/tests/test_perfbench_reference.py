"""The plain reference against repro_torch on the CPU at tiny sizes, in
float32: the predictor (batch and one-token), SparseMax, and the served
forward through the program's store, translation and capacity drops."""
import dataclasses

import numpy as np
import pytest
import torch

from perfbench import generate, modelcfg, weights
from perfbench.reference import moe_transformer as ref
from perfbench.reference import routing
from perfbench.tests.tiny import CONFIGS


def fp32(spec):
    spec = {**spec, "model": {**spec["model"], "dtype": "float32"}}
    return spec, modelcfg.build(spec)


def n_moe(m):
    return m["n_layers"] // m["moe"]["moe_every"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_predictor_matches_the_program(name):
    from repro_torch.core.decode_engine import hash_fn_step, hash_state_init
    from repro_torch.core.hash_fn import hash_fn_apply

    spec, _ = fp32(CONFIGS[name])
    m = spec["model"]
    hp = weights.predictor_params(spec, "cpu")
    emb = torch.randn((3, 20, m["d_model"]), generator=torch.Generator().manual_seed(0))
    E = m["moe"]["num_experts"]
    want = hash_fn_apply(hp, emb, num_experts=E)
    torch.testing.assert_close(ref.predictor_logits(hp, emb, n_moe(m), E), want,
                               rtol=1e-5, atol=1e-5)
    state, steps = hash_state_init(hp, 3), []
    for t in range(emb.shape[1]):
        lg, state = hash_fn_step(hp, emb[:, t], state, E)
        steps.append(lg)
    got = ref.decode_predictor_logits(hp, emb, n_moe(m), E, history=8)
    # the program's ring is 128 long; over 20 steps it sees every output
    torch.testing.assert_close(ref.decode_predictor_logits(hp, emb, n_moe(m), E, history=128),
                               torch.stack(steps, 1), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, torch.stack(steps, 1))


def test_sparsemax_matches_the_program():
    from repro_torch.kernels.ref import sparsemax_ref

    z = torch.randn((64, 33), generator=torch.Generator().manual_seed(1)) * 3
    z[::5, 7:] = -1e30
    torch.testing.assert_close(ref.sparsemax(z), sparsemax_ref(z), rtol=1e-6, atol=1e-6)
    assert torch.allclose(ref.sparsemax(z).sum(-1), torch.ones(64))


@pytest.mark.parametrize("name,slots,depth", [("tiny-switch", 2, 0), ("tiny-switch", 4, 0),
                                              ("tiny-deepseek", 3, 0), ("tiny-deepseek", 3, 2)])
def test_served_forward_matches_the_program(name, slots, depth):
    """SiDAEngine.serve in fp32 on the CPU (threaded, synchronous or async
    prefetch) against the reference routed by the program's tables through
    the reference's own translation and capacity."""
    from repro_torch.core.engine import SiDAEngine

    spec, cfg = fp32(CONFIGS[name])
    m = spec["model"]
    E = m["moe"]["num_experts"]
    eng = SiDAEngine(cfg, weights.model_params(spec, "cpu"), weights.predictor_params(spec, "cpu"),
                     slots_per_layer=slots, device="cpu", prefetch_depth=depth)
    seen = {}
    inner = eng.store.translate

    def translate(table, trans):
        seen[table.batch_index] = (table.expert_ids, table.weights, np.array(trans))
        return inner(table, trans)
    eng.store.translate = translate
    rng = generate.streams(9, 1)[0]
    batches = [generate.token_ids(rng, (4, 24), m["vocab_size"], {"kind": "uniform"})
               for _ in range(3)]
    eng.serve(batches, threaded=True)
    eng.close()
    W = weights.model_params(spec, "cpu")
    for j, toks in enumerate(batches):
        ids, alpha, trans = seen[j]
        need = routing.needed_experts(ids, alpha, min(slots, E), E)
        assert routing.residency_faults(trans, need, min(slots, E)) == (0, 0)
        w = routing.effective_routing(ids, alpha, trans, min(slots, E), m["moe"]["top_k"],
                                      m["moe"]["capacity_factor"])
        want = ref.forward(W, m, torch.as_tensor(toks), torch.as_tensor(ids).long(),
                           torch.as_tensor(w))
        got = eng.results[j][..., : m["vocab_size"]]
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_fp8_control_is_lower_precision():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(2))
    err8 = (ref.lower(x, "fp8") - x).abs().max() / x.abs().max()
    err32 = (ref.lower(x, "tf32") - x).abs().max() / x.abs().max()
    assert 1e-5 < err32 < 1e-3 < err8 < 0.1
    assert torch.equal(ref.lower(x, "fp32"), x)
