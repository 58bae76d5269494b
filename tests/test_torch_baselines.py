"""The port's serving baselines (`repro_torch.core.baselines`) against the JAX
package's on the committed trained miniature `experiments/cache/sys_E8`:
the same batches from `SyntheticLM`, logits within 1e-4 relative in fp32,
and equal store loads, evictions, `bytes_h2d` and `device_memory_bytes`.
Also `tests/test_engine.py`'s parity (OnDemand at E slots and PrefetchAll
at 2 slots against Standard), the serve metrics, the serve CLI's engines on
the CPU, and the copied synthetic corpus against the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import baselines as jb
from repro.data.synthetic import SyntheticConfig as JSynthConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro_torch.core import baselines as tb
from repro_torch.data.synthetic import LENGTH_PROFILES, SyntheticConfig, SyntheticLM
from test_torch_engine import e8  # noqa: F401  (module fixture: sys_E8 in both packages)

torch.set_num_threads(2)
REL = 1e-4


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))


def _batches(cfg, n=3, batch=2, seq=24, seed=0):
    lm = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=seq), seed=seed)
    return [lm.sample(batch)[0] for _ in range(n)]


def _pair(e8, kind, slots):
    cfg_j, cfg_t, pj, _, pt, _ = e8
    if kind == "standard":
        return jb.StandardServer(cfg_j, pj), tb.StandardServer(cfg_t, pt, device="cpu")
    cls_j = {"ondemand": jb.OnDemandServer, "prefetchall": jb.PrefetchAllServer}[kind]
    cls_t = {"ondemand": tb.OnDemandServer, "prefetchall": tb.PrefetchAllServer}[kind]
    return cls_j(cfg_j, pj, slots_per_layer=slots), cls_t(cfg_t, pt, slots_per_layer=slots,
                                                         device="cpu")


def _logits(srv, toks):
    if isinstance(srv, jb.StandardServer):
        return np.asarray(srv._fwd(srv.params, jnp.asarray(toks)))
    if isinstance(srv, tb.StandardServer):
        return srv._fwd(toks).numpy()
    out = srv._forward_batch(toks)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


@pytest.mark.parametrize("kind,slots", [("standard", 0), ("ondemand", 2), ("ondemand", 4),
                                        ("prefetchall", 2), ("prefetchall", 3)])
def test_baseline_matches_jax_on_e8(e8, kind, slots):
    cfg_t = e8[1]
    sj, st = _pair(e8, kind, slots)
    for toks in _batches(cfg_t):
        assert _rel_err(_logits(st, toks), _logits(sj, toks)) < REL
    assert st.device_memory_bytes() == sj.device_memory_bytes()
    if kind != "standard":
        a, b = st.store.stats, sj.store.stats
        for f in ("loads", "evictions", "hits", "dropped", "bytes_h2d"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.loads > 0 and (kind == "ondemand" and slots == 4 or a.evictions > 0)
        assert st.store.resident == sj.store.resident


@pytest.mark.parametrize("kind,slots", [("ondemand", 8), ("prefetchall", 2)])
def test_parity_with_standard_on_e8(e8, kind, slots):
    """tests/test_engine.py's parity on the trained miniature: OnDemand at E
    slots and PrefetchAll at 2 slots give Standard's logits (the padded
    vocab columns, which Standard masks and the layer loop does not, apart).
    As there, capacity_factor 100, so no path drops a token: PrefetchAll
    sizes each wave's capacity over its 2 slots, Standard over 8 experts,
    and at sys_E8's own factor of 4 Standard drops tokens the waves keep
    (the JAX baselines differ by the same 9 %)."""
    cfg_t, pt = e8[1], e8[4]
    cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe, capacity_factor=100.0))
    std = tb.StandardServer(cfg_t, pt, device="cpu")
    cls = {"ondemand": tb.OnDemandServer, "prefetchall": tb.PrefetchAllServer}[kind]
    srv = cls(cfg_t, pt, slots_per_layer=slots, device="cpu")
    V = cfg_t.vocab_size
    for toks in _batches(cfg_t, n=2, seed=3):
        assert _rel_err(_logits(srv, toks)[..., :V], _logits(std, toks)[..., :V]) < REL


@pytest.mark.parametrize("kind", ["standard", "ondemand", "prefetchall"])
def test_serve_metrics_and_memory(e8, kind):
    cfg_t, pt = e8[1], e8[4]
    srv = _pair(e8, kind, 2)[1]
    batches = _batches(cfg_t, n=2)
    m = srv.serve(batches)
    assert len(m.latency_s) == 2 and m.tokens == sum(b.size for b in batches)
    assert m.summary()["throughput_tok_s"] > 0
    std = tb.StandardServer(cfg_t, pt, device="cpu").device_memory_bytes()
    if kind == "standard":
        assert srv.device_memory_bytes() == std
    else:
        assert srv.device_memory_bytes() < std   # 2 of 8 experts resident
        assert set(srv.routers) == {f"sub{s}" for s in srv.store.moe_subs}


@pytest.mark.parametrize("profile", [None, *LENGTH_PROFILES])
def test_synthetic_copy_matches_reference(profile):
    kw = dict(vocab_size=512, seq_len=480 if profile == "multirc" else 96, profile=profile)
    a = SyntheticLM(SyntheticConfig(**kw), seed=5).sample(4)
    b = JSyntheticLM(JSynthConfig(**kw), seed=5).sample(4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("argv", [["--engine", "standard"], ["--engine", "ondemand"],
                                  ["--engine", "prefetchall"],
                                  ["--engine", "sida", "--prefetch-depth", "2",
                                   "--staging-buffers", "1"]],
                         ids=["standard", "ondemand", "prefetchall", "sida-async"])
def test_serve_cli_runs_each_engine_on_the_cpu(capsys, argv):
    from repro_torch.launch import serve

    serve.main(argv + ["--device", "cpu", "--slots", "2", "--batches", "2", "--batch", "2",
                       "--seq", "8"])
    out = capsys.readouterr().out
    assert out.startswith(f"engine={argv[1]} slots=2")
    for key in ("throughput_tok_s", "mean_latency_s", "device_mem_mb"):
        assert key in out
    assert ("prefetch_uploads" in out) == (argv[1] == "sida")
    assert ("reduction" in out) == (argv[1] == "sida")
