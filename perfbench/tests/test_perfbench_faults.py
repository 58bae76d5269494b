"""The check against a timed path broken underneath: each fault a serving
cell can have makes `correct` false (the chip's look is skipped; the rest of
a run is driven on the CPU at tiny sizes)."""
import pytest
import torch

from perfbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _wrap(obj, attr, change):
    inner = getattr(obj, attr)
    setattr(obj, attr, lambda *a, **k: change(inner(*a, **k), *a))


def answer_altered(drv):
    """Each batch's logits at position 1 are those of position 0."""
    def change(logits, *_):
        logits = logits.clone()
        logits[:, 1] = logits[:, 0]
        return logits
    _wrap(drv.eng, "infer", change)


def half_batch_left_out(drv):
    """The second half of each batch's rows is never computed."""
    def change(logits, *_):
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits
    _wrap(drv.eng, "infer", change)


def uploads_dropped(drv):
    """The store's state never changes: planned uploads are not written."""
    drv.eng.store.commit_loads = lambda s, items: None
    for pool in drv.eng.store.serve_params["blocks"].values():
        for k, t in pool.get("moe", {}).items():
            if k in ("w_in", "w_gate", "w_out"):
                t.zero_()


def token_altered(drv):
    """Every lane's token at each step is replaced by the next id."""
    V = drv.m["vocab_size"]
    _wrap(drv.eng, "_step", lambda out, *_: (((out[0] + 1) % V).to(out[0].dtype), out[1]))


def cache_unchanged(drv):
    """The decode step returns its K/V cache as it found it."""
    inner = drv.eng._step

    def step(cache, *args):
        saved = {k: {n: t.clone() for n, t in v.items() if n in ("k", "v")}
                 for k, v in cache.items() if isinstance(v, dict)}
        tokens, cache = inner(cache, *args)
        for k, v in saved.items():
            for n, t in v.items():
                cache[k][n].copy_(t)
        return tokens, cache
    drv.eng._step = step


def decode_half_lanes(drv):
    """The expert layers skip the second half of the lanes."""
    def change(out, *_):
        slots, w = out
        w = w.clone()
        w[:, w.shape[1] // 2:] = 0
        return slots, w
    _wrap(drv.eng.store, "translate_device", change)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.batch", answer_altered), ("tiny.batch", half_batch_left_out),
    ("tiny.batch", uploads_dropped), ("tiny.async", answer_altered),
    ("tiny.async", half_batch_left_out),
    ("tiny.decode", token_altered), ("tiny.decode", cache_unchanged),
    ("tiny.decode", decode_half_lanes),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(root, cell, fault):
    with torch.inference_mode(False):
        out = tiny.run(root, cell, hook=fault)
    assert out["result"]["correct"] is False, out["checks"]
