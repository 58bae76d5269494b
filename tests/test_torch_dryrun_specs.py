"""The port's training-mesh sharding policy and meshes against the
reference's (`repro/sharding/policy.py`, `repro/launch/mesh.py`) and the
seq-split decode attention, on the CPU.

* `param_specs` and `cache_specs` equal to the reference's, dimension by
  dimension, for all fourteen configs at full width on the pod (16, 16) and
  multipod (2, 16, 16) meshes; the caches at decode_32k and, where the arch
  runs it, long_500k. The JAX side runs in a subprocess with 512 host
  devices (`eval_shape` only, nothing compiled), as `tests/test_sharding.py`
  runs its 8; the port builds its shapes as fake tensors.
* `decode_attention` under a ctx whose `decode_seq_axis` splits the cache:
  within 1e-5 of the unsplit plain path (fp32), and within 1e-4 of the
  reference's `shard_map` decode on a (2, 4) mesh (the case of
  `tests/test_sharding.py::test_flash_decode_sharded_matches_local`); on
  CUDA tensors (fakes here) the split raises instead of running plain
  PyTorch on the card.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import INPUT_SHAPES, get_config, list_configs, shape_supported
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import AUDIO_ENC_FRAMES
from repro_torch.models.attention import ShardingCtx, decode_attention
from repro_torch.sharding import policy
from repro_torch.tree import flatten

torch.set_num_threads(2)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ("pod", "multipod")
CACHE_SHAPES = ("decode_32k", "long_500k")

# the seq-split decode case of tests/test_sharding.py
B, H, K, D, S = 2, 4, 2, 32, 64
POS = [40, 63]


def _decode_inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    pos = np.asarray(POS, np.int32)
    sidx = np.arange(S)[None, :]
    slot_pos = (pos[:, None] - ((pos[:, None] - sidx) % S)).astype(np.int32)
    return q, k, v, slot_pos, pos


_JAX_SCRIPT = """
import json, sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import INPUT_SHAPES, get_config, list_configs, shape_supported
from repro.launch.mesh import make_mesh, make_production_mesh
from repro.launch.specs import AUDIO_ENC_FRAMES
from repro.models.attention import ShardingCtx, decode_attention
from repro.sharding import policy

def flat(tree):
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = [list(e) if isinstance(e, tuple) else e for e in spec]
    return out

res = {"meshes": {}, "params": {}, "caches": {}}
for kind in %(meshes)r:
    mesh = make_production_mesh(multi_pod=(kind == "multipod"))
    res["meshes"][kind] = [dict(mesh.shape), list(mesh.axis_names)]
    for name in list_configs():
        cfg = get_config(name)
        res["params"][f"{name}/{kind}"] = flat(policy.param_specs(cfg, mesh))
        for sname in %(cache_shapes)r:
            shape = INPUT_SHAPES[sname]
            if not shape_supported(cfg, shape)[0]:
                continue
            enc = AUDIO_ENC_FRAMES if cfg.enc_dec else 0
            res["caches"][f"{name}/{kind}/{sname}"] = flat(policy.cache_specs(
                cfg, mesh, shape.global_batch, shape.seq_len, enc))

q, k, v, sp, pos = (np.asarray(a) for a in json.load(open(sys.argv[1])))
mesh = make_mesh((2, 4), ("data", "model"))
ctx = ShardingCtx(mesh=mesh, batch_axes=("data",), model_axis="model", decode_seq_axis=("model",))
got = jax.jit(lambda *a: decode_attention(*a, window=0, cap=0.0, ctx=ctx))(
    q.astype(np.float32), k.astype(np.float32), v.astype(np.float32), sp.astype(np.int32),
    pos.astype(np.int32))
res["decode"] = np.asarray(got).tolist()
print("RESULT" + json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's specs, meshes and shard_map decode from a 512-device
    JAX subprocess."""
    path = tmp_path_factory.mktemp("specs") / "decode_inputs.json"
    path.write_text(json.dumps([a.tolist() for a in _decode_inputs()]))
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    script = textwrap.dedent(_JAX_SCRIPT % {"meshes": MESHES, "cache_shapes": CACHE_SHAPES})
    out = subprocess.run([sys.executable, "-c", script, str(path)], capture_output=True,
                         text=True, env=env, timeout=420)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def _flat(specs) -> dict:
    return {k: [list(e) if isinstance(e, tuple) else e for e in v]
            for k, v in flatten(specs).items()}


@pytest.mark.parametrize("kind", MESHES)
def test_production_meshes_match_reference(reference, kind):
    mesh = make_production_mesh(multi_pod=kind == "multipod")
    assert [mesh.shape, list(mesh.axis_names)] == reference["meshes"][kind]
    assert mesh.size == (512 if kind == "multipod" else 256)
    assert make_mesh((2, 4), ("data", "model")).shape == {"data": 2, "model": 4}


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("name", list_configs())
def test_param_and_cache_specs_match_reference(reference, name, kind):
    cfg = get_config(name)
    mesh = make_production_mesh(multi_pod=kind == "multipod")
    assert _flat(policy.param_specs(cfg, mesh)) == reference["params"][f"{name}/{kind}"]
    for sname in CACHE_SHAPES:
        shape = INPUT_SHAPES[sname]
        key = f"{name}/{kind}/{sname}"
        if not shape_supported(cfg, shape)[0]:
            assert key not in reference["caches"]
            continue
        enc = AUDIO_ENC_FRAMES if cfg.enc_dec else 0
        got = policy.cache_specs(cfg, mesh, shape.global_batch, shape.seq_len, enc)
        assert _flat(got) == reference["caches"][key], key


def test_opt_token_and_decode_plan_specs():
    """The small rules the dry run reads, at the reference's values."""
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert policy.opt_specs(None, pod, {"w": policy.P("model")}) == {
        "m": {"w": ("model",)}, "v": {"w": ("model",)}, "t": ()}
    assert policy.token_specs(multi, 256) == (("pod", "data"), None)
    assert policy.batch_axes_for(multi, 16) == ("data",)
    assert policy.batch_axes_for(multi, 2) == ("pod",)
    assert policy.token_specs(multi, 16) == ("data", None)
    assert policy.decode_plan(pod, 128) == (("data",), ("model",))
    assert policy.decode_plan(multi, 1) == (None, ("model", "pod", "data"))
    assert policy.slot_pool_spec() == (None, "model", None, None)
    ctx = policy.make_ctx(multi)
    assert (ctx.batch_axes, ctx.model_axis, ctx.decode_seq_axis) == (("pod", "data"), "model", None)
    assert ctx.batch_spec(64) == ("pod", "data") and ctx.batch_spec(3) is None


def test_shard_bytes_divides_by_the_sharded_extent():
    mesh = make_mesh((2, 4), ("data", "model"))
    tree = {"w": torch.zeros(8, 16), "b": torch.zeros(16, dtype=torch.bfloat16), "t": 0}
    specs = {"w": policy.P("data", "model"), "b": policy.P(), "t": policy.P()}
    assert policy.shard_bytes(tree, specs, mesh) == 8 * 16 * 4 // 8 + 16 * 2 + 4


def _split_ctx():
    return ShardingCtx(mesh=make_mesh((2, 4), ("data", "model")), batch_axes=("data",),
                       model_axis="model", decode_seq_axis=("model",))


def test_seq_split_decode_matches_local():
    q, k, v, sp, pos = (torch.from_numpy(a) for a in _decode_inputs())
    ctx = _split_ctx()
    assert ctx.seq_shards(S) == 4 and ctx.seq_shards(S + 2) == 0
    for window, cap in ((0, 0.0), (16, 30.0)):
        got = decode_attention(q, k, v, sp, pos, window, cap, ctx=ctx)
        want = decode_attention(q, k, v, sp, pos, window, cap)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_seq_split_decode_matches_reference_shard_map(reference):
    q, k, v, sp, pos = (torch.from_numpy(a) for a in _decode_inputs())
    got = decode_attention(q, k, v, sp, pos, 0, 0.0, ctx=_split_ctx())
    np.testing.assert_allclose(got.numpy(), np.asarray(reference["decode"], np.float32),
                               atol=1e-4, rtol=1e-4)


def test_seq_split_decode_refuses_cuda_tensors():
    """The split is the dry run's CPU layout: CUDA tensors under a ctx that
    splits raise rather than run the plain path on the card. Fake CUDA
    tensors reach the check without a card."""
    with policy.fake_mode():
        q, k, v, sp, pos = (torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, device="cuda")
                            for a in _decode_inputs())
        assert q.device.type == "cuda"
        with pytest.raises(ValueError, match="splits the cache 4 ways"):
            decode_attention(q, k, v, sp, pos, 0, 0.0, ctx=_split_ctx())
