"""What one device holds of the dry run's arguments: the port's
`shard_bytes` over its partition specs against XLA's
`compiled.memory_analysis().argument_size_in_bytes` for the reference's
lowering of the same step, equal to the byte, on a (2, 4) mesh: reduced
switch-base-8 and deepseek-moe-16b, train and decode. The arguments are the
ones the step reads: `jax.jit` prunes the rest (switch's `w_gate`, kept for
a non-gated config, in decode). The JAX side compiles in a subprocess with
8 host devices, as `tests/test_sharding.py` does; the port traces its step
over fake tensors."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs.base import InputShape, get_config
from repro_torch.launch.dryrun import argument_bytes, build_lowering, trace_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import policy

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NAMES = ("switch-base-8", "deepseek-moe-16b")
SHAPES = {"train": InputShape("t", 64, 8, "train"), "decode": InputShape("d", 64, 8, "decode")}

_JAX_SCRIPT = """
import json
from repro.configs.base import InputShape, get_config
from repro.launch.dryrun import build_lowering
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for name in %(names)r:
    cfg = get_config(name).reduced()
    for kind in ("train", "decode"):
        lowered, _ = build_lowering(cfg, InputShape("x", 64, 8, kind), mesh)
        out[f"{name}/{kind}"] = lowered.compile().memory_analysis().argument_size_in_bytes
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def xla_argument_bytes():
    env = dict(os.environ, PYTHONPATH=SRC, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT % {"names": NAMES})],
                         capture_output=True, text=True, env=env, timeout=420)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("name", NAMES)
def test_argument_bytes_per_device_match_xla(xla_argument_bytes, name, kind):
    mesh = make_mesh((2, 4), ("data", "model"))
    mode = policy.fake_mode()
    step, args, meta = build_lowering(get_config(name).reduced(), SHAPES[kind], mesh, mode=mode)
    *_, read = trace_step(step, args, mode)
    assert sum(argument_bytes(args, meta, mesh, read)) == xla_argument_bytes[f"{name}/{kind}"]
