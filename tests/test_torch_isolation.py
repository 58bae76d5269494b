"""The port stands alone: it imports neither JAX nor the JAX package, it runs
on the card unless told otherwise (no quiet CPU fallback), and its copied
configs equal the reference's field by field."""
import dataclasses
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs as jlist_configs
from repro_torch.configs.base import get_config, list_configs

REPO = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|\.|,|$)|from\s+repro(\s|\.))",
    re.MULTILINE,
)


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_jax_and_no_repro():
    hits = []
    for path in _port_sources():
        with open(path) as fh:
            for m in FORBIDDEN.finditer(fh.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not hits, hits
    assert FORBIDDEN.search("from repro.models import moe")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.models import moe")


def test_importing_the_port_loads_no_jax():
    mods = [
        "repro_torch", "repro_torch.checkpoint", "repro_torch.core.engine",
        "repro_torch.core.decode_engine", "repro_torch.core.offload",
        "repro_torch.launch.serve", "repro_torch.kernels.ops",
        "repro_torch.kernels.flash_decode", "repro_torch.kernels.expert_gemm",
        "repro_torch.core.residency", "repro_torch.core.baselines",
        "repro_torch.data.synthetic", "repro_torch.serving", "repro_torch.serving.server",
        "repro_torch.serving.config", "repro_torch.serving.scheduler",
        "repro_torch.core.faults", "repro_torch.kernels.autograd", "repro_torch.optim.adamw",
        "repro_torch.optim.schedule", "repro_torch.launch.steps", "repro_torch.launch.train",
        "repro_torch.core.tkd", "repro_torch.core.sparsity",
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        + "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_port_sources_cover_the_decode_slice():
    names = {os.path.relpath(p, PORT) for p in _port_sources()}
    for mod in ("core/decode_engine.py", "kernels/flash_decode.py", "kernels/expert_gemm.py",
                "core/offload.py", "models/attention.py", "core/baselines.py",
                "data/synthetic.py", "serving/server.py", "serving/config.py",
                "serving/scheduler.py", "serving/request.py", "serving/telemetry.py",
                "core/faults.py", "kernels/autograd.py", "optim/adamw.py", "optim/schedule.py",
                "launch/steps.py", "launch/train.py", "core/tkd.py", "core/sparsity.py"):
        assert mod in names, mod


def test_default_device_is_cuda_and_never_falls_back_to_cpu(monkeypatch):
    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.engine import SiDAEngine
    from repro_torch.core.hash_fn import init_hash_fn
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_cache, init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("switch-base-8").reduced()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(gen, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_hash_fn(gen, cfg.d_model, 1, cfg.moe.num_experts, d_h=8)
    params = init_params(gen, cfg, device="cpu")
    hp = init_hash_fn(gen, cfg.d_model, 1, cfg.moe.num_experts, d_h=8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SiDAEngine(cfg, params, hp, slots_per_layer=2)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--batches", "1", "--batch", "1", "--seq", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SiDADecodeEngine(cfg, params, hp, slots_per_layer=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--batches", "1", "--batch", "1", "--seq", "4", "--quantized-slots"])
    assert SiDAEngine(cfg, params, hp, slots_per_layer=2, device="cpu").device.type == "cpu"
    assert SiDADecodeEngine(cfg, params, hp, slots_per_layer=2, device="cpu").device.type == "cpu"


ATTENTION_FAMILY = ["chameleon-34b", "deepseek-moe-16b", "gemma2-9b", "qwen2-1.5b",
                    "qwen3-moe-235b-a22b", "smollm-135m", "stablelm-12b"]
OTHER_FAMILIES = ["hymba-1.5b", "xlstm-125m", "seamless-m4t-medium"]
SWITCH = [f"switch-base-{e}" for e in (8, 64, 128, 256)]


def test_the_port_registers_the_attention_family_and_switch():
    """All 14 of the reference's configs: the attention family, the Switch
    family, and the hybrid, recurrent and encoder-decoder archs."""
    assert list(list_configs()) == sorted(ATTENTION_FAMILY + OTHER_FAMILIES + SWITCH)
    assert list(list_configs()) == list(jlist_configs())


# the fields only the port's configs have (nemotron_h's Mamba-2 sizes and
# its router), each at the default that leaves a JAX config's model as it is
PORT_ONLY = {"moe": {"score_func": "softmax", "routed_scaling_factor": 1.0},
             "ssm": {"mamba2_heads": 0, "mamba2_head_dim": 64, "n_groups": 1, "chunk_size": 128}}


def split_port_only(t: dict, j: dict):
    """(the port's fields that the JAX config has, nested as in `t`; those
    it has not)."""
    shared, extra = {}, {}
    for k, v in t.items():
        if k not in j:
            extra[k] = v
        elif isinstance(v, dict) and isinstance(j[k], dict):
            shared[k], sub = split_port_only(v, j[k])
            if sub:
                extra[k] = sub
        else:
            shared[k] = v
    return shared, extra


@pytest.mark.parametrize("name", ATTENTION_FAMILY + OTHER_FAMILIES + SWITCH)
def test_configs_match_jax_field_by_field(name):
    assert name in list_configs()
    t, j = get_config(name), jget_config(name)
    for tc, jc in ((t, j), (t.reduced(), j.reduced())):
        shared, extra = split_port_only(dataclasses.asdict(tc), dataclasses.asdict(jc))
        assert shared == dataclasses.asdict(jc)
        assert extra == PORT_ONLY
    assert (t.padded_vocab, t.hd, t.param_counts()) == (j.padded_vocab, j.hd, j.param_counts())
