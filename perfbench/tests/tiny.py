"""A throwaway copy of the benchmark with tiny cells added as files alone,
for running the harness end to end on the CPU."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, Optional

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
LIMITS = {"slots_missing": 0, "slots_invalid": 0, "hash_gap": 1e-4, "alpha_err": 1e-4}


def _config(src: str, name: str, model: Dict, moe: Dict) -> Dict:
    spec = json.loads((ROOT / "perfbench" / "configs" / f"{src}.json").read_text())
    spec["name"] = name
    spec["model"].update(model)
    spec["model"]["moe"].update(moe)
    spec["weights"]["predictor_d_h"] = 16
    return spec


CONFIGS = {
    "tiny-switch": _config("switch-base-8", "tiny-switch",
                           dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                                vocab_size=300), dict(num_experts=4, d_expert=128)),
    "tiny-deepseek": _config("deepseek-moe-16b-d8", "tiny-deepseek",
                             dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab_size=512),
                             dict(num_experts=8, top_k=3, d_expert=32, d_shared=32)),
}
BATCH = {"driver": "batch_serve", "batch": 4, "seq": 16, "tokens": {"kind": "uniform"},
         "batches_per_call": 3, "warmup_batches": 1, "eviction": "fifo", "staging_buffers": 2,
         "lookahead": 1}
TRAFFIC = {
    "tiny_sync": dict(BATCH, slots=2, prefetch_depth=0),
    "tiny_async": dict(BATCH, slots=3, prefetch_depth=2),
    "tiny_decode": {"driver": "decode", "lanes": 6, "steps": 12, "cache_len": 16, "history": 128,
                    "warmup_steps": 2, "tokens": {"kind": "uniform"}, "slots": 4,
                    "eviction": "fifo", "prefetch_depth": 0},
}
CELLS = {  # name: (config, traffic, kind of the manifest's cells it stands beside)
    "tiny.batch": ("tiny-switch", "tiny_sync", "switch8.batch"),
    "tiny.async": ("tiny-deepseek", "tiny_async", "switch8.batch"),
    "tiny.decode": ("tiny-switch", "tiny_decode", "switch8.decode"),
}
WORKLOADS = {
    "tiny.batch": {"check": {"calls": 2, "rows": 4}, "limits": dict(LIMITS, logit_err=0.05)},
    "tiny.async": {"check": {"calls": 2, "rows": 4}, "limits": dict(LIMITS, logit_err=0.05)},
    "tiny.decode": {"check": {"calls": 2, "lanes": 3}, "limits": dict(LIMITS, token_gap=0.01)},
}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Path:
    """`tmp` holding BENCHMARK.json and perfbench/, with the tiny cells added:
    new files, and new entries in the manifest's lists."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((tmp / "BENCHMARK.json").read_text())
    for name, spec in CONFIGS.items():
        write(tmp / "perfbench" / "configs" / f"{name}.json", spec)
        manifest["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                                    "file": f"perfbench/configs/{name}.json"})
    for name, traffic in TRAFFIC.items():
        write(tmp / "perfbench" / "traffic" / f"{name}.json", traffic)
    for name, (config, traffic, like) in CELLS.items():
        write(tmp / "perfbench" / "workloads" / f"{name}.json", WORKLOADS[name])
        manifest["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                      "chips": 1, "why": "test"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    write(tmp / "BENCHMARK.json", manifest)
    return tmp


def run(root: Path, cell: str, seed: int = 5, seconds: float = 0.3, trace: bool = False,
        hook: Optional[Callable] = None) -> Dict:
    c = harness.resolve(cell, root)
    return harness.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(), hook=hook)
