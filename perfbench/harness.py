"""One run of one cell: load, warm up, measure, check, print.

Everything that belongs to one cell, configuration, traffic mix or metric is
a file of its own, found by the names in `BENCHMARK.json`:

- `configs/<config>.json` (the `file` the manifest names): the model's sizes
  as run, its source and cuts, the weights' seeds, and its plain reference
  (`reference/<reference>.py`);
- `traffic/<traffic>.json`: the traffic mix's parameters and the driver that
  serves it (`drivers/<driver>.py`);
- `workloads/<cell>.json`: what the cell's check samples and the limit of
  each number it compares;
- `metrics/<metric>.py`: one reader a metric, end to end or per layer, each
  `read(rec) -> float | None`; `kernels/<kernel>.py`: a kernel's operations
  and bytes, for its roofline.

A driver builds the program's engine from the configuration and traffic
(`setup`), serves for the run's seconds (`window`, which returns the run's
record), lets the program's state go (`release`), and compares what the
timed path produced with the plain reference (`check`).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from perfbench.spans import Spans

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_MODULES: Dict[str, object] = {}


def load_module(root: Path, kind: str, name: str):
    """`perfbench/<kind>/<name>.py`, loaded by its path (names may hold dots)."""
    path = root / "perfbench" / kind / f"{name}.py"
    key = str(path)
    if key not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path.relative_to(root)}")
        spec = importlib.util.spec_from_file_location(
            "perfbench_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    root: Path
    config: Dict
    traffic: Dict
    workload: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def driver(self):
        return load_module(self.root, "drivers", self.traffic["driver"])

    @property
    def reference(self):
        return load_module(self.root, "reference", self.config["reference"])


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json`, with its files."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name=name, chips=w["chips"], root=root, config=config,
                traffic=load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json"),
                workload=load_json(root / "perfbench" / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


@dataclass
class Ctx:
    """What a driver is handed: the cell, the run's seed and device, and the
    span recorder."""
    cell: Cell
    seed: int
    device: str
    spans: Spans = field(default_factory=Spans)


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def read_metrics(cell: Cell, rec: Dict, trace: bool) -> Dict[str, Dict]:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(cell.root, "metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, hook: Optional[Callable[[object], None]] = None) -> Dict:
    """Serve the cell for `seconds` and check it. Returns {"result": the
    result line's object, "checks": {name: (value, limit)}}. `hook(driver)`
    runs after set-up (the fault tests break the timed path there)."""
    drv = cell.driver.Driver(Ctx(cell=cell, seed=seed, device=device))
    drv.setup()
    if hook is not None:
        hook(drv)
    sync(device)
    setup_s = time.perf_counter() - t_start
    rec = drv.window(seconds, trace)
    rec["setup_s"] = setup_s
    drv.release()
    gc.collect()
    if device.startswith("cuda"):
        import torch

        torch.cuda.empty_cache()
    readings = drv.check(cell.reference, control=False)
    checks = {k: (readings[k], lim) for k, lim in cell.workload["limits"].items()}
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": read_metrics(cell, rec, trace), "device": dict(rec["device"])}
    if trace and rec.get("trace"):
        result["device"]["busy_s"] = rec["trace"]["busy_s"]
        result["device"]["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = rec["trace"]["breakdown"]
    # a reading that is not finite fails its limit and is written as null
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return {"result": result, "checks": checks}


def control_readings(cell: Cell, seeds: List[int], seconds: float, device: str) -> List[Dict]:
    """For each seed, in one process over one set-up: a short window at the
    cell's own load (at least the calls its check samples), then the check's
    readings of the program and of the control, the reference one precision
    step lower in the program's place, on the same sample. The readings the
    limits are set from."""
    drv = cell.driver.Driver(Ctx(cell=cell, seed=seeds[0], device=device))
    drv.setup()
    out = []
    for s in seeds:
        drv.reseed(s)
        drv.window(seconds, False)
        out.append({"seed": s, "program": drv.check(cell.reference, control=False),
                    "control": drv.check(cell.reference, control=True)})
    drv.release()
    return out


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control-seeds", default="",
                   help="comma-separated seeds: print the check's readings for the program "
                        "and for its control on each (one set-up), instead of a result")
    return p.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), this machine "
              f"has {n}", file=sys.stderr)
        return 2
    if args.control_seeds:
        seeds = [int(x) for x in args.control_seeds.split(",")]
        runs = control_readings(cell, seeds, args.seconds, "cuda")
        for r in runs:
            for side in ("program", "control"):
                print(f"seed {r['seed']} {side} " + " ".join(f"{k}={v!r}" for k, v in
                                                               r[side].items()), file=sys.stderr)
        print(json.dumps(runs))
        return 0
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}: the benchmark measures "
              "repro_torch without JAX or the JAX package", file=sys.stderr)
        return 3
    for k, (v, lim) in out["checks"].items():
        print(f"check {k}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(out["result"]))
    return 0
