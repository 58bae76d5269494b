"""On the card, at each cell's own size: the control, the reference one
precision step below the configuration's in the program's place, fails one
of the cell's limits on every seed, and the program passes them all (run:
`PYTHONPATH=src python -m pytest -m gpu perfbench/tests`)."""
import json

import pytest

from perfbench import harness
from perfbench.tests.tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at full size on the card")
    c = harness.resolve(cell)
    limits = c.workload["limits"]
    for r in harness.control_readings(c, [101, 2147483647, 3000000001], 1.0, "cuda"):
        assert all(r["program"][k] <= lim for k, lim in limits.items()), r
        assert any(r["control"][k] > lim for k, lim in limits.items()), r
