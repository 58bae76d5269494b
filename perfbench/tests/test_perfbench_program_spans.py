"""The program's own spans (`repro_torch`'s `Telemetry.span`) beside the
harness's device trace, on the CPU at tiny sizes: they carry the clock the
trace's events carry, so once merged with the harness's spans they name the
trace's idle gaps, and they leave what the run serves and checks as it was."""
import pytest

from perfbench.spans import Spans
from perfbench.tests import tiny
from repro_torch.serving.telemetry import Telemetry

PROGRAM = ("hash.", "infer.", "transfer.", "prefetch.", "store.", "decode.")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


class Merged(Spans):
    """The harness's spans and the program's, as one list."""

    def __init__(self, harness: Spans, telemetry: Telemetry):
        self.harness, self.telemetry = harness, telemetry

    @property
    def items(self):
        return self.harness.items + [s[:4] for s in self.telemetry.spans]


def record_program_spans(tel: Telemetry):
    """A set-up hook: the engine, its store and its pipeline record into
    `tel` from the window on, and the trace labels gaps with both lists."""

    def hook(drv):
        for obj in (drv.eng, drv.eng.store, drv.eng.prefetcher):
            if obj is not None:
                obj.telemetry = tel
        drv.ctx.spans = Merged(drv.ctx.spans, tel)

    return hook


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_spans_name_the_idle_gaps(root, cell):
    tel = Telemetry(record_spans=True)
    res = tiny.run(root, cell, trace=True, hook=record_program_spans(tel))["result"]
    assert res["correct"]
    prefix = "decode." if cell.endswith("decode") else "hash."
    assert any(s.name.startswith(prefix) for s in tel.spans)
    named = [part for label, _ in res["breakdown"]["idle_gaps"] for part in label.split("+")]
    assert any(part.startswith(PROGRAM) for part in named), named
