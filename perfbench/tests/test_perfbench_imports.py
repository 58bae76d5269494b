"""What the benchmark loads: nothing of JAX or of the JAX package `repro` in
anything a run loads (top-level names compared whole: `repro_torch` is not
`repro`), and nothing of the program in the reference."""
import ast
import json
import os
import subprocess
import sys

from perfbench.harness import FORBIDDEN
from perfbench.tests.tiny import ROOT

ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=ENV,
                          timeout=600, cwd=ROOT)


def _top_levels(code: str):
    out = _python(code + "\nimport sys, json\n"
                  "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    names = _top_levels(
        "from pathlib import Path\n"
        "from perfbench.tests import tiny\n"
        f"root = tiny.make_root(Path({str(tmp_path)!r}))\n"
        "for cell in sorted(tiny.CELLS):\n"
        "    assert tiny.run(root, cell, trace=True)['result']['correct']\n")
    assert "repro_torch" in names and "perfbench" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_levels("import perfbench.reference.moe_transformer, perfbench.reference.routing")
    assert not names & {"repro_torch", *FORBIDDEN}


def test_the_reference_imports_only_torch_numpy_and_itself():
    allowed = {"torch", "numpy", "math", "contextlib", "typing", "__future__", "perfbench"}
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in allowed, (path.name, mod)
                if mod.startswith("perfbench"):
                    assert mod.startswith("perfbench.reference"), (path.name, mod)


def test_run_refuses_without_a_card():
    """Here, with no CUDA device: a non-zero exit and no result."""
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "switch8.batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
