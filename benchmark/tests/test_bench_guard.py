"""The import guard: JAX and the JAX package by whole top-level name; a
CPU run of the harness loads neither, and the reference loads nothing of
the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from bench_helpers import ROOT, small_root  # noqa: F401 (a fixture)
from benchmark import guard


def test_whole_top_level_names():
    mods = ["rtm_tpu_torch", "rtm_tpu_torch.ops", "rtm_tpu_torchx", "jaxx",
            "numpy", "flaxen"]
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods + ["rtm_tpu.ops", "jax.numpy",
                                           "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "rtm_tpu.ops"]


def _run(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout


def test_reference_loads_nothing_of_the_program():
    out = _run(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.render, benchmark.reference.scene\n"
        "import benchmark.reference.compare\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    tops = eval(out)
    assert "rtm_tpu_torch" not in tops and "rtm_tpu" not in tops
    assert "jax" not in tops
    for p in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not any(guard.top_level(n or "").startswith("rtm_tpu")
                               for n in names), (p, names)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    out = _run(
        "import sys, json; sys.path.insert(0, '.')\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from pathlib import Path\n"
        "from bench_helpers import make_copy, run_cell\n"
        f"root = make_copy(Path({str(tmp_path)!r}))\n"
        "res, _ = run_cell(root, 'cornell720.spp4', seconds=0.3)\n"
        "from benchmark import guard\n"
        "print(json.dumps([res['correct'], guard.forbidden_modules()]))\n")
    assert out.strip().splitlines()[-1] == "[true, []]"


def test_the_guard_refuses_a_run_with_jax_loaded(small_root, monkeypatch):
    import types

    import pytest

    from benchmark import harness
    from bench_helpers import run_cell

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.Refused, match="jax"):
        run_cell(small_root, "cornell512.interactive", seconds=0.2)
