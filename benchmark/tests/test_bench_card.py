"""On the card: one short run of each cell through BENCHMARK.json's
command.  Marked `cuda`; skips without a card.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_card.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_helpers import ROOT, cuda  # noqa: F401 (a fixture)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ["cornell720.spp4", "cornell512.fit",
                                      "cornell512.interactive"])
def test_cell_runs_correct_on_the_card(cuda, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
