"""Helpers and fixtures of the benchmark's tests.

The CPU tests drive the harness on the CPU (`harness.run(...,
device="cpu")`, the kernels' plain versions) in a temporary copy of the
benchmark whose scenes are cut to 24x16 pixels; the cells' limits files
are copied as they are.  Tests marked `cuda` need the card and skip here.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def make_copy(dest: Path, width: int = 24, height: int = 16,
              grid: int = 6) -> Path:
    """BENCHMARK.json and benchmark/ copied under `dest`, the scenes cut
    to width x height and the instance grids to grid x grid."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    for p in (dest / "benchmark" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["render"].update(width=width, height=height)
        for g in c.get("instance_grids", []):
            g["k"] = grid
        p.write_text(json.dumps(c))
    return dest


def config(name: str) -> dict:
    """A configuration file of the benchmark, as a dict."""
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


def grid_config(k: int) -> dict:
    """A mesh scene of many triangles for the tests of the reference's
    cluster cull and of the roofline count: cornell512's stand-in mesh
    instanced on a k x k grid (20 k^2 triangles) under an emissive
    sphere, at cornell512's camera and sky."""
    c = config("cornell512")
    c.update(name=f"grid{k}", reduced=[], assumed={}, textures=[],
             instances=[], meshes={"dragon": c["meshes"]["dragon"]},
             materials=[[[0.9, 0.9, 0.9], [1, 1, 1], 0.0, 0.0, 0, 1.0, -1],
                        [[1, 1, 1], [1.0, 0.9, 0.8], 0, 0, 3.0, 1.0, -1]],
             instance_grids=[{"mesh": "dragon", "k": k, "pitch": 2.5,
                              "y": 0.0, "z0": -4.0, "scale": [5.0] * 3,
                              "rot_step_deg": 30.0, "material": 0}],
             spheres=[{"position": [0.0, 6.0, -7.0], "radius": 1.5,
                       "material": 1}])
    return c


def run_cell(root: Path, workload: str, seed: int = 2**31 + 11,
             seconds: float = 1, trace: int = 0, mode: str = "none",
             clock=time.perf_counter):
    """One harness run of `workload` on the CPU with `mode` planted
    (benchmark/faults.py): (the result line's object, the run's
    Context)."""
    from benchmark import faults, harness

    holder = {}
    args = types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=trace)
    with faults.planted(mode, holder):
        res = harness.run(args, clock(), root, device="cpu",
                          on_context=lambda c: holder.update(ctx=c),
                          clock=clock)
    return res, holder["ctx"]


class StepClock:
    """A host clock that moves on by `step` seconds at every reading."""

    def __init__(self, step: float):
        self.step, self.now = step, 1000.0

    def __call__(self) -> float:
        self.now += self.step
        return self.now


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A copy of the benchmark cut to 24x16 pixels, per test module."""
    return make_copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda():
    """The card, or the test skips."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
