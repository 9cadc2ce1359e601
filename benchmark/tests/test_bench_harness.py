"""The harness on the CPU: the end-to-end arithmetic under an injected
clock, and a configuration, traffic mix and per-layer metric added as new
files that the harness finds by name."""
from __future__ import annotations

import hashlib
import json

import pytest

from bench_helpers import (StepClock, make_copy, run_cell,  # noqa: F401
                           small_root)

STEP = 0.01


def test_rate_is_all_the_work_over_all_the_window(small_root):
    res, ctx = run_cell(small_root, "cornell720.spp4", seconds=0.1,
                        clock=StepClock(STEP))
    r = ctx.desc.render
    n = ctx.work["dispatches"]
    # one clock reading per dispatch enqueued, the one that ends the loop
    # and one after the read-back
    assert ctx.work["window_s"] == pytest.approx((n + 2) * STEP)
    want = (r["width"] * r["height"] * ctx.traffic["spp"]
            * r["max_bounces"] * n / ctx.work["window_s"] / 1e9)
    assert res["metrics"]["grays_per_s"]["value"] == pytest.approx(want)
    assert res["attempted"] == n >= 8


def test_p95_is_over_every_frame(small_root):
    res, ctx = run_cell(small_root, "cornell512.interactive", seconds=0.5,
                        clock=StepClock(STEP))
    # every frame reads the clock at the move, around step_async and after
    # the copy to the host: 3 steps from the move to the image
    assert res["metrics"]["frame_ms_p95"]["value"] == pytest.approx(
        3 * STEP * 1e3)
    assert res["attempted"] == ctx.work["frames"] >= 8


def test_step_time_is_the_window_over_its_steps(small_root):
    res, ctx = run_cell(small_root, "cornell512.fit", seconds=0.05,
                        clock=StepClock(STEP))
    steps = ctx.work["steps"]
    assert ctx.work["window_s"] == pytest.approx(steps * STEP)
    assert res["metrics"]["fit_step_ms"]["value"] == pytest.approx(
        STEP * 1e3)
    assert res["attempted"] == steps >= 4


def test_setup_leaves_out_the_reference(small_root):
    """The fit cell's target is the reference's render in set-up; its
    seconds are not the program's and do not count in setup_s."""
    res, ctx = run_cell(small_root, "cornell512.fit", seconds=0.05,
                        clock=StepClock(STEP))
    ref = sum(ctx.spans["reference_target"])
    assert ref > 0 and ctx.split["reference_in_setup_s"] == ref
    assert res["metrics"]["setup_s"]["value"] == ctx.split["setup_s"]


SPHERES = {
    "name": "spheres", "source": "test", "reduced": [], "assumed": {},
    "render": {"width": 20, "height": 12, "max_bounces": 4,
               "draw_environment": True, "route": "auto"},
    "camera": {"fov": 45.0, "near": 0.1, "far": 1.0,
               "position": [0.0, 1.0, 5.0], "direction": [0.0, 0.0, -1.0],
               "focus_distance": 1.0, "defocus_strength": 0.0,
               "blur_strength": 0.0},
    "sky": {"kind": "gradient", "h": 8, "w": 16,
            "rgb": [[0.6, 0.4], [0.7, 0.2], [0.9, 0.1]]},
    "textures": [],
    "materials": [[[0.8, 0.6, 0.5], [1, 1, 1], 0.5, 0.5, 0, 1.0, -1],
                  [[1, 1, 1], [1, 1, 1], 0, 0, 4.0, 1.0, -1],
                  [[1, 1, 1], [1, 1, 1], 0.7, 0, 0, 1.5, -1]],
    "meshes": {"floor": {"triangles": [
        [[5, -1, 5], [5, -1, -5], [-5, -1, 5]],
        [[-5, -1, -5], [-5, -1, 5], [5, -1, -5]]]}},
    "instances": [{"mesh": "floor", "position": [0, 0, 0],
                   "scale": [1, 1, 1], "rotation": [0, 0, 0],
                   "material": 0}],
    "spheres": [{"position": [0, 0, -2], "radius": 1.0, "material": 2},
                {"position": [0, 4, -3], "radius": 1.0, "material": 1}],
}


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_are_new_files(tmp_path):
    root = make_copy(tmp_path)
    before = _digest(root)
    b = root / "benchmark"
    (b / "configs" / "spheres.json").write_text(json.dumps(SPHERES))
    (b / "traffic" / "spp2.json").write_text(json.dumps(
        {"loop": "progressive", "spp": 2, "warm_dispatches": 2,
         "camera_jitter": 0.05, "trace_seconds": 0.3}))
    (b / "limits" / "spheres.spp2.json").write_text(json.dumps(
        {"check_pixels": 8, "limits": {"bad_pixel_share": 0.001,
                                       "accum_rel_gap": 0.001}}))
    (b / "metrics" / "dispatches_traced.py").write_text(
        "def read(ctx):\n"
        "    tr = ctx.trace_data\n"
        "    return None if tr is None else tr.units\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(manifest))
    manifest["configs"].append({"name": "spheres", "source": "test",
                                "file": "benchmark/configs/spheres.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "spheres.spp2",
                                  "config": "spheres", "traffic": "spp2",
                                  "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "dispatches_traced",
                                  "unit": "dispatches", "better": "higher",
                                  "source": "program_counter",
                                  "layer": "driver loop",
                                  "moves": "setup_s",
                                  "workloads": ["spheres.spp2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    res, _ = run_cell(root, "spheres.spp2", seconds=0.3)
    assert res["correct"] and set(res["metrics"]) == {"setup_s", "peak_mib"}
    res, _ = run_cell(root, "spheres.spp2", seconds=0.3, trace=1)
    assert res["correct"]
    assert res["metrics"]["dispatches_traced"]["value"] >= 1
    assert "scene_build_s" in res["metrics"]

    after = _digest(root)
    changed = {k for k in before if after[k] != before[k]}
    assert changed == {"BENCHMARK.json"}
    for key in old:      # the manifest only gained entries
        if isinstance(old[key], list):
            assert manifest[key][:len(old[key])] == old[key]
