"""The final scene of "Ray Tracing in One Weekend" in the port
(`models/scenes.py` `one_weekend`) against the benchmark's configuration
of it (`benchmark/configs/rtiow1200.json`), on the CPU.

`one_weekend` gives the configuration's spheres, materials and sky bitwise,
through the same door the benchmark hands a scene to the port
(`benchmark/program.py` `port_scene`); `auto` takes the megakernel on it;
and the megakernel's plain version, through `ProgressiveRenderer` and
`render_dispatch` as the cell drives it, agrees with the benchmark's plain
reference under the cell's own limits with every sphere and all 50
bounces, cut to 48x27 and 2 samples, while the planted `half` fault
(benchmark/faults.py) reads not correct there.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, harness, program  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.reference import render as R  # noqa: E402
from benchmark.reference.scene import build_tables, describe  # noqa: E402
from rtm_tpu_torch import build_tracer_scene  # noqa: E402
from rtm_tpu_torch.models.scenes import (ONE_WEEKEND_BOUNCES,  # noqa: E402
                                         ONE_WEEKEND_SIZE, one_weekend,
                                         one_weekend_camera)
from rtm_tpu_torch.ops.trace_ref import resolve_route  # noqa: E402
from rtm_tpu_torch.runtime.renderer import ProgressiveRenderer  # noqa: E402

CONFIG = json.loads((ROOT / "benchmark" / "configs" / "rtiow1200.json")
                    .read_text())
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "rtiow1200.still4.json")
                    .read_text())
W, H, SPP = 48, 27, 2


@pytest.fixture(scope="module")
def desc():
    return describe(CONFIG)


@pytest.fixture(scope="module")
def scene(desc):
    return build_tracer_scene(program.port_scene(desc), device="cpu")


def test_one_weekend_is_the_configs_scene(desc):
    want = program.port_scene(desc)
    got = one_weekend(CONFIG["seed"])
    assert len(got.spheres) == CONFIG["counts"]["spheres"] == 487
    assert len(got.materials) == CONFIG["counts"]["materials"]

    def spheres(s):
        return (np.array([sp.position for sp in s.spheres], np.float64),
                np.array([sp.radius for sp in s.spheres], np.float64),
                [sp.material_id for sp in s.spheres])

    def materials(s):
        return np.array([np.hstack([m.albedo, m.emission_color,
                                    m.roughness, m.metallic,
                                    m.emission_power, m.refraction_ratio,
                                    m.texture_id]) for m in s.materials],
                        np.float64)

    for a, b in zip(spheres(got), spheres(want)):
        assert np.array_equal(a, b)
    assert np.array_equal(materials(got), materials(want))
    assert got.sky.dtype == want.sky.dtype
    assert np.array_equal(got.sky, want.sky)
    assert not got.meshes and not got.objects and not got.textures


def test_one_weekend_keeps_the_books_sizes_and_camera():
    r = CONFIG["render"]
    assert (r["width"], r["height"]) == ONE_WEEKEND_SIZE == (1200, 675)
    assert r["max_bounces"] == ONE_WEEKEND_BOUNCES == 50
    want = program.port_camera(CONFIG["camera"])
    got = one_weekend_camera()
    for f in dataclasses.fields(got):
        assert np.array_equal(getattr(got, f.name), getattr(want, f.name))
    assert np.array_equal(got.row(*ONE_WEEKEND_SIZE),
                          want.row(*ONE_WEEKEND_SIZE))


def test_auto_takes_the_megakernel(scene):
    rc = program.render_config(CONFIG["render"], 4)
    assert resolve_route(scene, rc, CONFIG["render"]["route"]) == \
        "megakernel"


def checked(scene, desc, fault: str) -> tuple[bool, dict]:
    """The cell's numbers over its first dispatch at W x H and SPP
    samples, `fault` planted, judged against the cell's limits."""
    rc = program.render_config(dict(desc.render, width=W, height=H), SPP)
    pr = ProgressiveRenderer(scene, camera=program.port_camera(desc.camera),
                             cfg=rc, backend=desc.render["route"])
    with faults.planted(fault, {}):
        first = pr.step_async().reshape(-1, 3).numpy()
    x = torch.arange(W * H)
    ref = R.trace_blocked(R.Scene(build_tables(desc), "cpu"), desc.camera,
                          W, H, x % W, x // W, torch.ones_like(x), SPP,
                          desc.render["max_bounces"],
                          desc.render["draw_environment"]).numpy()
    numbers = {"bad_pixel_share": compare.bad_pixels(first, ref) / (W * H),
               "accum_rel_gap": compare.rel_gap(
                   pr.accum.reshape(-1, 3).numpy(), ref)}
    return harness.judge(numbers, LIMITS["limits"])


@pytest.mark.parametrize("fault, correct", [("none", True),
                                            ("half", False)])
def test_the_megakernel_route_against_the_reference(scene, desc, fault,
                                                    correct):
    ok, checks = checked(scene, desc, fault)
    assert ok is correct, checks
