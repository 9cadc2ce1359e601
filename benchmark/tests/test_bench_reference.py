"""The plain reference against the program on a tiny scene on the CPU:
bitwise the program's XLA-style route (whose arithmetic it copies), and
off on few pixels from the route the cell takes (the kernels' plain
versions here).  Its cluster cull finds the full sweep's hits."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_helpers import config, grid_config
from benchmark import program
from benchmark.reference import compare
from benchmark.reference import render as R
from benchmark.reference.scene import build_tables, describe


def setup(name, w=32, h=24):
    """cornell512, or gridK (grid_config(K))."""
    cfg = (grid_config(int(name[4:])) if name.startswith("grid")
           else config(name))
    desc = describe(cfg)
    return desc, build_tables(desc), w, h


def program_image(desc, w, h, spp, fi, backend):
    from rtm_tpu_torch import build_tracer_scene, render_dispatch

    ts = build_tracer_scene(program.port_scene(desc), device="cpu")
    rc = program.render_config(dict(desc.render, width=w, height=h), spp)
    cam = program.port_camera(desc.camera).spec(w, h)
    return render_dispatch(ts, cam, fi, rc, backend=backend).numpy()


def reference_image(desc, tables, w, h, spp, fi):
    sc = R.Scene(tables, "cpu")
    x = torch.arange(w * h)
    return R.trace(sc, desc.camera, w, h, x % w, x // w,
                   torch.full_like(x, fi), spp, desc.render["max_bounces"],
                   desc.render["draw_environment"]).numpy()


@pytest.mark.parametrize("name", ["cornell512", "grid6"])
def test_reference_is_bitwise_the_xla_route(name):
    desc, t, w, h = setup(name)
    got = program_image(desc, w, h, 2, 3, "xla").reshape(-1, 3)
    want = reference_image(desc, t, w, h, 2, 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["cornell512", "grid12"])
def test_reference_agrees_with_the_cells_route(name):
    desc, t, w, h = setup(name)
    got = program_image(desc, w, h, 2, 5, "auto").reshape(-1, 3)
    want = reference_image(desc, t, w, h, 2, 5)
    assert compare.bad_pixels(got, want) <= 0.01 * w * h


def test_cluster_cull_finds_the_sweeps_hits():
    desc, t, w, h = setup("grid12")
    sc = R.Scene(t, "cpu")
    assert sc.clusters is not None
    g = torch.Generator().manual_seed(5)
    o = torch.rand((4096, 3), generator=g) * torch.tensor([30.0, 3, 30]) \
        - torch.tensor([15.0, 0, 30])
    d = R.normalize(torch.randn((4096, 3), generator=g))
    t_cull, i_cull = R._nearest_culled(sc, o, d)
    t_all, i_all = R._nearest_sweep(sc, o, d)
    assert (i_all >= 0).sum() > 100
    assert torch.equal(i_cull, i_all) and torch.equal(t_cull, t_all)
