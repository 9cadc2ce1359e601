"""rtm_tpu_torch's trav path against rtm_tpu's trav kernel in Pallas
interpret mode, image against image and traversal work against traversal
work.

rtm_tpu's side is `render_rays_trav(..., interpret=True, with_stats=True)`
followed by its slot map: exactly what `render_dispatch(backend=
"trav_interpret")` runs (`render_trav`), with the per-tile stats kept.
The port's side goes through its entry point `render_dispatch` (backend
"auto" on dragon_grid(11), which auto resolves to trav, and "trav" on
scenes 1, 3 and 4), on a CPU scene, where the wrapper runs the kernel's
plain version.

Tolerances.  Images pass `images_close` (tests/conftest.py) at its
defaults.  rtm_tpu orders candidate hits with an approximate reciprocal
(bf16 in interpret mode), the port with an IEEE division, so a ray between
two triangles within 2^-8 of each other in t may take the other one; none
did at these sizes, and the image criteria absorb such paths.  The
per-1024-slot-tile sums of triangle tests (rtm_tpu's third stats entry,
the per-lane useful leaf k-steps) agree within 1%: a flipped winner prunes
a different set of boxes.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.ops.pallas import trav_kernel as jtk
from rtm_tpu.ops.pallas.megakernel import slots_to_image as j_slots_to_image
from rtm_tpu_torch.models import scenes as tscenes
from rtm_tpu_torch.ops.kernels import trav_kernel as ttk
from rtm_tpu_torch.ops.trace_ref import auto_backend
from test_torch_parity import host_scene, jax_scene

TILE = 1024                  # rtm_tpu's ray tile: its stats granule
STATS_RTOL = 0.01

# name: (scene, width, height, bounces, samples per dispatch, frame_index,
#        the port's backend)
CASES = {
    "grid11_auto": ("grid11", 32, 32, 4, 1, 1, "auto"),
    "scene1_spheres": (1, 32, 32, 4, 1, 1, "trav"),
    "scene3_textured": (3, 32, 32, 4, 1, 1, "trav"),
    "scene4_2spp": (4, 32, 32, 3, 2, 3, "trav"),
}


@pytest.fixture(scope="module")
def runs():
    """Both packages' image and per-tile triangle-test sums per case,
    computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            sid, w, h, bounces, spp, fi, backend = CASES[name]
            kw = dict(width=w, height=h, max_bounces=bounces,
                      max_frames=spp, draw_environment=True)
            sj = jax_scene(sid)
            out, jstats = jtk.render_rays_trav(
                sj, rtm_tpu.Camera().spec(w, h), jnp.uint32(fi),
                rtm_tpu.RenderConfig(**kw), pixel_offset=jnp.int32(0),
                n_rays=w * h, interpret=True, with_stats=True)
            want = np.asarray(j_slots_to_image(out, w, h))
            st = rtm_tpu_torch.build_tracer_scene(host_scene(tscenes, sid),
                                                  device="cpu")
            cfg = rtm_tpu_torch.RenderConfig(**kw)
            cam = rtm_tpu_torch.Camera().spec(w, h)
            before = ttk.trav_trace.launches
            got = rtm_tpu_torch.render_dispatch(st, cam, fi, cfg,
                                                backend=backend)
            _, tstats = ttk.render_rays_trav(st, cam, fi, cfg, 0, w * h,
                                             with_stats=True)
            assert ttk.trav_trace.launches == before   # CPU: plain version
            cache[name] = dict(
                scene=st, want=want, got=got,
                jtests=np.asarray(jstats[2]),
                ttests=tstats[1].reshape(-1, TILE).sum(1).numpy())
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_trav_render_matches_trav_interpret(runs, name, image_compare):
    r = runs(name)
    sid, w, h, *_, backend = CASES[name]
    if backend == "auto":
        assert r["scene"].num_triangles > 2047
        assert auto_backend(r["scene"], "cpu") == "trav"
    got = r["got"]
    assert got.device.type == "cpu" and got.shape == (h, w, 3)
    assert torch.isfinite(got).all() and float(got.mean()) > 0.0
    image_compare(got.numpy(), r["want"])


@pytest.mark.parametrize("name", list(CASES))
def test_trav_tile_triangle_tests_match(runs, name):
    r = runs(name)
    want, got = r["jtests"], r["ttests"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=STATS_RTOL)
    if r["scene"].trav_meta.n_nodes:
        assert got.sum() > 0
    else:
        assert got.sum() == 0                   # spheres only: no descent
