"""The port's per-mesh BVH scene (`build_bvh_scene`), shader-parity
traversal (`bvh_traverse`, `bounce_ray_bvh`) and slab test (`aabb_hit`)
against rtm_tpu's, on tests/test_bvh.py's and tests/test_intersect.py's
cases and on scene 3's primary rays.

Tolerances: the BvhScene arrays bitwise (rtm_tpu side built with its
NumPy builder, which the port's builders match bitwise); traversal t
within 1e-6 (relative and absolute) and winning indices equal; aabb_hit
exact.  Against the port's dense sweep (`nearest_triangle`), as
tests/test_bvh.py holds rtm_tpu's: hits equal, t within 1e-5, indices
different only on exact t ties.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.accel import bvh as jbvh
from rtm_tpu.accel.native import bvh_native as j_native
from rtm_tpu.models import scenes as jscenes
from rtm_tpu.ops import bvh_traverse as jtrav
from rtm_tpu.ops.intersect import aabb_hit as j_aabb_hit
from rtm_tpu_torch.accel.bvh import build_bvh_scene
from rtm_tpu_torch.models import scenes as tscenes
from rtm_tpu_torch.ops import bvh_traverse as ttrav
from rtm_tpu_torch.ops.intersect import (FLT_MAX, TriFeatures, aabb_hit,
                                         nearest_triangle)
from test_torch_parity import host_scene

T_TOL = 1e-6


def _random_mesh(pkg, n=256, seed=2):
    rs = np.random.RandomState(seed)
    a = rs.rand(n, 3).astype(np.float32) * 10 - 5
    b = a + rs.randn(n, 3).astype(np.float32) * 0.5
    c = a + rs.randn(n, 3).astype(np.float32) * 0.5
    return pkg.Mesh(np.stack([a, b, c], axis=1), None)


def _case(pkg, name):
    """A host scene of either package: tests/test_bvh.py's random mesh,
    its instanced triangle (scaled 2x, moved to z = -3) or scene 3."""
    if name == "random":
        return pkg.Scene(meshes=[_random_mesh(pkg)],
                         objects=[pkg.MeshInstance(mesh_id=0)])
    if name == "instanced":
        mesh = pkg.Mesh.from_triangles([pkg.Triangle((-1, -1, 0),
                                                     (1, -1, 0), (0, 1, 0))])
        inst = pkg.MeshInstance(mesh_id=0,
                                position=np.array([0.0, 0.0, -3.0]),
                                scale=np.array([2.0, 2.0, 2.0]))
        return pkg.Scene(meshes=[mesh], objects=[inst])
    return host_scene(jscenes if pkg is rtm_tpu else tscenes, 3)


def _jax_bvh_scene(name):
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "build", lambda mesh: None)
    try:
        return jbvh.build_bvh_scene(_case(rtm_tpu, name))
    finally:
        mp.undo()


def _rays(name, n=128):
    if name == "scene3":
        # scene 3's primary rays at 16x16 (frame 1, both jitters)
        from rtm_tpu_torch.ops.trace_ref import camera_rays, pixel_grid
        cfg = rtm_tpu_torch.RenderConfig(width=16, height=16)
        x, y = pixel_grid(16, 16)
        o, d, _ = camera_rays(rtm_tpu_torch.Camera().spec(16, 16), cfg, x,
                              y, 1, 1)
        return o.numpy(), d.numpy()
    # tests/test_bvh.py's origins, aimed at points of the meshes' extent
    # (half of them through z = -3, where the instanced triangle lies)
    rs = np.random.RandomState(3)
    o = rs.randn(n, 3).astype(np.float32) * 8
    aim = rs.rand(n, 3).astype(np.float32) * 10 - 5
    aim[::2, 2] = -3.0
    d = aim - o
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["random", "instanced", "scene3"])
def test_build_bvh_scene_matches_rtm_tpu(name):
    got = build_bvh_scene(_case(rtm_tpu_torch, name))
    want = _jax_bvh_scene(name)
    for f in dataclasses.fields(want):
        if f.name == "stats":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert a.tobytes() == b.tobytes(), f.name
    assert [s.sah for s in got.stats] == [s.sah for s in want.stats]


@pytest.mark.parametrize("name", ["random", "instanced", "scene3"])
def test_bounce_ray_bvh_matches_rtm_tpu(name):
    bs = build_bvh_scene(_case(rtm_tpu_torch, name))
    k = max(s.leaf_tris_max for s in bs.stats)
    o, d = _rays(name)
    t, tri, inst = ttrav.bounce_ray_bvh(
        ttrav.BvhArrays.from_scene(bs, device="cpu"), torch.from_numpy(o),
        torch.from_numpy(d), max_leaf_tris=k)
    jt, jtri, jinst = jtrav.bounce_ray_bvh(
        jtrav.BvhArrays.from_scene(_jax_bvh_scene(name)), jnp.asarray(o),
        jnp.asarray(d), max_leaf_tris=k)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))
    np.testing.assert_array_equal(inst.numpy(), np.asarray(jinst))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=T_TOL,
                               atol=T_TOL)
    assert (tri >= 0).any()


def test_traversal_matches_dense_sweep():
    """tests/test_bvh.py test_traversal_matches_brute_force on the port."""
    bs = build_bvh_scene(_case(rtm_tpu_torch, "random"))
    arrays = ttrav.BvhArrays.from_scene(bs, device="cpu")
    o, d = (torch.from_numpy(a) for a in _rays("random"))
    k = max(s.leaf_tris_max for s in bs.stats)
    t_bvh, i_bvh = ttrav.bvh_traverse(arrays, 0, 0, o, d, max_leaf_tris=k)
    v = torch.from_numpy(bs.tri_verts)
    t_dense, i_dense = nearest_triangle(
        o, d, TriFeatures.build(v[:, 0], v[:, 1], v[:, 2]))
    hit = i_bvh >= 0
    assert torch.equal(hit, i_dense >= 0) and hit.any()
    torch.testing.assert_close(t_bvh[hit], t_dense[hit], rtol=1e-5,
                               atol=1e-5)
    differ = hit & (i_bvh != i_dense)
    torch.testing.assert_close(t_bvh[differ], t_dense[differ], rtol=0,
                               atol=0)
    jt, ji = jtrav.bvh_traverse(
        jtrav.BvhArrays.from_scene(_jax_bvh_scene("random")),
        jnp.uint32(0), jnp.uint32(0), jnp.asarray(o.numpy()),
        jnp.asarray(d.numpy()), max_leaf_tris=k)
    np.testing.assert_array_equal(i_bvh.numpy(), np.asarray(ji))
    np.testing.assert_allclose(t_bvh.numpy(), np.asarray(jt), rtol=T_TOL,
                               atol=T_TOL)


def test_instanced_traversal_world_units():
    bs = build_bvh_scene(_case(rtm_tpu_torch, "instanced"))
    t, tri, ii = ttrav.bounce_ray_bvh(
        ttrav.BvhArrays.from_scene(bs, device="cpu"),
        torch.tensor([[0.0, 0.0, 2.0]]), torch.tensor([[0.0, 0.0, -1.0]]),
        max_leaf_tris=1)
    assert int(tri[0]) == 0 and int(ii[0]) == 0
    assert abs(float(t[0]) - 5.0) <= 1e-5        # world distance


def test_bvh_arrays_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bs = build_bvh_scene(_case(rtm_tpu_torch, "instanced"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrav.BvhArrays.from_scene(bs)


AABB = {   # tests/test_intersect.py TestAabb: origin, direction, want
    "entry": ((0.0, 0, 5), (0.0, 0, -1), 4.0),
    "miss": ((5.0, 5, 5), (0.0, 0, 1), FLT_MAX),
    "inside": ((0.0, 0, 0), (0.0, 0, -1), -1.0),
}


@pytest.mark.parametrize("case", list(AABB))
def test_aabb_hit(case):
    o, d, want = AABB[case]
    lo, hi = (-1.0, -1, -1), (1.0, 1, 1)
    got = aabb_hit(*(torch.tensor(v, dtype=torch.float32)
                     for v in (o, d, lo, hi)))
    assert float(got) == pytest.approx(want, abs=1e-6)
    assert float(got) == float(j_aabb_hit(*(jnp.asarray(v, jnp.float32)
                                            for v in (o, d, lo, hi))))


def test_aabb_hit_batch_matches_rtm_tpu():
    """Rays against boxes broadcast (N,3) x (N,3), zero direction
    components included: bitwise rtm_tpu's, NaN where it gives NaN."""
    rs = np.random.RandomState(4)
    o = rs.randn(256, 3).astype(np.float32) * 3
    d = rs.randn(256, 3).astype(np.float32)
    d[::7, 1] = 0.0
    lo = rs.randn(256, 3).astype(np.float32)
    hi = lo + np.abs(rs.randn(256, 3)).astype(np.float32)
    got = aabb_hit(*(torch.from_numpy(a) for a in (o, d, lo, hi))).numpy()
    want = np.asarray(j_aabb_hit(*(jnp.asarray(a) for a in (o, d, lo, hi))))
    np.testing.assert_array_equal(got, want)
    assert (got < FLT_MAX).any() and (got == FLT_MAX).any()
