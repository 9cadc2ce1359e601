"""rtm_tpu_torch scene build vs rtm_tpu: every table bitwise equal.

The port's native SAH builder computes a plane's cost as both NumPy
builders do, so its tables are bitwise rtm_tpu's NumPy builder's
(test_torch_native_bvh.py); the JAX side here builds with that NumPy
builder, since rtm_tpu's own native builder orders tied SAH splits
differently on instanced copies such as dragon_grid(2).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu_torch.models import scenes as tscenes
from rtm_tpu_torch.models.scene import tracer_scene_from_numpy
from test_torch_parity import (TRI_FIELDS, host_scene, jax_scene,
                               jax_scene_arrays)

SCENES = [1, 2, 3, 4, 5, "grid2"]


def assert_scenes_equal(sj, st):
    """Bitwise comparison of a JAX TracerScene and a port TracerScene."""
    for f in dataclasses.fields(sj.materials):
        a = np.asarray(getattr(sj.materials, f.name))
        b = getattr(st.materials, f.name).cpu().numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for name in TRI_FIELDS:
        a = np.asarray(getattr(sj, name))
        b = getattr(st, name).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert st.any_textured == sj.any_textured
    assert st.env_sun == sj.env_sun
    assert tuple(map(tuple, st.cluster_slices)) == tuple(
        map(tuple, sj.cluster_slices))

    mj, mt = sj.mxu_meta, st.mxu_meta
    assert (mt.n_tris, mt.nc, mt.supported, mt.textured_rows) == (
        mj.n_tris, mj.nc, mj.supported, mj.textured_rows)
    ja, ta = sj.mxu_arrays, st.mxu_arrays
    np.testing.assert_array_equal(
        np.asarray(ja.pair).view(np.uint16),
        ta.pair.cpu().view(torch.int16).numpy().view(np.uint16))
    # the port's attr/info are the TPU tables without the sublane
    # replication: (A_ROWS, NC, 8, 128) -> (NC*128, A_ROWS)
    attr = np.asarray(ja.attr)
    assert (attr == attr[:, :, :1]).all()
    np.testing.assert_array_equal(
        attr[:, :, 0].reshape(attr.shape[0], -1).T, ta.attr.cpu().numpy())
    np.testing.assert_array_equal(
        np.asarray(ja.info)[:, 0].reshape(-1), ta.info.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(ja.cbox), ta.cbox.cpu().numpy())


@pytest.mark.parametrize("sid", SCENES)
def test_scene_tables_bitwise(sid):
    sj = jax_scene(sid)
    st = rtm_tpu_torch.build_tracer_scene(host_scene(tscenes, sid), device="cpu")
    assert st.device.type == "cpu"
    assert_scenes_equal(sj, st)


@pytest.mark.parametrize("sid", [2, 3])
def test_tracer_scene_from_numpy_carries_jax_scene(sid):
    """The JAX scene's leaves, carried across as NumPy arrays, give the
    port's own scene exactly (the pair table goes through its bf16 bits)."""
    sj = jax_scene(sid)
    arrays, meta = jax_scene_arrays(sj)
    st = tracer_scene_from_numpy(arrays, meta, "cpu")
    assert_scenes_equal(sj, st)
    own = rtm_tpu_torch.build_tracer_scene(host_scene(tscenes, sid), device="cpu")
    for f in ("pair", "attr", "info", "cbox"):
        assert torch.equal(getattr(st.mxu_arrays, f),
                           getattr(own.mxu_arrays, f)), f
    # the carried tensors own their memory
    wa = np.array(arrays["tri_wa"])
    arrays["tri_wa"] = wa
    st2 = tracer_scene_from_numpy(arrays, meta, "cpu")
    wa[...] = 0
    assert torch.equal(st2.tri_wa, st.tri_wa)


def test_build_mxu_tables_random_geometry():
    """build_mxu_tables on random triangles and materials, textured rows
    included: bitwise against rtm_tpu's."""
    from rtm_tpu.ops.pallas.mxu_kernel import build_mxu_tables as jbuild
    from rtm_tpu_torch.ops.kernels.mxu_kernel import build_mxu_tables

    rng = np.random.default_rng(5)
    t = 300
    va = rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    vb = (va + rng.uniform(-1, 1, (t, 3))).astype(np.float32)
    vc = (va + rng.uniform(-1, 1, (t, 3))).astype(np.float32)
    nsh = rng.normal(size=(t, 3)).astype(np.float32)
    mat = rng.integers(0, 4, t).astype(np.int32)
    tex_id = np.array([-1, 0, -1, -1], np.int32)
    args = (va, vb, vc, nsh, mat, tex_id, 4, 2)
    j, p = jbuild(*args), build_mxu_tables(*args)
    assert (p.meta.n_tris, p.meta.nc, p.meta.supported,
            p.meta.textured_rows) == tuple(j.meta)
    np.testing.assert_array_equal(
        np.asarray(j.arrays.pair).view(np.uint16),
        p.arrays.pair.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(
        np.asarray(j.arrays.info)[:, 0].reshape(-1), p.arrays.info.numpy())
    np.testing.assert_array_equal(np.asarray(j.arrays.cbox),
                                  p.arrays.cbox.numpy())


def test_build_mxu_tables_limits():
    """Past 2047 triangles the tables say unsupported, like rtm_tpu's."""
    from rtm_tpu_torch.ops.kernels.mxu_kernel import build_mxu_tables

    t = 2048
    v = np.zeros((t, 3), np.float32)
    tabs = build_mxu_tables(v, v, v, v, np.zeros(t, np.int32),
                            np.array([-1], np.int32), 1, 0)
    assert not tabs.meta.supported


def test_camera_spec_matches_jax():
    cams = [(rtm_tpu.Camera(), rtm_tpu_torch.Camera())]
    jc, tc = rtm_tpu.Camera(), rtm_tpu_torch.Camera()
    jc.move(forward=0.7, right=-0.3, up=0.2)
    tc.move(forward=0.7, right=-0.3, up=0.2)
    cams.append((jc, tc))
    for jc, tc in cams:
        a, b = jc.spec(48, 32), tc.spec(48, 32)
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f.name), np.float32),
                getattr(b, f.name).numpy(), err_msg=f.name)


def test_pack_camera_matches_jax():
    from rtm_tpu.ops.pallas.megakernel import _pack_camera as jpack
    from rtm_tpu_torch.ops.kernels.megakernel import _pack_camera

    a = np.asarray(jpack(rtm_tpu.Camera().spec(40, 24)))[0]
    b = _pack_camera(rtm_tpu_torch.Camera().spec(40, 24)).numpy()
    np.testing.assert_array_equal(a, b)


def test_slot_maps_match_jax():
    from rtm_tpu.ops.pallas import megakernel as jm
    from rtm_tpu_torch.ops.kernels import megakernel as tm

    w, h = 40, 24
    lin = np.arange(w * h)
    for a, b in zip(jm.slot_to_xy(jnp.asarray(lin), w),
                    tm.slot_to_xy(torch.from_numpy(lin), w)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jm.pixel_to_slot(jnp.asarray(lin), w)),
        tm.pixel_to_slot(torch.from_numpy(lin), w).numpy())
    img = np.random.default_rng(0).normal(size=(h, w, 3)).astype(np.float32)
    slots = tm.image_to_slots(torch.from_numpy(img), w, h)
    np.testing.assert_array_equal(
        np.asarray(jm.image_to_slots(jnp.asarray(img), w, h)), slots.numpy())
    np.testing.assert_array_equal(tm.slots_to_image(slots, w, h).numpy(),
                                  img)
    assert tm.use_block8(w, h) and not tm.use_block8(24, 20)
