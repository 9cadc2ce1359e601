"""The port's native (C++/ctypes) SAH builder against its NumPy builder and
rtm_tpu's NumPy builder.

Bitwise, no tolerance: node boxes, regions, the triangle order and the
stats, on tests/test_native_bvh.py's meshes and on the world-space soups
the trav and cluster tables are built from (dragon_grid(2), (6), (11),
where rtm_tpu's own native builder picks tied planes differently).  A
failed compile raises; nothing falls back to the NumPy builder.
"""
from __future__ import annotations

import numpy as np
import pytest

import rtm_tpu_torch
from rtm_tpu.accel import bvh as jbvh
from rtm_tpu.models.mesh import Mesh as JMesh
from rtm_tpu_torch.accel import bvh as tbvh
from rtm_tpu_torch.accel.native import bvh_native
from rtm_tpu_torch.models import scenes as tscenes
from rtm_tpu_torch.models.mesh import Mesh as TMesh
from rtm_tpu_torch.models.scene import scene_diff

ARRAYS = ("box_min", "box_max", "buffer_region", "order")
STATS = ("tri_cnt", "node_cnt", "leaf_cnt", "leaf_depth_min",
         "leaf_depth_max", "leaf_depth_sum", "leaf_tris_min",
         "leaf_tris_max", "leaf_tris_sum", "sah")


def _verts(case):
    """(T,3,3) f32: tests/test_native_bvh.py's meshes, or a dragon grid's
    world soup in buffer order."""
    if case.startswith("grid"):
        st = rtm_tpu_torch.build_tracer_scene(
            tscenes.dragon_grid(int(case[4:])), order="buffer", device="cpu")
        return np.stack([st.tri_wa.numpy(), st.tri_wb.numpy(),
                         st.tri_wc.numpy()], axis=1)
    if case == "degenerate":
        return np.tile(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                                np.float32), (8, 1, 1))
    if case == "dragon":
        return tscenes._dragon_mesh().verts.astype(np.float32)
    n, seed = {"single": (1, 0), "small": (33, 1), "medium": (500, 2)}[case]
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 3)).astype(np.float32)


def _assert_bitwise(got, want):
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for f in STATS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f


CASES = ["single", "small", "medium", "degenerate", "dragon", "grid2",
         "grid6", "grid11"]


@pytest.mark.parametrize("case", CASES)
def test_native_matches_numpy_builder(case):
    verts = _verts(case)
    native = tbvh.build_bvh(TMesh(verts, None))
    _assert_bitwise(native, tbvh.build_bvh(TMesh(verts, None),
                                           use_native=False))
    native.stats.validate()


@pytest.mark.parametrize("case", ["medium", "grid2", "grid6", "grid11"])
def test_native_matches_rtm_tpu_numpy_builder(case):
    verts = _verts(case)
    _assert_bitwise(tbvh.build_bvh(TMesh(verts, None)),
                    jbvh._build_python(JMesh(verts, None)))


def test_native_and_numpy_scene_tables_equal():
    """build_tracer_scene's tables through either builder, bitwise."""
    host = tscenes.dragon_grid(6)
    a = rtm_tpu_torch.build_tracer_scene(host, device="cpu")
    b = rtm_tpu_torch.build_tracer_scene(host, device="cpu",
                                         use_native=False)
    assert a.num_triangles == 720 and len(a.cluster_slices) > 1
    assert scene_diff(a, b) == []


def test_compile_error_raises(tmp_path, monkeypatch):
    """A source g++ rejects raises with its output, through build_bvh too:
    no quiet fallback to the NumPy builder."""
    bad = tmp_path / "bvh.cpp"
    bad.write_text("int rtm_bvh_build( { not C++ }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        bvh_native.compile_library(bad, tmp_path)
    assert not list(tmp_path.glob("*.so")) and not list(
        tmp_path.glob("*.tmp"))
    monkeypatch.setattr(bvh_native, "SRC", bad)
    monkeypatch.setattr(bvh_native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="error"):
        tbvh.build_bvh(TMesh(_verts("small"), None))


def test_library_name_follows_the_source(tmp_path):
    """An edited source gets a library of its own (no stale load)."""
    src = tmp_path / "bvh.cpp"
    src.write_bytes(bvh_native.SRC.read_bytes())
    first = bvh_native.library_path(src, tmp_path)
    assert first == bvh_native.library_path(bvh_native.SRC, tmp_path)
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert bvh_native.library_path(src, tmp_path) != first


def test_concurrent_first_builds(tmp_path):
    """Several first uses at once (test workers) each compile to a name of
    their own and replace it into place: every one gets a whole library."""
    import ctypes
    import threading

    paths, errors = [], []

    def worker():
        try:
            paths.append(bvh_native.compile_library(bvh_native.SRC,
                                                    tmp_path))
        except RuntimeError as e:        # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and len(set(paths)) == 1 and len(paths) == 4
    assert not list(tmp_path.glob("*.tmp"))
    assert ctypes.CDLL(str(paths[0])).rtm_bvh_build
