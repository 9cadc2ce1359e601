"""The roofline count: the work of a cell whatever implements it."""
from __future__ import annotations

import pytest

from bench_helpers import config, grid_config
from benchmark import roofline
from benchmark.reference.scene import build_tables, describe


def tables(name):
    return build_tables(describe(
        grid_config(int(name[4:])) if name.startswith("grid")
        else config(name)))


def test_small_count_by_hand():
    t = tables("cornell512")
    b = roofline.dispatch_bound(t, 4, 2, 3, 5)
    texels = 64 * 64 + 64 * 128
    want_bytes = (34 * 10 * 4 + t.mat.size * 4 + texels * 12
                  + roofline.CAMERA_ROW_BYTES + 4 * 2 * 12)
    assert b["bytes"] == want_bytes
    assert b["ops"] == 4 * 2 * 3 * 5 * roofline.RAY_TRIANGLE_OPS
    assert b["bound_s"] == max(b["bytes_s"], b["ops_s"])
    assert b["binds"] == "bytes"


@pytest.mark.parametrize("name", ["cornell512", "cornell720", "grid56"])
def test_cells_are_bound_by_operations(name):
    b = roofline.dispatch_bound(tables(name), 512, 512, 4, 8)
    assert b["binds"] == "operations"
    assert b["ops_s"] == pytest.approx(512 * 512 * 4 * 8 * 45 / 67e12)


def test_count_does_not_depend_on_the_triangles_tested():
    """More triangles add bytes read once, never operations."""
    small = roofline.dispatch_bound(tables("cornell512"), 64, 64, 1, 8)
    big = roofline.dispatch_bound(tables("grid12"), 64, 64, 1, 8)
    assert small["ops"] == big["ops"] and big["bytes"] > small["bytes"]
