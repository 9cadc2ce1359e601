"""rtm_tpu_torch's traversal structure, trav tables and plain batched
traversal against rtm_tpu's.

  * `accel.trav.build_trav` gives a bitwise-equal TravBVH (boxes, skip
    links, leaf ids, triangle order, slices), with and without `merge`;
  * `build_trav_tables` gives rtm_tpu's TravMeta, and its node and triangle
    tables equal rtm_tpu's after `trav_arrays_from_tpu`; `_pack_box_bf16`
    (bit arithmetic, no ml_dtypes) is bitwise equal to rtm_tpu's;
  * the plain batched traversal `trav_nearest_plain` agrees with rtm_tpu's
    one-ray NumPy `traverse_ref` on 4096 random rays into dragon_grid(11):
    the winner on >= 99.9% of rays, t within 1e-5 relative on those.
    traverse_ref prunes with the tight f32 boxes and computes in float64;
    the port prunes with the looser bf16-pair boxes (which only adds
    visits) and computes in f32, so only a ray through a near-tie of two
    triangles may pick the other one;
  * a scene carried from rtm_tpu with its trav leaves renders the same
    image as the port's own build.

The JAX scenes are built with rtm_tpu's NumPy BVH builder
(test_torch_parity.jax_scene), the one the port keeps.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import rtm_tpu_torch
from rtm_tpu.accel import trav as jtrav
from rtm_tpu.accel.native import bvh_native
from rtm_tpu.ops.pallas import trav_kernel as jtk
from rtm_tpu_torch.accel import trav as ttrav
from rtm_tpu_torch.models import scenes as tscenes
from rtm_tpu_torch.ops.kernels import trav_kernel as ttk
from test_torch_parity import carry, host_scene, jax_scene

SCENES = [3, "grid2", "grid11"]
RAYS = 4096
WIN_AGREE_MIN = 0.999
T_RTOL = 1e-5


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene on the CPU) per scene id, built once."""
    cache = {}

    def get(sid):
        if sid not in cache:
            cache[sid] = (jax_scene(sid), rtm_tpu_torch.build_tracer_scene(
                host_scene(tscenes, sid), device="cpu"))
        return cache[sid]

    return get


def _verts(st):
    return np.stack([st.tri_wa.numpy(), st.tri_wb.numpy(),
                     st.tri_wc.numpy()], axis=1)


def _jax_build_trav(verts, **kw):
    mp = pytest.MonkeyPatch()
    mp.setattr(bvh_native, "build", lambda mesh: None)
    try:
        return jtrav.build_trav(verts, **kw)
    finally:
        mp.undo()


def _soup(sid):
    """World-space triangles (T,3,3) f32 of a scene in buffer order, or a
    seeded random soup with coordinates rounded to integers (tied
    centroids, signed zeros)."""
    if sid == "random":
        rng = np.random.default_rng(5)
        return np.round(rng.standard_normal((1500, 3, 3)) * 2.0).astype(
            np.float32)
    return _verts(rtm_tpu_torch.build_tracer_scene(
        host_scene(tscenes, sid), order="buffer", device="cpu"))


@pytest.mark.parametrize("sid", [3, "grid2", "grid8", "random"])
def test_build_bvh_matches_rtm_tpu_numpy_builder(sid):
    """The port's vectorized SAH builder against rtm_tpu's per-triangle
    NumPy loops: nodes, boxes (bitwise, signed zeros included), regions,
    triangle order and the SAH sum."""
    from rtm_tpu.accel import bvh as jbvh
    from rtm_tpu.models.mesh import Mesh as JMesh
    from rtm_tpu_torch.accel import bvh as tbvh
    from rtm_tpu_torch.models.mesh import Mesh as TMesh

    verts = _soup(sid)
    got = tbvh.build_bvh(TMesh(verts, None), use_native=False)
    want = jbvh._build_python(JMesh(verts, None))
    for f in ("box_min", "box_max", "buffer_region", "order"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert got.stats.sah == want.stats.sah
    assert got.num_nodes > 1


@pytest.mark.parametrize("sid", ["grid8", "random"])
def test_rebuild_on_bvh_order_is_identity(sid):
    """build_tracer_scene reuses the cluster cut's hierarchy for the trav
    tables: rebuilt over the triangles in that hierarchy's order, the
    builder gives the same nodes and the identity order."""
    from rtm_tpu_torch.accel.bvh import build_bvh
    from rtm_tpu_torch.models.mesh import Mesh as TMesh

    verts = _soup(sid)
    first = build_bvh(TMesh(verts, None))
    again = build_bvh(TMesh(verts[first.order], None))
    np.testing.assert_array_equal(again.order, np.arange(len(verts)))
    np.testing.assert_array_equal(again.buffer_region, first.buffer_region)
    np.testing.assert_array_equal(again.box_min, first.box_min)
    np.testing.assert_array_equal(again.box_max, first.box_max)


@pytest.mark.parametrize("sid,merge", [(3, False), ("grid2", False),
                                       ("grid11", False), ("grid2", True)])
def test_build_trav_bitwise(scenes, sid, merge):
    _, st = scenes(sid)
    verts = _verts(st)
    k = st.trav_meta.leaf_k
    want = _jax_build_trav(verts, max_leaf_tris=k, merge=merge)
    got = ttrav.build_trav(verts, max_leaf_tris=k, merge=merge)
    for f in ("lo", "hi", "skip", "leaf_id", "order"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.slices == want.slices
    assert got.num_nodes > 1 and got.num_leaves > 1


@pytest.mark.parametrize("sid", SCENES)
def test_trav_tables_equal_rtm_tpu(scenes, sid):
    sj, st = scenes(sid)
    assert st.trav_meta == tuple(sj.trav_meta)
    assert st.trav_meta.supported and st.trav_meta.n_nodes > 0
    carried = carry(sj).trav_arrays
    for f in ("node", "tri_feat", "tri_info"):
        a, b = getattr(st.trav_arrays, f), getattr(carried, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    tm = st.trav_meta
    assert st.trav_arrays.node.shape == (tm.n_nodes, 4)
    assert st.trav_arrays.tri_feat.shape == (tm.n_leaves * tm.leaf_k,
                                             ttk.TF_ROWS)


def test_pack_box_bf16_bitwise():
    """Random boxes plus signed zeros, tiny, subnormal and near-overflow
    bounds: the port's round-to-nearest-even bit arithmetic against
    rtm_tpu's ml_dtypes rounding."""
    rng = np.random.default_rng(7)
    lo = (rng.standard_normal((3, 4000))
          * 10.0 ** rng.uniform(-6, 6, (3, 4000))).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-38, -1e-38, 1e-40, -1e-40, 3e-45,
                        1.0, -1.0, 65504.0, 1e38, -1e38], np.float32)
    lo[:, :len(special)] = special
    hi = lo + np.abs(rng.standard_normal((3, 4000))).astype(np.float32)
    hi[:, :len(special)] = special
    box = np.concatenate([lo, hi])
    got = ttk._pack_box_bf16(box)
    want = jtk._pack_box_bf16(box)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def grid11_rays(scenes):
    """4096 rays from a seed: origins in a slab in front of and above the
    grid, aimed at points inside its bounds (most hit a dragon)."""
    _, st = scenes("grid11")
    v = _verts(st).reshape(-1, 3)
    lo, hi = v.min(axis=0), v.max(axis=0)
    rng = np.random.default_rng(11)
    tgt = lo + rng.uniform(0.0, 1.0, (RAYS, 3)) * (hi - lo)
    org = np.stack([rng.uniform(lo[0] - 5, hi[0] + 5, RAYS),
                    rng.uniform(hi[1] + 1, hi[1] + 15, RAYS),
                    rng.uniform(hi[2], hi[2] + 20, RAYS)], axis=1)
    d = tgt - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def test_plain_traversal_matches_traverse_ref(scenes, grid11_rays):
    _, st = scenes("grid11")
    tm = st.trav_meta
    org, d = grid11_rays
    verts = _verts(st)
    jt = _jax_build_trav(verts, max_leaf_tris=tm.leaf_k)
    vb = verts[jt.order]
    ref = [jtrav.traverse_ref(jt, vb, org[i].astype(np.float64),
                              d[i].astype(np.float64)) for i in range(RAYS)]
    ref_t = np.array([r[0] for r in ref])
    ref_i = np.array([r[1] for r in ref])

    o = torch.from_numpy(org)
    dd = torch.from_numpy(d)
    got, t, row, visits, tests = ttk.trav_nearest_plain(
        st.trav_arrays, tm, o[:, 0], o[:, 1], o[:, 2], dd[:, 0], dd[:, 1],
        dd[:, 2], torch.full((RAYS,), ttk.BIG),
        torch.ones(RAYS, dtype=torch.bool))
    # tri_feat row leaf*K + k -> BVH-order triangle slices[leaf][0] + k
    start = np.array([s for s, _ in jt.slices])
    row = row.numpy()
    idx = np.where(got.numpy(), start[row // tm.leaf_k] + row % tm.leaf_k,
                   -1)
    assert (ref_i >= 0).mean() > 0.5             # most rays hit a dragon
    same = idx == ref_i
    assert same.mean() >= WIN_AGREE_MIN, same.mean()
    hit = same & (ref_i >= 0)
    np.testing.assert_allclose(t.numpy()[hit], ref_t[hit], rtol=T_RTOL)
    # the bf16-pair boxes contain the tight ones: never fewer node visits
    ref_nodes = np.array([r[3] for r in ref])
    assert (visits.numpy()[same] >= ref_nodes[same]).all()
    assert int(tests.sum()) > 0


def test_carried_scene_renders_like_port_build(scenes):
    """tracer_scene_from_numpy with rtm_tpu's trav leaves renders the same
    trav image as build_tracer_scene."""
    sj, st = scenes("grid2")
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(16, 16)
    want = rtm_tpu_torch.render_dispatch(st, cam, 2, cfg, backend="trav")
    got = rtm_tpu_torch.render_dispatch(carry(sj), cam, 2, cfg,
                                        backend="trav")
    assert torch.isfinite(got).all() and float(got.mean()) > 0.0
    assert torch.equal(got, want)


# The trav kernel's warp-cooperative leaf test (csrc/trav_trace.cu
# drain_leaf) as a plain model, held against the serial strict loop that
# defines the leaf test (rows in order, strict <: rtm_tpu's kernel and the
# plain version), over the outcome of each row's test: `ok` the min-chain
# gate, `t` the quotient.  Bitwise: the same t bits (so -0.0 against 0.0
# counts) and the same winning row.
NO_ROW = 0x7FFFFFFF


def _serial_leaf(t, ok, best):
    """Rows in order, a row replaces the best only when strictly below."""
    win = -1
    for k in range(len(t)):
        if ok[k] and t[k] < best:
            best, win = t[k], k
    return best, win


def _warp_leaf(t, ok, best):
    """Lane j keeps its first strict minimum below the owner's best over
    rows j, j + 32, ...; the xor butterfly keeps the least t, the lower row
    on equal t; the owner takes it only when strictly below its best."""
    tl, kl = [best] * 32, [NO_ROW] * 32
    for j in range(32):
        for k in range(j, len(t), 32):
            if ok[k] and t[k] < tl[j]:
                tl[j], kl[j] = t[k], k
    for m in (16, 8, 4, 2, 1):
        nt, nk = list(tl), list(kl)
        for j in range(32):
            t2, k2 = tl[j ^ m], kl[j ^ m]
            if t2 < tl[j] or (t2 == tl[j] and k2 < kl[j]):
                nt[j], nk[j] = t2, k2
        tl, kl = nt, nk
    assert len({(float(x).hex(), k) for x, k in zip(tl, kl)}) == 1
    return (tl[0], kl[0]) if tl[0] < best else (best, -1)


def _leaf_rows(kind, cnt, rng):
    """(t, ok) of one leaf's rows: uniform t, t from a few values (ties,
    signed zeros, the sphere's t), or with inf, NaN and huge t."""
    f32 = np.float32
    if kind == "random":
        t = rng.uniform(0.0, 10.0, cnt).astype(f32)
    elif kind == "ties":
        t = rng.choice(np.array([0.0, -0.0, 0.5, 1.0, 2.0], f32), cnt)
    else:
        t = rng.choice(np.array([np.inf, np.nan, 1e30, 3.0e38, 0.25, 1.0],
                                f32), cnt)
    return t, rng.random(cnt) < 0.7


@pytest.mark.parametrize("cnt", [1, 31, 32, 33, 100, 256])
@pytest.mark.parametrize("kind", ["random", "ties", "inf_nan"])
def test_warp_leaf_reduction_equals_serial_loop(kind, cnt):
    rng = np.random.default_rng(cnt * 7 + len(kind))
    for _ in range(40):
        t, ok = _leaf_rows(kind, cnt, rng)
        for best in np.array([1e30, 1.0, 0.0, -0.0], np.float32):
            sb, sw = _serial_leaf(t, ok, best)
            wb, ww = _warp_leaf(t, ok, best)
            assert sw == ww
            assert np.float32(sb).tobytes() == np.float32(wb).tobytes()
