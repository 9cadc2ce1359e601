"""The CUDA kernels of rtm_tpu_torch against their plain versions, on the
card.  Marked `cuda`; each test skips when no CUDA device is present.

The file imports neither JAX nor rtm_tpu nor tests/conftest.py, so it runs
on a machine that has PyTorch with CUDA and nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: the mxu kernel's pair test takes the table's 16-bit rows
against the ray's f32 features on the tensor cores, the plain version the
TPU kernel's coarser bf16x3 product, so a ray through an edge two triangles
share may pick the other one: hitrec must agree on >= 99.9% of records.
Scene 3's walls are such pairs, and the share of rays near their edges
falls as the resolution grows, so scene 3 runs at 64x64, the size
chip_smoke.py holds to the same bound (0.9985 of records agreed at 32x32 on
an H100).  On integer-valued rows and rays every product and sum is exact
in both, and there the pair pass (`mxu_nearest`) must agree bitwise.  On
the lanes whose records all agree, both sides round op by op alike (the
kernels are built with --fmad=false), so color / miss / rec agree to 1e-3
absolute (the transcendentals are the only operations that may differ in
the last place).  The post-pass kernel (csrc/postpass.cu) repeats the
dense post-pass's operations in order and is bitwise the plain version run
by PyTorch on the card, but for the procedural sun: there the plain
version's dot product goes to cuBLAS (rtol 2e-4, below).  The replay
gather's backward (csrc/row_grad.cu) has only additions, in the plain
version's order, so it is bitwise that version and bitwise itself from run
to run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import rtm_tpu_torch
from rtm_tpu_torch.models.scenes import dragon_grid
from rtm_tpu_torch.ops.kernels import mxu_kernel as tmk
from rtm_tpu_torch.ops.kernels import trav_kernel as ttk
from rtm_tpu_torch.ops.kernels.megakernel import _pack_camera
from torch_mxu_cases import (N_TRIS_EDGES, frac_rays, int_rays, int_tables,
                             model_key, nearest_culled, table_scene)
from torch_postpass_cases import VARIANTS as POSTPASS_VARIANTS
from torch_postpass_cases import records, variant_scene

pytestmark = pytest.mark.cuda

AGREE_MIN = 0.999
MAX_ABS_ERR = 1e-3

# name: (scene, width, height, bounces, frames, frame_index)
CASES = {
    "scene1": (1, 32, 32, 4, 1, 1),
    "scene2": (2, 32, 32, 4, 1, 1),
    "scene3": (3, 64, 64, 4, 1, 1),
    "scene5": (5, 32, 32, 4, 1, 1),
    "grid2": ("grid2", 32, 32, 4, 1, 1),
    "scene2_tail_2frames": (2, 24, 20, 3, 2, 5),
    "grid10": ("grid10", 64, 64, 4, 1, 1),
}
# name: (case, first slot, slots) of a dispatch window
WINDOWS = {
    "scene3": ("scene3", 1000, 1500),
    "scene2_tail_2frames": ("scene2_tail_2frames", 100, 300),
    "scene3_odd": ("scene3", 37, 1001),
    "scene3_one_slot": ("scene3", 2049, 1),
    "grid10_odd": ("grid10", 515, 777),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _scene(sid, device):
    host = (dragon_grid(int(sid[4:])) if isinstance(sid, str)
            else rtm_tpu_torch.load_scene(sid))
    return rtm_tpu_torch.build_tracer_scene(host, device=device)


def _setup(name, device):
    sid, w, h, bounces, frames, fi = CASES[name]
    st = _scene(sid, device)
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=bounces,
                                     max_frames=frames, draw_environment=True)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(w, h), device)
    return st, tmk.side_tables(st), camf, fi, cfg


@pytest.mark.parametrize("name", list(CASES))
def test_mxu_kernel_matches_plain(cuda, name):
    st, tabs, camf, fi, cfg = _setup(name, cuda)
    n = cfg.width * cfg.height
    before = tmk.mxu_trace.launches
    k = tmk.mxu_trace(st, tabs, camf, fi, 0, n, cfg, return_hitrec=True)
    assert tmk.mxu_trace.launches == before + 1
    p = tmk.mxu_trace_plain(st, tabs, camf, fi, 0, n, cfg,
                            return_hitrec=True)
    torch.cuda.synchronize()
    same = k[3] == p[3]
    assert float(same.float().mean()) >= AGREE_MIN
    lanes = same.all(dim=0)
    assert float(lanes.float().mean()) >= 0.99
    for a, b in zip(k[:3], p[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and torch.isfinite(a).all()
            assert float((a - b)[:, lanes].abs().max()) <= MAX_ABS_ERR


@pytest.mark.parametrize("name", list(WINDOWS))
def test_mxu_kernel_window_equals_full_dispatch(cuda, name):
    """Slots [o, o + n) dispatched alone equal that window of the full
    dispatch: each thread traces its own slot, and the per-block chunk
    cull only skips chunks that none of the block's rays can hit."""
    case, off, rays = WINDOWS[name]
    st, tabs, camf, fi, cfg = _setup(case, cuda)
    full = tmk.mxu_trace(st, tabs, camf, fi, 0, cfg.width * cfg.height, cfg,
                         return_hitrec=True)
    part = tmk.mxu_trace(st, tabs, camf, fi, off, rays, cfg,
                         return_hitrec=True)
    for a, b in zip(full, part):
        if a is not None:
            assert torch.equal(a[:, off:off + rays], b)


def test_mxu_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    st = _scene(3, cuda)
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(16, 16), cuda)
    tabs = tmk.side_tables(st)
    before = tmk.mxu_trace.launches
    for bad in (camf.double(), torch.zeros(128, device=cuda)[::2],
                camf[:32]):
        with pytest.raises(ValueError, match="camf"):
            tmk.mxu_trace(st, tabs, bad, 1, 0, 256, cfg)
    for name, bad in (("mat", tabs.mat.T), ("tex", tabs.tex.cpu()),
                      ("tex", None), ("sph", tabs.sph.half())):
        with pytest.raises(ValueError, match=name):
            tmk.mxu_trace(st, tabs._replace(**{name: bad}), camf, 1, 0,
                          256, cfg)
    with pytest.raises(ValueError, match="scene on"):
        tmk.mxu_trace(st, tabs, camf.cpu(), 1, 0, 256, cfg)
    assert tmk.mxu_trace.launches == before


def test_render_dispatch_on_the_card(cuda):
    """The full frame (kernel + post-pass + slot map) against the same
    scene rendered on the CPU through the plain version."""
    w = h = 64
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=4,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(w, h)
    before = tmk.mxu_trace.launches
    got = rtm_tpu_torch.render_dispatch(_scene(3, cuda), cam, 2, cfg)
    assert got.device.type == "cuda" and tmk.mxu_trace.launches == before + 1
    want = rtm_tpu_torch.render_dispatch(_scene(3, "cpu"), cam, 2, cfg)
    diff = np.abs(got.cpu().numpy() - want.numpy()).max(axis=-1)
    assert diff.mean() <= 5e-3 and (diff > 2e-2).mean() <= 0.01
    assert (diff > 0.2).mean() <= 0.003


def _random_tri_scene(n_tris, device, seed=0):
    """n_tris triangles in front of the default camera (one large facing
    it, the rest random, half of them facing it), over a ground sphere and
    under the procedural sky."""
    from rtm_tpu_torch import (Material, Mesh, MeshInstance, Scene,
                               SphereDef, Triangle)
    from rtm_tpu_torch.models import scenes

    rng = np.random.default_rng(seed)
    s = Scene(sky=scenes._procedural_sky())
    s.add_material(Material((0.7, 0.6, 0.5), (1, 1, 1), 0.2, 0.1, 0, 1.0, -1))
    s.add_sphere(SphereDef((0, -101, -2), 100.0, 0))
    c = rng.uniform((-1.6, -0.6, -2.0), (1.6, 2.6, 1.0), size=(n_tris, 3))
    e = rng.normal(size=(n_tris, 2, 3)) * 0.35
    # the first one large, upright and facing the camera: every scene is hit
    c[0], e[0] = (-0.8, 0.2, -1.0), ((1.6, 0.0, 0.0), (0.8, 1.6, 0.0))
    s.add_mesh(Mesh.from_triangles([
        Triangle(tuple(p), tuple(p + a), tuple(p + b))
        for p, (a, b) in zip(c, np.asarray(e))]))
    s.add_object(MeshInstance(mesh_id=0, material_id=0))
    return rtm_tpu_torch.build_tracer_scene(s, device=device)


@pytest.mark.parametrize("n_tris", N_TRIS_EDGES)
def test_mxu_kernel_matches_plain_random_triangles(cuda, n_tris):
    """Scenes of 1 to 2047 triangles (one to 16 chunks, full and partial
    8-triangle groups) at 48x40, 3 bounces, 2 frames: the kernel's records
    and outputs against the plain version's by the CASES criteria."""
    st = _random_tri_scene(n_tris, cuda, seed=n_tris)
    assert st.mxu_meta.n_tris == n_tris and st.mxu_meta.supported
    cfg = rtm_tpu_torch.RenderConfig(width=48, height=40, max_bounces=3,
                                     max_frames=2, draw_environment=True)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(48, 40), cuda)
    tabs = tmk.side_tables(st)
    n = 48 * 40
    k = tmk.mxu_trace(st, tabs, camf, 3, 0, n, cfg, return_hitrec=True)
    p = tmk.mxu_trace_plain(st, tabs, camf, 3, 0, n, cfg,
                            return_hitrec=True)
    torch.cuda.synchronize()
    assert bool(((p[3] & tmk.HR_TRI) != 0).any())      # triangles are hit
    same = k[3] == p[3]
    assert float(same.float().mean()) >= AGREE_MIN
    lanes = same.all(dim=0)
    for a, b in zip(k[:3], p[:3]):
        if a is not None:
            assert torch.isfinite(a).all()
            assert float((a - b)[:, lanes].abs().max()) <= MAX_ABS_ERR


def _nearest_pair(n_tris, device, alive_fn, seed, dup=False, n_rays=3000,
                  span=4, frac=False):
    """The pair pass on the card against its reference on the CPU: the
    plain version's key on integer rays, the lane model's on fractional
    ones (`frac`, whose lo parts the plain version does not take)."""
    ma = int_tables(n_tris, seed=seed, dup=dup, span=span)
    rays = (frac_rays if frac else int_rays)(n_rays, seed=seed + 1)
    alive = alive_fn(torch.arange(n_rays))
    before = tmk.mxu_nearest.launches
    got = tmk.mxu_nearest(table_scene(ma, n_tris, device), rays.to(device),
                          alive.to(device))
    assert tmk.mxu_nearest.launches == before + 1
    want = (nearest_culled(ma, n_tris, rays, alive, key=model_key) if frac
            else nearest_culled(ma, n_tris, rays, alive))
    return got.cpu(), want, alive


@pytest.mark.parametrize("n_tris", N_TRIS_EDGES)
def test_mxu_pair_pass_integer_bitwise(cuda, n_tris):
    """The mma fragment layout, staging, test, packing and reductions held
    exactly: on integer rows and rays (axis-aligned, NaN and inf ones
    among them) the tensor-core pair pass gives the plain version's packed
    key over the chunks its block's cull passes (nearest_culled) on
    every live ray, and BIG on every dead one."""
    got, want, alive = _nearest_pair(
        n_tris, cuda, lambda i: (i * 2654435761 % 10) != 3, seed=n_tris)
    assert int((want[alive] < 1e29).sum()) >= (50 if n_tris >= 34 else 1)
    assert torch.equal(got[alive].view(torch.int32),
                       want[alive].view(torch.int32))
    assert (got[~alive] == tmk.BIG).all()


@pytest.mark.parametrize("n_tris", N_TRIS_EDGES)
def test_mxu_pair_pass_fractional_bitwise(cuda, n_tris):
    """The ray tile's md and lo words and their ldmatrix slots held
    exactly: on rays whose features split into three non-zero bf16 parts
    (frac_rays) against small integer tables, where every product and sum
    stays exact, the tensor-core pair pass gives the lane model's packed
    key (model_key) over the chunks its block's cull passes on every live
    ray, and BIG on every dead one."""
    got, want, alive = _nearest_pair(
        n_tris, cuda, lambda i: (i * 2654435761 % 10) != 3, seed=n_tris,
        span=1, frac=True)
    assert int((want[alive] < 1e29).sum()) >= (30 if n_tris >= 34 else 1)
    assert torch.equal(got[alive].view(torch.int32),
                       want[alive].view(torch.int32))
    assert (got[~alive] == tmk.BIG).all()


@pytest.mark.parametrize("case", ["duplicates", "one_live_lane",
                                  "lane_31_alone", "tail_of_one",
                                  "wide_rows"])
def test_mxu_pair_pass_edges_bitwise(cuda, case):
    """Duplicate triangles (the lower row wins), a single live lane in
    each warp, a warp whose last lane alone is live, a dispatch whose last
    block holds one ray, and vertices in [-16, 16] (A_lo words non-zero in
    the edge rows too), all bitwise against the plain version."""
    alive_fn = {"duplicates": lambda i: torch.ones_like(i, dtype=bool),
                "one_live_lane": lambda i: i % 32 == (i // 32) % 32,
                "lane_31_alone": lambda i: (i % 32 == 31) & (i // 32 % 3 == 0),
                "tail_of_one": lambda i: i % 5 != 0,
                "wide_rows": lambda i: i % 7 != 2}[case]
    got, want, alive = _nearest_pair(
        300, cuda, alive_fn, seed=11, dup=case == "duplicates",
        n_rays=2049 if case == "tail_of_one" else 3000,
        span=16 if case == "wide_rows" else 4)
    assert torch.equal(got[alive].view(torch.int32),
                       want[alive].view(torch.int32))
    assert (got[~alive] == tmk.BIG).all()


def test_mxu_nearest_rejects_what_the_kernel_does_not_take(cuda):
    ma = int_tables(34, seed=2)
    sc = table_scene(ma, 34, cuda)
    rays = int_rays(64, seed=3).to(cuda)
    alive = torch.ones(64, dtype=torch.bool, device=cuda)
    before = tmk.mxu_nearest.launches
    for r, a, what in ((rays.double(), alive, "rays"),
                       (rays[:5], alive, "rays"),
                       (rays, alive.int(), "alive"),
                       (rays, alive[:10], "alive")):
        with pytest.raises(ValueError, match=what):
            tmk.mxu_nearest(sc, r, a)
    bad = dataclasses.replace(sc.mxu_arrays,
                              pair=sc.mxu_arrays.pair.float())
    with pytest.raises(ValueError, match="pair"):
        tmk.mxu_nearest(table_scene(bad, 34, cuda), rays, alive)
    assert tmk.mxu_nearest.launches == before


# trav kernel.  Kernel and plain version compute the same f32 operations in
# the same order, so a lane differs only where a transcendental's last place
# tips a near-tie: >= 99.9% of lanes must agree on color / miss / rec within
# 1e-3, and the per-slot node-visit and triangle-test counts on as many.
# name: (scene, width, height, bounces, frames, frame_index)
TRAV_CASES = {
    "scene1": (1, 32, 32, 4, 1, 1),
    "scene3": (3, 32, 32, 4, 1, 1),
    "grid11": ("grid11", 32, 32, 4, 1, 1),
    "grid11_tail_2frames": ("grid11", 24, 20, 3, 2, 5),
}


def _trav_setup(name, device):
    sid, w, h, bounces, frames, fi = TRAV_CASES[name]
    st = _scene(sid, device)
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=bounces,
                                     max_frames=frames, draw_environment=True)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(w, h), device)
    return st, ttk.trav_side_tables(st), camf, fi, cfg


@pytest.mark.parametrize("name", list(TRAV_CASES))
def test_trav_kernel_matches_plain(cuda, name):
    st, tabs, camf, fi, cfg = _trav_setup(name, cuda)
    n = cfg.width * cfg.height
    before = ttk.trav_trace.launches
    k = ttk.trav_trace(st, tabs, camf, fi, 0, n, cfg, with_stats=True)
    assert ttk.trav_trace.launches == before + 1
    p = ttk.trav_trace_plain(st, tabs, camf, fi, 0, n, cfg, with_stats=True)
    torch.cuda.synchronize()
    diff = torch.zeros(n, device=cuda)
    for a, b in zip(k[:3], p[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and torch.isfinite(a).all()
            diff = torch.maximum(diff, (a - b).abs().amax(dim=0))
    assert float((diff <= MAX_ABS_ERR).float().mean()) >= AGREE_MIN
    assert float((k[3] == p[3]).all(dim=0).float().mean()) >= AGREE_MIN
    if st.trav_meta.n_nodes:
        assert int(k[3][1].sum()) > 0


def test_trav_kernel_window_equals_full_dispatch(cuda):
    """Slots [o, o + n) dispatched alone equal that window of the full
    dispatch: each thread traces its own slot."""
    st, tabs, camf, fi, cfg = _trav_setup("grid11_tail_2frames", cuda)
    off, rays = 100, 300
    full = ttk.trav_trace(st, tabs, camf, fi, 0, cfg.width * cfg.height,
                          cfg, with_stats=True)
    part = ttk.trav_trace(st, tabs, camf, fi, off, rays, cfg,
                          with_stats=True)
    for a, b in zip(full, part):
        if a is not None:
            assert torch.equal(a[:, off:off + rays], b)


def test_trav_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    st = _scene(3, cuda)
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(16, 16), cuda)
    tabs = ttk.trav_side_tables(st)
    before = ttk.trav_trace.launches
    for bad in (camf.double(), camf[:32]):
        with pytest.raises(ValueError, match="camf"):
            ttk.trav_trace(st, tabs, bad, 1, 0, 256, cfg)
    ta = st.trav_arrays
    for field, bad in (("node", ta.node.float()),
                       ("tri_feat", ta.tri_feat.cpu()),
                       ("tri_info", ta.tri_info.long())):
        broken = dataclasses.replace(
            st, trav_arrays=dataclasses.replace(ta, **{field: bad}))
        with pytest.raises(ValueError, match=field):
            ttk.trav_trace(broken, tabs, camf, 1, 0, 256, cfg)
    for name, bad in (("mat", tabs.mat.T), ("tex", None),
                      ("sph", tabs.sph.half())):
        with pytest.raises(ValueError, match=name):
            ttk.trav_trace(st, tabs._replace(**{name: bad}), camf, 1, 0,
                           256, cfg)
    with pytest.raises(ValueError, match="scene on"):
        ttk.trav_trace(st, tabs, camf.cpu(), 1, 0, 256, cfg)
    assert ttk.trav_trace.launches == before


def test_trav_render_dispatch_on_the_card(cuda):
    """A scene beyond the mxu tables (dragon_grid(11), 2420 triangles)
    renders through the trav kernel on the card, and its frame matches the
    same scene rendered on the CPU through the plain version."""
    w = h = 32
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=4,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(w, h)
    st = _scene("grid11", cuda)
    before = ttk.trav_trace.launches
    got = rtm_tpu_torch.render_dispatch(st, cam, 2, cfg)
    assert got.device.type == "cuda"
    assert ttk.trav_trace.launches == before + 1
    want = rtm_tpu_torch.render_dispatch(_scene("grid11", "cpu"), cam, 2,
                                         cfg)
    diff = np.abs(got.cpu().numpy() - want.numpy()).max(axis=-1)
    assert diff.mean() <= 5e-3 and (diff > 2e-2).mean() <= 0.01
    assert (diff > 0.2).mean() <= 0.003


# The trav kernel's warp-cooperative leaf tests (csrc/trav_trace.cu
# drain_leaf), held bitwise to the plain version on every output and every
# slot's stats.  dragon_grid(6)'s 720 triangle rows are re-cut into a flat
# skip-link tree (a root over every leaf, then one leaf per FLAT_LEAVES
# count), so leaves of 1, 31, 32, 33 and 256 rows are tested.  The camera
# at (1.25, 0, 5) looks straight down -z at one instance: the centre
# column's rays have dx = 0 exactly and the centre pixel's is (0, 0, -1).
TRAV_EDGES = ("lone_lane", "tie", "leaf_sizes", "tail_window", "axis_nan")
FLAT_LEAVES = (1, 31, 32, 33, 256, 256, 111)
TIE_LEAF = FLAT_LEAVES.index(256)


def _flat_trav(st, tie=False, nan_every=0):
    """`st` with its trav tables re-cut into FLAT_LEAVES (rows in table
    order).  tie: in the first 256-row leaf, row 2j + 1 repeats row 2j
    (j < 64; two lanes) and row 160 + j repeats row 128 + j (j < 32; one
    lane, a step apart), each copy with another shading normal, so equal t
    at two rows must go to the lower row.  nan_every: a NaN shading normal
    on every such row, so the rays that hit one scatter into NaN rays."""
    ta, tm = st.trav_arrays, st.trav_meta
    feat = ta.tri_feat.cpu().numpy()
    info = ta.tri_info.cpu().numpy()
    real = np.abs(feat[:, 3:9]).sum(axis=1) > 0
    feat, info = feat[real], info[real]
    assert len(feat) == sum(FLAT_LEAVES)
    nl, kk = len(FLAT_LEAVES), max(FLAT_LEAVES)
    tf = np.zeros((nl, kk, ttk.TF_ROWS), np.float32)
    ti = np.full((nl, kk), int(info.max()) | 255 << 8, np.int32)
    ends = np.cumsum((0,) + FLAT_LEAVES)
    for leaf, c in enumerate(FLAT_LEAVES):
        tf[leaf, :c] = feat[ends[leaf]:ends[leaf + 1]]
        ti[leaf, :c] = info[ends[leaf]:ends[leaf + 1]]
    if tie:
        for lo, hi in ((slice(0, 128, 2), slice(1, 128, 2)),
                       (slice(128, 160), slice(160, 192))):
            tf[TIE_LEAF, hi] = tf[TIE_LEAF, lo]
            tf[TIE_LEAF, hi, 9:12] = np.float32([0.6, 0.0, 0.8])
            ti[TIE_LEAF, hi] = ti[TIE_LEAF, lo]
    if nan_every:
        tf.reshape(-1, ttk.TF_ROWS)[::nan_every, 9:12] = np.nan
    n_nodes = nl + 1
    box = np.zeros((6, n_nodes), np.float32)
    for leaf, c in enumerate(FLAT_LEAVES):
        a = tf[leaf, :c, 0:3]
        v = np.concatenate([a, a + tf[leaf, :c, 3:6], a + tf[leaf, :c, 6:9]])
        box[:3, leaf + 1], box[3:, leaf + 1] = v.min(axis=0), v.max(axis=0)
    box[:3, 0], box[3:, 0] = box[:3, 1:].min(axis=1), box[3:, 1:].max(axis=1)
    node = np.zeros((n_nodes, 4), np.int32)
    node[:, 0:3] = ttk._pack_box_bf16(box).T
    skip = np.arange(1, n_nodes + 1)
    skip[0] = n_nodes
    node[:, 3] = (skip | np.arange(n_nodes) << 10
                  | np.array((0,) + FLAT_LEAVES) << 20)
    dev = st.device
    arrays = ttk.TravArrays(
        torch.from_numpy(node).to(dev),
        torch.from_numpy(tf.reshape(-1, ttk.TF_ROWS)).to(dev),
        torch.from_numpy(ti.reshape(-1)).to(dev))
    return dataclasses.replace(st, trav_arrays=arrays, trav_meta=tm._replace(
        n_nodes=n_nodes, n_leaves=nl, leaf_k=kk))


def _trav_edge_case(edge, device):
    """(scene, side tables, camf, cfg, pixel offset, slots) of one edge
    case at 64x64.  lone_lane: a 97-slot window, so the last warp holds one
    slot (the centre pixel) beside 31 tail lanes; tail_window: 3969 slots
    from slot 77 of the SAH-cut tables, 2 frames."""
    st = _scene("grid6", device)
    cam = rtm_tpu_torch.Camera()
    cam.position = np.array([1.25, 0.0, 5.0])
    if edge != "tail_window":
        st = _flat_trav(st, tie=edge == "tie",
                        nan_every=5 if edge == "axis_nan" else 0)
    w = h = 64
    frames = 2 if edge == "tail_window" else 1
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=4,
                                     max_frames=frames, draw_environment=True)
    camf = _pack_camera(cam.spec(w, h), device)
    centre = 36 * 64                 # the slot of pixel (32, 32), 8x8 blocks
    pix0, n = {"lone_lane": (centre - 96, 97),
               "tail_window": (77, w * h - 127)}.get(edge, (0, w * h))
    return st, ttk.trav_side_tables(st), camf, cfg, pix0, n


def _trav_edge_run(edge, device, kernel=True):
    """(kernel outputs or None, plain outputs, the plain descent's winning
    rows and the leaf sizes it tested) of one edge case."""
    from unittest import mock

    st, tabs, camf, cfg, pix0, n = _trav_edge_case(edge, device)
    k = None
    if kernel:
        before = ttk.trav_trace.launches
        k = ttk.trav_trace(st, tabs, camf, 1, pix0, n, cfg, with_stats=True)
        assert ttk.trav_trace.launches == before + 1
    rows, sizes = [], set()
    nearest, leaf_tests = ttk.trav_nearest_plain, ttk._leaf_tests

    def rec_nearest(*a):
        out = nearest(*a)
        rows.append(out[2][out[0]])
        return out

    def rec_leaves(ta, el, base, cnt, *a):
        sizes.update(int(c) for c in cnt.unique())
        return leaf_tests(ta, el, base, cnt, *a)

    with mock.patch.object(ttk, "trav_nearest_plain", rec_nearest), \
            mock.patch.object(ttk, "_leaf_tests", rec_leaves):
        p = ttk.trav_trace_plain(st, tabs, camf, 1, pix0, n, cfg,
                                 with_stats=True)
    return k, p, torch.cat(rows).cpu(), sizes


def _trav_edge_holds(edge, p, rows, sizes):
    """What each edge case must exercise, read from the plain version."""
    stats = p[3]
    assert int(stats[1].sum()) > 0
    if edge == "lone_lane":
        assert int(stats[1, -1]) > 0
    if edge == "tie":
        base = TIE_LEAF * max(FLAT_LEAVES)
        low = torch.cat([torch.arange(0, 128, 2), torch.arange(128, 160)])
        high = torch.cat([torch.arange(1, 128, 2), torch.arange(160, 192)])
        assert bool(torch.isin(rows, low + base).any())
        assert not bool(torch.isin(rows, high + base).any())
    if edge == "leaf_sizes":
        assert {1, 31, 32, 33, 256} <= sizes
    if edge == "axis_nan":
        assert bool(torch.isnan(p[1]).any())
        assert int(stats[0, 36 * 64]) > 0


@pytest.mark.parametrize("edge", TRAV_EDGES)
def test_trav_warp_leaf_edges_bitwise(cuda, edge):
    k, p, rows, sizes = _trav_edge_run(edge, cuda)
    torch.cuda.synchronize()
    for a, b in zip(k[:3], p[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0.0, atol=0.0,
                                       equal_nan=True)
    assert torch.equal(k[3], p[3])
    _trav_edge_holds(edge, p, rows, sizes)


# The cluster-sweep and intersect kernels.  Both compute the plain version's
# f32 operations in the same order (--fmad=false, IEEE division), so the
# winners agree on every lane of these bands; the bound kept is rtm_tpu's
# own: >= 99.9% of (alive) lanes, per-tile passes equal on >= 99% of tiles.
# The bands are the wavefront2 renderer's own: every bounce of one frame,
# unsorted unless a test asks (sort_from=99), recorded as the sweep got them.
SWEEP_SCENES = (2, 3, "grid11")


def _bands(st, res=32, bounces=4, sort_from=99):
    from unittest import mock

    from rtm_tpu_torch.ops import wavefront2 as wf2

    cfg = rtm_tpu_torch.RenderConfig(width=res, height=res,
                                     max_bounces=bounces,
                                     draw_environment=True)
    bands = []
    sweep_call = wf2.sweep_call

    def record(pack, state8, **kw):
        bands.append(state8)
        return sweep_call(pack, state8, **kw)

    with mock.patch.object(wf2, "sweep_call", record):
        wf2.render_rays_wavefront2(st, rtm_tpu_torch.Camera().spec(res, res),
                                   1, cfg, pixel_offset=0, n_rays=res * res,
                                   sort_from=sort_from)
    return bands


@pytest.mark.parametrize("sid", SWEEP_SCENES)
def test_cluster_sweep_kernel_matches_plain(cuda, sid):
    from rtm_tpu_torch.ops.kernels import sweep_kernel as sk
    from rtm_tpu_torch.ops.kernels.megakernel import build_mega_pack

    st = _scene(sid, cuda)
    pack = build_mega_pack(st)
    bands = _bands(st)
    assert bands
    for state8 in bands:
        before = sk.cluster_sweep.launches
        t, i, passes = sk.cluster_sweep(pack, state8)
        assert sk.cluster_sweep.launches == before + 1
        pt, pi, pp = sk.cluster_sweep_plain(
            pack.tri_feats, pack.boxes, pack.cluster_offsets,
            pack.cluster_widths, state8)
        torch.cuda.synchronize()
        alive = state8[6] > 0.5
        assert float((i == pi)[alive].float().mean()) >= AGREE_MIN
        assert float((passes == pp).float().mean()) >= 0.99
        same = (i == pi) & (i >= 0)
        assert torch.equal(t[same], pt[same])


@pytest.mark.parametrize("sid", SWEEP_SCENES)
def test_intersect_kernel_matches_plain(cuda, sid):
    from rtm_tpu_torch.ops.kernels import intersect_kernel as ik

    st = _scene(sid, cuda)
    feats, lo, hi, nc = ik.pack_triangle_features(st.tri_wa, st.tri_wb,
                                                  st.tri_wc)
    boxes = torch.cat([lo.T, hi.T, torch.zeros((2, nc), device=cuda)])
    for state8 in _bands(st):
        rays = ik.pack_rays(state8[0:3].T, state8[3:6].T)
        before = ik.intersect_sweep.launches
        t, i, passes = ik.intersect_sweep(rays, feats, boxes.contiguous(),
                                          nc, return_passes=True)
        assert ik.intersect_sweep.launches == before + 1
        pt, pi, pp = ik.intersect_sweep_plain(rays, feats, boxes, nc,
                                              return_passes=True)
        torch.cuda.synchronize()
        assert float((i == pi).float().mean()) >= AGREE_MIN
        assert float((passes == pp).float().mean()) >= 0.99
        same = i == pi
        assert torch.allclose(t[same], pt[same], rtol=1e-6, atol=0.0)


# The intersect kernel's real-rows sweep and candidate prefilter (csrc/
# intersect_sweep.cu), held bitwise to the plain version, which tests every
# row (padding included) and walks every cluster: t, the winner and the
# per-tile passes on every lane.
INTERSECT_EDGES = ("scene3", "full_clusters", "many_clusters", "no_box",
                   "nan_rays")


def _slab_triangles(n_tris, seed):
    """n_tris small random triangles whose centres run along x in buffer
    order, so each 128-row cluster is a thin slab of the row [0, n_tris/8)."""
    rs = np.random.default_rng(seed)
    ctr = np.stack([np.sort(rs.uniform(0.0, n_tris / 8.0, n_tris)),
                    rs.uniform(-1.0, 1.0, n_tris),
                    rs.uniform(-1.0, 1.0, n_tris)], axis=1)
    a, b, c = (ctr + rs.normal(0.0, 0.2, (n_tris, 3)) for _ in range(3))
    return [torch.from_numpy(x.astype(np.float32)) for x in (a, b, c)]


def _intersect_edge_case(edge, device):
    """(rays (N, 16), feats, boxes, clusters, real rows) of one edge case:
    scene 3's 64x64 wavefront2 bands (one cluster, 34 rows); the first 640
    triangles of dragon_grid(6) (5 full clusters) on that scene's bands;
    600 clusters of slab triangles (two box chunks) with rays along the
    row; and dragon_grid(6) with even tiles far out heading away (no box)
    or with NaN origins and directions (tile 3 all NaN)."""
    from rtm_tpu_torch.ops.kernels import intersect_kernel as ik

    if edge == "many_clusters":
        tris = [t.to(device) for t in _slab_triangles(600 * 128, 5)]
        rs = np.random.default_rng(6)
        o = np.stack([rs.uniform(0.0, 9600.0, 4096), rs.uniform(-1, 1, 4096),
                      rs.uniform(-1, 1, 4096)], axis=1)
        d = rs.normal(size=(4096, 3)) * np.float64([4.0, 1.0, 1.0])
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = (torch.from_numpy(x.astype(np.float32)).to(device)
                for x in (o, d))
    else:
        st = _scene(3 if edge == "scene3" else "grid6", device)
        tris = [st.tri_wa, st.tri_wb, st.tri_wc]
        if edge == "full_clusters":
            tris = [t[:640] for t in tris]
        state8 = torch.cat(_bands(st, res=64, bounces=2), dim=1)
        o, d = state8[0:3].T.contiguous(), state8[3:6].T.contiguous()
        if edge == "no_box":
            for tile in range(0, o.shape[0] // 256, 2):
                lanes = slice(tile * 256, (tile + 1) * 256)
                o[lanes] += 1e4
                d[lanes] = d[lanes].abs()
        if edge == "nan_rays":
            o[0::14, 0] = float("nan")
            d[7::14, 1] = float("nan")
            o[3 * 256:4 * 256] = float("nan")
    feats, lo, hi, nc = ik.pack_triangle_features(*tris)
    boxes = torch.cat([lo.T, hi.T, torch.zeros((2, nc), device=device)])
    return ik.pack_rays(o, d), feats, boxes.contiguous(), nc, tris[0].shape[0]


@pytest.mark.parametrize("edge", INTERSECT_EDGES)
def test_intersect_prefilter_edges_bitwise(cuda, edge):
    from rtm_tpu_torch.ops.kernels import intersect_kernel as ik

    rays, feats, boxes, nc, n_tris = _intersect_edge_case(edge, cuda)
    before = ik.intersect_sweep.launches
    t, i, passes = ik.intersect_sweep(rays, feats, boxes, nc,
                                      return_passes=True, n_tris=n_tris)
    assert ik.intersect_sweep.launches == before + 1
    pt, pi, pp, passed = ik.intersect_sweep_plain(
        rays, feats, boxes, nc, return_passes=True, with_passed=True)
    torch.cuda.synchronize()
    assert torch.equal(t, pt) and torch.equal(i, pi)
    assert torch.equal(passes, pp)
    assert int(passes.sum()) > 0 and bool((i >= 0).any())
    if edge == "scene3":
        assert nc == 1 and n_tris == 34
    if edge == "full_clusters":
        assert n_tris == nc * 128
    if edge == "many_clusters":
        assert nc > 512 and bool(passed[:, 512:].any())
    if edge == "no_box":
        assert int(passes[0::2].sum()) == 0
        assert bool((t.view(-1, 256)[0::2] == ik.FLT_MAX).all())
    if edge == "nan_rays":
        assert int(passes[3]) == 0 and bool((i[3 * 256:4 * 256] == -1).all())


def test_sweep_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from rtm_tpu_torch.ops.kernels import intersect_kernel as ik
    from rtm_tpu_torch.ops.kernels import sweep_kernel as sk
    from rtm_tpu_torch.ops.kernels.megakernel import build_mega_pack

    st = _scene(3, cuda)
    pack = build_mega_pack(st)
    state8 = torch.zeros((8, 512), device=cuda)
    before = sk.cluster_sweep.launches
    for bad in (state8.double(), state8[:, :500],
                torch.zeros((512, 8), device=cuda).T):
        with pytest.raises(ValueError, match="state8"):
            sk.cluster_sweep(pack, bad)
    with pytest.raises(ValueError, match="ray_tile"):
        sk.cluster_sweep(pack, state8, ray_tile=500)
    for name, field, bad in (
            ("tri_feats", "tri_feats", pack.tri_feats.double()),
            ("boxes", "boxes", pack.boxes.cpu()),
            ("offsets", "offsets_dev", pack.offsets_dev.long()),
            ("widths", "widths_dev", pack.widths_dev[:-1])):
        with pytest.raises(ValueError, match=name):
            sk.cluster_sweep(pack._replace(**{field: bad}), state8)
    assert sk.cluster_sweep.launches == before

    feats, lo, hi, nc = ik.pack_triangle_features(st.tri_wa, st.tri_wb,
                                                  st.tri_wc)
    boxes = torch.cat([lo.T, hi.T, torch.zeros((2, nc), device=cuda)])
    rays = torch.zeros((256, 16), device=cuda)
    before = ik.intersect_sweep.launches
    for name, args in (("rays", (rays[:200], feats, boxes)),
                       ("rays", (rays.double(), feats, boxes)),
                       ("feats", (rays, feats.T, boxes)),
                       ("boxes", (rays, feats, boxes.cpu()))):
        with pytest.raises(ValueError, match=name):
            ik.intersect_sweep(*args, nc)
    assert ik.intersect_sweep.launches == before


@pytest.mark.parametrize("backend", ["wavefront2", "pallas"])
@pytest.mark.parametrize("sid", [1, 3, "grid11"])
def test_sweep_render_dispatch_on_the_card(cuda, backend, sid):
    """render_dispatch(backend=...) on a CUDA scene launches its kernel (once
    per bounce; never for a scene without triangles) and its frame matches
    the same scene rendered on the CPU through the plain version."""
    from rtm_tpu_torch.ops.kernels import intersect_kernel as ik
    from rtm_tpu_torch.ops.kernels import sweep_kernel as sk

    counter = sk.cluster_sweep if backend == "wavefront2" \
        else ik.intersect_sweep
    w = h = 32
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=4,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(w, h)
    st = _scene(sid, cuda)
    before = counter.launches
    got = rtm_tpu_torch.render_dispatch(st, cam, 2, cfg, backend=backend)
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    launched = counter.launches - before
    assert launched == (cfg.max_bounces if st.num_triangles else 0)
    want = rtm_tpu_torch.render_dispatch(_scene(sid, "cpu"), cam, 2, cfg,
                                         backend=backend)
    diff = np.abs(got.cpu().numpy() - want.numpy()).max(axis=-1)
    assert diff.mean() <= 5e-3 and (diff > 2e-2).mean() <= 0.01
    assert (diff > 0.2).mean() <= 0.003


def _grad_rig(device):
    """tests/test_grad.py's `_scene()`: two materials, three spheres and one
    triangle, no shared triangle edges, so the kernel and its plain version
    record the same winners."""
    from rtm_tpu_torch import (Material, Mesh, MeshInstance, Scene,
                               SphereDef, Triangle)
    from rtm_tpu_torch.models import scenes

    s = Scene(sky=scenes._procedural_sky())
    s.add_material(Material((0.7, 0.4, 0.2), (1, 1, 1), 0.3, 0.2, 0, 1.0, -1))
    s.add_material(Material((1, 1, 1), (0.9, 0.8, 0.7), 0, 0, 2.0, 1.0, -1))
    s.add_sphere(SphereDef((0, 0, -2.5), 1.0, 0))
    s.add_sphere(SphereDef((0, -101, -2), 100.0, 0))
    s.add_sphere(SphereDef((1.5, 2.0, -2.0), 0.8, 1))
    s.add_mesh(Mesh.from_triangles([
        Triangle((-2.5, -0.8, -4), (2.5, -0.8, -4), (0, 2.5, -4))]))
    s.add_object(MeshInstance(mesh_id=0, material_id=0))
    return rtm_tpu_torch.build_tracer_scene(s, device=device)


def test_mxu_grad_on_the_card_matches_the_cpu(cuda):
    """loss_and_grad(backend="mxu") on the card (the mxu kernel's records,
    the replay's gather backward by csrc/row_grad.cu) against the same
    scene on the CPU (the plain versions): every gradient finite, within
    rtol 1e-3 / atol 1e-5 (rtm_tpu's grad tolerance, tests/test_grad.py)."""
    from rtm_tpu_torch.diff import extract_params, loss_and_grad

    w, h = 24, 20
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=3,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(w, h)
    out = []
    for dev in (cuda, torch.device("cpu")):
        st = _grad_rig(dev)
        target = torch.zeros((h, w, 3), device=dev)
        before = tmk.mxu_trace.launches
        loss, g = loss_and_grad(extract_params(st), st, cam, target, 1, cfg,
                                backend="mxu", remat=False)
        assert tmk.mxu_trace.launches == before + (dev.type == "cuda")
        out.append((loss, g))
    (lk, gk), (lp, gp) = out
    assert torch.allclose(lk.cpu(), lp, rtol=1e-4)
    for name in gk.fields():
        a, b = getattr(gk, name).cpu(), getattr(gp, name)
        assert torch.isfinite(a).all(), name
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-5), name


# The megakernel.  Kernel and plain version compute the same f32 operations
# in the same order (--fmad=false, IEEE division) over the same ray tiles, so
# a lane differs only where a transcendental's last place tips a near-tie:
# >= 99.9% of lanes must agree on color / miss / rec within 1e-3 (every
# lane, dead ones too), and the per-tile-bounce cluster passes on >= 99% of
# tile-bounces.
# name: (scene, width, height, bounces, frames, frame_index, cull, order)
MEGA_CASES = {
    "scene1": (1, 64, 64, 4, 1, 1, True, "static"),
    "scene2_2frames": (2, 64, 64, 4, 2, 3, True, "static"),
    "scene3": (3, 64, 64, 4, 1, 1, True, "static"),
    "scene3_near": (3, 64, 64, 4, 1, 1, True, "near"),
    "grid10": ("grid10", 64, 64, 4, 1, 1, True, "static"),
    "grid10_near": ("grid10", 64, 64, 4, 1, 1, True, "near"),
    "grid10_nocull": ("grid10", 64, 64, 4, 1, 1, False, "static"),
    "scene3_tail": (3, 24, 20, 3, 1, 1, True, "static"),
}


def _mega_setup(name, device):
    from rtm_tpu_torch.ops.kernels.megakernel import build_mega_pack

    sid, w, h, bounces, frames, fi, cull, order = MEGA_CASES[name]
    st = _scene(sid, device)
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=bounces,
                                     max_frames=frames, draw_environment=True)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(w, h), device)
    return st, build_mega_pack(st), camf, fi, cfg, dict(cull=cull,
                                                         order=order)


@pytest.mark.parametrize("name", list(MEGA_CASES))
def test_mega_kernel_matches_plain(cuda, name):
    from rtm_tpu_torch.ops.kernels import megakernel as mk

    st, pack, camf, fi, cfg, kw = _mega_setup(name, cuda)
    n = cfg.width * cfg.height
    before = mk.mega_trace.launches
    k = mk.mega_trace(st, pack, camf, fi, 0, n, cfg, with_stats=True, **kw)
    assert mk.mega_trace.launches == before + 1
    p = mk.mega_trace_plain(st, pack, camf, fi, 0, n, cfg, with_stats=True,
                            **kw)
    torch.cuda.synchronize()
    diff = torch.zeros(n, device=cuda)
    for a, b in zip(k[:3], p[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and torch.isfinite(a).all()
            diff = torch.maximum(diff, (a - b).abs().amax(dim=0))
    assert float((diff <= MAX_ABS_ERR).float().mean()) >= AGREE_MIN
    assert k[3].passes.shape == p[3].passes.shape
    assert float((k[3].passes == p[3].passes).float().mean()) >= 0.99
    live = p[3].alive
    same = (k[3].winners == p[3].winners)[live]
    assert float(same.float().mean()) >= AGREE_MIN
    if st.num_triangles:
        assert int(k[3].passes.sum()) > 0


def test_mega_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from rtm_tpu_torch.ops.kernels import megakernel as mk

    st, pack, camf, fi, cfg, _ = _mega_setup("scene2_2frames", cuda)
    before = mk.mega_trace.launches
    for bad in (camf.double(), camf[:32]):
        with pytest.raises(ValueError, match="camf"):
            mk.mega_trace(st, pack, bad, 1, 0, 256, cfg)
    for field, bad in (("tri_feats", pack.tri_feats.double()),
                       ("tri_attrs", pack.tri_attrs[:, :32]),
                       ("boxes", pack.boxes.cpu()),
                       ("offsets", pack.offsets_dev.long()),
                       ("spheres", pack.tri_attrs[:16])):
        key = {"offsets": "offsets_dev"}.get(field, field)
        with pytest.raises(ValueError, match=field):
            mk.mega_trace(st, pack._replace(**{key: bad}), camf, 1, 0, 256,
                          cfg)
    with pytest.raises(ValueError, match="ray_tile"):
        mk.mega_trace(st, pack, camf, 1, 0, 256, cfg, ray_tile=1024)
    with pytest.raises(ValueError, match="order"):
        mk.mega_trace(st, pack, camf, 1, 0, 256, cfg, order="far")
    with pytest.raises(ValueError, match="scene on"):
        mk.mega_trace(st, pack, camf.cpu(), 1, 0, 256, cfg)
    assert mk.mega_trace.launches == before


@pytest.mark.parametrize("sid", [3, "grid10"])
def test_mega_render_dispatch_on_the_card(cuda, sid):
    """render_dispatch(backend="megakernel") launches the kernel once per
    frame, and its frame matches the same scene rendered on the CPU through
    the plain version."""
    from rtm_tpu_torch.ops.kernels import megakernel as mk

    w = h = 32
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=4,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(w, h)
    before = mk.mega_trace.launches
    got = rtm_tpu_torch.render_dispatch(_scene(sid, cuda), cam, 2, cfg,
                                        backend="megakernel")
    assert got.device.type == "cuda" and mk.mega_trace.launches == before + 1
    want = rtm_tpu_torch.render_dispatch(_scene(sid, "cpu"), cam, 2, cfg,
                                         backend="megakernel")
    diff = np.abs(got.cpu().numpy() - want.numpy()).max(axis=-1)
    assert diff.mean() <= 5e-3 and (diff > 2e-2).mean() <= 0.01
    assert (diff > 0.2).mean() <= 0.003


# The candidate prefilter's edges (csrc/tri_sweep.cuh `sweep_clusters`: box
# chunks of CB = 512 clusters, per-warp candidate bits, a serial walk over
# the candidates only).  Each kernel is held to its plain version bitwise
# on every lane, dead ones too: both compute the same f32 operations in
# the same order, and the prefilter skips only clusters that cannot pass.
# dragon_grid(6) recut into 720 one-triangle clusters walks two box
# chunks; recut into (0, 300), (300, 720) its clusters are wider than one
# 128-row stage.
PREFILTER_EDGES = ("dead_tail", "many_clusters", "wide_cluster", "no_box",
                   "nan_rays")


def _edge_scene(edge, device):
    st = _scene("grid6", device)
    t = st.num_triangles
    slices = {"many_clusters": tuple((k, k + 1) for k in range(t)),
              "wide_cluster": ((0, 300), (300, t))}.get(edge)
    return dataclasses.replace(st, cluster_slices=slices) if slices else st


def _sweep_edge_case(edge, device):
    """(pack, state8) of one edge case of the cluster sweep: 64x64 bands of
    the wavefront2 renderer on dragon_grid(6), 8 tiles of 512."""
    from rtm_tpu_torch.ops.kernels.megakernel import build_mega_pack
    from rtm_tpu_torch.ops.kernels.sweep_kernel import sweep_candidates_plain

    st = _edge_scene(edge, device)
    pack = build_mega_pack(st)
    bands = _bands(st, res=64, bounces=2, sort_from=1)
    state8 = (bands[1] if edge == "dead_tail" else bands[0]).clone()
    alive = state8[6]
    if edge == "dead_tail":
        # the sorted band's last three tiles dead, and tile 4 down to one
        # alive ray that enters a box
        enters = sweep_candidates_plain(pack, state8, 1).any(dim=1)
        one = int(enters.nonzero()[0, 0])
        state8[:, 4 * 512] = state8[:, one]
        alive[4 * 512 + 1:] = 0.0
    elif edge == "no_box":
        # even tiles: every ray far out on +x+y+z, heading further out
        for tile in range(0, 8, 2):
            lanes = slice(tile * 512, (tile + 1) * 512)
            state8[0:3, lanes] += 1e4
            state8[3:6, lanes] = state8[3:6, lanes].abs()
    elif edge == "nan_rays":
        # every 7th alive ray NaN in its origin or its direction; tile 3's
        # only alive ray NaN
        nan = float("nan")
        state8[0, 0::14] = nan
        state8[4, 7::14] = nan
        alive[3 * 512:4 * 512] = 0.0
        alive[3 * 512 + 9] = 1.0
        state8[2, 3 * 512 + 9] = nan
    return pack, state8


@pytest.mark.parametrize("edge", PREFILTER_EDGES)
def test_cluster_sweep_prefilter_edges_bitwise(cuda, edge):
    from rtm_tpu_torch.ops.kernels import sweep_kernel as sk

    pack, state8 = _sweep_edge_case(edge, cuda)
    assert state8.shape == (8, 8 * 512)
    cand = sk.sweep_candidates_plain(pack, state8)
    before = sk.cluster_sweep.launches
    t, i, passes = sk.cluster_sweep(pack, state8)
    assert sk.cluster_sweep.launches == before + 1
    pt, pi, pp, passed = sk.cluster_sweep_plain(
        pack.tri_feats, pack.boxes, pack.cluster_offsets,
        pack.cluster_widths, state8, with_passed=True)
    torch.cuda.synchronize()
    assert torch.equal(t, pt) and torch.equal(i, pi)
    assert torch.equal(passes, pp)
    assert not bool((passed & ~cand).any())
    tile_alive = (state8[6] > 0.5).view(8, 512).any(dim=1)
    if edge == "dead_tail":
        assert not bool(tile_alive[5:].any())
        assert int((state8[6, 4 * 512:5 * 512] > 0.5).sum()) == 1
        assert int(passes[4]) >= 1 and int(passes[5:].sum()) == 0
    if edge == "many_clusters":
        assert pack.n_clusters > 512
        assert bool(passed[:, 512:].any())
    if edge == "wide_cluster":
        assert max(pack.cluster_widths) > 128 and int(passes.sum()) > 0
    if edge == "no_box":
        assert not bool(cand[0::2].any()) and int(passes[0::2].sum()) == 0
        assert bool((t[:512] == sk.BIG).all())
    if edge == "nan_rays":
        assert bool(tile_alive[3]) and not bool(cand[3].any())
        assert int(passes[3]) == 0 and int(passes.sum()) > 0


def _mega_edge_case(edge, device):
    """(scene, pack, camf, cfg, pixel offset, slots) of one edge case of
    the megakernel on dragon_grid(6), 64x64, 4 bounces."""
    from rtm_tpu_torch.ops.kernels.megakernel import build_mega_pack

    st = _edge_scene(edge, device)
    cam = rtm_tpu_torch.Camera()
    if edge == "no_box":
        cam.direction = np.array([0.0, 0.0, 1.0])     # away from the grid
    if edge == "nan_rays":
        # a NaN shading normal on every 5th triangle: the rays that hit one
        # scatter into a NaN ray for the next bounce
        nrm = st.tri_normal.clone()
        nrm[0::5] = float("nan")
        st = dataclasses.replace(st, tri_normal=nrm)
    w = h = 64
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=4,
                                     draw_environment=True)
    camf = _pack_camera(cam.spec(w, h), device)
    # dead_tail: a window whose last tile holds one slot
    n = 3 * 512 + 1 if edge == "dead_tail" else w * h
    return st, build_mega_pack(st), camf, cfg, 1024 if edge == "dead_tail" \
        else 0, n


@pytest.mark.parametrize("edge", PREFILTER_EDGES)
def test_mega_prefilter_edges_bitwise(cuda, edge):
    from rtm_tpu_torch.ops.kernels import megakernel as mk

    st, pack, camf, cfg, pix0, n = _mega_edge_case(edge, cuda)
    before = mk.mega_trace.launches
    k = mk.mega_trace(st, pack, camf, 1, pix0, n, cfg, with_stats=True)
    assert mk.mega_trace.launches == before + 1
    p = mk.mega_trace_plain(st, pack, camf, 1, pix0, n, cfg,
                            with_stats=True)
    torch.cuda.synchronize()
    for a, b in zip(k[:3], p[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0.0, atol=0.0,
                                       equal_nan=True)
    assert torch.equal(k[3].passes, p[3].passes)
    assert torch.equal(k[3].winners, p[3].winners)
    if edge == "dead_tail":
        assert k[3].passes.shape[1] == 4
        assert int(p[3].alive[0, 3 * 512:].sum()) == 1
    if edge == "many_clusters":
        assert pack.n_clusters > 512 and bool(p[3].passed[..., 512:].any())
    if edge == "wide_cluster":
        assert max(pack.cluster_widths) > 128
    if edge == "no_box":
        assert int(k[3].passes.sum()) == 0
    if edge == "nan_rays":
        assert bool(torch.isnan(p[1]).any())
    if edge != "no_box":
        assert int(k[3].passes.sum()) > 0


# ---------------------------------------------------------------------------
# The dense post-pass kernel (csrc/postpass.cu) against mega_postpass_dense
# run by PyTorch on the card
# ---------------------------------------------------------------------------

POSTPASS_SUN_RTOL = 2e-4
# name: (slots, frames, bounces, extra columns past n in miss and rec)
POSTPASS_SHAPES = {
    "one_slot": (1, 1, 1, 0),
    "f4_b8": (1000, 4, 8, 0),
    "f3_b3_wide_rows": (700, 3, 3, 37),
    "f1_b8": (513, 1, 8, 0),
}


def _postpass_pair(scene, color, miss, rec, cfg, n):
    """(kernel, plain) on the same inputs; the kernel launched once."""
    from rtm_tpu_torch.ops.kernels import megakernel as mk

    before = mk.mega_postpass.launches
    got = mk.mega_postpass(color, miss, rec, scene, cfg, n)
    assert mk.mega_postpass.launches == before + 1
    want = mk.mega_postpass_dense(color, miss, rec, scene, cfg, n)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("draw", [True, False], ids=["env", "no_env"])
@pytest.mark.parametrize("shape", list(POSTPASS_SHAPES))
@pytest.mark.parametrize("variant", list(POSTPASS_VARIANTS))
def test_postpass_kernel_matches_plain(cuda, variant, shape, draw):
    n, frames, bounces, pad = POSTPASS_SHAPES[shape]
    st = variant_scene(variant, cuda)
    color, miss, rec = (torch.from_numpy(a).to(cuda) for a in records(
        n + frames * 10 + bounces, n, bounces, frames, pad, near_sun=0.2))
    color = color.T.contiguous().T        # a tracing kernel's (3, n) rows
    cfg = rtm_tpu_torch.RenderConfig(width=n, height=1, max_bounces=bounces,
                                     max_frames=frames,
                                     draw_environment=draw)
    got, want = _postpass_pair(st, color, miss,
                               rec if st.any_textured else None, cfg, n)
    assert got.shape == (n, 3) and bool(torch.isfinite(got).all())
    if st.env_sun and draw:
        # the plain version's sun dot product is cuBLAS's mv, summed in
        # another order than the kernel's, and pow(., 500) * 100 takes its
        # last-place error 500-fold: up to 5.9e-5 relative on an H100
        torch.testing.assert_close(got, want, rtol=POSTPASS_SUN_RTOL,
                                   atol=1e-6)
    else:
        torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("sid", [2, 3])
def test_postpass_kernel_on_traced_records(cuda, sid):
    """The kernel against the plain version on the mxu kernel's records of
    a 4-sample, 8-bounce 64x64 dispatch."""
    st = _scene(sid, cuda)
    cfg = rtm_tpu_torch.RenderConfig(width=64, height=64, max_bounces=8,
                                     max_frames=4, draw_environment=True)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(64, 64), cuda)
    n = 64 * 64
    color, miss, rec, _ = tmk.mxu_trace(st, tmk.side_tables(st), camf, 3, 0,
                                        n, cfg)
    got, want = _postpass_pair(st, color.T, miss, rec, cfg, n)
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


def test_postpass_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from rtm_tpu_torch.ops.kernels import megakernel as mk

    st = variant_scene("tex", cuda)
    color, miss, rec = (torch.from_numpy(a).to(cuda) for a in records(5))
    cfg = rtm_tpu_torch.RenderConfig(width=32, height=16, max_bounces=4,
                                     max_frames=2)
    n = color.shape[0]
    for args in ((color, miss.T.contiguous().T, rec),     # strided rows
                 (color, miss, rec.cpu()),
                 (color.half(), miss, rec)):
        with pytest.raises(ValueError, match="mega_postpass"):
            mk.mega_postpass(*args, st, cfg, n)


# ---------------------------------------------------------------------------
# The replay gather's backward (csrc/row_grad.cu) against row_grad_plain run
# by PyTorch on the card
# ---------------------------------------------------------------------------

# name: (lanes, rows): the fit cell's 512x512 lanes over its 35 rows (34
# triangles and the miss row); the
# mxu tables' limit (2,047 triangles, 128 spheres, the miss row: 2,176 rows,
# several row tiles); a tail chunk shorter than the rest
ROW_GRAD_SHAPES = {
    "fit_35": (512 * 512, 35),
    "mxu_limit_2176": (512 * 512, 2176),
    "tail_41": (5003, 41),
}


def _row_grad_inputs(n, rows, device, seed=0):
    """(grad (n, 40) f32, idx (n,) i64): most lanes on a few rows, as a
    bounce's hits fall, the rest spread over the table."""
    rng = np.random.default_rng(seed)
    idx = np.where(rng.random(n) < 0.8, rng.integers(0, min(rows, 6), n),
                   rng.integers(0, rows, n))
    g = rng.standard_normal((n, 40)).astype(np.float32)
    return (torch.from_numpy(g).to(device),
            torch.from_numpy(idx.astype(np.int64)).to(device))


@pytest.mark.parametrize("shape", list(ROW_GRAD_SHAPES))
def test_row_grad_kernel_matches_plain(cuda, shape):
    """Bitwise the plain version, and bitwise itself over two runs."""
    from rtm_tpu_torch.ops.kernels import row_grad as rg

    n, rows = ROW_GRAD_SHAPES[shape]
    g, idx = _row_grad_inputs(n, rows, cuda)
    before = rg.row_grad.launches
    got = rg.row_grad(g, idx, rows)
    again = rg.row_grad(g, idx, rows)
    assert rg.row_grad.launches == before + 2
    want = rg.row_grad_plain(g, idx, rows)
    torch.cuda.synchronize()
    assert got.shape == (rows, 40) and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0)


def test_row_grad_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from rtm_tpu_torch.ops.kernels import row_grad as rg

    g, idx = _row_grad_inputs(100, 41, cuda)
    for args in ((g.double(), idx, 41),                  # dtype
                 (g.T.contiguous().T, idx, 41),          # strided rows
                 (g, idx, 0), (g, idx, rg.MAX_ROWS + 1),  # rows
                 (g, idx.cpu(), 41), (g.cpu(), idx, 41),  # devices
                 (g, idx.int(), 41)):
        with pytest.raises(ValueError, match="row_grad"):
            rg.row_grad(*args)


@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
def test_replay_backward_runs_the_row_grad_kernel(cuda, remat):
    """One mxu replay backward launches csrc/row_grad.cu once per frame
    and bounce (recomputing each bounce in the backward launches no more)."""
    from rtm_tpu_torch.diff import extract_params, loss_and_grad
    from rtm_tpu_torch.ops.kernels import row_grad as rg

    w, h = 24, 20
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=3,
                                     max_frames=2, draw_environment=True)
    st = _grad_rig(cuda)
    before = rg.row_grad.launches
    _, g = loss_and_grad(extract_params(st), st,
                         rtm_tpu_torch.Camera().spec(w, h),
                         torch.zeros((h, w, 3), device=cuda), 1, cfg,
                         backend="mxu", remat=remat)
    torch.cuda.synchronize()
    assert rg.row_grad.launches == before + cfg.max_frames * cfg.max_bounces
    assert bool(torch.isfinite(g.albedo).all())
    assert float(g.albedo.abs().max()) > 0.0
