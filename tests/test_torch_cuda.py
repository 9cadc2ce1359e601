"""The CUDA kernels of rtm_tpu_torch against their plain versions, on the
card.  Marked `cuda`; each test skips when no CUDA device is present.

The file imports neither JAX nor rtm_tpu nor tests/conftest.py, so it runs
on a machine that has PyTorch with CUDA and nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: the kernel's pair test is per-thread FP32 against the f32 rows
(hi + lo), the plain version's the bf16x3 product that drops lo x lo, so a
ray through an edge two triangles share may pick the other one: hitrec
must agree on >= 99.9% of records.  Scene 3's walls are such pairs, and
the share of rays near their edges falls as the resolution grows, so
scene 3 runs at 64x64, the size chip_smoke.py holds to the same bound
(0.9985 of records agreed at 32x32 on an H100).  On the lanes whose
records all agree, both sides round op by op alike (the kernels are built
with --fmad=false), so color / miss / rec agree to 1e-3 absolute (the
transcendentals are the only operations that may differ in the last
place).
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
}
# name: (case, first slot, slots) of a dispatch window
WINDOWS = {
    "scene3": ("scene3", 1000, 1500),
    "scene2_tail_2frames": ("scene2_tail_2frames", 100, 300),
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
