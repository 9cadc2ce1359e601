"""rtm_tpu_torch's megakernel path against rtm_tpu's on the CPU: the scene
tables, the plain version `mega_trace_plain` (what the CUDA kernel is held
to on the card) against rtm_tpu's kernel in Pallas interpret mode, the
images of both packages, the dispatch chain for a textured mesh beyond the
mxu and trav tables, slot bands, the flat preview and the gradient route.

rtm_tpu's raw kernel outputs are taken where `render_rays_megakernel`
hands them to `mega_postpass` (monkeypatched inside the test; the real
post-pass still runs, so the same call gives rtm_tpu's image).

Tolerances.  rtm_tpu orders candidate hits by an approximate reciprocal (a
bf16 one in interpret mode), the port by the exact tdet / max(det, eps),
so a winner may flip where two candidates lie within that rounding
(rtm_tpu's own test allows 0.3% outlier pixels on scene 3,
tests/test_megakernel.py).  XLA's rsqrt, sin and cos differ from
PyTorch's in the last place.  So: color and miss within 1e-5 on >= 99.7%
of lanes; the texture records on the records of rays alive at that bounce
within rtol 5e-4 / atol 1e-4 (grazing hits magnify a few ulp in uv) on
>= 99.7% of them.  Records of dead rays are not compared: rtm_tpu's dead
lanes sweep with whatever tile they share, and the port's tail slots and
all-dead tiles differ there (ROADMAP.md queue 3); no consumer reads them.
"""
from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from conftest import images_close
from rtm_tpu.ops.pallas import megakernel as jmk
from rtm_tpu.ops.trace_ref import render_dispatch as j_render_dispatch
from rtm_tpu_torch.ops.kernels import megakernel as tmk
from test_torch_parity import carry, host_scene, jax_scene

LANES_MIN = 0.997

# name: (scene, width, height, bounces, frames, frame_index, cull, order)
CASES = {
    "scene1": (1, 16, 16, 4, 1, 1, True, "static"),
    "scene2_3frames": (2, 16, 16, 3, 3, 7, True, "static"),
    "scene3": (3, 16, 16, 8, 1, 1, True, "static"),
    "scene5": (5, 16, 16, 3, 1, 1, True, "static"),
    "scene1_tail": (1, 24, 20, 3, 1, 1, True, "static"),
    "scene3_nocull": (3, 16, 16, 3, 1, 1, False, "static"),
    "grid7_near": ("grid7", 16, 16, 4, 1, 1, True, "near"),
}


def _cfgs(case):
    _, w, h, bounces, frames, _, _, _ = case
    kw = dict(width=w, height=h, max_bounces=bounces, max_frames=frames,
              draw_environment=True)
    return rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)


def _jax_run(sj, case):
    """rtm_tpu's render_megakernel in interpret mode: (color (3, N), miss,
    rec or None) as the kernel wrote them, and the image."""
    _, w, h, _, _, fi, cull, order = case
    jcfg, _ = _cfgs(case)
    got = {}
    postpass = jmk.mega_postpass

    def capture(color, miss, rec, scene, cfg, n):
        got["raw"] = (np.asarray(color).T, np.asarray(miss)[:, :n],
                      None if rec is None else np.asarray(rec)[:, :n])
        return postpass(color, miss, rec, scene, cfg, n)

    with mock.patch.object(jmk, "mega_postpass", capture):
        img = jmk.render_megakernel(sj, rtm_tpu.Camera().spec(w, h),
                                    jnp.uint32(fi), jcfg, cull=cull,
                                    interpret=True, order=order)
    return got["raw"], np.asarray(img)


def _port_raw(st, case):
    _, w, h, _, _, fi, cull, order = case
    _, tcfg = _cfgs(case)
    camf = tmk._pack_camera(rtm_tpu_torch.Camera().spec(w, h))
    out = tmk.mega_trace_plain(st, tmk.build_mega_pack(st), camf, fi, 0,
                               w * h, tcfg, cull=cull, order=order,
                               with_stats=True)
    return out


@pytest.fixture(scope="module")
def runs():
    """Per case: (rtm_tpu raw outputs, rtm_tpu image, the port's scene,
    the port's plain outputs with stats), computed once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            case = CASES[name]
            sj = jax_scene(case[0])
            raw, img = _jax_run(sj, case)
            st = carry(sj)
            cache[name] = (raw, img, st, _port_raw(st, case))
        return cache[name]

    return get


# ---------------------------------------------------------------------------
# (a) tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sid", [1, 2, 3, 4, 5, "grid2", "grid7"])
def test_mega_pack_tables_bitwise(sid):
    """The f32 attribute table is bitwise rtm_tpu's (a0 + a1) + a2 (what
    its three one-hot bf16 products sum to); features, boxes, spheres,
    layout and padded_to_real are bitwise equal."""
    sj = jax_scene(sid)
    jp = jmk.build_mega_pack(sj)
    tp = tmk.build_mega_pack(carry(sj))
    assert tp.n_clusters == jp.n_clusters
    assert tp.n_spheres_padded == jp.n_spheres_padded
    assert tp.cluster_offsets == jp.cluster_offsets
    assert tp.cluster_widths == jp.cluster_widths
    if jp.n_clusters:
        split = np.asarray(jp.tri_attrs).astype(np.float32)
        want = (split[0] + split[1]) + split[2]                 # (40, T')
        np.testing.assert_array_equal(tp.tri_attrs.numpy(), want.T)
        np.testing.assert_array_equal(tp.tri_feats.numpy(),
                                      np.asarray(jp.tri_feats))
        np.testing.assert_array_equal(tp.boxes.numpy(), np.asarray(jp.boxes))
        np.testing.assert_array_equal(tp.padded_to_real.numpy(),
                                      np.asarray(jp.padded_to_real))
        np.testing.assert_array_equal(tp.widths_dev.numpy(),
                                      np.asarray(jp.cluster_widths))
    else:
        assert tp.tri_attrs is None and jp.tri_attrs is None
    if jp.n_spheres_padded:
        np.testing.assert_array_equal(tp.spheres.numpy(),
                                      np.asarray(jp.spheres).T)
    else:
        assert tp.spheres is None and jp.spheres is None


# ---------------------------------------------------------------------------
# (b) raw outputs and (c) images against rtm_tpu's interpret-mode kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel(runs, name):
    (jc, jm, jr), _, _, (tc, tm, tr, stats) = runs(name)
    _, w, h, bounces, frames, _, _, _ = CASES[name]
    n = w * h
    assert tc.shape == (3, n) and tm.shape == jm.shape == (8 * frames, n)
    assert (tr is None) == (jr is None)
    close = lambda a, b: np.abs(a - b).max(axis=0) <= 1e-5  # noqa: E731
    assert close(tc.numpy(), jc[:3]).mean() >= LANES_MIN
    assert close(tm.numpy(), jm).mean() >= LANES_MIN
    if tr is not None:
        assert tr.shape == jr.shape == (8 * frames * bounces, n)
        live = np.repeat(stats.alive.numpy(), 8, axis=0)
        ok = np.isclose(tr.numpy(), jr, rtol=5e-4, atol=1e-4)
        assert ok[live].mean() >= LANES_MIN


@pytest.mark.parametrize("name", list(CASES))
def test_images_match_jax_megakernel(runs, name):
    """render_dispatch(backend="megakernel") against rtm_tpu's
    interpret-mode megakernel frame, by images_close."""
    _, jimg, st, _ = runs(name)
    _, w, h, _, _, fi, cull, order = CASES[name]
    _, tcfg = _cfgs(CASES[name])
    cam = rtm_tpu_torch.Camera().spec(w, h)
    if cull and order == "static":
        img = rtm_tpu_torch.render_dispatch(st, cam, fi, tcfg,
                                            backend="megakernel")
    else:
        img = tmk.render_megakernel(st, cam, fi, tcfg, cull=cull,
                                    order=order)
    assert img.shape == (h, w, 3) and torch.isfinite(img).all()
    images_close(img.numpy(), jimg)


def test_cluster_passes_and_orders(runs):
    """Per tile-bounce passes: a scene without triangles sweeps nothing, the
    cull never sweeps more clusters than cull=False, and the nearest-first
    order never more than the static one."""
    stats = {name: runs(name)[3][3] for name in
             ("scene1", "scene3", "scene3_nocull", "grid7_near")}
    assert not stats["scene1"].passes.any()
    assert (stats["scene3"].passes[:3] <= stats["scene3_nocull"].passes).all()
    st = runs("grid7_near")[2]
    static = _port_raw(st, CASES["grid7_near"][:7] + ("static",))
    near = stats["grid7_near"]
    assert int(near.passes.sum()) <= int(static[3].passes.sum())
    for a, b in zip(static[:2], runs("grid7_near")[3][:2]):    # color, miss
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# (d) the dispatch chain for a textured mesh beyond the mxu and trav tables
# ---------------------------------------------------------------------------

def _textured_grid(pkg):
    """dragon_grid(7) with material 0 given scene 3's texture: 980
    textured triangles, beyond the mxu and trav tables' 128."""
    s = host_scene(pkg.models.scenes, "grid7")
    s3 = pkg.models.scenes.load_scene(3)
    s.textures = list(s3.textures)
    s.materials[0].texture_id = 0
    return s


def test_textured_mesh_beyond_the_tables_renders_through_megakernel():
    from rtm_tpu.accel.native import bvh_native

    mp = pytest.MonkeyPatch()
    mp.setattr(bvh_native, "build", lambda mesh: None)
    try:
        sj = rtm_tpu.build_tracer_scene(_textured_grid(rtm_tpu))
    finally:
        mp.undo()
    res, fi = 16, 2
    kw = dict(width=res, height=res, max_bounces=3, draw_environment=True)
    assert not sj.mxu_meta.supported and not sj.trav_meta.supported
    assert jmk.megakernel_fits(sj)
    want = np.asarray(j_render_dispatch(sj, rtm_tpu.Camera().spec(res, res),
                                        jnp.uint32(fi),
                                        rtm_tpu.RenderConfig(**kw),
                                        backend="mxu_interpret"))
    st = carry(sj)
    assert st.any_textured and st.num_triangles == 980
    calls = []
    real = tmk.render_megakernel

    def record(*a, **k):
        calls.append(a)
        return real(*a, **k)

    with mock.patch.object(tmk, "render_megakernel", record):
        got = rtm_tpu_torch.render_dispatch(
            st, rtm_tpu_torch.Camera().spec(res, res), fi,
            rtm_tpu_torch.RenderConfig(**kw), backend="mxu")
    assert len(calls) == 1
    images_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# (e) slot bands, (f) the flat preview and the gradient route
# ---------------------------------------------------------------------------

def test_slot_bands_equal_the_full_frame():
    """render_rays_megakernel over 4 pixel_offset bands, concatenated,
    equals the full frame's slots (alive-lane winners do not depend on the
    tile; the post-pass may take the dense or the compact form per band,
    which sum in another order)."""
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(2),
                                          device="cpu")
    res = 16
    cfg = rtm_tpu_torch.RenderConfig(width=res, height=res, max_bounces=3,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(res, res)
    full = tmk.render_rays_megakernel(st, cam, 3, cfg, 0, res * res)
    band = res * res // 4
    parts = [tmk.render_rays_megakernel(st, cam, 3, cfg, k * band, band)
             for k in range(4)]
    torch.testing.assert_close(torch.cat(parts), full, rtol=1e-6, atol=1e-6)
    assert torch.equal(tmk.slots_to_image(full, res, res),
                       tmk.render_megakernel(st, cam, 3, cfg))


def test_flat_preview_is_the_xla_image():
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(3),
                                          device="cpu")
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=1,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(16, 16)
    mk = rtm_tpu_torch.render_dispatch(st, cam, 1, cfg, backend="megakernel")
    xla = rtm_tpu_torch.render_dispatch(st, cam, 1, cfg, backend="xla")
    assert torch.equal(mk, xla)


def test_megakernel_route_has_no_gradient():
    """rtm_tpu's pallas_call carries no VJP, so jax.grad through its
    megakernel route raises; the port's loss_and_grad raises too, and the
    loss it renders has no graph to differentiate."""
    from rtm_tpu.diff.inverse import render_loss as j_render_loss
    from rtm_tpu.diff.params import extract_params as j_extract_params

    res = 16
    kw = dict(width=res, height=res, max_bounces=2, draw_environment=True)
    sj = jax_scene(3)
    with pytest.raises(Exception):
        jax.grad(lambda p: j_render_loss(
            p, sj, rtm_tpu.Camera().spec(res, res),
            jnp.zeros((res, res, 3)), jnp.uint32(1),
            rtm_tpu.RenderConfig(**kw), backend="megakernel_interpret"))(
                j_extract_params(sj))
    st = carry(sj)
    cam = rtm_tpu_torch.Camera().spec(res, res)
    cfg = rtm_tpu_torch.RenderConfig(**kw)
    target = torch.zeros((res, res, 3))
    params = rtm_tpu_torch.extract_params(st).map(
        lambda t: t.detach().requires_grad_(True))
    loss = rtm_tpu_torch.render_loss(params, st, cam, target, 1, cfg,
                                     backend="megakernel")
    assert torch.isfinite(loss) and not loss.requires_grad
    with pytest.raises(RuntimeError):
        torch.autograd.grad(loss, params.tensors())
    with pytest.raises(ValueError, match="no gradient"):
        rtm_tpu_torch.loss_and_grad(params, st, cam, target, 1, cfg,
                                    backend="megakernel")


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(2),
                                          device="cpu")
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3)
    camf = tmk._pack_camera(rtm_tpu_torch.Camera().spec(16, 16))
    pack = tmk.build_mega_pack(st)
    before = tmk.mega_trace.launches
    a = tmk.mega_trace(st, pack, camf, 2, 0, 256, cfg, with_stats=True)
    b = tmk.mega_trace_plain(st, pack, camf, 2, 0, 256, cfg, with_stats=True)
    assert tmk.mega_trace.launches == before
    for x, y in zip(a[:3] + a[3], b[:3] + b[3]):
        assert torch.equal(x, y)
    w = b[3].winners
    assert (w >= 0).any() and (w <= -2).any() and (w == -1).any()
    assert not (w[~b[3].alive] != -1).any()
    with pytest.raises(ValueError, match="order"):
        tmk.mega_trace(st, pack, camf, 2, 0, 256, cfg, order="far")
    with pytest.raises(ValueError, match="scene on"):
        tmk.mega_trace(st, pack, camf.to("meta"), 2, 0, 256, cfg)


def test_megakernel_fits_the_device_not_the_v5e_vmem():
    """The port bounds the dispatch by the device's memory: a scene that
    rtm_tpu's 115 MiB VMEM bound sends to wavefront2 (62,720 triangles at
    ~2.4 KB each) fits; an absurd frame does not, and render_dispatch then
    falls back to wavefront2 with a warning."""
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(3),
                                          device="cpu")
    cfg = rtm_tpu_torch.RenderConfig(width=512, height=512, max_bounces=8)
    assert tmk.megakernel_fits(st, cfg)
    huge = cfg.replace(width=1 << 20, height=1 << 20)
    assert not tmk.megakernel_fits(st, huge)
    small = cfg.replace(width=16, height=16, max_bounces=2)
    with mock.patch.object(tmk, "megakernel_fits", lambda s, c: False):
        with pytest.warns(UserWarning, match="wavefront2"):
            got = rtm_tpu_torch.render_dispatch(
                st, rtm_tpu_torch.Camera().spec(16, 16), 1, small,
                backend="megakernel")
    want = rtm_tpu_torch.render_dispatch(
        st, rtm_tpu_torch.Camera().spec(16, 16), 1, small,
        backend="wavefront2")
    assert torch.equal(got, want)
