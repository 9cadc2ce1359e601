"""rtm_tpu_torch's XLA-style path against rtm_tpu's on the CPU: the full
u32 -> f32 draws, the sphere and triangle sweeps, the intersect kernel's
plain version, and the reference renderer's frames (`backend="xla"` and
`"pallas"`, and the max_bounces == 1 flat-shade preview).

Inputs come from NumPy seeds.  Tolerances:
  * RNG: `fast_random`, `fast_random3`, `random_unit_sphere` and
    `pixel_seed` are bitwise.  `random_circle_point` is held to 2 ulp:
    XLA's CPU sqrt, cos and sin are not correctly rounded and differ from
    PyTorch's in the last place on ~5% of values.
  * Sweeps: the winning index on >= 99.9% of rays, t within rtol 1e-5
    where the winners agree.
  * Frames: `images_close` (tests/conftest.py).  rtm_tpu's `pallas`
    backend has no autodiff rule and its kernel runs in interpret mode
    only inside its own tests, so the port's `pallas` frame is held
    against rtm_tpu's `xla` frame, the same function by a chunked sweep.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.ops import intersect as jint
from rtm_tpu.ops import rng as jrng
from rtm_tpu.ops.pallas import intersect_kernel as jik
from rtm_tpu.ops.trace_ref import render_dispatch as j_render_dispatch
from rtm_tpu_torch.models import scenes as tscenes
from rtm_tpu_torch.ops import intersect as tint
from rtm_tpu_torch.ops import rng as trng
from rtm_tpu_torch.ops.kernels import intersect_kernel as tik
from test_torch_parity import carry, jax_scene

AGREE_MIN = 0.999


def _seeds(seed: int, n: int = 4096) -> np.ndarray:
    s = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)
    s[:6] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]
    return s.astype(np.uint32)


def _t(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("fn", ["fast_random", "fast_random3",
                                "random_unit_sphere"])
def test_xla_draws_bitwise(fn):
    """The full u32 -> f32 conversion (int64 -> f32 rounds to nearest, as
    JAX's u32 cast does, for values >= 2^24 too) and the advanced seed,
    over a chain of draws."""
    s = _seeds(7)
    js, ts = jnp.asarray(s), _t(s)
    for _ in range(4):
        jv, js = getattr(jrng, fn)(js)
        tv, ts = getattr(trng, fn)(ts)
        assert tv.dtype == torch.float32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))


def test_random_circle_point_within_two_ulp():
    s = _seeds(8)
    jv, js = jrng.random_circle_point(jnp.asarray(s))
    tv, ts = trng.random_circle_point(_t(s))
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))
    want = np.asarray(jv)
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(tv.numpy() - want) <= 2 * ulp)
    assert float(torch.linalg.norm(tv, dim=-1).max()) <= 1.0 + 1e-6


def test_pixel_seed_bitwise():
    w, h = 640, 480
    lin = np.arange(0, w * h, 37)
    x, y = lin % w, lin // w
    for frame, fi in ((1, 1), (2, 77), (5, 2 ** 31 + 11)):
        want = jrng.pixel_seed(jnp.asarray(x, jnp.int32),
                               jnp.asarray(y, jnp.int32), w, frame,
                               jnp.uint32(fi))
        got = trng.pixel_seed(torch.from_numpy(x), torch.from_numpy(y), w,
                              frame, fi)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


def _rays(sid, n=2048, seed=0):
    """n rays through scene `sid`: half from the camera toward the scene,
    half from random points inside its bounds in random directions."""
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(sid),
                                          device="cpu")
    rs = np.random.default_rng(seed)
    pts = [st.tri_wa.numpy(), st.sph_pos.numpy()]
    pts = np.concatenate([p for p in pts if len(p)])
    lo, hi = pts.min(0), pts.max(0)
    lo, hi = np.maximum(lo, -8.0), np.minimum(hi, 8.0)
    o = np.empty((n, 3), np.float32)
    o[: n // 2] = np.array([0.0, 1.0, 5.0]) + rs.normal(0, 0.05, (n // 2, 3))
    o[n // 2:] = rs.uniform(lo, hi, (n - n // 2, 3))
    d = rs.normal(size=(n, 3))
    d[: n // 2, 2] = -np.abs(d[: n // 2, 2]) - 2.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return st, o, d


@pytest.mark.parametrize("sid", [1, 2, 3])
def test_nearest_sphere_and_triangle_match(sid):
    st, o, d = _rays(sid)
    sj = jax_scene(sid)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), \
        torch.from_numpy(d)
    # sphere t cancels -b against sqrt(delta): on scene 1's r = 1e4 walls
    # both are ~2e4, and one ulp of XLA's sqrt (not correctly rounded) is
    # ~1e-3 in t, hence the absolute term for spheres only
    pairs = [(jint.nearest_sphere(jo, jd, sj.sph_pos, sj.sph_radius),
              tint.nearest_sphere(to, td, st.sph_pos, st.sph_radius), 2e-3)]
    if not st.num_spheres:
        assert (pairs[0][1][1] == -1).all()
        pairs = []
    if st.num_triangles:
        jf = jint.TriFeatures.build(sj.tri_wa, sj.tri_wb, sj.tri_wc)
        tf = tint.TriFeatures.build(st.tri_wa, st.tri_wb, st.tri_wc)
        pairs.append((jint.nearest_triangle(jo, jd, jf, chunk=16),
                      tint.nearest_triangle(to, td, tf, chunk=16), 0.0))
    for (jt, ji), (tt, ti), atol in pairs:
        ji, jt = np.asarray(ji), np.asarray(jt)
        same = ti.numpy() == ji
        assert same.mean() >= AGREE_MIN
        assert (ji >= 0).any()
        np.testing.assert_allclose(tt.numpy()[same], jt[same], rtol=1e-5,
                                   atol=atol)


@pytest.mark.parametrize("sid", [2, 3])
def test_intersect_plain_matches_pallas_interpret(sid):
    """The kernel's plain version against rtm_tpu's intersect kernel in
    interpret mode: same packed features, same winners and distances."""
    st, o, d = _rays(sid, n=600, seed=sid)
    sj = jax_scene(sid)
    jt, ji = jik.nearest_triangle_pallas(jnp.asarray(o), jnp.asarray(d),
                                         sj.tri_wa, sj.tri_wb, sj.tri_wc,
                                         interpret=True)
    before = tik.intersect_sweep.launches
    tt, ti = tik.nearest_triangle_pallas(torch.from_numpy(o),
                                         torch.from_numpy(d), st.tri_wa,
                                         st.tri_wb, st.tri_wc)
    assert tik.intersect_sweep.launches == before     # CPU: plain version
    ji = np.asarray(ji)
    same = ti.numpy() == ji
    assert same.mean() >= AGREE_MIN and (ji >= 0).mean() > 0.2
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(jt)[same],
                               rtol=1e-5)
    jf, jlo, jhi, jc = jik.pack_triangle_features(sj.tri_wa, sj.tri_wb,
                                                  sj.tri_wc)
    tf, tlo, thi, tc = tik.pack_triangle_features(st.tri_wa, st.tri_wb,
                                                  st.tri_wc)
    assert tc == jc
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-6)


def test_intersect_plain_cull_is_tile_uniform():
    """With the cull the plain version visits fewer clusters per tile than
    without, and finds the same winners: two 256-ray tiles of narrow
    camera-ray cones, each aimed at one dragon of a 4x4 grid."""
    st = rtm_tpu_torch.build_tracer_scene(tscenes.dragon_grid(4),
                                          device="cpu")
    rs = np.random.default_rng(4)
    o = np.tile(np.float32([0.0, 1.0, 5.0]), (512, 1))
    aim = np.repeat(np.float32([[-3.75, 0.5, -4.0], [3.75, 0.5, -11.5]]),
                    256, axis=0)
    d = aim + rs.normal(0, 0.15, (512, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    feats, lo, hi, nc = tik.pack_triangle_features(st.tri_wa, st.tri_wb,
                                                   st.tri_wc)
    boxes = torch.cat([lo.T, hi.T, torch.zeros((2, nc))])
    rays = tik.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    t1, i1, p1 = tik.intersect_sweep(rays, feats, boxes, nc,
                                     return_passes=True)
    t0, i0, p0 = tik.intersect_sweep(rays, feats, boxes, nc, cull=False,
                                     return_passes=True)
    assert (p0 == nc).all() and (p1 < nc).all()
    assert (i1 == i0).float().mean() >= AGREE_MIN and (i1 >= 0).any()


def _edge_rays(n, seed):
    """(N, 3) origins and directions: random ones, then NaN, zero, inf and
    axis-aligned directions and NaN origins among them."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d[0:6] = axes
    d[6:12] = 0.0
    d[12:18, 0] = np.nan
    d[18:24] = np.nan
    d[24:30, 1] = np.inf
    o[30:36, 2] = np.nan
    d[36:48] = axes[rs.integers(0, 6, 12)]
    o[36:48, 0] = 0.0
    return torch.from_numpy(o), torch.from_numpy(d)


def test_padding_rows_never_pass_the_strict_gate():
    """The intersect kernel sweeps only a cluster's real rows: exact, since
    a padding row of pack_triangle_features has a zero normal, so det > eps
    fails for every ray (det is 0 or NaN).  Held on the plain version: a
    cluster of padding rows only gives no hit for any ray, and the sweep of
    the real rows (n_tris) equals the sweep of all 128 rows."""
    rs = np.random.default_rng(11)
    a = rs.uniform(-2.0, 2.0, (34, 3)).astype(np.float32)
    b = a + rs.normal(0, 0.8, (34, 3)).astype(np.float32)
    c = a + rs.normal(0, 0.8, (34, 3)).astype(np.float32)
    feats, lo, hi, nc = tik.pack_triangle_features(
        *(torch.from_numpy(x) for x in (a, b, c)))
    assert nc == 1 and not feats[:, 34:].any()
    boxes = torch.cat([lo.T, hi.T, torch.zeros((2, nc))])
    rays = tik.pack_rays(*_edge_rays(2048, 3))
    pad_only = feats[:, 34:35].expand(-1, 128).contiguous()
    t, i = tik.intersect_sweep_plain(rays, pad_only, boxes, 1, cull=False)
    assert (t == tint.FLT_MAX).all() and (i == -1).all()
    full = tik.intersect_sweep_plain(rays, feats, boxes, 1,
                                     return_passes=True)
    real = tik.intersect_sweep_plain(rays, feats, boxes, 1,
                                     return_passes=True, n_tris=34)
    assert (full[1] >= 0).any() and bool((full[1] < 34).all())
    for x, y in zip(full, real):
        assert torch.equal(x, y)


def _cfgs(res, bounces, spp=1):
    kw = dict(width=res, height=res, max_bounces=bounces, max_frames=spp,
              draw_environment=True)
    return rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)


@pytest.fixture(scope="module")
def xla_frames():
    """rtm_tpu's xla frames of scenes 1-4 at 16x16, 8 bounces, frame 1."""
    jcfg, _ = _cfgs(16, 8)
    cam = rtm_tpu.Camera().spec(16, 16)
    return {sid: np.asarray(j_render_dispatch(jax_scene(sid), cam,
                                              jnp.uint32(1), jcfg,
                                              backend="xla"))
            for sid in (1, 2, 3, 4)}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("sid", [1, 2, 3, 4])
def test_render_dispatch_matches_jax_xla(xla_frames, image_compare, sid,
                                         backend):
    _, tcfg = _cfgs(16, 8)
    st = carry(jax_scene(sid))
    got = rtm_tpu_torch.render_dispatch(
        st, rtm_tpu_torch.Camera().spec(16, 16), 1, tcfg, backend=backend)
    assert got.shape == (16, 16, 3) and torch.isfinite(got).all()
    image_compare(got.numpy(), xla_frames[sid])


@pytest.mark.parametrize("backend", ["auto", "mxu", "wavefront2", "pallas"])
def test_flat_shade_preview_matches_jax(image_compare, backend):
    """max_bounces == 1: every backend renders the flat-shade preview
    through the reference renderer, as in rtm_tpu."""
    jcfg, tcfg = _cfgs(16, 1)
    sj = jax_scene(3)
    jb = "xla" if backend in ("auto", "pallas") else backend
    want = np.asarray(j_render_dispatch(sj, rtm_tpu.Camera().spec(16, 16),
                                        jnp.uint32(3), jcfg, backend=jb))
    got = rtm_tpu_torch.render_dispatch(
        carry(sj), rtm_tpu_torch.Camera().spec(16, 16), 3, tcfg,
        backend=backend)
    assert float(got.mean()) > 0.0
    image_compare(got.numpy(), want)
