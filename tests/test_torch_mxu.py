"""rtm_tpu_torch's mxu kernel module vs rtm_tpu's, before the post-pass.

The port's plain version `mxu_trace_plain` (what the CUDA kernel is held
to on the card) runs against rtm_tpu's `render_rays_mxu` in Pallas
interpret mode, on the JAX scene carried into the port as NumPy arrays.
The JAX kernel's raw color / miss / rec rows are taken where
`render_rays_mxu` hands them to the post-pass.

Ordering.  The port orders candidate hits by tdet / det with an IEEE
division (its contract); the TPU kernel multiplies by an approximate
reciprocal, which interpret mode models as a bf16 reciprocal.  Two hits at
equal t (a ray through an edge two triangles share) can then pick
different winners.  The main comparison therefore runs the JAX kernel with
its reciprocal exact; `test_tpu_ordering_reciprocal` states the agreement
without that.

Tolerance.  hitrec must agree on >= 99.9% of records.  On the lanes whose
records all agree, color / miss / rec agree to rtol 5e-4, atol 1e-4: the
rays differ by a few ulp (XLA's rsqrt, cos and sin against PyTorch's), and
grazing hits far along scene 2's 100-unit ground plane magnify that in uv.
The remaining hitrec differences are rays through an edge two triangles
share, which the two sides' bf16x3 products (summed in another order)
split differently: scene 3's axis-aligned walls show about 3 in 4096.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.ops.pallas import mxu_kernel as jmk
from rtm_tpu_torch.ops.kernels import mxu_kernel as tmk
from rtm_tpu_torch.ops.kernels.megakernel import _pack_camera
from rtm_tpu_torch.models import scenes as tscenes
from test_torch_parity import carry, host_scene, jax_scene
from torch_mxu_cases import (EDGE_RAY, EDGE_TRI, HI, L, LO, MD,
                             N_TRIS_EDGES, TDET_RAY, TDET_TRI, W, frac_rays,
                             int_rays, int_tables, model_features, model_key,
                             model_nearest, model_split, nearest_culled,
                             table_scene)

# name: (scene, width, height, bounces, frames, frame_index)
CASES = {
    "scene1": (1, 32, 32, 4, 1, 1),
    "scene2": (2, 32, 32, 4, 1, 1),
    "scene3": (3, 32, 32, 4, 1, 1),
    "scene5": (5, 32, 32, 4, 1, 1),
    "grid2": ("grid2", 32, 32, 4, 1, 1),
    "scene2_2frames": (2, 24, 24, 3, 2, 5),
    "scene2_tail": (2, 24, 20, 3, 1, 1),
}
AGREE_MIN = 0.999


class _ExactReciprocal:
    """Stands in for rtm_tpu's `pallas` module inside mxu_kernel, with
    `reciprocal` exact whatever `approx` says."""

    def __getattr__(self, name):
        from jax.experimental import pallas
        return getattr(pallas, name)

    @staticmethod
    def reciprocal(x, approx=False):
        return 1.0 / x


def _jax_raw(sj, case, exact_order: bool):
    """rtm_tpu kernel outputs: (color (3,N), miss, rec or None, hitrec)."""
    _, w, h, bounces, frames, fi = case
    cfg = rtm_tpu.RenderConfig(width=w, height=h, max_bounces=bounces,
                               max_frames=frames, draw_environment=True)
    got = {}

    def capture(color, miss, rec, scene, cfg, n):
        got["miss"] = np.asarray(miss)[:, :n]
        got["rec"] = None if rec is None else np.asarray(rec)[:, :n]
        return color

    mp = pytest.MonkeyPatch()
    mp.setattr(jmk, "mega_postpass", capture)
    if exact_order:
        mp.setattr(jmk, "pl", _ExactReciprocal())
    try:
        color, hitrec = jmk.render_rays_mxu(
            sj, rtm_tpu.Camera().spec(w, h), jnp.uint32(fi), cfg,
            pixel_offset=jnp.int32(0), n_rays=w * h, interpret=True,
            return_hitrec=True)
    finally:
        mp.undo()
    return np.asarray(color).T, got["miss"], got["rec"], np.asarray(hitrec)


def _port_raw(st, case):
    _, w, h, bounces, frames, fi = case
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=bounces,
                                     max_frames=frames,
                                     draw_environment=True)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(w, h))
    out = tmk.mxu_trace_plain(st, tmk.side_tables(st), camf, fi, 0, w * h,
                              cfg, return_hitrec=True)
    return tuple(None if t is None else t.numpy() for t in out)


@pytest.fixture(scope="module")
def runs():
    """Both packages' raw outputs per case, computed once per module."""
    cache = {}

    def get(name, exact_order=True):
        key = (name, exact_order)
        if key not in cache:
            case = CASES[name]
            sj = jax_scene(case[0])
            cache[key] = (_jax_raw(sj, case, exact_order),
                          _port_raw(carry(sj), case))
        return cache[key]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel(runs, name):
    (jc, jm, jr, jh), (tc, tm, tr, th) = runs(name)
    _, w, h, bounces, frames, _ = CASES[name]
    n = w * h
    assert th.shape == jh.shape == (frames * bounces, n)
    assert tm.shape == jm.shape == (8 * frames, n)
    assert (tr is None) == (jr is None)
    same = th == jh
    agree = same.mean()
    assert agree >= AGREE_MIN, f"hitrec agreement {agree:.6f}"
    lanes = same.all(axis=0)
    assert lanes.mean() >= 0.99
    np.testing.assert_allclose(tc[:, lanes], jc[:3, lanes], rtol=5e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tm[:, lanes], jm[:, lanes], rtol=5e-4,
                               atol=1e-4)
    if tr is not None:
        assert tr.shape == jr.shape == (8 * frames * bounces, n)
        np.testing.assert_allclose(tr[:, lanes], jr[:, lanes], rtol=5e-4,
                                   atol=1e-4)


def test_tpu_ordering_reciprocal(runs):
    """Against the JAX kernel as it orders on the TPU (approximate
    reciprocal, bf16 in interpret mode): scene 3's shared wall edges flip
    about one record in a thousand (0.99878 measured); all else agrees."""
    (_, _, _, jh), (_, _, _, th) = runs("scene3", exact_order=False)
    (_, _, _, jh_exact), _ = runs("scene3")
    agree = (th == jh).mean()
    assert agree >= 0.998, agree
    assert (th == jh_exact).mean() >= agree


def test_hitrec_packing(runs):
    """hitrec = HR_TRI | scene row, HR_SPH | sphere, 0 = miss."""
    _, (_, _, _, th) = runs("scene2")
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(2),
                                          device="cpu")
    tri = th[(th & tmk.HR_TRI) != 0] & tmk.HR_IDX
    sph = th[(th & tmk.HR_SPH) != 0] & tmk.HR_IDX
    assert len(tri) and len(sph) and (th == 0).any()
    assert tri.max() < st.num_triangles and sph.max() < st.num_spheres
    assert not ((th & tmk.HR_TRI) & ((th & tmk.HR_SPH) >> 1)).any()


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(3),
                                          device="cpu")
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(16, 16))
    tabs = tmk.side_tables(st)
    before = tmk.mxu_trace.launches
    a = tmk.mxu_trace(st, tabs, camf, 2, 0, 256, cfg, return_hitrec=True)
    b = tmk.mxu_trace_plain(st, tabs, camf, 2, 0, 256, cfg,
                            return_hitrec=True)
    assert tmk.mxu_trace.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrapper_rejects_unsupported_scenes_and_devices():
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(3),
                                          device="cpu")
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(16, 16))
    big = dataclasses.replace(
        st, mxu_meta=st.mxu_meta._replace(supported=False))
    with pytest.raises(ValueError, match="table limits"):
        tmk.mxu_trace(big, tmk.side_tables(st), camf, 1, 0, 256, cfg)
    with pytest.raises(ValueError, match="scene on"):
        tmk.mxu_trace(st, tmk.side_tables(st), camf.to("meta"), 1, 0, 256,
                      cfg)


def test_pixel_offset_window(runs):
    """A dispatch of slots [o, o + n) equals that window of the full
    dispatch (the unit a banded multi-GPU renderer sends each card)."""
    st = carry(jax_scene(2))
    _, w, h, bounces, frames, fi = CASES["scene2"]
    cfg = rtm_tpu_torch.RenderConfig(width=w, height=h, max_bounces=bounces,
                                     max_frames=frames)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(w, h))
    tabs = tmk.side_tables(st)
    full = tmk.mxu_trace_plain(st, tabs, camf, fi, 0, w * h, cfg,
                               return_hitrec=True)
    part = tmk.mxu_trace_plain(st, tabs, camf, fi, 320, 448, cfg,
                               return_hitrec=True)
    for a, b in zip(full, part):
        if a is not None:
            assert torch.equal(a[:, 320:768], b)


def test_k_steps_take_each_product_once():
    """The steps take each product of (A_hi + A_lo) . (hi + md + lo) but
    A_lo . lo (2^-24 of the term) once, over the features each row kind
    uses (edge rows s1..s3: 0-5; the tdet row: 6-9), and nothing else but
    zeros."""
    for rays, tris, feats in ((EDGE_RAY, EDGE_TRI, range(6)),
                              (TDET_RAY, TDET_TRI, range(6, 10))):
        pairs = [(t, r) for h in range(2) for t, r in zip(tris[h], rays[h])]
        assert all((t is None) == (r is None) for t, r in pairs)
        got = [(t[0], r[0], t[1]) for t, r in pairs if t is not None]
        assert all(t[1] == r[1] for t, r in pairs if t is not None)
        want = [(a, b, k) for a, b in ((W, HI), (W, MD), (W, LO), (L, HI),
                                       (L, MD)) for k in feats]
        assert sorted(got) == sorted(want)
    # the table: edge rows have no features 6-9, the tdet row none of 0-5
    a = int_tables(34, seed=1).pair.float().reshape(tmk.Q, tmk.CHUNK, tmk.KS)
    assert (a[:3, :, 6:tmk.K] == 0).all() and (a[:3, :, 38:] == 0).all()
    assert (a[3, :, 0:6] == 0).all() and (a[3, :, 32:38] == 0).all()


@pytest.mark.parametrize("n_tris", N_TRIS_EDGES)
def test_pair_pass_model_bitwise_on_integer_geometry(n_tris):
    """On integer rows and features every sum is exact in any order, so the
    lane model's winners and packed t equal the plain version's bitwise;
    dead lanes keep BIG."""
    ma = int_tables(n_tris, seed=n_tris)
    rays = int_rays(1000, seed=7 + n_tris)
    alive = torch.from_numpy(np.random.default_rng(1).random(1000) < 0.9)
    want = tmk.nearest_packed_plain(ma, *rays)
    got = model_nearest(ma, n_tris, rays, alive)
    assert torch.equal(got[alive].view(torch.int32),
                       want[alive].view(torch.int32))
    assert (got[~alive] == tmk.BIG).all()
    hits = int((want[alive] < 1e29).sum())
    assert hits >= (50 if n_tris >= 34 else 1), hits


def test_pair_pass_model_bitwise_on_wide_integer_tables():
    """Vertices in [-16, 16] give edge rows of more than 8 significant bits
    (A_lo words non-zero in every row kind); integer rays keep every sum
    exact, so the model equals the plain version bitwise."""
    ma = int_tables(300, seed=21, span=16)
    a_lo = ma.pair[..., 2 * tmk.K:].float().reshape(tmk.Q, -1, tmk.K)
    assert (a_lo[:3, :, 0:6] != 0).any() and (a_lo[3, :, 6:10] != 0).any()
    rays = int_rays(2000, seed=22)
    alive = torch.ones(2000, dtype=torch.bool)
    want = tmk.nearest_packed_plain(ma, *rays)
    got = model_nearest(ma, 300, rays, alive)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((want < 1e29).sum()) >= 50


def test_fractional_rays_fill_every_md_and_lo_word():
    """frac_rays gives every feature slot of the ray tile but the constant
    1 non-zero md and lo parts on many rays (the words the plain version's
    bf16x3 never takes), each part on the 2^-18 grid."""
    rays = frac_rays(3000, seed=1)
    fin = torch.isfinite(rays).all(dim=0).numpy()
    hi, md, lo = model_split(rays)
    for part in (hi, md, lo):
        x = part[fin, :9].astype(np.float64) * 2.0 ** 18
        assert (x == np.round(x)).all()
    for k in range(9):
        assert (md[fin, k] != 0).mean() > 0.2, k
        assert (lo[fin, k] != 0).mean() > 0.2, k
    assert (hi[fin, 9] == 1).all()
    assert (md[fin, 9] == 0).all() and (lo[fin, 9] == 0).all()


def _exact_key(ma, rays):
    """The least packed key per ray from the f64 product the kernel takes,
    (A_hi + A_lo) . f - A_lo . lo (f = hi + md + lo exactly), rounded to
    f32 once, and checked to be exact in f32 in any order: every sum of
    absolute products below 2^6 on the 2^-18 grid."""
    f = torch.from_numpy(model_features(rays)).double()
    lo = torch.from_numpy(model_split(rays)[2]).double()
    fin = torch.isfinite(f).all(dim=1)
    bound = torch.zeros(rays.shape[1], dtype=torch.float64)
    best = torch.full_like(rays[0], tmk.BIG)
    rowi = torch.arange(tmk.CHUNK, dtype=torch.int32)[:, None]
    parts = [torch.from_numpy(p).double().abs() for p in model_split(rays)]
    for c in range(ma.pair.shape[0]):
        a_hi = ma.pair[c, :, 0:tmk.K].double()
        a_lo = ma.pair[c, :, 2 * tmk.K:].double()
        s = (a_hi + a_lo) @ f.T - a_lo @ lo.T              # (Q*128, N)
        mags = sum(ab @ p.T for ab, p in
                   ((a_hi.abs(), parts[0] + parts[1] + parts[2]),
                    (a_lo.abs(), parts[0] + parts[1])))
        bound = torch.maximum(bound, torch.where(
            fin, mags.amax(dim=0), 0.0))
        acc = s.float()
        s1, s2, s3, td = acc[0:128], acc[128:256], acc[256:384], acc[384:]
        det = s1 + s2 + s3
        m = torch.minimum(torch.minimum(s1, s2), torch.minimum(s3, td))
        tt = torch.clamp(td / torch.clamp(det, min=tmk.DET_EPS), max=1e28)
        packed = torch.where(m >= 0.0,
                             tmk.pack_t(tt, rowi + c * tmk.CHUNK), tmk.BIG)
        best = torch.minimum(best, packed.amin(dim=0))
    assert float(bound.max()) < 2.0 ** 6
    return best


@pytest.mark.parametrize("n_tris", N_TRIS_EDGES)
def test_pair_pass_model_exact_on_fractional_rays(n_tris):
    """Rays whose features have non-zero md and lo parts, against small
    integer tables: the lane model's packed keys equal the exact product's
    bitwise (the on-card tests hold the tensor cores to the model there).
    Finite rays only: a NaN or inf feature makes both sides NaN-gated
    alike, which the integer cases hold."""
    ma = int_tables(n_tris, seed=n_tris, span=1)
    rays = frac_rays(1000, seed=3 + n_tris)
    fin = torch.isfinite(rays).all(dim=0)
    want = _exact_key(ma, rays)
    got = model_nearest(ma, n_tris, rays, torch.ones(1000, dtype=torch.bool))
    assert torch.equal(got[fin].view(torch.int32),
                       want[fin].view(torch.int32))
    assert int((want[fin] < 1e29).sum()) >= (30 if n_tris >= 34 else 1)
    # the culled form the on-card tests use agrees on every live ray
    alive = torch.arange(1000) % 4 != 1
    culled = nearest_culled(ma, n_tris, rays, alive, key=model_key)
    keep = alive & fin & (got < 1e29) & (
        (got.view(torch.int32) & ~tmk.IDX_MASK) != 0)
    assert torch.equal(culled[keep], got[keep])


def test_pair_pass_duplicate_triangles_lower_index_wins():
    ma = int_tables(200, seed=3, dup=True)
    rays = int_rays(2000, seed=4)
    alive = torch.ones(2000, dtype=torch.bool)
    want = tmk.nearest_packed_plain(ma, *rays)
    got = model_nearest(ma, 200, rays, alive)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # a duplicate pair is two table rows with equal pair rows: the winner
    # is never the higher of two rows that tie
    rows = ma.pair[..., :].float().reshape(-1, tmk.Q, tmk.CHUNK, tmk.KS)
    rows = rows.permute(0, 2, 1, 3).reshape(-1, tmk.Q * tmk.KS)[:200]
    win = (got.view(torch.int32) & tmk.IDX_MASK)[got < 1e29].long()
    first = {}
    for i, r in enumerate(map(tuple, rows.tolist())):
        first.setdefault(r, i)
    assert len(first) < 200
    assert all(first[tuple(rows[w].tolist())] == w for w in win.tolist())


def test_ray_split_matches_the_plain_version_bitwise():
    """The device conversion (round to nearest even) gives the plain
    version's b_hi and b_lo as the kernel's hi and md, specials included,
    and hi + md + lo is the feature exactly (wherever no part underflows:
    |f| >= 2^-100, or f = 0)."""
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((6, 4096)) * 10.0 ** rng.integers(
        -30, 30, size=(6, 4096))).astype(np.float32)
    v[:, :8] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 3e38,
                         -3.3895314e38], np.float32)[None]
    rays = torch.from_numpy(v)
    b_hi, b_lo = tmk.ray_features(*rays)
    hi, md, lo = model_split(rays)
    for plain, model in ((b_hi, hi), (b_lo, md)):
        p = plain.float().numpy().T
        assert (np.isnan(p) == np.isnan(model)).all()
        keep = ~np.isnan(p)
        assert (p[keep].view(np.uint32) == model[keep].view(np.uint32)).all()
    f = model_features(rays)
    fin = (np.abs(f) >= 2.0 ** -100) & (np.abs(f) < 3e38) | (f == 0)
    total = hi.astype(np.float64) + md + lo
    assert (total[fin] == f[fin]).all()


def _recorded_rays(scene, res=32, bounces=4):
    """Every (rays, alive) the plain version's pair test sees over one
    frame of `scene`."""
    seen = []
    real = tmk.nearest_packed_plain

    def record(ma, *rays):
        seen.append(torch.stack(rays))
        return real(ma, *rays)

    cfg = rtm_tpu_torch.RenderConfig(width=res, height=res,
                                     max_bounces=bounces,
                                     draw_environment=True)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(res, res))
    mp = pytest.MonkeyPatch()
    mp.setattr(tmk, "nearest_packed_plain", record)
    try:
        out = tmk.mxu_trace_plain(scene, tmk.side_tables(scene), camf, 1, 0,
                                  res * res, cfg, with_stats=True)
    finally:
        mp.undo()
    return seen, out[4]


@pytest.mark.parametrize("sid", [3, "grid2"])
def test_pair_pass_model_winners_on_scenes(sid):
    """On a scene's own rays (all 4 bounces of a 32x32 frame) the model's
    winners agree with the plain version's on >= 0.999 of the alive rays:
    the products are the same, only their summation order differs."""
    st = rtm_tpu_torch.build_tracer_scene(
        host_scene(tscenes, sid), device="cpu")
    seen, stats = _recorded_rays(st)
    agree = total = 0
    for rays, alive in zip(seen, stats.alive):
        want = tmk.nearest_packed_plain(st.mxu_arrays, *rays)
        got = model_nearest(st.mxu_arrays, st.mxu_meta.n_tris, rays, alive)
        wi = want.view(torch.int32) & tmk.IDX_MASK
        gi = got.view(torch.int32) & tmk.IDX_MASK
        same = ((want < 1e29) == (got < 1e29)) & ((wi == gi)
                                                   | (want >= 1e29))
        agree += int(same[alive].sum())
        total += int(alive.sum())
    assert total > 1000
    assert agree / total >= AGREE_MIN, agree / total


@pytest.mark.parametrize("sid", [3, "grid4"])
def test_stats_leave_outputs_unchanged_and_cull_keeps_winners(sid):
    """with_stats changes no output; its alive rows are the rays that
    start each bounce, and the chunk cull passes, for every block, the
    chunk of each of its alive rays' plain winners."""
    st = rtm_tpu_torch.build_tracer_scene(
        host_scene(tscenes, sid), device="cpu")
    res, bounces = 24, 3
    cfg = rtm_tpu_torch.RenderConfig(width=res, height=res,
                                     max_bounces=bounces,
                                     draw_environment=True)
    camf = _pack_camera(rtm_tpu_torch.Camera().spec(res, res))
    tabs = tmk.side_tables(st)
    n = res * res
    a = tmk.mxu_trace_plain(st, tabs, camf, 2, 0, n, cfg, return_hitrec=True)
    b = tmk.mxu_trace_plain(st, tabs, camf, 2, 0, n, cfg, return_hitrec=True,
                            with_stats=True)
    for x, y in zip(a, b[:4]):
        assert (x is None and y is None) or torch.equal(x, y)
    stats = b[4]
    blocks = -(-n // tmk.BLOCK)
    assert stats.alive.shape == (bounces, n)
    assert stats.passed.shape == (bounces, blocks, st.mxu_meta.nc)
    assert stats.alive[0].all()
    hr = b[3]
    for k in range(1, bounces):   # alive at k: alive and hit at k - 1
        assert torch.equal(stats.alive[k],
                           stats.alive[k - 1] & (hr[k - 1] != 0))
    seen, _ = _recorded_rays(st, res, bounces)
    for k, rays in enumerate(seen):
        best = tmk.nearest_packed_plain(st.mxu_arrays, *rays)
        got = stats.alive[k] & (best < 1e29)
        chunk = (best.view(torch.int32) & tmk.IDX_MASK).long() // tmk.CHUNK
        block = torch.arange(n) // tmk.BLOCK
        assert stats.passed[k][block[got], chunk[got]].all()
        dead_blocks = ~torch.nn.functional.pad(
            stats.alive[k], (0, blocks * tmk.BLOCK - n)).view(
            blocks, -1).any(dim=1)
        assert not stats.passed[k][dead_blocks].any()


@pytest.mark.parametrize("sid", [2, 3, "grid2"])
def test_pair_padding_rows_fail_every_ray(sid):
    """Rows past n_tris carry only the tdet constant -1 (A_hi, both
    copies): a finite ray's tdet is -1 there, so no padding row passes."""
    st = rtm_tpu_torch.build_tracer_scene(
        host_scene(tscenes, sid), device="cpu")
    nc, t = st.mxu_meta.nc, st.mxu_meta.n_tris
    pair = st.mxu_arrays.pair.float().reshape(nc, tmk.Q, tmk.CHUNK, tmk.KS)
    pad = pair.permute(0, 2, 1, 3).reshape(nc * tmk.CHUNK, tmk.Q,
                                           tmk.KS)[t:]
    want = torch.zeros_like(pad)
    want[:, 3, 9] = want[:, 3, tmk.K + 9] = -1.0
    assert torch.equal(pad, want)


def test_mxu_nearest_runs_plain_on_cpu_and_counts_no_launch():
    ma = int_tables(34, seed=2)
    rays = int_rays(300, seed=5)
    alive = torch.arange(300) % 3 != 0
    before = tmk.mxu_nearest.launches
    got = tmk.mxu_nearest(table_scene(ma, 34, "cpu"), rays, alive)
    assert tmk.mxu_nearest.launches == before
    want = tmk.nearest_packed_plain(ma, *rays)
    assert torch.equal(got[alive].view(torch.int32),
                       want[alive].view(torch.int32))
    assert (got[~alive] == tmk.BIG).all()


@pytest.mark.parametrize("every", [1, 32, 96])
def test_culled_reference_differs_only_on_in_plane_rays(every):
    """The on-card reference (the plain key over the chunks each block's
    cull passes) equals the all-pairs key wherever the live rays of a block
    enter the winner's chunk; with one live ray in every `every`, the only
    differences are rays lying in a triangle's plane (packed t = 0)."""
    ma = int_tables(300, seed=11)
    rays = int_rays(3000, seed=12)
    i = torch.arange(3000)
    alive = i % every == (i // every) % every
    want = tmk.nearest_packed_plain(ma, *rays)
    got = nearest_culled(ma, 300, rays, alive)
    assert (got[~alive] == tmk.BIG).all()
    diff = alive & (got.view(torch.int32) != want.view(torch.int32))
    if every == 1:
        assert not diff.any()
    assert ((want[diff].view(torch.int32) & ~tmk.IDX_MASK) == 0).all()
