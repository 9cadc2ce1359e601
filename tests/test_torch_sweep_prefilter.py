"""The invariant the sweep kernels' candidate prefilter rests on, on the CPU.

csrc/tri_sweep.cuh `sweep_clusters` walks only the clusters some alive ray
of the tile enters at all (`sweep_candidates_plain`), and applies the exact
per-cluster test of a walk over every cluster to those alone.  That gives
the walk's passes, winners and tie order only if every cluster the walk
passes is a candidate: the best t never exceeds BIG and a missed box gives
BIG, so `near < best_t` implies `near < BIG`.  These tests hold the plain
sweep's pass matrix inside the candidate set, cluster by cluster, on the
wavefront2 renderer's own sorted bands, and pin the edge cases the kernel
treats specially: rays with a NaN component and tiles with no alive ray.
No tolerance: both sides are boolean.
"""
from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

import rtm_tpu_torch
from rtm_tpu_torch.models.scenes import dragon_grid
from rtm_tpu_torch.ops import wavefront2 as twf2
from rtm_tpu_torch.ops.kernels.megakernel import build_mega_pack
from rtm_tpu_torch.ops.kernels.sweep_kernel import (BIG, cluster_sweep_plain,
                                                    sweep_candidates_plain)

_SCENES = {}


def _scene(sid):
    if sid not in _SCENES:
        host = (dragon_grid(int(sid[4:])) if isinstance(sid, str)
                else rtm_tpu_torch.load_scene(sid))
        _SCENES[sid] = rtm_tpu_torch.build_tracer_scene(host, device="cpu")
    return _SCENES[sid]


def _sorted_bands(st, res=32, bounces=4):
    """Each bounce's (8, Np) band of one frame, sorted before every bounce
    (sort_from=0), as the renderer handed it to `sweep_call`."""
    cfg = rtm_tpu_torch.RenderConfig(width=res, height=res,
                                     max_bounces=bounces,
                                     draw_environment=True)
    bands = []
    sweep_call = twf2.sweep_call

    def record(pack, state8, **kw):
        bands.append(state8.clone())
        return sweep_call(pack, state8, **kw)

    with mock.patch.object(twf2, "sweep_call", record):
        twf2.render_rays_wavefront2(st, rtm_tpu_torch.Camera().spec(res, res),
                                    1, cfg, pixel_offset=0,
                                    n_rays=res * res, sort_from=0)
    return bands


def _plain(pack, state8, ray_tile):
    return cluster_sweep_plain(pack.tri_feats, pack.boxes,
                               pack.cluster_offsets, pack.cluster_widths,
                               state8, ray_tile, with_passed=True)


@pytest.mark.parametrize("ray_tile", [512, 64])
@pytest.mark.parametrize("sid", [2, 3, "grid11"])
def test_passed_clusters_are_candidates(sid, ray_tile):
    st = _scene(sid)
    pack = build_mega_pack(st)
    bands = _sorted_bands(st)
    assert len(bands) == 4
    swept = cands = 0
    for state8 in bands:
        _, _, passes, passed = _plain(pack, state8, ray_tile)
        cand = sweep_candidates_plain(pack, state8, ray_tile)
        assert cand.shape == passed.shape == (state8.shape[1] // ray_tile,
                                              pack.n_clusters)
        assert not bool((passed & ~cand).any())
        torch.testing.assert_close(passes, passed.sum(dim=1,
                                                      dtype=torch.int32))
        # a tile with no alive ray has no candidate
        tile_alive = (state8[6] > 0.5).view(-1, ray_tile).any(dim=1)
        assert not bool(cand[~tile_alive].any())
        swept += int(passed.sum())
        cands += int(cand.sum())
    assert 0 < swept <= cands


def _nan_band(st, pack, ray_tile=64):
    """A 4-tile band of camera rays that each enter some cluster's box:
    tile 0 as is, tile 1 with every ray dead, tile 2 with one alive ray
    whose origin x is NaN and one whose direction y is NaN (the rest dead),
    tile 3 with a single alive ray."""
    r = ray_tile
    band = _sorted_bands(st, res=32, bounces=1)[0]
    enters = sweep_candidates_plain(pack, band, 1).any(dim=1).nonzero()[:, 0]
    state8 = band[:, enters[torch.arange(4 * r) % len(enters)]].clone()
    state8[6, r:] = 0.0
    state8[6, 2 * r:2 * r + 2] = 1.0
    state8[0, 2 * r] = float("nan")
    state8[4, 2 * r + 1] = float("nan")
    state8[6, 3 * r + 5] = 1.0
    return state8


@pytest.mark.parametrize("sid", [3, "grid11"])
def test_nan_rays_and_dead_tiles_have_no_candidates(sid):
    st = _scene(sid)
    pack = build_mega_pack(st)
    r = 64
    state8 = _nan_band(st, pack, r)
    t, i, passes, passed = _plain(pack, state8, r)
    cand = sweep_candidates_plain(pack, state8, r)
    assert not bool((passed & ~cand).any())
    # the NaN rays enter no box, so their tile is a dead tile to the cull
    for tile in (1, 2):
        assert not bool(cand[tile].any())
        assert int(passes[tile]) == 0
        lanes = slice(tile * r, (tile + 1) * r)
        assert bool((t[lanes] == BIG).all())
        assert bool((i[lanes] == -1).all())
    # the live tiles see the same clusters as without the dead ones
    assert bool(cand[0].any()) and bool(cand[3].any())
    assert int(passes[3]) >= 1
    ref = _plain(pack, state8[:, 3 * r:], r)
    assert torch.equal(t[3 * r:], ref[0]) and torch.equal(i[3 * r:], ref[1])
    assert torch.equal(passed[3], ref[3][0])


def test_candidates_match_a_per_ray_scan():
    """The candidate set, computed 64 tiles at a time, equals one computed
    with NumPy's float32 operations in the same order (np.minimum and
    np.maximum propagate NaN as torch's do), with random rays dead."""
    st = _scene("grid11")
    pack = build_mega_pack(st)
    r = 32
    state8 = _sorted_bands(st, res=48, bounces=2)[1]
    rng = np.random.default_rng(7)
    keep = torch.from_numpy((rng.random(state8.shape[1]) < 0.6)
                            .astype(np.float32))
    state8[6] = state8[6] * keep
    cand = sweep_candidates_plain(pack, state8, r).numpy()
    s = state8.numpy()
    d = s[3:6]
    eps = np.float32(1e-12)
    inv = np.float32(1.0) / np.where(np.abs(d) < eps,
                                     np.where(d >= 0, eps, -eps), d)
    lo = pack.boxes[:, 0:3].numpy().T[:, None, :]
    hi = pack.boxes[:, 3:6].numpy().T[:, None, :]
    t1 = (lo - s[0:3, :, None]) * inv[:, :, None]
    t2 = (hi - s[0:3, :, None]) * inv[:, :, None]
    mn, mx = np.minimum(t1, t2), np.maximum(t1, t2)
    tn = np.maximum(np.maximum(mn[0], mn[1]), mn[2])
    tf = np.minimum(np.minimum(mx[0], mx[1]), mx[2])
    enters = (tf >= 0) & (tn <= tf) & (tn < BIG) & (s[6] > 0.5)[:, None]
    want = enters.reshape(-1, r, pack.n_clusters).any(axis=1)
    np.testing.assert_array_equal(cand, want)
    assert 0 < cand.sum() < cand.size
