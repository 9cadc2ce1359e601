"""rtm_tpu_torch's texture/sky post-pass vs rtm_tpu's, on numpy-made
kernel records.

The records follow the kernels' layout (rows per frame and bounce:
s_rgb, uv or sphere normal, texid or -1, sphere flag; per frame: miss
direction, contribution, valid).  The dense forms compute the same sums in
the same order; the port's compact form sums each ray in that order too,
rtm_tpu's by a segmented scan.  They differ by that summation order and by
the ulps of atan2 / asin on sphere records, which move a bilinear texture
tap by a few 1e-6 (rtol 1e-5 with atol 5e-6).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.ops.pallas import megakernel as jmk
from rtm_tpu_torch.ops.kernels import megakernel as tmk
from test_torch_parity import carry, jax_scene

N = 512
BOUNCES = 4
FRAMES = 2


def _records(seed: int, n=N, bounces=BOUNCES, frames=FRAMES):
    """(color (n,3), miss (8F,n), rec (8FB,n)) like the kernels emit."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((frames * bounces, 8, n), np.float32)
    emissive = rng.random((frames * bounces, n)) < 0.25
    rec[:, 0:3] = rng.uniform(0, 2, (frames * bounces, 3, n)) \
        * emissive[:, None]
    textured = rng.random((frames * bounces, n)) < 0.3
    sphere = textured & (rng.random((frames * bounces, n)) < 0.4)
    nrm = rng.normal(size=(frames * bounces, 3, n))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    uv = rng.uniform(-3, 10, (frames * bounces, 2, n))
    rec[:, 3:5] = np.where(sphere[:, None], nrm[:, :2], uv)
    rec[:, 5] = np.where(sphere, nrm[:, 2], 0.0)
    rec[:, 6] = np.where(textured, 0.0, -1.0)
    rec[:, 7] = sphere
    miss = np.zeros((frames, 8, n), np.float32)
    valid = rng.random((frames, n)) < 0.6
    d = rng.normal(size=(frames, 3, n))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    miss[:, 0:3] = d * valid[:, None]
    miss[:, 3:6] = rng.uniform(0, 1, (frames, 3, n))
    miss[:, 6] = valid
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return (color, miss.reshape(8 * frames, n),
            rec.reshape(8 * frames * bounces, n))


def _cfgs(bounces=BOUNCES, frames=FRAMES):
    kw = dict(width=32, height=16, max_bounces=bounces, max_frames=frames,
              draw_environment=True)
    return rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)


def _both(fn_name, sid, seed, **kw):
    sj = jax_scene(sid)
    st = carry(sj)
    color, miss, rec = _records(seed)
    if not sj.any_textured:
        rec = None
    jc, tc = _cfgs()
    j = getattr(jmk, fn_name)(
        jnp.asarray(color), jnp.asarray(miss),
        None if rec is None else jnp.asarray(rec), sj, jc, N, **kw)
    t = getattr(tmk, fn_name)(
        torch.from_numpy(color), torch.from_numpy(miss),
        None if rec is None else torch.from_numpy(rec), st, tc, N, **kw)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("sid,seed", [(2, 0), (3, 1)])
def test_compact_matches_jax(sid, seed):
    j, t = _both("mega_postpass_compact", sid, seed)
    assert np.isfinite(t).all() and t.shape == (N, 3)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("sid,seed", [(2, 2), (3, 3)])
def test_compact_capacity_overflow_takes_dense(sid, seed):
    """cap below the significant-record count: every frame takes the dense
    branch (lax.cond in rtm_tpu, a host branch here)."""
    j, t = _both("mega_postpass_compact", sid, seed, cap=16)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("sid,seed", [(1, 4), (2, 5), (3, 6)])
def test_dense_matches_jax(sid, seed):
    j, t = _both("mega_postpass_dense", sid, seed)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("sid,seed", [(1, 7), (2, 8)])
def test_mega_postpass_routing_matches_jax(sid, seed):
    j, t = _both("mega_postpass", sid, seed)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=5e-6)


def test_compact_equals_dense_in_the_port():
    """The two forms give the same bits: the compact form runs each ray's
    albedo chain and sum in the dense form's order, so a frame does not
    depend on which branch a dispatch (or a band of it) takes."""
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(2),
                                          device="cpu")
    color, miss, rec = (torch.from_numpy(a) for a in _records(9))
    _, cfg = _cfgs()
    a = tmk.mega_postpass_compact(color, miss, rec, st, cfg, N)
    b = tmk.mega_postpass_dense(color, miss, rec, st, cfg, N)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


SEG_BOUNCES = 8


def _segment_records(seed: int, sparse: bool, n=N, frames=FRAMES):
    """Records whose significant slots form each ray's segment: a count
    per ray of 0..8 (rays with 0 and with all 8 always present) on a
    random subset of its bounces, each significant record emissive,
    textured (some on a sphere) or both; the other slots are neither.
    sparse: most rays hold 0-2 records, so a frame fits the default cap
    of n; else about half the slots are significant."""
    rng = np.random.default_rng(seed)
    b = SEG_BOUNCES
    color, miss, _ = _records(seed, n, b, frames)
    rec = np.zeros((frames, b, 8, n), np.float32)
    rec[:, :, 6] = -1.0
    for f in range(frames):
        if sparse:
            cnt = np.minimum(rng.geometric(0.75, n) - 1, b)
        else:
            cnt = rng.integers(0, b + 1, n)
        cnt[:3] = (0, b, 1)
        for r in range(n):
            for k in np.sort(rng.choice(b, cnt[r], replace=False)):
                kind = rng.integers(3)                # emissive, tex, both
                if kind != 1:
                    rec[f, k, 0:3, r] = rng.uniform(0.01, 2, 3)
                if kind != 0:
                    rec[f, k, 6, r] = 0.0
                    if rng.random() < 0.4:
                        nrm = rng.normal(size=3)
                        rec[f, k, 3:6, r] = nrm / np.linalg.norm(nrm)
                        rec[f, k, 7, r] = 1.0
                    else:
                        rec[f, k, 3:5, r] = rng.uniform(-3, 10, 2)
    return color, miss, rec.reshape(8 * frames * b, n)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("sid,seed", [(2, 12), (3, 13), (2, 14), (3, 15)])
def test_compact_segments_match_jax(sid, seed, sparse):
    """The compact form over per-ray segments of 0..8 significant records
    (the per-ray loop that reads each ray's segment) against rtm_tpu's
    segmented scans, and bitwise against the port's dense form.  The
    bitwise check clears the sphere flags: PyTorch's CPU atan2 is not
    batch-invariant, so a sphere tap's uv may differ by an ulp between
    the compact (cap,) and the dense (B, n) batch; the summation order
    is what it holds."""
    sj = jax_scene(sid)
    st = carry(sj)
    color, miss, rec = _segment_records(seed, sparse)
    kw = dict(width=32, height=16, max_bounces=SEG_BOUNCES,
              max_frames=FRAMES, draw_environment=True)
    jc, tc = rtm_tpu.RenderConfig(**kw), rtm_tpu_torch.RenderConfig(**kw)
    cap = N if sparse else N * SEG_BOUNCES
    sig = (rec.reshape(FRAMES, SEG_BOUNCES, 8, N)[:, :, 6] > -0.5) | (
        np.abs(rec.reshape(FRAMES, SEG_BOUNCES, 8, N)[:, :, 0:3]).sum(2) > 0)
    per_ray = sig.sum(axis=1)
    assert (sig.sum(axis=(1, 2)) <= cap).all()     # the compact branch runs
    assert {0, SEG_BOUNCES} <= set(per_ray.ravel().tolist())
    j = jmk.mega_postpass_compact(jnp.asarray(color), jnp.asarray(miss),
                                  jnp.asarray(rec), sj, jc, N, cap=cap)
    ct, mt, rt = (torch.from_numpy(a) for a in (color, miss, rec))
    t = tmk.mega_postpass_compact(ct, mt, rt, st, tc, N, cap=cap)
    assert np.isfinite(t.numpy()).all() and t.shape == (N, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=5e-6)
    flat = rec.reshape(FRAMES, SEG_BOUNCES, 8, N).copy()
    flat[:, :, 7] = 0.0
    rt = torch.from_numpy(flat.reshape(rec.shape))
    a = tmk.mega_postpass_compact(ct, mt, rt, st, tc, N, cap=cap)
    d = tmk.mega_postpass_dense(ct, mt, rt, st, tc, N)
    np.testing.assert_array_equal(a.numpy(), d.numpy())


def test_compact_rejects_untextured_scene():
    st = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(1),
                                          device="cpu")
    color, miss, rec = (torch.from_numpy(a) for a in _records(11))
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="textured"):
        tmk.mega_postpass_compact(color, miss, rec, st, cfg, N)
