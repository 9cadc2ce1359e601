"""rtm_tpu_torch's sorted-wavefront path against rtm_tpu's on the CPU: the
cluster tables, the cluster sweep's plain version against rtm_tpu's sweep
kernel in interpret mode, and twins of tests/test_wavefront2.py (images
against rtm_tpu's xla frame with that file's tolerances, the slot band,
the unsorted stream and the cull heatmap).

The sweep orders candidate hits by the exact tdet / det; rtm_tpu's kernel
multiplies by an approximate reciprocal (a bf16 one in interpret mode), so
the winner may differ where two candidates lie within its rounding of each
other: alive-lane winners must agree on >= 99.9% of lanes and the
per-tile cluster passes on >= 99% of tiles.
"""
from __future__ import annotations

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.ops.pallas import megakernel as jmk
from rtm_tpu.ops.pallas import sweep_kernel as jsk
from rtm_tpu.ops.trace_ref import render_dispatch as j_render_dispatch
from rtm_tpu.ops.wavefront2 import render_rays_wavefront2 as j_rays_wf2
from rtm_tpu_torch.ops import wavefront2 as twf2
from rtm_tpu_torch.ops.kernels import megakernel as tmk
from rtm_tpu_torch.ops.kernels import sweep_kernel as tsk
from rtm_tpu_torch.ops.wavefront2 import (render_rays_wavefront2,
                                          render_wavefront2)
from test_torch_parity import carry, jax_scene


@pytest.mark.parametrize("sid", [2, 3, "grid2"])
def test_mega_pack_bitwise(sid):
    sj = jax_scene(sid)
    jp = jmk.build_mega_pack(sj)
    tp = tmk.build_mega_pack(carry(sj))
    assert tp.n_clusters == jp.n_clusters
    assert tp.cluster_offsets == jp.cluster_offsets
    assert tp.cluster_widths == jp.cluster_widths
    assert tp.n_padded_tris == jp.n_padded_tris
    np.testing.assert_array_equal(tp.tri_feats.numpy(),
                                  np.asarray(jp.tri_feats))
    np.testing.assert_array_equal(tp.boxes.numpy(), np.asarray(jp.boxes))
    np.testing.assert_array_equal(tp.padded_to_real.numpy(),
                                  np.asarray(jp.padded_to_real))
    np.testing.assert_array_equal(tp.offsets_dev.numpy(),
                                  np.asarray(jp.cluster_offsets))


def _bands(st, res=32, bounces=4):
    """Each bounce's (8, Np) band of an unsorted frame, as the renderer
    handed it to `sweep_call`."""
    cfg = rtm_tpu_torch.RenderConfig(width=res, height=res,
                                     max_bounces=bounces,
                                     draw_environment=True)
    bands = []

    def record(pack, state8, **kw):
        bands.append(state8)
        return tsk.sweep_call(pack, state8, **kw)

    with mock.patch.object(twf2, "sweep_call", record):
        render_rays_wavefront2(st, rtm_tpu_torch.Camera().spec(res, res), 1,
                               cfg, pixel_offset=0, n_rays=res * res,
                               sort_from=99)
    return bands


@pytest.mark.parametrize("sid", [3, "grid2"])
def test_sweep_plain_matches_sweep_call_interpret(sid):
    """Every bounce's band of an unsorted 32x32 frame through the plain
    sweep and through rtm_tpu's sweep kernel in interpret mode."""
    sj = jax_scene(sid)
    st = carry(sj)
    jp = jmk.build_mega_pack(sj)
    tp = tmk.build_mega_pack(st)
    bands = _bands(st)
    assert len(bands) == 4
    for state8 in bands:
        jt, ji, jn = jsk.sweep_call(jp, jnp.asarray(state8.numpy()),
                                    interpret=True)
        before = tsk.cluster_sweep.launches
        tt, ti, tn = tsk.sweep_call(tp, state8)
        assert tsk.cluster_sweep.launches == before      # CPU: plain
        alive = state8[6].numpy() > 0.5
        same = ti.numpy() == np.asarray(ji)
        assert same[alive].mean() >= 0.999
        tiles = (tn.numpy() == np.asarray(jn)).reshape(-1, 512)[:, 0]
        assert tiles.mean() >= 0.99
        hit = same & (np.asarray(ji) >= 0)
        np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                                   rtol=1e-2)


def test_sweep_call_is_detached():
    """The sweep under autograd: zero cotangents, as rtm_tpu's custom_vjp."""
    st = carry(jax_scene(3))
    pack = tmk.build_mega_pack(st)
    state8 = _bands(st, res=16, bounces=1)[0].clone().requires_grad_(True)
    t, i, n = tsk.sweep_call(pack, state8)
    assert not (t.requires_grad or i.requires_grad or n.requires_grad)
    assert n.shape == t.shape == (512,) and (n == n[0]).all()


def _compare(sid, res=24, bounces=4, frames=1, outlier_frac=0.0,
             frame_index=1, **kw):
    """tests/test_wavefront2.py `_compare`: the port's wavefront2 frame
    against rtm_tpu's xla frame."""
    sj = jax_scene(sid)
    cfg = dict(width=res, height=res, max_bounces=bounces, max_frames=frames,
               draw_environment=True)
    ref = np.asarray(j_render_dispatch(sj, rtm_tpu.Camera().spec(res, res),
                                       jnp.uint32(frame_index),
                                       rtm_tpu.RenderConfig(**cfg),
                                       backend="xla"))
    wf = render_wavefront2(carry(sj), rtm_tpu_torch.Camera().spec(res, res),
                           frame_index, rtm_tpu_torch.RenderConfig(**cfg),
                           **kw).numpy()
    assert np.isfinite(wf).all()
    d = np.abs(ref - wf)
    frac_bad = float((d.max(axis=-1) > 1e-3).mean())
    assert frac_bad <= outlier_frac, (frac_bad, float(d.max()))
    np.testing.assert_allclose(wf.mean(), ref.mean(), rtol=2e-3)


def test_scene1_spheres():
    _compare(1, bounces=4)


def test_scene3_cornell_sorted_every_bounce():
    _compare(3, bounces=4, outlier_frac=0.003, sort_from=0)


def test_scene3_unsorted_matches():
    # sorting must be a pure lane permutation: disabling it gives the
    # same image (the configuration gradient passes use)
    _compare(3, bounces=4, outlier_frac=0.003, sort_from=99)


def test_scene2_textured_multiframe():
    _compare(2, bounces=3, frames=2, outlier_frac=0.01)


def test_partial_ray_range():
    """An arbitrary dispatch-slot band equals the corresponding pixels of
    the full frame (slots walk 8x8 pixel blocks)."""
    sj = jax_scene(1)
    res = 16
    cfg = dict(width=res, height=res, max_bounces=3, max_frames=1,
               draw_environment=True)
    full = np.asarray(j_render_dispatch(
        sj, rtm_tpu.Camera().spec(res, res), jnp.uint32(1),
        rtm_tpu.RenderConfig(**cfg), backend="xla")).reshape(-1, 3)
    band = render_rays_wavefront2(
        carry(sj), rtm_tpu_torch.Camera().spec(res, res), 1,
        rtm_tpu_torch.RenderConfig(**cfg), pixel_offset=3 * res,
        n_rays=5 * res).numpy()
    x, y = tmk.slot_to_xy(torch.arange(3 * res, 8 * res), res)
    np.testing.assert_allclose(band, full[(y * res + x).numpy()], atol=1e-3)


def test_debug_passes_heatmap():
    """The cluster-pass probe: bounded by n_clusters * bounces, positive
    where geometry is, and equal to rtm_tpu's interpret-mode heatmap on
    >= 99% of pixels."""
    sj = jax_scene(3)
    res = 16
    cfg = dict(width=res, height=res, max_bounces=3, max_frames=1,
               draw_environment=True)
    img, passes = render_rays_wavefront2(
        carry(sj), rtm_tpu_torch.Camera().spec(res, res), 1,
        rtm_tpu_torch.RenderConfig(**cfg), pixel_offset=0,
        n_rays=res * res, debug_passes=True)
    _, want = j_rays_wf2(sj, rtm_tpu.Camera().spec(res, res), jnp.uint32(1),
                         rtm_tpu.RenderConfig(**cfg),
                         pixel_offset=jnp.int32(0), n_rays=res * res,
                         interpret=True, debug_passes=True)
    passes = passes.numpy()
    assert passes.shape == (res * res,) and passes.min() >= 0
    assert passes.max() <= tmk.build_mega_pack(carry(sj)).n_clusters * 3
    assert passes.max() > 0
    assert (passes == np.asarray(want)).mean() >= 0.99
    assert torch.isfinite(img).all()
