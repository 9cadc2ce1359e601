"""rtm_tpu_torch's CLI entry point, scene files, measure harness, numeric
guards and timer, each against rtm_tpu's counterpart
(tests/test_cli_and_harness.py): the same `scenes` listing, PNGs from
`render --device cpu` that match rtm_tpu's, .rtm.json scene files and
Measure.txt files that each package reads from the other, and the guards
on a NaN-poisoned sphere and an Inf pixel.

Images are compared after the PNG's 8-bit quantisation: the xla renders
of both packages agree to about 1e-6 (tests/test_torch_intersect.py), so
at most one level on at most 1% of the channel values.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import rtm_tpu
import rtm_tpu_torch
from rtm_tpu.__main__ import main as j_cli
from rtm_tpu_torch.__main__ import main as t_cli

RENDER = ["render", "--scene", "1", "--width", "16", "--height", "16",
          "--bounces", "2", "--frames", "2"]


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


def test_cli_scenes_listing_equals_rtm_tpu(capsys):
    assert j_cli(["scenes"]) == 0
    want = capsys.readouterr().out
    assert t_cli(["scenes"]) == 0
    got = capsys.readouterr().out
    assert got == want and "Cornell box" in got and got.count(":") >= 5


@pytest.fixture(scope="module")
def jax_png(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "r.png"
    assert j_cli(RENDER + ["--backend", "xla", "--out", str(out)]) == 0
    return _png(out)


@pytest.mark.parametrize("extra", [
    ["--backend", "xla"],
    ["--backend", "xla", "--check-nans"],
    ["--backend", "megakernel", "--check-nans"],
    ["--backend", "auto"],
], ids=["xla", "xla_check_nans", "megakernel_check_nans", "auto"])
def test_cli_render_cpu_writes_the_png(tmp_path, capsys, jax_png, extra):
    out = tmp_path / "r.png"
    assert t_cli(RENDER + ["--device", "cpu", "--out", str(out)]
                 + extra) == 0
    assert "device=cpu" in capsys.readouterr().out
    got = _png(out)
    assert got.shape == jax_png.shape == (16, 16, 3)
    diff = np.abs(got - jax_png)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_cli_render_debug_heatmap(tmp_path):
    out = tmp_path / "d.png"
    assert t_cli(RENDER + ["--scene", "3", "--device", "cpu", "--debug", "1",
                           "--out", str(out)]) == 0
    img = _png(out)
    assert img.shape == (16, 16, 3) and img.std() > 0


def test_cli_needs_the_card_unless_asked(tmp_path, capsys, monkeypatch):
    """No silent CPU fallback: without a card and without --device cpu the
    command exits non-zero with a message (view and bench too, before
    they serve or measure)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "r.png"
    assert t_cli(RENDER + ["--out", str(out)]) == 2
    assert "--device cpu" in capsys.readouterr().err and not out.exists()
    assert t_cli(["bench"]) == 2
    cap = capsys.readouterr()
    assert "--device cpu" in cap.err and cap.out == ""
    assert t_cli(["view", "--port", "0"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def _same_host_scene(a, b):
    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        assert dataclasses.asdict(ma) == pytest.approx(dataclasses.asdict(mb))
    assert [(tuple(s.position), s.radius, s.material_id) for s in a.spheres] \
        == [(tuple(s.position), s.radius, s.material_id) for s in b.spheres]
    assert len(a.meshes) == len(b.meshes)
    for ma, mb in zip(a.meshes, b.meshes):
        np.testing.assert_array_equal(ma.verts, mb.verts)
        np.testing.assert_array_equal(ma.uvs, mb.uvs)
    for oa, ob in zip(a.objects, b.objects):
        assert oa.mesh_id == ob.mesh_id and oa.material_id == ob.material_id
        for f in ("position", "scale", "rotation"):
            np.testing.assert_array_equal(getattr(oa, f), getattr(ob, f))
    assert len(a.textures) == len(b.textures)
    for ta, tb in zip(a.textures, b.textures):
        np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(a.sky, b.sky)


@pytest.mark.parametrize("writer", ["rtm_tpu_torch", "rtm_tpu"])
def test_scene_file_round_trip_across_packages(tmp_path, capsys, writer):
    """save-scene from either package loads in the other (the same JSON
    schema and sidecar) and renders through --scene-file."""
    from rtm_tpu.io.scene_io import load_scene_file as j_load
    from rtm_tpu_torch.io.scene_io import load_scene_file as t_load

    path = tmp_path / "s2.rtm.json"
    cli = t_cli if writer == "rtm_tpu_torch" else j_cli
    assert cli(["save-scene", "--scene", "2", "--out", str(path)]) == 0
    assert path.exists() and path.with_name("s2.rtm.npz").exists()
    js, jcam, _ = j_load(path)
    ts, tcam, _ = t_load(path)
    _same_host_scene(js, ts)
    _same_host_scene(ts, rtm_tpu_torch.load_scene(2))
    for f in ("position", "direction"):
        np.testing.assert_array_equal(getattr(jcam, f), getattr(tcam, f))
    assert jcam.fov == tcam.fov
    out = tmp_path / "r.png"
    assert t_cli(["render", "--scene-file", str(path), "--device", "cpu",
                  "--width", "16", "--height", "16", "--bounces", "2",
                  "--frames", "1", "--out", str(out)]) == 0
    assert _png(out).shape == (16, 16, 3)


def test_measure_files_read_in_both_packages(tmp_path, capsys):
    from rtm_tpu.bench.measure import run_measure as j_measure
    from rtm_tpu.bench.view_perf import load as j_load
    from rtm_tpu_torch.bench.measure import run_measure, summarize
    from rtm_tpu_torch.bench.view_perf import load, main as vp_main

    kw = dict(width=16, height=16, max_bounces=2, max_frames=1,
              draw_environment=True)
    t_path = str(tmp_path / "t.txt")
    arr = run_measure(rtm_tpu_torch.build_tracer_scene(
        rtm_tpu_torch.load_scene(1), device="cpu"),
        rtm_tpu_torch.RenderConfig(**kw), out_path=t_path, angle_step=60.0,
        frames_per_sample=2)
    assert arr.shape == (6, 2) and (arr[:, 1] > 0).all()
    stats = summarize(arr)
    assert stats["min_fps"] <= stats["mean_fps"] <= stats["max_fps"]
    np.testing.assert_array_equal(j_load(t_path), load(t_path))
    np.testing.assert_allclose(j_load(t_path), arr, rtol=1e-5)

    j_path = str(tmp_path / "j.txt")
    jarr = j_measure(rtm_tpu.build_tracer_scene(rtm_tpu.load_scene(1)),
                     rtm_tpu.RenderConfig(**kw), out_path=j_path,
                     angle_step=120.0, frames_per_sample=1)
    np.testing.assert_array_equal(load(j_path), j_load(j_path))
    np.testing.assert_allclose(load(j_path)[:, 0], jarr[:, 0])
    assert vp_main(j_path, plot=False) == summarize(load(j_path))
    assert "Mean:" in capsys.readouterr().out


def test_nan_guards():
    """The numeric validation layer flags a poisoned scene and passes a
    clean one (rtm_tpu's checkify float_checks become per-bounce checks
    naming the tensor); the output assertion flags an Inf pixel."""
    from rtm_tpu_torch.utils.guards import (assert_image_finite,
                                            checked_render_dispatch)

    scene = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(1),
                                             device="cpu")
    cam = rtm_tpu_torch.Camera().spec(12, 12)
    cfg = rtm_tpu_torch.RenderConfig(width=12, height=12, max_bounces=2,
                                     max_frames=1, draw_environment=True)
    img = checked_render_dispatch(scene, cam, 1, cfg)
    assert_image_finite(img)
    assert torch.equal(img, rtm_tpu_torch.render_dispatch(
        scene, cam, 1, cfg, backend="xla"))

    pos = scene.sph_pos.clone()
    pos[0, 0] = float("nan")
    bad = dataclasses.replace(scene, sph_pos=pos)
    with pytest.raises(FloatingPointError) as ei:
        checked_render_dispatch(bad, cam, 1, cfg)
    msg = str(ei.value).lower()
    assert "nan" in msg and "bounce 0" in msg
    with pytest.raises(ValueError, match="megakernel"):
        checked_render_dispatch(scene, cam, 1, cfg, backend="megakernel")

    with pytest.raises(FloatingPointError):
        assert_image_finite(torch.tensor([1.0, float("inf"), 2.0]))
    with pytest.raises(FloatingPointError):
        assert_image_finite(np.array([1.0, np.inf, 2.0]))
    # rtm_tpu's guard flags the same Inf pixel
    from rtm_tpu.utils.guards import assert_image_finite as j_assert
    with pytest.raises(FloatingPointError):
        j_assert(jnp.array([1.0, jnp.inf, 2.0]))


def test_cli_optimize_lowers_the_loss(tmp_path, capsys):
    out = tmp_path / "o.png"
    assert t_cli(["optimize", "--device", "cpu", "--scene", "1", "--width",
                  "8", "--height", "8", "--bounces", "2", "--steps", "3",
                  "--out", str(out)]) == 0
    line = capsys.readouterr().out
    first, last = (float(v) for v in
                   line.split("loss ")[1].split(" (")[0].split(" -> "))
    assert last < first and out.exists()


def test_timer_and_device_timed_ms():
    from rtm_tpu_torch.utils.timing import Timer, device_timed_ms

    t = Timer()
    ms, out = device_timed_ms(lambda x: x + 1, torch.ones(4), warmup=1,
                              iters=3)
    assert ms >= 0.0 and torch.equal(out, torch.full((4,), 2.0))
    assert t.elapsed_ms() >= ms
