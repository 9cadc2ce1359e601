"""rtm_tpu_torch's benchmark drivers (rtm_tpu_torch/bench/{protocol,
headline,backends,grad,bigscene}.py) against the scripts they port:
bench.py, scripts/bench_backends.py, scripts/bench_grad.py,
scripts/bigscene_bench.py and scripts/trav_bench.py.

On the CPU at small sizes: `bench --device cpu` prints exactly one JSON
line holding every key of bench.py's (bench.py itself runs in a
subprocess on the CPU); the timing protocol with an injected clock gives
bench.py's arithmetic and bench_backends.py's order; the grad rows' losses
are the port's render_loss; the large-scene grid rule and the live
ray-bounce count (held to the plain trav version's alive masks); a failed
backend fails the large-scene run; no driver writes a file unless asked,
and none runs without the card unless asked.  No time measured here is a
device figure.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rtm_tpu_torch
from rtm_tpu_torch.__main__ import main as t_cli
from rtm_tpu_torch.bench import backends, bigscene, grad, headline, protocol

ROOT = Path(__file__).resolve().parent.parent

TINY = {"RTM_BENCH_WIDTH": "8", "RTM_BENCH_HEIGHT": "8",
        "RTM_BENCH_BOUNCES": "1", "RTM_BENCH_REPEATS": "1",
        "RTM_BENCH_BLOCKS": "1"}


def _set_env(monkeypatch, env: dict):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def jax_bench_line(tmp_path_factory):
    """bench.py on the CPU at the TINY knobs: its one stdout line."""
    env = dict(os.environ, **TINY, RTM_BENCH_BACKEND="xla",
               RTM_BENCH_PLATFORM="cpu",
               RTM_JAX_CACHE=str(tmp_path_factory.mktemp("jax_cache")))
    proc = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


def _port_line(monkeypatch, capsys, backend: str) -> dict:
    _set_env(monkeypatch, dict(TINY, RTM_BENCH_BACKEND=backend))
    assert t_cli(["bench", "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    assert len(lines) == 1, cap.out
    assert cap.err.startswith("# device=cpu backend=")
    return json.loads(lines[0])


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_bench_cpu_prints_one_json_line(monkeypatch, capsys, backend):
    line = _port_line(monkeypatch, capsys, backend)
    assert line["metric"] == "cornell_grays_per_s"
    assert line["unit"] == "Grays/s/chip"
    assert line["device"] == {"platform": "cpu"}
    # one bounce is the flat-shade preview, which every route takes on xla
    assert line["backend"] == "xla"
    assert line["setup_s"] > 0.0
    assert line["spread"] == {"min": line["spread"]["min"],
                              "max": line["spread"]["max"], "blocks": 1,
                              "repeats_per_block": 1}


def test_bench_line_has_every_key_of_bench_py(monkeypatch, capsys,
                                              jax_bench_line):
    got = _port_line(monkeypatch, capsys, "xla")
    want = jax_bench_line
    assert set(want) <= set(got), set(want) - set(got)
    assert set(got) - set(want) == {"device", "backend", "setup_s"}
    assert (got["metric"], got["unit"]) == (want["metric"], want["unit"])
    assert set(got["spread"]) == set(want["spread"])
    for k in ("blocks", "repeats_per_block"):
        assert got["spread"][k] == want["spread"][k]


class FakeClock:
    """Returns each block's start and end from a list of durations."""

    def __init__(self, durations):
        self.stamps = []
        t = 100.0
        for d in durations:
            self.stamps += [t, t + d]
            t += d + 1.0
        self.stamps.reverse()

    def __call__(self):
        return self.stamps.pop()


def test_timed_blocks_give_bench_py_arithmetic():
    w, h, spp, bounces, repeats = 512, 512, 1, 8, 20
    dts = [0.1051, 0.0987, 0.1203, 0.1012, 0.0999]
    frames = []

    def dispatch(fi):
        frames.append(fi)
        return torch.ones(4)

    got = protocol.timed_blocks(dispatch, len(dts), repeats, first_frame=2,
                                clock=FakeClock(dts))
    assert frames == list(range(2, 2 + len(dts) * repeats))
    assert got == pytest.approx(dts, abs=1e-12)
    line = headline.headline_line(w, h, spp, bounces, repeats, got)
    # bench.py:85-101, verbatim
    rates = [w * h * spp * bounces * repeats / dt / 1e9 for dt in got]
    rates.sort()
    med = rates[len(rates) // 2]
    assert line == {
        "metric": "cornell_grays_per_s",
        "value": round(med, 4),
        "unit": "Grays/s/chip",
        "vs_baseline": round(med / 2.0, 4),
        "spread": {"min": round(rates[0], 4), "max": round(rates[-1], 4),
                   "blocks": len(dts), "repeats_per_block": repeats},
    }
    assert line["value"] == round(w * h * bounces * repeats / 0.1012 / 1e9,
                                  4)


def test_median_spread_is_the_scripts_median():
    assert protocol.median_spread([3.0, 1.0, 2.0]) == (2.0, 1.0, 3.0)
    # an even count takes the upper median, sorted(xs)[len(xs) // 2]
    assert protocol.median_spread([4.0, 1.0, 3.0, 2.0]) == (3.0, 1.0, 4.0)


def test_interleaved_blocks_warm_up_then_round_robin():
    calls = []

    def make(name):
        def dispatch(fi):
            calls.append((name, fi))
            return torch.zeros(2)
        return dispatch

    blocks, repeats = 2, 6
    dts = [0.6, 1.2, 1.8, 0.3, 0.6, 0.9]
    times = protocol.interleaved_blocks(
        {n: make(n) for n in "ABC"}, blocks, repeats, clock=FakeClock(dts))
    warm = max(2, repeats // 2)
    assert [n for n, _ in calls[:3 * warm]] == ["A"] * warm + ["B"] * warm \
        + ["C"] * warm
    timed = [n for n, _ in calls[3 * warm:]]
    assert timed == (["A"] * repeats + ["B"] * repeats
                     + ["C"] * repeats) * blocks
    assert [fi for _, fi in calls] == list(range(2, 2 + len(calls)))
    assert times["A"] == pytest.approx([100.0, 50.0])
    assert times["B"] == pytest.approx([200.0, 100.0])
    assert times["C"] == pytest.approx([300.0, 150.0])


@pytest.mark.parametrize("backend,res,bands_env,want", [
    ("mxu", 512, None, (1, False)),
    ("mxu", 16, "4", (1, False)),
    ("wavefront2", 512, None, (8, True)),
    ("wavefront2", 256, None, (1, True)),
    ("wavefront2", 512, "4", (4, True)),
    ("xla", 16, "2", (2, True)),
])
def test_grad_bands_and_remat_rule(monkeypatch, backend, res, bands_env,
                                   want):
    if bands_env is None:
        monkeypatch.delenv("RTM_GRAD_BANDS", raising=False)
    else:
        monkeypatch.setenv("RTM_GRAD_BANDS", bands_env)
    assert grad.grad_plan(backend, res) == want


@pytest.mark.parametrize("backend", ["mxu", "wavefront2"])
def test_grad_rows_losses_are_render_loss(monkeypatch, backend):
    monkeypatch.setenv("RTM_BENCH_BACKEND", backend)
    monkeypatch.delenv("RTM_GRAD_BANDS", raising=False)
    monkeypatch.delenv("RTM_BENCH_OUT", raising=False)
    res, bounces = 16, 2
    rows = grad.run(torch.device("cpu"), res, bounces, reps=1)
    assert [r["metric"] for r in rows] == [
        "fwd", "fwd_loss(bands=1)", "fwd_bwd(bands=1)"]
    assert all(r["backend"] == backend and r["device"] == {"platform": "cpu"}
               and r["peak_mib"] == "not measured" for r in rows)
    scene = rtm_tpu_torch.build_tracer_scene(rtm_tpu_torch.load_scene(3),
                                             device="cpu")
    cfg = rtm_tpu_torch.RenderConfig(width=res, height=res,
                                     max_bounces=bounces, max_frames=1,
                                     draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(res, res)
    target = torch.full((res, res, 3), 0.3)
    params = rtm_tpu_torch.extract_params(scene)
    remat = backend != "mxu"
    with torch.no_grad():
        want = [float(rtm_tpu_torch.render_loss(
            params, scene, cam, target, fi, cfg, backend, remat, False))
            for fi in (1, 2)]
    assert rows[1]["loss"] == pytest.approx(want[0], rel=1e-6)
    assert rows[2]["loss"] == pytest.approx(want[1], rel=1e-6)
    assert np.isfinite([r["ms"] for r in rows]).all()


@pytest.mark.parametrize("per_dragon,want", [(20, (19, 28, 56)),
                                             (1742, (2, 3, 6))],
                         ids=["stand_in", "dragon_asset"])
def test_bigscene_grid_rule(per_dragon, want):
    got = tuple(bigscene.grid_for(t, per_dragon)
                for t in bigscene.TRIANGLE_TARGETS)
    assert got == want
    assert [k * k * per_dragon for k in got] == (
        [7220, 15680, 62720] if per_dragon == 20 else [6968, 15678, 62712])


def test_bigscene_live_ray_bounces_match_the_plain_alive_masks(monkeypatch):
    """trav_work's count (visits that grow from b - 1 to b bounces) is the
    number of rays the plain version's descent walks, bounce by bounce."""
    from rtm_tpu_torch.models.scenes import dragon_grid
    from rtm_tpu_torch.ops.kernels import trav_kernel as ttk
    from rtm_tpu_torch.ops.kernels.megakernel import _pack_camera

    scene = rtm_tpu_torch.build_tracer_scene(dragon_grid(2), device="cpu")
    cfg = rtm_tpu_torch.RenderConfig(width=16, height=16, max_bounces=3,
                                     max_frames=1, draw_environment=True)
    cam = rtm_tpu_torch.Camera().spec(16, 16)
    walked = []
    inner = ttk.trav_nearest_plain

    def counting(*args):
        walked.append(int(args[-1].sum()))
        return inner(*args)

    monkeypatch.setattr(ttk, "trav_nearest_plain", counting)
    _, _, _, stats = ttk.trav_trace_plain(
        scene, ttk.trav_side_tables(scene), _pack_camera(cam), 2, 0, 256,
        cfg, with_stats=True)
    assert len(walked) == 3
    want = (int(stats[0].sum()), int(stats[1].sum()), sum(walked))
    walked.clear()
    with torch.no_grad():
        got = bigscene.trav_work(scene, cam, 2, cfg)
    assert got == want
    assert 0 < got[2] < 3 * 256


def test_bigscene_rows_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bigscene, "TRIANGLE_TARGETS", (80,))
    assert bigscene.main(["16", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["grid"] == "2x2" and row["n_tris"] == 80
    assert row["trav_supported"] and row["megakernel_fits"]
    for key in ("leaf_k", "n_leaves", "n_nodes", "trav_ms",
                "trav_compile_s", "megakernel_ms", "megakernel_compile_s",
                "cross_backend_max_diff", "live_ray_bounces",
                "node_visits_per_live", "tri_tests_per_live"):
        assert key in row, key
    assert row["device"] == {"platform": "cpu"}


def test_bigscene_failed_backend_fails_the_run(monkeypatch, capsys):
    from rtm_tpu_torch.ops import trace_ref

    inner = trace_ref.render_dispatch

    def failing(scene, cam, fi, cfg, backend="auto", **kw):
        if backend == "megakernel":
            raise RuntimeError("megakernel launch failed")
        return inner(scene, cam, fi, cfg, backend=backend, **kw)

    monkeypatch.setattr(bigscene, "TRIANGLE_TARGETS", (80, 180))
    monkeypatch.setattr(trace_ref, "render_dispatch", failing)
    assert bigscene.main(["16", "2", "--device", "cpu"]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "megakernel launch failed" in cap.err


def test_backends_writes_a_file_only_when_asked(monkeypatch, capsys,
                                                tmp_path):
    _set_env(monkeypatch, dict(TINY, RTM_BENCH_BOUNCES="2"))
    monkeypatch.delenv("RTM_BENCH_OUT", raising=False)
    monkeypatch.chdir(tmp_path)
    assert backends.main(["mxu", "wavefront2", "--device", "cpu"]) == 0
    rows = [json.loads(s) for s in
            capsys.readouterr().out.strip().splitlines()]
    assert [(r["backend"], r["route"]) for r in rows] == [
        ("mxu", "mxu"), ("wavefront2", "wavefront2")]
    for r in rows:
        assert {"ms_per_frame", "ms_min", "ms_max", "grays_per_s",
                "compile_s", "mean_radiance"} <= set(r)
        assert r["ms_min"] <= r["ms_per_frame"] <= r["ms_max"]
        assert r["device"] == {"platform": "cpu"}
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "rows.json"
    monkeypatch.setenv("RTM_BENCH_OUT", str(out))
    assert backends.main(["mxu", "--device", "cpu"]) == 0
    assert [r["backend"] for r in json.loads(out.read_text())["rows"]] \
        == ["mxu"]
    assert list(tmp_path.iterdir()) == [out]


@pytest.mark.parametrize("main", [headline.main, backends.main, grad.main,
                                  bigscene.main],
                         ids=["headline", "backends", "grad", "bigscene"])
def test_drivers_need_the_card_unless_asked(monkeypatch, capsys, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "--device cpu" in cap.err
