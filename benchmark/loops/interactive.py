"""One user dragging the view: closed loop, one frame at a time.

Traffic keys: `spp`, `step` (the view moves this far per frame), `bounds`
(the box the camera's x and y stay in), `warm_frames`, `check_frames`,
`trace_seconds`.

Each frame: a step of the view drawn from the seed (right or up, either
sign, turned back at the bounds) through `ProgressiveRenderer.
move_camera`, which resets the accumulation; `step_async`; the display
image copied to the host.  frame_ms_p95 is the 95th percentile over every
frame of the window of the time from the move to the image on the host.

The check: `check_frames` frames drawn from the seed over the whole run
(a reservoir sample), each compared with the reference at its own camera
pose over every pixel.
"""
from __future__ import annotations


import numpy as np

from benchmark import program
from benchmark.harness import p95
from benchmark.loops import Outcome, reference_image

UP = np.array([0.0, 1.0, 0.0])


class Walk:
    """The camera's moves, drawn from the seed, and the pose they give,
    worked out here with Camera.move's arithmetic."""

    def __init__(self, rng, cam: dict, step: float, bounds: dict):
        self.rng, self.step, self.bounds = rng, step, bounds
        self.pos = np.asarray(cam["position"], np.float64)
        self.fwd = np.asarray(cam["direction"], np.float64)
        self.right = np.cross(self.fwd, UP)

    def next(self) -> dict:
        axis = int(self.rng.integers(2))
        sign = 1.0 if self.rng.random() < 0.5 else -1.0
        lo, hi = self.bounds["xy"[axis]]
        if not lo <= self.pos[axis] + sign * self.step <= hi:
            sign = -sign
        kw = {"right": sign * self.step} if axis == 0 else \
            {"up": sign * self.step}
        move = (0.0 * self.fwd + kw.get("right", 0.0) * self.right
                + kw.get("up", 0.0) * UP) * 1.0 * 1.0
        self.pos = self.pos + move
        return kw

    def pose(self, cam: dict) -> dict:
        return dict(cam, position=[float(v) for v in self.pos])


def run(ctx) -> Outcome:
    from rtm_tpu_torch import ProgressiveRenderer, build_tracer_scene

    tr, r = ctx.traffic, ctx.desc.render
    spp = tr["spp"]
    with ctx.span("scene_build"):
        ts = build_tracer_scene(program.port_scene(ctx.desc),
                                device=ctx.device)
        ctx.sync()
    cfg = program.render_config(r, spp)
    pr = ProgressiveRenderer(ts, camera=program.port_camera(ctx.desc.camera),
                             cfg=cfg, backend=r["route"])
    walk = Walk(ctx.rng(1), ctx.desc.camera, tr["step"], tr["bounds"])
    pick = ctx.rng(2)
    kept, n = [], 0
    lat = []

    def frame(record: bool):
        nonlocal n
        t = ctx.clock()
        pr.move_camera(**walk.next())
        s = ctx.clock()
        out = pr.step_async()
        e = ctx.clock()
        host = out.cpu()
        done = ctx.clock()
        if not record:
            return
        lat.append(done - t)
        ctx.spans.setdefault("step_async", []).append(e - s)
        n += 1
        item = (walk.pose(ctx.desc.camera), host)
        if len(kept) < tr["check_frames"]:
            kept.append(item)
        else:
            j = int(pick.integers(n))
            if j < len(kept):
                kept[j] = item

    t = ctx.clock()
    frame(False)
    ctx.split["first_dispatch_s"] = ctx.clock() - t
    for _ in range(tr["warm_frames"] - 1):
        frame(False)
    ctx.sync()
    t0 = ctx.open_window()
    while ctx.clock() - t0 < ctx.seconds:
        frame(True)
    window_lat = list(lat)
    ctx.work.update(frames=n, window_s=ctx.clock() - t0)
    e2e = {"frame_ms_p95": p95(window_lat) * 1e3}
    if ctx.trace:
        from benchmark.devtrace import Profiler

        prof = Profiler()
        prof.start()
        n0 = n
        t2 = ctx.clock()
        while ctx.clock() - t2 < tr["trace_seconds"]:
            frame(True)
        ctx.trace_data = prof.stop(units=n - n0)
        ctx.work.update(traced=n - n0, trace_events=prof.events)
        del ctx.spans["step_async"][-(n - n0):]
    kept = [(pose, host.numpy().reshape(-1, 3)) for pose, host in kept]
    state = {"pr": pr}

    def release():
        state.clear()

    def check():
        from benchmark.reference import compare
        from benchmark.reference import render as R

        sc = R.Scene(ctx.tables, ctx.device)
        bad = sum(compare.bad_pixels(img, reference_image(ctx, sc, pose,
                                                          spp, 1))
                  for pose, img in kept)
        return {"bad_pixel_share": bad / (len(kept) * r["width"]
                                          * r["height"])}

    return Outcome(e2e=e2e, attempted=len(window_lat), check=check,
                   release=release)
