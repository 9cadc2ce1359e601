"""Progressive rendering to convergence: one user, a fixed camera, closed
loop.

Traffic keys: `spp` (samples per dispatch), `warm_dispatches`,
`camera_jitter` (the seed moves the fixed camera by up to this much in x
and y, so seeds render other images with the same work),
`trace_seconds`.  The cell's limits file gives `check_pixels`.

Set-up builds the scene, warms the route up with `warm_dispatches`
dispatches through `ProgressiveRenderer.step_async` and resets the
accumulation.  The window enqueues dispatches through `step_async` until
`--seconds` have passed, then waits for the last one and reads the
accumulated image to the host.  grays_per_s = W * H * spp * bounces *
dispatches / window seconds.

The check: the first dispatch of the window and one more drawn from the
seed are compared with the reference over every pixel (share of pixels
off by more than the tolerance), and the accumulated image over all the
window's dispatches at `check_pixels` pixels drawn from the seed (the
relative L1 gap).
"""
from __future__ import annotations

from benchmark import program
from benchmark.loops import Outcome, render_check


def run(ctx) -> Outcome:
    from rtm_tpu_torch import ProgressiveRenderer, build_tracer_scene

    tr, r = ctx.traffic, ctx.desc.render
    spp = tr["spp"]
    cam_desc = dict(ctx.desc.camera)
    jit = ctx.rng(1).uniform(-1.0, 1.0, 2) * tr["camera_jitter"]
    cam_desc["position"] = [cam_desc["position"][0] + float(jit[0]),
                            cam_desc["position"][1] + float(jit[1]),
                            cam_desc["position"][2]]
    with ctx.span("scene_build"):
        ts = build_tracer_scene(program.port_scene(ctx.desc),
                                device=ctx.device)
        ctx.sync()
    cfg = program.render_config(r, spp)
    pr = ProgressiveRenderer(ts, camera=program.port_camera(cam_desc),
                             cfg=cfg, backend=r["route"])
    t = ctx.clock()
    pr.step_async()
    ctx.sync()
    ctx.split["first_dispatch_s"] = ctx.clock() - t
    for _ in range(tr["warm_dispatches"] - 1):
        pr.step_async()
    ctx.sync()
    pr.reset()
    ctx.sync()

    pick = ctx.rng(2)
    first = drawn = prev = None
    n = 0
    deadline = ctx.seconds

    def dispatch():
        nonlocal n, first, drawn, prev
        out = pr.step_async()
        n += 1
        if n == 1:
            first = out
        elif pick.random() * (n - 1) < 1.0:      # uniform over 2..n
            drawn = (n, prev, out)
        prev = out

    t0 = ctx.open_window()
    while ctx.clock() - t0 < deadline:
        dispatch()
    ctx.sync()
    pr.accum.cpu()
    t1 = ctx.clock()
    window_n = n
    ctx.work.update(dispatches=n, window_s=t1 - t0)
    e2e = {"grays_per_s": (cfg.width * cfg.height * spp * cfg.max_bounces
                           * n / (t1 - t0) / 1e9)}
    if ctx.trace:
        from benchmark.devtrace import Profiler

        prof = Profiler()
        prof.start()
        t2 = ctx.clock()
        while ctx.clock() - t2 < tr["trace_seconds"]:
            dispatch()
        ctx.sync()
        pr.accum.cpu()
        ctx.trace_data = prof.stop(units=n - window_n)
        ctx.work.update(traced=n - window_n, trace_events=prof.events,
                        trace_read_s=ctx.clock() - t2
                        - tr["trace_seconds"])
    accum = pr.accum.cpu().numpy().reshape(-1, 3)
    k_total = pr.frame_index
    kept = [(1, None, first.cpu().numpy())]
    if drawn is not None:
        k, a, b = drawn
        kept.append((k, a.cpu().numpy(), b.cpu().numpy()))
    state = {"pr": pr, "ts": ts, "first": first, "drawn": drawn,
             "prev": prev}

    def release():
        state.clear()

    def check():
        return render_check(ctx, cam_desc, spp, accum, k_total, kept)

    return Outcome(e2e=e2e, attempted=n, check=check, release=release)
