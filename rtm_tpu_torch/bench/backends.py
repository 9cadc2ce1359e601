"""Interleaved A/B comparison of the render routes at the headline config.

    python -m rtm_tpu_torch.bench.backends [backend ...] [--device cuda|cpu]

Port of scripts/bench_backends.py.  Backends default to mxu, megakernel,
trav and wavefront2 at bench.py's headline (scene 3, 512x512, 8 bounces,
spp 1; the RTM_BENCH_WIDTH / _HEIGHT / _BOUNCES / _SPP / _SCENE knobs),
each dispatch through `render_dispatch`.  Protocol
(`protocol.interleaved_blocks`): each backend's first dispatch (frame 1:
its kernel build and first launch, `compile_s`), one untimed warm-up block
per backend, then RTM_BENCH_BLOCKS (5) rounds of one timed block of
RTM_BENCH_REPEATS (10) frames per backend, round-robin, one frame counter
shared.  One JSON row per backend on stdout: backend, the route it took,
ms_per_frame (median block), ms_min, ms_max, grays_per_s, compile_s,
mean_radiance of frame 1, device.  Writes the rows to a JSON file only
when RTM_BENCH_OUT names one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .protocol import (bench_device, device_identity, dispatcher, finish,
                       interleaved_blocks, knob, median_spread)

DEFAULT_BACKENDS = ("mxu", "megakernel", "trav", "wavefront2")


def run(device, backends) -> list[dict]:
    from .. import Camera, RenderConfig, build_tracer_scene, load_scene
    from ..ops.trace_ref import resolve_route

    width = knob("RTM_BENCH_WIDTH", 512)
    height = knob("RTM_BENCH_HEIGHT", 512)
    bounces = knob("RTM_BENCH_BOUNCES", 8)
    spp = knob("RTM_BENCH_SPP", 1)
    scene_id = knob("RTM_BENCH_SCENE", 3)
    repeats = knob("RTM_BENCH_REPEATS", 10)
    blocks = knob("RTM_BENCH_BLOCKS", 5)

    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       max_frames=spp, draw_environment=True, accumulate=True)
    scene = build_tracer_scene(load_scene(scene_id), device=device)
    cam = Camera().spec(cfg.width, cfg.height, device=scene.device)
    ident = device_identity(scene.device)

    dispatches = {b: dispatcher(scene, cam, cfg, b) for b in backends}
    compile_s, mean_rad = {}, {}
    for backend, dispatch in dispatches.items():
        t0 = time.perf_counter()
        out = dispatch(1)
        finish(out)
        mean_rad[backend] = float(out.mean())
        compile_s[backend] = round(time.perf_counter() - t0, 1)
        print(f"# first dispatch of {backend} in {compile_s[backend]} s "
              f"(mean radiance {mean_rad[backend]:.6f})", file=sys.stderr,
              flush=True)

    times = interleaved_blocks(dispatches, blocks, repeats)
    rays = width * height * spp * bounces
    rows = []
    for backend in backends:
        med, lo, hi = median_spread(times[backend])
        rows.append({
            "backend": backend,
            "route": resolve_route(scene, cfg, backend),
            "ms_per_frame": round(med, 3),
            "ms_min": round(lo, 3),
            "ms_max": round(hi, 3),
            "grays_per_s": round(rays / med / 1e6, 4),
            "compile_s": compile_s[backend],
            "mean_radiance": round(mean_rad[backend], 6),
            "device": ident,
        })
    out_path = os.environ.get("RTM_BENCH_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({
                "config": f"scene {scene_id}, {width}x{height}, {bounces} "
                          f"bounces, spp {spp}",
                "protocol": f"interleaved round-robin, {blocks} blocks x "
                            f"{repeats} frames per backend after one "
                            "untimed warm-up block each; median + min/max",
                "rows": rows,
            }, f, indent=1)
        print(f"# wrote {out_path}", file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("backends", nargs="*",
                    help=f"render_dispatch backends (default: "
                         f"{' '.join(DEFAULT_BACKENDS)})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = bench_device("bench.backends", args.device)
    if device is None:
        return 2
    for row in run(device, args.backends or list(DEFAULT_BACKENDS)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
