"""Headline benchmark: forward path-tracing throughput on the Cornell box.

    python -m rtm_tpu_torch bench [--device cuda|cpu]
    python -m rtm_tpu_torch.bench.headline [--device cuda|cpu]

Port of bench.py.  Scene 3 (Cornell box + dragon), 512x512, 8 bounces,
1 sample per dispatch, progressive accumulation, `backend="auto"` (the mxu
kernel on scene 3), each dispatch through `render_dispatch`.  The same
environment knobs and defaults: RTM_BENCH_WIDTH (512), _HEIGHT (512),
_BOUNCES (8), _SPP (1), _SCENE (3), _BACKEND (auto), _REPEATS (20),
_BLOCKS (5).

One warm-up dispatch (frame 1: the scene's first use, kernel builds
included, reported with the scene build as `setup_s`), then
`protocol.timed_blocks` from frame 2.  Rays counted = W * H * spp *
bounces per dispatch, as bench.py counts them.  Prints ONE JSON line on
stdout, bench.py's keys and arithmetic:
  {"metric": "cornell_grays_per_s", "value": median Grays/s (4 places),
   "unit": "Grays/s/chip", "vs_baseline": median / 2.0,
   "spread": {"min", "max", "blocks", "repeats_per_block"},
   "device": {...}, "backend": the route that ran, "setup_s": seconds}
`vs_baseline` is the ratio to BASELINE.json's north-star target of
2 Grays/s per chip, a constant, not a measurement.  stderr gets a `# ...`
line: ms/frame median (min / max) and the kernel launches of the timed
blocks.  The camera spec is built on the scene's device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .protocol import (bench_device, device_identity, dispatcher, finish,
                       knob, median_spread, timed_blocks)

METRIC = "cornell_grays_per_s"
TARGET_GRAYS_PER_S = 2.0      # BASELINE.json's north-star target


def headline_line(width: int, height: int, spp: int, bounces: int,
                  repeats: int, block_s) -> dict:
    """bench.py's line from each block's host seconds."""
    rays = width * height * spp * bounces * repeats
    med, lo, hi = median_spread([rays / dt / 1e9 for dt in block_s])
    return {
        "metric": METRIC,
        "value": round(med, 4),
        "unit": "Grays/s/chip",
        "vs_baseline": round(med / TARGET_GRAYS_PER_S, 4),
        "spread": {"min": round(lo, 4), "max": round(hi, 4),
                   "blocks": len(block_s), "repeats_per_block": repeats},
    }


def run(device) -> dict:
    """Build, warm up and time the headline on `device`; returns the line
    and writes the `# ...` line to stderr."""
    from .. import Camera, RenderConfig, build_tracer_scene, load_scene
    from ..ops.kernels import kernel_wrappers
    from ..ops.trace_ref import resolve_route

    width = knob("RTM_BENCH_WIDTH", 512)
    height = knob("RTM_BENCH_HEIGHT", 512)
    bounces = knob("RTM_BENCH_BOUNCES", 8)
    spp = knob("RTM_BENCH_SPP", 1)
    scene_id = knob("RTM_BENCH_SCENE", 3)
    repeats = knob("RTM_BENCH_REPEATS", 20)
    blocks = knob("RTM_BENCH_BLOCKS", 5)
    backend = os.environ.get("RTM_BENCH_BACKEND", "auto")

    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       max_frames=spp, draw_environment=True, accumulate=True)
    t0 = time.perf_counter()
    scene = build_tracer_scene(load_scene(scene_id), device=device)
    cam = Camera().spec(cfg.width, cfg.height, device=scene.device)
    route = resolve_route(scene, cfg, backend)      # auto: auto_backend

    dispatch = dispatcher(scene, cam, cfg, route)
    finish(dispatch(1))
    setup_s = time.perf_counter() - t0

    kernels = kernel_wrappers()
    for k in kernels.values():
        k.launches = 0
    block_s = timed_blocks(dispatch, blocks, repeats, first_frame=2)
    launches = {name: k.launches for name, k in kernels.items()}

    line = headline_line(width, height, spp, bounces, repeats, block_s)
    line.update(device=device_identity(scene.device), backend=route,
                setup_s=round(setup_s, 3))
    # ms/frame from the rates, as bench.py prints it
    rays = width * height * spp * bounces
    med, lo, hi = median_spread([rays * repeats / dt / 1e9
                                 for dt in block_s])
    print(f"# device={scene.device} backend={route} {width}x{height} "
          f"bounces={bounces} spp={spp} median ms/frame="
          f"{rays / med / 1e6:.4f} (min {rays / hi / 1e6:.4f} / max "
          f"{rays / lo / 1e6:.4f}) launches={launches}",
          file=sys.stderr, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = bench_device("bench", args.device)
    if device is None:
        return 2
    print(json.dumps(run(device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
