"""Large-scene benchmark: trav against the megakernel (or wavefront2) where
the mxu tables end.

    python -m rtm_tpu_torch.bench.bigscene [res] [bounces] [--device cuda|cpu]

Port of scripts/bigscene_bench.py and scripts/trav_bench.py.  The scenes
are the triangle counts rtm_tpu ran, 6,968, 15,678 and 62,712 (1,742 * k^2
for k = 2, 3, 6 with the dragon asset): each is `dragon_grid(k)` with
k = round(sqrt(target / triangles per dragon)) of the mesh actually loaded
(`grid_for`), so k = 19, 28 and 56 with the 20-triangle stand-in.  At
res x res (256) and `bounces` (4), each scene renders through what a user
gets: trav where its tables take the scene, then the megakernel where
`megakernel_fits` holds and wavefront2 where it does not.  Each backend:
one untimed dispatch (`compile_s`) and RTM_BIGSCENE_REPS (5) timed ones,
host clock around work that ends on the device; frame 1 of the two
backends against each other (`cross_backend_max_diff`).  For trav, its
node visits and triangle tests per live ray-bounce (`trav_work`).  One
JSON row per scene on stdout.  A backend that fails fails the run (exit
1): nothing is recorded in its place.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback

import torch

from .protocol import (bench_device, device_identity, dispatcher, knob,
                       timed_calls)

TRIANGLE_TARGETS = (6968, 15678, 62712)


def grid_for(target: int, tris_per_dragon: int) -> int:
    """The dragon_grid size whose triangle count is nearest `target`."""
    return round((target / tris_per_dragon) ** 0.5)


def trav_work(scene, cam, frame_index: int, cfg) -> tuple[int, int, int]:
    """(node visits, triangle tests, live ray-bounces) of one trav dispatch
    (render_rays_trav(with_stats=True)).  Every ray alive at a bounce's
    start tests the root node, a dead one tests nothing, and a ray's first
    b bounces do not depend on max_bounces; so a slot's visits grow from
    the dispatch of b - 1 bounces to that of b exactly when it was alive at
    bounce b, and the dispatches of 1 .. max_bounces bounces count the live
    ray-bounces."""
    from ..ops.kernels.trav_kernel import render_rays_trav

    n = cfg.width * cfg.height
    prev = torch.zeros(n, dtype=torch.int32, device=scene.device)
    live = 0
    for b in range(1, cfg.max_bounces + 1):
        _, stats = render_rays_trav(
            scene, cam, frame_index, dataclasses.replace(cfg, max_bounces=b),
            pixel_offset=0, n_rays=n, skip_postpass=True, with_stats=True)
        if bool((stats[0] < prev).any()):
            raise RuntimeError("trav node visits fell with more bounces")
        live += int((stats[0] > prev).sum())
        prev = stats[0]
    return int(stats[0].sum()), int(stats[1].sum()), live


def run_scene(k: int, res: int, bounces: int, reps: int, device) -> dict:
    from .. import Camera, RenderConfig, build_tracer_scene
    from ..models.scenes import dragon_grid
    from ..ops.kernels.megakernel import megakernel_fits

    cfg = RenderConfig(width=res, height=res, max_bounces=bounces,
                       max_frames=1, draw_environment=True)
    scene = build_tracer_scene(dragon_grid(k), device=device)
    cam = Camera().spec(res, res, device=scene.device)
    tm = scene.trav_meta
    row = {"grid": f"{k}x{k}", "n_tris": scene.num_triangles,
           "trav_supported": bool(tm.supported), "leaf_k": tm.leaf_k,
           "n_leaves": tm.n_leaves, "n_nodes": tm.n_nodes,
           "megakernel_fits": bool(megakernel_fits(scene, cfg))}
    print(f"# {row}", file=sys.stderr, flush=True)
    backends = ["trav"] if tm.supported else []
    backends.append("megakernel" if row["megakernel_fits"] else "wavefront2")

    imgs = []
    for backend in backends:
        dispatch = dispatcher(scene, cam, cfg, backend)
        dt, comp, _ = timed_calls(dispatch, 1, reps)
        row[f"{backend}_ms"] = round(dt * 1e3, 2)
        row[f"{backend}_compile_s"] = round(comp, 1)
        imgs.append(dispatch(1))
        print(f"#   {backend}: {dt * 1e3:.2f} ms", file=sys.stderr, flush=True)
    if len(imgs) == 2:
        row["cross_backend_max_diff"] = round(
            float((imgs[0] - imgs[1]).abs().max()), 5)
    if tm.supported:
        with torch.no_grad():
            visits, tests, live = trav_work(scene, cam, 2, cfg)
        row.update(live_ray_bounces=live,
                   node_visits_per_live=round(visits / max(live, 1), 4),
                   tri_tests_per_live=round(tests / max(live, 1), 4))
    row["device"] = device_identity(scene.device)
    return row


def main(argv=None) -> int:
    from ..models.scenes import dragon_grid

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("res", nargs="?", type=int, default=256)
    ap.add_argument("bounces", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = bench_device("bench.bigscene", args.device)
    if device is None:
        return 2
    reps = knob("RTM_BIGSCENE_REPS", 5)
    per_dragon = dragon_grid(1).meshes[0].num_triangles
    try:
        for target in TRIANGLE_TARGETS:
            row = run_scene(grid_for(target, per_dragon), args.res,
                            args.bounces, reps, device)
            print(json.dumps(row), flush=True)
    except Exception:                   # a failed backend fails the run
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
