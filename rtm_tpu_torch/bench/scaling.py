"""Rays per second of the sharded renderer against the world size.

    python -m rtm_tpu_torch.bench.scaling [--worlds 1,2,4] [--out scaling.csv]
        [--band 64] [--width 256] [--bounces 4] [--scene 3]
        [--backend mxu] [--repeats 5] [--device cuda|cpu]

Port of scripts/scaling.py.  For each world size it spawns that many ranks
(parallel/smoke.py spawn_world) and times render_sharded:
  * weak scaling: each rank traces a band of `--band` rows of a
    `--width`-wide frame, so the frame grows with the world;
  * strong scaling: one fixed frame of `--band * max(worlds)` rows.
rays/s = W * H * bounces / (host seconds per frame, every rank
synchronised on its card).  Efficiency, weak: rays_per_s(n) /
(n * rays_per_s(1)); strong: t(1) / (n * t(n)).  It is computed only where
every rank has a GPU of its own.  Ranks that share a card (more ranks
than GPUs, over gloo), or the CPU's cores, measure contention, not
scaling: those rows are labelled so and carry no efficiency.  Writes a CSV
and prints it.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist


def scaling_rank(mesh, dev, args, height: int):
    """Rank body: host ms per render_sharded frame of a width x height
    frame, every rank starting together and synchronised at the end."""
    from ..config import RenderConfig
    from ..models.camera import Camera
    from ..models.scene import build_tracer_scene
    from ..models.scenes import load_scene
    from ..parallel.sharding import DP_AXIS, render_sharded

    group = mesh.get_group(DP_AXIS)
    scene = build_tracer_scene(load_scene(args.scene), device=dev)
    cfg = RenderConfig(width=args.width, height=height,
                       max_bounces=args.bounces, draw_environment=True)
    cam = Camera().spec(cfg.width, cfg.height, device=dev)

    def frame(fi):
        img = render_sharded(scene, cam, fi, cfg, mesh, backend=args.backend)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return img

    frame(1)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for i in range(args.repeats):
        frame(2 + i)
    dist.barrier(group=group)
    return (time.perf_counter() - t0) / args.repeats


def main(argv=None) -> int:
    from ..parallel.smoke import build_in_parent, pick_backend, spawn_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", default="1,2,4")
    ap.add_argument("--out", default="scaling.csv")
    ap.add_argument("--band", type=int, default=64,
                    help="pixel rows per rank (the weak-scaling unit)")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--scene", type=int, default=3)
    ap.add_argument("--backend", default="mxu")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    worlds = sorted({int(w) for w in args.worlds.split(",")})
    gpus = torch.cuda.device_count() if args.device == "cuda" else 0
    if args.device == "cuda":
        where = f"{gpus} x {torch.cuda.get_device_name(0)}"
    else:
        where = "cpu"
    build_in_parent(args.device)

    rows = []
    for mode in ("weak", "strong"):
        base = None
        for n in worlds:
            height = args.band * (n if mode == "weak" else max(worlds))
            secs = spawn_world(n, scaling_rank, (args, height),
                               device=args.device)
            sec = max(secs)
            rps = args.width * height * args.bounces / sec
            own_gpu = args.device == "cuda" and n <= gpus
            if base is None:
                base = (rps, sec)
            if not own_gpu:
                label, eff = "contention", ""
            elif mode == "weak":
                label, eff = "scaling", f"{rps / (n * base[0]):.4f}"
            else:
                label, eff = "scaling", f"{base[1] / (n * sec):.4f}"
            rows.append((mode, n, pick_backend(n, args.device),
                         -(-n // max(gpus, 1)) if gpus else "",
                         args.width, height, f"{sec * 1e3:.4f}",
                         f"{rps:.1f}", label, eff))
    head = ("mode", "world", "backend", "ranks_per_gpu", "width", "height",
            "ms_per_frame", "rays_per_s", "measures", "efficiency")
    lines = [f"# render_sharded, scene {args.scene}, {args.bounces} "
             f"bounces, backend={args.backend}, {args.repeats} frames per "
             f"world, on {where}; 'contention' rows share a card or the "
             f"CPU and carry no efficiency", ",".join(head)]
    lines += [",".join(str(v) for v in r) for r in rows]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
