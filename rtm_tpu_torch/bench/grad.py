"""fwd+bwd throughput at the headline config (BASELINE.md row 2).

    python -m rtm_tpu_torch.bench.grad [res] [bounces] [--device cuda|cpu]

Port of scripts/bench_grad.py.  Times `loss_and_grad` of the pixel-L2 loss
on scene 3 at res x res (512) and `bounces` (8) through RTM_BENCH_BACKEND
(wavefront2), beside the forward alone: rows `fwd` (render_dispatch),
`fwd_loss(bands=N)` (render_loss) and `fwd_bwd(bands=N)` (loss_and_grad),
each one untimed call (`compile_s`: the first use, builds included) and 8
timed ones, host clock around work that ends on the device.  Bands and
remat follow the script's rule (`grad_plan`).  Each row adds the loss it
computed and the peak device memory of its calls (`peak_mib`,
max_memory_allocated after reset_peak_memory_stats; "not measured" on the
CPU).  One JSON row per line on stdout; a file only where RTM_BENCH_OUT
names one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .protocol import (bench_device, device_identity, dispatcher,
                       timed_calls)

REPS = 8


def grad_plan(backend: str, res: int) -> tuple[int, bool]:
    """(bands, remat), bench_grad.py's rule: the mxu record replay runs
    whole (bands 1) and stores its residuals (remat False); the other
    routes take RTM_GRAD_BANDS bands, by default 8 at res >= 512 and 1
    below, and recompute each bounce in the backward (remat True)."""
    if backend.startswith("mxu"):
        return 1, False
    return int(os.environ.get("RTM_GRAD_BANDS", 8 if res >= 512 else 1)), True


def run(device, res: int = 512, bounces: int = 8, reps: int = REPS):
    from .. import Camera, RenderConfig, build_tracer_scene, load_scene
    from ..diff import extract_params, loss_and_grad, render_loss

    backend = os.environ.get("RTM_BENCH_BACKEND", "wavefront2")
    cfg = RenderConfig(width=res, height=res, max_bounces=bounces,
                       max_frames=1, draw_environment=True)
    scene = build_tracer_scene(load_scene(3), device=device)
    cam = Camera().spec(res, res, device=scene.device)
    params = extract_params(scene)
    target = torch.full((res, res, 3), 0.3, dtype=torch.float32,
                        device=scene.device)
    bands, remat = grad_plan(backend, res)
    ident = device_identity(scene.device)
    on_card = scene.device.type == "cuda"
    rays = res * res * bounces

    def fwd_loss(fi):
        with torch.no_grad():
            return render_loss(params, scene, cam, target, fi, cfg, backend,
                               remat, False, bands=bands)

    def fwd_bwd(fi):
        return loss_and_grad(params, scene, cam, target, fi, cfg, backend,
                             remat, False, bands=bands)

    rows = []
    for name, f, frame in (("fwd", dispatcher(scene, cam, cfg, backend), 1),
                           (f"fwd_loss(bands={bands})", fwd_loss, 1),
                           (f"fwd_bwd(bands={bands})", fwd_bwd, 2)):
        if on_card:
            torch.cuda.synchronize(scene.device)
            torch.cuda.reset_peak_memory_stats(scene.device)
        dt, comp, out = timed_calls(f, frame, reps)
        row = {"metric": name, "ms": round(dt * 1e3, 2),
               "grays_per_s": round(rays / dt / 1e9, 4),
               "compile_s": round(comp, 1), "backend": backend,
               "remat": remat,
               "config": f"scene3 {res}x{res} x{bounces} bounces",
               "peak_mib": (round(torch.cuda.max_memory_allocated(
                   scene.device) / 2 ** 20, 1) if on_card
                   else "not measured"),
               "device": ident}
        if name != "fwd":
            row["loss"] = float(out[0] if isinstance(out, tuple) else out)
        rows.append(row)
    print(f"# fwd_bwd / fwd_loss = {rows[2]['ms'] / rows[1]['ms']:.2f}x "
          f"({backend}, bands={bands}, remat={remat})", file=sys.stderr,
          flush=True)
    out_path = os.environ.get("RTM_BENCH_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"rows": rows}, f, indent=1)
        print(f"# wrote {out_path}", file=sys.stderr, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("res", nargs="?", type=int, default=512)
    ap.add_argument("bounces", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = bench_device("bench.grad", args.device)
    if device is None:
        return 2
    for row in run(device, args.res, args.bounces):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
