#!/usr/bin/env python3
"""Host waits, device busy time and frame time of the port's main path
([main]: scene 3, 512x512, 8 bounces, render_progressive, auto -> mxu) on
one CUDA card, for one checkout.

    python3 frame_waits.py [--tree DIR]

--tree is the checkout whose rtm_tpu_torch is measured (default: the one
beside this file), so one command can measure a parent checkout and this
one in turns (unpack the parent with `git archive` into the git-ignored
`_trees/`, then run parent, this, this, parent).  For the camera spec on
the CPU and on the card, in turns cpu, card, card, cpu, it prints one
JSON line each: ms/frame by CUDA events over FRAMES frames after WARM
(unprofiled), then over PROFILED frames under torch.profiler the host
waits per frame (cudaStreamSynchronize, pageable and pinned host-to-device
copies, device-to-host copies), the device's busy ms per frame and
launches, the idle share against the unprofiled frame time, the image's
SHA-256 (equal across checkouts whose frames are bitwise equal), and the
card's nvidia-smi name and power limit.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

# this checkout's helpers, imported before --tree joins the path (a tree
# has a chip_smoke.py of its own)
from chip_smoke import host_wait_counts, nvidia_smi_line, profile_window

WARM, FRAMES, PROFILED = 5, 32, 10


def measure(scene, spec, cfg) -> dict:
    import torch

    from rtm_tpu_torch import render_progressive

    render_progressive(scene, spec, cfg, WARM)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    img = render_progressive(scene, spec, cfg, FRAMES)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / FRAMES
    w = host_wait_counts(profile_window(
        lambda: render_progressive(scene, spec, cfg, PROFILED)), PROFILED)
    return {"ms_per_frame": ms,
            "device_busy_ms_per_frame": w["device_busy_ms"],
            "idle_share_unprofiled": 1.0 - w["device_busy_ms"] / ms,
            "cudaStreamSynchronize_per_frame": w["cudaStreamSynchronize"],
            "cudaDeviceSynchronize_per_frame": w["cudaDeviceSynchronize"],
            "memcpy_HtoD_pageable_per_frame": w["HtoD_pageable"],
            "memcpy_HtoD_pinned_per_frame": w["HtoD_pinned"],
            "memcpy_DtoH_per_frame": w["DtoH"],
            "device_launches_per_frame": w["device_launches"],
            "image_sha256": hashlib.sha256(
                img.cpu().numpy().tobytes()).hexdigest()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    if not (tree / "rtm_tpu_torch").is_dir():
        print(f"frame_waits: no rtm_tpu_torch in {tree}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("frame_waits: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    torch.backends.cuda.matmul.allow_tf32 = False

    from rtm_tpu_torch import (Camera, RenderConfig, build_tracer_scene,
                               load_scene)

    card = nvidia_smi_line()
    scene = build_tracer_scene(load_scene(3))
    cfg = RenderConfig(width=512, height=512, max_bounces=8, max_frames=1,
                       draw_environment=True, accumulate=True)
    for where in ("cpu", "card", "card", "cpu"):
        spec = Camera().spec(cfg.width, cfg.height,
                             device="cpu" if where == "cpu" else scene.device)
        row = {"tree": str(tree), "spec": where, **measure(scene, spec, cfg),
               "card": card}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
