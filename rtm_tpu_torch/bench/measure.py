"""Orbit-camera perf harness — reference Measure parity.

Port of rtm_tpu/bench/measure.py, the reference's measurement loop
(RayTracing/src/RayTracing.cpp:151-160,597-620): the camera orbits the
scene on a radius-2 circle; every `frames_per_sample` frames (3 in the
reference) the average frame time is appended to `Measure.txt` as one
`angle avg_ms` line, advancing the angle 1 degree until 360.
`view_perf.py` post-processes the file like the reference's viewPerf.py.

Each sample window ends in `torch.cuda.synchronize` on the card, so it
holds the device time of its frames, not only their launches.
"""
from __future__ import annotations

import numpy as np

from ..config import RenderConfig
from ..models.camera import Camera
from ..utils.logging import get_logger
from ..utils.timing import Timer, synchronize

log = get_logger("app")


def run_measure(scene, cfg: RenderConfig, out_path: str = "Measure.txt",
                radius: float = 2.0, frames_per_sample: int = 3,
                angle_step: float = 1.0, backend: str = "xla",
                camera: Camera | None = None):
    """Sweep 360 deg; write `angle avg_ms` per sample.  Returns the (angle,
    avg_ms) array."""
    from ..ops.trace_ref import render_dispatch

    cam = camera or Camera()
    cam.orbit(0.0, radius)
    # warm-up frame outside the timed loop (kernel build and first launch)
    synchronize(render_dispatch(scene, cam.spec(cfg.width, cfg.height,
                                                device=scene.device), 1,
                                cfg, backend=backend))

    rows = []
    angle = 0.0
    frame_index = 0
    with open(out_path, "w") as fh:
        while angle < 360.0:
            cam.orbit(angle, radius)
            spec = cam.spec(cfg.width, cfg.height, device=scene.device)
            timer = Timer()
            out = None
            for _ in range(frames_per_sample):
                frame_index += 1
                out = render_dispatch(scene, spec, frame_index, cfg,
                                      backend=backend)
            synchronize(out)
            avg_ms = timer.elapsed_ms() / frames_per_sample
            fh.write(f"{angle:g} {avg_ms:g}\n")
            rows.append((angle, avg_ms))
            angle += angle_step
    arr = np.asarray(rows, np.float64)
    log.info("measure: %d samples -> %s", len(rows), out_path)
    return arr


def summarize(arr: np.ndarray) -> dict:
    """viewPerf.py:4-17 parity: FPS = 1000/ms, report mean/max/min."""
    fps = 1000.0 / arr[:, 1]
    return {"mean_fps": float(fps.mean()), "max_fps": float(fps.max()),
            "min_fps": float(fps.min())}
