"""Profiling and roofline helpers (SURVEY §5.1 parity).

Port of rtm_tpu/bench/profile.py.  The reference instruments frames with
RT::Timer and surfaces FPS / GPU time in the UI (Core/Time.h:12-30,
RayTracing.cpp:71-79).  Here: `torch.profiler` traces for op-level
analysis, a timer that waits for the device, and a static roofline
estimate of the megakernel pass from first principles.

This module is the one place that knows the card's peak rates and the
sweep's operation counts; `chip_smoke.py`'s bounds import them.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

from ..config import RenderConfig
from ..utils.timing import synchronize

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W power limit): HBM3
# bandwidth, FP32 outside the tensor cores, and BF16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
# FP32 operations of one (ray, row) pair of the sweep kernels
# (csrc/tri_sweep.cuh: det 6, tdet 6, udet 11, vdet 11, wdet 2, then the
# min-chain gate 6 + max and division 2 + the best-t compare 1 for the
# cluster sweep, or 5 compares + division + compare for the intersect
# kernel's strict gate) and of one ray's slab test against a cluster box
SWEEP_PAIR_OPS = 45
STRICT_PAIR_OPS = 43
SLAB_OPS = 25


@contextlib.contextmanager
def trace(logdir):
    """torch.profiler over the block (CPU, and CUDA when there is a card);
    on exit writes a Chrome trace (chrome://tracing, Perfetto) to
    `logdir`/trace.json, where the port's spans (`utils/tracing.py`, host
    events named `rtm.*`) hold the aten ops and kernels they caused.
    Yields the profiler (key_averages() etc.)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def time_fn(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean wall-clock seconds of fn(*args) over `iters` calls after
    `warmup`, waiting for the device's queued work (the card's, when the
    result lies on it) before starting and stopping the clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    synchronize(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    synchronize(out)
    return (time.perf_counter() - t0) / iters


def megakernel_roofline(cfg: RenderConfig, num_triangles: int,
                        num_spheres: int = 0,
                        fp32_ops_per_sec: float = FP32_OPS_PER_S) -> dict:
    """Static speed-of-light estimate for one forward dispatch of the dense
    sweep on the H100.

    The pair count is rtm_tpu's: every ray, every bounce, against the
    triangles padded to 128-row clusters and the spheres padded to 8.
    Each pair costs the sweep's FP32 operations (SWEEP_PAIR_OPS) at the
    card's FP32 rate.  Returns the pairs, the expected ms/frame and the
    implied Grays/s ceiling."""
    n_rays = cfg.num_pixels * cfg.max_frames
    t_pad = max(1, -(-num_triangles // 128)) * 128
    pairs = n_rays * cfg.max_bounces * (t_pad + ((num_spheres + 7) // 8) * 8)
    seconds = pairs * SWEEP_PAIR_OPS / fp32_ops_per_sec
    rays = cfg.num_pixels * cfg.max_frames * cfg.max_bounces
    return {
        "pairs": int(pairs),
        "ops_per_pair": SWEEP_PAIR_OPS,
        "fp32_seconds": seconds,
        "expected_ms_per_frame": seconds * 1e3,
        "ceiling_grays_per_sec": rays / seconds / 1e9,
        "note": "FP32-bound dense sweep at the H100's data-sheet rate; "
                "the pair-reduction levers (cluster culls, the BVH) cut "
                "the pairs, not the rate",
    }
