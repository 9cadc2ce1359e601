"""The timing protocol the benchmark drivers share.

Port of the protocol in bench.py and scripts/bench_backends.py:
  * the host clock around each block of `repeats` dispatches; a block ends
    when the device has finished its work (`torch.cuda.synchronize`) and
    one element of its last output has been read back to the host;
  * `interleaved_blocks`: one untimed warm-up block per backend, then timed
    blocks round-robin (A B C A B C ...), so drift over a session reaches
    every backend alike;
  * `median_spread`: the scripts' median, `sorted(xs)[len(xs) // 2]` (the
    upper median for an even count), with the min and the max.

First uses (nvcc's kernel libraries, g++'s native BVH builder) happen in a
driver's first dispatch or scene build, outside every timed window; the
drivers report them as `setup_s` / `compile_s`.  Every line a driver
prints carries `device_identity` of the device it measured.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import torch


def knob(name: str, default: int) -> int:
    """An integer environment knob (RTM_BENCH_WIDTH and the like)."""
    return int(os.environ.get(name, default))


def bench_device(prog: str, name: str) -> torch.device | None:
    """The device a driver measures on, or None, with a message naming
    `--device cpu` on stderr, when the card is asked for and there is none:
    a measurement never falls back to the CPU by itself."""
    if name == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device is available; pass --device cpu to "
              f"run on the CPU (the kernels' plain versions)",
              file=sys.stderr)
        return None
    return torch.device(name)


def device_identity(device) -> dict:
    """Where a measurement ran.  On the card: its name, the number of
    cards, and the power limit `nvidia-smi` reads (a card set below 700 W
    runs slower under load); on the CPU: {"platform": "cpu"}."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu"}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        idx = device.index if device.index is not None else 0
        power = out[idx].rsplit(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        power = "not measured"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "power_limit": power}


def dispatcher(scene, cam, cfg, backend: str):
    """dispatch(frame_index): one `render_dispatch` of `backend` without
    autograd, the call every timed frame makes."""
    from ..ops.trace_ref import render_dispatch

    def dispatch(frame_index: int) -> torch.Tensor:
        with torch.no_grad():
            return render_dispatch(scene, cam, frame_index, cfg,
                                   backend=backend)
    return dispatch


def finish(out: torch.Tensor) -> float:
    """Wait for the device's queued work and read one element of `out` to
    the host (bench.py reads one pixel): the end of a timed block."""
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    return float(out.reshape(-1)[0])


def timed_blocks(dispatch, blocks: int, repeats: int, first_frame: int,
                 clock=time.perf_counter) -> list[float]:
    """bench.py's timed loop: `blocks` blocks of `repeats` dispatches each,
    `dispatch(frame_index)` returning a tensor, frame indices rising from
    `first_frame` across blocks.  Returns each block's host seconds."""
    dts = []
    fi = first_frame
    for _ in range(blocks):
        t0 = clock()
        for _ in range(repeats):
            out = dispatch(fi)
            fi += 1
        finish(out)
        dts.append(clock() - t0)
    return dts


def interleaved_blocks(dispatches: dict, blocks: int, repeats: int,
                       first_frame: int = 2,
                       clock=time.perf_counter) -> dict[str, list[float]]:
    """scripts/bench_backends.py's protocol over `dispatches` (name ->
    dispatch(frame_index)): first one untimed warm-up block of
    max(2, repeats // 2) frames per backend, then `blocks` rounds of one
    timed block of `repeats` frames per backend, round-robin; one frame
    counter, from `first_frame`, shared by every backend.  Returns name ->
    each timed block's ms per frame."""
    fi = first_frame
    for dispatch in dispatches.values():
        for _ in range(max(2, repeats // 2)):
            out = dispatch(fi)
            fi += 1
        finish(out)
    times = {name: [] for name in dispatches}
    for _ in range(blocks):
        for name, dispatch in dispatches.items():
            t0 = clock()
            for _ in range(repeats):
                out = dispatch(fi)
                fi += 1
            finish(out)
            times[name].append((clock() - t0) / repeats * 1e3)
    return times


def timed_calls(f, frame: int, reps: int):
    """The scripts' `timeit`: one untimed call of f(frame) (its first use,
    builds included), then `reps` timed calls, the last one finished (its
    first tensor, or the tensor itself).  Returns (seconds per timed call,
    the first call's seconds, the last result)."""
    def first(out):
        return out[0] if isinstance(out, tuple) else out

    t0 = time.perf_counter()
    out = f(frame)
    finish(first(out))
    comp = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(frame)
    finish(first(out))
    return (time.perf_counter() - t0) / reps, comp, out


def median_spread(xs) -> tuple[float, float, float]:
    """(median, min, max) with the scripts' median: sorted(xs)[len // 2]."""
    s = sorted(xs)
    return s[len(s) // 2], s[0], s[-1]
