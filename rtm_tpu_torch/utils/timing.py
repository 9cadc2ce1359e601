"""Nanosecond timer returning milliseconds as float.

Port of rtm_tpu/utils/timing.py, parity with ``RT::Timer``
(Engine/src/Engine/Core/Time.h:12-30).  PyTorch returns before the card
finishes, so a device measurement brackets the work with
`torch.cuda.synchronize` (where rtm_tpu blocks on its JAX arrays).
"""
from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter_ns()

    def elapsed_ms(self) -> float:
        """Milliseconds since construction/reset (reference `Ellapsed`)."""
        return (time.perf_counter_ns() - self._start) / 1e6


def synchronize(result=None):
    """Wait for the card's queued work when `result` (a tensor, or a tuple
    or list of them) lies on it; returns `result`."""
    items = result if isinstance(result, (tuple, list)) else (result,)
    for t in items:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
    return result


def device_timed_ms(fn, *args, warmup: int = 1, iters: int = 10):
    """Run `fn(*args)`, synchronised, `warmup` times untimed and `iters`
    times timed: returns (mean ms, last result).  The analog of the
    reference's GPU-time measurement around beginFrame..endFrame
    (RayTracing/src/RayTracing.cpp:505-518)."""
    result = None
    for _ in range(max(warmup, 0)):
        result = synchronize(fn(*args))
    t = Timer()
    for _ in range(iters):
        result = synchronize(fn(*args))
    return t.elapsed_ms() / iters, result
