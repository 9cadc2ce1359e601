"""Reading a torch.profiler window: device busy time, idle share, the
costliest device operations, the longest idle gaps by what the host was
doing, launch API calls and the device time of the autograd backward.

The busy arithmetic is frame_waits.py's: the window is
the host-side span the benchmark marks around its calls (its device-side
copy and the profiler's own closing synchronise are left out), and the
device's busy time is the union of its kernel, copy and set intervals.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

WINDOW = "benchmark_window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
                "cudaMemsetAsync", "cudaMemset", "cuMemcpyAsync",
                "cuMemcpyHtoDAsync_v2", "cuMemcpyDtoHAsync_v2",
                "cudaGraphLaunch")
BACKWARD = "autograd::engine::evaluate_function"


@dataclass
class Trace:
    """The events of one profiled window, times in microseconds."""

    window: tuple            # (start, end) of the host-side span
    device: list             # (start, end, name)
    host: list               # (start, end, name, thread, device us of
    #                          the operations it launched itself)
    units: int = 0           # dispatches / frames / steps in the window
    thread: int = 0          # the host thread that ran the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self, keep=None):
        """Merged (start, end) intervals of the device events (those whose
        name `keep` accepts, when given)."""
        w0, w1 = self.window
        ev = sorted((max(s, w0), min(e, w1)) for s, e, n in self.device
                    if keep is None or keep(n))
        out = []
        for s, e in ev:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self, keep=None) -> float:
        return sum(e - s for s, e in self.busy_intervals(keep)) / 1e6

    def device_ops(self, n: int = 10):
        by = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The idle gaps of the device inside the window, summed by the
        innermost host operation running on the window's thread when each
        gap began: [[name, seconds], ...], the largest first."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        gaps, cur = [], w0
        for s, e in busy:
            if s > cur:
                gaps.append((cur, min(s, w1)))
            cur = max(cur, e)
            if cur >= w1:
                break
        if cur < w1:
            gaps.append((cur, w1))
        ops = sorted((h[0], h[1], h[2]) for h in self.host
                     if h[3] == self.thread and h[2] != WINDOW)
        starts = [o[0] for o in ops]
        by = {}
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            name = "(between host operations)"
            i = bisect.bisect_right(starts, g0) - 1
            for j in range(i, max(i - 256, -1), -1):
                if ops[j][1] >= g0:
                    name = ops[j][2]
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def launch_calls(self) -> int:
        return sum(1 for h in self.host if h[2] in LAUNCH_CALLS)

    def backward_device_s(self) -> float:
        """Device seconds of the operations launched by host operations
        that ran inside the autograd engine's evaluate_function spans (the
        profiler hangs each device operation on the host operation that
        launched it)."""
        spans = {}
        for s, e, name, th, _ in self.host:
            if name.startswith(BACKWARD):
                spans.setdefault(th, []).append((s, e))
        merged = {}
        for th, sp in spans.items():
            out = []
            for s, e in sorted(sp):
                if out and s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            merged[th] = ([a for a, _ in out], [b for _, b in out])
        total = 0.0
        for s, _, _, th, dev_us in self.host:
            if dev_us and th in merged:
                st, en = merged[th]
                i = bisect.bisect_right(st, s) - 1
                if i >= 0 and s <= en[i]:
                    total += dev_us
        return total / 1e6


class Profiler:
    """torch.profiler (CPU and CUDA activities) over one WINDOW span,
    started and stopped by hand so that a loop can open it between two of
    its steps.  The caller ends its own work with a synchronise before
    `stop`, so the span covers the device's work; the profiler's closing
    synchronise falls outside it."""

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW)
        self._span.__enter__()

    def stop(self, units: int) -> Trace:
        import torch
        from torch.autograd import DeviceType

        self._span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        window, device, host, main = None, [], [], None
        for e in self._prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if e.name != WINDOW:
                    device.append((tr.start, tr.end, e.name))
            elif e.name == WINDOW:
                window, main = (tr.start, tr.end), e.thread
            else:
                host.append((tr.start, tr.end, e.name, e.thread,
                             sum(k.duration for k in e.kernels)))
        self._prof = self._span = None
        self.events = len(device) + len(host)
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        return Trace(window=window, device=device, host=host, units=units,
                     thread=main)
