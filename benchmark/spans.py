"""Reading the program's own spans (`rtm_tpu_torch/utils/tracing.py`,
host events named `rtm.*`) from a traced window.

Only complete spans count: those recorded on the window's thread that
start and end inside the window.  A span's host time is its duration.
Its device time is the device us that the profiler hung on the host
operations that started inside it (each device operation hangs on the one
host operation that launched it, so it counts once however those nest;
overlapping spans of one name are merged first).  Each idle gap of the
device goes to the innermost span open on the window's thread when the
gap began, or to None outside every span.  A program without the spans
gives no spans, and every reader here then returns None.
"""
from __future__ import annotations

import bisect

PREFIX = "rtm."


def complete(tr, name: str) -> list:
    """Sorted (start, end) of the complete spans `name` of the window."""
    w0, w1 = tr.window
    return sorted((s, e) for s, e, n, th, _ in tr.host
                  if n == name and th == tr.thread and w0 <= s and e <= w1)


def _merged(spans) -> tuple:
    """(starts, ends) of the union of the (start, end) spans."""
    starts, ends = [], []
    for s, e in sorted(spans):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def _within(merged, t) -> bool:
    starts, ends = merged
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def host_s(tr, name: str, less: str | None = None):
    """Host seconds inside the spans `name`, less those inside the spans
    `less` that start within them; None where the window has no `name`."""
    spans = complete(tr, name)
    if not spans:
        return None
    total = sum(e - s for s, e in spans)
    if less is not None:
        outer = _merged(spans)
        total -= sum(e - s for s, e in complete(tr, less)
                     if _within(outer, s))
    return total / 1e6


def device_s(tr, name: str):
    """Device seconds of the operations launched by host operations that
    started inside the spans `name` (the span's own event among them);
    None where the window has no `name`."""
    spans = _merged(complete(tr, name))
    if not spans[0]:
        return None
    return sum(dev for s, _, _, th, dev in tr.host
               if dev and th == tr.thread and _within(spans, s)) / 1e6


def idle_gaps(tr) -> list:
    """(start, end) of the device's idle gaps inside the window."""
    w0, w1 = tr.window
    gaps, cur = [], w0
    for s, e in tr.busy_intervals():
        if s > cur:
            gaps.append((cur, min(s, w1)))
        cur = max(cur, e)
        if cur >= w1:
            break
    if cur < w1:
        gaps.append((cur, w1))
    return [(a, b) for a, b in gaps if b > a]


def innermost(tr) -> tuple:
    """(times, names): from times[i] on, until times[i + 1], the innermost
    complete span open on the window's thread is names[i] (None: none)."""
    w0, w1 = tr.window
    spans = sorted((s, e, n) for s, e, n, th, _ in tr.host
                   if n.startswith(PREFIX) and th == tr.thread
                   and w0 <= s and e <= w1)
    times, names, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            times.append(end)
            names.append(stack[-1][2] if stack else None)

    for span in spans:
        close_until(span[0])
        stack.append(span)
        times.append(span[0])
        names.append(span[2])
    close_until(float("inf"))
    return times, names


def idle_by_span(tr) -> dict:
    """Idle seconds of the window by the innermost span open when each
    gap began: {name or None: seconds}; {} where the window has no
    spans."""
    times, names = innermost(tr)
    if not times:
        return {}
    by = {}
    for g0, g1 in idle_gaps(tr):
        i = bisect.bisect_right(times, g0) - 1
        name = names[i] if i >= 0 else None
        by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
    return by
