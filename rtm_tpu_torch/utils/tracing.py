"""Named spans of the port's layers in `torch.profiler`'s timeline.

`span(name)` marks a block (`with span("rtm.dispatch"): ...`) or a whole
function (`@span("rtm.dispatch")`).  While a profiler runs (`torch.profiler`,
as `bench/profile.py` `trace` starts one), the block becomes a host event of
that name in its trace, on the same clock as the device's kernels and copies;
spans opened inside it on the same thread nest inside it there.  While none
runs, a span reads one flag and calls nothing in torch: no allocation, no
clock read, no device work, so a frame's bits and its host waits are the
same either way.

The event is a record of the profiler's FUNCTION scope, as an aten op's is,
and not a `torch.profiler.record_function` annotation: the profiler draws
each such user annotation a second time on the device's timeline, from the
first kernel launched under it to the last, and a reader of the trace's
device events would count that stretch as busy.  A kernel launched under a
span with no aten op around it (the ctypes launches of `csrc/`) is hung on
the span's event, as an aten op's kernels are hung on the op.
"""
from __future__ import annotations

import functools

import torch
import torch.autograd.profiler as _profiler

_RECORD = torch._C._profiler._RecordFunctionFast


class _Off:
    """A name's span while no profiler runs: does nothing; one per name."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _On(name):
                return fn(*args, **kwargs)
        return traced


class _On(_Off):
    """A span while a profiler runs: the profiler's record of the block."""

    __slots__ = ("_record",)

    def __enter__(self):
        self._record = _RECORD(self.name)
        self._record.__enter__()

    def __exit__(self, *exc):
        self._record.__exit__(*exc)


_OFF: dict[str, _Off] = {}


def span(name: str):
    """The span `name`: a context manager, or a decorator that spans each
    call of the function it decorates."""
    if not _profiler._is_profiler_enabled:
        off = _OFF.get(name)
        if off is None:
            off = _OFF[name] = _Off(name)
        return off
    return _On(name)
