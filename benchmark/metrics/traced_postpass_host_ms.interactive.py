"""Host ms per frame inside the program's `rtm.postpass` span, read under
the profiler (which slows the host)."""
from benchmark import spans
from benchmark.readers import per_unit


def read(ctx):
    s = ctx.trace_data and spans.host_s(ctx.trace_data, "rtm.postpass")
    return None if s is None else per_unit(ctx, s * 1e3)
