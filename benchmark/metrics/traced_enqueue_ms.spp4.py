"""Host ms per dispatch inside the program's `rtm.step_async` span, read
under the profiler (which slows the host): the enqueue that the device's
work per dispatch has to hide."""
from benchmark import spans
from benchmark.readers import per_unit


def read(ctx):
    s = ctx.trace_data and spans.host_s(ctx.trace_data, "rtm.step_async")
    return None if s is None else per_unit(ctx, s * 1e3)
