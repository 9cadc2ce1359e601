"""Host ms per frame inside the program's `rtm.dispatch` span less its
`rtm.postpass` child: the route, the camera row, the side tables and the
kernel's launch.  Read under the profiler (which slows the host)."""
from benchmark import spans
from benchmark.readers import per_unit


def read(ctx):
    s = ctx.trace_data and spans.host_s(ctx.trace_data, "rtm.dispatch",
                                        less="rtm.postpass")
    return None if s is None else per_unit(ctx, s * 1e3)
