"""Host ms per dispatch inside the program's `rtm.mega.pack` span
(`build_mega_pack`: the sphere table repacked from the scene's tensors on
every dispatch), read under the profiler (which slows the host)."""
from benchmark import spans
from benchmark.readers import per_unit


def read(ctx):
    s = ctx.trace_data and spans.host_s(ctx.trace_data, "rtm.mega.pack")
    return None if s is None else per_unit(ctx, s * 1e3)
