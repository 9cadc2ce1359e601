"""CUDA launch and copy API calls per frame, counted from the profiler's
host events in the traced window."""
from benchmark.readers import per_unit


def read(ctx):
    tr = ctx.trace_data
    if tr is None:
        return None
    n = tr.launch_calls()
    return per_unit(ctx, n) if n else None
