"""Device ms per Adam step of the operations that the autograd engine's
backward launched (those under its evaluate_function records)."""
from benchmark.readers import per_unit


def read(ctx):
    tr = ctx.trace_data
    if tr is None:
        return None
    s = tr.backward_device_s()
    return per_unit(ctx, s * 1e3) if s > 0 else None
