"""Device ms per dispatch of the operations launched inside the program's
`rtm.mega.trace` span (`mega_trace`: on the card, the megakernel's one
launch), read from the traced window."""
from benchmark import spans
from benchmark.readers import per_unit


def read(ctx):
    s = ctx.trace_data and spans.device_s(ctx.trace_data, "rtm.mega.trace")
    return per_unit(ctx, s * 1e3) if s else None
