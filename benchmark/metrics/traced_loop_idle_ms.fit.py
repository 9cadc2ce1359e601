"""Device idle ms per Adam step in the gaps that begin while the innermost
open program span is `rtm.fit.step` itself, outside `rtm.fit.forward` and
`rtm.fit.backward`: the wait at `float(loss)`, the Adam update and the
step's own Python.  Read under the profiler (which slows the host)."""
from benchmark import spans
from benchmark.readers import per_unit


def read(ctx):
    tr = ctx.trace_data
    if tr is None or not spans.complete(tr, "rtm.fit.step"):
        return None
    return per_unit(ctx, spans.idle_by_span(tr).get("rtm.fit.step", 0.0)
                    * 1e3)
