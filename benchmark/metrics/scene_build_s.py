"""Host seconds of build_tracer_scene in set-up, from the benchmark's own
span around the call (which ends with a synchronise)."""


def read(ctx):
    xs = ctx.spans.get("scene_build")
    return xs[0] if xs else None
