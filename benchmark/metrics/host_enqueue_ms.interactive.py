"""Host ms per frame inside ProgressiveRenderer.step_async, from the
benchmark's own span around the call, over the window's frames."""


def read(ctx):
    xs = ctx.spans.get("step_async")
    return sum(xs) / len(xs) * 1e3 if xs else None
