"""Device busy ms per dispatch outside the route's tracing kernel: the
dense post-pass, the accumulation add and the camera copy."""
from benchmark.readers import nonkernel_device_ms


def read(ctx):
    return nonkernel_device_ms(ctx)
