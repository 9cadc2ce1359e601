"""What the per-layer metric readers (benchmark/metrics/<name>.py) share.
Each helper returns None where the run has nothing to read, and the
harness then leaves the metric out of the result line."""
from __future__ import annotations

from benchmark import roofline


def idle_share(ctx):
    tr = ctx.trace_data
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 1.0 - tr.busy_s() / tr.window_s


def kernel_roofline_pct(ctx, kernel: str):
    """100 * (the least time one dispatch needs) / (the kernel's device
    seconds per dispatch), from the trace's events of `kernel`."""
    tr = ctx.trace_data
    busy = tr.busy_s(lambda name: kernel in name) if tr and tr.units else 0
    if busy <= 0:
        return None
    r = ctx.desc.render
    b = roofline.dispatch_bound(ctx.tables, r["width"], r["height"],
                                ctx.traffic["spp"], r["max_bounces"])
    per = busy / ctx.trace_data.units
    ctx.work[f"{kernel}_bound"] = dict(b, kernel_s_per_dispatch=per)
    return 100.0 * b["bound_s"] / per


ROUTE_KERNELS = ("mxu_trace_kernel", "trav_trace_kernel", "mega_trace_kernel",
                 "cluster_sweep_kernel", "intersect_sweep_kernel")


def nonkernel_device_ms(ctx):
    """Device busy ms per unit outside the route kernels."""
    tr = ctx.trace_data
    if tr is None or not tr.units or not tr.device:
        return None
    other = tr.busy_s(lambda n: not any(k in n for k in ROUTE_KERNELS))
    return other / tr.units * 1e3


def per_unit(ctx, value):
    tr = ctx.trace_data
    if tr is None or not tr.units:
        return None
    return value / tr.units
