"""The megakernel's share of its roofline, in %: the least time a
dispatch needs (benchmark/roofline.py) over the kernel's device time per
dispatch, its events found in the trace by name."""
from benchmark.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "mega_trace_kernel")
